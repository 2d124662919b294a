"""AIR's actor manager and the Tuner of ray_tpu_torch against ray_tpu's, on
each package's multi-process `init()` cluster (trial actors in worker
processes), on the CPU.

One cluster per runtime for this file, never both at once (a module
fixture over the two runtimes): JAX's run records what it got, the port's
run is held to the record. The scenarios of tests/test_air_execution.py
(lifecycle events, an application error, an actor's death) and an
accelerator demand passed through the manager's `resources` (the port's
daemon fakes one card with RAY_TPU_NUM_GPUS, JAX's one chip with
RAY_TPU_NUM_TPUS: the demand holds the device while the actor lives; in
the port `resources={"GPU": 1}` gets the card lease that `num_gpus=1`
gets). Then the Tuner: ASHA over sequential trials (deterministic: the
trials must equal JAX's), PBT exploiting a checkpoint and sync HyperBand
(their outcome depends on how concurrent trials interleave: each package
is held to the scenario's claims).

The slice as a whole, TINY's train step tuned by ASHA, is in
tests/test_torch_tune_cluster_tiny.py, on a cluster of its own.

Classes and trainables sent to workers are nested in the test's helpers
(cloudpickle sends them by value; the test module does not import in a
worker).
"""
import importlib
import os
import time

import pytest

import ray_tpu
import ray_tpu_torch

RUNTIMES = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]
RECORD = {}
# The accelerator each runtime's daemon fakes, by the variable it reads.
ACCEL = {ray_tpu: ("TPU", "RAY_TPU_NUM_TPUS"), ray_tpu_torch: ("GPU", "RAY_TPU_NUM_GPUS")}


def _mod(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _agree(name, rt, got):
    """Record JAX's result; hold the port's to it."""
    if rt is ray_tpu:
        RECORD[name] = got
    elif name in RECORD:
        assert got == RECORD[name], (name, got, RECORD[name])
    return got


@pytest.fixture(scope="module", params=RUNTIMES, ids=IDS)
def cluster(request):
    rt = request.param
    for other in RUNTIMES:
        if other.is_initialized():
            other.shutdown()
    key, var = ACCEL[rt]
    old = os.environ.get(var)
    os.environ[var] = "1"
    try:
        rt.init(num_cpus=4)
    finally:
        if old is None:
            os.environ.pop(var)
        else:
            os.environ[var] = old
    try:
        yield rt
    finally:
        rt.shutdown()


def _make_counter():
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

        def boom(self):
            raise ValueError("app error")

        def die(self):
            import os

            os._exit(1)

        def visible(self):
            import os

            return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()

    return Counter


def _pump_until(mgr, cond, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        mgr.next(timeout=0.5)
        if cond():
            return True
    return False


# -- AIR's actor manager (tests/test_air_execution.py) --------------------------

def test_actor_lifecycle_events(cluster):
    rt = cluster
    mgr = _mod(rt, "air").RayActorManager()
    events = []
    t = mgr.add_actor(
        _make_counter(), kwargs={"start": 5}, resources={"CPU": 0},
        on_start=lambda a: events.append(("start", a.actor_id)),
        on_stop=lambda a: events.append(("stop", a.actor_id)))
    first_state = t.state
    assert _pump_until(mgr, lambda: t.state == "STARTED")
    started = list(events)
    results = []
    mgr.schedule_actor_task(t, "inc", (3,), on_result=lambda a, r: results.append(r))
    mgr.schedule_actor_task(t, "inc", (2,), on_result=lambda a, r: results.append(r))
    assert _pump_until(mgr, lambda: len(results) == 2)
    mgr.remove_actor(t)
    assert _pump_until(mgr, lambda: ("stop", t.actor_id) in events)
    got = (first_state, [e[0] for e in started], results, [e[0] for e in events], t.state)
    mgr.shutdown()
    assert _agree("lifecycle", rt, got) == (
        "PENDING", ["start"], [8, 10], ["start", "stop"], "STOPPED")


def test_task_app_error_does_not_kill_actor(cluster):
    rt = cluster
    mgr = _mod(rt, "air").RayActorManager()
    errors, results = [], []
    t = mgr.add_actor(_make_counter(), resources={"CPU": 0})
    assert _pump_until(mgr, lambda: t.state == "STARTED")
    mgr.schedule_actor_task(t, "boom", on_error=lambda a, e: errors.append(e))
    assert _pump_until(mgr, lambda: errors)
    state = t.state
    mgr.schedule_actor_task(t, "inc", on_result=lambda a, r: results.append(r))
    assert _pump_until(mgr, lambda: results)
    mgr.shutdown()
    got = (state, type(errors[0]).__name__, "app error" in str(errors[0]), results)
    assert _agree("app_error", rt, got)[0] == "STARTED"


def test_actor_death_fires_actor_on_error(cluster):
    rt = cluster
    mgr = _mod(rt, "air").RayActorManager()
    actor_errors, task_errors = [], []
    t = mgr.add_actor(_make_counter(), resources={"CPU": 0},
                      on_error=lambda a, e: actor_errors.append(e))
    assert _pump_until(mgr, lambda: t.state == "STARTED")
    mgr.schedule_actor_task(t, "die", on_error=lambda a, e: task_errors.append(e))
    assert _pump_until(mgr, lambda: task_errors, timeout=120)
    got = (bool(actor_errors), type(task_errors[0]).__name__, t.state)
    mgr.shutdown()
    assert _agree("death", rt, got)[::2] == (True, "FAILED")


def test_accelerator_resource_through_the_manager(cluster):
    """The manager passes non-CPU keys as custom `resources`; the runtime
    merges them into the demand, so the device is held while the actor
    lives and returned when it goes."""
    rt = cluster
    key, _ = ACCEL[rt]
    mgr = _mod(rt, "air").RayActorManager()
    assert rt.cluster_resources().get(key) == 1.0
    t = mgr.add_actor(_make_counter(), resources={"CPU": 0, key: 1})
    assert _pump_until(mgr, lambda: t.state == "STARTED")
    held = rt.available_resources().get(key, 0.0)
    seen = []
    mgr.schedule_actor_task(t, "visible", on_result=lambda a, r: seen.append(r))
    assert _pump_until(mgr, lambda: seen)
    mgr.remove_actor(t)
    mgr.next(timeout=0.5)
    deadline = time.monotonic() + 60
    while rt.available_resources().get(key, 0.0) != 1.0 and time.monotonic() < deadline:
        time.sleep(0.1)
    freed = rt.available_resources().get(key, 0.0)
    mgr.shutdown()
    assert _agree("accelerator", rt, (held, freed)) == (0.0, 1.0)
    if rt is ray_tpu_torch:
        # The card lease: the same CUDA_VISIBLE_DEVICES as num_gpus=1's.
        ref = rt.remote(num_gpus=1)(_make_counter()).remote()
        by_num_gpus = rt.get(ref.visible.remote(), timeout=120)
        rt.kill(ref)
        assert seen[0][0] == by_num_gpus[0] == "0", (seen, by_num_gpus)


# -- the Tuner with trial actors in worker processes ----------------------------

def test_asha_tuner_on_worker_processes(cluster, tmp_path):
    rt = cluster
    tune = _mod(rt, "tune")

    def trainable(config):
        import os

        if config["x"] == 99:
            raise ValueError("boom")
        for i in range(6):
            tune.report({"loss": 1.0 / config["x"], "training_iteration": i + 1,
                         "pid": os.getpid()})

    grid = tune.Tuner(
        trainable, param_space={"x": tune.grid_search([4, 2, 1, 99])},
        tune_config=tune.TuneConfig(
            num_samples=1, max_concurrent_trials=1,
            scheduler=tune.ASHAScheduler(metric="loss", mode="min", grace_period=2,
                                         reduction_factor=2, max_t=6)),
        run_config=_mod(rt, "train").RunConfig(name="asha", storage_path=str(tmp_path))
    ).fit()
    pids = {m["pid"] for t in grid._trials for m in t.history}
    assert pids and os.getpid() not in pids
    got = [(t.trial_id, t.config, t.state, t.iteration,
            [(m["training_iteration"], m["loss"]) for m in t.history],
            t.error.strip().splitlines()[-1] if t.error else None)
           for t in grid._trials]
    assert _agree("asha_cluster", rt, got)[1][2] == "STOPPED"


def test_pbt_exploits_a_checkpoint(cluster, tmp_path):
    rt = cluster
    tune = _mod(rt, "tune")
    ckpt_mod = _mod(rt, "train.checkpoint")

    def trainable(config):
        import json
        import os
        import tempfile

        ckpt = tune.get_checkpoint()
        weight = 0.0
        if ckpt:
            with open(os.path.join(ckpt.path, "w.json")) as f:
                weight = json.load(f)["w"]
        for i in range(10):
            weight += config["lr"]
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "w.json"), "w") as f:
                json.dump({"w": weight}, f)
            tune.report({"score": weight, "training_iteration": i + 1},
                        checkpoint=ckpt_mod.Checkpoint(d))

    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=4,
        hyperparam_mutations={"lr": [0.1, 1.0]}, seed=0)
    grid = tune.Tuner(
        trainable, param_space={"lr": tune.grid_search([0.01, 1.0])},
        tune_config=tune.TuneConfig(num_samples=1, max_concurrent_trials=2, scheduler=pbt),
        run_config=_mod(rt, "train").RunConfig(name="pbt", storage_path=str(tmp_path))
    ).fit()
    best = grid.get_best_result("score", "max").metrics["score"]
    got = (best >= 4.0, len(grid), grid.errors)
    assert _agree("pbt", rt, got) == (True, 2, [])


def test_sync_hyperband_halves(cluster, tmp_path):
    rt = cluster
    tune = _mod(rt, "tune")

    def objective(config):
        for i in range(1, 9):
            tune.report({"score": config["slope"] * i, "training_iteration": i})

    grid = tune.Tuner(
        objective,
        param_space={"slope": tune.grid_search([1.0, 2.0, 3.0, 4.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=1, max_concurrent_trials=4,
            scheduler=tune.HyperBandScheduler(metric="score", mode="max", grace_period=2,
                                              reduction_factor=2, max_t=8)),
        run_config=_mod(rt, "train").RunConfig(name="hb", storage_path=str(tmp_path))
    ).fit()
    total = sum(r.metrics.get("training_iteration", 0) for r in grid)
    got = (grid.get_best_result("score").metrics["config"]["slope"], total < 32,
           "STOPPED" in {t.state for t in grid._trials}, len(grid), grid.errors)
    assert _agree("hyperband", rt, got) == (4.0, True, True, 4, [])
