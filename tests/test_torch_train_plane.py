"""The train plane of ray_tpu_torch against ray_tpu's, on the CPU.

Each runtime starts one single-host cluster for this file (`init(num_cpus=4)`)
and shuts it down in `finally`, never both at once. The same scenarios run
through JAX's trainer and the port's (`use_gpu=False`): JAX's run records
what it got, the port's run is held to the record. They are the scenarios
of tests/test_train.py (reports of a two-worker gang, a checkpoint round
trip and resume, a restart from a checkpoint, an exhausted failure budget,
the gloo all-reduce at world 2); the slice as a whole (TINY's train step in
each trainer's worker from the same weights and batches, a failure after
the checkpoint at step 2, the resumed losses within 1e-5); the federation
of a run's gauges and spans to the GCS (`train_runs()`, `fetch_spans`);
and the elastic supervisor replacing a SIGKILLed rank, and a SIGSTOPped
straggler, in place. After the SIGKILL the port's store is back at its
baseline (the daemon frees what the dead rank owned).
"""
import dataclasses
import importlib
import json
import os
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.core.distributed import gcs_server as port_gcs
from ray_tpu.models import configs as jax_configs
from ray_tpu.models.training import make_train_step as jax_make_train_step
from ray_tpu.parallel import MeshConfig, build_mesh

RECORD = {}   # scenario -> what the JAX package's trainer gave
# TINY's losses through the two trainers.
LOSS_REL = 1e-5
OPT = dict(lr=1e-2, warmup=2, total_steps=10)


@pytest.fixture(scope="module", params=[ray_tpu, ray_tpu_torch],
                ids=["ray_tpu", "ray_tpu_torch"])
def cluster(request):
    rt = request.param
    for other in (ray_tpu, ray_tpu_torch):
        if other.is_initialized():
            other.shutdown()
    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


def _agree(name: str, rt, got):
    """Record JAX's result; hold the port's to it."""
    if rt is ray_tpu:
        RECORD[name] = got
    elif name in RECORD:
        assert got == RECORD[name], (name, got, RECORD[name])
    return got


def _scaling(rt, **kw):
    """A CPU gang: JAX's default, the port's with `use_gpu=False`."""
    if rt is ray_tpu_torch:
        kw.setdefault("use_gpu", False)
    return rt.train.ScalingConfig(**kw)


def _trainer(rt, loop, tmp, name, *, workers=1, config=None, fc=None,
             resume=None, kind="DataParallelTrainer", **scaling):
    train = rt.train
    kw = {} if kind == "TorchTrainer" else {"backend": None}
    return getattr(train, kind)(
        loop, train_loop_config=config if config is not None else {},
        scaling_config=_scaling(rt, num_workers=workers,
                                resources_per_worker={"CPU": 1}, **scaling),
        run_config=train.RunConfig(name=name, storage_path=tmp,
                                   failure_config=fc or train.FailureConfig()),
        resume_from_checkpoint=resume, **kw)


def _ckpt_name(result):
    return os.path.basename(result.checkpoint.path) if result.checkpoint else None


def _seqs(trial_dir):
    return sorted(n for n in os.listdir(trial_dir) if n.startswith("checkpoint_"))


# -- the scenarios of tests/test_train.py ------------------------------------

def s_two_worker_reports(rt, tmp):
    train = rt.train

    def loop(config):
        ctx = train.get_context()
        for step in range(3):
            train.report({"step": step, "rank": ctx.get_world_rank(),
                          "world": ctx.get_world_size()})

    r = _trainer(rt, loop, tmp, "basic", workers=2).fit()
    return r.metrics, r.metrics_history, r.error is None, _ckpt_name(r)


def _json_ckpt_loop(rt, steps_after_start, fail_at=None):
    train = rt.train

    def loop(config):
        import json
        import tempfile

        ckpt = train.get_checkpoint()
        start = 0
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "state.json")) as f:
                start = json.load(f)["step"] + 1
        for step in range(start, steps_after_start(start)):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"step": step}, f)
            train.report({"step": step}, checkpoint=train.Checkpoint(d))
            if step == fail_at and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("injected failure")
    return loop


def s_checkpoint_roundtrip_and_resume(rt, tmp):
    loop = _json_ckpt_loop(rt, lambda start: start + 2)
    r1 = _trainer(rt, loop, tmp, "ckpt").fit()
    r2 = _trainer(rt, loop, tmp, "ckpt", resume=r1.checkpoint).fit()
    return (r1.metrics, _ckpt_name(r1), r2.metrics, _ckpt_name(r2),
            r2.metrics_history, _seqs(os.path.join(tmp, "ckpt")))


def s_failure_restart_from_checkpoint(rt, tmp):
    loop = _json_ckpt_loop(rt, lambda start: 4, fail_at=1)
    r = _trainer(rt, loop, tmp, "ft", config={"marker": os.path.join(tmp, "once")},
                 fc=rt.train.FailureConfig(max_failures=2)).fit()
    return (r.metrics, r.metrics_history, r.error is None, _ckpt_name(r),
            _seqs(os.path.join(tmp, "ft")))


def s_failure_exhausts_budget(rt, tmp):
    def loop(config):
        raise ValueError("always fails")

    r = _trainer(rt, loop, tmp, "fail").fit()
    return r.error is not None, "always fails" in str(r.error), r.metrics_history


def s_torch_trainer_gloo_allreduce(rt, tmp):
    train = rt.train

    def loop(config):
        import torch
        import torch.distributed as dist

        t = torch.ones(2) * (dist.get_rank() + 1)
        dist.all_reduce(t)
        train.report({"sum": float(t[0]), "world": dist.get_world_size()})

    r = _trainer(rt, loop, tmp, "torch", workers=2, kind="TorchTrainer").fit()
    return r.metrics, r.error is None


SCENARIOS = {
    "two_worker_reports": (s_two_worker_reports, lambda got: (
        got[0]["step"] == 2 and got[0]["world"] == 2 and len(got[1]) == 3
        and got[2])),
    "checkpoint_roundtrip_and_resume": (s_checkpoint_roundtrip_and_resume, lambda got: (
        got[0] == {"step": 1} and got[2] == {"step": 3} and got[1] is not None)),
    "failure_restart_from_checkpoint": (s_failure_restart_from_checkpoint, lambda got: (
        got[0] == {"step": 3} and got[2])),
    "failure_exhausts_budget": (s_failure_exhausts_budget, lambda got: got[:2] == (True, True)),
    "torch_trainer_gloo_allreduce": (s_torch_trainer_gloo_allreduce, lambda got: (
        got == ({"sum": 3.0, "world": 2}, True))),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax(cluster, tmp_path, name):
    scenario, check = SCENARIOS[name]
    got = scenario(cluster, str(tmp_path))
    assert check(got), got
    _agree(name, cluster, got)


# -- the slice as a whole ----------------------------------------------------

def _slice_inputs():
    cfg = dataclasses.replace(jax_configs.TINY, compute_dtype=jnp.float32)
    mesh = build_mesh(MeshConfig(fsdp=-1), devices=jax.devices()[:1])
    params = jax_make_train_step(cfg, mesh)[0](jax.random.key(0)).params
    batches = np.random.default_rng(0).integers(0, cfg.vocab_size, (6, 4, 33),
                                                dtype=np.int32)
    return jax.tree.map(np.asarray, params), batches


def _jax_tiny_loop():
    """TINY's JAX train step in a ray_tpu worker: the weights from the
    config, a checkpoint after step 2 (the state pickled as host arrays:
    the payload formats are held to each other in
    test_torch_train_units.py), and a failure right after it on the first
    attempt. Both attempts share a compilation cache."""

    def loop(config):
        import dataclasses
        import pickle
        import tempfile

        import jax
        import jax.numpy as jnp

        from ray_tpu import train
        from ray_tpu.models import configs
        from ray_tpu.models.training import default_optimizer, make_train_step
        from ray_tpu.parallel import MeshConfig, build_mesh

        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(config["tmp"], "jax_cache"))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        cfg = dataclasses.replace(configs.TINY, compute_dtype=jnp.float32)
        mesh = build_mesh(MeshConfig(fsdp=-1), devices=jax.devices()[:1])
        init_fn, step_fn = make_train_step(cfg, mesh, optimizer=default_optimizer(
            config["opt"]["lr"], warmup=config["opt"]["warmup"],
            total_steps=config["opt"]["total_steps"]))
        state = init_fn(jax.random.key(0))
        state = dataclasses.replace(state, params=jax.tree.map(
            lambda p, w: jnp.asarray(w, p.dtype), state.params, config["params"]))
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "state.pkl"), "rb") as f:
                host = pickle.load(f)
            state = jax.tree.map(lambda cur, h: jnp.asarray(h, cur.dtype), state, host)
            start = int(state.step)
        for i in range(start, len(config["batches"])):
            state, m = step_fn(state, {"tokens": jnp.asarray(config["batches"][i])})
            ck = None
            if i == 2:
                d = tempfile.mkdtemp()
                with open(os.path.join(d, "state.pkl"), "wb") as f:
                    pickle.dump(jax.device_get(state), f)
                ck = train.Checkpoint(d)
                ck.update_metadata({"step": i + 1})
            train.report({"step": i, "loss": float(m["loss"])}, checkpoint=ck)
            if i == 2 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("injected failure after the checkpoint")
    return loop


def _port_tiny_loop():
    """The same with the port's train step, the weights carried by
    `jax_bridge`, the checkpoint through torch.distributed.checkpoint."""

    def loop(config):
        import dataclasses

        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models import configs
        from ray_tpu_torch.models.jax_bridge import params_from_jax
        from ray_tpu_torch.models.training import (
            default_optimizer, make_train_step, train_state_tree)

        cfg = dataclasses.replace(configs.TINY, compute_dtype=torch.float32)
        init_fn, step_fn = make_train_step(cfg, device="cpu", optimizer=default_optimizer(
            config["opt"]["lr"], warmup=config["opt"]["warmup"],
            total_steps=config["opt"]["total_steps"]))
        state = init_fn(params=params_from_jax(config["params"], cfg, device="cpu"))
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            tree = train.load_pytree(ckpt, target=train_state_tree(state))
            state.step = int(tree["step"])
        for i in range(state.step, len(config["batches"])):
            state, m = step_fn(state, {"tokens": config["batches"][i]})
            ck = None
            if i == 2:
                ck = train.save_pytree(train_state_tree(state),
                                       os.path.join(config["tmp"], "port_state"), step=i + 1)
            train.report({"step": i, "loss": float(m["loss"])}, checkpoint=ck)
            if i == 2 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("injected failure after the checkpoint")
    return loop


def test_tiny_train_step_through_the_trainer_matches_jax(cluster, tmp_path):
    """TINY's step in each trainer's worker, from the same weights on the
    same batches: losses within 1e-5; the failure after the checkpoint at
    step 2 restarts the gang, which resumes from it and agrees again."""
    params, batches = _slice_inputs()
    tmp = str(tmp_path)
    config = {"params": params, "batches": batches, "opt": OPT, "tmp": tmp,
              "marker": os.path.join(tmp, "once")}
    loop = _jax_tiny_loop() if cluster is ray_tpu else _port_tiny_loop()
    r = _trainer(cluster, loop, tmp, "tiny", config=config,
                 fc=cluster.train.FailureConfig(max_failures=1)).fit()
    assert r.error is None, r.error
    steps = [m["step"] for m in r.metrics_history]
    losses = [m["loss"] for m in r.metrics_history]
    assert steps == list(range(6)), steps
    assert os.path.exists(config["marker"])
    # JAX's trainer drops the checkpoint when the resumed gang makes none;
    # the port's keeps the one it resumed from.
    if cluster is ray_tpu:
        assert r.checkpoint is None
    else:
        assert _ckpt_name(r) == "checkpoint_000001"
        assert r.checkpoint.get_metadata() == {"step": 3}
    if cluster is ray_tpu:
        RECORD["tiny"] = losses
    else:
        assert losses == pytest.approx(RECORD["tiny"], rel=LOSS_REL)


# -- federation to the GCS ---------------------------------------------------

def _instrumented_loop(rt, total_steps, sleep=0.1):
    train = rt.train

    def loop(config):
        import json
        import tempfile

        ctx = train.get_context()
        ckpt = train.get_checkpoint()
        start = 0
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "state.json")) as f:
                start = json.load(f)["step"] + 1
        for step in range(start, total_steps):
            with train.step_phases():
                with train.phase("compute"):
                    time.sleep(sleep)
            ck = None
            if ctx.get_world_rank() == 0:
                d = tempfile.mkdtemp()
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump({"step": step}, f)
                ck = train.Checkpoint(d)
            train.report({"step": step, "world": ctx.get_world_size()},
                         checkpoint=ck)
            if config.get("dir"):
                with open(os.path.join(config["dir"],
                                       f"pid_rank{ctx.get_world_rank()}"), "w") as f:
                    f.write(str(os.getpid()))
            time.sleep(config.get("sleep", 0.0))
    return loop


def _poll(fn, timeout=30.0, period=0.25):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            last = fn()
        except Exception:  # noqa: BLE001 — GCS mid-refresh
            last = None
        if last:
            return last
        time.sleep(period)
    raise TimeoutError(f"condition never met (last={last!r})")


def test_train_run_federated_to_gcs(cluster, tmp_path):
    """A clean two-rank run: its gauges reach `state.train_runs()` and
    `cluster_status()`, its step spans `timeline.fetch_spans`, as in JAX."""
    state = importlib.import_module(f"{cluster.__name__}.util.state")
    timeline = importlib.import_module(f"{cluster.__name__}.util.timeline")
    tmp = str(tmp_path)
    r = _trainer(cluster, _instrumented_loop(cluster, 6), tmp, "tclean", workers=2,
                 flops_per_step=1e9).fit()
    assert r.error is None, r.error

    def both_ranks_synced():
        s = state.train_runs().get("tclean")
        if s and s["attributed_s"]["compute_s"] >= 2 * 5 * 0.1 * 0.8:
            return s
        return None

    s = _poll(both_ranks_synced)
    spans = _poll(lambda: [sp for sp in timeline.fetch_spans(trace_id="tclean#0")
                           if sp["name"] in ("train.step", "phase.compute")])
    got = {"run_id": s["run_id"], "world": s["world"], "steps": s["steps"] >= 5,
           "restarts": s["restarts"], "goodput": s["goodput"] >= 0.5,
           "lost": s["split"]["lost_restart"], "flops": s["achieved_flops"] > 0,
           "in_status": "tclean" in state.cluster_status()["observability"]["train"]["runs"],
           "span_ranks": sorted({(sp["name"], sp["attrs"]["rank"]) for sp in spans})}
    assert _agree("federation", cluster, got) == {
        "run_id": "tclean#0", "world": 2, "steps": True, "restarts": 0,
        "goodput": True, "lost": 0.0, "flops": True, "in_status": True,
        "span_ranks": [("phase.compute", 0), ("phase.compute", 1),
                       ("train.step", 0), ("train.step", 1)]}
    out = timeline.train_trace("tclean", filename=os.path.join(tmp, "trace.json"))
    with open(out) as f:
        assert any(ev["pid"] == "run:tclean#0" for ev in json.load(f))
    if cluster is ray_tpu_torch:
        # The ranks' last pushes say their loops returned: past the stale
        # window, while the run still counts as active, the port blames no
        # stopped rank (JAX's does, in that window).
        time.sleep(port_gcs.TrainRunState.STALE_RANK_S + 1)
        s = state.train_runs()["tclean"]
        assert s["active"] and "stale_ranks" not in s["skew"], s


# -- elastic: a rank killed, a rank stopped ------------------------------------

def _wait_pid(path, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                return int(f.read())
        except (OSError, ValueError):
            time.sleep(0.05)
    raise TimeoutError(f"no pid beacon at {path}")


def _monotonic(trial_dir):
    steps = []
    for n in _seqs(trial_dir):
        with open(os.path.join(trial_dir, n, "state.json")) as f:
            steps.append(json.load(f)["step"])
    return steps == sorted(steps) and len(steps) >= 1


def _elastic(rt, **overrides):
    base = dict(elastic=True, max_failures=3, replace_timeout_s=20,
                backoff_initial_s=0.1, backoff_max_s=0.5, backoff_jitter=0.0,
                hang_timeout_s=60, grow_check_s=3600)
    base.update(overrides)
    return rt.train.FailureConfig(**base)


@pytest.mark.parametrize("how", ["sigkill", "sigstop"])
def test_rank_replaced_in_place(cluster, tmp_path, how):
    """SIGKILL rank 1 mid-step (or SIGSTOP it past a 2 s hang threshold):
    the supervisor blames that rank, keeps the placement group, and
    restarts the gang at the same world size from the latest checkpoint.
    After the SIGKILL the port's store is back at its baseline."""
    chaos = importlib.import_module(f"{cluster.__name__}.util.chaos")
    tmp = str(tmp_path)
    fc = _elastic(cluster, **({"hang_timeout_s": 2} if how == "sigstop" else {}))
    store = cluster.api._global_worker().store
    baseline = (store.used, store.num_objects)
    trainer = _trainer(cluster, _instrumented_loop(cluster, 6, sleep=0.0), tmp,
                       f"e{how}", workers=2,
                       config={"dir": tmp, "sleep": 0.3 if how == "sigkill" else 0.2},
                       fc=fc)
    signal_rank = chaos.kill_rank if how == "sigkill" else chaos.sigstop_rank

    def inject():
        pid = _wait_pid(os.path.join(tmp, "pid_rank1"))
        assert signal_rank(SimpleNamespace(pids=[pid]), 0)

    th = threading.Thread(target=inject, daemon=True)
    th.start()
    r = trainer.fit()
    th.join(timeout=10)
    cause = "death" if how == "sigkill" else "hang"
    got = (r.error is None, r.metrics["step"], r.metrics["world"],
           r.elastic["restarts"][cause] >= 1, r.elastic["shrinks"],
           r.elastic["final_world"], _monotonic(os.path.join(tmp, f"e{how}")))
    assert _agree(f"elastic_{how}", cluster, got) == (True, 5, 2, True, 0, 2, True)
    deadline = time.monotonic() + (20 if cluster is ray_tpu_torch else 0)
    while (store.used, store.num_objects) != baseline and time.monotonic() < deadline:
        time.sleep(0.1)
    after = (store.used, store.num_objects)
    print(f"{cluster.__name__}: store (used, objects) {baseline} before the "
          f"elastic fit, {after} after")
    if cluster is ray_tpu_torch:
        assert after == baseline
