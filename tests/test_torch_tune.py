"""The Tuner of ray_tpu_torch against ray_tpu's, on `init(local_mode=True)`
on the CPU.

Scenarios of tests/test_tune_breadth.py and test_workflow_callbacks.py
run through both packages, one runtime after the other, one trial at a
time and with no trial stopped: `Tuner.restore` after a crash and the JSON
and CSV logger files. The outcome is deterministic, and the two packages'
trials (configs, states, metric histories, the experiment state, logger
files) must be equal.

Then the port alone, on concurrent and stopped trials in local mode, where
every trial is a thread of one process. The JAX package's trials share one
process-wide train session there (its concurrent trials raise "No
training session active", and a stopped trial's thread runs on), so these
tests hold the port to its own claim and do not compare it with JAX: PBT
with 2 concurrent trials of 10 reports (tests/test_tune.py's
test_pbt_exploits_checkpoint) reaches a best score >= 4.0 with no trial
error, and ASHA with 2 concurrent trials stops the trials that the same
scenario stops on a cluster (tests/test_torch_tune_cluster.py), each
stopped trial's thread having ended by the time `fit()` returns.
"""
import csv
import gc
import importlib
import json
import os
import tempfile

import pytest

import ray_tpu
import ray_tpu_torch

RUNTIMES = [ray_tpu, ray_tpu_torch]


def _mod(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _shutdown_all():
    for other in RUNTIMES:
        if other.is_initialized():
            other.shutdown()


def _run_local(scenario, tmp_path):
    """scenario(rt, tune, storage) on each runtime's local mode, in turn."""
    got = []
    for rt in RUNTIMES:
        _shutdown_all()
        rt.init(local_mode=True)
        try:
            got.append(scenario(rt, _mod(rt, "tune"),
                                str(tmp_path / rt.__name__)))
        finally:
            rt.shutdown()
            # Collect the run's ref cycles now, with no engine lock held:
            # a collection inside JAX's local store lock that frees a ref
            # deadlocks its thread (ROADMAP C).
            gc.collect()
    return got


def _error_line(error):
    """The last line of a trial's traceback (its paths differ by package)."""
    return error.strip().splitlines()[-1] if error else None


def _trials(grid):
    """What a grid's trials did: id, config, final state, iterations, the
    reported metrics in order, the error's last line."""
    return [(t.trial_id, t.config, t.state, t.iteration,
             [{k: v for k, v in m.items()} for m in t.history],
             _error_line(t.error))
            for t in grid._trials]


def _run_config(rt, storage, name, **kw):
    return _mod(rt, "train").RunConfig(storage_path=storage, name=name, **kw)


# -- Tuner scenarios -----------------------------------------------------------

def s_restore(rt, tune, storage):
    marker = os.path.join(storage, "fail_once")
    ckpt_mod = _mod(rt, "train.checkpoint")

    def objective(config):
        ckpt = tune.get_checkpoint()
        start = 0
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "state.json")) as f:
                start = json.load(f)["step"]
        for step in range(start + 1, 6):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"step": step}, f)
            tune.report({"step": step, "v": config["v"]},
                        checkpoint=ckpt_mod.Checkpoint(d))
            if step == 3 and not os.path.exists(marker):
                open(marker, "w").write("x")
                raise RuntimeError("simulated crash")

    os.makedirs(storage, exist_ok=True)
    first = tune.Tuner(objective, param_space={"v": tune.grid_search([10])},
                       tune_config=tune.TuneConfig(metric="step", mode="max"),
                       run_config=_run_config(rt, storage, "resume_exp")).fit()
    assert first[0].error is not None
    restored = tune.Tuner.restore(os.path.join(storage, "resume_exp"), objective)
    second = restored.fit()
    r = second[0]
    assert r.error is None and r.metrics["step"] == 5
    assert [m["step"] for m in r.metrics_history] == [4, 5]
    with open(os.path.join(storage, "resume_exp", "experiment_state.json")) as f:
        state = json.load(f)
    return (_trials(first), _trials(second),
            [(t["trial_id"], t["state"], t["iteration"], t["history"], t["config"],
              os.path.basename(t["checkpoint"] or ""), _error_line(t["error"]))
             for t in state["trials"]],
            sorted(os.listdir(os.path.join(storage, "resume_exp", "trial_0000"))))


def s_loggers(rt, tune, storage):
    exp_dir = os.path.join(storage, "cb_exp")

    def objective(config):
        for i in range(3):
            tune.report({"score": config["x"] * (i + 1), "tag": f"i{i}",
                         "nested": {"skip": 1}})

    grid = tune.Tuner(
        objective, param_space={"x": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max", max_concurrent_trials=1),
        run_config=_run_config(rt, storage, "cb_exp",
                               callbacks=[tune.JsonLoggerCallback(exp_dir),
                                          tune.CSVLoggerCallback(exp_dir)])).fit()
    assert len(grid) == 2
    files = {}
    for trial_id in ("trial_0000", "trial_0001"):
        for name in ("result.json", "progress.csv"):
            with open(os.path.join(exp_dir, trial_id, name)) as f:
                files[(trial_id, name)] = f.read()
        rows = list(csv.DictReader(open(os.path.join(exp_dir, trial_id, "progress.csv"))))
        assert len(rows) == 3 and "score" in rows[0] and "nested" not in rows[0]
    return files


TUNER_SCENARIOS = {"restore": s_restore, "loggers": s_loggers}


@pytest.mark.parametrize("name", list(TUNER_SCENARIOS))
def test_local_mode_tuner_matches_jax(name, tmp_path):
    got = _run_local(TUNER_SCENARIOS[name], tmp_path)
    assert got[0] == got[1], got


# -- the port alone: concurrent and stopped trials in local mode ----------------

def _trial_threads():
    import threading

    return {t for t in threading.enumerate() if t.name.startswith("Thread-")}


def test_local_mode_pbt_with_concurrent_trials(tmp_path):
    _shutdown_all()
    ray_tpu_torch.init(local_mode=True)
    try:
        tune = ray_tpu_torch.tune
        ckpt_mod = _mod(ray_tpu_torch, "train.checkpoint")

        def trainable(config):
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
            tune_config=tune.TuneConfig(num_samples=1, max_concurrent_trials=2,
                                        scheduler=pbt),
            run_config=_run_config(ray_tpu_torch, str(tmp_path), "pbt")).fit()
        assert grid.errors == [], grid.errors
        assert len(grid) == 2
        assert grid.get_best_result("score", "max").metrics["score"] >= 4.0
    finally:
        ray_tpu_torch.shutdown()
        gc.collect()


def test_local_mode_asha_stops_trials_and_their_threads(tmp_path):
    """tests/test_torch_tune_cluster.py's ASHA scenario with 2 trials at a
    time: a worse trial reports more slowly, so the better one of a pair
    reaches each rung first, as in the cluster's sequential run, and the
    same trials stop."""
    _shutdown_all()
    ray_tpu_torch.init(local_mode=True)
    try:
        tune = ray_tpu_torch.tune
        from ray_tpu_torch.tune import tuner as tuner_mod

        reports = {}

        def trainable(config):
            import time

            if config["x"] == 99:
                raise ValueError("boom")
            for i in range(6):
                time.sleep(0.4 / config["x"])
                reports[config["x"]] = i + 1
                tune.report({"loss": 1.0 / config["x"], "training_iteration": i + 1})

        before = _trial_threads()
        grid = tune.Tuner(
            trainable, param_space={"x": tune.grid_search([4, 2, 1, 99])},
            tune_config=tune.TuneConfig(
                num_samples=1, max_concurrent_trials=2,
                scheduler=tune.ASHAScheduler(metric="loss", mode="min", grace_period=2,
                                             reduction_factor=2, max_t=6)),
            run_config=_run_config(ray_tpu_torch, str(tmp_path), "asha")).fit()
        after_fit = dict(reports)
        new = [t for t in _trial_threads() - before]
        for t in new:
            t.join(10)
        states = {t.trial_id: t.state for t in grid._trials}
        assert states == {"trial_0000": "TERMINATED", "trial_0001": "STOPPED",
                          "trial_0002": "STOPPED", "trial_0003": "ERROR"}, states
        stopped = [t for t in grid._trials if t.state == "STOPPED"]
        # The scheduler stopped each at its rung (step 2), and its loop
        # ended at a report after that, short of its 6 steps.
        for t in stopped:
            assert t.iteration == 2, (t.trial_id, t.iteration)
            assert 3 <= reports[t.config["x"]] < 6, reports
        # Every trial thread ends (a finished one just after its last
        # poll), and none reported after fit() returned: the stopped ones
        # had ended by then.
        assert not [t for t in new if t.is_alive()]
        assert reports == after_fit and not tuner_mod._stopped_threads
    finally:
        ray_tpu_torch.shutdown()
        gc.collect()
