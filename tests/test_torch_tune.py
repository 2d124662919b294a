"""The Tuner of ray_tpu_torch against ray_tpu's, on `init(local_mode=True)`
on the CPU.

Scenarios of tests/test_tune_breadth.py and test_workflow_callbacks.py
run through both packages, one runtime after the other, one trial at a
time and with no trial stopped: in local mode every trial is a thread of
one process sharing its one train session, and a stopped trial's thread
runs on, so scenarios with concurrent or stopped trials run on a cluster
(tests/test_torch_tune_cluster.py). Here: `Tuner.restore` after a crash
and the JSON and CSV logger files. The outcome is deterministic, and the
two packages' trials (configs, states, metric histories, the experiment
state, logger files) must be equal.
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
