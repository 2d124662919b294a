"""The searchers and schedulers of ray_tpu_torch.tune against ray_tpu.tune's,
on the CPU with no actors.

The same seeds and the same metric streams go through both packages: the
variants, the searchers' suggestions (TPE, BOHB, ask/tell, the concurrency
limiter) and the schedulers' decisions (ASHA, sync HyperBand with its
pending transitions, median stopping, PBT's exploits and mutations, PB2's
GP-UCB explore) must be equal. This holds `test_tune_breadth.py`'s
searchers without rerunning its Tuner scenarios beside the port.
"""
import random

import numpy as np
import pytest

from ray_tpu import tune as jtune
from ray_tpu_torch import tune as ttune

PACKAGES = [jtune, ttune]


def _both(fn):
    """fn(tune module) for each package; the two results."""
    return [fn(t) for t in PACKAGES]


# -- variants ------------------------------------------------------------------

SPACES = {
    "grid_x_uniform": lambda t: {"a": t.grid_search([1, 2, 3]), "b": t.uniform(0, 1),
                                 "c": "fixed"},
    "every_domain": lambda t: {"lr": t.loguniform(1e-5, 1e-1), "n": t.randint(1, 9),
                               "q": t.quniform(0.0, 1.0, 0.25),
                               "act": t.choice(["relu", "gelu", "silu"]),
                               "g": t.grid_search(["x", "y"])},
    "two_grids": lambda t: {"a": t.grid_search([0.1, 0.2]),
                            "b": t.grid_search([10, 20, 30]), "c": t.uniform(-1, 1)},
}


@pytest.mark.parametrize("name", list(SPACES))
@pytest.mark.parametrize("seed", [0, 7])
def test_generate_variants_match_jax(name, seed):
    got = _both(lambda t: t.search.generate_variants(SPACES[name](t), 3, seed))
    assert got[0] == got[1]
    assert len(got[0]) >= 3


# -- searchers -----------------------------------------------------------------

def _objective(cfg) -> float:
    """A smooth objective over the test spaces (max at x=3, y=-1)."""
    score = -(cfg["x"] - 3.0) ** 2
    if "y" in cfg:
        score -= 0.5 * (cfg["y"] + 1.0) ** 2
    if cfg.get("kind") == "b":
        score += 0.25
    return score


def _search_space(t):
    return {"x": t.uniform(-10.0, 10.0), "y": t.loguniform(0.01, 10.0),
            "kind": t.choice(["a", "b", "c"])}


def _drive(searcher, t, n: int, mode: str = "max", reports: int = 1, seed: int = 3,
           concurrent: int = 1) -> list:
    """Suggest n trials, `concurrent` live at a time; each reports
    `reports` results (metric over training_iteration) and completes.
    Returns every suggestion in order (None when the searcher declines)."""
    searcher.set_space(_search_space(t), "score", mode, seed)
    out, live, i = [], [], 0
    while i < n or live:
        while i < n and len(live) < concurrent:
            tid = f"trial_{i:04d}"
            cfg = searcher.suggest(tid)
            out.append(cfg)
            i += 1
            if cfg is None:
                break
            live.append((tid, cfg))
        if not live:
            continue
        tid, cfg = live.pop(0)
        last = None
        for it in range(1, reports + 1):
            value = _objective(cfg) * (1.0 + 1.0 / it)
            last = {"score": -value if mode == "min" else value,
                    "training_iteration": it}
            searcher.on_trial_result(tid, last)
        searcher.on_trial_complete(tid, last)
    return out


@pytest.mark.parametrize("mode", ["max", "min"])
def test_tpe_suggestions_match_jax(mode):
    got = _both(lambda t: _drive(t.TPESearcher(n_initial=4), t, 20, mode=mode))
    assert got[0] == got[1]


@pytest.mark.parametrize("reports", [1, 4])
def test_bohb_suggestions_match_jax(reports):
    def run(t):
        s = t.BOHBSearcher(min_points=4, random_fraction=0.2)
        cfgs = _drive(s, t, 18, reports=reports, concurrent=3)
        return cfgs, s._model_budget(), sorted(s._obs)

    got = _both(run)
    assert got[0] == got[1]
    assert got[1][1] is not None  # the model phase ran


class _HillClimber:
    """A seeded external ask/tell optimizer."""

    def __init__(self):
        self.rng = random.Random(0)
        self.best = (None, float("-inf"))
        self.told = []

    def ask(self):
        if self.best[0] is None:
            return {"x": self.rng.uniform(-4, 4), "y": 1.0}
        return {"x": self.best[0]["x"] + self.rng.uniform(-1, 1), "y": 1.0}

    def tell(self, config, value):
        self.told.append((config["x"], value))
        if value > self.best[1]:
            self.best = (config, value)


@pytest.mark.parametrize("mode", ["max", "min"])
def test_ask_tell_suggestions_match_jax(mode):
    def run(t):
        opt = _HillClimber()
        return _drive(t.AskTellSearcher(opt), t, 12, mode=mode), opt.told

    got = _both(run)
    assert got[0] == got[1]
    for t in PACKAGES:
        with pytest.raises(TypeError, match="ask"):
            t.AskTellSearcher(object())
        with pytest.raises(ValueError, match="metric"):
            t.AskTellSearcher(_HillClimber()).set_space({}, None, "max")


def test_concurrency_limiter_matches_jax():
    def run(t):
        limited = t.ConcurrencyLimiter(t.BasicVariantGenerator(), max_concurrent=2)
        limited.set_space({"x": t.uniform(0, 1)}, "m", "max", seed=1)
        seq = [limited.suggest("t1"), limited.suggest("t2"), limited.suggest("t3")]
        limited.on_trial_complete("t1", {"m": 1.0})
        seq.append(limited.suggest("t3"))
        return seq

    got = _both(run)
    assert got[0] == got[1]
    assert got[1][2] is None and got[1][3] is not None
    # Driven by a Tuner-shaped loop, three live at a time under a cap of 2.
    got = _both(lambda t: _drive(t.ConcurrencyLimiter(t.TPESearcher(n_initial=3), 2),
                                 t, 10, concurrent=3))
    assert got[0] == got[1]
    assert None in got[1]


# -- schedulers ----------------------------------------------------------------

def _stream(seed: int, n_trials: int, iters: int, stride: int = 1) -> list:
    """(trial_id, result) in an interleaved order: trial i's metric grows
    with its slope, plus seeded noise; trials report every `stride`."""
    rng = np.random.default_rng(seed)
    slopes = rng.uniform(0.5, 2.0, n_trials)
    order = []
    for it in range(stride, iters + 1, stride):
        for i in rng.permutation(n_trials):
            order.append((f"trial_{i:04d}",
                          {"score": float(slopes[i] * it + rng.normal(0, 0.3)),
                           "training_iteration": it}))
    return order


def _decisions(sched, stream, complete_at=None) -> list:
    """Feed a result stream; record each decision (and, for sync
    HyperBand, each tick's pending transitions). A trial told STOP or
    PAUSE reports nothing more until resumed."""
    out, halted = [], set()
    for tid, result in stream:
        if tid in halted:
            continue
        d = sched.on_result(tid, dict(result))
        out.append((tid, result["training_iteration"], d))
        if d in ("STOP", "PAUSE"):
            halted.add(tid)
        if hasattr(sched, "pending_transitions"):
            resume, stop = sched.pending_transitions()
            out.append(("transitions", sorted(resume), sorted(stop)))
            halted.difference_update(resume)
            for s in stop:
                sched.on_trial_complete(s)
        if complete_at is not None and result["training_iteration"] == complete_at:
            sched.on_trial_complete(tid)
    return out


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("stride", [1, 2])
def test_asha_decisions_match_jax(mode, stride):
    got = _both(lambda t: _decisions(
        t.ASHAScheduler(metric="score", mode=mode, grace_period=1, reduction_factor=2,
                        max_t=16), _stream(5, 8, 16, stride)))
    assert got[0] == got[1]
    assert any(d == "STOP" for *_, d in got[1])


@pytest.mark.parametrize("mode", ["max", "min"])
def test_hyperband_decisions_match_jax(mode):
    got = _both(lambda t: _decisions(
        t.HyperBandScheduler(metric="score", mode=mode, grace_period=2,
                             reduction_factor=2, max_t=8), _stream(11, 8, 8)))
    assert got[0] == got[1]
    assert any(e[0] == "transitions" and e[2] for e in got[1])


def test_median_stopping_decisions_match_jax():
    got = _both(lambda t: _decisions(
        t.MedianStoppingRule(metric="score", mode="max", grace_period=2,
                             min_samples_required=3), _stream(2, 6, 10)))
    assert got[0] == got[1]
    assert any(d == "STOP" for *_, d in got[1])


def _pbt_run(sched, stream, mutate_all: bool = True) -> list:
    """PBT as the Tuner drives it: every result, then drain exploits and
    mutate the victims' configs from their sources'."""
    configs = {tid: {"lr": 0.01 * (1 + int(tid[-1])), "wd": 0.1}
               for tid, _ in stream}
    if hasattr(sched, "on_trial_config"):
        for tid, cfg in sorted(configs.items()):
            sched.on_trial_config(tid, cfg)
    out = []
    for tid, result in stream:
        out.append(sched.on_result(tid, dict(result)))
        for victim, src in sorted(sched.exploits.items()):
            sched.exploits.pop(victim)
            configs[victim] = sched.mutate(configs[src])
            if hasattr(sched, "on_trial_config"):
                sched.on_trial_config(victim, configs[victim])
            out.append((victim, src, configs[victim]))
    return out


def test_pbt_exploits_and_mutations_match_jax():
    got = _both(lambda t: _pbt_run(t.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=4,
        hyperparam_mutations={"lr": [0.1, 1.0], "wd": (0.0, 0.5)}, seed=0),
        _stream(3, 4, 16)))
    assert got[0] == got[1]
    assert any(isinstance(e, tuple) for e in got[1])


@pytest.mark.parametrize("mode", ["max", "min"])
def test_pb2_explore_matches_jax(mode):
    def run(t):
        pb2 = t.PB2(metric="score", mode=mode, perturbation_interval=4,
                    hyperparam_bounds={"lr": (0.0, 1.0), "wd": (0.0, 0.3)}, seed=0)
        out = _pbt_run(pb2, _stream(9, 4, 16))
        return out, [tuple(r[0]) + r[1:] for r in pb2._rows]

    got = _both(run)
    assert got[0] == got[1]
    assert len(got[1][1]) >= 4  # the bandit fit its GP (not the cold start)
    assert any(isinstance(e, tuple) for e in got[1][0])
