"""Trial schedulers: FIFO, ASHA, median stopping, PBT-lite; the port's
copy of `ray_tpu/tune/schedulers.py` (the same results give the same
decisions).

Reference: schedulers package (ref: python/ray/tune/schedulers/ —
async_hyperband.py AsyncHyperBandScheduler/ASHA, median_stopping_rule.py,
pbt.py).  The controller calls `on_result` per reported result and acts on
the returned decision.
"""
from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"
PAUSE = "PAUSE"


class FIFOScheduler:
    def on_result(self, trial_id: str, result: dict) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        pass


class AsyncHyperBandScheduler(FIFOScheduler):
    """ASHA: asynchronous successive halving (ref: async_hyperband.py).

    Rungs at r, r*eta, r*eta^2, ... ; at each rung keep the top 1/eta of
    completed-at-rung trials, stop the rest.
    """

    def __init__(self, *, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: int = 3,
                 max_t: int = 100):
        assert mode in ("max", "min")
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.eta = reduction_factor
        self.grace = grace_period
        self.max_t = max_t
        # rung level -> {trial_id: best metric at that rung}
        self.rungs: Dict[int, Dict[str, float]] = defaultdict(dict)
        r = grace_period
        self.rung_levels: List[int] = []
        while r < max_t:
            self.rung_levels.append(r)
            r *= reduction_factor
        self._recorded_up_to: Dict[str, int] = defaultdict(lambda: -1)

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.mode == "max" else a < b

    def on_result(self, trial_id: str, result: dict) -> str:
        t = result.get(self.time_attr)
        val = result.get(self.metric)
        if t is None or val is None:
            return CONTINUE
        # Milestone crossing (t >= rung), not equality: trials reporting at
        # arbitrary strides still hit every rung exactly once.
        for rung in self.rung_levels:
            if t >= rung > self._recorded_up_to[trial_id]:
                self._recorded_up_to[trial_id] = rung
                recorded = self.rungs[rung]
                recorded[trial_id] = val
                vals = sorted(recorded.values(),
                              reverse=(self.mode == "max"))
                k = max(1, math.floor(len(vals) / self.eta))
                cutoff = vals[k - 1]
                if self._better(cutoff, val):
                    return STOP
        return CONTINUE


class MedianStoppingRule(FIFOScheduler):
    """Stop a trial whose running-average metric falls below the median of
    other trials' averages at the same step (ref: median_stopping_rule.py)."""

    def __init__(self, *, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._history: Dict[str, List[float]] = defaultdict(list)

    def on_result(self, trial_id: str, result: dict) -> str:
        val = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if val is None:
            return CONTINUE
        self._history[trial_id].append(val)
        if t <= self.grace or len(self._history) < self.min_samples:
            return CONTINUE
        my_avg = sum(self._history[trial_id]) / len(self._history[trial_id])
        others = [sum(h) / len(h) for tid, h in self._history.items()
                  if tid != trial_id and h]
        if len(others) < self.min_samples - 1:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        if self.mode == "max" and my_avg < median:
            return STOP
        if self.mode == "min" and my_avg > median:
            return STOP
        return CONTINUE


class PopulationBasedTraining(FIFOScheduler):
    """PBT-lite (ref: pbt.py): at each perturbation interval, bottom-quantile
    trials are marked for exploit — the controller restarts them from a
    top-quantile trial's checkpoint with mutated hyperparameters."""

    def __init__(self, *, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[dict] = None,
                 quantile_fraction: float = 0.25, seed: Optional[int] = None):
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        self.latest: Dict[str, dict] = {}
        # controller reads + clears this: trial_id -> (source_trial, new_cfg)
        self.exploits: Dict[str, tuple] = {}

    def on_result(self, trial_id: str, result: dict) -> str:
        self.latest[trial_id] = result
        t = result.get(self.time_attr, 0)
        if t and t % self.interval == 0 and len(self.latest) >= 2:
            ranked = sorted(
                self.latest.items(),
                key=lambda kv: kv[1].get(self.metric, -math.inf),
                reverse=(self.mode == "max"))
            n = len(ranked)
            k = max(1, int(n * self.quantile))
            bottom = [tid for tid, _ in ranked[-k:]]
            top = [tid for tid, _ in ranked[:k]]
            if trial_id in bottom:
                src = self.rng.choice(top)
                self.exploits[trial_id] = src
        return CONTINUE

    def mutate(self, config: dict) -> dict:
        out = dict(config)
        for key, spec in self.mutations.items():
            if callable(spec):
                out[key] = spec()
            elif isinstance(spec, list):
                out[key] = self.rng.choice(spec)
            elif isinstance(spec, tuple) and len(spec) == 2:
                out[key] = self.rng.uniform(*spec)
            elif key in out and isinstance(out[key], (int, float)):
                out[key] = out[key] * self.rng.choice([0.8, 1.2])
        return out


class PB2(PopulationBasedTraining):
    """Population Based Bandits (ref: tune/schedulers/pb2.py; Parker-
    Holder et al., NeurIPS 2020): PBT where the EXPLORE step is chosen
    by a time-varying GP-UCB bandit over the continuous hyperparameters
    instead of random perturbation — data-efficient with small
    populations, where random mutations mostly wander.

    Every reported result contributes a datapoint (hyperparams, time,
    reward change); on exploit, the victim copies a top trial's weights
    and its new hyperparams maximize the GP's upper confidence bound
    over `hyperparam_bounds` (a {key: (low, high)} dict — PB2 is for
    continuous axes; non-bounded keys pass through unchanged).
    """

    def __init__(self, *, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Dict[str, tuple],
                 quantile_fraction: float = 0.25,
                 ucb_kappa: float = 2.0, n_candidates: int = 64,
                 seed: Optional[int] = None):
        if not hyperparam_bounds:
            raise ValueError("PB2 needs hyperparam_bounds "
                             "{key: (low, high)}")
        super().__init__(metric=metric, mode=mode, time_attr=time_attr,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        self._keys = sorted(self.bounds)
        self._cfgs: Dict[str, dict] = {}      # trial -> live config
        self._prev: Dict[str, tuple] = {}     # trial -> (t, metric)
        self._rows: List[tuple] = []          # (xvec, t, reward_delta)
        self._max_rows = 256

    # Tuner hook: fires on every (re)launch, including post-exploit.
    def on_trial_config(self, trial_id: str, config: dict) -> None:
        self._cfgs[trial_id] = dict(config)
        self._prev.pop(trial_id, None)        # new lineage, new deltas

    def _xvec(self, config: dict) -> List[float]:
        out = []
        for k in self._keys:
            lo, hi = self.bounds[k]
            v = float(config.get(k, lo))
            out.append((v - lo) / (hi - lo) if hi > lo else 0.0)
        return out

    def on_result(self, trial_id: str, result: dict) -> str:
        t = result.get(self.time_attr)
        y = result.get(self.metric)
        cfg = self._cfgs.get(trial_id)
        if t is not None and y is not None and cfg is not None:
            prev = self._prev.get(trial_id)
            if prev is not None and t > prev[0]:
                dy = (y - prev[1]) / (t - prev[0])
                if self.mode == "min":
                    dy = -dy
                self._rows.append((self._xvec(cfg), float(t), dy))
                if len(self._rows) > self._max_rows:
                    self._rows = self._rows[-self._max_rows:]
            self._prev[trial_id] = (t, y)
        return super().on_result(trial_id, result)

    # -- the bandit: GP-UCB over (hyperparams, time) --------------------
    def mutate(self, config: dict) -> dict:
        import numpy as np

        out = dict(config)
        rng = np.random.default_rng(self.rng.randrange(2 ** 31))
        cand = rng.uniform(size=(self.n_candidates, len(self._keys)))
        if len(self._rows) >= 4:
            X = np.array([r[0] for r in self._rows])
            ts = np.array([r[1] for r in self._rows])
            y = np.array([r[2] for r in self._rows])
            t_scale = max(1.0, float(ts.max()))
            Xt = np.hstack([X, (ts / t_scale)[:, None]])
            y_std = y.std() or 1.0
            yn = (y - y.mean()) / y_std
            ls = 0.3
            now = (ts.max() / t_scale)
            Ct = np.hstack([cand, np.full((len(cand), 1), now)])

            def k(a, b):
                d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
                return np.exp(-d2 / (2 * ls * ls))

            K = k(Xt, Xt) + 1e-2 * np.eye(len(Xt))
            Ks = k(Ct, Xt)
            alpha = np.linalg.solve(K, yn)
            mu = Ks @ alpha
            v = np.linalg.solve(K, Ks.T)
            var = np.clip(1.0 - (Ks * v.T).sum(1), 1e-9, None)
            score = mu + self.kappa * np.sqrt(var)
            best = cand[int(score.argmax())]
        else:
            best = cand[0]                    # cold start: random
        for i, key in enumerate(self._keys):
            lo, hi = self.bounds[key]
            out[key] = lo + float(best[i]) * (hi - lo)
        return out


class HyperBandScheduler(FIFOScheduler):
    """Synchronous successive halving (ref: hyperband.py HyperBand — one
    bracket, simplified): every live trial PAUSES at each rung milestone;
    once the whole rung has reported, the top 1/eta resume from their
    checkpoints and the rest stop. Unlike ASHA (async, stop-only), sync
    halving never stops a trial that a straggler would later beat.
    """

    def __init__(self, *, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: int = 3,
                 max_t: int = 100):
        assert mode in ("max", "min")
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.eta = reduction_factor
        self.max_t = max_t
        self.rung_levels: List[int] = []
        r = grace_period
        while r < max_t:
            self.rung_levels.append(r)
            r *= reduction_factor
        self.participants: set = set()          # live trial ids
        self._next_rung: Dict[str, int] = {}    # trial -> rung index due
        self._rung_scores: Dict[int, Dict[str, float]] = defaultdict(dict)
        self._resume: List[str] = []
        self._stop: List[str] = []

    def on_trial_add(self, trial_id: str) -> None:
        self.participants.add(trial_id)
        self._next_rung[trial_id] = 0

    def on_result(self, trial_id: str, result: dict) -> str:
        if trial_id not in self.participants:
            self.on_trial_add(trial_id)
        t = result.get(self.time_attr)
        val = result.get(self.metric)
        if t is None or val is None:
            return CONTINUE
        idx = self._next_rung.get(trial_id, len(self.rung_levels))
        if idx >= len(self.rung_levels):
            return CONTINUE
        milestone = self.rung_levels[idx]
        if t < milestone:
            return CONTINUE
        self._rung_scores[idx][trial_id] = val
        self._next_rung[trial_id] = idx + 1
        self._maybe_complete_rung(idx)
        return PAUSE

    def _maybe_complete_rung(self, idx: int) -> None:
        scores = self._rung_scores[idx]
        waiting = {tid for tid in self.participants
                   if self._next_rung.get(tid, 99) <= idx}
        if waiting:
            return                     # stragglers still running the rung
        reported = list(scores.items())
        if not reported:
            return
        reported.sort(key=lambda kv: kv[1], reverse=(self.mode == "max"))
        k = max(1, len(reported) // self.eta)
        survivors = [tid for tid, _ in reported[:k]]
        losers = [tid for tid, _ in reported[k:]]
        self._resume.extend(survivors)
        self._stop.extend(losers)
        for tid in losers:
            self.participants.discard(tid)
        self._rung_scores[idx] = {}

    def pending_transitions(self) -> tuple:
        """Controller drains (resume_ids, stop_ids) once per tick."""
        resume, self._resume = self._resume, []
        stop, self._stop = self._stop, []
        return resume, stop

    def on_trial_complete(self, trial_id: str) -> None:
        self.participants.discard(trial_id)
        # A natural finish may complete a rung its peers were waiting on.
        for idx in range(len(self.rung_levels)):
            self._maybe_complete_rung(idx)
