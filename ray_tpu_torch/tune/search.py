"""Search spaces + basic variant generation; the port's copy of
`ray_tpu/tune/search.py` (pure Python and numpy: the same seed gives the
same suggestions).

Reference: `tune.grid_search/choice/uniform/...` sampling primitives and
`BasicVariantGenerator` grid×random expansion
(ref: python/ray/tune/search/sample.py, search/basic_variant.py).
"""
from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low, high):
        import math

        self._lo, self._hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self._lo, self._hi))


class Randint(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class QUniform(Domain):
    def __init__(self, low, high, q):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        return round(v / self.q) * self.q


def domain_to_unit(dom, v) -> "Optional[float]":
    """Map a numeric value into [0, 1] over its domain (None for
    categorical/grid axes). Shared by model-based searchers so the
    normalization cannot drift between them."""
    import math

    if v is None:
        return None
    if isinstance(dom, (Uniform, QUniform, Randint)):
        span = float(dom.high - dom.low) or 1.0
        return (v - dom.low) / span
    if isinstance(dom, LogUniform):
        span = (dom._hi - dom._lo) or 1.0
        return (math.log(max(v, 1e-300)) - dom._lo) / span
    return None


def domain_from_unit(dom, u: float):
    """Inverse of domain_to_unit (u clipped to [0, 1] by the caller)."""
    import math

    if isinstance(dom, LogUniform):
        return math.exp(dom._lo + u * (dom._hi - dom._lo))
    if isinstance(dom, Randint):
        return min(dom.low + int(u * (dom.high - dom.low)), dom.high - 1)
    v = dom.low + u * (dom.high - dom.low)
    if isinstance(dom, QUniform):
        v = round(v / dom.q) * dom.q
    return v


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


# public constructors (tune.* names)
def grid_search(values) -> GridSearch:
    return GridSearch(values)


def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> Randint:
    return Randint(low, high)


def quniform(low, high, q) -> QUniform:
    return QUniform(low, high, q)


def sample_from(fn: Callable[[dict], Any]):
    class _SampleFrom(Domain):
        def __init__(self):
            self.fn = fn

        def sample(self, rng):
            return self.fn({})

    return _SampleFrom()


def generate_variants(param_space: Dict[str, Any], num_samples: int,
                      seed: Optional[int] = None) -> List[Dict[str, Any]]:
    """Cross-product of grid axes × num_samples random draws of the rest
    (ref: basic_variant.py semantics)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items()
                 if isinstance(v, GridSearch)]
    grid_values = [param_space[k].values for k in grid_keys]
    variants = []
    for combo in itertools.product(*grid_values) if grid_keys else [()]:
        for _ in range(num_samples):
            cfg = {}
            for k, v in param_space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants


# ---------------------------------------------------------------------------
# Searcher plug-in interface (ref: python/ray/tune/search/searcher.py —
# Searcher.suggest/on_trial_result/on_trial_complete; integrations like
# OptunaSearch implement the same surface)
# ---------------------------------------------------------------------------

class Searcher:
    """Suggest configs one trial at a time; observe results to adapt.

    set_space() is called by the Tuner before the first suggest with the
    param_space and optimization target."""

    def set_space(self, param_space: Dict[str, Any], metric: Optional[str],
                  mode: str, seed: Optional[int] = None) -> None:
        self.param_space = param_space
        self.metric = metric
        self.mode = mode
        self.rng = random.Random(seed)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict] = None) -> None:
        pass

    def _random_config(self) -> Dict[str, Any]:
        cfg = {}
        for k, v in self.param_space.items():
            if isinstance(v, GridSearch):
                cfg[k] = self.rng.choice(v.values)
            elif isinstance(v, Domain):
                cfg[k] = v.sample(self.rng)
            else:
                cfg[k] = v
        return cfg


class BasicVariantGenerator(Searcher):
    """Random/grid sampling as a Searcher (ref: search/basic_variant.py)."""

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        return self._random_config()


class AskTellSearcher(Searcher):
    """Adapter for external ask/tell optimizers (ref: the role the
    Optuna/Ax/BayesOpt adapters fill, tune/search/optuna/
    optuna_search.py:1 — each wraps a library behind the Searcher
    surface; this is the ONE seam they all reduce to).

    The wrapped optimizer needs exactly two methods:

        ask() -> config dict            (next point to evaluate)
        tell(config, value) -> None     (observed objective; maximized)

    The adapter handles metric extraction, min/max sign, and config
    bookkeeping per trial, so a scikit-optimize/nevergrad/CMA-style
    optimizer plugs into the Tuner in ~5 lines.
    """

    def __init__(self, optimizer: Any):
        for attr in ("ask", "tell"):
            if not callable(getattr(optimizer, attr, None)):
                raise TypeError(
                    f"ask/tell optimizer needs a callable {attr}()")
        self._opt = optimizer
        self._live: Dict[str, Dict[str, Any]] = {}

    def set_space(self, param_space, metric, mode, seed=None) -> None:
        if metric is None:
            # Without a metric, tell() would never fire and the
            # optimizer silently degrades to random — misconfiguration,
            # not a mode.
            raise ValueError(
                "AskTellSearcher needs TuneConfig.metric set — the "
                "wrapped optimizer learns from tell(config, value)")
        super().set_space(param_space, metric, mode, seed)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        cfg = self._opt.ask()
        if cfg is None:
            return None                 # optimizer exhausted
        cfg = dict(cfg)
        self._live[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict] = None) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None:
            return
        value = (result or {}).get(self.metric)
        if value is None:
            return                      # failed trial: nothing to learn
        if self.mode == "min":
            value = -value
        self._opt.tell(cfg, float(value))


class TPESearcher(Searcher):
    """Native adaptive searcher in the TPE spirit (ref: the role Optuna's
    TPE fills behind search/optuna.py): after `n_initial` random trials,
    candidates are drawn near the top-`gamma` observed configs (Gaussian
    jitter for numeric axes, frequency-weighted choice for categorical)
    and the best of `n_candidates` under a nearest-neighbour score is
    suggested."""

    def __init__(self, n_initial: int = 5, gamma: float = 0.25,
                 n_candidates: int = 16, jitter: float = 0.15):
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.jitter = jitter
        self._obs: List[tuple] = []     # (config, score)
        self._live: Dict[str, dict] = {}

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._obs) < self.n_initial:
            cfg = self._random_config()
        else:
            cfg = self._adaptive_config()
        self._live[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict] = None) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None or not result or self.metric not in result:
            return
        score = result[self.metric]
        if self.mode == "min":
            score = -score
        self._obs.append((cfg, score))

    def _split_configs(self) -> tuple:
        ranked = sorted(self._obs, key=lambda o: -o[1])
        k = max(1, int(len(ranked) * self.gamma))
        return ([cfg for cfg, _ in ranked[:k]],
                [cfg for cfg, _ in ranked[k:]])

    def _distance(self, a: dict, b: dict) -> float:
        """Normalized config distance: numeric axes scaled to their
        domain span, categorical mismatch counts 1."""
        import math

        d = 0.0
        for key, dom in self.param_space.items():
            if isinstance(dom, (Uniform, QUniform, Randint)):
                span = float(dom.high - dom.low) or 1.0
                d += ((a[key] - b[key]) / span) ** 2
            elif isinstance(dom, LogUniform):
                span = (dom._hi - dom._lo) or 1.0
                d += ((math.log(max(a[key], 1e-300))
                       - math.log(max(b[key], 1e-300))) / span) ** 2
            elif isinstance(dom, (Categorical, GridSearch, Domain)):
                d += 0.0 if a.get(key) == b.get(key) else 1.0
        return math.sqrt(d)

    def _adaptive_config(self) -> Dict[str, Any]:
        top, bad = self._split_configs()
        best = None
        best_score = None
        for _ in range(self.n_candidates):
            anchor = self.rng.choice(top)
            cand = {}
            for key, dom in self.param_space.items():
                if isinstance(dom, (Uniform, QUniform)):
                    span = (dom.high - dom.low) * self.jitter
                    v = anchor[key] + self.rng.gauss(0.0, span)
                    v = min(max(v, dom.low), dom.high)
                    if isinstance(dom, QUniform):
                        v = round(v / dom.q) * dom.q
                    cand[key] = v
                elif isinstance(dom, LogUniform):
                    import math

                    lv = math.log(anchor[key]) + self.rng.gauss(
                        0.0, (dom._hi - dom._lo) * self.jitter)
                    cand[key] = math.exp(min(max(lv, dom._lo), dom._hi))
                elif isinstance(dom, Randint):
                    span = max(1, int((dom.high - dom.low) * self.jitter))
                    v = anchor[key] + self.rng.randint(-span, span)
                    cand[key] = min(max(v, dom.low), dom.high - 1)
                elif isinstance(dom, (Categorical, GridSearch)):
                    values = (dom.categories
                              if isinstance(dom, Categorical) else dom.values)
                    counts = {v: 1 for v in values}
                    for c in top:
                        if c[key] in counts:
                            counts[c[key]] += 2
                    total = sum(counts.values())
                    r = self.rng.uniform(0, total)
                    acc = 0
                    for v, w in counts.items():
                        acc += w
                        if r <= acc:
                            cand[key] = v
                            break
                elif isinstance(dom, Domain):
                    cand[key] = dom.sample(self.rng)
                else:
                    cand[key] = dom
            # 1-NN surrogate: prefer candidates near the good group and
            # far from the bad group (the l(x)/g(x) ratio TPE optimizes,
            # reduced to nearest-neighbour distances).
            d_good = min(self._distance(cand, c) for c in top)
            d_bad = (min(self._distance(cand, c) for c in bad)
                     if bad else 1.0)
            score = d_bad - d_good
            if best_score is None or score > best_score:
                best, best_score = cand, score
        return best


class BOHBSearcher(Searcher):
    """Model-based HyperBand companion (ref: tune/search/bohb/bohb_search.py
    TuneBOHB + schedulers/hb_bohb.py — BOHB, Falkner et al. 2018).

    Observations are grouped by BUDGET (`result[time_attr]`, collected
    from every intermediate report), exactly BOHB's trick: successive
    halving produces many cheap low-budget observations and few
    expensive high-budget ones, and the model always conditions on the
    LARGEST budget that has enough points. Candidates are sampled
    around the top-`gamma` configs of that budget and ranked by the
    TPE density ratio l(x)/g(x) under product kernel-density models
    (Gaussian kernels on domain-normalized numeric axes, smoothed
    frequencies on categorical axes). A `random_fraction` of suggests
    stays uniform so the model never starves exploration.

    Pair with `HyperBandScheduler` (the reference pairs TuneBOHB with
    HyperBandForBOHB the same way).
    """

    def set_space(self, param_space, metric, mode, seed=None) -> None:
        if metric is None:
            # Same rule as AskTellSearcher: without a metric no
            # observation is ever recorded and the model silently
            # degrades to random — misconfiguration, not a mode.
            raise ValueError(
                "BOHBSearcher needs TuneConfig.metric set — the KDE "
                "model learns from reported results")
        super().set_space(param_space, metric, mode, seed)

    def __init__(self, *, time_attr: str = "training_iteration",
                 gamma: float = 0.25, n_candidates: int = 24,
                 min_points: int = 6, bandwidth: float = 0.15,
                 random_fraction: float = 0.2):
        self.time_attr = time_attr
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.min_points = min_points
        self.bandwidth = bandwidth
        self.random_fraction = random_fraction
        # budget -> {trial_id: (config, best score at that budget)}
        self._obs: Dict[Any, Dict[str, tuple]] = {}
        self._live: Dict[str, dict] = {}

    # -- observation intake --------------------------------------------
    def _record(self, trial_id: str, result: Optional[dict]) -> None:
        cfg = self._live.get(trial_id)
        if cfg is None or not result:
            return
        val = result.get(self.metric)
        budget = result.get(self.time_attr)
        if val is None or budget is None:
            return
        score = -val if self.mode == "min" else val
        rung = self._obs.setdefault(budget, {})
        prev = rung.get(trial_id)
        if prev is None or score > prev[1]:
            rung[trial_id] = (cfg, score)

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        self._record(trial_id, result)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict] = None) -> None:
        self._record(trial_id, result)
        self._live.pop(trial_id, None)

    # -- model ----------------------------------------------------------
    def _log_density(self, unit_points: List[dict], points: List[dict],
                     cand_units: dict, cand: dict) -> float:
        """Product-kernel KDE log-density of the candidate under
        `points` (with `unit_points` their precomputed unit coords)."""
        import math

        total = 0.0
        for key, dom in self.param_space.items():
            u = cand_units.get(key)
            if u is not None:
                h = self.bandwidth
                dens = sum(
                    math.exp(-0.5 * ((u - up[key]) / h) ** 2)
                    for up in unit_points) / (len(unit_points) * h)
                total += math.log(max(dens, 1e-12))
            else:
                values = (dom.values if isinstance(dom, GridSearch)
                          else dom.categories
                          if isinstance(dom, Categorical) else None)
                if values is None:
                    continue
                n_match = sum(1 for p in points if p[key] == cand[key])
                total += math.log((n_match + 1.0)
                                  / (len(points) + len(values)))
        return total

    def _units(self, cfg: dict) -> dict:
        return {k: domain_to_unit(dom, cfg[k])
                for k, dom in self.param_space.items()}

    def _model_budget(self) -> Optional[Any]:
        eligible = [b for b, rung in self._obs.items()
                    if len(rung) >= self.min_points]
        return max(eligible) if eligible else None

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        budget = self._model_budget()
        ranked = (sorted(self._obs[budget].values(), key=lambda o: -o[1])
                  if budget is not None else [])
        k = max(2, int(len(ranked) * self.gamma))
        good = [cfg for cfg, _ in ranked[:k]]
        bad = [cfg for cfg, _ in ranked[k:]]
        if not bad or budget is None \
                or self.rng.random() < self.random_fraction:
            # No usable split yet (or the exploration draw): uniform.
            cfg = self._random_config()
            self._live[trial_id] = cfg
            return cfg
        good_units = [self._units(c) for c in good]
        bad_units = [self._units(c) for c in bad]

        best, best_ratio = None, None
        for _ in range(self.n_candidates):
            # sample around a good config (jittered in unit space)
            anchor = self.rng.choice(good)
            cand = {}
            for key, dom in self.param_space.items():
                u = domain_to_unit(dom, anchor.get(key))
                if u is not None:
                    u = min(max(u + self.rng.gauss(0.0, self.bandwidth),
                                0.0), 1.0)
                    cand[key] = domain_from_unit(dom, u)
                elif isinstance(dom, (Categorical, GridSearch)):
                    values = (dom.categories if isinstance(dom, Categorical)
                              else dom.values)
                    # mostly keep the anchor's choice, sometimes explore
                    cand[key] = (anchor[key]
                                 if self.rng.random() > 0.25
                                 and anchor[key] in values
                                 else self.rng.choice(values))
                elif isinstance(dom, Domain):
                    cand[key] = dom.sample(self.rng)
                else:
                    cand[key] = dom
            cu = self._units(cand)
            ratio = (self._log_density(good_units, good, cu, cand)
                     - self._log_density(bad_units, bad, cu, cand))
            if best_ratio is None or ratio > best_ratio:
                best, best_ratio = cand, ratio
        self._live[trial_id] = best
        return best


class ConcurrencyLimiter(Searcher):
    """Cap a searcher's outstanding suggestions (ref: search/
    concurrency_limiter.py) — adaptive searchers learn little from 64
    blind parallel draws."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._outstanding: set = set()

    def set_space(self, *args, **kwargs) -> None:
        self.searcher.set_space(*args, **kwargs)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._outstanding) >= self.max_concurrent:
            return None      # Tuner retries on a later tick
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._outstanding.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict] = None) -> None:
        self._outstanding.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result)
