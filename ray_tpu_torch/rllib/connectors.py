"""Connectors: composable transforms between env, module, and learner;
a copy of `ray_tpu/rllib/connectors.py`.

ref: rllib/connectors/connector_v2.py — the new-stack pipeline that
sits on the three seams (env→module for observations, module→env for
actions, learner for training batches) so preprocessing lives OUTSIDE
both the environment and the network.

Connectors are plain numpy/host-side transforms — they run in the
rollout worker where branchy per-step work belongs, keeping the policy
and learner's device work free of data-dependent preprocessing.
Stateful connectors (running normalization) expose get_state/set_state
so checkpoints capture them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Connector:
    """One transform; __call__ must be shape-preserving or document
    its output space (obs_dim changes are not supported yet)."""

    def __call__(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class ConnectorPipeline(Connector):
    """Ordered composition (ref: connector_pipeline_v2.py)."""

    def __init__(self, connectors: List[Connector]):
        self.connectors = list(connectors)

    def __call__(self, data):
        for c in self.connectors:
            data = c(data)
        return data

    def get_state(self):
        return {str(i): c.get_state()
                for i, c in enumerate(self.connectors)}

    def set_state(self, state):
        for i, c in enumerate(self.connectors):
            if str(i) in state:
                c.set_state(state[str(i)])


class ObsNormalizer(Connector):
    """Running mean/std observation filter (ref: the MeanStdFilter
    connector role): Welford accumulation over every observation seen,
    normalize to ~N(0,1), clip outliers. Each rollout worker keeps its
    own stream — the filter converges to the same statistics on every
    worker since they sample the same policy/env distribution."""

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self.count = 0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        batch = obs.reshape(-1, obs.shape[-1]).astype(np.float64)
        if self.mean is None:
            self.mean = np.zeros(batch.shape[-1], np.float64)
            self.m2 = np.zeros(batch.shape[-1], np.float64)
        # Batched Chan parallel-variance merge: ONE vectorized update
        # per call (this sits on the hot rollout path, up to 3x per
        # env step — a per-row Python Welford loop costs O(E)
        # interpreter iterations per step).
        b_count = len(batch)
        if b_count:
            b_mean = batch.mean(axis=0)
            b_m2 = ((batch - b_mean) ** 2).sum(axis=0)
            total = self.count + b_count
            delta = b_mean - self.mean
            self.m2 += b_m2 + delta ** 2 * (self.count * b_count / total)
            self.mean += delta * (b_count / total)
            self.count = total
        std = np.sqrt(self.m2 / max(1, self.count - 1)) + self.eps
        out = (obs - self.mean.astype(np.float32)) / std.astype(np.float32)
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def get_state(self):
        return {"count": self.count,
                "mean": None if self.mean is None else self.mean.copy(),
                "m2": None if self.m2 is None else self.m2.copy()}

    def set_state(self, state):
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]


class ObsClip(Connector):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def __call__(self, obs):
        return np.clip(obs, self.low, self.high)


class ActionClip(Connector):
    """module→env: bound continuous actions to the env's legal range."""

    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def __call__(self, actions):
        return np.clip(actions, self.low, self.high)


class RewardScale(Connector):
    """learner connector (wire via
    `.env_runners(learner_connector=lambda: RewardScale(s))`): scales
    rewards in the training batch — a dict transform operating on the
    'rewards' key, leaving the rest untouched."""

    def __init__(self, scale: float):
        self.scale = scale

    def __call__(self, batch):
        out = dict(batch)
        out["rewards"] = np.asarray(batch["rewards"]) * self.scale
        return out
