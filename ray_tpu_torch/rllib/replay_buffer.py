"""Replay buffers: uniform + prioritized experience replay; a copy of
`ray_tpu/rllib/replay_buffer.py`.

ref: rllib/utils/replay_buffers/{replay_buffer.py,
prioritized_replay_buffer.py} — ring storage, proportional priority
sampling with importance weights and post-update priority writes.
Storage is flat numpy rings (one array per field), so sampling is pure
vectorized indexing.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._store: Optional[Dict[str, np.ndarray]] = None
        self._size = 0
        self._pos = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        if self._store is None:
            self._store = {
                k: np.empty((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in batch.items()}
        idx = (self._pos + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._store[k][idx] = v
        self._pos = (self._pos + n) % self.capacity
        self._size = min(self._size + n, self.capacity)
        self._on_add(idx)

    def _on_add(self, idx: np.ndarray) -> None:
        pass

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, batch_size)
        out = {k: v[idx] for k, v in self._store.items()}
        out["batch_indexes"] = idx
        out["weights"] = np.ones(batch_size, np.float32)
        return out

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        pass  # uniform: no-op


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional PER (ref: prioritized_replay_buffer.py): sample
    P(i) ∝ p_i^alpha, correct with importance weights
    w_i = (N * P(i))^-beta / max w, write back |td_error| + eps."""

    def __init__(self, capacity: int, *, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self._prio = np.zeros(capacity, np.float64)
        self._max_prio = 1.0

    def _on_add(self, idx: np.ndarray) -> None:
        self._prio[idx] = self._max_prio ** self.alpha

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        p = self._prio[:self._size]
        total = p.sum()
        if total <= 0:
            return super().sample(batch_size)
        probs = p / total
        idx = self._rng.choice(self._size, batch_size, p=probs)
        weights = (self._size * probs[idx]) ** (-self.beta)
        weights = (weights / weights.max()).astype(np.float32)
        out = {k: v[idx] for k, v in self._store.items()}
        out["batch_indexes"] = idx
        out["weights"] = weights
        return out

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        pr = np.abs(priorities) + self.eps
        self._prio[idx] = pr ** self.alpha
        self._max_prio = max(self._max_prio, float(pr.max()))


class SequenceReplayBuffer:
    """Contiguous-window replay for recurrent world models.

    ref: rllib/utils/replay_buffers/episode_replay_buffer.py — the
    reference stores episodes and samples fixed-length chunks for
    DreamerV3. Here each env stream gets its own time-ring of numpy
    arrays; `sample(B, L)` returns [B, L, ...] windows drawn uniformly
    over (env, start) pairs. Windows never cross the ring's write head
    (they may span episode boundaries — records carry `is_first` so the
    model resets its recurrent state mid-window, exactly how the
    reference feeds chunked sequences).
    """

    def __init__(self, capacity_per_env: int, seed: int = 0):
        self.capacity = capacity_per_env
        self._streams: list = []           # env -> field -> [cap, ...]
        self._len: list = []               # env -> valid records
        self._pos: list = []               # env -> next write slot
        self._rng = np.random.default_rng(seed)
        self._total = 0

    def __len__(self) -> int:
        return self._total

    def add(self, env_i: int, record: Dict[str, np.ndarray]) -> None:
        """Append one record (field -> scalar or 1-D array) to env_i's
        stream."""
        while len(self._streams) <= env_i:
            self._streams.append(None)
            self._len.append(0)
            self._pos.append(0)
        if self._streams[env_i] is None:
            self._streams[env_i] = {
                k: np.zeros((self.capacity,) + np.shape(v),
                            np.asarray(v).dtype)
                for k, v in record.items()}
        st = self._streams[env_i]
        pos = self._pos[env_i]
        for k, v in record.items():
            st[k][pos] = v
        self._pos[env_i] = (pos + 1) % self.capacity
        if self._len[env_i] < self.capacity:
            self._len[env_i] += 1
            self._total += 1

    def can_sample(self, length: int) -> bool:
        return any(n >= length for n in self._len)

    def sample(self, batch_size: int, length: int
               ) -> Dict[str, np.ndarray]:
        """[B, L, ...] windows, uniform over (env, start) pairs: each
        env is weighted by its valid-window count, so records in short
        streams are not oversampled. Envs with fewer than `length`
        records are excluded; raises if no env has enough yet."""
        ok = [i for i, n in enumerate(self._len) if n >= length]
        if not ok:
            raise ValueError(
                f"no env stream has {length} records yet (sizes: "
                f"{self._len})")
        windows = np.array([self._len[i] - length + 1 for i in ok],
                           np.float64)
        envs = self._rng.choice(ok, batch_size, p=windows / windows.sum())
        batches = {k: [] for k in self._streams[ok[0]]}
        for i in envs:
            n, pos = self._len[i], self._pos[i]
            start = int(self._rng.integers(0, n - length + 1))
            # oldest record lives at (pos - n) mod cap
            idx = (pos - n + start + np.arange(length)) % self.capacity
            for k, arr in self._streams[i].items():
                batches[k].append(arr[idx])
        return {k: np.stack(v) for k, v in batches.items()}
