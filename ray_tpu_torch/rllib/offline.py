"""Offline RL IO and behavior cloning, counterpart of
`ray_tpu/rllib/offline.py`.

ref: rllib/offline/json_writer.py (rollout recording) and the BC and MARWIL
algorithms (rllib/algorithms/bc, rllib/algorithms/marwil). `SampleWriter`,
`_columnar`, `discounted_returns` and `record_rollouts` are copies: they
write the same parquet and JSON shards. `BCLearner` and `MARWILLearner`
run JAX's update functions eagerly on `device` ("cuda" by default) with
the port's Adam.

The JAX package reads the shards back through its data executor
(`read_samples`, and `BC`/`MARWIL` training on what it reads); the port's
executor is ROADMAP queue A, item 10b, so those raise.
The learners train on any arrays of rows.
"""
from __future__ import annotations

import json
import os
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.transformer import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.jax_bridge import rl_params_from_jax, rl_params_to_numpy
from ray_tpu_torch.rllib.models import apply_mlp_policy, init_mlp_policy
from ray_tpu_torch.rllib.optim import Adam

_NEEDS_EXECUTOR = ("reads offline shards through the data executor, which is "
                   "not ported yet (ROADMAP queue A, item 10b)")


class SampleWriter:
    """Shard-per-flush columnar sample recorder (ref: JsonWriter —
    max_file_size rotation; here one parquet shard per flush)."""

    def __init__(self, path: str, fmt: str = "parquet",
                 rows_per_shard: int = 10_000):
        if fmt not in ("parquet", "json"):
            raise ValueError(f"unsupported offline format {fmt!r}")
        self.path = path
        self.fmt = fmt
        self.rows_per_shard = rows_per_shard
        self._pending: List[Dict[str, np.ndarray]] = []
        self._pending_rows = 0
        os.makedirs(path, exist_ok=True)

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        self._pending.append({k: np.asarray(v) for k, v in batch.items()})
        self._pending_rows += len(next(iter(batch.values())))
        if self._pending_rows >= self.rows_per_shard:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        merged = {k: np.concatenate([b[k] for b in self._pending])
                  for k in self._pending[0]}
        self._pending, self._pending_rows = [], 0
        shard = os.path.join(self.path, f"samples-{uuid.uuid4().hex[:12]}")
        if self.fmt == "parquet":
            import pyarrow as pa
            import pyarrow.parquet as pq

            cols = {}
            for k, v in merged.items():
                if v.ndim == 1:
                    cols[k] = pa.array(v)
                else:  # fixed-width vector columns (obs, actions)
                    cols[k] = pa.FixedSizeListArray.from_arrays(
                        pa.array(v.reshape(-1)), v.shape[1])
            pq.write_table(pa.table(cols), shard + ".parquet")
        else:
            with open(shard + ".json", "w") as f:
                for i in range(len(next(iter(merged.values())))):
                    row = {k: (v[i].tolist() if v.ndim > 1 else v[i].item())
                           for k, v in merged.items()}
                    f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self.flush()


def read_samples(path: str):
    """The JAX package returns a Dataset of the shards under `path`."""
    raise NotImplementedError(f"read_samples {_NEEDS_EXECUTOR}")


def _columnar(rows: List[dict]) -> Dict[str, np.ndarray]:
    out = {}
    for k in rows[0]:
        v0 = rows[0][k]
        if isinstance(v0, (list, np.ndarray)):
            out[k] = np.asarray([r[k] for r in rows], np.float32)
        else:
            out[k] = np.asarray([r[k] for r in rows])
    return out


def discounted_returns(rewards: np.ndarray, dones: np.ndarray,
                       gamma: float) -> np.ndarray:
    """Per-row Monte-Carlo returns over recorded episodes (trailing
    partial episodes bootstrap 0 — offline data has no value net yet)."""
    out = np.zeros_like(rewards, dtype=np.float32)
    acc = 0.0
    for i in range(len(rewards) - 1, -1, -1):
        if dones[i]:
            acc = 0.0
        acc = rewards[i] + gamma * acc
        out[i] = acc
    return out


class BCConfig(AlgorithmConfig):
    """Behavior cloning: supervised policy learning from recorded
    samples — zero environment interaction during training."""

    def __init__(self):
        super().__init__(algo_class=BC)
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_updates_per_iteration = 32
        self.input_path: Optional[str] = None

    def offline_data(self, *, input_path: str) -> "BCConfig":
        self.input_path = input_path
        return self

    def training(self, *, lr=None, train_batch_size=None,
                 num_updates_per_iteration=None, **kwargs) -> "BCConfig":
        for k, v in dict(
                lr=lr, train_batch_size=train_batch_size,
                num_updates_per_iteration=num_updates_per_iteration).items():
            if v is not None:
                setattr(self, k, v)
        return super().training(**kwargs)


class BCLearner:
    """The NLL step over the discrete policy head (pi/v towers of
    `init_mlp_policy`; only pi trains)."""

    def __init__(self, obs_dim: int, num_actions: int, lr: float,
                 seed: int = 0, hidden=(64, 64),
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        params = init_mlp_policy(torch.Generator().manual_seed(seed), obs_dim,
                                 num_actions, hidden)
        self.params = {k: p.to(self.device).requires_grad_()
                       for k, p in params.items()}
        self._tx = Adam(lr)
        self.opt_state = self._tx.init(self.params)

    def _tensors(self, obs, actions, *more):
        out = [torch.as_tensor(np.asarray(obs, np.float32), device=self.device),
               torch.as_tensor(np.asarray(actions, np.int64), device=self.device)]
        return out + [torch.as_tensor(np.asarray(x, np.float32), device=self.device)
                      for x in more]

    def _nll(self, logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        return -F.log_softmax(logits, -1).gather(1, actions[:, None])[:, 0]

    def _step(self, loss: torch.Tensor) -> None:
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names],
                                    allow_unused=True)
        # The value tower has no part in BC's loss: optax gives it zeros.
        grads = {k: torch.zeros_like(self.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        self._tx.update(grads, self.opt_state, self.params)

    def update(self, obs: np.ndarray, actions: np.ndarray) -> float:
        obs, actions = self._tensors(obs, actions)
        logits, _ = apply_mlp_policy(self.params, obs)
        loss = self._nll(logits, actions).mean()
        self._step(loss)
        return float(loss.detach())

    def get_weights(self):
        return rl_params_to_numpy(self.params)

    def set_weights(self, params) -> None:
        self.params = rl_params_from_jax(params, self.device, like=self.params)


class BC(Algorithm):
    """The JAX package's BC samples minibatches from the offline Dataset;
    that reader needs the port's runtime."""

    def _setup_learner(self, obs_dim: int, num_actions: int) -> BCLearner:
        raise NotImplementedError(
            f"BC {_NEEDS_EXECUTOR}; train a BCLearner on arrays of rows instead")


class MARWILConfig(BCConfig):
    """Monotonic Advantage Re-Weighted Imitation Learning (ref:
    rllib/algorithms/marwil/marwil.py): behavior cloning where each
    action's log-likelihood is weighted by exp(beta * advantage), so
    good recorded behavior is imitated harder than bad. beta=0 reduces
    exactly to BC (the reference documents the same identity)."""

    def __init__(self):
        super().__init__()
        self.algo_class = MARWIL
        self.beta = 1.0
        self.gamma = 0.99
        self.vf_coeff = 1.0

    def training(self, *, beta=None, gamma=None, vf_coeff=None,
                 **kwargs) -> "MARWILConfig":
        for k, v in dict(beta=beta, gamma=gamma, vf_coeff=vf_coeff).items():
            if v is not None:
                setattr(self, k, v)
        return super().training(**kwargs)


class MARWILLearner(BCLearner):
    """One update: value regression to Monte-Carlo returns plus the
    advantage-exponentiated NLL through the pi/v towers."""

    def __init__(self, obs_dim: int, num_actions: int, lr: float,
                 beta: float, vf_coeff: float, seed: int = 0,
                 hidden=(64, 64), device: torch.device | str = "cuda"):
        super().__init__(obs_dim, num_actions, lr, seed=seed, hidden=hidden,
                         device=device)
        self.beta = beta
        self.vf_coeff = vf_coeff

    def update(self, obs, actions, returns) -> Dict[str, float]:
        obs, actions, returns = self._tensors(obs, actions, returns)
        logits, value = apply_mlp_policy(self.params, obs)
        nll = self._nll(logits, actions)
        vf = (value - returns) ** 2
        adv = (returns - value).detach()
        # Batch-normalized advantage inside the exp keeps the weights
        # scale-free (the reference tracks a running moment for the same
        # purpose, marwil.py moving-average c^2). jnp.std: ddof 0.
        a_norm = adv / (adv.std(correction=0) + 1e-6)
        w = torch.clamp_max(torch.exp(self.beta * a_norm), 20.0)   # clip blowup
        loss = (w * nll).mean() + self.vf_coeff * vf.mean()
        self._step(loss)
        out = torch.stack([loss, nll.mean(), vf.mean()]).detach().tolist()
        return dict(zip(("marwil_loss", "policy_nll", "vf_loss"), out))


class MARWIL(Algorithm):
    """Offline training like BC, with per-row Monte-Carlo returns feeding
    the advantage weights; its reader needs the port's runtime."""

    def _setup_learner(self, obs_dim: int, num_actions: int) -> MARWILLearner:
        raise NotImplementedError(
            f"MARWIL {_NEEDS_EXECUTOR}; train a MARWILLearner on arrays of "
            "rows instead")


def record_rollouts(algo: Algorithm, path: str, num_iterations: int = 4,
                    fmt: str = "parquet") -> str:
    """Record an algorithm's on-policy rollouts to offline shards
    (ref: `output` config in the reference — rollout recording)."""
    writer = SampleWriter(path, fmt=fmt)
    for _ in range(num_iterations):
        batch, _ = algo._sample_rollouts()
        flat = {
            "obs": batch["obs"].reshape(-1, batch["obs"].shape[-1]),
            "actions": batch["actions"].reshape(-1),
            "rewards": batch["rewards"].reshape(-1),
            "dones": batch["dones"].reshape(-1),
        }
        writer.write(flat)
    writer.close()
    return path
