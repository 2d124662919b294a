"""Learner: owns params + optimizer state + the update, counterpart of
`ray_tpu/rllib/core/learner.py`.

ref: rllib/core/learner/learner.py:107. Where the JAX learner compiles its
whole training iteration into one jitted program, a learner here runs it
eagerly on `device` ("cuda" by default; "cpu" runs the same code on CPU
tensors). Under a dp `DeviceMesh` (`parallel.mesh.build_mesh`, one rank
per process) every rank is given the same global batch and takes its rows
on axis 0; each minibatch's loss is written as this rank's share of the
global means (sums over its rows divided by the global count), and the
gradients and metric sums are summed over dp in one all-reduce, so the
update is the function JAX's sharded program computes, with the psum
written out. Params and optimizer state stay replicated.

Noise a JAX update draws from its key inside the program (PPO's
minibatch permutations, SAC's and CQL's action samples) is drawn here from
the learner's generator by `draw_noise` and passed to `update`, which
takes it as an argument, so a test can feed both packages the same noise.
Global-shaped noise is drawn whole on every rank (same generator, same
draws) and sliced like the batch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.models.transformer import resolve_device
from ray_tpu_torch.parallel.mesh import AXIS_DATA
from ray_tpu_torch.rllib.jax_bridge import rl_params_from_jax, rl_params_to_numpy


def _to_numpy(value: Any) -> Any:
    """Numpy copies (never views of the live tensors) of a state tree."""
    if isinstance(value, dict):
        return {k: _to_numpy(v) for k, v in value.items()}
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    if isinstance(value, torch.Generator):
        return value.get_state().numpy()
    return value


def _tensor(value: Any) -> torch.Tensor:
    """A tensor as is; anything else (numpy, a read-only JAX view) copied
    into a new one."""
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))


class Learner:
    """Base: device, dp rows, the all-reduce and the state plumbing;
    subclasses build the update.

    Contract: call `_setup(device, mesh, seed)` first, set `_state_attrs`
    to the attributes making up the full training state (leading
    underscores are stripped in the serialized keys; `_rng` is the noise
    generator, serialized as its state bytes), implement
    `update(batch, noise=None)` and, where the update draws noise,
    `draw_noise(batch)`.
    """

    _state_attrs: Tuple[str, ...] = ()
    mesh: Optional[DeviceMesh] = None

    def _setup(self, device: torch.device | str, mesh: Optional[DeviceMesh],
               seed: int) -> torch.Generator:
        """Set device, mesh and dp coordinates and the noise generator
        `_rng`; return a CPU generator seeded for the params' init (so a
        seed gives the same init on any device)."""
        self.mesh = mesh
        self._group = None
        self._rank, self._world = 0, 1
        if mesh is not None:
            if AXIS_DATA not in (mesh.mesh_dim_names or ()):
                raise ValueError(f"a learner mesh needs a {AXIS_DATA!r} dim, "
                                 f"got {mesh.mesh_dim_names}")
            dp = mesh[AXIS_DATA] if mesh.ndim > 1 else mesh
            self._world = dp.size()
            if self._world > 1:
                self._group, self._rank = dp.get_group(), dp.get_local_rank()
            device = mesh.device_type
            if device == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = resolve_device(device)
        self._rng = torch.Generator(self.device).manual_seed(seed + 1)
        return torch.Generator().manual_seed(seed)

    def _params_on_device(self, params: dict) -> dict:
        return {k: p.to(self.device).requires_grad_() for k, p in params.items()}

    # -- update ---------------------------------------------------------
    def update(self, batch: Dict[str, Any], noise: Optional[dict] = None):
        raise NotImplementedError

    def draw_noise(self, batch: Dict[str, Any]) -> dict:
        return {}

    # -- dp plumbing ----------------------------------------------------
    def _rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of `n` (all of them at dp 1)."""
        if n % self._world:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"dp {self._world}")
        per = n // self._world
        return slice(self._rank * per, (self._rank + 1) * per)

    def _local(self, batch: Dict[str, Any], keys) -> Dict[str, torch.Tensor]:
        """This rank's rows of `batch[keys]` as tensors on the device."""
        return self._slices(batch, {k: 0 for k in keys})

    def _slices(self, arrays: Dict[str, Any], axis: Dict[str, int]) -> dict:
        """This rank's slice of each global array (numpy or tensor) on
        `axis[k]`, on the device."""
        out = {}
        for k, dim in axis.items():
            v = _tensor(arrays[k])
            idx = [slice(None)] * v.dim()
            idx[dim] = self._rows(v.shape[dim])
            out[k] = v[tuple(idx)].to(self.device)
        return out

    def _psum(self, tensors: list) -> list:
        """Sum each tensor over dp in one all-reduce (as is at dp 1)."""
        if self._world == 1:
            return tensors
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, group=self._group)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
            i += t.numel()
        return out

    def _grads_and_metrics(self, loss: torch.Tensor, params: dict,
                           metrics: Dict[str, torch.Tensor]):
        """d loss / d params, summed over dp with the metric sums in the
        same all-reduce: (grads dict, metrics dict)."""
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        mnames = list(metrics)
        out = self._psum(list(grads) + [metrics[k].detach() for k in mnames])
        return (dict(zip(names, out[:len(names)])),
                dict(zip(mnames, out[len(names):])))

    # -- weights (what rollout/eval workers need) -----------------------
    def get_weights(self) -> Any:
        return rl_params_to_numpy(self.params)

    def set_weights(self, params: Any) -> None:
        self.params = rl_params_from_jax(params, self.device, like=self.params)

    # -- full training state (exact resume; ref: Learner.get_state) -----
    def get_state(self) -> Dict[str, Any]:
        return {attr.lstrip("_"): _to_numpy(getattr(self, attr))
                for attr in self._state_attrs}

    def set_state(self, state: Dict[str, Any]) -> None:
        for attr in self._state_attrs:
            key = attr.lstrip("_")
            if key in state:
                setattr(self, attr, self._restore(getattr(self, attr), state[key]))

    def _restore(self, current: Any, value: Any) -> Any:
        if isinstance(current, torch.Generator):
            current.set_state(torch.from_numpy(np.array(value, np.uint8)))
            return current
        if isinstance(current, dict) and all(
                isinstance(v, torch.Tensor) for v in current.values()):
            # A parameter dict: names and shapes checked.
            return rl_params_from_jax(value, self.device, like=current)
        if isinstance(current, dict):
            return {k: self._restore(current[k], value[k]) for k in current}
        if isinstance(current, torch.Tensor):
            return torch.tensor(np.asarray(value), dtype=current.dtype,
                                device=self.device).requires_grad_(
                                    current.requires_grad)
        return type(current)(value)
