"""Carry weights between the JAX package and the port.

Both packages keep one parameter tree (same names, same shapes, layers
stacked on a leading axis), so crossing over is a copy of numpy arrays.
This module takes and returns numpy only: it imports no JAX. JAX params
sharded on a mesh come across as `jax.device_get` gives them (whole numpy
arrays); `params_from_jax` lays them out on a torch mesh by the same
logical rules (or by the shardings the caller passes, such as a pipeline's
stage split), and
`params_to_numpy` gathers DTensors whole again. `adam_state_from_jax`
carries optax's Adam moments into a train state's torch AdamW.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from ray_tpu_torch.models.transformer import (
    TransformerConfig, param_logical_axes, param_shapes, resolve_device)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, LogicalRules, local_tensor, param_shardings, shard_pytree)


def params_from_jax(np_tree: dict, cfg: TransformerConfig,
                    device: torch.device | str = "cuda", *,
                    mesh: DeviceMesh | None = None,
                    rules: LogicalRules = DEFAULT_RULES,
                    shardings: dict | None = None) -> dict:
    """The JAX param pytree, as numpy arrays, -> the port's params.

    Every leaf of `param_shapes(cfg)` must be present with its shape;
    values are cast to `cfg.param_dtype` on `device`. Under a `mesh`
    (whose device type replaces `device`) they become DTensors laid out
    by `param_logical_axes(cfg)` and `rules`, or by `shardings` (a tree of
    `NamedSharding`s, e.g. `parallel.pipeline.pipeline_shardings`) when
    given.
    """
    device = resolve_device(device if mesh is None else mesh.device_type)

    def convert(shapes, tree, path):
        if set(shapes) != set(tree):
            raise ValueError(f"{path or 'params'}: keys {sorted(tree)} != "
                             f"expected {sorted(shapes)}")
        out = {}
        for name, shape in shapes.items():
            if isinstance(shape, dict):
                out[name] = convert(shape, tree[name], f"{path}{name}/")
                continue
            arr = np.asarray(tree[name])
            if arr.shape != shape:
                raise ValueError(f"{path}{name}: shape {arr.shape} != {shape}")
            out[name] = torch.from_numpy(np.array(arr, np.float32)).to(
                device=device, dtype=cfg.param_dtype)
        return out

    params = convert(param_shapes(cfg), np_tree, "")
    if mesh is None:
        return params
    if shardings is None:
        shardings = param_shardings(param_logical_axes(cfg), mesh, rules)
    return shard_pytree(params, shardings)


def params_to_numpy(params: dict) -> dict:
    """The port's params -> a tree of fp32 numpy arrays (the JAX layout).
    DTensors are gathered whole, so every rank of their mesh must call it."""
    def whole(w):
        w = w.detach()
        return w.full_tensor() if isinstance(w, DTensor) else w

    return {name: (params_to_numpy(w) if isinstance(w, dict)
                   else whole(w).float().cpu().numpy())
            for name, w in params.items()}


def adam_state_from_jax(state, mu: dict, nu: dict, count: int) -> None:
    """Put optax's Adam state (`ScaleByAdamState.mu`/`.nu` as numpy trees
    in the params' layout, and its update `count`) into `state`, a
    `models.training.TrainState` whose optimizer is a torch AdamW over its
    leaves (`default_optimizer()` or `AdamW()`); `state.step` becomes
    `count`. A DTensor leaf takes its own shard of each moment."""
    opt = state.opt_state
    locals_ = iter(opt.param_groups[0]["params"])

    def put(params, m, v):
        for name, leaf in params.items():
            if isinstance(leaf, dict):
                put(leaf, m[name], v[name])
                continue
            local = next(locals_)
            st = opt.state[local]
            st["step"] = torch.tensor(float(count), dtype=torch.float32)
            for key, arr in (("exp_avg", m[name]), ("exp_avg_sq", v[name])):
                full = torch.from_numpy(np.array(arr, np.float32)).to(
                    local.device, local.dtype)
                if isinstance(leaf, DTensor):
                    full = local_tensor(distribute_tensor(
                        full, leaf.device_mesh, leaf.placements))
                st[key] = full.reshape(local.shape).clone()

    put(state.params, mu, nu)
    state.step = int(count)
