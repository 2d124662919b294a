"""Carry weights between the JAX package and the port.

Both packages keep one parameter tree (same names, same shapes, layers
stacked on a leading axis), so crossing over is a copy of numpy arrays.
This module takes and returns numpy only: it imports no JAX. JAX params
sharded on a mesh come across as `jax.device_get` gives them (whole numpy
arrays); `params_from_jax` lays them out on a torch mesh by the same
logical rules, and `params_to_numpy` gathers DTensors whole again.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ray_tpu_torch.models.transformer import (
    TransformerConfig, param_logical_axes, param_shapes, resolve_device)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, LogicalRules, param_shardings, shard_pytree)


def params_from_jax(np_tree: dict, cfg: TransformerConfig,
                    device: torch.device | str = "cuda", *,
                    mesh: DeviceMesh | None = None,
                    rules: LogicalRules = DEFAULT_RULES) -> dict:
    """The JAX param pytree, as numpy arrays, -> the port's params.

    Every leaf of `param_shapes(cfg)` must be present with its shape;
    values are cast to `cfg.param_dtype` on `device`. Under a `mesh`
    (whose device type replaces `device`) they become DTensors laid out
    by `param_logical_axes(cfg)` and `rules`.
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
    return shard_pytree(params, param_shardings(param_logical_axes(cfg), mesh, rules))


def params_to_numpy(params: dict) -> dict:
    """The port's params -> a tree of fp32 numpy arrays (the JAX layout).
    DTensors are gathered whole, so every rank of their mesh must call it."""
    def whole(w):
        w = w.detach()
        return w.full_tensor() if isinstance(w, DTensor) else w

    return {name: (params_to_numpy(w) if isinstance(w, dict)
                   else whole(w).float().cpu().numpy())
            for name, w in params.items()}
