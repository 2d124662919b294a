"""Carry weights between the JAX package and the port.

Both packages keep one parameter tree (same names, same shapes, layers
stacked on a leading axis), so crossing over is a copy of numpy arrays.
This module takes and returns numpy only: it imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.models.transformer import (
    TransformerConfig, param_shapes, resolve_device)


def params_from_jax(np_tree: dict, cfg: TransformerConfig,
                    device: torch.device | str = "cuda") -> dict:
    """The JAX param pytree, as numpy arrays, -> the port's params.

    Every leaf of `param_shapes(cfg)` must be present with its shape;
    values are cast to `cfg.param_dtype` on `device`.
    """
    device = resolve_device(device)

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

    return convert(param_shapes(cfg), np_tree, "")


def params_to_numpy(params: dict) -> dict:
    """The port's params -> a tree of fp32 numpy arrays (the JAX layout)."""
    return {name: (params_to_numpy(w) if isinstance(w, dict)
                   else w.detach().float().cpu().numpy())
            for name, w in params.items()}
