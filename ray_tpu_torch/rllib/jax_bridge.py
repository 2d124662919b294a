"""Carry RL network weights and learner state between the JAX package and
the port.

Both packages name the weights alike (`pi_w0`, `q1_b2`, `gru_wr`, ...: flat
dicts, weights [fan_in, fan_out]), so crossing over is a copy of numpy
arrays by name; a learner's optax Adam states become the port's by field
(`learner_state_from_jax`). Takes and returns numpy only: it imports no
JAX (pass `jax.device_get` of a JAX tree).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def rl_params_from_jax(np_tree: Any, device: torch.device | str, *,
                       like: Optional[dict] = None) -> dict:
    """A flat dict of numpy arrays -> fp32 tensors on `device`. With `like`
    (a dict of tensors), the names and shapes must be `like`'s, and each
    tensor takes its dtype and requires_grad."""
    if like is not None:
        if set(np_tree) != set(like):
            raise ValueError(f"keys {sorted(np_tree)} != expected {sorted(like)}")
        for name, ref in like.items():
            shape = tuple(np.shape(np_tree[name]))
            if shape != tuple(ref.shape):
                raise ValueError(f"{name}: shape {shape} != {tuple(ref.shape)}")
    out = {}
    for name, value in np_tree.items():
        t = torch.from_numpy(np.array(value, np.float32)).to(device)
        if like is not None:
            t = t.to(like[name].dtype).requires_grad_(like[name].requires_grad)
        out[name] = t
    return out


def rl_params_to_numpy(params: dict) -> dict:
    """A (nested) dict of tensors -> the same tree of numpy arrays (copies,
    never views of the tensors)."""
    return {k: (rl_params_to_numpy(v) if isinstance(v, dict)
                else v.detach().cpu().numpy().copy()) for k, v in params.items()}


def _adam_moments(opt_state: Any) -> Any:
    """The optax ScaleByAdamState (count, mu, nu) in a state or a chain's
    tuple of states, found by its fields; None if there is none."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_moments(part)
            if found is not None:
                return found
    return None


def learner_state_from_jax(state: dict) -> dict:
    """A JAX learner's `get_state()` (numpy, `jax.device_get` of it) -> what
    the port learner's `set_state` takes: param trees and arrays as they
    are, and every optax Adam state, alone or in a chain, as the port's
    {"count", "mu", "nu"} (`rllib/optim.py`). The JAX key ("rng") is left
    out: the port draws its noise from a torch generator."""
    out = {}
    for key, value in state.items():
        if key == "rng":
            continue
        moments = _adam_moments(value)
        out[key] = value if moments is None else {
            "count": int(np.asarray(moments.count)),
            "mu": dict(moments.mu), "nu": dict(moments.nu)}
    return out
