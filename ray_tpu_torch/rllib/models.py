"""Policy and value networks as functions on a dict of tensors,
counterpart of `ray_tpu/rllib/models.py`.

Params are flat dicts with the JAX package's names (`pi_w0`, `v_b1`,
`actor_w2`, `q1_w0`, ...), weights [fan_in, fan_out], so weights cross
over by name (`rllib/jax_bridge.py`). Init draws from an explicit
`torch.Generator` at the JAX package's scales (the draws differ from
jax.random's). Noise is an argument: `sample_squashed` takes the
standard-normal draw, so a learner can take it from its generator or a
test from JAX's key.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


def _init_mlp(generator: torch.Generator, prefix: str, sizes: Sequence[int],
              params: Params, final_scale: float = 1.0) -> None:
    """N(0, 2/fan_in) weights (the last layer times `final_scale`) and zero
    biases, on the generator's device."""
    device = generator.device
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = math.sqrt(2.0 / fan_in)
        if i == len(sizes) - 2:
            scale *= final_scale
        params[f"{prefix}_w{i}"] = torch.randn(
            fan_in, fan_out, generator=generator, device=device) * scale
        params[f"{prefix}_b{i}"] = torch.zeros(fan_out, device=device)


def _apply_mlp(params: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b per layer, tanh between layers, none after the last."""
    i = 0
    while f"{prefix}_w{i}" in params:
        x = x @ params[f"{prefix}_w{i}"] + params[f"{prefix}_b{i}"]
        if f"{prefix}_w{i + 1}" in params:
            x = torch.tanh(x)
        i += 1
    return x


def init_mlp_policy(generator: torch.Generator, obs_dim: int, num_actions: int,
                    hidden: Sequence[int] = (64, 64)) -> Params:
    """Separate pi/v MLP towers (shared trunks hurt small-control tasks);
    the last layers scaled by 0.01 (a near-uniform policy)."""
    params: Params = {}
    for tower, out_dim in (("pi", num_actions), ("v", 1)):
        _init_mlp(generator, tower, [obs_dim, *hidden, out_dim], params,
                  final_scale=0.01)
    return params


def apply_mlp_policy(params: Params, obs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, obs_dim] -> (logits [B, A], value [B])."""
    return _apply_mlp(params, "pi", obs), _apply_mlp(params, "v", obs)[..., 0]


def init_sac_actor(generator: torch.Generator, obs_dim: int, act_dim: int,
                   hidden: Sequence[int] = (64, 64)) -> Params:
    """Squashed-Gaussian policy head: obs -> (mu, log_std) [B, 2*act_dim]."""
    params: Params = {}
    _init_mlp(generator, "actor", [obs_dim, *hidden, 2 * act_dim], params,
              final_scale=0.01)
    return params


def apply_sac_actor(params: Params, obs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    mu, log_std = _apply_mlp(params, "actor", obs).chunk(2, dim=-1)
    return mu, log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)


def squashed_logp(pre: torch.Tensor, mu: torch.Tensor,
                  log_std: torch.Tensor) -> torch.Tensor:
    """log-prob of a = tanh(pre) under Normal(mu, exp(log_std)) with the
    tanh change-of-variables correction in its softplus form."""
    std = torch.exp(log_std)
    logp_gauss = (-0.5 * ((pre - mu) / std) ** 2 - log_std
                  - _HALF_LOG_2PI).sum(-1)
    return logp_gauss - (2.0 * (_LOG_2 - pre - F.softplus(-2.0 * pre))).sum(-1)


def sample_squashed(mu: torch.Tensor, log_std: torch.Tensor, noise: torch.Tensor,
                    act_limit: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized tanh-squashed sample from the standard-normal
    `noise` (mu's shape), and its log-prob."""
    pre = mu + torch.exp(log_std) * noise
    return torch.tanh(pre) * act_limit, squashed_logp(pre, mu, log_std)


def init_twin_q(generator: torch.Generator, obs_dim: int, act_dim: int,
                hidden: Sequence[int] = (64, 64)) -> Params:
    """Two independent continuous Q towers (clipped double-Q)."""
    params: Params = {}
    for tower in ("q1", "q2"):
        _init_mlp(generator, tower, [obs_dim + act_dim, *hidden, 1], params)
    return params


def apply_twin_q(params: Params, obs: torch.Tensor, act: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = torch.cat([obs, act], dim=-1)
    return (_apply_mlp(params, "q1", x)[..., 0],
            _apply_mlp(params, "q2", x)[..., 0])


def init_mlp_q(generator: torch.Generator, obs_dim: int, num_actions: int,
               hidden: Sequence[int] = (64, 64)) -> Params:
    """Q-network MLP: obs -> Q(s, .) (the DQN RLModule analogue)."""
    params: Params = {}
    _init_mlp(generator, "q", [obs_dim, *hidden, num_actions], params)
    return params


def apply_mlp_q(params: Params, obs: torch.Tensor) -> torch.Tensor:
    """obs [B, obs_dim] -> Q [B, A]."""
    return _apply_mlp(params, "q", obs)
