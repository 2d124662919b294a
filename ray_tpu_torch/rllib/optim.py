"""The learners' optimizers on flat dicts of tensors: optax.adam and
optax.rmsprop as the JAX package's RLlib chains them behind
optax.clip_by_global_norm, with their state kept as optax's (a step count
and the moments, by parameter name) so that it crosses over to numpy by
name.

`Adam.update` is one step of `torch.optim.Adam(foreach=True)`, whose
update is optax.adam's (eps outside the square root, the same bias
correction); `RMSProp.update` is written out, since optax puts its eps
inside the square root where torch.optim.RMSprop puts it outside. Each
runs in place under no_grad on the params' own device. Clipping is
`models.training.clip_by_global_norm_`, the port's copy of
optax.clip_by_global_norm.
"""
from __future__ import annotations

import dataclasses

import torch

from ray_tpu_torch.models.training import clip_by_global_norm_


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.adam(lr): mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
    p -= lr * mu_hat / (sqrt(nu_hat) + eps) with bias-corrected moments."""
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict) -> dict:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> None:
        """One torch.optim.Adam step over `params` from `grads`, on the
        moments of `state` in place. The optimizer is built for the step:
        a learner replaces its param tensors when it loads weights or
        state, and the state lives in `state`, not in the optimizer."""
        names = list(params)
        leaves = [params[k] for k in names]
        opt = torch.optim.Adam(leaves, lr=self.lr, betas=(self.b1, self.b2),
                               eps=self.eps, foreach=True)
        for k, p in zip(names, leaves):
            p.grad = grads[k]
            opt.state[p] = {"step": torch.tensor(float(state["count"])),
                            "exp_avg": state["mu"][k], "exp_avg_sq": state["nu"][k]}
        opt.step()
        for p in leaves:
            p.grad = None
        state["count"] += 1


@dataclasses.dataclass(frozen=True)
class RMSProp:
    """optax.rmsprop(lr, decay, eps): nu = (1-decay) g^2 + decay nu from
    zero, p -= lr * g / sqrt(nu + eps) (eps inside the square root, where
    torch.optim.RMSprop puts it outside), no bias correction."""
    lr: float
    decay: float = 0.9
    eps: float = 1e-8

    def init(self, params: dict) -> dict:
        return {"nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> None:
        names = list(params)
        g = [grads[k] for k in names]
        nu = [state["nu"][k] for k in names]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.decay)
        denom = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(denom)
        step = torch._foreach_mul(g, denom)
        torch._foreach_add_([params[k] for k in names], step, alpha=-self.lr)


def clip_grads_(grads: dict, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on a dict of grads, in place; returns the
    raw global norm."""
    return clip_by_global_norm_(list(grads.values()), max_norm)
