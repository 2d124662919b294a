"""Single-device training step, counterpart of `ray_tpu/models/training.py`.

`make_train_step` returns `(init_fn, step_fn)` as the JAX package does.
The step is eager PyTorch: forward and loss, backward through the flash
attention kernels, then clipping and AdamW. It updates the state in place
(params, moments) and returns it, where JAX returns a new, donated state.
With MoE the loss carries the auxiliary losses, so the metrics, the grad
norm and clipping see them as JAX's step does. Sharding over several GPUs
is a later slice (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ray_tpu_torch.models.transformer import (
    TransformerConfig, init_params, loss_fn, resolve_device)


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict
    opt_state: torch.optim.Optimizer


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    """Leaves of a nested dict of tensors, in insertion order."""
    out = []
    for value in tree.values():
        out.extend(tree_leaves(value) if isinstance(value, dict) else [value])
    return out


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float):
    """Scale grads in place by max_norm / norm when norm >= max_norm, as
    optax.clip_by_global_norm does (no epsilon); return the raw norm."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


# optax.adamw's betas and eps as the JAX default_optimizer sets them.
ADAM_BETAS = (0.9, 0.95)
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax.chain(clip_by_global_norm, adamw(warmup-cosine schedule)).

    AdamW decays every parameter (no mask), as the JAX default does;
    torch.optim.AdamW applies the same decoupled update as optax.adamw.
    """
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def learning_rate(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup,
        max(total_steps, warmup + 1), 0.1 * lr) at update `count` (0-based:
        the first update has lr 0)."""
        if count < self.warmup:
            return self.lr * count / self.warmup
        decay_steps = max(self.total_steps, self.warmup + 1) - self.warmup
        frac = min(count - self.warmup, decay_steps) / decay_steps
        alpha = 0.1 if self.lr else 0.0
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return self.lr * ((1.0 - alpha) * cosine + alpha)

    def init(self, leaves: list[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.AdamW(leaves, lr=0.0, betas=ADAM_BETAS, eps=ADAM_EPS,
                                 weight_decay=self.weight_decay)

    def update(self, opt: torch.optim.Optimizer, leaves: list[torch.Tensor],
               count: int) -> torch.Tensor:
        """Clip the leaves' grads, take one AdamW step at the scheduled lr,
        clear the grads; return the global norm of the raw grads."""
        norm = clip_by_global_norm_([p.grad for p in leaves], self.grad_clip)
        for group in opt.param_groups:
            group["lr"] = self.learning_rate(count)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return norm


def default_optimizer(lr: float = 3e-4, *, warmup: int = 100,
                      total_steps: int = 10000, weight_decay: float = 0.1,
                      grad_clip: float = 1.0) -> Optimizer:
    return Optimizer(lr=lr, warmup=warmup, total_steps=total_steps,
                     weight_decay=weight_decay, grad_clip=grad_clip)


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def make_train_step(
    cfg: TransformerConfig,
    *,
    device: torch.device | str = "cuda",
    optimizer: Optimizer | None = None,
) -> tuple[Callable[..., TrainState], Callable[..., tuple[TrainState, dict]]]:
    """Returns (init_fn(generator=None, *, params=None) -> TrainState,
    step_fn(state, batch) -> (state, metrics)).

    `init_fn` draws params from `generator` (see `init_params`) or copies
    the given `params` tree. Metrics: "loss" and "grad_norm" (of the raw
    grads) as 0-d tensors on the device, and "step" as an int.
    """
    device = resolve_device(device)
    optimizer = optimizer or default_optimizer()

    def init_fn(generator: torch.Generator | None = None, *,
                params: dict | None = None) -> TrainState:
        if params is None:
            params = init_params(cfg, generator, device=device)

        def own(tree):
            return {k: own(v) if isinstance(v, dict) else
                    v.detach().to(device, cfg.param_dtype).clone().requires_grad_()
                    for k, v in tree.items()}

        params = own(params)
        return TrainState(step=0, params=params,
                          opt_state=optimizer.init(tree_leaves(params)))

    def step_fn(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        loss = loss_fn(state.params, _to_device(batch, device), cfg)
        loss.backward()
        grad_norm = optimizer.update(state.opt_state,
                                     tree_leaves(state.params), state.step)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm,
                       "step": state.step}

    return init_fn, step_fn


def make_eval_step(cfg: TransformerConfig, *,
                   device: torch.device | str = "cuda"):
    """fn(params, batch) -> loss, without building a graph."""
    device = resolve_device(device)

    def eval_fn(params: dict, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            return loss_fn(params, _to_device(batch, device), cfg)

    return eval_fn
