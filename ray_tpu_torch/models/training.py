"""Training step, counterpart of `ray_tpu/models/training.py`.

`make_train_step` returns `(init_fn, step_fn)` as the JAX package does.
The step is eager PyTorch: forward and loss, backward through the flash
attention kernels, then the optimizer (AdamW with clipping, or
Adafactor). It updates the state in place (params, optimizer state) and
returns it, where JAX returns a new, donated state. With MoE the loss
carries the auxiliary losses, so the metrics, the grad norm and clipping
see them as JAX's step does.

With a `mesh` (`parallel.build_mesh`) the params are DTensors laid out by
the logical rules, the step takes the global batch (each rank computes
its rows), and its loss, grads and metrics are the global batch's, as
JAX's sharded step gives them. Without one it runs on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from ray_tpu_torch.models.transformer import (
    TransformerConfig, init_params, layout_for, loss_fn, param_logical_axes,
    resolve_device)
from ray_tpu_torch.parallel.collectives import psum
from ray_tpu_torch.parallel.mesh import local_batch_rows
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, LogicalRules, NamedSharding, local_tensor, logical_to_mesh,
    mesh_axes, param_shardings, placements, shard_axes)


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict
    opt_state: Any  # torch.optim.AdamW, or Adafactor's per-leaf statistics


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    """Leaves of a nested dict of tensors, in insertion order."""
    out = []
    for value in tree.values():
        out.extend(tree_leaves(value) if isinstance(value, dict) else [value])
    return out


def _split_axes(t: torch.Tensor) -> tuple[str, ...]:
    """Every mesh axis (of more than one rank) that splits a DTensor."""
    return tuple(a for axes in shard_axes(t).values() for a in axes)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of all grads together, as optax.global_norm. A DTensor
    counts each element once: its local norms are summed (squared) over
    the axes that split it, and a replicated one is taken once."""
    groups: dict = {}
    for g in grads:
        axes = _split_axes(g)
        key = (axes, g.device_mesh if axes else None)
        groups.setdefault(key, []).append(
            torch.linalg.vector_norm(local_tensor(g).float()))
    norms = []
    for (axes, mesh), ns in groups.items():
        n = torch.linalg.vector_norm(torch.stack(ns))
        norms.append(psum(n.square(), axes, mesh=mesh).sqrt() if axes else n)
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float):
    """Scale grads in place by max_norm / norm when norm >= max_norm, as
    optax.clip_by_global_norm does (no epsilon); return the raw norm."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        local_tensor(g).mul_(scale.to(g.dtype))
    return norm


# optax.adamw's betas and eps as the JAX default_optimizer sets them.
ADAM_BETAS = (0.9, 0.95)
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax.chain(clip_by_global_norm, adamw(warmup-cosine schedule)).

    AdamW decays every parameter (no mask), as the JAX default does;
    torch.optim.AdamW applies the same decoupled update as optax.adamw.
    Every step of it is elementwise, so on DTensors it runs over each
    rank's local shards: plain tensors, with no DTensor dispatch.
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
        return torch.optim.AdamW([local_tensor(p) for p in leaves], lr=0.0,
                                 betas=ADAM_BETAS, eps=ADAM_EPS,
                                 weight_decay=self.weight_decay)

    def update(self, opt: torch.optim.Optimizer, leaves: list[torch.Tensor],
               count: int) -> torch.Tensor:
        """Clip the leaves' grads, take one AdamW step at the scheduled lr,
        clear the grads; return the global norm of the raw grads."""
        norm = clip_by_global_norm_([p.grad for p in leaves], self.grad_clip)
        for p, local in zip(leaves, opt.param_groups[0]["params"]):
            local.grad = local_tensor(p.grad)
        for group in opt.param_groups:
            group["lr"] = self.learning_rate(count)
        opt.step()
        opt.zero_grad(set_to_none=True)
        for p in leaves:
            p.grad = None
        return norm


# optax.adafactor's defaults, which `optax.adafactor(learning_rate=...)`
# keeps: factor a leaf's second moment when its second-largest dim has at
# least 128 entries; decay 1 - (t + 1)^-0.8 from step 0; clip each update
# to RMS 1; scale it by the param's RMS, at least 1e-3; no momentum and no
# weight decay.
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP = 1.0
ADAFACTOR_MIN_PARAM_SCALE = 1e-3


def factored_dims(shape) -> tuple[int, int] | None:
    """(second-largest, largest) dim of `shape`, ranked as optax's
    `_factored_dims` ranks them (np.argsort), or None when the leaf keeps
    a full second moment."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """optax.adafactor(learning_rate) with its defaults: a factored
    estimate of the grad's RMS (row and column means of the squares over
    the two largest dims), the update clipped to RMS 1, times the learning
    rate and the param's RMS. A stacked (L, d, h) leaf is one block: its
    RMS statistics span its layers and L stays unfactored.

    On DTensors each rank keeps the statistics of its shard; the row and
    column means and both RMS values sum over the mesh axes that split the
    leaf, so they are the global array's."""
    learning_rate: float = 1e-4

    def init(self, leaves: list[torch.Tensor]) -> list[dict]:
        state = []
        for p in leaves:
            local = local_tensor(p).detach()
            dims = factored_dims(p.shape)
            if dims is None:
                state.append({"v": torch.zeros_like(local)})
                continue
            d1, d0 = dims
            state.append({"v_row": torch.zeros_like(local.select(d0, 0)),
                          "v_col": torch.zeros_like(local.select(d1, 0))})
        return state

    @torch.no_grad()
    def update(self, state: list[dict], leaves: list[torch.Tensor],
               count: int) -> torch.Tensor:
        """One update of every leaf from its grad, which it clears; return
        the global norm of the grads."""
        norm = global_norm([p.grad for p in leaves])
        decay = 1.0 - (count + 1.0) ** -ADAFACTOR_DECAY_RATE
        for p, s in zip(leaves, state):
            mesh = p.device_mesh if isinstance(p, DTensor) else None
            axes = shard_axes(p)
            every = _split_axes(p)

            def mean(x, dim, split_by, keepdim=False):
                return psum(x.sum(dim, keepdim=keepdim), axes.get(split_by, ()),
                            mesh=mesh) / p.shape[split_by]

            def rms(x):
                return (psum(x.square().sum(), every, mesh=mesh) / p.numel()).sqrt()

            g, w = local_tensor(p.grad), local_tensor(p)
            sq = g.square() + ADAFACTOR_EPS
            dims = factored_dims(p.shape)
            if dims is None:
                s["v"] = decay * s["v"] + (1.0 - decay) * sq
                u = g * s["v"] ** -0.5
            else:
                d1, d0 = dims
                s["v_row"] = decay * s["v_row"] + (1.0 - decay) * mean(sq, d0, d0)
                s["v_col"] = decay * s["v_col"] + (1.0 - decay) * mean(sq, d1, d1)
                # v_row lacks d0, so p's dim d1 is its dim d1 - (d1 > d0).
                reduced = d1 - 1 if d1 > d0 else d1
                row_col_mean = mean(s["v_row"], reduced, d1, keepdim=True)
                row_factor = (s["v_row"] / row_col_mean) ** -0.5
                col_factor = s["v_col"] ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            u = u / torch.clamp(rms(u) / ADAFACTOR_CLIP, min=1.0)
            u = u * self.learning_rate
            param_rms = rms(w)
            u = u * torch.where(param_rms <= ADAFACTOR_MIN_PARAM_SCALE,
                                ADAFACTOR_MIN_PARAM_SCALE, param_rms)
            w.sub_(u)
            p.grad = None
        return norm


def default_optimizer(lr: float = 3e-4, *, warmup: int = 100,
                      total_steps: int = 10000, weight_decay: float = 0.1,
                      grad_clip: float = 1.0) -> Optimizer:
    return Optimizer(lr=lr, warmup=warmup, total_steps=total_steps,
                     weight_decay=weight_decay, grad_clip=grad_clip)


def _local_batch(batch: dict, device: torch.device, mesh: DeviceMesh | None,
                 rules: LogicalRules) -> dict:
    """This rank's rows of a global batch, on `device`. A DTensor (what
    `data.torch_feed` yields under a mesh) is laid out as `rules` split the
    batch and gives its local rows. A host array is sliced to this rank's
    rows and copied synchronously; `data.torch_feed` stages batches in
    pinned memory and copies them ahead of the step."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            spec = logical_to_mesh(("batch",) + (None,) * (v.dim() - 1), rules)
            out[k] = v.redistribute(v.device_mesh,
                                    placements(spec, v.device_mesh)).to_local()
            continue
        v = torch.as_tensor(v)
        if mesh is not None:
            v = v[local_batch_rows(mesh, v.shape[0], mesh_axes(rules, "batch", mesh))]
        out[k] = v.to(device)
    return out


def _own(t: torch.Tensor, sharding: NamedSharding | None, device: torch.device,
         dtype: torch.dtype) -> torch.Tensor:
    """A fresh leaf of the train state: on `device` in `dtype`, laid out
    by `sharding` when given (a DTensor is redistributed, a full tensor
    distributed)."""
    t = t.detach()
    if sharding is not None:
        if isinstance(t, DTensor):
            t = t.redistribute(sharding.mesh, sharding.placements)
        else:
            t = distribute_tensor(t.to(device), sharding.mesh, sharding.placements)
    return t.to(device, dtype).clone().requires_grad_()


def make_train_step(
    cfg: TransformerConfig,
    mesh: DeviceMesh | None = None,
    *,
    rules: LogicalRules = DEFAULT_RULES,
    optimizer: Optimizer | Adafactor | None = None,
    device: torch.device | str = "cuda",
) -> tuple[Callable[..., TrainState], Callable[..., tuple[TrainState, dict]]]:
    """Returns (init_fn(generator=None, *, params=None) -> TrainState,
    step_fn(state, batch) -> (state, metrics)).

    `init_fn` draws params from `generator` (see `init_params`; every
    rank must draw the same) or copies the given `params` tree. Under a
    `mesh` (whose device type replaces `device`) they become DTensors laid
    out by `param_shardings(param_logical_axes(cfg), mesh, rules)`, and
    `step_fn` takes the global batch. Metrics: "loss" and "grad_norm" (of
    the raw grads) as 0-d tensors on the device, the global batch's, and
    "step" as an int.
    """
    device = resolve_device(device if mesh is None else mesh.device_type)
    layout_for(cfg, mesh, rules)  # raises now for a layout not ported yet
    shardings = None if mesh is None else \
        param_shardings(param_logical_axes(cfg), mesh, rules)
    optimizer = optimizer or default_optimizer()

    def init_fn(generator: torch.Generator | None = None, *,
                params: dict | None = None) -> TrainState:
        if params is None:
            params = init_params(cfg, generator, device=device)

        def own(tree, shardings):
            return {k: own(v, shardings and shardings[k]) if isinstance(v, dict)
                    else _own(v, shardings and shardings[k], device, cfg.param_dtype)
                    for k, v in tree.items()}

        params = own(params, shardings)
        return TrainState(step=0, params=params,
                          opt_state=optimizer.init(tree_leaves(params)))

    def step_fn(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        loss = loss_fn(state.params, _local_batch(batch, device, mesh, rules), cfg,
                       rules=rules, mesh=mesh)
        loss.backward()
        grad_norm = optimizer.update(state.opt_state,
                                     tree_leaves(state.params), state.step)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm,
                       "step": state.step}

    return init_fn, step_fn


def make_eval_step(cfg: TransformerConfig, mesh: DeviceMesh | None = None, *,
                   rules: LogicalRules = DEFAULT_RULES,
                   device: torch.device | str = "cuda"):
    """fn(params, batch) -> loss, without building a graph; under a `mesh`
    as `make_train_step`'s step (global batch in, global loss out)."""
    device = resolve_device(device if mesh is None else mesh.device_type)
    layout_for(cfg, mesh, rules)

    def eval_fn(params: dict, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            return loss_fn(params, _local_batch(batch, device, mesh, rules), cfg,
                           rules=rules, mesh=mesh)

    return eval_fn
