"""Mixture-of-Experts: top-k routing and the expert FFN (counterpart of
`ray_tpu/ops/moe.py`).

Training routes with a capacity (`moe_mlp`): dispatch and combine are fp32
products against capacity-bounded one-hot tensors, as the JAX package
computes them, and tokens over an expert's capacity are dropped (the
residual carries them). Serving routes exactly (`moe_mlp_dropless`): every
token reaches all of its top-k experts, so a cached decode step computes
the same function as a full prefill.

Shapes: tokens (B, T, d) -> one group (G = 1, S = B*T, d); dispatch and
combine (G, S, E, C); expert buffers (E, G*C, d). The expert products are
batched over the expert axis (`bmm` on the stacked (E, d, f) weights), so
no step copies or permutes the expert weights. There is no Pallas kernel
here in the JAX package, and none here: cuBLAS runs the products.

Under a mesh (`MoELayout`) each rank holds its rows (and sp columns) of
the batch, and the layer keeps JAX's one routing group over the global
batch, as GSPMD computes it: the capacity counts the global tokens, each
choice takes its place in its expert's queue in the global token order
(the ranks' choices are gathered for that), and the auxiliary losses are
means over the global tokens (psums of each rank's sums). A token's gates
depend on its own router logits alone, so the logits themselves are not
gathered. The experts split over `ep` and each expert's d_ff over `tp`:
a rank runs its experts' buffers, and the combined output is summed over
both axes.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.parallel.collectives import all_gather, axis_size, psum, pvary

MOE_PARAMS = ("router", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    cfg: MoEConfig, dtype: torch.dtype, *,
                    device: torch.device | str = "cuda") -> dict:
    """One layer's MoE weights at N(0, 1/fan_in), as the JAX function
    scales them (the draws come from `generator`, not jax.random)."""
    e = cfg.num_experts

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in ** -0.5).to(dtype)

    return {"router": dense((d_model, e), d_model),
            "w_gate": dense((e, d_model, d_ff), d_model),
            "w_up": dense((e, d_model, d_ff), d_model),
            "w_down": dense((e, d_ff, d_model), d_ff)}


def moe_param_logical_axes() -> dict:
    return {"router": ("embed", "expert"),
            "w_gate": ("expert", "embed", "mlp"),
            "w_up": ("expert", "embed", "mlp"),
            "w_down": ("expert", "mlp", "embed")}


@dataclasses.dataclass(frozen=True)
class MoELayout:
    """Where a MoE layer's tokens and weights lie on `mesh`: the mesh axes
    that split the batch rows (`rows`, outermost first) and the positions
    (`cols`, the sp axis), the axis the experts split over (`experts`, ep)
    and the one that splits each expert's d_ff (`tensor`, tp). Only axes
    of more than one rank are named. Without a mesh one rank holds all."""
    mesh: DeviceMesh | None = None
    rows: tuple[str, ...] = ()
    cols: tuple[str, ...] = ()
    experts: tuple[str, ...] = ()
    tensor: tuple[str, ...] = ()

    def _size(self, axes) -> int:
        return math.prod(axis_size(a, mesh=self.mesh) for a in axes)

    @property
    def token_shards(self) -> int:
        """How many ranks' tokens make up the global batch."""
        return self._size(self.rows + self.cols)

    def first_expert(self, local_experts: int) -> int:
        return self.mesh.get_local_rank(self.experts[0]) * local_experts \
            if self.experts else 0

    def queue_places(self, expert_idx: torch.Tensor, e: int) -> torch.Tensor:
        """This rank's (B, T, k) expert choices -> (B*T, k) places of each
        in its expert's queue over the global batch, in JAX's token order
        b*T + t: every rank's choices are gathered (the sp columns of a
        row, then the rows, innermost axis first), ordered and counted,
        and this rank keeps its block. Under sp a rank's tokens are not a
        contiguous run of that order, so no per-rank offset would do."""
        b, t, k = expert_idx.shape
        ids, r0, c0 = expert_idx, 0, 0
        for a in self.cols:
            c0 = self.mesh.get_local_rank(a) * t
            ids = all_gather(ids, a, mesh=self.mesh, dim=1)
        for a in self.rows:
            r0 = r0 * axis_size(a, mesh=self.mesh) + self.mesh.get_local_rank(a)
        for a in reversed(self.rows):
            ids = all_gather(ids, a, mesh=self.mesh, dim=0)
        places = _queue_positions(ids.reshape(-1, k), e).view(ids.shape)
        return places[r0 * b:(r0 + 1) * b, c0:c0 + t].reshape(b * t, k)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of the last axis, the lower index first among equal
    values, as `jax.lax.top_k` orders them (`torch.topk` promises no order
    on ties, and bf16 router logits tie)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gates(logits: torch.Tensor, k: int):
    """fp32 softmax probs, and the top-k gates renormalised to sum 1."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def _queue_positions(expert_idx: torch.Tensor, e: int) -> torch.Tensor:
    """(..., S, k) choices of E experts -> each choice's place in its
    expert's queue: earlier token first, then earlier choice (a cumsum
    over the flattened (S, k) choices, as JAX counts them)."""
    flat = expert_idx.flatten(-2)
    counts = torch.cumsum(F.one_hot(flat, e), dim=-2)
    return (counts.gather(-1, flat[..., None])[..., 0] - 1).view_as(expert_idx)


def _dispatch_combine(expert_idx, gate_vals, slot, keep, e: int, slots: int):
    """(N, k) choices -> dispatch (N, E, slots), one where choice j of
    token n sits (place slot[n, j] of expert expert_idx[n, j], if kept),
    and combine, the same entries gate-weighted. A token's k choices are
    distinct experts, so no two choices share an entry."""
    n, k = expert_idx.shape
    token = torch.arange(n, device=expert_idx.device)[:, None].expand(n, k)
    at = (token, expert_idx, torch.where(keep, slot, 0))
    kept = keep.float()
    dispatch = torch.zeros(n, e, slots, device=expert_idx.device).index_put(at, kept)
    combine = torch.zeros(n, e, slots, dtype=gate_vals.dtype,
                          device=expert_idx.device).index_put(at, gate_vals * kept)
    return dispatch, combine


def top_k_routing(logits: torch.Tensor, k: int, capacity: int):
    """logits (G, S, E) -> dispatch (G, S, E, C) one-hot, combine (G, S, E, C)
    gate-weighted, and the fp32 probs (G, S, E).

    A token's place in an expert's queue is its rank among the choices of
    that expert, earlier token first, then earlier choice; places at or
    past `capacity` drop."""
    g, s, e = logits.shape
    probs, gate_vals, expert_idx = _gates(logits, k)
    pos = _queue_positions(expert_idx, e)
    dispatch, combine = _dispatch_combine(
        *(t.reshape(g * s, k) for t in (expert_idx, gate_vals, pos, pos < capacity)),
        e, capacity)
    return dispatch.view(g, s, e, capacity), combine.view(g, s, e, capacity), probs


def moe_mlp(x: torch.Tensor, params: dict, cfg: MoEConfig,
            layout: MoELayout | None = None):
    """x (B, T, d) -> (B, T, d) and the auxiliary losses
    {"moe_load_balance_loss", "moe_z_loss"}, with capacity routing.

    Under a `layout`, x is this rank's tokens, the expert weights its
    experts (E/ep of them, each with its d_ff/tp columns) and the router
    whole; routing, capacity and the losses are the global batch's."""
    lay = layout or MoELayout()
    b, t, d = x.shape
    dtype = x.dtype
    e, k = cfg.num_experts, cfg.top_k
    n = b * t
    capacity = max(1, int(cfg.capacity_factor * n * lay.token_shards * k / e))
    xg = x.reshape(1, n, d)                                    # one group

    logits = (xg @ params["router"].to(dtype))[0]              # (S, E)
    probs, gate_vals, expert_idx = _gates(logits, k)
    keep = lay.queue_places(expert_idx.view(b, t, k), e) < capacity
    # This rank's kept choices fill each expert's buffer from slot 0 in
    # queue order: an expert's row for a token does not depend on its
    # slot, and at most min(capacity, S) of the rank's tokens reach one
    # expert. With the whole batch on one rank the slots are the places.
    slots = min(capacity, n)
    slot = _queue_positions(torch.where(keep, expert_idx, e), e + 1)
    # The combine's grads are partial over the ranks of other experts and
    # other d_ff columns: summed there, every rank's router sees them all.
    split = lay.experts + lay.tensor
    gate_vals = pvary(gate_vals, split, mesh=lay.mesh)
    dispatch, combine = _dispatch_combine(expert_idx, gate_vals, slot, keep, e, slots)
    e_loc = params["w_gate"].shape[0]
    e0 = lay.first_expert(e_loc)
    dispatch, combine = (a[None, :, e0:e0 + e_loc] for a in (dispatch, combine))

    # gsec,gsd->egcd in fp32: one product over the rank's tokens.
    xe = pvary(xg, split, mesh=lay.mesh)
    expert_in = torch.matmul(dispatch.flatten(2).transpose(1, 2), xe.float())
    expert_in = expert_in.to(dtype).view(e_loc, slots, d)      # (E, G*C, d)
    gate = torch.matmul(expert_in, params["w_gate"].to(dtype))
    up = torch.matmul(expert_in, params["w_up"].to(dtype))
    expert_out = torch.matmul(F.silu(gate) * up, params["w_down"].to(dtype))
    # gsec,egcd->gsd in fp32, summed over the experts' and columns' ranks.
    out = torch.matmul(combine.flatten(2),
                       expert_out.float().view(1, e_loc * slots, d))
    out = psum(out, split, mesh=lay.mesh)

    # Load balance (Switch eq. 4) and the router z-loss, means over the
    # global tokens: each rank's sums, summed over the ranks of other
    # tokens (whose backward gives each rank its own tokens' share).
    tokens, over = n * lay.token_shards, lay.rows + lay.cols
    routed = (F.one_hot(expert_idx, e) * keep[..., None]).sum(dim=1).float()
    me = psum(probs.sum(dim=0), over, mesh=lay.mesh) / tokens   # (E,)
    ce = psum(routed.sum(dim=0), over, mesh=lay.mesh) / tokens  # share routed
    lb_loss = e * torch.sum(me * ce)
    z = torch.logsumexp(logits.float(), dim=-1)
    z_loss = psum(torch.sum(z ** 2), over, mesh=lay.mesh) / tokens * cfg.router_z_loss
    aux = {"moe_load_balance_loss": lb_loss, "moe_z_loss": z_loss}
    return out.reshape(b, t, d).to(dtype), aux


def moe_mlp_dropless(x: torch.Tensor, params: dict, cfg: MoEConfig,
                     layout: MoELayout | None = None):
    """Exact top-k MoE for inference: x (..., d) -> (..., d).

    Every expert runs on every token (E/k times the FLOPs of a gather),
    and the top-k combine weights zero the experts a token did not choose;
    the combine is fp32 over the compute-dtype expert outputs. Under a
    `layout` (serving's: experts whole) the expert weights are this
    rank's d_ff columns, and the output is summed over tp."""
    lay = layout or MoELayout()
    dtype = x.dtype
    e = cfg.num_experts
    xf = x.reshape(-1, x.shape[-1])                            # (N, d)
    _, gate_vals, expert_idx = _gates(xf @ params["router"].to(dtype),
                                      cfg.top_k)
    w = (F.one_hot(expert_idx, e).float() * gate_vals[..., None]).sum(dim=1)
    # btd,edf->btef as one product batched over the expert axis, on the
    # stacked weights as they lie.
    gate = torch.matmul(xf[None], params["w_gate"].to(dtype))  # (E, N, f)
    up = torch.matmul(xf[None], params["w_up"].to(dtype))
    out_e = torch.matmul(F.silu(gate) * up, params["w_down"].to(dtype))
    out = torch.einsum("ne,end->nd", w, out_e.float())
    out = psum(out, lay.tensor, mesh=lay.mesh)
    return out.reshape(x.shape).to(dtype)
