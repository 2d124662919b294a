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
here in the JAX package, and none here: cuBLAS runs the products. Expert
parallelism (the `ep` mesh axis) comes with multi-GPU sharding.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

MOE_PARAMS = ("router", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3


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


def top_k_routing(logits: torch.Tensor, k: int, capacity: int):
    """logits (G, S, E) -> dispatch (G, S, E, C) one-hot, combine (G, S, E, C)
    gate-weighted, and the fp32 probs (G, S, E).

    A token's place in an expert's queue is its rank among the choices of
    that expert, earlier token first, then earlier choice (a cumsum over
    the flattened (S, k) choices); places at or past `capacity` drop."""
    g, s, e = logits.shape
    probs, gate_vals, expert_idx = _gates(logits, k)
    onehot = F.one_hot(expert_idx, e).float()                  # (G, S, k, E)
    flat = onehot.reshape(g, s * k, e)
    pos = (torch.cumsum(flat, dim=1) * flat - 1.0).reshape(g, s, k, e)
    keep = (pos >= 0) & (pos < capacity)
    pos = torch.where(keep, pos, 0.0)
    cap_onehot = F.one_hot(pos.long(), capacity).float() \
        * keep[..., None].float()                                # (G,S,k,E,C)
    dispatch = cap_onehot.amax(dim=2)
    combine = torch.einsum("gske,gskec->gsec", onehot * gate_vals[..., None],
                           cap_onehot)
    return dispatch, combine, probs


def moe_mlp(x: torch.Tensor, params: dict, cfg: MoEConfig):
    """x (B, T, d) -> (B, T, d) and the auxiliary losses
    {"moe_load_balance_loss", "moe_z_loss"}, with capacity routing."""
    b, t, d = x.shape
    dtype = x.dtype
    e = cfg.num_experts
    tokens = b * t
    capacity = max(1, int(cfg.capacity_factor * tokens * cfg.top_k / e))
    xg = x.reshape(1, tokens, d)                               # one group

    logits = xg @ params["router"].to(dtype)                   # (1, S, E)
    dispatch, combine, probs = top_k_routing(logits, cfg.top_k, capacity)

    # gsec,gsd->egcd in fp32: one product over the group's tokens.
    expert_in = torch.matmul(dispatch.flatten(2).transpose(1, 2), xg.float())
    expert_in = expert_in.to(dtype).view(e, capacity, d)       # (E, G*C, d)
    gate = torch.matmul(expert_in, params["w_gate"].to(dtype))
    up = torch.matmul(expert_in, params["w_up"].to(dtype))
    expert_out = torch.matmul(F.silu(gate) * up, params["w_down"].to(dtype))
    # gsec,egcd->gsd in fp32.
    out = torch.matmul(combine.flatten(2),
                       expert_out.float().view(1, e * capacity, d))

    # Load balance (Switch eq. 4) and the router z-loss.
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = dispatch.amax(dim=-1).mean(dim=(0, 1))                # share routed
    lb_loss = e * torch.sum(me * ce)
    z = torch.logsumexp(logits.float(), dim=-1)
    z_loss = torch.mean(z ** 2) * cfg.router_z_loss
    aux = {"moe_load_balance_loss": lb_loss, "moe_z_loss": z_loss}
    return out.reshape(b, t, d).to(dtype), aux


def moe_mlp_dropless(x: torch.Tensor, params: dict, cfg: MoEConfig):
    """Exact top-k MoE for inference: x (..., d) -> (..., d).

    Every expert runs on every token (E/k times the FLOPs of a gather),
    and the top-k combine weights zero the experts a token did not choose;
    the combine is fp32 over the compute-dtype expert outputs."""
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
    return out.reshape(x.shape).to(dtype)
