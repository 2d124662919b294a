"""Ring attention: exact attention over sequence shards by neighbour
exchange, counterpart of `ray_tpu/ops/ring_attention.py`.

The sequence axis is split over a mesh axis (`sp`); each rank holds a
local q/k/v shard and, over `n` ring steps, rotates its k/v shard to the
next rank with `ppermute_ring` while merging blockwise online-softmax
partial results. Backward goes through the rotations (each one's
backward rotates the cotangent the other way), so every rank of the axis
must call it, with the same shapes, in the same order.

As in the JAX package this is plain tensor math in fp32 (einsums), not a
kernel: it reaches no flash-attention kernel. `ring_attention` takes this
rank's local shards; `make_ring_attention` binds it to a mesh.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.parallel.collectives import axis_index, axis_size, ppermute_ring
from ray_tpu_torch.parallel.mesh import AXIS_SEQ

_NEG_INF = -1e30


def _block_attn(q, k, v, q_off: int, kv_off: int, *, causal: bool, sm_scale: float):
    """Unnormalized blockwise attention with a global-position causal mask.

    q: (B, Tq, H, D) local; k/v: (B, Tk, H, D), the shard now held.
    Returns (m, l, acc): rowwise max (B,Tq,H,1), sum of exp (B,Tq,H,1),
    unnormalized weighted values (B,Tq,H,D), all fp32.
    """
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * sm_scale
    if causal:
        q_pos = q_off + torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = kv_off + torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where((q_pos >= k_pos)[None, :, None, :], s, _NEG_INF)
    m = torch.clamp(s.amax(-1, keepdim=True), min=_NEG_INF)  # finite when all masked
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bqhk,bkhd->bqhd", p, v.float())
    return m, l, acc


def ring_attention(q, k, v, *, mesh: DeviceMesh, axis: str = AXIS_SEQ,
                   causal: bool = True, sm_scale: float | None = None):
    """Exact attention over a sequence-split mesh axis, on this rank's shards.

    q, k, v: local shards (B, T_local, H, D). The global sequence is
    T_local * axis_size(axis) long; the rank at index i of `axis` holds
    positions [i*T_local, (i+1)*T_local).
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n = axis_size(axis, mesh=mesh)
    i = axis_index(axis, mesh=mesh)
    b, t_local, h, d = q.shape
    m = torch.full((b, t_local, h, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, t_local, h, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, t_local, h, d), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for t in range(n):
        # After t rotations this rank holds kv shard (i - t) mod n. Rotate
        # first, as the JAX scan does; the n-th rotation would bring the
        # shards home unused, so it is not made.
        if t < n - 1:
            k_next = ppermute_ring(kc, axis, mesh=mesh)
            v_next = ppermute_ring(vc, axis, mesh=mesh)
        j = (i - t) % n
        bm, bl, bacc = _block_attn(q, kc, vc, i * t_local, j * t_local,
                                   causal=causal, sm_scale=sm_scale)
        m_new = torch.maximum(m, bm)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(bm - m_new)
        l = alpha * l + beta * bl
        acc = alpha * acc + beta * bacc
        m = m_new
        if t < n - 1:
            kc, vc = k_next, v_next
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def make_ring_attention(mesh: DeviceMesh, *, axis: str = AXIS_SEQ, causal: bool = True,
                        sm_scale: float | None = None):
    """`ring_attention` over `mesh`'s `axis`: fn(q, k, v) on this rank's
    shards, (B, T, H, D) with B over the data axes, T over `axis` and H
    over tp, as JAX's shard_map specs lay them out."""
    return functools.partial(ring_attention, mesh=mesh, axis=axis, causal=causal,
                             sm_scale=sm_scale)
