"""Ulysses-style sequence parallelism: an all-to-all head/sequence swap,
counterpart of `ray_tpu/ops/ulysses.py`.

Two `all_to_all`s re-split the activations so that each rank attends over
the whole sequence for a subset of heads:

    [B, T/sp, H, D]  --all_to_all-->  [B, T, H/sp, D]
        flash attention over the whole sequence on the local heads
    [B, T, H/sp, D]  --all_to_all-->  [B, T/sp, H, D]

The attention in the middle is the port's `flash_attention`, which
launches the hand-written CUDA kernels (`fa_fwd`, and `fa_bwd_dq` /
`fa_bwd_dkv` in backward) on CUDA tensors. Against ring attention,
Ulysses moves q, k, v and the output once each where ring moves k/v
sp - 1 times, but caps sp at the head count.

`ulysses_attention` takes this rank's local shards; `make_ulysses_attention`
binds it to a mesh, with the layout of `make_ring_attention`.
"""
from __future__ import annotations

import functools
import math

from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.parallel.collectives import all_to_all, axis_size
from ray_tpu_torch.parallel.mesh import AXIS_SEQ


def ulysses_attention(q, k, v, *, mesh: DeviceMesh, axis: str = AXIS_SEQ,
                      causal: bool = True, sm_scale: float | None = None):
    """Exact attention over a sequence-split mesh axis, on this rank's
    shards. q, k, v: local shards (B, T_local, H_local, D); the local head
    count must divide by the axis size."""
    n = axis_size(axis, mesh=mesh)
    h, h_kv = q.shape[2], k.shape[2]
    # k/v too: with GQA they carry n_kv_heads, and an indivisible kv count
    # would otherwise surface as an opaque all_to_all shape error.
    if h % n != 0 or h_kv % n != 0:
        raise ValueError(
            f"Ulysses needs q AND kv heads divisible by the sequence-"
            f"parallel degree: {h} q heads / {h_kv} kv heads over "
            f"sp={n} (use ring attention when sp exceeds the head count)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])

    def seq_to_heads(x):   # [B, T/sp, H, D] -> [B, T, H/sp, D]
        return all_to_all(x, axis, mesh=mesh, split_dim=2, concat_dim=1)

    # Rank order along `axis` is sequence order, so the gathered sequence
    # is in global order and the plain causal mask is exact.
    out = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                          causal, sm_scale)
    return all_to_all(out, axis, mesh=mesh, split_dim=1, concat_dim=2)


def make_ulysses_attention(mesh: DeviceMesh, *, axis: str = AXIS_SEQ,
                           causal: bool = True, sm_scale: float | None = None):
    """`ulysses_attention` over `mesh`'s `axis`: fn(q, k, v) on local shards
    (under tp, the heads are this rank's, and they must divide by sp)."""
    return functools.partial(ulysses_attention, mesh=mesh, axis=axis, causal=causal,
                             sm_scale=sm_scale)
