"""Flash attention: hand-written CUDA kernels for Hopper + plain references.

Counterpart of `ray_tpu/ops/attention.py`. The three Pallas kernels there
become the three CUDA kernels of `csrc/flash_attention.cu`:

- `fa_fwd`: online-softmax forward, returning O and the per-row
  logsumexp (`_fa_kernel`);
- `fa_bwd_dq`: dq accumulated over kv tiles (`_bwd_dq_kernel`);
- `fa_bwd_dkv`: dk, dv accumulated over q tiles (`_bwd_dkv_kernel`).

Each wrapper launches its kernel for CUDA tensors and counts the launch
in `launches`; for CPU tensors it runs the kernel's plain version
(`*_plain`), the same function written as tensor math, which the CPU tests
check against JAX and which the kernels are held against on the card.
Anything else raises: there is no fallback from a CUDA tensor.

`flash_attention` zero-pads a head dim below one of `HEAD_DIMS` up to it
(`padded_head_dim`), so that a small model (TINY's head dim is 16) runs
the kernels too; a head dim above 128, another dtype than bf16 or fp32,
or mixed dtypes raise on the card.

Layout is (B, T, H, D) as in the JAX package; lse and delta are plain
(B, H, T) fp32 arrays. There is no GQA inside: callers repeat kv heads
first.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch.ops import _cuda

_NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each kernel since the last `reset_launches()`.
launches = {"fa_fwd": 0, "fa_bwd_dq": 0, "fa_bwd_dkv": 0}

# (atol, rtol) of |kernel - plain| <= atol + rtol * |plain|, the bound each
# kernel is held to against its plain version on the card. Both compute the
# same fp32 values in another summation order, so they part only where a
# rounding to the output dtype (or, in the backward, of P and dS to bf16)
# falls on either side: one bf16 ulp is at most 2^-7 |x|, inside rtol.
# atol covers elements near zero; at bf16 it is a twentieth of a typical
# |o| or |dq| at T 2048, so a fault that moves ordinary elements by a few
# percent fails.
KERNEL_TOLERANCE = {"bf16": (2e-3, 2e-2), "fp32": (1e-4, 1e-4),
                    "lse": (1e-3, 0.0)}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def mha_reference(q, k, v, *, causal: bool = True,
                  sm_scale: float | None = None, kv_offset: int = 0):
    """Plain multi-head attention with a numerically stable softmax.

    q (B, Tq, H, D), k/v (B, Tkv, H, D). `kv_offset` shifts the kv global
    positions for causal masking. Scores are fp32; probabilities are cast
    to v.dtype before the PV product.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal, sm_scale, kv_offset)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _scores(q, k, causal, sm_scale, kv_offset=0):
    """fp32 (B, H, Tq, Tkv) scores: scaled first, then masked with -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :] + kv_offset
        s = torch.where(q_pos >= k_pos, s, _NEG_INF)
    return s


# --- plain versions of the three kernels -----------------------------------

def fa_fwd_plain(q, k, v, *, causal: bool, sm_scale: float):
    """(o, lse) as `_fa_kernel` computes them: o in v.dtype, lse fp32 (B, H, Tq).

    P stays fp32 in the PV product: `_fa_kernel` upcasts v to fp32 first.
    """
    s = _scores(q, k, causal, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(v.dtype), lse


def fa_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool,
                    sm_scale: float):
    """dq as `_bwd_dq_kernel` computes it: scale * dS.K, dS cast to k.dtype."""
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(k.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.float(), k.float()) * sm_scale
    return dq.to(q.dtype)


def fa_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool,
                     sm_scale: float):
    """(dk, dv) as `_bwd_dkv_kernel` computes them: dv = P^T.dO,
    dk = scale * dS^T.Q, with P cast to do.dtype and dS to q.dtype."""
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float()) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


# --- kernel wrappers -------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "rtt_flash_fwd": [_I, _I] + [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    "rtt_flash_bwd_dq": [_I, _I] + [_P] * 7 + [_I] * 4 + [_F, _I, _P],
    "rtt_flash_bwd_dkv": [_I, _I] + [_P] * 8 + [_I] * 4 + [_F, _I, _P],
}
_bound: dict[str, object] = {}


def _bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _kernel(name: str):
    if name not in _bound:
        _bound[name] = _bind(_cuda.load("flash_attention"), name)
    return _bound[name]


def use_library(lib: ctypes.CDLL | None) -> None:
    """Launch the kernels of `lib`, another build of flash_attention.cu,
    from now on; None returns to the package's own build."""
    _bound.clear()
    if lib is not None:
        _bound.update({name: _bind(lib, name) for name in _ARGTYPES})


def _on_cpu(*tensors) -> bool:
    """True for all-CPU tensors (plain version), False for all-CUDA (kernel)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(
        f"flash attention takes tensors all on the CPU (plain version) or "
        f"all on one CUDA device (kernel), got {[str(t.device) for t in tensors]}")


def _check(q, k, v, *same_as_q) -> tuple:
    """Validate kernel inputs; return (dtype code, D, B, H, Tq, Tkv)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q (B,Tq,H,D), k/v (B,Tkv,H,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, tq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash attention kernels take bf16 or fp32, not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in {HEAD_DIMS}, not {d}")
    for t in (k, v, *same_as_q):
        if t.dtype != q.dtype:
            raise ValueError(f"dtype mismatch: {t.dtype} vs {q.dtype}")
    for t in same_as_q:
        if t.shape != q.shape:
            raise ValueError(f"shape {tuple(t.shape)} differs from q {tuple(q.shape)}")
    for t in (q, k, v, *same_as_q):
        if not t.is_contiguous():
            raise ValueError("flash attention kernels take contiguous tensors")
    if min(tq, k.shape[1]) < 1:
        raise ValueError("flash attention needs Tq, Tkv >= 1")
    return _DTYPE_CODES[q.dtype], d, b, h, tq, k.shape[1]


def _check_stats(lse, delta, b, h, tq) -> None:
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b, h, tq) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 ({b}, {h}, {tq}), "
                             f"got {t.dtype} {tuple(t.shape)}")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fa_fwd(q, k, v, *, causal: bool, sm_scale: float):
    """Forward kernel: (o (B,Tq,H,D) in q.dtype, lse (B,H,Tq) fp32)."""
    if _on_cpu(q, k, v):
        return fa_fwd_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    code, d, b, h, tq, tkv = _check(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    fn = _kernel("rtt_flash_fwd")
    with torch.cuda.device(q.device):
        status = fn(code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), lse.data_ptr(), b, h, tq, tkv,
                    float(sm_scale), int(causal), _stream(q))
    launches["fa_fwd"] += 1
    _cuda.check(status, "rtt_flash_fwd")
    return o, lse


def fa_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float):
    """dq kernel: dq (B,Tq,H,D) in q.dtype."""
    if _on_cpu(q, k, v, do, lse, delta):
        return fa_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                               sm_scale=sm_scale)
    code, d, b, h, tq, tkv = _check(q, k, v, do)
    _check_stats(lse, delta, b, h, tq)
    dq = torch.empty_like(q)
    fn = _kernel("rtt_flash_bwd_dq")
    with torch.cuda.device(q.device):
        status = fn(code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), b, h, tq, tkv, float(sm_scale),
                    int(causal), _stream(q))
    launches["fa_bwd_dq"] += 1
    _cuda.check(status, "rtt_flash_bwd_dq")
    return dq


def fa_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float):
    """dk/dv kernel: (dk, dv), each (B,Tkv,H,D) in k.dtype."""
    if _on_cpu(q, k, v, do, lse, delta):
        return fa_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                                sm_scale=sm_scale)
    code, d, b, h, tq, tkv = _check(q, k, v, do)
    _check_stats(lse, delta, b, h, tq)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _kernel("rtt_flash_bwd_dkv")
    with torch.cuda.device(q.device):
        status = fn(code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), b, h, tq, tkv,
                    float(sm_scale), int(causal), _stream(q))
    launches["fa_bwd_dkv"] += 1
    _cuda.check(status, "rtt_flash_bwd_dkv")
    return dk, dv


def padded_head_dim(d: int) -> int:
    """The least of HEAD_DIMS that holds head dim `d`; `d` itself when
    none does (the kernels then refuse it)."""
    return next((h for h in HEAD_DIMS if h >= d), d)


class _FlashAttention(torch.autograd.Function):
    """O = flash attention; the backward runs the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = fa_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # delta = rowsum(dO * O), outside the kernels as in the JAX package.
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        dq = fa_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """Fused attention. q, k, v: (B, T, H, D) -> (B, T, H, D).

    CUDA tensors run the kernels; CPU tensors run their plain versions.
    A head dim below one of HEAD_DIMS is zero-padded up to it: the zero
    columns add nothing to q.k, so the scores, lse and delta are those of
    the unpadded inputs, the output's and grads' padded columns are zero,
    and the result is sliced back. GQA/MQA: callers repeat kv heads
    before the call.
    """
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    pad = padded_head_dim(d) - d
    if not pad:
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, sm_scale)[..., :d].contiguous()
