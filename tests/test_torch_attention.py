"""ray_tpu_torch attention against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages.
On the CPU the JAX `flash_attention` runs `mha_reference` and its VJP is
`jax.vjp` of it; the port's wrappers run the plain versions of the three
CUDA kernels. The plain versions are what chip_smoke.py holds the kernels
against on the card, so they are checked here first.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import flash_attention as jax_flash
from ray_tpu.ops.attention import mha_reference as jax_mha
from ray_tpu_torch.ops import _cuda
from ray_tpu_torch.ops import attention

# fp32 tolerances of the JAX package's own attention tests (tests/test_ops.py).
ATOL_OUT = 1e-5
ATOL_GRAD = 1e-4


def _arrays(seed, b=2, tq=64, tkv=None, h=4, d=32, n=3):
    """n fp32 arrays: q-shaped first, then kv-shaped; a last `do` if n == 4."""
    rng = np.random.default_rng(seed)
    tkv = tkv or tq
    shapes = [(b, tq, h, d)] + [(b, tkv, h, d)] * 2 + [(b, tq, h, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes[:n]]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tkv,kv_offset", [
    (64, 64, 0), (100, 100, 0), (130, 130, 5), (48, 80, 0), (80, 48, 16)])
def test_mha_reference_parity(causal, tq, tkv, kv_offset):
    q, k, v = _arrays(0, tq=tq, tkv=tkv)
    want = jax_mha(q, k, v, causal=causal, kv_offset=kv_offset)
    got = attention.mha_reference(*_t(q, k, v), causal=causal,
                                  kv_offset=kv_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_OUT)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tkv", [(64, 64), (100, 100), (48, 80)])
def test_flash_attention_forward_and_grads(causal, tq, tkv):
    q, k, v, g = _arrays(1, tq=tq, tkv=tkv, n=4)
    out_j, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, causal, None),
                         q, k, v)
    grads_j = vjp(jnp.asarray(g))

    qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
    out_t = attention.flash_attention(qt, kt, vt, causal)
    out_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=ATOL_OUT)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL_GRAD)


def _jax_stats(q, k, v, do, causal):
    """lse (B,H,Tq) from the JAX scores and delta = rowsum(do * o)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = jnp.arange(q.shape[1])[:, None] >= jnp.arange(k.shape[1])[None, :]
        s = jnp.where(mask, s, -1e30)
    lse = jax.scipy.special.logsumexp(s, axis=-1)
    o = jax_mha(q, k, v, causal=causal)
    delta = jnp.sum(do * o, axis=-1).transpose(0, 2, 1)
    return np.asarray(o), np.asarray(lse), np.asarray(delta), scale


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tkv", [(64, 64), (100, 100), (48, 80)])
def test_plain_kernels_match_jax(causal, tq, tkv):
    q, k, v, do = _arrays(2, tq=tq, tkv=tkv, n=4)
    o_j, lse_j, delta_j, scale = _jax_stats(q, k, v, do, causal)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_mha(q_, k_, v_, causal=causal),
                     q, k, v)
    dq_j, dk_j, dv_j = vjp(jnp.asarray(do))
    kw = dict(causal=causal, sm_scale=scale)

    o, lse = attention.fa_fwd_plain(*_t(q, k, v), **kw)
    np.testing.assert_allclose(o.numpy(), o_j, atol=ATOL_OUT)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=ATOL_OUT)

    stats = _t(q, k, v, do, lse_j, delta_j)
    dq = attention.fa_bwd_dq_plain(*stats, **kw)
    dk, dv = attention.fa_bwd_dkv_plain(*stats, **kw)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), atol=ATOL_GRAD)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_j), atol=ATOL_GRAD)
    np.testing.assert_allclose(dv.numpy(), np.asarray(dv_j), atol=ATOL_GRAD)


def test_wrappers_run_plain_versions_on_cpu():
    q, k, v, do = _t(*_arrays(3, n=4))
    kw = dict(causal=True, sm_scale=0.25)
    before = dict(attention.launches)
    o, lse = attention.fa_fwd(q, k, v, **kw)
    o_p, lse_p = attention.fa_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o, o_p, rtol=0, atol=0)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    torch.testing.assert_close(
        attention.fa_bwd_dq(q, k, v, do, lse, delta, **kw),
        attention.fa_bwd_dq_plain(q, k, v, do, lse, delta, **kw), rtol=0, atol=0)
    # The plain versions are no kernel launch.
    assert attention.launches == before


def test_no_fallback_off_the_cpu():
    q, k, v = _t(*_arrays(4))
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="all on the CPU"):
        attention.fa_fwd(*meta, causal=True, sm_scale=1.0)
    with pytest.raises(ValueError, match="all on the CPU"):
        attention.fa_fwd(q, meta[1], v, causal=True, sm_scale=1.0)


@pytest.mark.parametrize("dtype,d,contiguous,match", [
    (torch.float16, 64, True, "bf16 or fp32"),
    (torch.bfloat16, 32, True, "head_dim"),
    (torch.float32, 128, False, "contiguous"),
])
def test_kernel_input_checks(dtype, d, contiguous, match):
    q = torch.zeros(1, 8, 2, d, dtype=dtype)
    k = torch.zeros(1, 2, 8, d, dtype=dtype).transpose(1, 2)
    if contiguous:
        k = k.contiguous()
    with pytest.raises(ValueError, match=match):
        attention._check(q, k, k)


def test_planted_faults_each_edit_the_kernel_source_once():
    """The fault check's edits still apply to the kernel source as it is."""
    from ray_tpu_torch.scripts import kernel_faults

    src = open(kernel_faults.SOURCE).read()
    for name, old, new, _ in kernel_faults.FAULTS:
        assert kernel_faults.edit(src, old, new) != src, name


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed: the build would succeed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.library_path("flash_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain_on_card(cuda_device, causal):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(2, 200, 4, 64, generator=g, device=cuda_device,
                               dtype=torch.bfloat16) for _ in range(4))
    kw = dict(causal=causal, sm_scale=0.125)
    o, lse = attention.fa_fwd(q, k, v, **kw)
    o_p, lse_p = attention.fa_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    stats = (q, k, v, do, lse_p, delta)
    dk, dv = attention.fa_bwd_dkv(*stats, **kw)
    dk_p, dv_p = attention.fa_bwd_dkv_plain(*stats, **kw)
    atol, rtol = attention.KERNEL_TOLERANCE["bf16"]
    tol = dict(atol=atol, rtol=rtol)
    torch.testing.assert_close(o.float(), o_p.float(), **tol)
    atol, rtol = attention.KERNEL_TOLERANCE["lse"]
    torch.testing.assert_close(lse, lse_p, atol=atol, rtol=rtol)
    torch.testing.assert_close(attention.fa_bwd_dq(*stats, **kw).float(),
                               attention.fa_bwd_dq_plain(*stats, **kw).float(), **tol)
    torch.testing.assert_close(dk.float(), dk_p.float(), **tol)
    torch.testing.assert_close(dv.float(), dv_p.float(), **tol)
