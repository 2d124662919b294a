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
    _check_plain_kernels_against_jax(_arrays(2, tq=tq, tkv=tkv, n=4), causal)


# Lengths where the kernels' TMA boxes run past T (zero-filled rows) and
# the causal diagonal and ragged-edge masks meet: one row, one past a
# 64-row tile, one past two 128-row tiles, and Tq != Tkv either way.
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tkv", [(1, 1), (65, 65), (257, 257), (257, 300),
                                    (300, 257), (1, 65)])
def test_plain_kernels_match_jax_at_tile_edges(causal, tq, tkv):
    _check_plain_kernels_against_jax(
        _arrays(5, b=1, tq=tq, tkv=tkv, h=2, d=64, n=4), causal)


def _check_plain_kernels_against_jax(arrays, causal):
    q, k, v, do = arrays
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


@pytest.mark.parametrize("d,padded", [
    (16, 64), (32, 64), (64, 64), (80, 128), (96, 128), (128, 128), (256, 256)])
def test_padded_head_dim(d, padded):
    assert attention.padded_head_dim(d) == padded


@pytest.mark.parametrize("d", [16, 80])
def test_flash_attention_pads_head_dim_for_the_kernels(monkeypatch, d):
    """A head dim below one of HEAD_DIMS reaches all three wrappers padded
    with zeros to it, and the sliced result is JAX's attention at `d`."""
    seen = []
    for name in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"):
        def run(q, *args, _fn=getattr(attention, name), _name=name, **kw):
            seen.append((_name, q.shape[-1]))
            return _fn(q, *args, **kw)
        monkeypatch.setattr(attention, name, run)
    q, k, v, g = _arrays(6, tq=48, h=2, d=d, n=4)
    out_j, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, True, None),
                         q, k, v)
    grads_j = vjp(jnp.asarray(g))
    qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
    out_t = attention.flash_attention(qt, kt, vt, True)
    out_t.backward(torch.from_numpy(g))
    padded = attention.padded_head_dim(d)
    assert seen == [("fa_fwd", padded), ("fa_bwd_dq", padded), ("fa_bwd_dkv", padded)]
    assert out_t.shape == q.shape and out_t.is_contiguous()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=ATOL_OUT)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_GRAD)


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


# Lines as nvcc -Xptxas -v prints them for two kernels of the source.
_PTXAS_LOG = """\
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to insufficient register resources for the \
function '_ZN51_GLOBAL__N__ba107a96_18_flash_attention_cu_a0e9620c23fa_bwd_\
dkv_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiifi'
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__ba107a96_18_flash_\
attention_cu_a0e9620c23fa_bwd_dkv_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_\
S1_PKfS3_P13__nv_bfloat16S5_iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__ba107a96_18_flash_\
attention_cu_a0e9620c23fa_bwd_dkv_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_\
S1_PKfS3_P13__nv_bfloat16S5_iiifi
    264 bytes stack frame, 264 bytes spill stores, 260 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1088 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__ba107a96_18_flash_\
attention_cu_a0e9620c16fa_bwd_dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_\
PKfS6_PS2_iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__ba107a96_18_flash_\
attention_cu_a0e9620c16fa_bwd_dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_\
PKfS6_PS2_iiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, 16 bytes smem, 408 bytes cmem[0]
"""


def test_ptxas_report_reads_each_kernel():
    report = _cuda.ptxas_report(_PTXAS_LOG)
    assert sorted(report) == ["fa_bwd_dkv_wgmma_kernel<128>",
                              "fa_bwd_dq_kernel<bf16, 64>"]
    dkv = report["fa_bwd_dkv_wgmma_kernel<128>"]
    assert (dkv["registers"], dkv["spill_store_bytes"],
            dkv["spill_load_bytes"], dkv["static_smem_bytes"]) == (168, 264, 260, 0)
    # Only the serialisation line is a note: kernel names holding "wgmma"
    # are not.
    assert len(dkv["notes"]) == 1 and "serialized" in dkv["notes"][0]
    dq = report["fa_bwd_dq_kernel<bf16, 64>"]
    assert (dq["registers"], dq["static_smem_bytes"], dq["notes"]) == (128, 16, [])


@pytest.mark.parametrize("mangled,label", [
    ("_ZN1a19fa_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16",
     "fa_fwd_wgmma_kernel<64>"),
    ("_ZN1a13fa_fwd_kernelIfLi128EEEvPKT_", "fa_fwd_kernel<float, 128>"),
    ("_ZN1a16fa_bwd_dq_kernelI13__nv_bfloat16Li64EEEvPKT_", "fa_bwd_dq_kernel<bf16, 64>"),
    ("_ZN1a22fa_bwd_dq_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiifi",
     "fa_bwd_dq_wgmma_kernel<64>"),
])
def test_kernel_labels(mangled, label):
    assert _cuda.kernel_label(mangled) == label


def test_build_report_covers_every_wgmma_kernel():
    """chip_smoke.py's build report checks each wgmma kernel the source
    defines, so a new one cannot slip out of it."""
    import re

    import chip_smoke

    src = open(os.path.join(_cuda.CSRC_DIR, "flash_attention.cu")).read()
    defined = set(re.findall(r"\b(\w+_wgmma_kernel)\(", src))
    assert defined == set(chip_smoke.WGMMA_KERNELS)
    assert len(set(chip_smoke.WGMMA_KERNELS.values())) == len(defined)


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
@pytest.mark.parametrize("b,tq,tkv,h,d", [
    (2, 200, 200, 4, 64), (1, 257, 300, 4, 64), (1, 257, 300, 4, 128)])
def test_kernels_match_plain_on_card(cuda_device, causal, b, tq, tkv, h, d):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(b, t, h, d, generator=g, device=cuda_device,
                               dtype=torch.bfloat16) for t in (tq, tkv, tkv, tq))
    kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(d))
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


@pytest.mark.parametrize("tq,tkv,causal,pairs", [
    (4, 4, True, 10), (4, 4, False, 16), (5, 3, True, 6 + 2 * 3), (3, 5, True, 6)])
def test_chip_smoke_bound_counts_kept_pairs(tq, tkv, causal, pairs):
    """The bound counts the (q, k) pairs the causal mask keeps, k <= q."""
    import chip_smoke

    b, h, d = 1, 1, 64
    got = chip_smoke.work("fa_fwd", b, tq, tkv, h, d, causal)
    flops = 2.0 * 2 * pairs * d
    nbytes = (2 * tq + 2 * tkv) * d * 2 + tq * 4
    assert got["bound_ms"] == pytest.approx(
        max(flops / chip_smoke.PEAK_BF16_FLOPS, nbytes / chip_smoke.PEAK_HBM_BYTES) * 1e3)


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::fa_fwd_wgmma_kernel<64>(CUtensorMap_st, ...)", "fa_fwd"),
    ("void (anonymous namespace)::fa_bwd_dkv_wgmma_kernel<64>(...)", "fa_bwd_dkv"),
    ("void (anonymous namespace)::fa_bwd_dq_kernel<__nv_bfloat16, 64>(...)", "fa_bwd_dq"),
    ("void (anonymous namespace)::fa_bwd_dq_wgmma_kernel<64>(CUtensorMap_st, ...)",
     "fa_bwd_dq"),
    ("void (anonymous namespace)::fa_fwd_kernel<float, 64>(...)", "fa_fwd"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", "matmul (cuBLAS)"),
])
def test_profile_groups_attention_kernels(name, group):
    from ray_tpu_torch.scripts.profile_step import kernel_group

    assert kernel_group(name) == group


@pytest.mark.parametrize("name,label", [
    ("void (anonymous namespace)::fa_bwd_dq_wgmma_kernel<64>(CUtensorMap_st, ...)",
     "fa_bwd_dq_wgmma_kernel<64>"),
    ("void (anonymous namespace)::fa_fwd_kernel<float, 128>(float const*, ...)",
     "fa_fwd_kernel<float, 128>"),
])
def test_profile_labels_attention_kernels(name, label):
    from ray_tpu_torch.scripts.profile_step import attention_kernel_name

    assert attention_kernel_name(name) == label
