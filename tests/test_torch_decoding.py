"""ray_tpu_torch paged decoding against the JAX package, on the CPU.

TINY (4 query heads over 2 kv heads, so GQA is on the path) at fp32
compute in both packages, weights drawn by the JAX init and carried across
with `jax_bridge`, inputs from numpy at a fixed seed. fp32 runs the same
arithmetic in both frameworks, so logits and the scattered KV blocks are
held to atol 1e-4, rtol 1e-4. Pool block 0 is left out of the KV
comparisons: inactive lanes all write it, and which duplicate write lands
is unspecified in both frameworks. The block copies are held bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import decoding as jdec
from ray_tpu.models import init_params as jax_init
from ray_tpu_torch.models import configs
from ray_tpu_torch.models import decoding as tdec
from ray_tpu_torch.models.jax_bridge import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
BS = 4           # tokens per block
N_BLOCKS = 24    # pool blocks, block 0 the null block


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_configs.TINY, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.TINY, compute_dtype=torch.float32)
    assert tcfg.n_kv_heads < tcfg.n_heads
    jp = jax_init(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _caches(cfg, rng=None):
    """The same pool in both packages: zeros, or N(0, 1) KV from `rng`."""
    shape = (cfg.n_layers, N_BLOCKS, BS, cfg.n_kv_heads, cfg.head_dim)
    k, v = ((rng.standard_normal(shape, dtype=np.float32) if rng is not None
             else np.zeros(shape, np.float32)) for _ in range(2))
    jc = jdec.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v))
    tc = tdec.PagedKVCache(k=torch.from_numpy(k.copy()),
                           v=torch.from_numpy(v.copy()))
    return jc, tc


def _assert_pools_close(jc, tc):
    for name in ("k", "v"):
        want = np.asarray(getattr(jc, name))[:, 1:]
        got = getattr(tc, name).numpy()[:, 1:]
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


def test_prefill_chunks_then_decode_across_a_block_boundary(model):
    """Two full chunks and a ragged last one, then decode steps whose
    positions cross from one block into the next."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(0)
    chunk, n = 8, 21                         # chunks of 8, 8, 5 (padded)
    prompt = rng.integers(1, tcfg.vocab_size, n).astype(np.int32)
    # 8 table entries cover 32 positions; scattered, not contiguous.
    table = rng.permutation(np.arange(1, N_BLOCKS))[:8].astype(np.int32)
    jc, tc = _caches(tcfg)
    for start in range(0, n, chunk):
        nv = min(chunk, n - start)
        toks = np.zeros(chunk, np.int32)
        toks[:nv] = prompt[start:start + nv]
        jc, jlast = jdec.paged_prefill_chunk(
            jp, jc, jnp.asarray(toks), jnp.asarray(table), jnp.int32(start),
            jnp.int32(nv), jcfg)
        tc, tlast = tdec.paged_prefill_chunk(
            tp, tc, torch.from_numpy(toks), torch.from_numpy(table), start,
            nv, tcfg)
        assert tlast.shape == (tcfg.vocab_size,)
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    _assert_pools_close(jc, tc)

    # Decode: slot 0 continues the prompt at positions 21, 22, 23, 24 (a
    # block boundary at 24); slot 1 is inactive and writes the null block.
    tables = np.stack([table, np.zeros_like(table)])
    active = np.array([True, False])
    tok = np.array([int(np.argmax(tlast.numpy())), 0], np.int32)
    for length in range(n, n + 4):
        lengths = np.array([length, 0], np.int32)
        jc, jlog = jdec.paged_decode_step(
            jp, jc, jnp.asarray(tok), jnp.asarray(tables),
            jnp.asarray(lengths), jnp.asarray(active), jcfg)
        tc, tlog = tdec.paged_decode_step(
            tp, tc, torch.from_numpy(tok), torch.from_numpy(tables),
            torch.from_numpy(lengths), torch.from_numpy(active), tcfg)
        np.testing.assert_allclose(tlog[0].numpy(), np.asarray(jlog)[0],
                                   **TOL)
        tok = np.array([int(np.argmax(np.asarray(jlog)[0])), 0], np.int32)
    _assert_pools_close(jc, tc)


def test_decode_step_and_burst_on_a_filled_pool(model):
    """Three live lanes and one inactive over a pool of random KV: one
    writes the last offset of a block, one the first offset of a new
    block. The burst runs greedy, so its tokens must equal JAX's."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(1)
    jc, tc = _caches(tcfg, rng)
    ids = rng.permutation(np.arange(1, N_BLOCKS)).astype(np.int32)
    tables = np.zeros((4, 5), np.int32)
    tables[0], tables[1], tables[2, :3] = ids[:5], ids[5:10], ids[10:13]
    lengths = np.array([7, 12, 3, 0], np.int32)    # offsets 3, 0, 3
    active = np.array([True, True, True, False])
    tokens = rng.integers(0, tcfg.vocab_size, 4).astype(np.int32)
    args_j = [jnp.asarray(a) for a in (tokens, tables, lengths, active)]
    args_t = [torch.from_numpy(a) for a in (tokens, tables, lengths, active)]

    jc1, jlog = jdec.paged_decode_step(jp, jc, *args_j, jcfg)
    tc1, tlog = tdec.paged_decode_step(tp, tc, *args_t, tcfg)
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    _assert_pools_close(jc1, tc1)

    jc, tc = _caches(tcfg, np.random.default_rng(1))
    temps = np.zeros(4, np.float32)
    jc, jtoks, _ = jdec.paged_decode_burst(
        jp, jc, *args_j, jnp.asarray(temps), jax.random.key(0), jcfg,
        n_steps=3)
    tc, ttoks = tdec.paged_decode_burst(
        tp, tc, *args_t, torch.from_numpy(temps), torch.Generator(), tcfg,
        n_steps=3)
    assert ttoks.shape == (3, 4)
    np.testing.assert_array_equal(ttoks.numpy()[:, :3],
                                  np.asarray(jtoks)[:, :3])
    _assert_pools_close(jc, tc)


def test_copy_block_matches_jax(model):
    _, _, tcfg, _ = model
    jc, tc = _caches(tcfg, np.random.default_rng(2))
    jc = jdec.copy_block(jc, jnp.int32(9), jnp.int32(4))
    tc = tdec.copy_block(tc, 9, 4)
    for name in ("k", "v"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))


def test_gather_scatter_round_trip_is_bit_exact(model):
    """A frame gathered from one pool and scattered into another reads
    back bit for bit, and equals the JAX package's frame and pool."""
    _, _, tcfg, _ = model
    jsrc, tsrc = _caches(tcfg, np.random.default_rng(3))
    jdst, tdst = _caches(tcfg, np.random.default_rng(4))
    src_ids, dst_ids = [3, 11, 7], [5, 2, 20]
    frame = tdec.gather_blocks(tsrc, src_ids)
    assert frame.shape == (2, tcfg.n_layers, 3, BS, tcfg.n_kv_heads,
                           tcfg.head_dim)
    assert frame.dtype == tsrc.k.dtype
    np.testing.assert_array_equal(
        frame.numpy(), np.asarray(jdec.gather_blocks(jsrc, src_ids)))
    tdst = tdec.scatter_blocks(tdst, dst_ids, frame.numpy())
    jdst = jdec.scatter_blocks(jdst, dst_ids, np.asarray(frame))
    assert torch.equal(tdec.gather_blocks(tdst, dst_ids), frame)
    for name in ("k", "v"):
        np.testing.assert_array_equal(getattr(tdst, name).numpy(),
                                      np.asarray(getattr(jdst, name)))


def test_sample_per_slot_greedy_and_mixed_lanes():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 50)).astype(np.float32) * 3
    greedy = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    gen = torch.Generator().manual_seed(0)
    zeros = np.zeros(6, np.float32)
    out = tdec.sample_per_slot(torch.from_numpy(logits), gen,
                               torch.from_numpy(zeros))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), greedy)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jdec.sample_per_slot(
            jnp.asarray(logits), jax.random.key(0), jnp.asarray(zeros))))
    # Temperature-0 lanes stay greedy beside sampled ones.
    temps = np.array([0.0, 0.7, 0.0, 1.3, 0.0, 2.0], np.float32)
    for _ in range(5):
        out = tdec.sample_per_slot(torch.from_numpy(logits), gen,
                                   torch.from_numpy(temps)).numpy()
        np.testing.assert_array_equal(out[temps == 0], greedy[temps == 0])
        assert ((out >= 0) & (out < 50)).all()
    # The stored-logits path of a prefix hit.
    assert int(tdec.sample_one(torch.from_numpy(logits[2]),
                               torch.tensor(0.0), gen)) == greedy[2]


@pytest.mark.parametrize("top_k", [0, 3])
def test_sample_per_slot_frequencies_follow_the_softmax(top_k):
    """20,000 draws at temperature 0.8: each token's frequency is within
    0.01 of softmax(logits / 0.8), over the top k when top_k > 0."""
    logits = np.array([1.0, 0.2, -0.5, 0.7, -1.5, 0.0], np.float32)
    n, temp = 20_000, 0.8
    scaled = logits / temp
    if top_k:
        scaled = np.where(scaled < np.sort(scaled)[-top_k], -np.inf, scaled)
    want = np.exp(scaled - scaled.max())
    want /= want.sum()
    rows = torch.from_numpy(np.tile(logits, (n, 1)))
    out = tdec.sample_per_slot(rows, torch.Generator().manual_seed(0),
                               torch.full((n,), temp), top_k=top_k)
    freq = np.bincount(out.numpy(), minlength=len(logits)) / n
    np.testing.assert_allclose(freq, want, atol=0.01)
    if top_k:
        assert freq[want == 0].sum() == 0
