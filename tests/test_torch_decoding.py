"""ray_tpu_torch paged decoding against the JAX package, on the CPU.

TINY (4 query heads over 2 kv heads, so GQA is on the path) at fp32
compute in both packages, weights drawn by the JAX init and carried across
with `jax_bridge`, inputs from numpy at a fixed seed; the steps' tests run
again on TINY_MOE (4 experts, top 2, dropless routing). fp32 runs the same
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


def _model(name):
    jcfg = dataclasses.replace(jax_configs.get(name), compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get(name), compute_dtype=torch.float32)
    jp = jax_init(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def model():
    jcfg, jp, tcfg, tp = _model("tiny")
    assert tcfg.n_kv_heads < tcfg.n_heads
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def moe_model():
    return _model("tiny-moe")


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


# ---------------------------------------------------------------------------
# speculative verification through the block pool
# ---------------------------------------------------------------------------
def test_paged_verify_step_on_a_partly_right_draft_matches_jax(model):
    """Lane 0 (greedy) drafts two right proposals and a wrong one after a
    prefilled prompt, lane 1 samples the same draft, lane 2 is inactive.
    Tokens and `accepted` equal JAX's, the scattered KV is within the
    tolerance, and each window column's logits equal JAX's decode step
    fed the same candidates one at a time."""
    jcfg, jp, tcfg, tp = model
    prompt = np.array([5, 6, 7, 8, 9, 10], np.int32)
    n, k = len(prompt), 4
    table = np.array([3, 9, 14, 2], np.int32)          # 16 positions
    jc, tc = _caches(tcfg)
    toks = np.zeros(8, np.int32)
    toks[:n] = prompt
    jc, jlast = jdec.paged_prefill_chunk(
        jp, jc, jnp.asarray(toks), jnp.asarray(table), jnp.int32(0),
        jnp.int32(n), jcfg)
    tc, _ = tdec.paged_prefill_chunk(tp, tc, torch.from_numpy(toks),
                                     torch.from_numpy(table), 0, n, tcfg)
    # The reference: JAX's sequential greedy decode on a copy of the pool
    # gives the continuation, and, fed the draft one token at a time, the
    # logits of each window column.
    ref, ref_logits = [int(np.argmax(np.asarray(jlast)))], []
    jref = jdec.PagedKVCache(k=jnp.array(jc.k), v=jnp.array(jc.v))
    for i in range(k):
        fed = ref[-1] if i < k - 1 else (ref[3] + 1) % tcfg.vocab_size
        jref, logits = jdec.paged_decode_step(
            jp, jref, jnp.asarray([fed], jnp.int32),
            jnp.asarray(table[None]), jnp.asarray([n + i], jnp.int32),
            jnp.asarray([True]), jcfg)
        ref_logits.append(np.asarray(logits)[0])
        ref.append(int(np.argmax(ref_logits[-1])))
    draft = [ref[0], ref[1], ref[2], (ref[3] + 1) % tcfg.vocab_size]
    cand = np.array([draft, draft, [0] * k], np.int32)
    tables = np.stack([table, table, np.zeros_like(table)])
    lengths = np.array([n, n, 0], np.int32)
    active = np.array([True, True, False])
    temps = np.array([0.0, 0.7, 0.0], np.float32)
    # Lane 1 samples and would write the same positions as lane 0: give it
    # blocks of its own so the two writes do not collide.
    tables[1] = [4, 5, 6, 7]
    jc, jtok, jacc, _ = jdec.paged_verify_step(
        jp, jc, jnp.asarray(cand), jnp.asarray(tables), jnp.asarray(lengths),
        jnp.asarray(active), jnp.asarray(temps), jax.random.key(0), jcfg)
    args = [torch.from_numpy(a) for a in (cand, tables, lengths, active)]
    logits = tdec._paged_window(tp, tdec.PagedKVCache(
        k=tc.k.clone(), v=tc.v.clone()), *args, tcfg)
    np.testing.assert_allclose(logits[0].numpy(), np.stack(ref_logits),
                               **TOL)
    tc, ttok, tacc = tdec.paged_verify_step(
        tp, tc, *args[:3], args[3], torch.from_numpy(temps),
        torch.Generator().manual_seed(0), tcfg)
    assert ttok.dtype == tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy()[:2], np.asarray(jacc)[:2])
    assert tacc.tolist()[:2] == [2, 0]
    np.testing.assert_array_equal(ttok.numpy()[0], np.asarray(jtok)[0])
    assert ttok.numpy()[0, :3].tolist() == ref[1:4]
    # The sampled lane's column 0 is a draw; the rest are greedy.
    np.testing.assert_array_equal(ttok.numpy()[1, 1:], np.asarray(jtok)[1, 1:])
    _assert_pools_close(jc, tc)


@pytest.mark.parametrize("size,ngram", [(0, 2), (2, 2), (3, 2), (12, 1),
                                        (40, 2), (40, 3), (200, 2)])
def test_ngram_propose_matches_jax(size, ngram):
    """Seeded contexts over a small alphabet (so n-grams recur), with the
    empty and too-short cases, and proposal budgets past the context's
    end."""
    rng = np.random.default_rng(size * 10 + ngram)
    for trial in range(20):
        ctx = rng.integers(0, 4 if trial % 2 else 30, size).tolist()
        for k_minus_1 in (1, 3, 7):
            got = tdec.ngram_propose(ctx, k_minus_1, ngram)
            assert got == jdec.ngram_propose(ctx, k_minus_1, ngram)
            assert len(got) <= k_minus_1
    assert tdec.ngram_propose([1, 2, 1, 2], 3, 2) == [1, 2]


# ---------------------------------------------------------------------------
# contiguous cache (the fixed-slot engine's steps)
# ---------------------------------------------------------------------------
T_MAX = 32      # contiguous cache positions per slot


def _contiguous(cfg, rng=None, lengths=(0, 0, 0)):
    """The same (L, 3, T_MAX, Hkv, D) cache in both packages."""
    shape = (cfg.n_layers, len(lengths), T_MAX, cfg.n_kv_heads, cfg.head_dim)
    k, v = ((rng.standard_normal(shape, dtype=np.float32) if rng is not None
             else np.zeros(shape, np.float32)) for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    jc = jdec.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                      lengths=jnp.asarray(lens))
    tc = tdec.KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                      lengths=torch.from_numpy(lens.copy()))
    return jc, tc


def _assert_slots_close(jc, tc, slots):
    """KV on [0, length) of each listed slot, and every slot's length."""
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    for s in slots:
        n = int(tc.lengths[s])
        for name in ("k", "v"):
            np.testing.assert_allclose(
                getattr(tc, name).numpy()[:, s, :n],
                np.asarray(getattr(jc, name))[:, s, :n], **TOL,
                err_msg=f"{name} slot {s}")


def test_prefill_then_decode_steps_match_jax(model):
    """A 10-token prompt padded to 16 into slot 1 of a random cache, then
    decode steps with slot 0 active at its own length and slot 2 idle at a
    stale length near the end of the cache."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(6)
    jc, tc = _contiguous(tcfg, rng, lengths=(5, 0, T_MAX - 1))
    prompt = rng.integers(1, tcfg.vocab_size, 10).astype(np.int32)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :10] = prompt
    jc, jlast = jdec.prefill(jp, jc, jnp.asarray(padded), jnp.int32(1),
                             jnp.int32(10), jcfg)
    tc, tlast = tdec.prefill(tp, tc, torch.from_numpy(padded), 1, 10, tcfg)
    assert tlast.shape == (tcfg.vocab_size,)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    _assert_slots_close(jc, tc, (0, 1))
    active = np.array([True, True, False])
    tok = np.array([7, int(np.argmax(np.asarray(jlast))), 3], np.int32)
    for _ in range(4):
        jc, jlog = jdec.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(active), jcfg)
        tc, tlog = tdec.decode_step(tp, tc, torch.from_numpy(tok),
                                    torch.from_numpy(active), tcfg)
        np.testing.assert_allclose(tlog.numpy()[:2], np.asarray(jlog)[:2],
                                   **TOL)
        tok = np.array([*np.argmax(np.asarray(jlog)[:2], -1), 3], np.int32)
    _assert_slots_close(jc, tc, (0, 1))
    assert tc.lengths.tolist() == [9, 14, T_MAX - 1]


def test_verify_step_on_a_partly_right_draft_matches_jax(model):
    """The contiguous verifier against JAX's: window logits within the
    tolerance, tokens, `accepted` and the advanced lengths equal, and the
    KV of the accepted positions within the tolerance. Slot 0 is greedy
    with two right proposals, slot 1 samples, slot 2 is idle at a stale
    length past T - K (an unclamped write would leave the cache)."""
    jcfg, jp, tcfg, tp = model
    prompt = np.array([[5, 6, 7, 8, 0, 0, 0, 0]], np.int32)
    jc, tc = _contiguous(tcfg, np.random.default_rng(7),
                         lengths=(0, 0, T_MAX - 2))
    for slot in (0, 1):
        jc, jlast = jdec.prefill(jp, jc, jnp.asarray(prompt), jnp.int32(slot),
                                 jnp.int32(4), jcfg)
        tc, _ = tdec.prefill(tp, tc, torch.from_numpy(prompt), slot, 4, tcfg)
    ref = [int(np.argmax(np.asarray(jlast)))]
    jref = jdec.KVCache(k=jnp.array(jc.k), v=jnp.array(jc.v),
                        lengths=jnp.array(jc.lengths))
    on = jnp.asarray([True, False, False])
    for _ in range(3):
        jref, logits = jdec.decode_step(
            jp, jref, jnp.asarray([ref[-1], 0, 0], jnp.int32), on, jcfg)
        ref.append(int(np.argmax(np.asarray(logits)[0])))
    draft = [ref[0], ref[1], ref[2], (ref[3] + 1) % tcfg.vocab_size]
    cand = np.array([draft, draft, [1, 2, 3, 4]], np.int32)
    active = np.array([True, True, False])
    temps = np.array([0.0, 0.9, 0.0], np.float32)
    jwin, _, _ = jdec._wide_decode(jp, jc, jnp.asarray(cand), jcfg)
    twin = tdec._wide_decode(tp, tdec.KVCache(
        k=tc.k.clone(), v=tc.v.clone(), lengths=tc.lengths.clone()),
        torch.from_numpy(cand), torch.from_numpy(active), tcfg)
    np.testing.assert_allclose(twin.numpy()[:2], np.asarray(jwin)[:2], **TOL)
    jc, jtok, jacc, _ = jdec.verify_step(
        jp, jc, jnp.asarray(cand), jnp.asarray(active), jnp.asarray(temps),
        jax.random.key(0), jcfg)
    tc, ttok, tacc = tdec.verify_step(
        tp, tc, torch.from_numpy(cand), torch.from_numpy(active),
        torch.from_numpy(temps), torch.Generator().manual_seed(0), tcfg)
    assert tacc.tolist() == np.asarray(jacc).tolist() == [2, 0, 0]
    np.testing.assert_array_equal(ttok.numpy()[0], np.asarray(jtok)[0])
    assert ttok.numpy()[0, :3].tolist() == ref[1:4]
    np.testing.assert_array_equal(ttok.numpy()[1, 1:], np.asarray(jtok)[1, 1:])
    _assert_slots_close(jc, tc, (0, 1))
    assert tc.lengths.tolist() == [7, 5, T_MAX - 2]


def test_greedy_decode_burst_matches_jax(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(8)
    jc, tc = _contiguous(tcfg, rng, lengths=(6, 11, 3))
    tokens = rng.integers(0, tcfg.vocab_size, 3).astype(np.int32)
    active = np.array([True, False, True])
    temps = np.zeros(3, np.float32)
    jc, jtoks, _ = jdec.decode_burst(
        jp, jc, jnp.asarray(tokens), jnp.asarray(active), jnp.asarray(temps),
        jax.random.key(0), jcfg, n_steps=5)
    tc, ttoks = tdec.decode_burst(
        tp, tc, torch.from_numpy(tokens), torch.from_numpy(active),
        torch.from_numpy(temps), torch.Generator(), tcfg, n_steps=5)
    assert ttoks.shape == (5, 3)
    np.testing.assert_array_equal(ttoks.numpy()[:, active],
                                  np.asarray(jtoks)[:, active])
    _assert_slots_close(jc, tc, (0, 1, 2))
    assert int(tdec.sample_logits(torch.eye(3), None, temperature=0.0)[2]) == 2


def test_prefix_snapshot_survives_later_writes_and_matches_jax(model):
    """extract_prefix copies: after the slot is prefilled with another
    prompt the snapshot still holds the first one, and inserting it into
    another slot gives JAX's cache there."""
    jcfg, jp, tcfg, tp = model
    jc, tc = _contiguous(tcfg, np.random.default_rng(9))
    first = np.zeros((1, 16), np.int32)
    first[0, :9] = np.arange(20, 29)
    second = np.zeros((1, 16), np.int32)
    second[0, :12] = np.arange(40, 52)
    jc, _ = jdec.prefill(jp, jc, jnp.asarray(first), jnp.int32(0),
                         jnp.int32(9), jcfg)
    tc, _ = tdec.prefill(tp, tc, torch.from_numpy(first), 0, 9, tcfg)
    jk, jv = jdec.extract_prefix(jc, jnp.int32(0), t=16)
    tk, tv = tdec.extract_prefix(tc, 0, 16)
    held = tk.clone()
    tc, _ = tdec.prefill(tp, tc, torch.from_numpy(second), 0, 12, tcfg)
    assert torch.equal(tk, held)            # not a view of slot 0
    assert not torch.equal(tc.k[:, 0, :16], held)
    np.testing.assert_allclose(tk.numpy()[:, :9], np.asarray(jk)[:, :9], **TOL)
    np.testing.assert_allclose(tv.numpy()[:, :9], np.asarray(jv)[:, :9], **TOL)
    jc = jdec.insert_prefix(jc, jk, jv, jnp.int32(2), jnp.int32(9))
    tc = tdec.insert_prefix(tc, tk, tv, 2, 9)
    assert int(tc.lengths[2]) == 9
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(tc, name).numpy()[:, 2, :9],
                                   np.asarray(getattr(jc, name))[:, 2, :9],
                                   **TOL)
    extract, insert, sample = tdec.make_prefix_cache_fns()
    assert (extract, insert, sample) == (tdec.extract_prefix,
                                         tdec.insert_prefix, tdec.sample_one)


# ---------------------------------------------------------------------------
# MoE: the same steps on TINY_MOE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    test_prefill_chunks_then_decode_across_a_block_boundary,
    test_decode_step_and_burst_on_a_filled_pool,
    test_paged_verify_step_on_a_partly_right_draft_matches_jax,
    test_prefill_then_decode_steps_match_jax,
    test_verify_step_on_a_partly_right_draft_matches_jax,
    test_greedy_decode_burst_matches_jax,
], ids=lambda case: case.__name__[len("test_"):])
def test_tiny_moe_steps_match_jax(moe_model, case):
    """Each paged and contiguous step's test above, on TINY_MOE: its MLP is
    the dropless MoE in both packages."""
    case(moe_model)


def test_tiny_moe_decode_matches_reprefill(moe_model):
    """The port's twin of tests/test_llm.py's MoE check: the cached greedy
    decode gives the tokens of re-prefilling the grown sequence each step,
    and its logits are within the tolerance of the re-prefill's (dropless
    routing does not depend on how many tokens share a call)."""
    _, _, tcfg, tp = moe_model
    prompt = np.random.default_rng(10).integers(0, tcfg.vocab_size, 8).tolist()
    seq, ref_tokens, ref_logits = list(prompt), [], []
    for _ in range(4):
        padded = torch.zeros(1, T_MAX, dtype=torch.int32)
        padded[0, :len(seq)] = torch.tensor(seq)
        _, last = tdec.prefill(tp, tdec.init_cache(tcfg, 1, T_MAX, device="cpu"),
                               padded, 0, len(seq), tcfg)
        ref_logits.append(last)
        ref_tokens.append(int(torch.argmax(last)))
        seq.append(ref_tokens[-1])
    cache = tdec.init_cache(tcfg, 1, T_MAX, device="cpu")
    padded = torch.zeros(1, 16, dtype=torch.int32)
    padded[0, :8] = torch.tensor(prompt)
    cache, last = tdec.prefill(tp, cache, padded, 0, 8, tcfg)
    out, logits = [int(torch.argmax(last))], [last]
    for _ in range(3):
        cache, step = tdec.decode_step(
            tp, cache, torch.tensor([out[-1]], dtype=torch.int32),
            torch.tensor([True]), tcfg)
        logits.append(step[0])
        out.append(int(torch.argmax(step[0])))
    assert out == ref_tokens
    torch.testing.assert_close(torch.stack(logits), torch.stack(ref_logits),
                               **TOL)
