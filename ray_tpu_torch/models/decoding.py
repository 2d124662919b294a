"""Decoding: the contiguous slot cache and the paged block pool, with their
prefill, decode, burst and speculative-verify steps (counterpart of
`ray_tpu/models/decoding.py`).

Contiguous cache: k/v (L, S, T_max, Hkv, D) with S = slots and per-slot
lengths (S,) driving the attention mask; `prefill` fills one slot from a
bucket-padded prompt and `decode_step` advances every slot one token. The
fixed-slot `LLMEngine` runs on it.

Paged pool: KV lives in a flat pool of fixed-size blocks, (L, N_blocks,
block_size, Hkv, D), and each request holds an int32 block table mapping
its sequence positions to pool blocks. The host-side allocator
(`serve/kv_cache.py`) decides which blocks a request owns; these functions
only gather and scatter through the tables. Pool block 0 is the NULL block:
the allocator never hands it out, unallocated table entries and inactive
slots point at it, so every gather and scatter is in bounds. Writes routed
to block 0 are garbage that no attention mask reads.

The JAX package donates the cache to each jitted call; here both caches are
updated in place (`index_put_` on the layer's view), which is what the
donation buys. A functional copy of the cache per layer does not fit at
llama3-8b. So a slice of the cache is a view that the next write changes:
`extract_prefix` returns copies. Attention is an fp32 product in plain
PyTorch, as it is plain XLA in the JAX package: there is no kernel on these
paths. MoE layers route exactly (`moe_mlp_dropless`), so every step
computes the same function whatever the batch.

Tensor-parallel serving (the contiguous path, which `LLMEngine(mesh=...)`
runs): each rank holds its tp shard of the weights as `TP_RULES` lay them
out (heads, kv heads, d_ff and vocab split over tp) and of the cache
(`cache_shardings`: kv heads split), as plain tensors. The steps take the
`mesh` and compute on the rank's heads (head counts come from the local
weights), sum the partial outputs of `wo` and `w_down` over tp, look a
token up in the rank's vocab rows (a psum over tp gives every rank its
row), and gather the logits over tp, so every rank samples from the whole
vocab. The paged steps keep no mesh: the JAX paged engine has none.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.models.transformer import TransformerConfig, resolve_device
from ray_tpu_torch.ops.moe import MOE_PARAMS, MoELayout, moe_mlp_dropless
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rotary import apply_rope
from ray_tpu_torch.parallel.collectives import all_gather, axis_size, psum
from ray_tpu_torch.parallel.mesh import AXIS_TENSOR
from ray_tpu_torch.parallel.sharding import NamedSharding

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class _TP:
    """The tp split of a serving step: the mesh and its tp axis, () when
    no rank holds a split (no mesh, or tp of one rank)."""
    mesh: DeviceMesh | None = None
    axes: tuple[str, ...] = ()

    @classmethod
    def of(cls, mesh: DeviceMesh | None) -> "_TP":
        if mesh is None or AXIS_TENSOR not in mesh.mesh_dim_names or \
                axis_size(AXIS_TENSOR, mesh=mesh) == 1:
            return cls()
        return cls(mesh, (AXIS_TENSOR,))

    def leave(self, out):
        """The partial sums of a row-split product, summed over tp."""
        return psum(out, self.axes, mesh=self.mesh)

    def embed(self, embed, tokens):
        """Each token's row of the embedding, whose vocab rows split over tp:
        the rank holding it gives the row, the others zeros."""
        if not self.axes:
            return embed[tokens]
        v = embed.shape[0]
        local = tokens - self.mesh.get_local_rank(AXIS_TENSOR) * v
        mine = (local >= 0) & (local < v)
        rows = embed[torch.where(mine, local, 0)]
        return self.leave(torch.where(mine[..., None], rows, 0))

    def logits(self, logits):
        """The logits of this rank's vocab columns -> the whole vocab."""
        if not self.axes:
            return logits
        return all_gather(logits, AXIS_TENSOR, mesh=self.mesh, dim=-1)


def _qkv(bp, x, cfg: TransformerConfig, positions):
    """q, k, v of this rank's heads (all of them without a tp split)."""
    cd = cfg.compute_dtype
    h = rms_norm(x, bp["attn_norm"], eps=cfg.norm_eps)
    b, t = x.shape[:2]
    q = (h @ bp["wq"].to(cd)).view(b, t, -1, cfg.head_dim)
    k = (h @ bp["wk"].to(cd)).view(b, t, -1, cfg.head_dim)
    v = (h @ bp["wv"].to(cd)).view(b, t, -1, cfg.head_dim)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _mlp(bp, x, cfg: TransformerConfig, tp: _TP = _TP()):
    cd = cfg.compute_dtype
    h = rms_norm(x, bp["mlp_norm"], eps=cfg.norm_eps)
    if cfg.n_experts > 0:
        # Dropless: capacity routing (training's) would make a decode step
        # depend on how many tokens share it.
        return moe_mlp_dropless(h, {n: bp[n] for n in MOE_PARAMS}, cfg.moe,
                                MoELayout(mesh=tp.mesh, tensor=tp.axes))
    gate = h @ bp["w_gate"].to(cd)
    up = h @ bp["w_up"].to(cd)
    return tp.leave((F.silu(gate) * up) @ bp["w_down"].to(cd))


def _gqa(kh, vh, cfg: TransformerConfig):
    """Repeat each kv head in place (h0 h0 h1 h1 ...), as `jnp.repeat`."""
    if cfg.n_kv_heads != cfg.n_heads:
        rep = cfg.n_heads // cfg.n_kv_heads
        kh = torch.repeat_interleave(kh, rep, dim=2)
        vh = torch.repeat_interleave(vh, rep, dim=2)
    return kh, vh


def _attend(q, kh, vh, mask, cfg: TransformerConfig):
    """Queries (S, K, H, D) over keys/values (S, T, Hkv, D) where `mask`
    (S, K, T) holds: scores, softmax and P·V in fp32, the mask applied
    after the scale. Returns (S, K, H*D) in the compute dtype."""
    kh, vh = _gqa(kh, vh, cfg)
    s = torch.einsum("sqhd,sthd->sqht", q.float(), kh.float())
    s = torch.where(mask[:, :, None, :], s * cfg.head_dim ** -0.5, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    attn = torch.einsum("sqht,sthd->sqhd", p, vh.float())
    return attn.reshape(*q.shape[:2], -1).to(cfg.compute_dtype)


def _final_logits(params, x, cfg: TransformerConfig, tp: _TP = _TP()):
    cd = cfg.compute_dtype
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        return tp.logits(x @ params["embed"].to(cd).t())
    return tp.logits(x @ params["lm_head"].to(cd))


def _layer(params, i: int) -> dict:
    return {name: w[i] for name, w in params["blocks"].items()}


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def sample_per_slot(logits: torch.Tensor, generator: torch.Generator,
                    temps: torch.Tensor, top_k: int = 0) -> torch.Tensor:
    """(S, vocab) logits + per-slot temperature (0 = greedy) -> (S,) int32.

    Greedy lanes are the argmax. Sampled lanes draw from
    softmax(logits / max(temp, 1e-6)) by the Gumbel-max trick, as
    `jax.random.categorical` does, from `generator`'s stream (the JAX
    stream cannot be reproduced)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
    if top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled < kth, _NEG_INF, scaled)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled.to(torch.int32))


def sample_logits(logits: torch.Tensor, generator: torch.Generator, *,
                  temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """(S, vocab) -> (S,) sampled token ids; temperature 0 = greedy."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    temps = torch.full(logits.shape[:1], float(temperature),
                       device=logits.device)
    return sample_per_slot(logits, generator, temps, top_k)


def sample_one(last_logits: torch.Tensor, temp: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
    """Re-sample a stored last-logits vector (prefix-cache hit path)."""
    return sample_per_slot(last_logits[None], generator, temp.reshape(1))[0]


def _accept(logits, cand_tokens, temps, generator):
    """The verify steps' acceptance rule: proposal i (column i of the
    candidates) is right iff the greedy token at the previous position
    equals it, and a slot accepts the run of right proposals. Sampled
    slots accept nothing; their column 0 is sampled, so the call
    degrades to an exact decode step. Returns (tok_out (S, K) int32,
    accepted (S,) int32)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)       # (S, K)
    match = cand_tokens[:, 1:] == greedy[:, :-1]
    acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    accepted = torch.where(temps > 0.0, 0, acc).to(torch.int32)
    tok_out = greedy.clone()
    tok_out[:, 0] = sample_per_slot(logits[:, 0], generator, temps)
    return tok_out, accepted


# ---------------------------------------------------------------------------
# contiguous KV cache (the fixed-slot LLMEngine)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # (L, S, T, Hkv, D)
    v: torch.Tensor
    lengths: torch.Tensor    # (S,) int32: tokens currently in each slot


def cache_shardings(mesh: DeviceMesh) -> KVCache:
    """`NamedSharding`s of the KVCache leaves, beside the (L, S, T, Hkv, D)
    layout they index: kv heads split over the mesh's tp axis, lengths
    replicated (tensor-parallel serving)."""
    kv = NamedSharding(mesh, (None, None, None, AXIS_TENSOR, None))
    return KVCache(k=kv, v=kv, lengths=NamedSharding(mesh, ()))


def init_cache(cfg: TransformerConfig, num_slots: int, max_len: int,
               dtype: torch.dtype | None = None, *,
               device: torch.device | str = "cuda",
               shardings: KVCache | None = None) -> KVCache:
    """A zero cache. With `shardings` (see `cache_shardings`) each rank
    allocates only its shard, on the mesh's device, so no rank ever holds
    the whole cache; the leaves are this rank's plain tensors."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, num_slots, max_len, cfg.n_kv_heads, cfg.head_dim)
    if shardings is not None:
        device = shardings.k.mesh.device_type
        shape = shardings.k.shard_shape(shape)
    device = resolve_device(device)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   lengths=torch.zeros((num_slots,), dtype=torch.int32,
                                       device=device))


def prefill(params, cache: KVCache, tokens: torch.Tensor, slot: int,
            length: int, cfg: TransformerConfig, mesh: DeviceMesh | None = None):
    """Run a (1, T_pad) prompt through the model, writing its k/v into
    `slot` at positions 0..T_pad-1; `length` (<= T_pad) is the true prompt
    length. Returns (cache, logits of token length-1 (vocab,)).

    The JAX function writes the whole slot row, zeros past T_pad; here
    positions from T_pad on keep what they held. Every mask stops at the
    slot's length, so neither is ever read. Only the last real row goes
    through the final norm and head: the returned logits are a tensor of
    their own, which the engine's prefix cache keeps. Under a `mesh` the
    params and cache are this rank's tp shards (see the module doc)."""
    cd = cfg.compute_dtype
    tp = _TP.of(mesh)
    t = tokens.shape[1]
    positions = torch.arange(t, device=tokens.device)
    x = tp.embed(params["embed"].to(cd), tokens.long())       # (1, T, d)
    mask = ((positions[:, None] >= positions[None, :])
            & (positions[None, :] < length))[None]            # (1, T, T)
    for i in range(cfg.n_layers):
        bp = _layer(params, i)
        q, k, v = _qkv(bp, x, cfg, positions)                 # (1,T,H,D)
        cache.k[i, slot, :t] = k[0].to(cache.k.dtype)
        cache.v[i, slot, :t] = v[0].to(cache.v.dtype)
        x = x + tp.leave(_attend(q, k, v, mask, cfg) @ bp["wo"].to(cd))
        x = x + _mlp(bp, x, cfg, tp)
    cache.lengths[slot] = length
    last = _final_logits(params, x[:, length - 1:length], cfg, tp)
    return cache, last[0, 0]


def _wide_decode(params, cache: KVCache, tokens: torch.Tensor,
                 active: torch.Tensor, cfg: TransformerConfig,
                 mesh: DeviceMesh | None = None):
    """Width-K core of `decode_step` and `verify_step`: tokens (S, K) at
    positions lengths[s]..lengths[s]+K-1, their KV written into each
    ACTIVE slot, attending to cache[:len] plus the in-window causal
    prefix. Returns logits (S, K, vocab); callers advance `lengths`.

    The JAX function writes every slot by `dynamic_update_slice`, whose
    start is clamped to T-K, then keeps the new cache only where active.
    The in-place write here takes the same clamped positions and writes an
    inactive slot's old values back, so it stays in bounds whatever stale
    length an idle slot holds. Inactive lanes attend to their old KV, so
    their logits may differ from JAX's; no caller reads them."""
    cd = cfg.compute_dtype
    tp = _TP.of(mesh)
    s_count, k_w = tokens.shape
    t_cache = cache.k.shape[2]
    dev = tokens.device
    start = cache.lengths.long()
    window = torch.arange(k_w, device=dev)
    positions = start[:, None] + window                        # (S, K)
    wpos = torch.clamp(start, max=t_cache - k_w)[:, None] + window
    rows = torch.arange(s_count, device=dev)[:, None].expand(-1, k_w)
    keep = active[:, None, None, None]
    x = tp.embed(params["embed"].to(cd), tokens.long())        # (S, K, d)
    mask = (torch.arange(t_cache, device=dev)[None, None, :]
            <= positions[:, :, None])                          # (S, K, T)
    for i in range(cfg.n_layers):
        bp = _layer(params, i)
        k_cache, v_cache = cache.k[i], cache.v[i]              # (S,T,Hkv,D)
        q, k, v = _qkv(bp, x, cfg, positions)                  # (S,K,H,D)
        k_cache[rows, wpos] = torch.where(keep, k.to(k_cache.dtype),
                                          k_cache[rows, wpos])
        v_cache[rows, wpos] = torch.where(keep, v.to(v_cache.dtype),
                                          v_cache[rows, wpos])
        x = x + tp.leave(_attend(q, k_cache, v_cache, mask, cfg) @ bp["wo"].to(cd))
        x = x + _mlp(bp, x, cfg, tp)
    return _final_logits(params, x, cfg, tp)                   # (S,K,vocab)


def decode_step(params, cache: KVCache, tokens: torch.Tensor,
                active: torch.Tensor, cfg: TransformerConfig,
                mesh: DeviceMesh | None = None):
    """One token for every slot: tokens (S,) int32 (each slot's last
    sampled token), active (S,) bool. Returns (cache, logits (S, vocab)).
    Inactive slots flow through the products (fixed shapes); their cache
    and lengths are left as they were."""
    logits = _wide_decode(params, cache, tokens[:, None], active, cfg, mesh)
    cache.lengths = torch.where(active, cache.lengths + 1, cache.lengths)
    return cache, logits[:, 0]


def verify_step(params, cache: KVCache, cand_tokens: torch.Tensor,
                active: torch.Tensor, temps: torch.Tensor,
                generator: torch.Generator, cfg: TransformerConfig,
                mesh: DeviceMesh | None = None):
    """Speculative verification: K candidate tokens per slot in one call
    (prompt-lookup decoding: the drafts are n-gram matches in the slot's
    own context, no draft model).

    cand_tokens (S, K): column 0 is each slot's last sampled token (whose
    KV is not written yet), columns 1..K-1 the proposals. Returns (cache,
    tok_out (S, K), accepted (S,)): tok_out[s, i] is the model's token at
    position len+i+1, and the engine emits tok_out[s, :a+1] for a =
    accepted[s]. KV is written for all K candidates and lengths advance by
    a+1: the stale tail past the new length is masked, so rejecting a
    draft needs no rollback."""
    start = cache.lengths
    logits = _wide_decode(params, cache, cand_tokens, active, cfg, mesh)
    tok_out, accepted = _accept(logits, cand_tokens, temps, generator)
    cache.lengths = torch.where(active, start + 1 + accepted, start)
    return cache, tok_out, accepted


def decode_and_sample(params, cache: KVCache, tokens, active, temps,
                      generator: torch.Generator, cfg: TransformerConfig,
                      mesh: DeviceMesh | None = None):
    """Decode + per-slot sampling: (cache, next_tokens (S,))."""
    cache, logits = decode_step(params, cache, tokens, active, cfg, mesh)
    return cache, sample_per_slot(logits, generator, temps)


def prefill_and_sample(params, cache: KVCache, tokens, slot: int,
                       length: int, temp: float,
                       generator: torch.Generator, cfg: TransformerConfig,
                       mesh: DeviceMesh | None = None):
    """Returns (cache, first_token, last_logits): the logits come back so
    the engine's prefix cache can re-sample them under another
    temperature on a later hit."""
    cache, last_logits = prefill(params, cache, tokens, slot, length, cfg, mesh)
    temp = torch.tensor(temp, dtype=torch.float32, device=last_logits.device)
    return cache, sample_one(last_logits, temp, generator), last_logits


def extract_prefix(cache: KVCache, slot: int, t: int):
    """Copies of the first `t` positions of one slot's KV, (L, t, Hkv, D)
    each: `t` is the prompt's prefill bucket, so an entry costs t/max_len
    of a slot. The cache is written in place, so a view would change with
    the slot's next request: the snapshot is a copy."""
    return cache.k[:, slot, :t].clone(), cache.v[:, slot, :t].clone()


def insert_prefix(cache: KVCache, k_slice, v_slice, slot: int,
                  length: int) -> KVCache:
    """Write a snapshotted prefix back into `slot` (a prefix-cache hit:
    one device copy instead of the prompt's forward). Only the snapshot's
    positions are written; older KV past `length` is masked, as prefill
    padding is."""
    t = k_slice.shape[1]
    cache.k[:, slot, :t] = k_slice
    cache.v[:, slot, :t] = v_slice
    cache.lengths[slot] = length
    return cache


def decode_burst(params, cache: KVCache, tokens, active, temps,
                 generator: torch.Generator, cfg: TransformerConfig,
                 n_steps: int, mesh: DeviceMesh | None = None):
    """`n_steps` decode+sample steps, all enqueued on the device before the
    caller reads anything back. Returns (cache, token matrix (n_steps, S))."""
    out = []
    for _ in range(n_steps):
        cache, tokens = decode_and_sample(params, cache, tokens, active,
                                          temps, generator, cfg, mesh)
        out.append(tokens)
    return cache, torch.stack(out)


def make_engine_fns(cfg: TransformerConfig, mesh: DeviceMesh | None = None):
    """(prefill_and_sample, decode_burst) bound to `cfg` (and a tp `mesh`):
    the fixed-slot engine's two device calls."""
    return (functools.partial(prefill_and_sample, cfg=cfg, mesh=mesh),
            functools.partial(decode_burst, cfg=cfg, mesh=mesh))


def ngram_propose(context, k_minus_1: int, ngram: int = 2):
    """Host-side draft: match the trailing `ngram` tokens against the
    earlier context; propose the tokens that followed the most recent
    match. Returns a list of <= k_minus_1 proposals (possibly empty)."""
    n = len(context)
    if n < ngram + 1:
        return []
    tail = tuple(context[n - ngram:])
    # scan backwards for the most recent earlier occurrence
    for i in range(n - ngram - 1, -1, -1):
        if tuple(context[i:i + ngram]) == tail:
            j = i + ngram
            return list(context[j:j + k_minus_1])
    return []


def make_spec_fns(cfg: TransformerConfig, mesh: DeviceMesh | None = None):
    """The speculative verifier bound to `cfg` (and a tp `mesh`; K rides in
    the candidate shape)."""
    return functools.partial(verify_step, cfg=cfg, mesh=mesh)


# ---------------------------------------------------------------------------
# paged KV cache (the PagedLLMEngine)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PagedKVCache:
    k: torch.Tensor       # (L, N_blocks, block_size, Hkv, D)
    v: torch.Tensor


def init_paged_cache(cfg: TransformerConfig, num_blocks: int,
                     block_size: int, dtype: torch.dtype | None = None, *,
                     device: torch.device | str = "cuda") -> PagedKVCache:
    device = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def _write_block(block_tables: torch.Tensor, positions: torch.Tensor,
                 bs: int) -> torch.Tensor:
    """Pool block of each position. JAX clamps an out-of-range gather
    index, so a padded chunk past the table's end writes into its last
    entry; the clamp keeps that (and any such index) in bounds here."""
    col = torch.clamp(positions // bs, max=block_tables.shape[-1] - 1)
    if block_tables.dim() == 1:
        return block_tables[col]
    return torch.gather(block_tables, 1, col)


def _paged_window(params, cache: PagedKVCache, tokens: torch.Tensor,
                  block_tables: torch.Tensor, lengths: torch.Tensor,
                  active: torch.Tensor, cfg: TransformerConfig):
    """Width-K core of `paged_decode_step` and `paged_verify_step`: tokens
    (S, K) at positions lengths[s]..lengths[s]+K-1 through the block pool.
    Returns logits (S, K, vocab).

    Scatter-then-gather: each window's new KV is written to
    table[pos // bs] at offset pos % bs FIRST, so the gathered window
    already holds it and the mask is simply kv_pos <= pos. Inactive slots
    write the null block and read garbage that the engine drops."""
    cd = cfg.compute_dtype
    s_count, k_w = tokens.shape
    bs = cache.k.shape[2]
    tables = block_tables.long()
    t_w = tables.shape[1] * bs
    positions = (lengths.long()[:, None]
                 + torch.arange(k_w, device=tokens.device))    # (S, K)
    x = params["embed"].to(cd)[tokens.long()]                  # (S, K, d)
    keep = active[:, None]
    wb = torch.where(keep, _write_block(tables, positions, bs), 0)
    off = torch.where(keep, positions % bs, 0)
    kv_pos = torch.arange(t_w, device=tokens.device)
    mask = kv_pos[None, None, :] <= positions[:, :, None]      # (S, K, T_w)
    for i in range(cfg.n_layers):
        bp = _layer(params, i)
        k_cache, v_cache = cache.k[i], cache.v[i]              # (N,bs,Hkv,D)
        q, k, v = _qkv(bp, x, cfg, positions)                  # (S,K,H,D)
        k_cache[wb, off] = k.to(k_cache.dtype)
        v_cache[wb, off] = v.to(v_cache.dtype)
        kh = k_cache[tables].reshape(s_count, t_w, *k_cache.shape[2:])
        vh = v_cache[tables].reshape(s_count, t_w, *v_cache.shape[2:])
        x = x + _attend(q, kh, vh, mask, cfg) @ bp["wo"].to(cd)
        x = x + _mlp(bp, x, cfg)
    return _final_logits(params, x, cfg)                       # (S,K,vocab)


def paged_decode_step(params, cache: PagedKVCache, tokens: torch.Tensor,
                      block_tables: torch.Tensor, lengths: torch.Tensor,
                      active: torch.Tensor, cfg: TransformerConfig):
    """One token for every slot through the block pool: tokens (S,),
    block_tables (S, B_max), lengths (S,), active (S,) bool. Updates the
    pool in place; returns (cache, logits (S, vocab))."""
    logits = _paged_window(params, cache, tokens[:, None], block_tables,
                           lengths, active, cfg)
    return cache, logits[:, 0]


def paged_decode_and_sample(params, cache: PagedKVCache, tokens,
                            block_tables, lengths, active, temps,
                            generator: torch.Generator,
                            cfg: TransformerConfig):
    cache, logits = paged_decode_step(params, cache, tokens, block_tables,
                                      lengths, active, cfg)
    return cache, sample_per_slot(logits, generator, temps)


def paged_decode_burst(params, cache: PagedKVCache, tokens, block_tables,
                       lengths, active, temps, generator: torch.Generator,
                       cfg: TransformerConfig, n_steps: int):
    """`n_steps` decode+sample steps, all enqueued on the device before
    the caller reads anything back. Block tables are fixed across the
    burst: the engine pre-extends each active slot's table to cover
    lengths + n_steps. Returns (cache, token matrix (n_steps, S))."""
    out = []
    for _ in range(n_steps):
        cache, tokens = paged_decode_and_sample(
            params, cache, tokens, block_tables, lengths, active, temps,
            generator, cfg)
        lengths = torch.where(active, lengths + 1, lengths)
        out.append(tokens)
    return cache, torch.stack(out)


def paged_prefill_chunk(params, cache: PagedKVCache, tokens: torch.Tensor,
                        block_tables: torch.Tensor, start: int,
                        n_valid: int, cfg: TransformerConfig):
    """One chunk of a prompt through the block pool: tokens (C,) (padded
    with zeros past `n_valid`), block_tables (B_max,), `start` = absolute
    position of tokens[0]. Chunk KV scatters into the table's blocks at
    positions start..start+C-1; attention covers the already-prefilled
    context plus the in-chunk causal prefix, both by the single mask
    kv_pos <= start+i after the scatter. Padded positions write garbage
    that the next chunk overwrites and no real query's mask reaches.
    Returns (cache, logits of token n_valid-1 (vocab,)).

    Only that row goes through the final norm and head (the JAX function
    computes all C rows and keeps one): the row is its own tensor, not a
    view that would keep a (C, vocab) block alive in the prefix map.
    """
    cd = cfg.compute_dtype
    c = tokens.shape[0]
    bs = cache.k.shape[2]
    tables = block_tables.long()
    t_w = tables.shape[0] * bs
    positions = start + torch.arange(c, device=tokens.device)   # (C,)
    x = params["embed"].to(cd)[tokens.long()][None]             # (1, C, d)
    wb = _write_block(tables, positions, bs)
    off = positions % bs
    kv_pos = torch.arange(t_w, device=tokens.device)
    mask = (kv_pos[None, :] <= positions[:, None])[None]        # (1, C, T_w)
    for i in range(cfg.n_layers):
        bp = _layer(params, i)
        k_cache, v_cache = cache.k[i], cache.v[i]
        q, k, v = _qkv(bp, x, cfg, positions)                   # (1,C,H,D)
        k_cache[wb, off] = k[0].to(k_cache.dtype)
        v_cache[wb, off] = v[0].to(v_cache.dtype)
        kh = k_cache[tables].reshape(t_w, *k_cache.shape[2:])[None]
        vh = v_cache[tables].reshape(t_w, *v_cache.shape[2:])[None]
        x = x + _attend(q, kh, vh, mask, cfg) @ bp["wo"].to(cd)
        x = x + _mlp(bp, x, cfg)
    last = _final_logits(params, x[:, n_valid - 1:n_valid], cfg)
    return cache, last[0, 0]


def paged_verify_step(params, cache: PagedKVCache,
                      cand_tokens: torch.Tensor, block_tables: torch.Tensor,
                      lengths: torch.Tensor, active: torch.Tensor,
                      temps: torch.Tensor, generator: torch.Generator,
                      cfg: TransformerConfig):
    """Speculative verification through the block pool: the paged
    counterpart of `verify_step`, with the same drafts and the same
    acceptance rule.

    cand_tokens (S, K): column 0 is each slot's last sampled token, columns
    1..K-1 the proposals; block_tables (S, B_max) / lengths (S,) are the
    engine's paged state, and each table must already cover positions up
    to lengths+K. KV for all K candidates scatters into the slot's own
    blocks at lengths..lengths+K-1; the engine advances lengths by
    accepted+1 and every mask treats the stale tail as garbage until the
    next step overwrites it, so a rejected draft needs no rollback. The
    blocks are the slot's alone (copy-on-write at decode start, fresh
    growth blocks), so a stale write never reaches a shared prefix.
    Returns (cache, tok_out (S, K), accepted (S,))."""
    logits = _paged_window(params, cache, cand_tokens, block_tables, lengths,
                           active, cfg)
    tok_out, accepted = _accept(logits, cand_tokens, temps, generator)
    return cache, tok_out, accepted


def make_paged_spec_fns(cfg: TransformerConfig):
    """The paged speculative verifier bound to `cfg`."""
    return functools.partial(paged_verify_step, cfg=cfg)


def copy_block(cache: PagedKVCache, dst: int, src: int) -> PagedKVCache:
    """Copy one pool block across all layers, in place (the device half
    of copy-on-write: a shared partial block is duplicated before its new
    owner appends into it)."""
    cache.k[:, dst] = cache.k[:, src]
    cache.v[:, dst] = cache.v[:, src]
    return cache


def gather_blocks(cache: PagedKVCache, block_ids) -> torch.Tensor:
    """Pool blocks as one KV frame, (2, L, n, block_size, Hkv, D) with k
    stacked over v, in the cache dtype: the unit disaggregated serving
    ships. The round trip through `scatter_blocks` is exact."""
    ids = torch.as_tensor(block_ids, dtype=torch.long, device=cache.k.device)
    return torch.stack([cache.k[:, ids], cache.v[:, ids]])


def scatter_blocks(cache: PagedKVCache, block_ids, frame) -> PagedKVCache:
    """Write a `gather_blocks` frame into pool blocks, in place. The
    frame's layer/head/dim geometry must match the receiving cache."""
    ids = torch.as_tensor(block_ids, dtype=torch.long, device=cache.k.device)
    frame = torch.as_tensor(frame).to(device=cache.k.device,
                                      dtype=cache.k.dtype)
    cache.k[:, ids] = frame[0]
    cache.v[:, ids] = frame[1]
    return cache


def make_paged_engine_fns(cfg: TransformerConfig):
    """(prefill_chunk, decode_burst, copy_block) bound to `cfg`: the
    engine's three device calls."""
    return (functools.partial(paged_prefill_chunk, cfg=cfg),
            functools.partial(paged_decode_burst, cfg=cfg),
            copy_block)


def make_prefix_cache_fns():
    """(extract, insert, sample) for the fixed-slot engine's prefix cache.
    `extract_prefix` copies, so its snapshot outlives later writes to the
    slot."""
    return extract_prefix, insert_prefix, sample_one
