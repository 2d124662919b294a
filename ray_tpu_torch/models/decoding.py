"""Paged decoding: the block-pool KV cache, chunked prefill and fused
decode bursts (counterpart of the paged half of
`ray_tpu/models/decoding.py`).

KV lives in a flat pool of fixed-size blocks, (L, N_blocks, block_size,
Hkv, D), and each request holds an int32 block table mapping its sequence
positions to pool blocks. The host-side allocator (`serve/kv_cache.py`)
decides which blocks a request owns; these functions only gather and
scatter through the tables.

Pool block 0 is the NULL block: the allocator never hands it out,
unallocated table entries and inactive slots point at it, so every gather
and scatter is in bounds. Writes routed to block 0 are garbage that no
attention mask reads.

The JAX package donates the cache to each jitted call; here the pool is
updated in place (`index_put_` on the layer's view), which is what the
donation buys. A functional copy of the pool per layer does not fit at
llama3-8b. Attention is a gather plus an fp32 product in plain PyTorch, as
it is plain XLA in the JAX package: there is no kernel on this path.

Not ported yet (ROADMAP queue A, item 1): speculative verification
(`paged_verify_step`), the contiguous-cache engine's functions, and MoE
layers (`n_experts > 0` raises).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.transformer import TransformerConfig, resolve_device
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rotary import apply_rope

_NEG_INF = -1e30


def _qkv(bp, x, cfg: TransformerConfig, positions):
    cd = cfg.compute_dtype
    h = rms_norm(x, bp["attn_norm"], eps=cfg.norm_eps)
    b, t = x.shape[:2]
    q = (h @ bp["wq"].to(cd)).view(b, t, cfg.n_heads, cfg.head_dim)
    k = (h @ bp["wk"].to(cd)).view(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ bp["wv"].to(cd)).view(b, t, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _mlp(bp, x, cfg: TransformerConfig):
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE (n_experts > 0) is not ported yet: ROADMAP queue A, MoE")
    cd = cfg.compute_dtype
    h = rms_norm(x, bp["mlp_norm"], eps=cfg.norm_eps)
    gate = h @ bp["w_gate"].to(cd)
    up = h @ bp["w_up"].to(cd)
    return (F.silu(gate) * up) @ bp["w_down"].to(cd)


def _gqa(kh, vh, cfg: TransformerConfig):
    """Repeat each kv head in place (h0 h0 h1 h1 ...), as `jnp.repeat`."""
    if cfg.n_kv_heads != cfg.n_heads:
        rep = cfg.n_heads // cfg.n_kv_heads
        kh = torch.repeat_interleave(kh, rep, dim=2)
        vh = torch.repeat_interleave(vh, rep, dim=2)
    return kh, vh


def _final_logits(params, x, cfg: TransformerConfig):
    cd = cfg.compute_dtype
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(cd).t()
    return x @ params["lm_head"].to(cd)


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


def sample_one(last_logits: torch.Tensor, temp: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
    """Re-sample a stored last-logits vector (prefix-cache hit path)."""
    return sample_per_slot(last_logits[None], generator, temp.reshape(1))[0]


# ---------------------------------------------------------------------------
# paged KV cache
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


def paged_decode_step(params, cache: PagedKVCache, tokens: torch.Tensor,
                      block_tables: torch.Tensor, lengths: torch.Tensor,
                      active: torch.Tensor, cfg: TransformerConfig):
    """One token for every slot through the block pool: tokens (S,),
    block_tables (S, B_max), lengths (S,), active (S,) bool. Updates the
    pool in place; returns (cache, logits (S, vocab)).

    Scatter-then-gather: each slot's new KV is written to
    table[len // bs] at offset len % bs FIRST, so the gathered window
    already holds it and the mask is simply kv_pos <= len. Inactive slots
    write the null block and read garbage that the engine drops.
    """
    cd = cfg.compute_dtype
    s_count = tokens.shape[0]
    bs = cache.k.shape[2]
    tables = block_tables.long()
    t_w = tables.shape[1] * bs
    pos = lengths.long()
    positions = pos[:, None]                                 # (S, 1)
    x = params["embed"].to(cd)[tokens.long()[:, None]]       # (S, 1, d)
    wb = torch.where(active, _write_block(tables, positions, bs)[:, 0], 0)
    off = torch.where(active, pos % bs, 0)
    kv_pos = torch.arange(t_w, device=pos.device)
    attn_mask = kv_pos[None, None, :] <= positions[:, :, None]  # (S,1,T_w)
    scale = cfg.head_dim ** -0.5
    for i in range(cfg.n_layers):
        bp = _layer(params, i)
        k_cache, v_cache = cache.k[i], cache.v[i]            # (N,bs,Hkv,D)
        q, k, v = _qkv(bp, x, cfg, positions)                # (S,1,H,D)
        k_cache[wb, off] = k[:, 0].to(k_cache.dtype)
        v_cache[wb, off] = v[:, 0].to(v_cache.dtype)
        kh = k_cache[tables].reshape(s_count, t_w, *k_cache.shape[2:])
        vh = v_cache[tables].reshape(s_count, t_w, *v_cache.shape[2:])
        kh, vh = _gqa(kh, vh, cfg)
        s = torch.einsum("sqhd,sthd->sqht", q.float(), kh.float()) * scale
        s = torch.where(attn_mask[:, :, None, :], s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        attn = torch.einsum("sqht,sthd->sqhd", p, vh.float())
        attn = attn.reshape(s_count, 1, cfg.n_heads * cfg.head_dim)
        x = x + attn.to(cd) @ bp["wo"].to(cd)
        x = x + _mlp(bp, x, cfg)
    return cache, _final_logits(params, x, cfg)[:, 0]        # (S, vocab)


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
    attn_mask = kv_pos[None, :] <= positions[:, None]           # (C, T_w)
    scale = cfg.head_dim ** -0.5
    for i in range(cfg.n_layers):
        bp = _layer(params, i)
        k_cache, v_cache = cache.k[i], cache.v[i]
        q, k, v = _qkv(bp, x, cfg, positions)                   # (1,C,H,D)
        k_cache[wb, off] = k[0].to(k_cache.dtype)
        v_cache[wb, off] = v[0].to(v_cache.dtype)
        kh = k_cache[tables].reshape(t_w, *k_cache.shape[2:])[None]
        vh = v_cache[tables].reshape(t_w, *v_cache.shape[2:])[None]
        kh, vh = _gqa(kh, vh, cfg)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh.float()) * scale
        s = torch.where(attn_mask[None, None], s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", p, vh.float())
        attn = attn.reshape(1, c, cfg.n_heads * cfg.head_dim)
        x = x + attn.to(cd) @ bp["wo"].to(cd)
        x = x + _mlp(bp, x, cfg)
    last = _final_logits(params, x[:, n_valid - 1:n_valid], cfg)
    return cache, last[0, 0]


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
