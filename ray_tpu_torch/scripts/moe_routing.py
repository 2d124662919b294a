"""How far two exact dropless paths part on one prompt, at bf16.

    python3 -m ray_tpu_torch.scripts.moe_routing [--layers 24]

Builds mixtral-8x7b at full width (random weights from seed 0, bf16, the
depth given) and prefills random prompts of 1,000, 1,500 and 1,900 tokens
three ways: through the paged pool in 128-token chunks
(`paged_prefill_chunk`, the engine's step), whole through the contiguous
path's wide step, and through the contiguous path in 128-token windows.
All three compute the same dropless function. For each pair it prints
the largest |difference| of the last position's logits and, per layer,
how many tokens chose another pair of experts. Prints the card's name and
power limit, then one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ray_tpu_torch import models
from ray_tpu_torch.models import decoding
from ray_tpu_torch.ops import moe
from ray_tpu_torch.scripts import card_line

CHUNK = 128


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--config", default="mixtral-8x7b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lengths", default="1000,1500,1900")
    args = ap.parse_args()
    device = models.transformer.resolve_device(args.device)
    cfg = dataclasses.replace(models.configs.get(args.config), n_layers=args.layers,
                              param_dtype=torch.bfloat16, remat=False)
    params = models.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                device=device)
    routes = []
    gates = moe._gates

    def recording_gates(logits, k):   # each MoE call's chosen experts
        probs, vals, idx = gates(logits, k)
        routes.append(idx.reshape(-1, k).sort(dim=-1).values)
        return probs, vals, idx

    moe._gates = recording_gates
    on = torch.ones(1, dtype=torch.bool, device=device)

    def paged(seq):
        bs = 16
        n_blocks = -(-len(seq) // bs)
        cache = decoding.init_paged_cache(cfg, n_blocks + 1, bs, device=device)
        # The padded tail of the last chunk writes the null block 0.
        table = torch.zeros(-(-(len(seq) + CHUNK) // bs), dtype=torch.int32)
        table[:n_blocks] = torch.arange(1, n_blocks + 1)
        table = table.to(device)
        for start in range(0, len(seq), CHUNK):
            nv = min(CHUNK, len(seq) - start)
            toks = torch.zeros(CHUNK, dtype=torch.int32)
            toks[:nv] = torch.tensor(seq[start:start + nv])
            cache, last = decoding.paged_prefill_chunk(
                params, cache, toks.to(device), table, start, nv, cfg)
        return last

    def contiguous(seq, window):
        cache = decoding.init_cache(cfg, 1, len(seq) + window, device=device)
        for start in range(0, len(seq), window):
            part = torch.tensor(seq[start:start + window], device=device)[None]
            logits = decoding._wide_decode(params, cache, part.int(), on, cfg)
            cache.lengths += part.shape[1]
        return logits[0, -1]

    def run(fn, seq):
        """Last logits and, per layer, each real token's expert pair."""
        routes.clear()
        last = fn(seq).float()
        per_layer = [[] for _ in range(cfg.n_layers)]
        for i, r in enumerate(routes):   # calls run layer by layer
            per_layer[i % cfg.n_layers].append(r)
        n = len(seq)
        return last, [torch.cat(rs)[:n] if fn is not paged else
                      torch.cat([r[:min(CHUNK, n - j * CHUNK)] for j, r in enumerate(rs)])
                      for rs in per_layer]

    rng = np.random.default_rng(0)
    out = []
    with torch.no_grad():
        for n in (int(x) for x in args.lengths.split(",")):
            seq = rng.integers(0, cfg.vocab_size, n).tolist()
            paths = {"paged_chunks": run(paged, seq),
                     "whole": run(lambda s: contiguous(s, len(s)), seq),
                     "windows": run(lambda s: contiguous(s, CHUNK), seq)}
            row = {"tokens": n}
            for a, b in (("paged_chunks", "whole"), ("paged_chunks", "windows"),
                         ("windows", "whole")):
                (la, ra), (lb, rb) = paths[a], paths[b]
                row[f"{a}_vs_{b}"] = {
                    "last_logits_max_abs_diff": float((la - lb).abs().max()),
                    "tokens_routed_otherwise_per_layer":
                        [int((x != y).any(-1).sum()) for x, y in zip(ra, rb)]}
            out.append(row)
    moe._gates = gates
    print(card_line() if device.type == "cuda" else "cpu")
    print(json.dumps({"config": cfg.name, "n_layers": cfg.n_layers,
                      "dtype": "bf16", "prompts": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
