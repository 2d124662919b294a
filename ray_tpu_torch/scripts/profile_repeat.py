"""Whether torch.profiler's trace of a train step holds every kernel.

    python3 -m ray_tpu_torch.scripts.profile_repeat [--runs 25] [--layers 2]

Builds mixtral-8x7b at full width (random weights from seed 0, bf16, the
depth given, batch 2 x 2048, remat "full"), as `chip_smoke.py`'s phase
11a does, takes one step to warm up, then profiles `--runs` steps one at a
time through `profile_step` with shapes recorded. For each profiled step
it compares the attention kernels that the trace holds with the counts of
their wrappers, and counts the launch calls whose kernel record is
missing. Prints the card's name and power limit, then one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ray_tpu_torch import models
from ray_tpu_torch.scripts import card_line
from ray_tpu_torch.scripts.profile_step import profile_step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_repeat: no CUDA device")
        return 2
    cfg = dataclasses.replace(models.configs.MIXTRAL_8X7B, n_layers=args.layers,
                              remat=True, remat_policy="full")
    batch, seq = 2, 2048
    init_fn, step_fn = models.training.make_train_step(
        cfg, device="cuda",
        optimizer=models.training.default_optimizer(3e-4, warmup=10, total_steps=1000))
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)).to("cuda")
    state, metrics = step_fn(state, {"tokens": tokens})
    float(metrics["loss"])
    want = {f"{n}_wgmma_kernel<{cfg.head_dim}>": c for n, c in
            {"fa_fwd": 2 * cfg.n_layers, "fa_bwd_dq": cfg.n_layers,
             "fa_bwd_dkv": cfg.n_layers}.items()}
    runs = []
    for _ in range(args.runs):
        prof = profile_step(step_fn, state, tokens, record_shapes=True)
        runs.append({"attention_in_trace": prof["attention_launches"],
                     "counted": prof["counted_launches"], "kernels": prof["kernels"],
                     "launch_calls": prof["trace_completeness"],
                     "trace_matches": prof["attention_launches"] == want})
    print(card_line())
    print(json.dumps({"config": cfg.name, "layers": cfg.n_layers, "batch": batch,
                      "seq": seq, "want": want, "runs": runs,
                      "traces_short": sum(not r["trace_matches"] for r in runs)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
