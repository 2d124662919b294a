"""`chip_smoke.py`'s phases 26 and 27 alone, on the card or rehearsed on the CPU.

    python3 -m ray_tpu_torch.scripts.phase26_27_alone [--seed 0]
    python3 -m ray_tpu_torch.scripts.phase26_27_alone --device cpu \\
        --config tiny --batch 2 --seq 32

Run from the repository's root (it imports `chip_smoke`). On the card it
builds the kernels first. It takes `chip_smoke.JOB_STEPS` direct steps of
the config on 19b's batches for the reference losses, starts a one-host
cluster (`chip_smoke.cluster_start`, with the knobs' defaults: no zygote
preload, unlike the script's cluster) and runs 26 (`job_phase`: a job
submitted over the dashboard head, the CLI) on it, shuts it down, then
runs 27 (`autoscaler_phase`: a GPU node the autoscaler launches for a
waiting actor). `--device cpu` asks for the CPU: the kernels' plain
versions, a node that fakes one card, and no card memory to watch.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--config", default="bench-350m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    import ray_tpu_torch as rt
    from ray_tpu_torch import models
    from ray_tpu_torch.ops import _cuda, attention
    from ray_tpu_torch.scripts import card_line

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("phase26_27_alone: no CUDA device (--device cpu rehearses on the CPU)",
              file=sys.stderr)
        return 2
    card = card_line() if cuda else "cpu"
    cs.log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    if cuda:
        t0 = time.perf_counter()
        _cuda.library_path("flash_attention")
        cs.log(f"build {time.perf_counter() - t0:.1f} s")
    cfg = models.configs.get(args.config)
    init_fn, step_fn = cs.bench_train_step(models, cfg, args.device)
    state = init_fn(torch.Generator(device=args.device).manual_seed(args.seed))
    corpus = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (cs.CLUSTER_STEPS, args.batch, args.seq + 1), dtype=np.int32)
    losses = []
    for i in range(cs.JOB_STEPS):
        state, m = step_fn(state, {"tokens": torch.from_numpy(corpus[i]).to(args.device)})
        losses.append(float(m["loss"]))
    cs.log(f"direct losses {losses}")
    del state
    if cuda:
        torch.cuda.empty_cache()
    t_all = time.perf_counter()
    cs.cluster_start(torch, rt, card, cs.CLUSTER_CPUS, args.device)
    try:
        t0 = time.perf_counter()
        cs.job_phase(torch, models, rt, args.seed, card, losses, cfg=cfg, batch=args.batch,
                     seq=args.seq, device=args.device)
        cs.log(f"26 {time.perf_counter() - t0:.1f} s")
    except BaseException:
        cs._dump_node_logs(rt)
        raise
    finally:
        rt.shutdown()
    t0 = time.perf_counter()
    cs.autoscaler_phase(torch, models, attention, args.seed, card, losses, cfg=cfg,
                        batch=args.batch, seq=args.seq, device=args.device)
    cs.log(f"27 {time.perf_counter() - t0:.1f} s")
    cs.log(f"phases 26 and 27 alone passed in {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
