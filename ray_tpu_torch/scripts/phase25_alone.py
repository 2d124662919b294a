"""`chip_smoke.py`'s phase 25 alone on the card, with the split of its time.

    python3 -m ray_tpu_torch.scripts.phase25_alone [--seed 0]

Run from the repository's root (it imports `chip_smoke`). Builds the
kernels, takes TUNE_STEPS direct bench-350m steps on 19b's batches for the
reference losses, starts a one-host cluster (`chip_smoke.cluster_start`,
with the knobs' defaults: no zygote preload, unlike the script's cluster),
then runs 25a (`tune_phase`), 25b (`workflow_phase`), 23d's attention
call in a num_gpus=1 worker without the profiling plugin, and 25c
(`profiled_task`); after the cluster's shutdown, 25c's trace and 25d's
usage snapshot. Each part's lines carry its seconds and, for the trials,
the workflow step and the calls, the process's age at entry and its setup.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    import ray_tpu_torch as rt
    import ray_tpu_torch.data  # noqa: F401 the snapshot's library tags
    import ray_tpu_torch.rllib  # noqa: F401
    import ray_tpu_torch.serve  # noqa: F401
    from ray_tpu_torch import models
    from ray_tpu_torch.core import config as rt_config
    from ray_tpu_torch.ops import _cuda, attention
    from ray_tpu_torch.scripts import card_line

    if not torch.cuda.is_available():
        print("phase25_alone: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    cs.log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _cuda.library_path("flash_attention")
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    cfg = models.configs.BENCH_350M
    init_fn, step_fn = cs.bench_train_step(models, cfg, "cuda")
    state = init_fn(torch.Generator(device="cuda").manual_seed(args.seed))
    corpus = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (cs.CLUSTER_STEPS, 8, 2049), dtype=np.int32)
    losses, ms = [], []
    for i in range(cs.TUNE_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, {"tokens": torch.from_numpy(corpus[i]).cuda()})
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    cs.log(f"direct losses {losses}, step ms {ms}")
    del state
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix="phase25_alone_")
    traces = os.path.join(scratch, "traces")
    os.environ["RAY_TPU_USAGE_STATS_PATH"] = os.path.join(scratch, "usage.json")
    rt_config.reset_config()
    t_all = time.perf_counter()
    cs.cluster_start(torch, rt, card, cs.CLUSTER_CPUS, "cuda")
    try:
        t0 = time.perf_counter()
        cs.tune_phase(torch, models, attention, rt, args.seed, card, losses, ms[-1])
        cs.log(f"25a {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cs.workflow_phase(torch, models, rt, args.seed, card, losses)
        cs.log(f"25b {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        plain = rt.get(rt.remote(num_gpus=1)(cs.attention_task).remote(
            args.seed, 8, 2048, 16, 64, "cuda"), timeout=600)
        cs.log(f"the attention call without the plugin {time.perf_counter() - t0:.1f} s: "
               f"{plain['timing']}")
        t0 = time.perf_counter()
        task = cs.profiled_task(rt, args.seed, card, traces)
        cs.log(f"25c {time.perf_counter() - t0:.1f} s")
    except BaseException:
        cs._dump_node_logs(rt)
        raise
    finally:
        t0 = time.perf_counter()
        rt.shutdown()
        cs.log(f"shutdown {time.perf_counter() - t0:.1f} s")
    cs.profiled_trace(traces, task["pid"], card)
    cs.usage_snapshot(os.environ["RAY_TPU_USAGE_STATS_PATH"], card)
    cs.log(f"phase 25 alone passed in {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
