"""A submitted job's driver: a model's first train steps in a num_gpus=1 task.

    python -m ray_tpu_torch.scripts.bench_job [--config bench-350m] [--seed 0]
        [--steps 3] [--corpus-steps 6] [--batch 8] [--seq 2048] [--device cuda]

It joins the cluster that `RAY_TPU_ADDRESS` names (a job's supervisor sets
it for the entrypoint), and runs the steps in one `num_gpus=1` task: the
state from the seed with AdamW at 3e-4 and 10 warmup steps (bench.py's
step), on the first `--steps` batches of a `--corpus-steps` x batch x
(seq + 1) int32 corpus drawn from the seed. It prints one line,
`BENCH_JOB <json>`: the losses, each step's kernel launches and ms in the
task's process, the task's setup, and whether this driver process
initialised CUDA or the CUDA driver. It must not: the card is
the task's, and a driver that opened a context would pay for one and hold
memory on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

PREFIX = "BENCH_JOB "


def bench_steps(config: str, seed: int, steps: int, corpus_steps: int, batch: int,
                seq: int, device: str) -> dict:
    """The task: `steps` train steps with this process's launch counts."""
    import numpy as np
    import torch

    from ray_tpu_torch import models
    from ray_tpu_torch.ops import attention

    entered = time.perf_counter()
    cfg = models.configs.get(config)
    init_fn, step_fn = models.training.make_train_step(
        cfg, device=device, optimizer=models.training.default_optimizer(
            3e-4, warmup=10, total_steps=1000))
    state = init_fn(torch.Generator(device=device).manual_seed(seed))
    corpus = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (corpus_steps, batch, seq + 1), dtype=np.int32))
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - entered
    losses, step_ms, launches = [], [], []
    for i in range(steps):
        tokens = corpus[i].to(device)
        seen = dict(attention.launches)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
        if cuda:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({n: attention.launches[n] - seen[n] for n in seen})
    out = {"losses": losses, "step_ms": step_ms, "launches_per_step": launches,
           "setup_s": setup_s, "pid": os.getpid(),
           "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "device": torch.cuda.get_device_name() if cuda else "cpu"}
    del state
    if cuda:
        torch.cuda.empty_cache()  # the task's worker stays in the pool
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="bench-350m")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--corpus-steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    started = time.perf_counter()

    import ray_tpu_torch as rt

    rt.init()
    try:
        joined_s = time.perf_counter() - started
        task = rt.remote(num_gpus=1)(bench_steps)
        t0 = time.perf_counter()
        out = rt.get(task.remote(args.config, args.seed, args.steps, args.corpus_steps,
                                 args.batch, args.seq, args.device), timeout=900)
        out["task_s"] = time.perf_counter() - t0
        out["join_s"] = joined_s
        out["address"] = rt.api._global_worker().gcs_address
    finally:
        rt.shutdown()
    torch = sys.modules.get("torch")
    out["driver_cuda_initialized"] = bool(torch is not None and torch.cuda.is_initialized())
    from ray_tpu_torch.core.distributed.worker_zygote import cuda_driver_initialized

    out["driver_cuda_driver_initialized"] = cuda_driver_initialized()
    out["driver_s"] = time.perf_counter() - started
    print(PREFIX + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
