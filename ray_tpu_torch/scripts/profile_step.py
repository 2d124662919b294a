"""Device time of one bench-350m train step, by kernel.

    python3 -m ray_tpu_torch.scripts.profile_step

Runs `make_train_step` for bench-350m at batch 8 x 2048 on one CUDA card,
weights and tokens from seed 0: one step to warm up, then one under
torch.profiler. Prints the card's name and power limit, then one JSON
object: device time by kernel group, the device's busy time and idle
share, the top kernels by device time and the aten ops by self device
time. `chip_smoke.py` reads the group totals, the device time by
launching aten op and dtype, and the busy time of `profile_step` alone.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time

import numpy as np
import torch

from ray_tpu_torch.scripts import card_line

ATTENTION_KERNELS = ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv")


def kernel_group(name: str) -> str:
    for key in ATTENTION_KERNELS:
        if re.search(rf"{key}(_wgmma)?_kernel", name):
            return key
    lowered = name.lower()
    if any(k in lowered for k in ("gemm", "xmma", "cutlass", "sm90_", "nvjet")):
        return "matmul (cuBLAS)"
    if "multi_tensor_apply" in lowered or "adam" in lowered:
        return "optimizer"
    return "elementwise and reductions"


def attention_kernel_name(name: str) -> str:
    """`fa_bwd_dq_wgmma_kernel<64>` from a demangled attention kernel name."""
    m = re.search(r"fa_\w+_kernel<[^>]*>", name)
    return m.group(0) if m else name


def profile_step(step_fn, state, tokens, *, detail: bool = False,
                 record_shapes: bool = False) -> dict:
    """One train step under torch.profiler: `trace_summary` of it, and
    with `detail` also the aten ops by self device time. `record_shapes`
    records the ops' input dtypes, which `ops_ms` then tells apart."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        _, metrics = step_fn(state, {"tokens": tokens})
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = trace_summary(prof, wall_ms)
    if detail:
        ops = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.key.startswith("aten::") and e.self_device_time_total > 0}
        out["top_aten_ops_self_device_ms"] = dict(
            sorted(ops.items(), key=lambda kv: -kv[1])[:15])
    return out


def trace_summary(prof, wall_ms: float) -> dict:
    """From a finished torch.profiler run over `wall_ms` of host time:
    device ms by kernel group, the device's busy ms and idle share, the
    launches of each attention kernel by name, the top 15 kernels, and
    device ms by the aten op that launched each kernel ("aten::bmm float";
    the dtype of its first input, where the run recorded shapes)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise AssertionError("profiler recorded no device kernels")
    # A kernel's "External id" is that of the innermost op that launched it.
    launcher = {}
    for e in events:
        if e.get("cat") == "cpu_op" and "External id" in e.get("args", {}):
            types = e["args"].get("Input type") or [""]
            launcher[e["args"]["External id"]] = f"{e['name']} {types[0]}".strip()
    groups, by_name, attention, ops = {}, {}, {}, {}
    for e in kernels:
        ms = e["dur"] / 1e3
        group = kernel_group(e["name"])
        groups[group] = groups.get(group, 0.0) + ms
        op = launcher.get(e.get("args", {}).get("External id"), "(no op)")
        ops[op] = ops.get(op, 0.0) + ms
        # Summed under the first 80 characters of the name, the key shown.
        by_name[e["name"][:80]] = by_name.get(e["name"][:80], 0.0) + ms
        if group in ATTENTION_KERNELS:
            label = attention_kernel_name(e["name"])
            attention[label] = attention.get(label, 0) + 1
    busy_ms = sum(groups.values())
    # wall_ms includes the profiler's own host cost; kernel times do not.
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "kernels": len(kernels), "attention_launches": attention,
           "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    out["top_kernels_ms"] = dict(top)
    out["ops_ms"] = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device")
        return 2
    from ray_tpu_torch import models

    cfg = models.configs.BENCH_350M
    batch, seq = 8, 2048
    init_fn, step_fn = models.training.make_train_step(
        cfg, device="cuda",
        optimizer=models.training.default_optimizer(3e-4, warmup=10, total_steps=1000))
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)).to("cuda")
    state, metrics = step_fn(state, {"tokens": tokens})
    float(metrics["loss"])
    result = profile_step(step_fn, state, tokens, detail=True)
    print(card_line())
    print(json.dumps({"config": cfg.name, "batch": batch, "seq": seq, **result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
