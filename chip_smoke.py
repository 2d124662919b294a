#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ray_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py [--steps 5] [--seed 0]

Run from a checkout of the repository on a machine with a Hopper card
(sm_90a) and the CUDA toolkit. Phases:

1. build: compile `ray_tpu_torch/csrc/*.cu` with nvcc (first use), and
   print ptxas's registers, spills and shared memory for each bf16 wgmma
   kernel, with any report line on a serialised wgmma or an ignored
   setmaxnreg; fails if setmaxnreg would not get its registers;
2. kernels: hold each flash-attention kernel against its plain PyTorch
   version on the card, in bf16 (bench-350m heads, llama3-8b heads, a
   ragged T, odd unequal Tq and Tkv at D 64 and 128) and fp32, causal and
   not, within `KERNEL_TOLERANCE` of ray_tpu_torch/ops/attention.py, and
   two bf16 dq launches on the same inputs bit for bit; time kernel, plain
   version and `scaled_dot_product_attention` as a yardstick;
3. reference: a 2-layer model's loss and gradients at fp32 through the
   kernels on the card against the same model through the plain versions
   on the CPU;
4. main path: the bench-350m train step (full width and depth, remat
   "full", bf16 compute) at batch 8 x 2048 through `make_train_step`,
   for --steps steps; every kernel must launch 2L / L / L times a step.
   The step time is the median of the steps after the first. One further
   step runs under torch.profiler, after the launch counts are read, for
   the device time by kernel group and the idle share; its attention
   launches must all be the wgmma kernels, 2L / L / L of them
   (`ray_tpu_torch/scripts/profile_step.py` gives the full tables).

Any failure exits nonzero and prints no result. The last lines are the
card's name and power limit, the {"kernels": [...]} line, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

KERNELS = {  # wrapper name -> TPU kernel it replaces
    "fa_fwd": "ray_tpu/ops/attention.py:57",
    "fa_bwd_dq": "ray_tpu/ops/attention.py:106",
    "fa_bwd_dkv": "ray_tpu/ops/attention.py:145",
}
SOURCE = "ray_tpu_torch/csrc/flash_attention.cu"
# (label, B, Tq, Tkv, H, D); the first is the main path's shape.
BF16_SHAPES = [("bench-350m", 8, 2048, 2048, 16, 64),
               ("llama3-8b-heads", 2, 2048, 2048, 32, 128),
               ("ragged-T", 2, 1000, 1000, 16, 64),
               ("odd-unequal-d64", 1, 257, 300, 4, 64),
               ("odd-unequal-d128", 1, 257, 300, 4, 128)]
FP32_SHAPES = [("fp32-d64", 1, 300, 300, 4, 64),
               ("fp32-d128", 1, 200, 200, 2, 128)]
# The bf16 wgmma kernels: (kernel, its code for rtt_flash_wgmma_smem).
# Each block is 384 threads at __launch_bounds__ (384, 1), so ptxas must
# start it at 65536 / 384 -> 168 registers: the producer warpgroup's
# setmaxnreg down to 24 then frees the 72 more that each consumer thread
# takes up to 240 (csrc/flash_attention.cu).
WGMMA_KERNELS = {"fa_fwd_wgmma_kernel": 0, "fa_bwd_dkv_wgmma_kernel": 1,
                 "fa_bwd_dq_wgmma_kernel": 2}
WGMMA_ENTRY_REGISTERS = 168


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want, tol) -> tuple[float, float]:
    """(max |got - want|, the largest share of atol + rtol*|want| an element
    takes); raises if any element is outside that bound."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output has non-finite values")
    diff = (got - want).abs()
    atol, rtol = tol
    limit = atol + rtol * want.abs()
    bad = diff > limit
    if bad.any():
        raise AssertionError(
            f"{int(bad.sum())} elements outside atol={atol} rtol={rtol}; "
            f"max |diff| {float(diff.max()):.3g}")
    return float(diff.max()), float((diff / limit).max())


def work(kernel: str, b: int, tq: int, tkv: int, h: int, d: int,
         causal: bool) -> dict:
    """Least time for the bf16 function on an H100: max(FLOPs/peak, bytes/HBM).

    FLOPs count the matrix products over the (q, k) pairs the causal mask
    keeps (k <= q); bytes count each input read once and each output
    written once.
    """
    if causal:
        kept = min(tq, tkv)
        pairs = kept * (kept + 1) // 2 + (tq - kept) * tkv
    else:
        pairs = tq * tkv
    q_like = b * tq * h * d * 2   # q, do, o, dq
    kv_like = b * tkv * h * d * 2  # k, v, dk, dv
    stats = b * h * tq * 4
    products, reads, writes = {
        "fa_fwd": (2, q_like + 2 * kv_like, q_like + stats),  # QK^T, PV
        "fa_bwd_dq": (3, 2 * q_like + 2 * kv_like + 2 * stats, q_like),
        "fa_bwd_dkv": (4, 2 * q_like + 2 * kv_like + 2 * stats, 2 * kv_like),
    }[kernel]
    flops = 2.0 * products * b * h * pairs * d
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (reads + writes) / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_kernels(torch, attention, gen) -> dict:
    """Phase 2: every kernel against its plain version; times at bf16."""
    import torch.nn.functional as F

    tols = attention.KERNEL_TOLERANCE
    rows = {name: {"max_abs_err": 0.0, "tolerance_share": 0.0, "shapes": []}
            for name in KERNELS}
    shapes = [(s, torch.bfloat16) for s in BF16_SHAPES] + \
             [(s, torch.float32) for s in FP32_SHAPES]
    for (label, b, tq, tkv, h, d), dtype in shapes:
        bf16 = dtype == torch.bfloat16
        tol = tols["bf16" if bf16 else "fp32"]
        for causal in (True, False):
            q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device="cuda",
                                       dtype=dtype) for t in (tq, tkv, tkv, tq))
            kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(d))
            o_ref, lse_ref = attention.fa_fwd_plain(q, k, v, **kw)
            delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
            stats = (q, k, v, do, lse_ref, delta)
            o, lse = attention.fa_fwd(q, k, v, **kw)
            dq = attention.fa_bwd_dq(*stats, **kw)
            dk, dv = attention.fa_bwd_dkv(*stats, **kw)
            # dq is summed in a fixed order (no atomics): same bits again.
            if bf16 and not torch.equal(dq, attention.fa_bwd_dq(*stats, **kw)):
                raise AssertionError(f"{label}: two dq launches differ")
            torch.cuda.synchronize()
            dk_ref, dv_ref = attention.fa_bwd_dkv_plain(*stats, **kw)
            # Each kernel's (max |diff|, largest share of its tolerance).
            errs = {n: (max(e for e, _ in pairs), max(s for _, s in pairs))
                    for n, pairs in {
                "fa_fwd": (max_err(o, o_ref, tol),
                           max_err(lse, lse_ref, tols["lse"])),
                "fa_bwd_dq": (max_err(dq, attention.fa_bwd_dq_plain(*stats, **kw), tol),),
                "fa_bwd_dkv": (max_err(dk, dk_ref, tol), max_err(dv, dv_ref, tol)),
            }.items()}
            del o_ref, dk_ref, dv_ref
            entry = {"shape": label, "B": b, "Tq": tq, "Tkv": tkv, "H": h, "D": d,
                     "dtype": "bf16" if bf16 else "fp32", "causal": causal}
            timed = {}
            if bf16:
                runs = {
                    "fa_fwd": (lambda: attention.fa_fwd(q, k, v, **kw),
                               lambda: attention.fa_fwd_plain(q, k, v, **kw)),
                    "fa_bwd_dq": (lambda: attention.fa_bwd_dq(*stats, **kw),
                                  lambda: attention.fa_bwd_dq_plain(*stats, **kw)),
                    "fa_bwd_dkv": (lambda: attention.fa_bwd_dkv(*stats, **kw),
                                   lambda: attention.fa_bwd_dkv_plain(*stats, **kw)),
                }
                # Yardstick only: one PyTorch call for the same function.
                qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                              for x in (q, k, v))
                dot = do.transpose(1, 2).contiguous()
                lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal))
                out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
                lib_bwd = time_ms(lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True))
                lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
                    (qt, kt, vt), dot))
                del out, qt, kt, vt
                for name, (kern, plain) in runs.items():
                    timed[name] = {
                        "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=3),
                        # SDPA's backward computes dq, dk and dv in one call.
                        "library_ms": lib_fwd if name == "fa_fwd" else lib_bwd,
                        "library_fwd_bwd_ms": lib_fwd_bwd,
                        **work(name, b, tq, tkv, h, d, causal)}
            for name in KERNELS:
                err, share = errs[name]
                row = rows[name]
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["tolerance_share"] = max(row["tolerance_share"], share)
                row["shapes"].append({**entry, "max_abs_err": err,
                                      "tolerance_share": share,
                                      **timed.get(name, {})})
            log(f"kernels {label} {entry['dtype']} causal={causal}: " + ", ".join(
                f"{n} err {errs[n][0]:.3g} ({errs[n][1]:.2f} of tol)"
                + (f" {timed[n]['ms']:.3f} ms (plain {timed[n]['plain_ms']:.3f},"
                   f" sdpa {timed[n]['library_ms']:.3f},"
                   f" bound {timed[n]['bound_ms']:.3f})" if n in timed else "")
                for n in KERNELS))
            del q, k, v, do, stats, delta
            torch.cuda.empty_cache()
    return rows


def build_report(_cuda) -> dict:
    """Phase 1's report: ptxas's figures for each bf16 wgmma kernel, with
    the dynamic shared memory its launch asks for. Raises if ptxas ignored
    a setmaxnreg, or started a kernel below the registers its setmaxnreg
    split frees (the consumers' setmaxnreg would then wait forever), or if
    a kernel at the main path's D = 64 spills or serialises its wgmmas."""
    import ctypes

    with open(os.path.join(_cuda.BUILD_DIR, "libflash_attention.log")) as f:
        kernels = _cuda.ptxas_report(f.read())
    smem = _cuda.load("flash_attention").rtt_flash_wgmma_smem
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    report = {}
    for label, row in kernels.items():
        name = label.split("<")[0]
        if name not in WGMMA_KERNELS:
            continue
        d = int(label.split("<")[1].rstrip(">"))
        report[label] = {**row, "dynamic_smem_bytes": smem(WGMMA_KERNELS[name], d)}
        if any("setmaxnreg" in note for note in row["notes"]):
            raise AssertionError(f"{label}: {row['notes']}")
        # The main path's head dim: no spill and no serialised wgmma.
        if d == 64 and (row["spill_store_bytes"] or row["notes"]):
            raise AssertionError(f"{label} spills or serialises: {row}")
        if (row["registers"] or 0) < WGMMA_ENTRY_REGISTERS:
            raise AssertionError(
                f"{label} starts at {row['registers']} registers, below the "
                f"{WGMMA_ENTRY_REGISTERS} its setmaxnreg split needs")
    if len(report) != 2 * len(WGMMA_KERNELS):
        raise AssertionError(f"ptxas report lacks wgmma kernels: {sorted(report)}")
    return report


def check_reference(torch, models) -> None:
    """Phase 3: fp32 loss and grads through the kernels on the card agree
    with the same model through the plain versions on the CPU."""
    import dataclasses
    import numpy as np

    cfg = dataclasses.replace(
        models.configs.TINY, name="ref-2l", vocab_size=1000, d_model=256,
        n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512, remat=True,
        compute_dtype=torch.float32)
    params = models.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 301), dtype=np.int32))
    out = {}
    for device in ("cpu", "cuda"):
        def leaf(w):
            return w.detach().to(device).clone().requires_grad_()

        p = {k: ({n: leaf(w) for n, w in v.items()} if isinstance(v, dict)
                 else leaf(v)) for k, v in params.items()}
        loss = models.loss_fn(p, {"tokens": tokens.to(device)}, cfg)
        loss.backward()
        grads = [g.grad.detach().cpu() for g in models.training.tree_leaves(p)]
        out[device] = (float(loss.detach()), grads)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    # fp32 throughout (TF32 off); sums run in another order on the card.
    if not math.isclose(l_gpu, l_cpu, rel_tol=1e-5):
        raise AssertionError(f"reference loss: card {l_gpu} vs cpu {l_cpu}")
    worst = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(g_gpu, g_cpu))
    if worst > 1e-4:
        raise AssertionError(f"reference grads differ by {worst:.3g} (relative)")
    log(f"reference: loss card {l_gpu:.6f} cpu {l_cpu:.6f}; "
        f"worst grad diff {worst:.3g} of its tensor's max")


def main_path(torch, models, attention, steps: int, seed: int) -> dict:
    """Phase 4: the bench-350m train step, as a user drives it."""
    import numpy as np

    from ray_tpu_torch.scripts.profile_step import profile_step

    cfg = models.configs.BENCH_350M
    batch, seq = 8, 2048
    init_fn, step_fn = models.training.make_train_step(
        cfg, device="cuda",
        optimizer=models.training.default_optimizer(3e-4, warmup=10, total_steps=1000))
    state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    corpus = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (steps, batch, seq + 1), dtype=np.int32)
    host = torch.from_numpy(corpus).pin_memory()
    expected = {"fa_fwd": 2 * cfg.n_layers, "fa_bwd_dq": cfg.n_layers,
                "fa_bwd_dkv": cfg.n_layers}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, host_ms, per_step = [], [], [], []
    attention.reset_launches()
    seen = dict(attention.launches)
    for i in range(steps):
        tokens = host[i].to("cuda", non_blocking=True)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens})
        host_ms.append((time.perf_counter() - t0) * 1e3)  # enqueued, not run
        loss = float(metrics["loss"])
        grad_norm = float(metrics["grad_norm"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {n: attention.launches[n] - seen[n] for n in seen}
        seen = dict(attention.launches)
        per_step.append(counts)
        losses.append(loss)
        log(f"step {i}: loss {loss:.5f} grad_norm {grad_norm:.4f} "
            f"{step_ms[-1]:.1f} ms (host {host_ms[-1]:.1f}) launches {counts}")
        if not (math.isfinite(loss) and math.isfinite(grad_norm)):
            raise AssertionError(f"step {i}: non-finite loss or grad norm")
        if counts != expected:
            raise AssertionError(f"step {i}: launches {counts} != {expected}")
    total = dict(attention.launches)
    # Random init: logits ~ N(0, 1) after the final norm, so the first loss
    # sits near ln(vocab) + 1/2.
    if not abs(losses[0] - (math.log(cfg.vocab_size) + 0.5)) < 1.0:
        raise AssertionError(f"first loss {losses[0]} far from ln(V) + 1/2")
    profile = profile_step(step_fn, state, host[-1].to("cuda"))
    # bf16 runs the wgmma kernels only, each as often as its wrapper counts.
    want = {f"{n}_wgmma_kernel<{cfg.head_dim}>": c for n, c in expected.items()}
    if profile["attention_launches"] != want:
        raise AssertionError(f"profiled step launched {profile['attention_launches']},"
                             f" not {want}")
    median_ms = statistics.median(step_ms[1:] or step_ms)
    tokens_per_s = batch * seq / (median_ms / 1e3)
    fpt = 6.0 * cfg.num_params + 6 * cfg.n_layers * cfg.d_model * seq
    profile["busy_share_of_steady_step"] = profile["device_busy_ms"] / median_ms
    return {"config": cfg.name, "batch": batch, "seq": seq, "steps": steps,
            "losses": losses, "step_ms": step_ms, "steady_step_ms": median_ms,
            # Host time to enqueue each step; near step_ms, the host sets
            # the step and the device waits on it.
            "host_enqueue_ms": host_ms,
            "tokens_per_s": tokens_per_s,
            "mfu_bf16_989": tokens_per_s * fpt / PEAK_BF16_FLOPS,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": total, "launches_per_step": per_step,
            "profiled_step": profile}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's path runs only on the "
              "card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ray_tpu_torch")):
        print(f"chip_smoke: {HERE} holds no ray_tpu_torch package; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ray_tpu_torch import models
    from ray_tpu_torch.ops import _cuda, attention
    from ray_tpu_torch.scripts import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _cuda.library_path("flash_attention")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    log("build report: " + json.dumps(build_report(_cuda)))

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = check_kernels(torch, attention, gen)
    check_reference(torch, models)
    run = main_path(torch, models, attention, args.steps, args.seed)
    log("main path: " + json.dumps(run))

    kernels = []
    for name, replaces in KERNELS.items():
        main_shape = rows[name]["shapes"][0]  # bench-350m, bf16, causal
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": run["launches"][name],
            "max_abs_err": rows[name]["max_abs_err"],
            "tolerance": attention.KERNEL_TOLERANCE,
            "tolerance_share": rows[name]["tolerance_share"],
            **{k: main_shape[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "shapes": rows[name]["shapes"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
