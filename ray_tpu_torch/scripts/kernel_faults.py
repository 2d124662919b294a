"""Plant faults in the flash-attention kernels and show that holding each
kernel against its plain version catches them.

    python3 -m ray_tpu_torch.scripts.kernel_faults

Needs nvcc and one Hopper card. Each fault is one edit of
`csrc/flash_attention.cu`, built (all builds at once) into a temporary
directory and launched in place of the package's own build. Every variant
runs at the bench-350m shape (B 8, T 2048, H 16, D 64, bf16), causal and
not, against the plain versions; the package's own build runs with
SEEDS seeds, each fault with the first. One JSON line per variant gives,
for each output, the largest |kernel - plain|, the largest share of its
tolerance an element takes (`KERNEL_TOLERANCE`), the elements outside that
tolerance, and the elements outside one with an atol ten times larger.
Exits 1 unless the package's kernels pass and each fault is caught as
FAULTS says (None: a reading, held to nothing).
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import math
import os
import tempfile

import torch

from ray_tpu_torch.ops import _cuda, attention
from ray_tpu_torch.scripts import card_line

SHAPE = (8, 2048, 16, 64)  # B, T, H, D of bench-350m
SEEDS = 4
SOURCE = os.path.join(_cuda.CSRC_DIR, "flash_attention.cu")

# (name, text of the source, its replacement, caught: True, or None for a
# reading). Each text occurs once in the source.
FAULTS = [
    ("fwd: running max rescale (alpha) not applied",
     "acc[j][e] *= alpha[e >> 1];", "acc[j][e] *= 1.f;", True),
    ("bf16 products: one k in 16 of B read from its neighbour",
     "b[(k0 + 2 * t + 9) * ldb + n]",
     "b[(k0 + 2 * t + 9 - (t == 3)) * ldb + n]", True),
    ("dq: last live kv tile skipped",
     "n0 += kBlockN) {\n    __syncthreads();\n",
     "n0 += kBlockN) {\n    if (n0 + kBlockN >= kv_end) break;\n"
     "    __syncthreads();\n", True),
    ("dkv: last q tile skipped",
     "q0 < Tq; q0 += kBlockN", "q0 < Tq - kBlockN; q0 += kBlockN", True),
    # P rounded to bf16 before P.V, as the backward kernels round it: a
    # loss of precision against `_fa_kernel`, whose distance from the
    # fp32-P plain forward is a reading.
    ("fwd: P rounded to bf16 (lo product dropped)",
     "if constexpr (kHiLo) mma_bf16(acc[j], af_lo, bfr);", "", None),
]


def edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"{old!r} occurs {src.count(old)} times in {SOURCE}")
    return src.replace(old, new)


def compare(got, want, tol) -> dict:
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    atol, rtol = tol
    limit = atol + rtol * want.abs()
    return {"max_abs": float(diff.max()), "worst_share": float((diff / limit).max()),
            "outside": int((~(diff <= limit)).sum()),
            "outside_atol_x10": int((~(diff <= limit + 9 * atol)).sum())}


def merge(a: dict | None, b: dict) -> dict:
    if a is None:
        return b
    return {k: (a[k] + b[k] if k.startswith("outside") else max(a[k], b[k]))
            for k in a}


def readings(seeds: int) -> dict:
    """Each output of the bound kernels against its plain version."""
    b, t, h, d = SHAPE
    tol, tol_lse = attention.KERNEL_TOLERANCE["bf16"], attention.KERNEL_TOLERANCE["lse"]
    out = {}
    for causal in (True, False):
        rows = {}
        for seed in range(seeds):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device="cuda",
                                       dtype=torch.bfloat16) for _ in range(4))
            kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(d))
            o_ref, lse_ref = attention.fa_fwd_plain(q, k, v, **kw)
            delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
            stats = (q, k, v, do, lse_ref, delta)
            o, lse = attention.fa_fwd(q, k, v, **kw)
            dq = attention.fa_bwd_dq(*stats, **kw)
            dk, dv = attention.fa_bwd_dkv(*stats, **kw)
            dk_ref, dv_ref = attention.fa_bwd_dkv_plain(*stats, **kw)
            got = {"o": compare(o, o_ref, tol), "lse": compare(lse, lse_ref, tol_lse),
                   "dq": compare(dq, attention.fa_bwd_dq_plain(*stats, **kw), tol),
                   "dk": compare(dk, dk_ref, tol), "dv": compare(dv, dv_ref, tol)}
            rows = {name: merge(rows.get(name), r) for name, r in got.items()}
            del q, k, v, do, o_ref, lse_ref, delta, stats, dk_ref, dv_ref
            torch.cuda.empty_cache()
        out["causal" if causal else "full"] = rows
    return out


def caught(result: dict) -> bool:
    return any(r["outside"] > 0 for rows in result.values() for r in rows.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_faults: no CUDA device")
        return 2
    print(card_line())
    src = open(SOURCE).read()
    ok = True
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(len(FAULTS) + 1) as pool:
        builds = [pool.submit(_cuda.library_path, "flash_attention")]
        for i, (_, old, new, _) in enumerate(FAULTS):
            path = os.path.join(tmp, f"fault{i}.cu")
            with open(path, "w") as f:
                f.write(edit(src, old, new))
            builds.append(pool.submit(_cuda.compile_library, path,
                                      os.path.join(tmp, f"libfault{i}.so")))
        for build in builds:
            build.result()
        variants = [("package build", None, SEEDS, False)] + [
            (name, os.path.join(tmp, f"libfault{i}.so"), 1, expect)
            for i, (name, _, _, expect) in enumerate(FAULTS)]
        for name, lib, seeds, expect in variants:
            attention.use_library(None if lib is None else ctypes.CDLL(lib))
            try:
                result = readings(seeds)
            finally:
                attention.use_library(None)
            met = expect is None or caught(result) == expect
            ok &= met
            print(json.dumps({"variant": name, "seeds": seeds, "caught": caught(result),
                              "expected": expect, "met": met, **result}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
