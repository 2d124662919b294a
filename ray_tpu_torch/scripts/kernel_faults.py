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
tolerance, and the elements outside one with an atol ten times larger,
and each kernel's time at the causal shape (CUDA events, the first seed),
so a reading that edits the design shows what the edit costs or saves.
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

# dq's dP products, after the scores' commit.
_DQ_DP = ("      wgmma_commit();\n#pragma unroll\n"
          "      for (int kk = 0; kk < D / 16; ++kk) {\n"
          "        wgmma_ss(dp_acc, desc_k(do_desc, kk, kQBox),\n"
          "                 desc_k(v_desc, kk, kKvBox), kk);\n      }\n")

# (name, text of the source, its replacement, caught: True, or None for a
# reading). Each text occurs once in the source.
FAULTS = [
    ("fwd: running max rescale (alpha) not applied",
     "o_acc[4 * j + e] *= alpha[e >> 1];", "o_acc[4 * j + e] *= 1.f;", True),
    ("wgmma: K-major operands' k16 slice 3 read from slice 2",
     "(kk & 3) * 32", "((kk & 3) == 3 ? 2 : (kk & 3)) * 32", True),
    ("dq: last live kv tile skipped",
     "(kv_end + kDqN - 1) / kDqN", "(kv_end - 1) / kDqN", True),
    ("dq: delta not subtracted from dP",
     "const float d = delta_r[i & 1];", "const float d = 0.f;", True),
    ("dkv: last q tile skipped",
     "(Tq - q_begin + kDkvQ - 1) / kDkvQ", "(Tq - q_begin - 1) / kDkvQ", True),
    # dq's S and dP as one commit group, as the forward commits its scores:
    # P's exp2 then waits for dP's wgmmas instead of running beside them.
    ("dq: S and dP in one commit group (a reading)",
     _DQ_DP + "      wgmma_commit();\n      // S and dP are two commit groups: P's"
     " exp2 runs while dP's wgmmas do.\n      wgmma_wait_one();",
     _DQ_DP[len("      wgmma_commit();\n"):] + "      wgmma_commit();\n"
     "      wgmma_wait_all();", None),
    # kv tiles of 128 rows: ptxas spills and serialises the wgmmas at D 64.
    ("dq: kv tiles of 128 rows (a reading)",
     "constexpr int kDqN = 64;", "constexpr int kDqN = 128;", None),
    # P rounded to bf16 before P.V, as the backward kernels round it: a
    # loss of precision against `_fa_kernel`, whose distance from the
    # fp32-P plain forward is a reading.
    ("fwd: P rounded to bf16 (lo product dropped)",
     "wgmma_rs(o_acc, p_lo[kk], v_desc);", "", None),
    # hi = p truncated to bf16 (bit mask, no conversion) and lo = bf16(p -
    # hi): one conversion per pair of p instead of two, P kept to 2^-16.
    ("fwd: hi truncated, not rounded (a reading of the conversions' cost)",
     "const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);\n"
     "          const float2 hf = __bfloat1622float2(hi);\n"
     "          p_hi[kk][i] = *reinterpret_cast<const uint32_t*>(&hi);\n"
     "          p_lo[kk][i] = bf16x2(p0 - hf.x, p1 - hf.y);",
     "const uint32_t b0 = __float_as_uint(p0) & 0xFFFF0000u;\n"
     "          const uint32_t b1 = __float_as_uint(p1) & 0xFFFF0000u;\n"
     "          p_hi[kk][i] = (b0 >> 16) | b1;\n"
     "          p_lo[kk][i] = bf16x2(p0 - __uint_as_float(b0),\n"
     "                               p1 - __uint_as_float(b1));", None),
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


def time_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def readings(seeds: int) -> dict:
    """Each output of the bound kernels against its plain version, and the
    kernels' times at the causal shape."""
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
            if causal and seed == 0:
                out["ms"] = {
                    "fa_fwd": time_ms(lambda: attention.fa_fwd(q, k, v, **kw)),
                    "fa_bwd_dq": time_ms(lambda: attention.fa_bwd_dq(*stats, **kw)),
                    "fa_bwd_dkv": time_ms(lambda: attention.fa_bwd_dkv(*stats, **kw))}
            del q, k, v, do, o_ref, lse_ref, delta, stats, dk_ref, dv_ref
            torch.cuda.empty_cache()
        out["causal" if causal else "full"] = rows
    return out


def caught(result: dict) -> bool:
    return any(r["outside"] > 0 for key in ("causal", "full")
               for r in result[key].values())


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
