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
   version on the card, in bf16 (bench-350m heads, llama3-8b heads,
   bench-1b4 heads, a ragged T, odd unequal Tq and Tkv at D 64 and 128)
   and fp32, causal and not, within `KERNEL_TOLERANCE` of
   ray_tpu_torch/ops/attention.py, and two bf16 dq launches on the same
   inputs bit for bit; time kernel, plain version and
   `scaled_dot_product_attention` as a yardstick;
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
   (`ray_tpu_torch/scripts/profile_step.py` gives the full tables);
5. serving reference: a 2-layer fp32 model with llama3-8b's head layout
   (32 query heads, 8 kv heads of 128) served by the port's
   `PagedLLMEngine` on the card and on the CPU (block 16, chunk 128, one
   prompt longer than a chunk): equal greedy tokens, and the prefill and
   decode logits of the engine's device calls within `SERVE_REF_TOL`;
6. serving main path: llama3-8b (full width and depth, random weights from
   the seed) served by `PagedLLMEngine` with 8 slots, max_len 2048 and the
   knob defaults. Eight requests from threads (prompts of 128 to 1900
   tokens and a pair sharing a 512-token prefix, six greedy, two at
   temperature 0.8) must all finish without error, launch no attention
   kernel, and reuse the shared prefix; greedy tokens must be `forward`'s
   argmax teacher-forced over prompt + output wherever its top-2 gap
   exceeds `SERVE_MARGIN`. Then a decode round (eight short prompts at
   width 8: burst ms, host enqueue ms, tokens/s, the step against its
   least time), a second one under torch.profiler (device busy time, idle
   share) and a prefill round (one 1900-token prompt alone). Every
   serving line carries the card's name and power limit;
7. serving reference for the rest of the engine, on phase 5's model, each
   part on the card and on the CPU: (a) `PagedLLMEngine` with
   speculation_k 4 on prompts that repeat a segment (tokens and accepted
   drafts card == CPU, accepted > 0, and on the card the tokens of the
   same engine without speculation); (b) `LLMEngine` with a prefix cache
   of 4 and speculation_k 0 and 4, one prompt sent twice (a prefix-cache
   hit; tokens card == CPU and k 4 == k 0); (c) migration: a greedy stream
   cut after its first burst, its `export_streams` ticket imported into a
   second engine by `import_prefix`, and the stream resumed there must
   give the uninterrupted tokens;
8. this slice's main path at llama3-8b on phase 6's weights: (a)
   `PagedLLMEngine` (8 slots, max_len 2048, knob defaults) with
   speculation_k 4 and, in turns, without: 8 concurrent greedy requests
   whose prompts repeat a random 64-token segment 2-8 times, 64 new tokens
   each; every request without error, verify calls made, greedy tokens
   against the teacher-forced `forward` as in phase 6; acceptance rate,
   decode tokens/s, verify and burst ms by lane width, a verify call's
   least time at width 8; (b) the fixed-slot
   `LLMEngine` (8 slots, max_len 2048, buckets 64-512): 8 requests of
   64-512 prompt tokens, one prompt sent twice (a prefix-cache hit), the
   same checks, TTFT per prompt, then a decode round at width 8 (tokens/s)
   and peak memory;
9. references for this slice at fp32, card against CPU (loss 1e-5, grads
   1e-4): (a) phase 3's model under remat "dots" and "ff", whose card
   grads must also equal "full"'s within REMAT_GRAD_TOL; (b) the same
   model with 8 experts top-2 under "full" and "dots"; (c) phase 5's
   serving model with 8 experts top-2 through PagedLLMEngine (tokens card
   == CPU, logits within SERVE_REF_TOL);
10. bench-350m's train step (phase 4's batch) under remat "full", "dots"
   and "ff" in turns (full, dots, ff, ff, dots, full) on one state: median
   step ms, peak memory and launches (2L / L / L) a step for each;
11. mixtral-8x7b at full width (8 experts top-2, 32/8 heads of 128, d_ff
   14336, bf16): (a) training, depth cut to MIXTRAL_TRAIN_LAYERS, batch
   2 x 2048, AdamW with warmup, "full" and "dots" in turns: this slice's
   main path, every kernel at D 128 launching 2L / L / L times a step;
   step ms, tokens/s, active-parameter MFU, peak memory, and a profiled
   step's device time by group (fp32 dispatch/combine products, bf16
   expert products, dense products, attention, optimizer, the rest);
   (b) serving, depth cut to MIXTRAL_SERVE_LAYERS, bf16 weights drawn a
   layer at a time: phase 6's engine, traffic and measurements, with
   `forward` replaced as the teacher by a dropless re-prefill of each
   grown sequence through the contiguous path, and a decode step whose
   largest tensor must stay below a layer's expert weight (no copy of the
   stacked weights);
12. the sharded train step at world 1: `build_mesh(MeshConfig(fsdp=-1))`
   starts a one-rank NCCL group (the collectives are checked on it), the
   params are DTensors laid out by DEFAULT_RULES, and batches come through
   `data.torch_feed` (pinned, depth 2) from a seeded numpy corpus:
   (a) bench-350m (phase 4's batch and optimizer), the plain step and the
   mesh step from the same params on the same batches in turns (plain,
   mesh, mesh, plain): step and host enqueue medians, the loss difference
   at each step, the feed's hits and misses, launches 2L / L / L a step;
   (b) this slice's main path: bench-1b4 at full width (bf16, remat
   "full", batch 4 x 2048) through the mesh step with Adafactor(1e-4):
   step median over steps 2..N, tokens/s, MFU, peak memory, launches 2L /
   L / L a step at D 128, one profiled step, Adafactor's update alone; (c) fp32, card against CPU
   (a "cpu" mesh over the same group): phase 3's 2-layer model (widths
   256 and 512) for 3 Adafactor steps under the mesh path, loss within
   1e-5, params within 1e-4 and their updates within 1e-3 of the largest;
13. the pipeline and context-parallel attention at world 1, on a (dp 1,
   pp 1) mesh and an sp mesh of one rank: (a) this slice's main path:
   bench-350m (phase 4's batch, remat "full") through
   `make_pipeline_train_step` with 4 microbatches and `AdamW()`, in turns
   with the plain step from the same params on the same batches (plain,
   pipeline, pipeline, plain): step and host enqueue medians, peak
   memory, the loss difference at each step (each within
   PIPE_LOSS_TOL), launches 2L / L / L a plain step and 4 ticks of that a
   pipeline step; (b) ring and Ulysses attention at bench-1b4's attention
   shape (bf16, causal), forward and backward: Ulysses launches each
   kernel once and equals flash_attention bit for bit, ring launches none
   and is held to mha_reference at fp32 within KERNEL_TOLERANCE["bf16"];
   each timed against flash_attention, host enqueue beside wall time; (c)
   fp32, card against CPU: `make_pipeline_loss` and its grads on phase 3's
   model (pp 1, 2 microbatches; loss 1e-5, grads 1e-4), ring and Ulysses
   at sp 1 within CP_REF_TOL;
14. expert parallelism and tensor-parallel serving at world 1, each part
   on a world-1 group it starts and destroys: (b) right after phase 8, on
   its llama3-8b weights: `LLMEngine(mesh=...)` over a tp mesh of one rank
   in turns with `LLMEngine()` (plain, mesh, mesh, plain) on phase 8b's
   traffic and a decode round at width 8: greedy tokens equal over the
   turns and held to `forward` as in phase 6; TTFT, decode tokens/s, a
   burst's ms beside its host enqueue ms; (c) right after phase 11b, on
   its mixtral-8x7b weights (MIXTRAL_SERVE_LAYERS) once the paged engine
   is gone: the same mesh engine and traffic, held to the dropless
   re-prefill as 11b is; (a) this slice's main path, after phase 13: mixtral-8x7b at phase
   11a's cell through the mesh step on `build_mesh(MeshConfig(fsdp=-1,
   ep=1))`, fed by torch_feed, after the plain step from the same params
   on the same batches (whose state is freed first): every step's loss
   within MOE_MESH_LOSS_TOL of the plain step's, launches 2L / L / L a
   step, step and host enqueue ms, tokens/s, active MFU, peak memory; (d)
   fp32, card against CPU: TINY_MOE (widened to head dim 64) through the
   mesh path at ep 1 (loss 1e-5, grads 1e-4) and the tp-1 LLMEngine
   (tokens equal), and `dryrun_tp_serving` at tp 1;
15. the HF import: (a) TINY at fp32 (head_dim 16, which `flash_attention`
   zero-pads to 64) through the kernels on the card against the plain
   versions on the CPU: logits and loss within 1e-5, grads within 1e-4,
   2L / L / L launches; (b) an HF-layout Llama state dict at llama3-8b's
   widths, imported by `models.hf_convert.from_hf`: (i) 2 layers at fp32
   drawn on the card, `forward`'s logits within HF_REF_TOL of an
   independent HF-layout forward (`hf_llama_logits`), fa_fwd launched
   once a layer; (ii) 32 layers at bf16 held in host memory, as a
   checkpoint read from disk arrives (import seconds, peak memory),
   `LLMEngine` answering 4 requests of 16 greedy tokens, held to
   `forward` as in phase 6 and its first-token logits within
   HF_SERVE_LOGITS_TOL;
16. RLlib on the card at the JAX package's defaults: PPO on CartPole for
   10 iterations (env steps/s, ms a learner update), IMPALA, APPO and DQN
   updates, SAC on Pendulum for 3 iterations, CQLLearner updates, and one
   PPO update at fp32 card against CPU within RL_CARD_CPU_TOL;
17. DreamerV3 and the offline learners on the card, at `DreamerV3Config`'s
   defaults (8 envs x 64 steps, deter 256, 16x16 latents, 256 units, 41
   bins, batches 16 x 16, horizon 15, 8 updates an iteration after 256 env
   steps): (a) CartPole for 8 iterations and (b) Pendulum (dynamics
   backprop) for 3: env steps/s, ms an update and ms a policy step
   (medians), every metric finite; (c) one update at fp32 card against CPU
   from the same state, batch and noise: every tree, Adam moment,
   return_scale and metric within RL_CARD_CPU_TOL (on a draw whose every
   sample is decided by more than DREAMER_TIE_GAP); (d) PPO's CartPole
   rollouts recorded as JSON shards by `record_rollouts`, read back here,
   and BCLearner and MARWILLearner updates timed on them;
18. the task/actor core (`ray_tpu_torch.init(local_mode=True)`): (a) this
   slice's main path: phase 4's bench-350m train step (its config, batches
   and optimizer, from the same seed) inside a `@remote(num_gpus=1)` actor,
   in turns with the direct step on a state of its own (direct, actor;
   actor, direct; ...): every step's loss bit-equal, 2L / L / L launches a
   step through the actor, median step and host ms of each and the ms the
   runtime adds a step; (b) the actor's 468 M fp32 params fetched from it,
   then `put` and `get` (ms and GiB/s of each), bit-equal on cuda:0; (c)
   `detect_node_resources()` and its time-boxed GPU probe: GPU 1.0 and an
   `accelerator_type:` key naming the card, the probe's seconds; (d) PPO on
   CartPole at the JAX defaults with 2 remote env runners and 2 remote
   learner actors, in turns with phase 16's local PPO, 5 iterations each
   (env steps/s, ms an iteration), then the remote learners' update of one
   sampled batch under the same per-actor permutations and its broadcast,
   card against CPU, within RL_CARD_CPU_TOL (weights, metrics, Adam
   moments), and the remote evaluation runner's greedy returns equal;
19. the multi-process runtime on one host (`ray_tpu_torch.init()`): (a)
   the cluster's start (GCS, node daemon with its time-boxed GPU probe,
   the worker zygote) in seconds, and `cluster_resources()` with GPU 1.0
   and an `accelerator_type:` key naming the card; (b) this slice's main
   path: phase 4's bench-350m train step inside a `@remote(num_gpus=1)`
   actor in a worker process, in turns with the direct step here for
   CLUSTER_STEPS steps: every loss bit-equal, 2L / L / L launches a step
   counted by the worker itself, median step and host ms of each, the ms
   the runtime adds, whether the zygote forked the worker (with torch
   loaded) or it was cold-spawned, and the seconds until the actor was
   ready; (c) the actor's params `put` in the worker and `get`
   here, then the reverse (GiB/s each way), bit-equal on cuda:0 at both
   ends; (d) the round trip of a no-op task and of an actor call, median
   and p99 microseconds over 1,000 of each, beside the in-process
   engine's; (e) phase 18d's PPO with its runners and learners in worker
   processes, in turns with local PPO, and the remote learners' update
   card against CPU within RL_CARD_CPU_TOL;
20. the serve control plane on that runtime (`serve_plane_phase`): (a)
   `serve.run(serve.deployment(LLMDeployment).options(ray_actor_options=
   {"num_gpus": 1}).bind("llama3-8b", num_slots=8, max_len=2048,
   seed=--seed), _http=True, route_prefix="/llm")` at full width and
   depth with the knob defaults, and the seconds until `serve.status()`
   shows it ready; (b) phase 6's eight requests at once, four streamed
   over HTTP as JSONL and four through the handle: all finish, the
   replica's own counters show no attention launch, every stream rides
   the rails (shared-memory rings; the replica's lane counts them); client
   TTFT and decode tokens/s a request beside phase 6's in-process ones;
   (c) the KV pool's arena (bytes, whether in the store), and the store's
   used bytes and objects back at their baseline once the deployment goes
   and after `serve.shutdown()`; (d) a `disagg=True` deployment: one fresh
   1900-token greedy prompt must be prefilled by the prefill actor
   (`disagg_prefills` 1) and give the unified deployment's tokens for it
   served alone; the card's peak memory over every process; (e) the
   median round trip of a 1-token request over the handle and over HTTP
   beside phase 6's `engine.generate`. After the cluster is down, the
   greedy tokens (and the alone prompt's) are held to `forward`
   teacher-forced as in phase 6, on weights remade from the seed whose
   `params_digest` must equal the replica's `weights_digest()`;
21. the train plane on that runtime (`train_plane_phase`), with
   RAY_TPU_TRAIN_OBS_PEAK_FLOPS at PEAK_BF16_FLOPS: (a)
   `train.TorchTrainer(train_plane_loop, scaling_config=ScalingConfig(
   num_workers=1, use_gpu=True, flops_per_step=...))` runs phase 4's cell
   (bench-350m, 8 x 2048, AdamW with warmup, seed --seed) for
   TRAIN_PLANE_STEPS steps in its worker, every loss bit-equal to 19b's
   direct step's on the same batches and 2L / L / L launches a step
   counted in the worker; after step TRAIN_PLANE_CKPT_STEP the loop saves
   the whole train state (params, both AdamW moments, the step count)
   with `train.save_pytree` (seconds and GiB/s, the session's copy, the
   free bytes first), and `Result.checkpoint` is checkpoint_000001; (b)
   the same fit with `FailureConfig(elastic=True)`: right after that
   checkpoint the driver SIGKILLs rank 0 (`util.chaos.kill_rank`; attempt
   0 waits for it, with a deadline), the supervisor replaces the rank in
   place on its kept bundle, the new gang loads the checkpoint in place
   (`load_pytree(target=...)`, seconds and GiB/s) and steps on with the
   direct step's losses; restarts by death >= 1, no shrink, checkpoint
   directories monotonic, the restart gap from the kill to the new
   gang's first step, and the store's (used bytes, objects) back at
   their baseline; (c) `util.state.train_runs()` shows the clean run
   (steps, no restart, a goodput split, achieved FLOP/s and an MFU beside
   phase 4's) and the killed one (one restart, lost_restart_s > 0),
   `util.timeline.fetch_spans` the clean run's train.step spans, and
   `util.state.doctor()` no train finding on the clean run.
22. the data layer on that runtime (`data_plane_phase`, run by phase 21
   before its cluster shuts down): it first prints whether pyarrow and
   pandas import here (nothing in the phase needs them); (a) phase 4's
   cell trained by `train.TorchTrainer` from
   `datasets={"train": StreamingIngest(ds)}`, ds phase 21's corpus as
   `from_numpy` in 8 blocks and one `map_batches`, read in the worker
   with `iter_device_batches`: losses bit-equal to the direct step's,
   2L / L / L launches a step counted there, every row once, the
   worker's step and host ms against the direct step's, the feed's hits
   and misses, `ds.stats()`; (b) 131,072 rows of 2,049 int32 tokens
   (1.0 GiB) in 64 blocks made by the read stage from the seed, through
   `map_batches`, `random_shuffle(seed=0)` and `iter_device_batches(8)`
   onto the card: every row once and the token sum intact, none of its
   objects left in the store after it is dropped; seconds, GiB/s,
   rows/s, the shuffle's bytes and seconds from the data gauges, each
   operator's stall and spill, the feed's hits and misses, the store's
   peak; (c) PPO's CartPole rollouts and a SAC Pendulum replay recorded
   as JSON shards, read back by `read_samples` (rows read = rows
   written), BC and MARWIL trained 3 iterations and CQL 2 on the card
   (ms an iteration, finite metrics). A "phase seconds" line then gives
   each phase group's wall clock.

Any failure exits nonzero and prints no result. The last lines are the
card's name and power limit, the {"kernels": [...]} line (launches of
phase 4's steps, of phase 11a's as `launches_mixtral_8x7b_train`, of
phase 12b's as `launches_bench_1b4_mesh_train`, of phase 13a's pipeline
steps as `launches_bench_350m_pipeline_train`, of 13b's Ulysses call
as `launches_ulysses`, of 14a's mesh steps as
`launches_mixtral_8x7b_mesh_train`, of 15b(i)'s forward as
`launches_hf_llama3_8b_forward`, of 15a's TINY as
`launches_tiny_padded`, of 18a's actor steps as
`launches_bench_350m_actor_train`, of 19b's worker-process actor steps
as `launches_bench_350m_cluster_actor_train`, of phase 20's replica as
`launches_llama3_8b_serve_replica`, of 21a's trainer steps as
`launches_bench_350m_trainer` and of 22a's steps fed by the data layer
as `launches_bench_350m_data_ingest`), and {"ok": true,
"device": {...}}.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import shutil
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
               ("bench-1b4", 4, 2048, 2048, 16, 128),
               ("ragged-T", 2, 1000, 1000, 16, 64),
               ("odd-unequal-d64", 1, 257, 300, 4, 64),
               ("odd-unequal-d128", 1, 257, 300, 4, 128)]
FP32_SHAPES = [("fp32-d64", 1, 300, 300, 4, 64),
               ("fp32-d128", 1, 200, 200, 2, 128),
               # Phase 15a's TINY: head dim 16, zero-padded to 64.
               ("tiny-padded", 2, 96, 96, 4, 64)]
# The bf16 wgmma kernels: (kernel, its code for rtt_flash_wgmma_smem).
# Each block is 384 threads at __launch_bounds__ (384, 1), so ptxas must
# start it at 65536 / 384 -> 168 registers: the producer warpgroup's
# setmaxnreg down to 24 then frees the 72 more that each consumer thread
# takes up to 240 (csrc/flash_attention.cu).
WGMMA_KERNELS = {"fa_fwd_wgmma_kernel": 0, "fa_bwd_dkv_wgmma_kernel": 1,
                 "fa_bwd_dq_wgmma_kernel": 2}
WGMMA_ENTRY_REGISTERS = 168
# Phase 5: fp32 logits card vs CPU (atol, rtol); the sums run in another
# order on the card, and TF32 is off.
SERVE_REF_TOL = (1e-4, 1e-4)
# Phase 6: a greedy token may differ from the teacher-forced forward's
# argmax only where forward's top-2 logit gap is at most this. Both run in
# bf16, by different attention arithmetic (fp32 softmax over bf16 KV
# against the flash kernel), and round each layer's output to bf16.
SERVE_MARGIN = 0.125
# Phase 6: the engine's first-token logits (stored for prefix hits), and
# the logits of the first decode steps of one greedy request, against
# forward's at the same positions, max |diff|. The logits have unit
# spread; bf16 noise put the first-token ones 0.086 apart at most over 6
# prompts x 128256 logits, so a fault of the prefill or the decode step (a
# wrong position, block or head) shows as a difference of order one.
SERVE_LOGITS_TOL = 0.25
# Phase 6: the first decode steps whose logits are held to SERVE_LOGITS_TOL.
SERVE_DECODE_STEPS_CHECKED = 4
# Phase 11b at bf16: the share of the checked positions whose greedy token
# may differ from the dropless re-prefill's argmax where its top-2 gap
# exceeds SERVE_MARGIN. Routing is discrete: the engine and the teacher
# compute the same function, but in other chunks (the engine's token budget
# splits a prompt where the tick ends), so their bf16 sums part in the last
# bit, and where a token's 2nd and 3rd experts lie within a bf16 step of
# each other a layer routes it to another expert. On an H100, a 1,900-token
# prompt prefilled whole and in 128-token chunks routed up to 146 tokens a
# layer otherwise (`python3 -m ray_tpu_torch.scripts.moe_routing`), and the
# engine parted from the re-prefill on 11 of 384 checked positions (2.9%),
# at gaps up to 0.52. A fault of the paged path (a wrong position, block,
# head or expert) moves nearly every later position; the fp32 twin below
# holds the same traffic exactly.
MOE_BF16_BEYOND_SHARE = 0.10
# Phase 11b's fp32 twin: mixtral-8x7b at full width and fp32 compute, depth
# MIXTRAL_FP32_TWIN_LAYERS, on the same traffic: greedy tokens equal the
# re-prefill's argmax wherever its gap exceeds SERVE_FP32_MARGIN, and every
# first-token logit within SERVE_FP32_LOGITS_TOL of it (fp32 sums in
# another order part by ~1e-5; a routing flip needs a near-tie within that).
MIXTRAL_FP32_TWIN_LAYERS = 4
SERVE_FP32_MARGIN = 1e-3
SERVE_FP32_LOGITS_TOL = 1e-3
# Phase 9: the card's fp32 grads under "dots" or "ff" against "full", the
# largest |diff| relative to each tensor's max. The policies save or
# recompute the same values; only the order of a few sums may move.
REMAT_GRAD_TOL = 1e-6
# Phase 11: mixtral-8x7b depth on one card. Training keeps fp32 masters,
# grads and two AdamW moments, 16 bytes a parameter, 1.451 B a layer: 2
# layers are 50.6 GB. Serving holds bf16 weights, 2.925 GB a layer; 8
# layers (23.4 GB) keep the whole script inside its time budget (24, 70.2
# GB, fit the card too, at ~60 s more).
MIXTRAL_TRAIN_LAYERS = 2
MIXTRAL_SERVE_LAYERS = 8


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


def reference_model(torch, models, **overrides):
    """Phases 3 and 9: 2 layers at fp32 (vocab 1000, d_model 256, 4 heads
    over 2 kv heads, d_ff 512, remat "full"), with `overrides`; weights
    from seed 1 on the CPU and a (2, 301) token batch from seed 1."""
    import dataclasses
    import numpy as np

    cfg = dataclasses.replace(
        models.configs.TINY, name="ref-2l", vocab_size=1000, d_model=256,
        n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512, remat=True,
        compute_dtype=torch.float32, **overrides)
    params = models.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 301), dtype=np.int32))
    return cfg, params, tokens


def reference_grads(torch, models, cfg, params, tokens, device: str):
    """(loss, grads on the CPU in tree_leaves order) of one loss_fn on `device`."""
    def leaf(w):
        return w.detach().to(device).clone().requires_grad_()

    p = {k: ({n: leaf(w) for n, w in v.items()} if isinstance(v, dict)
             else leaf(v)) for k, v in params.items()}
    loss = models.loss_fn(p, {"tokens": tokens.to(device)}, cfg)
    loss.backward()
    return float(loss.detach()), [g.grad.detach().cpu()
                                  for g in models.training.tree_leaves(p)]


def worst_grad_diff(got, want) -> float:
    """The largest |got - want| of any tensor, relative to want's max."""
    return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in zip(got, want))


def check_reference(torch, models, label: str = "reference", **overrides) -> dict:
    """Phases 3 and 9: fp32 loss and grads through the kernels on the card
    agree with the same model through the plain versions on the CPU (loss
    1e-5, grads 1e-4 of each tensor's max). Returns the numbers and the
    card's grads."""
    cfg, params, tokens = reference_model(torch, models, **overrides)
    l_cpu, g_cpu = reference_grads(torch, models, cfg, params, tokens, "cpu")
    l_gpu, g_gpu = reference_grads(torch, models, cfg, params, tokens, "cuda")
    # fp32 throughout (TF32 off); sums run in another order on the card.
    if not math.isclose(l_gpu, l_cpu, rel_tol=1e-5):
        raise AssertionError(f"{label} loss: card {l_gpu} vs cpu {l_cpu}")
    worst = worst_grad_diff(g_gpu, g_cpu)
    if worst > 1e-4:
        raise AssertionError(f"{label} grads differ by {worst:.3g} (relative)")
    log(f"{label}: loss card {l_gpu:.6f} cpu {l_cpu:.6f}; "
        f"worst grad diff {worst:.3g} of its tensor's max")
    return {"loss_card": l_gpu, "loss_cpu": l_cpu, "worst_grad_diff": worst,
            "card_grads": g_gpu}


def bench_train_step(models, cfg, device: str):
    """Phase 4's train step for `cfg`: AdamW at 3e-4 with 10 warmup steps
    (bench.py's), remat "full"."""
    return models.training.make_train_step(
        cfg, device=device,
        optimizer=models.training.default_optimizer(3e-4, warmup=10, total_steps=1000))


def main_path(torch, models, attention, steps: int, seed: int) -> dict:
    """Phase 4: the bench-350m train step, as a user drives it."""
    import numpy as np

    from ray_tpu_torch.scripts.profile_step import profile_step

    cfg = models.configs.BENCH_350M
    batch, seq = 8, 2048
    init_fn, step_fn = bench_train_step(models, cfg, "cuda")
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


def _tree_to(params: dict, device: str) -> dict:
    return {k: (_tree_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def serve_ref_model(torch, models, **overrides):
    """Phases 5, 7 and 9c: 2 layers at fp32 with llama3-8b's width and heads
    (32 query heads over 8 kv heads of 128), d_ff 1024 and a vocab of 1000,
    with `overrides`; weights from seed 2, on the CPU."""
    import dataclasses

    cfg = dataclasses.replace(
        models.configs.LLAMA3_8B, name="serve-ref-2l", n_layers=2, d_ff=1024,
        vocab_size=1000, max_seq_len=512, remat=False,
        compute_dtype=torch.float32, **overrides)
    return cfg, models.init_params(cfg, torch.Generator().manual_seed(2),
                                   device="cpu")


def check_serving_reference(torch, models, card: str, label: str = "serving reference",
                            **overrides) -> dict:
    """Phases 5 and 9c: a 2-layer fp32 model with llama3-8b's head layout
    (and `overrides`) served by the port's PagedLLMEngine on the card and
    on the CPU: the same greedy tokens, and the prefill and decode logits of
    the functions the engine calls within SERVE_REF_TOL."""
    import numpy as np

    from ray_tpu_torch.models import decoding
    from ray_tpu_torch.serve import PagedLLMEngine

    cfg, params = serve_ref_model(torch, models, **overrides)
    rng = np.random.default_rng(2)
    # 200 tokens: a chunk of 128, then a ragged one of 72.
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (200, 37, 128)]
    tokens, chunks = {}, {}
    for device in ("cpu", "cuda"):
        eng = PagedLLMEngine(cfg, params, num_slots=4, max_len=512, block_size=16,
                             prefill_chunk=128, device=device)
        try:
            tokens[device] = [eng.generate(p, max_tokens=24, timeout=600)
                              for p in prompts]
            chunks[device] = eng.stats["prefill_chunks"]
        finally:
            eng.shutdown()
    if tokens["cuda"] != tokens["cpu"]:
        raise AssertionError(f"{label}: card tokens {tokens['cuda']} "
                             f"!= cpu {tokens['cpu']}")
    if chunks["cuda"] != chunks["cpu"] or chunks["cuda"] < 4:
        raise AssertionError(f"{label}: prefill chunks {chunks}")
    # The engine's device calls, step by step: prefill the 200-token prompt
    # in its two chunks, then decode its first four generated tokens.
    logits = {}
    for device in ("cpu", "cuda"):
        p = _tree_to(params, device)
        cache = decoding.init_paged_cache(cfg, 40, 16, device=device)
        table = torch.arange(1, 33, dtype=torch.int32, device=device)
        rows = []
        with torch.no_grad():
            for start in (0, 128):
                nv = min(128, 200 - start)
                toks = torch.zeros(128, dtype=torch.int32)
                toks[:nv] = torch.tensor(prompts[0][start:start + nv])
                cache, last = decoding.paged_prefill_chunk(
                    p, cache, toks.to(device), table, start, nv, cfg)
                rows.append(last)
            for i, tok in enumerate(tokens["cpu"][0][:4]):
                cache, step = decoding.paged_decode_step(
                    p, cache, torch.tensor([tok], dtype=torch.int32, device=device),
                    table[None], torch.tensor([200 + i], dtype=torch.int32, device=device),
                    torch.tensor([True], device=device), cfg)
                rows.append(step[0])
        logits[device] = torch.stack(rows).cpu()
    err, share = max_err(logits["cuda"], logits["cpu"], SERVE_REF_TOL)
    log(f"{label} [{card}]: tokens card == cpu over {len(prompts)} "
        f"prompts (200, 37, 128 tokens; {chunks['cuda']} prefill chunks); "
        f"prefill + decode logits max |diff| {err:.3g} ({share:.3f} of tolerance)")
    return {"prompts": [len(x) for x in prompts], "prefill_chunks": chunks["cuda"],
            "logits_max_abs_err": err, "tolerance": SERVE_REF_TOL,
            "tolerance_share": share}


def forward_teacher(torch, models, params, seq, cfg):
    """`forward`'s logits (T, vocab) over one sequence, teacher-forced."""
    import dataclasses

    return models.forward(params, seq[None], dataclasses.replace(cfg, remat=False))[0]


def reprefill_teacher(torch, models, params, seq, cfg):
    """The logits (T, vocab) of every position of one sequence, prefilled
    whole into an empty one-slot contiguous cache by the contiguous
    path's width-T step: the dropless function the engine serves, by code
    apart from the paged engine's (`forward` routes with a capacity and
    drops tokens, so it computes another function for MoE)."""
    from ray_tpu_torch.models import decoding

    cache = decoding.init_cache(cfg, 1, seq.shape[0], device="cuda")
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    return decoding._wide_decode(params, cache, seq[None].int(), active, cfg)[0]


def forward_agreement(torch, models, params, cfg, prompts, outs, card: str,
                      on_logits=None, teacher=forward_teacher, margin=SERVE_MARGIN,
                      max_beyond_share=0.0, device: str = "cuda") -> dict:
    """Greedy outputs against `teacher` (default `forward`) teacher-forced at
    the compute dtype over prompt + output: at each generated position the
    output must be the teacher's argmax wherever its top-2 gap exceeds
    `margin`, but for at most `max_beyond_share` of the positions.
    `on_logits(i, prompt, logits)` sees each request's logits. Logs and
    returns the counts; raises past that share."""
    checks = []
    with torch.no_grad():
        for i, (p, out) in enumerate(zip(prompts, outs)):
            seq = torch.tensor(p + out[:-1], dtype=torch.long, device=device)
            logits = teacher(torch, models, params, seq, cfg)
            top = logits[len(p) - 1:].float().topk(2, dim=-1)
            gap = (top.values[:, 0] - top.values[:, 1]).cpu()
            checks.append((len(p), gap, top.indices[:, 0].cpu() == torch.tensor(out)))
            if on_logits is not None:
                on_logits(i, p, logits)
            del logits
    positions = sum(len(g) for _, g, _ in checks)
    excused = sum(int((g <= margin).sum()) for _, g, _ in checks)
    bad = [(n, int(j), float(g[j])) for n, g, a in checks
           for j in torch.nonzero(~a & (g > margin)).flatten()]
    mismatches = sum(int((~a).sum()) for *_, a in checks)
    # How close the mismatches the margin excuses come to it.
    sound_gap = max((float(g[j]) for _, g, a in checks
                     for j in torch.nonzero(~a & (g <= margin)).flatten()),
                    default=0.0)
    log(f"serve [{card}]: greedy vs teacher-forced {teacher.__name__}: {positions} "
        f"positions, {mismatches} argmax mismatches, margin {margin} "
        f"excused {excused} ({excused / positions:.3f}), largest gap of an "
        f"excused mismatch {sound_gap:.4f}; mismatches beyond it {bad} "
        f"({len(bad) / positions:.3f} of the positions; at most {max_beyond_share})")
    if len(bad) > max_beyond_share * positions:
        raise AssertionError(f"serve: tokens disagree with {teacher.__name__} beyond "
                             f"the margin at (prompt length, index, gap) {bad}")
    return {"teacher": teacher.__name__, "positions": positions, "mismatches": mismatches,
            "margin": margin, "excused": excused, "largest_excused_gap": sound_gap,
            "beyond_margin": bad, "max_beyond_share": max_beyond_share}


def decode_burst_profile(torch, models, engine, cfg, card: str,
                         live: int = 48, bursts: int = 5) -> dict:
    """Decode bursts alone, outside the engine's loop (which must be idle):
    the engine's burst function at width 8, every lane at `live` KV
    tokens, timed on the host clock and then profiled (device busy ms and
    kernels per burst, nothing else in the window). Then the same burst
    on a model of the same depth and heads at narrow widths, whose kernels
    are too short to hold the host back: its enqueue time is the host's
    cost of a burst's launches, if its device busy time stays below it.
    The lanes' tables point at the null block, so the bursts write only
    garbage no request reads; the gather and the products do the same
    work whatever the table holds."""
    import dataclasses
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import decoding
    from ray_tpu_torch.scripts.profile_step import trace_summary
    from ray_tpu_torch.serve.llm import _to_compute

    width, n_steps, b_max = engine.num_slots, engine.max_burst, engine._b_max
    args = [torch.from_numpy(a).to("cuda") for a in (
        np.arange(width, dtype=np.int32), np.zeros((width, b_max), np.int32),
        np.full((width,), live, np.int32), np.ones((width,), bool),
        np.zeros((width,), np.float32))]

    def measure(params, cache, fn):
        def one():
            t0 = time.perf_counter()
            _, toks = fn(params, cache, *args, engine._gen, n_steps=n_steps)
            t_enq = time.perf_counter()
            toks.cpu()
            return (t_enq - t0) * 1e3, (time.perf_counter() - t0) * 1e3

        one()
        timed = [one() for _ in range(bursts)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(bursts):
                one()
            wall_ms = (time.perf_counter() - t0) * 1e3
        trace = trace_summary(prof, wall_ms)
        return {"enqueue_ms": statistics.median(t[0] for t in timed),
                "burst_ms": statistics.median(t[1] for t in timed),
                "device_busy_ms": trace["device_busy_ms"] / bursts,
                "kernels_per_step": trace["kernels"] / bursts / n_steps,
                "groups_ms": {k: v / bursts for k, v in trace["groups_ms"].items()}}

    with torch.no_grad():
        full = measure(engine.params, engine.cache, engine._decode)
        narrow_cfg = dataclasses.replace(cfg, d_model=512, d_ff=1024, vocab_size=1024)
        narrow_params = models.init_params(
            narrow_cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        narrow_params = _to_compute(narrow_params, narrow_cfg.compute_dtype,
                                    torch.device("cuda"))
        narrow_cache = decoding.init_paged_cache(narrow_cfg, engine.num_blocks,
                                                 engine.block_size, device="cuda")
        _, narrow_decode, _ = decoding.make_paged_engine_fns(narrow_cfg)
        narrow = measure(narrow_params, narrow_cache, narrow_decode)
        del narrow_params, narrow_cache
    full["idle_share"] = max(0.0, 1.0 - full["device_busy_ms"] / full["burst_ms"])
    log(f"serve [{card}]: decode bursts alone, width {width} x {n_steps} steps at "
        f"{live} live tokens a lane: burst {full['burst_ms']:.2f} ms (host enqueue "
        f"{full['enqueue_ms']:.2f}), device busy {full['device_busy_ms']:.2f} ms, idle "
        f"share {full['idle_share']:.3f}, {full['kernels_per_step']:.0f} kernels a "
        f"step; groups ms a burst {json.dumps(full['groups_ms'])}")
    log(f"serve [{card}]: same burst at narrow widths (d_model 512, d_ff 1024, "
        f"vocab 1024; {cfg.n_layers} layers, {cfg.n_heads}/{cfg.n_kv_heads} heads): "
        f"host enqueue {narrow['enqueue_ms']:.2f} "
        f"ms, burst {narrow['burst_ms']:.2f} ms, device busy "
        f"{narrow['device_busy_ms']:.2f} ms, {narrow['kernels_per_step']:.0f} kernels "
        f"a step")
    return {"live_tokens": live, "full_width": full, "narrow": narrow}


def run_streams(engine, prompts, new_tokens: int, temps=None, waits=None,
                streams=None):
    """Stream every prompt from a thread of its own, `new_tokens` each, at
    `temps` (greedy by default): through `engine.generate_stream`, or
    `streams(i, prompt, max_tokens, temperature)`, an iterator of request
    i's tokens. Request i of `waits` {i: j} is sent once request j has its
    first token. Returns ([(tokens, TTFT ms, last token ms)], wall s);
    raises if a request failed, ended short or did not end."""
    import threading

    if streams is None:
        def streams(i, prompt, max_tokens, temperature):
            return engine.generate_stream(prompt, max_tokens=max_tokens,
                                          temperature=temperature, timeout=600)

    temps = temps or [0.0] * len(prompts)
    waits = waits or {}
    results = [None] * len(prompts)
    first = [threading.Event() for _ in prompts]

    def run(i):
        if i in waits and not first[waits[i]].wait(600):
            results[i] = TimeoutError(f"request {waits[i]} never answered")
            first[i].set()
            return
        t_sub = time.perf_counter()
        out, t_first = [], None
        try:
            for tok in streams(i, prompts[i], new_tokens, temps[i]):
                if t_first is None:
                    t_first = time.perf_counter()
                    first[i].set()
                out.append(tok)
            results[i] = (out, (t_first - t_sub) * 1e3,
                          (time.perf_counter() - t_sub) * 1e3)
        except BaseException as e:  # noqa: BLE001 - reported below
            results[i] = e
        first[i].set()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    t_run = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    run_s = time.perf_counter() - t_run
    failed = {i: repr(r) for i, r in enumerate(results) if not isinstance(r, tuple)}
    if failed or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve: requests failed {failed}")
    if any(len(r[0]) != new_tokens for r in results):
        raise AssertionError(f"serve: lengths {[len(r[0]) for r in results]}")
    return results, run_s


def stream_decode_rates(results) -> list:
    """Each streamed request's decode rate, tokens/s after its first token,
    from run_streams' (tokens, TTFT ms, last token ms)."""
    return [(len(out) - 1) / ((last - first) / 1e3) for out, first, last in results]


def one_token_round_trips(call, rng, cfg, n: int = 20) -> float:
    """Median ms of `call(prompt)` for a 1-token request on one 16-token
    prompt, over `n` calls after a first (which prefills it; the rest hit
    its registered prefix, as a repeated short request does)."""
    prompt = rng.integers(0, cfg.vocab_size, 16).tolist()
    call(prompt)
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        call(prompt)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def serve_traffic(rng, cfg):
    """Phase 6's requests: prompts of 128 ... 1900 tokens and a pair sharing
    a 512-token prefix, whose second request arrives once the first has its
    first token (so it finds the prefix registered); two sampled at 0.8.
    Returns (prompts, temperatures, waits for run_streams)."""
    shared = rng.integers(0, cfg.vocab_size, 512).tolist()
    lengths = (128, 256, 512, 1000, 1500, 1900)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    prompts += [shared + rng.integers(0, cfg.vocab_size, n).tolist()
                for n in (88, 200)]
    temps = [0.0, 0.8, 0.0, 0.8, 0.0, 0.0, 0.0, 0.0]
    return prompts, temps, {len(prompts) - 1: len(prompts) - 2}


def largest_op_output(torch, fn):
    """(numel, op) of the largest tensor any aten op makes while `fn` runs
    (views, which make none, are left out), and fn's result."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        top = (0, "")

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(r.alias_info is not None for r in func._schema.returns):
                return out
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.numel() > Largest.top[0]:
                    Largest.top = (t.numel(), str(func))
            return out

    with Largest():
        result = fn()
    return Largest.top, result


def serve_main_path(torch, models, attention, seed: int, card: str, cfg=None,
                    teacher=forward_teacher):
    """Phase 6: llama3-8b served by PagedLLMEngine with the knob defaults
    (phase 11b: `cfg` mixtral-8x7b at MIXTRAL_SERVE_LAYERS, held to `teacher`).

    Eight requests from threads: prompts of 128 ... 1900 tokens and a pair
    sharing a 512-token prefix, the second of which arrives once the first
    has its first token (so it finds the prefix registered). Every request
    must finish without error; the greedy ones must agree with `forward`
    teacher-forced over prompt + output (argmax, wherever the top-2 gap
    exceeds SERVE_MARGIN), and one request's first-token and first decode
    logits must be within SERVE_LOGITS_TOL of forward's. Then eight short
    prompts decoding together (decode tokens/s, burst ms, the step against
    its least time), decode bursts alone (`decode_burst_profile`) and one
    long prompt alone (prefill tokens/s). Returns the results and the
    engine's bf16 weights, which phase 8 serves again."""
    import numpy as np

    from ray_tpu_torch.models import decoding
    from ray_tpu_torch.serve import PagedLLMEngine

    cfg = cfg or models.configs.LLAMA3_8B
    num_slots, max_len, new_tokens = 8, 2048, 64
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                                device="cuda")
    engine = PagedLLMEngine(cfg, params, num_slots=num_slots, max_len=max_len,
                            seed=seed)
    del params  # the engine holds its bf16 copy
    torch.cuda.empty_cache()
    try:
        engine.warmup()
        build_s = time.perf_counter() - t0
        weights_gib = sum(w.numel() * w.element_size() for w in
                          models.training.tree_leaves(engine.params)) / 2**30
        pool_gib = 2 * engine.cache.k.numel() * engine.cache.k.element_size() / 2**30
        log(f"serve [{card}]: {cfg.name} engine built in {build_s:.1f} s; weights "
            f"{weights_gib:.2f} GiB, KV pool {engine.num_blocks} blocks of "
            f"{engine.block_size} = {pool_gib:.2f} GiB, prefill_chunk "
            f"{engine.prefill_chunk}, max_burst {engine.max_burst}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attention.reset_launches()

        rng = np.random.default_rng(seed)
        prompts, temps, waits = serve_traffic(rng, cfg)
        results, run_s = run_streams(engine, prompts, new_tokens, temps=temps,
                                     waits=waits)
        mixed_stats = engine.engine_stats()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        kernel_launches = dict(attention.launches)
        if any(kernel_launches.values()):
            raise AssertionError(f"serve: the serving path launched {kernel_launches}")
        if not (mixed_stats["prefix_hits"] >= 1 and mixed_stats["reuse_hits"] > 0
                and mixed_stats["cow_copies"] > 0):
            raise AssertionError(f"serve: the shared prefix was not reused: {mixed_stats}")
        ttft = [round(r[1], 3) for r in results]
        mixed_decode = stream_decode_rates(results)
        log(f"serve [{card}]: 8 requests (prompts {[len(p) for p in prompts]}, "
            f"temps {temps}) done in {run_s:.2f} s; TTFT ms {ttft}; decode tokens/s "
            f"a request {[round(r, 1) for r in mixed_decode]}; prefix_hits "
            f"{mixed_stats['prefix_hits']} reuse_hits {mixed_stats['reuse_hits']} "
            f"cow_copies {mixed_stats['cow_copies']}; attention kernel launches "
            f"{kernel_launches}")

        # Greedy outputs against forward, teacher-forced at bf16.
        steps = SERVE_DECODE_STEPS_CHECKED
        firsts, fwd_steps = [], []

        def logits_checks(i, p, logits):
            # The engine's own first-token logits, kept for prefix hits
            # (read-only; the pool is large enough that none was evicted).
            stored = engine.allocator._meta[tuple(p)].float()
            first = logits[len(p) - 1].float()
            firsts.append((float((stored - first).abs().max()), float(first.std())))
            if i == 0:   # forward's logits for the first decode steps
                fwd_steps.append(logits[len(p):len(p) + steps].float().clone())

        greedy = [i for i, temp in enumerate(temps) if temp == 0]
        agreement = forward_agreement(
            torch, models, engine.params, cfg, [prompts[i] for i in greedy],
            [results[i][0] for i in greedy], card, on_logits=logits_checks,
            teacher=teacher,
            max_beyond_share=MOE_BF16_BEYOND_SHARE if cfg.n_experts else 0.0)
        with torch.no_grad():
            # The engine's decode step on the first request, replayed on a
            # pool of its own: prefill its prompt, then feed its first
            # tokens; each step's logits against forward's.
            p, out = prompts[0], results[0][0]
            bs = engine.block_size
            n_blocks = math.ceil((len(p) + steps) / bs)
            replay = decoding.init_paged_cache(cfg, n_blocks + 1, bs, device="cuda")
            table = torch.arange(1, n_blocks + 1, dtype=torch.int32, device="cuda")
            one = torch.ones(1, dtype=torch.bool, device="cuda")
            replay, _ = decoding.paged_prefill_chunk(
                engine.params, replay, torch.tensor(p, dtype=torch.int32, device="cuda"),
                table, 0, len(p), cfg)
            rows = []
            for k in range(steps):
                step_args = (torch.tensor([out[k]], dtype=torch.int32, device="cuda"),
                             table[None], torch.tensor([len(p) + k], dtype=torch.int32,
                                                       device="cuda"), one)
                if k == 0:   # the step's largest tensor: no weight copy runs
                    largest, (replay, row) = largest_op_output(
                        torch, lambda: decoding.paged_decode_step(
                            engine.params, replay, *step_args, cfg))
                else:
                    replay, row = decoding.paged_decode_step(
                        engine.params, replay, *step_args, cfg)
                rows.append(row[0].float())
            decode_diff = float((torch.stack(rows) - fwd_steps[0]).abs().max())
            del replay, rows, fwd_steps
        first_diff = max(f[0] for f in firsts)
        log(f"serve [{card}]: logits engine vs {teacher.__name__} max |diff|: first "
            f"token {first_diff:.4f}, first {steps} decode steps of the "
            f"{len(prompts[0])}-token request {decode_diff:.4f} (bound "
            f"{SERVE_LOGITS_TOL}; logit std {min(f[1] for f in firsts):.3f}-"
            f"{max(f[1] for f in firsts):.3f}); a decode step's largest tensor "
            f"{largest[0]} elements ({largest[1]})")
        # With MoE the first-token logits of a prompt prefilled in other
        # chunks than the teacher's may part at a routing flip (see
        # MOE_BF16_BEYOND_SHARE): they are reported, the decode steps held.
        held = decode_diff if cfg.n_experts else max(first_diff, decode_diff)
        if held > SERVE_LOGITS_TOL:
            raise AssertionError(f"serve: logits differ from {teacher.__name__}'s by "
                                 f"{held} > {SERVE_LOGITS_TOL}")
        # An expert product that copied or permuted its stacked weights
        # would make a tensor of a layer's (E, d, f) expert weight.
        expert_weight = cfg.n_experts * cfg.d_model * cfg.d_ff
        if cfg.n_experts and largest[0] >= expert_weight // 2:
            raise AssertionError(f"serve: a decode step made a {largest} tensor, "
                                 f"of the order of an expert weight ({expert_weight})")

        torch.cuda.reset_peak_memory_stats()  # the check above is not serving
        # Decode round: eight short prompts prefill in one tick, then decode
        # together at width 8 with no prefill pending.
        n_log = len(engine.burst_log)
        run_streams(engine, [rng.integers(0, cfg.vocab_size, 16).tolist()
                             for _ in range(num_slots)], new_tokens)
        bursts = [b for b in list(engine.burst_log)[n_log:] if b[3] == num_slots]
        burst_ms = [(b[2] - b[0]) * 1e3 for b in bursts]
        enqueue_ms = [(b[1] - b[0]) * 1e3 for b in bursts]
        emitted = sum(b[4] for b in bursts)
        decode_tok_s = emitted / (sum(burst_ms) / 1e3)
        burst = engine.max_burst
        step_ms = statistics.median(burst_ms) / burst
        # Least time of a width-8 decode step: every weight but the
        # embedding read once, plus the live KV each lane reads (its
        # positions 0..pos, growing by one a step) at the card's memory
        # rate. The design's own traffic is larger: each lane gathers its
        # whole table (b_max blocks) whatever its length.
        n_weights = cfg.num_params - cfg.vocab_size * cfg.d_model
        kv_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
        live_tokens = [burst * b[6] + b[5] * burst * (burst + 1) // 2 for b in bursts]
        bound_ms = [(burst * n_weights * 2 + n * kv_token) / PEAK_HBM_BYTES * 1e3 / burst
                    for n in live_tokens]
        bound_step_ms = statistics.median(bound_ms)
        distance = statistics.median(b_ms / burst / bd for b_ms, bd in zip(burst_ms, bound_ms))
        window = engine._b_max * engine.block_size
        gathered_ms = (n_weights * 2 + num_slots * window * kv_token) / PEAK_HBM_BYTES * 1e3
        log(f"serve [{card}]: decode round, {len(bursts)} width-8 bursts of "
            f"{burst}: burst ms median {statistics.median(burst_ms):.2f} "
            f"(host enqueue {statistics.median(enqueue_ms):.2f}); decode "
            f"{decode_tok_s:.1f} tokens/s; step {step_ms:.3f} ms vs least "
            f"{bound_step_ms:.3f} ms ({distance:.1f}x; weights {n_weights * 2 / 1e9:.2f} "
            f"GB + live KV {statistics.median(live_tokens) / burst * kv_token / 1e9:.3f} GB "
            f"a step at 3.35 TB/s); with the gathered window "
            f"({num_slots * window * kv_token / 1e9:.2f} GB a step) {gathered_ms:.3f} ms")
        profiled = decode_burst_profile(torch, models, engine, cfg, card)

        # Prefill round: one fresh 1900-token prompt alone.
        long_prompt = rng.integers(0, cfg.vocab_size, 1900).tolist()
        torch.cuda.synchronize()
        t_sub = time.perf_counter()
        engine.generate(long_prompt, max_tokens=1, timeout=600)
        prefill_ms = (time.perf_counter() - t_sub) * 1e3
        prefill_tok_s = len(long_prompt) / (prefill_ms / 1e3)
        peak_gib = max(peak_gib, torch.cuda.max_memory_allocated() / 2**30)
        snapshot = engine.allocator.snapshot()
        log(f"serve [{card}]: prefill round, 1900 tokens alone: TTFT "
            f"{prefill_ms:.1f} ms, {prefill_tok_s:.0f} tokens/s; peak memory "
            f"{peak_gib:.2f} GiB; allocator {json.dumps(snapshot)}")
        one_token_ms = one_token_round_trips(
            lambda p: engine.generate(p, max_tokens=1, timeout=600), rng, cfg)
        log(f"serve [{card}]: 1-token request in process (engine.generate): median "
            f"{one_token_ms:.2f} ms")
    finally:
        engine.shutdown()
    return engine.params, {
            "config": cfg.name, "num_slots": num_slots, "max_len": max_len,
            "block_size": engine.block_size, "prefill_chunk": engine.prefill_chunk,
            "max_burst": engine.max_burst, "num_blocks": engine.num_blocks,
            "weights_gib": weights_gib, "kv_pool_gib": pool_gib, "build_s": build_s,
            "prompts": [len(p) for p in prompts], "temperatures": temps,
            "ttft_ms": ttft, "mixed_run_s": run_s, "mixed_stats": mixed_stats,
            "mixed_decode_tokens_per_s": mixed_decode,
            "one_token_round_trip_ms": one_token_ms,
            "teacher_forced": {**agreement,
                               "first_token_logits_max_abs_diff": first_diff,
                               "decode_logits_max_abs_diff": decode_diff,
                               "logits_tolerance": SERVE_LOGITS_TOL},
            "decode_step_largest_tensor": largest,
            "decode_bursts": len(bursts), "burst_ms": burst_ms,
            "burst_enqueue_ms": enqueue_ms, "decode_tokens_per_s": decode_tok_s,
            "decode_live_kv_tokens": live_tokens, "decode_step_ms": step_ms,
            "decode_step_bound_ms": bound_step_ms, "decode_step_distance": distance,
            "decode_step_gathered_window_ms": gathered_ms,
            "decode_bursts_alone": profiled,
            "prefill_1900_ms": prefill_ms, "prefill_tokens_per_s": prefill_tok_s,
            "peak_mem_gib": peak_gib, "allocator": snapshot}


def migrate_stream(cfg, params, device: str, kw: dict, prompt, new_tokens: int) -> dict:
    """Phase 7c on one device: engine A streams a greedy request and its loop
    ends after the first decode burst (the cut; no clock decides where it
    falls); A's `export_streams` ticket goes into engine B by
    `import_prefix`, and B resumes the stream from the tokens the client
    saw. Returns the uninterrupted tokens (from a third engine), the tokens
    seen and continued, and B's counts."""
    from ray_tpu_torch.serve import PagedLLMEngine

    ref = PagedLLMEngine(cfg, params, device=device, prefix_sharing=False, **kw)
    a, b = (PagedLLMEngine(cfg, params, device=device, **kw) for _ in range(2))
    real_burst = a._decode

    def last_burst(*args, **kwargs):
        a._stop = True              # A's loop ends after this tick
        return real_burst(*args, **kwargs)

    try:
        full = ref.generate(prompt, max_tokens=new_tokens, timeout=600)
        a._decode = last_burst
        stream = a.generate_stream(prompt, max_tokens=new_tokens, timeout=600)
        seen = [next(stream) for _ in range(5)]
        a._thread.join(timeout=600)
        tickets = a.export_streams()
        stream.close()
        if len(tickets) != 1:
            raise AssertionError(f"migration: {len(tickets)} tickets, not 1")
        t = tickets[0]
        imported = b.import_prefix(t["tokens"], t["kv"], t["block_size"])
        cont = list(b.generate_stream(prompt, max_tokens=new_tokens,
                                      resume_tokens=seen, timeout=600))
    finally:
        a._decode = real_burst      # no cycle through the closure keeps A
        for eng in (ref, a, b):
            eng.shutdown()
    return {"full": full, "seen": seen, "continued": cont,
            "ticket_tokens": len(t["tokens"]), "imported_blocks": imported,
            "prefix_hits": b.stats["prefix_hits"],
            "prefill_chunks": b.stats["prefill_chunks"]}


def check_serving_slice(torch, models, card: str, devices=("cpu", "cuda")) -> dict:
    """Phase 7: speculative decoding on both engines, the fixed-slot engine's
    prefix cache and stream migration, on phase 5's model, each part on the
    CPU and on the card (the last of `devices`): tokens and counts equal
    across devices, speculation exact, the migrated stream uninterrupted."""
    import numpy as np

    from ray_tpu_torch.serve import LLMEngine, PagedLLMEngine

    cfg, params = serve_ref_model(torch, models)
    rng = np.random.default_rng(3)
    # Prompts that repeat a segment; the random model's greedy
    # continuations also fall into loops, which the drafter mines.
    spec_prompts = [rng.integers(0, cfg.vocab_size, n).tolist() * reps
                    for reps, n in ((4, 12), (3, 16), (6, 8))]
    # The first prompt again last: a whole-prompt prefix-cache hit.
    fixed_prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 90)]
    fixed_prompts.append(fixed_prompts[0])
    mig_prompt = rng.integers(0, cfg.vocab_size, 40).tolist()
    paged_kw = dict(num_slots=4, max_len=512, block_size=16, prefill_chunk=128)
    got = {}
    for device in devices:
        res = got[device] = {}
        # Without speculation only on the card: its tokens must be the same.
        for k in ((4, 0) if device == devices[-1] else (4,)):
            eng = PagedLLMEngine(cfg, params, speculation_k=k, device=device, **paged_kw)
            try:
                res[f"paged_k{k}"] = [eng.generate(p, max_tokens=48, timeout=600)
                                      for p in spec_prompts]
                res[f"paged_k{k}_stats"] = {n: eng.stats[n] for n in
                                            ("spec_proposed", "spec_accepted")}
            finally:
                eng.shutdown()
        for k in (0, 4):
            eng = LLMEngine(cfg, params, num_slots=4, max_len=512, prefix_cache_size=4,
                            speculation_k=k, device=device)
            try:
                res[f"fixed_k{k}"] = [eng.generate(p, max_tokens=40, timeout=600)
                                      for p in fixed_prompts]
                res[f"fixed_k{k}_stats"] = {n: eng.stats[n] for n in (
                    "prefix_hits", "prefix_misses", "spec_proposed", "spec_accepted")}
            finally:
                eng.shutdown()
        res["migration"] = migrate_stream(cfg, params, device, paged_kw, mig_prompt, 24)
    ref, dev = got[devices[0]], got[devices[-1]]
    checks = {
        "7a paged k4 tokens and drafts card == cpu":
            dev["paged_k4"] == ref["paged_k4"]
            and dev["paged_k4_stats"] == ref["paged_k4_stats"],
        "7a drafts accepted": dev["paged_k4_stats"]["spec_accepted"] > 0,
        "7a paged k4 == k0 on the card": dev["paged_k4"] == dev["paged_k0"],
        "7b fixed tokens card == cpu": all(dev[f"fixed_k{k}"] == ref[f"fixed_k{k}"]
                                          for k in (0, 4)),
        "7b fixed k4 == k0, prefix-cache hit gives the miss's tokens": all(
            r["fixed_k4"] == r["fixed_k0"] and r["fixed_k0"][2] == r["fixed_k0"][0]
            for r in got.values()),
        "7b prefix-cache hits": all(r[f"fixed_k{k}_stats"]["prefix_hits"] >= 1
                                    for r in got.values() for k in (0, 4)),
        "7c migrated stream == uninterrupted": all(
            m["seen"] + m["continued"] == m["full"] and m["imported_blocks"] > 0
            and m["prefix_hits"] >= 1 for m in (r["migration"] for r in got.values())),
        "7c card == cpu": dev["migration"]["full"] == ref["migration"]["full"],
    }
    mig = dev["migration"]
    log(f"serving slice reference [{card}]: 7a paged speculation_k 4 on "
        f"{[len(p) for p in spec_prompts]}-token prompts, 48 new each: drafts "
        f"{dev['paged_k4_stats']}; 7b LLMEngine {dev['fixed_k0_stats']} (k 0), "
        f"{dev['fixed_k4_stats']} (k 4); 7c migration: ticket of "
        f"{mig['ticket_tokens']} tokens, {mig['imported_blocks']} blocks imported, "
        f"{mig['prefix_hits']} prefix hit, {mig['prefill_chunks']} prefill chunk; "
        f"checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"serving slice reference failed: {checks}; {got}")
    return {"devices": list(devices), "checks": checks,
            **{k: v for k, v in dev.items() if k.endswith("_stats")},
            "migration": {k: mig[k] for k in ("ticket_tokens", "imported_blocks",
                                              "prefix_hits", "prefill_chunks")}}


def _work_rate(entries) -> float:
    """Tokens a second over burst_log / verify_log entries."""
    entries = list(entries)
    busy = sum(e[2] - e[0] for e in entries)
    return sum(e[4] for e in entries) / busy if busy else 0.0


def _ms_by_width(entries) -> dict:
    """Median ms of burst_log / verify_log entries, by lane width."""
    by = {}
    for e in entries:
        by.setdefault(e[3], []).append((e[2] - e[0]) * 1e3)
    return {w: statistics.median(ms) for w, ms in sorted(by.items())}


def _verify_least_ms(cfg, entries, k: int) -> list:
    """Least time of each verify_log entry's call on an H100: every weight
    but the embedding read once, and each live lane's KV up to its window's
    last position read once, at the card's memory rate (bytes bound it:
    the products are 2 FLOPs a weight for K tokens a lane)."""
    n_weights = cfg.num_params - cfg.vocab_size * cfg.d_model
    kv_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    return [(n_weights * 2 + (e[6] + e[5] * k) * kv_token) / PEAK_HBM_BYTES * 1e3
            for e in entries]


def serve_slice_main_path(torch, models, attention, params, seed: int, card: str) -> dict:
    """Phase 8: this slice's main path at llama3-8b on phase 6's bf16 weights
    (see the module docstring)."""
    import numpy as np

    from ray_tpu_torch.serve import LLMEngine, PagedLLMEngine

    cfg = models.configs.LLAMA3_8B
    num_slots, max_len, new_tokens = 8, 2048, 64
    torch.cuda.empty_cache()
    log(f"serve [{card}]: phase 8 starts with "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (the weights)")
    rng = np.random.default_rng(seed + 8)
    # 8a: prompt lookup's traffic, prompts that repeat a 64-token segment.
    spec_prompts = [rng.integers(0, cfg.vocab_size, 64).tolist() * reps
                    for reps in (2, 3, 4, 5, 6, 7, 8, 8)]
    runs = []
    for k in (0, 4, 4, 0):           # in turns
        engine = PagedLLMEngine(cfg, params, num_slots=num_slots, max_len=max_len,
                                seed=seed, speculation_k=k)
        try:
            engine.warmup()
            attention.reset_launches()
            results, run_s = run_streams(engine, spec_prompts, new_tokens)
            launches = dict(attention.launches)
            if any(launches.values()):
                raise AssertionError(f"serve: the serving path launched {launches}")
            stats = engine.engine_stats()
            if k and not stats["spec_proposed"] > 0:
                raise AssertionError(f"serve: no verify call ran: {stats}")
            run = {"speculation_k": k, "run_s": run_s,
                   "ttft_ms": [r[1] for r in results],
                   "spec_proposed": stats["spec_proposed"],
                   "spec_accepted": stats["spec_accepted"],
                   "acceptance": (stats["spec_accepted"] / stats["spec_proposed"]
                                  if stats["spec_proposed"] else None),
                   "decode_tokens_per_s": _work_rate(
                       list(engine.burst_log) + list(engine.verify_log)),
                   "bursts": len(engine.burst_log), "verify_calls": len(engine.verify_log),
                   "burst_ms_by_width": _ms_by_width(engine.burst_log),
                   "verify_ms_by_width": _ms_by_width(engine.verify_log)}
            wide = [e for e in engine.verify_log if e[3] == num_slots]
            run["verify_least_ms_width8"] = (
                statistics.median(_verify_least_ms(cfg, wide, k)) if wide else None)
            if len(runs) < 2:         # each kind's first run against forward
                run["teacher_forced"] = forward_agreement(
                    torch, models, engine.params, cfg, spec_prompts,
                    [r[0] for r in results], card)
            runs.append(run)
            log(f"serve [{card}]: 8a PagedLLMEngine speculation_k {k}, 8 greedy "
                f"requests of {[len(p) for p in spec_prompts]} tokens, {new_tokens} "
                f"new each: {run_s:.2f} s; drafts accepted {stats['spec_accepted']} of "
                f"{stats['spec_proposed']} proposed ({run['acceptance']}); decode "
                f"{run['decode_tokens_per_s']:.1f} tokens/s over {run['bursts']} "
                f"bursts and {run['verify_calls']} verify calls; median ms by lane "
                f"width: a burst of {engine.max_burst} steps "
                f"{run['burst_ms_by_width']}, a verify call "
                f"{run['verify_ms_by_width']} (least at width 8: "
                f"{run['verify_least_ms_width8']} ms); TTFT ms "
                f"{[round(t, 3) for t in run['ttft_ms']]}")
        finally:
            engine.shutdown()
        del engine
        torch.cuda.empty_cache()

    # 8b: the fixed-slot engine. The 512-token prompt is sent again once it
    # has its first token (a prefix-cache hit), the rest once that has.
    lengths = (512, 64, 100, 128, 200, 256, 300)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    prompts.insert(1, prompts[0])
    waits = {1: 0, **{i: 1 for i in range(2, len(prompts))}}
    engine = LLMEngine(cfg, params, num_slots=num_slots, max_len=max_len,
                       prefill_buckets=(64, 128, 256, 512), seed=seed)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attention.reset_launches()
        results, run_s = run_streams(engine, prompts, new_tokens, waits=waits)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(attention.launches)
        if any(launches.values()):
            raise AssertionError(f"serve: the serving path launched {launches}")
        stats = engine.engine_stats()
        if stats["prefix_hits"] != 1:
            raise AssertionError(f"serve: the repeated prompt did not hit: {stats}")
        agreement = forward_agreement(torch, models, engine.params, cfg, prompts,
                                      [r[0] for r in results], card)
        ttft = [r[1] for r in results]
        log(f"serve [{card}]: 8b LLMEngine, 8 requests of {[len(p) for p in prompts]} "
            f"tokens (the second a prefix-cache hit), {new_tokens} new each: "
            f"{run_s:.2f} s; TTFT ms {[round(t, 3) for t in ttft]}; the hit's "
            f"tokens == the miss's: {results[1][0] == results[0][0]}; {stats}")
        # Decode round: eight 64-token prompts, 128 new tokens each; the
        # bursts with all 8 slots live.
        torch.cuda.reset_peak_memory_stats()
        n_log = len(engine.burst_log)
        run_streams(engine, [rng.integers(0, cfg.vocab_size, 64).tolist()
                             for _ in range(num_slots)], 2 * new_tokens)
        full = [b for b in list(engine.burst_log)[n_log:] if b[5] == num_slots]
        decode_tok_s = _work_rate(full)
        burst_ms = _ms_by_width(full).get(num_slots)
        peak_gib = max(peak_gib, torch.cuda.max_memory_allocated() / 2**30)
        kv_gib = 2 * engine.cache.k.numel() * engine.cache.k.element_size() / 2**30
        log(f"serve [{card}]: 8b decode round, {len(full)} bursts with 8 live slots: "
            f"{decode_tok_s:.1f} tokens/s, burst of {engine.max_burst} {burst_ms} ms; "
            f"KV cache {kv_gib:.2f} GiB; peak memory {peak_gib:.2f} GiB")
    finally:
        engine.shutdown()
    return {"config": cfg.name, "paged_speculation": runs,
            "fixed": {"prompts": [len(p) for p in prompts], "ttft_ms": ttft,
                      "run_s": run_s, "stats": stats, "teacher_forced": agreement,
                      "decode_bursts": len(full), "decode_tokens_per_s": decode_tok_s,
                      "burst_ms": burst_ms, "kv_cache_gib": kv_gib,
                      "peak_mem_gib": peak_gib}}


def check_remat_and_moe_reference(torch, models, card: str, full_grads) -> dict:
    """Phase 9, at fp32, card against CPU: (a) phase 3's model under remat
    "dots" and "ff", whose card grads must also equal phase 3's ("full",
    `full_grads`) within REMAT_GRAD_TOL; (b) the same model with 8 experts
    top-2 under "full" and "dots"; (c) phase 5's serving model with 8
    experts top-2 through PagedLLMEngine."""
    out = {}
    for policy in ("dots", "ff"):
        r = check_reference(torch, models, label=f"9a reference, remat {policy}",
                            remat_policy=policy)
        out[f"9a_{policy}"] = r
    moe = dict(n_experts=8, expert_top_k=2)
    for policy in ("full", "dots"):
        out[f"9b_moe_{policy}"] = check_reference(
            torch, models, label=f"9b reference, 8 experts top-2, remat {policy}",
            remat_policy=policy, **moe)
    pairs = {"9a dots vs full": (out["9a_dots"], full_grads),
             "9a ff vs full": (out["9a_ff"], full_grads),
             "9b dots vs full": (out["9b_moe_dots"], out["9b_moe_full"]["card_grads"])}
    same = {label: worst_grad_diff(r["card_grads"], want)
            for label, (r, want) in pairs.items()}
    log(f"9a/9b remat policies on the card, worst grad diff against full: {same} "
        f"(0 is bit for bit; bound {REMAT_GRAD_TOL})")
    if max(same.values()) > REMAT_GRAD_TOL:
        raise AssertionError(f"remat policies change the card's grads: {same}")
    for r in out.values():
        r.pop("card_grads")
    out["card_grads_vs_full"] = same
    out["9c"] = check_serving_reference(
        torch, models, card, label="9c serving reference, 8 experts top-2", **moe)
    return out


def remat_turns(torch, models, attention, steps: int, seed: int, card: str) -> dict:
    """Phase 10: the bench-350m train step (phase 4's batch) under remat
    "full", "dots" and "ff" in turns, on one train state: median step ms
    and host enqueue ms (steps 2..N of each turn), peak memory and kernel
    launches a step; then one profiled step under each policy (device busy
    ms and kernel groups)."""
    import dataclasses
    import numpy as np

    from ray_tpu_torch.scripts.profile_step import profile_step

    base = models.configs.BENCH_350M
    batch, seq = 8, 2048
    opt = models.training.default_optimizer(3e-4, warmup=10, total_steps=1000)
    init_fn, _ = models.training.make_train_step(base, device="cuda", optimizer=opt)
    step_fns = {p: models.training.make_train_step(
        dataclasses.replace(base, remat_policy=p), device="cuda", optimizer=opt)[1]
        for p in ("full", "dots", "ff")}
    state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    host = torch.from_numpy(np.random.default_rng(seed + 10).integers(
        0, base.vocab_size, (steps, batch, seq + 1), dtype=np.int32)).pin_memory()
    expected = {"fa_fwd": 2 * base.n_layers, "fa_bwd_dq": base.n_layers,
                "fa_bwd_dkv": base.n_layers}
    state, _ = step_fns["full"](state, {"tokens": host[0].to("cuda")})  # moments
    turns = []
    for policy in ("full", "dots", "ff", "ff", "dots", "full"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, host_ms, losses = [], [], []
        for i in range(steps):
            tokens = host[i].to("cuda", non_blocking=True)
            attention.reset_launches()
            t0 = time.perf_counter()
            state, metrics = step_fns[policy](state, {"tokens": tokens})
            host_ms.append((time.perf_counter() - t0) * 1e3)  # enqueued, not run
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if dict(attention.launches) != expected or not math.isfinite(losses[-1]):
                raise AssertionError(f"remat {policy} step {i}: launches "
                                     f"{dict(attention.launches)}, loss {losses[-1]}")
        turn = {"policy": policy, "step_ms": step_ms, "host_enqueue_ms": host_ms,
                "median_ms": statistics.median(step_ms[1:] or step_ms),
                "median_host_ms": statistics.median(host_ms[1:] or host_ms),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches_per_step": expected, "losses": losses}
        turns.append(turn)
        log(f"remat [{card}] {base.name} {policy}: median step {turn['median_ms']:.2f} ms "
            f"(host enqueue {turn['median_host_ms']:.2f}; steps "
            f"{[round(x, 1) for x in step_ms]}), peak {turn['peak_gib']:.2f} GiB, "
            f"launches a step {expected}")
    profiled = {}
    for policy in ("full", "dots", "ff"):
        prof = profile_step(step_fns[policy], state, host[0].to("cuda"))
        profiled[policy] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                  "idle_share", "groups_ms")}
        log(f"remat [{card}] {base.name} {policy}, one profiled step: device busy "
            f"{prof['device_busy_ms']:.1f} ms of {prof['wall_ms']:.1f}, groups "
            f"{json.dumps(prof['groups_ms'])}")
    del state
    torch.cuda.empty_cache()
    return {"config": base.name, "batch": batch, "seq": seq, "steps": steps,
            "turns": turns, "profiled_steps": profiled}


def moe_groups(profile: dict) -> dict:
    """The profiled MoE step's device ms by group, from `trace_summary`'s
    ops (launching aten op and its first input's dtype) and kernel groups."""
    ops, groups = profile["ops_ms"], profile["groups_ms"]

    def ops_sum(*prefixes):
        return sum(ms for op, ms in ops.items() if op.startswith(prefixes))

    out = {
        "dispatch/combine (fp32 bmm)": ops_sum("aten::bmm float"),
        "expert products (bf16 bmm)": ops_sum("aten::bmm c10::BFloat16"),
        "dense products (mm: attention projections, router, head)":
            ops_sum("aten::mm", "aten::addmm"),
        "attention kernels": sum(groups.get(k, 0.0) for k in KERNELS),
        "optimizer": groups.get("optimizer", 0.0),
    }
    out["elementwise, reductions and the rest"] = \
        profile["device_busy_ms"] - sum(out.values())
    return out


def moe_train_path(torch, models, attention, steps: int, seed: int, card: str) -> dict:
    """Phase 11a: mixtral-8x7b training at full width, depth cut to
    MIXTRAL_TRAIN_LAYERS, batch 2 x 2048, remat "full" and "dots" in turns
    (full, dots, dots, full) on one train state; every kernel launches 2L /
    L / L times a step. Then one profiled step under "full"."""
    import dataclasses
    import numpy as np

    from ray_tpu_torch.scripts.profile_step import profile_step

    cfg = dataclasses.replace(models.configs.MIXTRAL_8X7B,
                              n_layers=MIXTRAL_TRAIN_LAYERS, remat=True)
    batch, seq = 2, 2048
    opt = models.training.default_optimizer(3e-4, warmup=10, total_steps=1000)
    init_fn, _ = models.training.make_train_step(cfg, device="cuda", optimizer=opt)
    step_fns = {p: models.training.make_train_step(
        dataclasses.replace(cfg, remat_policy=p), device="cuda", optimizer=opt)[1]
        for p in ("full", "dots")}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    host = torch.from_numpy(np.random.default_rng(seed + 11).integers(
        0, cfg.vocab_size, (steps + 1, batch, seq + 1), dtype=np.int32)).pin_memory()
    expected = {"fa_fwd": 2 * cfg.n_layers, "fa_bwd_dq": cfg.n_layers,
                "fa_bwd_dkv": cfg.n_layers}
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launches()            # this slice's main path starts
    seen = dict(attention.launches)
    turns, losses = [], []
    for policy in ("full", "dots", "dots", "full"):
        step_ms, host_ms = [], []
        torch.cuda.synchronize()
        for i in range(steps):
            tokens = host[i].to("cuda", non_blocking=True)
            t_step = time.perf_counter()
            state, metrics = step_fns[policy](state, {"tokens": tokens})
            host_ms.append((time.perf_counter() - t_step) * 1e3)
            loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t_step) * 1e3)
            counts = {n: attention.launches[n] - seen[n] for n in seen}
            seen = dict(attention.launches)
            losses.append(loss)
            if counts != expected:
                raise AssertionError(f"mixtral {policy} step {i}: launches {counts} "
                                     f"!= {expected}")
            if not (math.isfinite(loss) and math.isfinite(grad_norm)):
                raise AssertionError(f"mixtral {policy} step {i}: non-finite loss "
                                     f"or grad norm")
        median_ms = statistics.median(step_ms[1:] or step_ms)
        turns.append({"policy": policy, "step_ms": step_ms, "host_enqueue_ms": host_ms,
                      "median_ms": median_ms,
                      "tokens_per_s": batch * seq / (median_ms / 1e3)})
        log(f"mixtral train [{card}] {policy}: median step {median_ms:.2f} ms "
            f"(steps {[round(x, 1) for x in step_ms]}, host {[round(x, 1) for x in host_ms]}), "
            f"{batch * seq / (median_ms / 1e3):.0f} tokens/s, launches a step {expected}")
    total = dict(attention.launches)      # ... and ends
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # The loss adds 0.01 x load balance (~1 a layer) and the z-loss (~0.005
    # a layer) to a cross entropy near ln(V) + 1/2 at random init.
    if not abs(losses[0] - (math.log(cfg.vocab_size) + 0.5)) < 1.0:
        raise AssertionError(f"mixtral first loss {losses[0]} far from ln(V) + 1/2")
    profile = profile_step(step_fns["full"], state, host[steps].to("cuda"),
                           record_shapes=True)
    want = {f"{n}_wgmma_kernel<{cfg.head_dim}>": c for n, c in expected.items()}
    if profile["attention_launches"] != want:
        raise AssertionError(f"profiled mixtral step launched "
                             f"{profile['attention_launches']}, not {want}")
    profile["moe_groups_ms"] = moe_groups(profile)
    # Active-parameter MFU: 6 N_active + 6 L d T FLOPs a token over the bf16
    # peak, N_active counting top_k of the n_experts experts of each layer
    # (what the dispatch pads to capacity and the fp32 dispatch/combine
    # products add is not counted).
    n_active = cfg.num_params - (cfg.n_experts - cfg.expert_top_k) * \
        3 * cfg.d_model * cfg.d_ff * cfg.n_layers
    fpt = 6.0 * n_active + 6 * cfg.n_layers * cfg.d_model * seq
    for turn in turns:
        turn["mfu_active_bf16_989"] = turn["tokens_per_s"] * fpt / PEAK_BF16_FLOPS
    log(f"mixtral train [{card}]: {cfg.n_layers} layers ({cfg.num_params / 1e9:.3f} B "
        f"params, {n_active / 1e9:.3f} B active), init {init_s:.1f} s, peak "
        f"{peak_gib:.2f} GiB, first loss {losses[0]:.4f}, launches {total}; "
        f"active MFU {[round(t['mfu_active_bf16_989'], 4) for t in turns]}; profiled "
        f"full step: device busy {profile['device_busy_ms']:.1f} ms of "
        f"{profile['wall_ms']:.1f}, groups {json.dumps(profile['moe_groups_ms'])}")
    del state
    torch.cuda.empty_cache()
    return {"config": cfg.name, "n_layers": cfg.n_layers, "batch": batch, "seq": seq,
            "steps_per_turn": steps, "params": cfg.num_params, "active_params": n_active,
            "init_s": init_s, "losses": losses, "turns": turns, "peak_mem_gib": peak_gib,
            "launches": total, "launches_per_step": expected, "profiled_step": profile}


def moe_serve_fp32_twin(torch, models, seed: int, card: str) -> dict:
    """Phase 11b's exactness check: mixtral-8x7b at full width and fp32,
    MIXTRAL_FP32_TWIN_LAYERS deep, served by PagedLLMEngine (8 slots,
    max_len 2048, knob defaults) on phase 6's traffic; greedy tokens and
    every first-token logit held to the dropless re-prefill at the fp32
    bounds."""
    import dataclasses
    import numpy as np

    from ray_tpu_torch.serve import PagedLLMEngine

    cfg = dataclasses.replace(models.configs.MIXTRAL_8X7B, n_layers=MIXTRAL_FP32_TWIN_LAYERS,
                              compute_dtype=torch.float32, remat=False)
    params = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                                device="cuda")
    engine = PagedLLMEngine(cfg, params, num_slots=8, max_len=2048, seed=seed)
    del params
    try:
        engine.warmup()
        prompts, temps, waits = serve_traffic(np.random.default_rng(seed), cfg)
        results, run_s = run_streams(engine, prompts, 64, temps=temps, waits=waits)
        firsts = []

        def first_token(i, p, logits):
            stored = engine.allocator._meta[tuple(p)].float()
            firsts.append(float((stored - logits[len(p) - 1].float()).abs().max()))

        greedy = [i for i, temp in enumerate(temps) if temp == 0]
        agreement = forward_agreement(
            torch, models, engine.params, cfg, [prompts[i] for i in greedy],
            [results[i][0] for i in greedy], card, on_logits=first_token,
            teacher=reprefill_teacher, margin=SERVE_FP32_MARGIN)
        stats = engine.engine_stats()
    finally:
        engine.shutdown()
    log(f"serve [{card}]: fp32 twin, {cfg.name} at {cfg.n_layers} layers: 8 requests "
        f"in {run_s:.2f} s, {stats['prefill_chunks']} prefill chunks, prefix_hits "
        f"{stats['prefix_hits']}; first-token logits vs the re-prefill max |diff| "
        f"{[round(f, 7) for f in firsts]} (bound {SERVE_FP32_LOGITS_TOL})")
    if max(firsts) > SERVE_FP32_LOGITS_TOL:
        raise AssertionError(f"fp32 twin: first-token logits differ by {max(firsts)}")
    del engine
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "run_s": run_s, "teacher_forced": agreement,
            "first_token_logits_max_abs_diff": firsts,
            "prefill_chunks": stats["prefill_chunks"], "prefix_hits": stats["prefix_hits"]}


def moe_serve_path(torch, models, attention, seed: int, card: str) -> dict:
    """Phase 11b: mixtral-8x7b served at full width, depth cut to
    MIXTRAL_SERVE_LAYERS, bf16 weights drawn a layer at a time, through
    phase 6's traffic and measurements, held to the dropless re-prefill;
    first its fp32 twin (`moe_serve_fp32_twin`)."""
    import dataclasses

    twin = moe_serve_fp32_twin(torch, models, seed, card)
    cfg = dataclasses.replace(models.configs.MIXTRAL_8X7B, n_layers=MIXTRAL_SERVE_LAYERS,
                              param_dtype=torch.bfloat16, remat=False)
    params, run = serve_main_path(torch, models, attention, seed, card, cfg=cfg,
                                  teacher=reprefill_teacher)
    torch.cuda.empty_cache()   # the paged engine and its pool are gone
    tp = tp_engine_phase(torch, models, attention, params, cfg, seed, card, "14c",
                         plain_turns=False, teacher=reprefill_teacher)
    log("14c tensor-parallel LLMEngine: " + json.dumps(tp))
    del params
    torch.cuda.empty_cache()
    return {**run, "fp32_twin": twin, "tp_engine": tp}


# Phase 12c: Adafactor's learning rate. bench.py's 1e-4 moves a param by
# ~1e-4 of itself a step, below what a 1e-4 bound on the params can see;
# at 1e-2 a wrong update shows.
MESH_REF_LR = 1e-2


def check_collectives(torch, mesh) -> dict:
    """Phase 12: each collective once on the card over the one-rank NCCL
    group (fsdp, size 1): every result equals its input (all_to_all and
    ppermute_ring issue no collective over one rank)."""
    from ray_tpu_torch.parallel import collectives

    x = torch.arange(24, dtype=torch.float32, device="cuda").reshape(4, 6)
    out = {name: fn(x, "fsdp", mesh=mesh) for name, fn in {
        "psum": collectives.psum, "pmean": collectives.pmean,
        "all_gather": collectives.all_gather, "psum_scatter": collectives.psum_scatter,
        "ppermute_ring": collectives.ppermute_ring}.items()}
    out["all_to_all"] = collectives.all_to_all(x, "fsdp", mesh=mesh, split_dim=0,
                                               concat_dim=1)
    for name, y in out.items():
        if not torch.equal(y, x):
            raise AssertionError(f"{name} over a one-rank group changed its input")
    return {"checked": sorted(out), "backend": torch.distributed.get_backend()}


def fed_turn(torch, attention, step_fn, state, feed, expected) -> tuple:
    """Steps over a torch_feed, each timed on the host clock (enqueue,
    then synchronised); the launches of every step must be `expected`."""
    step_ms, host_ms, losses = [], [], []
    total = {n: 0 for n in expected}
    with feed:
        for batch in feed:
            attention.reset_launches()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            host_ms.append((time.perf_counter() - t0) * 1e3)  # enqueued, not run
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if dict(attention.launches) != expected or not math.isfinite(losses[-1]):
                raise AssertionError(f"launches {dict(attention.launches)} != "
                                     f"{expected}, or loss {losses[-1]}")
            total = {n: total[n] + attention.launches[n] for n in total}
    return state, {"step_ms": step_ms, "host_enqueue_ms": host_ms, "losses": losses,
                   "launches": total,
                   "median_ms": statistics.median(step_ms[1:] or step_ms),
                   "median_host_ms": statistics.median(host_ms[1:] or host_ms),
                   "feed_hits": feed.hits, "feed_misses": feed.misses}


def mesh_turns(torch, models, attention, mesh, steps: int, seed: int, card: str) -> dict:
    """Phase 12a: bench-350m, the plain step and the mesh step from the
    same params on the same batches, in turns (plain, mesh, mesh, plain),
    each turn fed by torch_feed."""
    import numpy as np

    from ray_tpu_torch.data import torch_feed

    cfg = models.configs.BENCH_350M
    batch, seq = 8, 2048
    opt = models.training.default_optimizer(3e-4, warmup=10, total_steps=1000)
    init_plain, step_plain = models.training.make_train_step(cfg, device="cuda",
                                                             optimizer=opt)
    init_mesh, step_mesh = models.training.make_train_step(cfg, mesh, optimizer=opt)
    states = {"plain": init_plain(torch.Generator(device="cuda").manual_seed(seed))}
    states["mesh"] = init_mesh(params=states["plain"].params)
    corpus = np.random.default_rng(seed + 12).integers(
        0, cfg.vocab_size, (2 * steps, batch, seq + 1), dtype=np.int32)
    expected = {"fa_fwd": 2 * cfg.n_layers, "fa_bwd_dq": cfg.n_layers,
                "fa_bwd_dkv": cfg.n_layers}
    turns = []
    for path, half in (("plain", 0), ("mesh", 0), ("mesh", 1), ("plain", 1)):
        source = ({"tokens": t} for t in corpus[half * steps:(half + 1) * steps])
        feed = torch_feed(source, device="cuda", mesh=mesh if path == "mesh" else None,
                          prefetch=2)
        torch.cuda.synchronize()
        states[path], turn = fed_turn(torch, attention, {"plain": step_plain,
                                                         "mesh": step_mesh}[path],
                                      states[path], feed, expected)
        turns.append({"path": path, "batches": [half * steps, (half + 1) * steps],
                      **turn, "launches_per_step": expected})
        log(f"mesh [{card}] {cfg.name} {path} (batches {half * steps}..): median step "
            f"{turn['median_ms']:.2f} ms (host enqueue {turn['median_host_ms']:.2f}; "
            f"steps {[round(x, 1) for x in turn['step_ms']]}), feed hits "
            f"{turn['feed_hits']} misses {turn['feed_misses']}, launches a step {expected}")
    # The same batches from the same params: plain turn i against mesh turn i.
    diffs = [abs(a - b) for half in (0, 1)
             for a, b in zip(turns[half * 3]["losses"], turns[1 + half]["losses"])]
    log(f"mesh [{card}]: |loss mesh - loss plain| per step {[f'{d:.3g}' for d in diffs]}")
    if not abs(turns[0]["losses"][0] - (math.log(cfg.vocab_size) + 0.5)) < 1.0:
        raise AssertionError(f"first loss {turns[0]['losses'][0]} far from ln(V) + 1/2")
    if max(diffs) > 1e-2:
        raise AssertionError(f"mesh and plain steps part: loss diffs {diffs}")
    del states
    torch.cuda.empty_cache()
    return {"config": cfg.name, "batch": batch, "seq": seq, "steps_per_turn": steps,
            "turns": turns, "loss_abs_diff": diffs}


def bench_1b4_path(torch, models, attention, mesh, steps: int, seed: int, card: str) -> dict:
    """Phase 12b: bench-1b4 at full width through the mesh step with
    Adafactor(1e-4), fed by torch_feed; then one profiled step."""
    import numpy as np

    from ray_tpu_torch.data import torch_feed
    from ray_tpu_torch.scripts.profile_step import profile_step

    cfg = models.configs.BENCH_1B4
    batch, seq = 4, 2048
    init_fn, step_fn = models.training.make_train_step(
        cfg, mesh, optimizer=models.training.Adafactor(1e-4))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    corpus = np.random.default_rng(seed + 13).integers(
        0, cfg.vocab_size, (steps + 1, batch, seq + 1), dtype=np.int32)
    expected = {"fa_fwd": 2 * cfg.n_layers, "fa_bwd_dq": cfg.n_layers,
                "fa_bwd_dkv": cfg.n_layers}
    feed = torch_feed(({"tokens": t} for t in corpus[:steps]), device="cuda",
                      mesh=mesh, prefetch=2)
    total = {n: 0 for n in attention.launches}
    attention.reset_launches()            # this slice's main path starts
    step_ms, host_ms, losses = [], [], []
    with feed:
        for batch_ in feed:
            t_step = time.perf_counter()
            state, metrics = step_fn(state, batch_)
            host_ms.append((time.perf_counter() - t_step) * 1e3)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t_step) * 1e3)
            counts = {n: attention.launches[n] - total[n] for n in total}
            total = dict(attention.launches)
            if counts != expected or not math.isfinite(losses[-1]):
                raise AssertionError(f"bench-1b4 step {len(losses)}: launches {counts} "
                                     f"!= {expected}, or loss {losses[-1]}")
    total = dict(attention.launches)      # ... and ends
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not abs(losses[0] - (math.log(cfg.vocab_size) + 0.5)) < 1.0:
        raise AssertionError(f"bench-1b4 first loss {losses[0]} far from ln(V) + 1/2")
    profile = profile_step(step_fn, state, torch.from_numpy(corpus[steps]).to("cuda"))
    want = {f"{n}_wgmma_kernel<{cfg.head_dim}>": c for n, c in expected.items()}
    if profile["attention_launches"] != want:
        raise AssertionError(f"profiled bench-1b4 step launched "
                             f"{profile['attention_launches']}, not {want}")
    # The optimizer's share: Adafactor alone on fixed grads of the same leaves.
    leaves = models.training.tree_leaves(state.params)
    grads = [p.detach() * 1e-3 for p in leaves]

    def adafactor_update():
        for p, g in zip(leaves, grads):
            p.grad = g
        models.training.Adafactor(1e-4).update(state.opt_state, leaves, steps)

    adafactor_ms = time_ms(adafactor_update, iters=3, warmup=1)
    del grads
    median_ms = statistics.median(step_ms[1:] or step_ms)
    tokens_per_s = batch * seq / (median_ms / 1e3)
    fpt = 6.0 * cfg.num_params + 6 * cfg.n_layers * cfg.d_model * seq
    run = {"config": cfg.name, "batch": batch, "seq": seq, "steps": steps,
           "params": cfg.num_params, "init_s": init_s, "losses": losses,
           "step_ms": step_ms, "host_enqueue_ms": host_ms, "steady_step_ms": median_ms,
           "tokens_per_s": tokens_per_s,
           "mfu_bf16_989": tokens_per_s * fpt / PEAK_BF16_FLOPS,
           "peak_mem_gib": peak_gib, "feed_hits": feed.hits, "feed_misses": feed.misses,
           "adafactor_update_ms": adafactor_ms,
           "launches": total, "launches_per_step": expected,
           "profiled_step": {k: profile[k] for k in (
               "wall_ms", "device_busy_ms", "idle_share", "groups_ms", "top_kernels_ms")}}
    log(f"bench-1b4 [{card}] mesh step, Adafactor: median {median_ms:.2f} ms (steps "
        f"{[round(x, 1) for x in step_ms]}, host {[round(x, 1) for x in host_ms]}), "
        f"{tokens_per_s:.0f} tokens/s, MFU {run['mfu_bf16_989']:.4f}, peak "
        f"{peak_gib:.2f} GiB, init {init_s:.1f} s, losses {[round(x, 4) for x in losses]}, "
        f"feed hits {feed.hits} misses {feed.misses}, launches {total}; profiled step: "
        f"device busy {profile['device_busy_ms']:.1f} ms of {profile['wall_ms']:.1f}, "
        f"groups {json.dumps(profile['groups_ms'])}; Adafactor alone {adafactor_ms:.2f} ms")
    del state
    torch.cuda.empty_cache()
    return run


def check_mesh_reference(torch, models, mesh, card: str) -> dict:
    """Phase 12c: 3 Adafactor steps of phase 3's fp32 model under the mesh
    path on the card and on the CPU (a "cpu" mesh over the same group)."""
    from ray_tpu_torch.parallel import build_mesh

    cfg, params, tokens = reference_model(torch, models)
    batches = [tokens.numpy()] * 3
    runs = {}
    for device, m in (("cpu", build_mesh(device_type="cpu")), ("cuda", mesh)):
        init_fn, step_fn = models.training.make_train_step(
            cfg, m, optimizer=models.training.Adafactor(MESH_REF_LR))
        state = init_fn(params=params)
        losses = [float(step_fn(state, {"tokens": b})[1]["loss"]) for b in batches]
        runs[device] = (losses, [p.detach().full_tensor().cpu() for p in
                                 models.training.tree_leaves(state.params)])
    (l_cpu, p_cpu), (l_gpu, p_gpu) = runs["cpu"], runs["cuda"]
    start = models.training.tree_leaves(params)
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    param_diff = max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu))
    update_diff = worst_grad_diff([a - s for a, s in zip(p_gpu, start)],
                                  [b - s for b, s in zip(p_cpu, start)])
    log(f"mesh reference [{card}]: Adafactor({MESH_REF_LR}) x 3 at fp32, losses card "
        f"{l_gpu} cpu {l_cpu} (worst rel diff {loss_diff:.3g}); params max |diff| "
        f"{param_diff:.3g}, updates {update_diff:.3g} of their largest")
    if loss_diff > 1e-5 or param_diff > 1e-4 or update_diff > 1e-3:
        raise AssertionError("mesh path: card and CPU part")
    return {"losses_card": l_gpu, "losses_cpu": l_cpu, "loss_rel_diff": loss_diff,
            "param_max_abs_diff": param_diff, "update_rel_diff": update_diff}


def mesh_phase(torch, models, attention, steps: int, seed: int, card: str) -> dict:
    """Phase 12 on one world-1 group, which it destroys when done."""
    from ray_tpu_torch.parallel import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(fsdp=-1))
    try:
        out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "collectives": check_collectives(torch, mesh)}
        log(f"mesh [{card}]: {out}")
        out["bench_350m_turns"] = mesh_turns(torch, models, attention, mesh, steps,
                                             seed, card)
        out["bench_1b4"] = bench_1b4_path(torch, models, attention, mesh, steps, seed,
                                          card)
        out["reference"] = check_mesh_reference(torch, models, mesh, card)
        return out
    finally:
        torch.distributed.destroy_process_group()


# Phase 13a: the pipeline's microbatches (bench-350m's batch of 8 rows
# makes microbatches of 2); at pp 1 a step runs M + S - 1 = 4 ticks.
PIPE_MICROBATCHES = 4
# Phase 13a: |pipeline - plain| of every step's loss. At world 1 both
# compute the same function; the microbatched products round in bf16 in
# another grouping.
PIPE_LOSS_TOL = 1e-2
# Phase 13c: ring and Ulysses attention at fp32, card against CPU (atol,
# rtol) on outputs and q/k/v grads.
CP_REF_TOL = (1e-5, 1e-5)


def pipeline_turns(torch, models, attention, mesh, steps: int, seed: int, card: str) -> dict:
    """Phase 13a: bench-350m through `make_pipeline_train_step` (pp 1, 4
    microbatches) and through the plain `make_train_step`, both with
    `AdamW()` (optax.adamw(1e-3)), from the same params on the same
    batches, in turns (plain, pipeline, pipeline, plain)."""
    import numpy as np

    from ray_tpu_torch.parallel import pipeline

    cfg = models.configs.BENCH_350M
    batch, seq = 8, 2048
    opt = models.training.AdamW()
    init_plain, step_plain = models.training.make_train_step(cfg, device="cuda",
                                                             optimizer=opt)
    init_pipe, step_pipe = pipeline.make_pipeline_train_step(
        cfg, mesh, n_microbatches=PIPE_MICROBATCHES, optimizer=opt)
    step_fns = {"plain": step_plain, "pipeline": step_pipe}
    states = {"plain": init_plain(torch.Generator(device="cuda").manual_seed(seed))}
    states["pipeline"] = init_pipe(params=states["plain"].params)
    corpus = np.random.default_rng(seed + 13).integers(
        0, cfg.vocab_size, (2 * steps, batch, seq + 1), dtype=np.int32)
    host = torch.from_numpy(corpus).pin_memory()
    ticks = PIPE_MICROBATCHES + mesh.size(mesh.mesh_dim_names.index(pipeline.AXIS_PIPE)) - 1
    expected = {"plain": {"fa_fwd": 2 * cfg.n_layers, "fa_bwd_dq": cfg.n_layers,
                          "fa_bwd_dkv": cfg.n_layers}}
    expected["pipeline"] = {n: c * ticks for n, c in expected["plain"].items()}
    total = {n: 0 for n in attention.launches}  # the pipeline steps' launches
    turns = []
    for path, half in (("plain", 0), ("pipeline", 0), ("pipeline", 1), ("plain", 1)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, host_ms, losses = [], [], []
        for i in range(half * steps, (half + 1) * steps):
            tokens = host[i].to("cuda", non_blocking=True)
            attention.reset_launches()
            t0 = time.perf_counter()
            states[path], metrics = step_fns[path](states[path], {"tokens": tokens})
            host_ms.append((time.perf_counter() - t0) * 1e3)  # enqueued, not run
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            counts = dict(attention.launches)
            if counts != expected[path] or not math.isfinite(losses[-1]):
                raise AssertionError(f"{path} step {i}: launches {counts} != "
                                     f"{expected[path]}, or loss {losses[-1]}")
            if path == "pipeline":
                total = {n: total[n] + counts[n] for n in total}
        turn = {"path": path, "batches": [half * steps, (half + 1) * steps],
                "step_ms": step_ms, "host_enqueue_ms": host_ms, "losses": losses,
                "median_ms": statistics.median(step_ms[1:] or step_ms),
                "median_host_ms": statistics.median(host_ms[1:] or host_ms),
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches_per_step": expected[path]}
        turns.append(turn)
        log(f"pipeline [{card}] {cfg.name} {path} (batches {half * steps}..): median "
            f"step {turn['median_ms']:.2f} ms (host enqueue {turn['median_host_ms']:.2f}; "
            f"steps {[round(x, 1) for x in step_ms]}), peak {turn['peak_mem_gib']:.2f} GiB "
            f"(both states resident), losses {[round(x, 5) for x in losses]}, launches a "
            f"step {expected[path]}")
    # The same batches from the same params: plain turn i against pipeline turn i.
    diffs = [abs(a - b) for half in (0, 1)
             for a, b in zip(turns[half * 3]["losses"], turns[1 + half]["losses"])]
    log(f"pipeline [{card}]: |loss pipeline - loss plain| per step "
        f"{[f'{d:.3g}' for d in diffs]}")
    if not abs(turns[0]["losses"][0] - (math.log(cfg.vocab_size) + 0.5)) < 1.0:
        raise AssertionError(f"first loss {turns[0]['losses'][0]} far from ln(V) + 1/2")
    if max(diffs) > PIPE_LOSS_TOL:
        raise AssertionError(f"pipeline and plain losses part: diffs {diffs}")
    del states
    torch.cuda.empty_cache()
    return {"config": cfg.name, "batch": batch, "seq": seq, "steps_per_turn": steps,
            "n_microbatches": PIPE_MICROBATCHES, "ticks": ticks, "turns": turns,
            "loss_abs_diff": diffs, "launches": total}


def host_and_wall_ms(torch, fn, iters: int = 10) -> tuple[float, float]:
    """(host ms to enqueue one call, wall ms of one call) over `iters`
    calls in a row: near each other, the host sets the call's time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3, (time.perf_counter() - t0) / iters * 1e3


def _fwd_bwd(torch, fn, q, k, v, do) -> list:
    """[out, dq, dk, dv] of fn(q, k, v) and the cotangent do."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return [out.detach(), *torch.autograd.grad(out, leaves, do)]


def context_parallel_attention(torch, attention, sp_mesh, seed: int, card: str) -> dict:
    """Phase 13b: ring and Ulysses attention over an sp axis of one rank at
    bench-1b4's attention shape (bf16, causal), forward and backward:
    Ulysses launches each kernel once and equals flash_attention bit for
    bit; ring launches none and is held to mha_reference at fp32 on the
    same inputs. Each is timed against flash_attention (CUDA events), and
    its host enqueue read beside its wall time."""
    from ray_tpu_torch.ops import flash_attention, ring_attention, ulysses_attention

    b, t, h, d = 4, 2048, 16, 128
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    fns = {"flash": lambda a, b_, c: flash_attention(a, b_, c, True),
           "ulysses": lambda a, b_, c: ulysses_attention(a, b_, c, mesh=sp_mesh),
           "ring": lambda a, b_, c: ring_attention(a, b_, c, mesh=sp_mesh)}
    one = {"fa_fwd": 1, "fa_bwd_dq": 1, "fa_bwd_dkv": 1}
    expected = {"flash": one, "ulysses": one, "ring": {n: 0 for n in one}}
    runs, launches = {}, {}
    for name, fn in fns.items():
        attention.reset_launches()
        runs[name] = _fwd_bwd(torch, fn, q, k, v, do)
        torch.cuda.synchronize()
        launches[name] = dict(attention.launches)
        if launches[name] != expected[name]:
            raise AssertionError(f"{name}: launches {launches[name]} != {expected[name]}")
    if not all(torch.equal(a, b_) for a, b_ in zip(runs["ulysses"], runs["flash"])):
        raise AssertionError("Ulysses at sp 1 differs from flash_attention")
    want = _fwd_bwd(torch, lambda a, b_, c: attention.mha_reference(
        a.float(), b_.float(), c.float(), causal=True), q, k, v, do)
    ring_err = [max_err(got, exp, attention.KERNEL_TOLERANCE["bf16"])
                for got, exp in zip(runs["ring"], want)]
    del runs, want
    torch.cuda.empty_cache()
    ms = {name: time_ms(lambda fn=fn: _fwd_bwd(torch, fn, q, k, v, do), iters=5)
          for name, fn in fns.items()}
    host = {name: host_and_wall_ms(torch, lambda fn=fn: _fwd_bwd(torch, fn, q, k, v, do))
            for name, fn in fns.items()}
    out = {"shape": [b, t, h, d], "dtype": "bf16", "causal": True,
           "launches": launches, "ulysses_equals_flash": True,
           "ring_vs_reference": {"max_abs_err": max(e for e, _ in ring_err),
                                 "tolerance_share": max(s_ for _, s_ in ring_err)},
           "fwd_bwd_ms": ms, "host_enqueue_and_wall_ms": host}
    log(f"context parallel [{card}] at sp 1, {b}x{t}x{h}x{d} bf16 causal, fwd+bwd: "
        f"flash {ms['flash']:.3f} ms, ulysses {ms['ulysses']:.3f} ms (equal to flash, "
        f"launches {launches['ulysses']}), ring {ms['ring']:.3f} ms (launches "
        f"{launches['ring']}; vs mha_reference {out['ring_vs_reference']}); host "
        f"enqueue and wall ms a call {host}")
    return out


def check_pipeline_reference(torch, models, mesh, sp_mesh, card: str) -> dict:
    """Phase 13c, fp32, card against CPU ("cpu" meshes over the same group):
    make_pipeline_loss and its grads on phase 3's model at pp 1 and 2
    microbatches (loss 1e-5, grads 1e-4 of each tensor's max), and ring and
    Ulysses attention at sp 1 (CP_REF_TOL)."""
    from ray_tpu_torch.ops import ring_attention, ulysses_attention
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.pipeline import (
        build_pipeline_mesh, make_pipeline_loss, pipeline_shardings)

    cfg, params, tokens = reference_model(torch, models)
    start = models.jax_bridge.params_to_numpy(params)
    runs = {}
    for device, m in (("cpu", build_pipeline_mesh(1, device_type="cpu")), ("cuda", mesh)):
        p = models.jax_bridge.params_from_jax(start, cfg, mesh=m,
                                              shardings=pipeline_shardings(cfg, m))
        leaves = models.training.tree_leaves(p)
        for w in leaves:
            w.requires_grad_()
        loss = make_pipeline_loss(cfg, m, 2)(p, {"tokens": tokens})
        loss.backward()
        runs[device] = (float(loss.detach()),
                        [w.grad.full_tensor().detach().cpu() for w in leaves])
    (l_cpu, g_cpu), (l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    worst = worst_grad_diff(g_gpu, g_cpu)
    if not math.isclose(l_gpu, l_cpu, rel_tol=1e-5) or worst > 1e-4:
        raise AssertionError(f"pipeline loss card {l_gpu} cpu {l_cpu}, grads {worst:.3g}")
    gen = torch.Generator().manual_seed(15)
    q, k, v, do = (torch.randn(2, 256, 4, 64, generator=gen) for _ in range(4))
    cpu_sp = build_mesh(MeshConfig(fsdp=1, sp=1), device_type="cpu")
    attn = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        want = _fwd_bwd(torch, lambda a, b, c: fn(a, b, c, mesh=cpu_sp), q, k, v, do)
        got = _fwd_bwd(torch, lambda a, b, c: fn(a, b, c, mesh=sp_mesh),
                       *(x.cuda() for x in (q, k, v, do)))
        errs = [max_err(g.cpu(), w, CP_REF_TOL) for g, w in zip(got, want)]
        attn[name] = {"max_abs_err": max(e for e, _ in errs),
                      "tolerance_share": max(s_ for _, s_ in errs)}
    out = {"pipeline_loss_card": l_gpu, "pipeline_loss_cpu": l_cpu,
           "pipeline_worst_grad_diff": worst, "attention": attn}
    log(f"pipeline reference [{card}]: fp32 loss card {l_gpu:.6f} cpu {l_cpu:.6f}, worst "
        f"grad diff {worst:.3g} of its tensor's max; ring/Ulysses at sp 1 card vs cpu "
        f"{attn}")
    return out


def pipeline_phase(torch, models, attention, steps: int, seed: int, card: str) -> dict:
    """Phase 13 on one world-1 group (a (dp 1, pp 1) pipeline mesh and an
    sp mesh of one rank over it), which it destroys when done."""
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.pipeline import build_pipeline_mesh

    mesh = build_pipeline_mesh(1)
    try:
        sp_mesh = build_mesh(MeshConfig(fsdp=1, sp=1))
        return {
            "bench_350m_pipeline": pipeline_turns(torch, models, attention, mesh, steps,
                                                  seed, card),
            "context_parallel": context_parallel_attention(torch, attention, sp_mesh,
                                                           seed, card),
            "reference": check_pipeline_reference(torch, models, mesh, sp_mesh, card)}
    finally:
        torch.distributed.destroy_process_group()


# Phase 14a: |mesh - plain| of every step's loss, mixtral-8x7b at bf16 on
# the same params and batches. At world 1 both steps compute the same
# function (phase 12a's bench-350m agreed bit for bit).
MOE_MESH_LOSS_TOL = 1e-2
# Phase 14b/c: the fixed-slot engine's traffic, phase 8b's: prompts of
# these lengths, the first sent twice (a prefix-cache hit).
TP_PROMPT_LENGTHS = (512, 64, 100, 128, 200, 256, 300)


def moe_mesh_path(torch, models, attention, mesh, steps: int, seed: int,
                  card: str) -> dict:
    """Phase 14a: mixtral-8x7b at phase 11a's cell (full width, depth
    MIXTRAL_TRAIN_LAYERS, batch 2 x 2048, remat "full", AdamW with warmup)
    through the mesh step on `mesh` (fsdp over the world-1 group, ep 1),
    fed by torch_feed. The plain step runs first from the same params
    (drawn again from the seed) on the same batches, and its state is freed
    before the mesh state exists; every mesh step's loss must be within
    MOE_MESH_LOSS_TOL of the plain step's, and every step of both must
    launch each kernel 2L / L / L times."""
    import dataclasses
    import numpy as np

    from ray_tpu_torch.data import torch_feed

    cfg = dataclasses.replace(models.configs.MIXTRAL_8X7B,
                              n_layers=MIXTRAL_TRAIN_LAYERS, remat=True)
    batch, seq = 2, 2048
    opt = models.training.default_optimizer(3e-4, warmup=10, total_steps=1000)
    corpus = np.random.default_rng(seed + 14).integers(
        0, cfg.vocab_size, (steps, batch, seq + 1), dtype=np.int32)
    expected = {"fa_fwd": 2 * cfg.n_layers, "fa_bwd_dq": cfg.n_layers,
                "fa_bwd_dkv": cfg.n_layers}
    n_active = cfg.num_params - (cfg.n_experts - cfg.expert_top_k) * \
        3 * cfg.d_model * cfg.d_ff * cfg.n_layers
    fpt = 6.0 * n_active + 6 * cfg.n_layers * cfg.d_model * seq
    runs = {}
    for path, m in (("plain", None), ("mesh", mesh)):
        init_fn, step_fn = models.training.make_train_step(cfg, m, device="cuda",
                                                           optimizer=opt)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        feed = torch_feed(({"tokens": t} for t in corpus), device="cuda", mesh=m,
                          prefetch=2)
        state, turn = fed_turn(torch, attention, step_fn, state, feed, expected)
        del state
        torch.cuda.empty_cache()
        turn.update(init_s=init_s, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                    tokens_per_s=batch * seq / (turn["median_ms"] / 1e3))
        turn["mfu_active_bf16_989"] = turn["tokens_per_s"] * fpt / PEAK_BF16_FLOPS
        runs[path] = turn
        log(f"14a mixtral train [{card}] {path} step: median {turn['median_ms']:.2f} ms "
            f"(steps {[round(x, 1) for x in turn['step_ms']]}, host enqueue "
            f"{[round(x, 1) for x in turn['host_enqueue_ms']]}), "
            f"{turn['tokens_per_s']:.0f} tokens/s, active MFU "
            f"{turn['mfu_active_bf16_989']:.4f}, peak {turn['peak_mem_gib']:.2f} GiB, "
            f"init {init_s:.1f} s, feed hits {turn['feed_hits']} misses "
            f"{turn['feed_misses']}, launches a step {expected}")
    diffs = [abs(a - b) for a, b in zip(runs["mesh"]["losses"], runs["plain"]["losses"])]
    log(f"14a mixtral train [{card}]: |loss mesh - loss plain| per step "
        f"{[f'{d:.3g}' for d in diffs]} (bound {MOE_MESH_LOSS_TOL})")
    if not abs(runs["plain"]["losses"][0] - (math.log(cfg.vocab_size) + 0.5)) < 1.0:
        raise AssertionError(f"14a first loss {runs['plain']['losses'][0]} far from "
                             f"ln(V) + 1/2")
    if max(diffs) > MOE_MESH_LOSS_TOL:
        raise AssertionError(f"14a: mesh and plain steps part: loss diffs {diffs}")
    return {"config": cfg.name, "n_layers": cfg.n_layers, "batch": batch, "seq": seq,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "steps": steps,
            "active_params": n_active, "plain": runs["plain"], "mesh_step": runs["mesh"],
            "loss_abs_diff": diffs, "launches": runs["mesh"]["launches"],
            "launches_per_step": expected}


def tp_engine_phase(torch, models, attention, params, cfg, seed: int, card: str,
                    label: str, plain_turns: bool, teacher=forward_teacher) -> dict:
    """Phase 14b (llama3-8b on phase 8's weights) and 14c (mixtral-8x7b on
    phase 11b's, `teacher` its dropless re-prefill): the fixed-slot
    `LLMEngine(mesh=...)` over a tp mesh of a world-1 group it starts (and
    destroys when done), 8 slots, max_len 2048, on phase 8b's traffic, then
    a decode round (8 prompts of 64 tokens, 128 new each, at width 8).
    With `plain_turns`
    it runs in turns with the meshless `LLMEngine` (plain, mesh, mesh,
    plain) and every turn's greedy tokens must equal the first's; each
    engine is shut down and freed before the next one is built. The first
    mesh turn's tokens are held to `teacher` (MoE: at most
    MOE_BF16_BEYOND_SHARE of the positions beyond the margin)."""
    import numpy as np

    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    from ray_tpu_torch.serve import LLMEngine

    num_slots, max_len, new_tokens = 8, 2048, 64
    rng = np.random.default_rng(seed + 140)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in TP_PROMPT_LENGTHS]
    prompts.insert(1, prompts[0])
    waits = {1: 0, **{i: 1 for i in range(2, len(prompts))}}
    round_prompts = [rng.integers(0, cfg.vocab_size, 64).tolist() for _ in range(num_slots)]
    mesh = build_mesh(MeshConfig(fsdp=1, tp=1))
    turns, agreement = [], None
    try:
        for path in (("plain", "mesh", "mesh", "plain") if plain_turns else ("mesh",)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            engine = LLMEngine(cfg, params, num_slots=num_slots, max_len=max_len,
                               prefill_buckets=(64, 128, 256, 512), seed=seed,
                               **({"mesh": mesh} if path == "mesh" else {}))
            try:
                attention.reset_launches()
                results, run_s = run_streams(engine, prompts, new_tokens, waits=waits)
                launches = dict(attention.launches)
                if any(launches.values()):
                    raise AssertionError(f"{label}: the serving path launched {launches}")
                stats = engine.engine_stats()
                if stats["prefix_hits"] != 1:
                    raise AssertionError(f"{label}: the repeated prompt did not hit: {stats}")
                if path == "mesh" and agreement is None:
                    agreement = forward_agreement(
                        torch, models, engine.params, cfg, prompts,
                        [r[0] for r in results], card, teacher=teacher,
                        max_beyond_share=MOE_BF16_BEYOND_SHARE if cfg.n_experts else 0.0)
                n_log = len(engine.burst_log)
                run_streams(engine, round_prompts, 2 * new_tokens)
                full = [b for b in list(engine.burst_log)[n_log:] if b[5] == num_slots]
                if not full:
                    raise AssertionError(f"{label}: no burst ran with 8 live slots")
                turn = {"path": path, "run_s": run_s, "ttft_ms": [r[1] for r in results],
                        "tokens": [r[0] for r in results],
                        "decode_bursts": len(full),
                        "decode_tokens_per_s": _work_rate(full),
                        "burst_ms": [(b[2] - b[0]) * 1e3 for b in full],
                        "burst_enqueue_ms": [(b[1] - b[0]) * 1e3 for b in full],
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
            finally:
                engine.shutdown()
            del engine
            turns.append(turn)
            log(f"{label} [{card}] {cfg.name} LLMEngine {path}: 8 requests of "
                f"{[len(p) for p in prompts]} tokens in {run_s:.2f} s, TTFT ms "
                f"{[round(t, 1) for t in turn['ttft_ms']]}; decode round: "
                f"{turn['decode_tokens_per_s']:.1f} tokens/s over {len(full)} bursts with "
                f"8 live slots, a burst {statistics.median(turn['burst_ms']):.2f} ms median "
                f"(host enqueue {statistics.median(turn['burst_enqueue_ms']):.2f} ms); "
                f"peak {turn['peak_mem_gib']:.2f} GiB")
    finally:
        torch.distributed.destroy_process_group()
    same = all(t["tokens"] == turns[0]["tokens"] for t in turns)
    log(f"{label} [{card}]: greedy tokens equal over the turns "
        f"{[t['path'] for t in turns]}: {same}")
    if not same:
        raise AssertionError(f"{label}: the engines' greedy tokens differ")
    for t in turns:
        del t["tokens"]
    return {"config": cfg.name, "n_layers": cfg.n_layers, "prompts": [len(p) for p in prompts],
            "turns": turns, "teacher_forced": agreement}


def check_expert_tp_reference(torch, models, card: str) -> dict:
    """Phase 14d at fp32, card against CPU, on a world-1 group it starts
    (and destroys): TINY_MOE (4 experts, top 2) widened to d_model 256 so
    its heads are the kernels' 64, remat "full": the mesh path's loss and
    grads at (fsdp 1, ep 1) on a "cuda" and a "cpu" mesh (loss 1e-5, grads
    1e-4 of each tensor's max), and the tp-1 `LLMEngine`'s greedy tokens (a
    prefix hit among them) card == CPU; then `dryrun_tp_serving` at tp 1."""
    import dataclasses
    import numpy as np

    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    from ray_tpu_torch.serve import LLMEngine
    from ray_tpu_torch.serve.llm import dryrun_tp_serving

    cfg = dataclasses.replace(models.configs.TINY_MOE, d_model=256, d_ff=512,
                              remat=True, compute_dtype=torch.float32)
    params = models.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 129), dtype=np.int32)
    prompts = [[5, 6, 7, 8, 9], [5, 6, 7, 8, 9], [100, 3, 99]]
    out = {}
    try:
        for device in ("cuda", "cpu"):   # the group starts with NCCL beside gloo
            mesh = build_mesh(MeshConfig(fsdp=-1, ep=1), device_type=device)
            init_fn, _ = models.training.make_train_step(cfg, mesh)
            state = init_fn(params=params)
            loss = models.loss_fn(state.params, {"tokens": torch.from_numpy(tokens).to(device)},
                                  cfg, mesh=mesh)
            loss.backward()
            grads = [p.grad.full_tensor().cpu() for p in
                     models.training.tree_leaves(state.params)]
            tp_mesh = build_mesh(MeshConfig(fsdp=1, tp=1), device_type=device)
            engine = LLMEngine(cfg, params, mesh=tp_mesh, num_slots=2, max_len=64,
                               prefill_buckets=(16,))
            try:
                toks = [engine.generate(p, max_tokens=8, timeout=120) for p in prompts]
                hits = engine.stats["prefix_hits"]
            finally:
                engine.shutdown()
            out[device] = (float(loss.detach()), grads, toks, hits)
        dryrun_tp_serving(models.configs.TINY_MOE, 1, timeout=120)
    finally:
        torch.distributed.destroy_process_group()
    (l_cpu, g_cpu, t_cpu, h_cpu), (l_gpu, g_gpu, t_gpu, h_gpu) = out["cpu"], out["cuda"]
    worst = worst_grad_diff(g_gpu, g_cpu)
    log(f"14d expert/tp reference [{card}]: {cfg.name} d 256 mesh step at ep 1, loss card "
        f"{l_gpu:.6f} cpu {l_cpu:.6f}, worst grad diff {worst:.3g}; tp-1 LLMEngine tokens "
        f"card == cpu: {t_gpu == t_cpu} (prefix hits {h_gpu}, {h_cpu}); "
        f"dryrun_tp_serving(tp=1) ran")
    if not math.isclose(l_gpu, l_cpu, rel_tol=1e-5) or worst > 1e-4:
        raise AssertionError("14d: the mesh path's card and CPU loss or grads part")
    if t_gpu != t_cpu or h_gpu != 1 or h_cpu != 1:
        raise AssertionError(f"14d: tp engine tokens card {t_gpu} cpu {t_cpu}")
    return {"loss_card": l_gpu, "loss_cpu": l_cpu, "worst_grad_diff": worst,
            "tokens_equal": True, "dryrun_tp_serving": "ran"}


def expert_mesh_phase(torch, models, attention, steps: int, seed: int, card: str) -> dict:
    """Phase 14a on one world-1 group (destroyed when done), then 14d."""
    from ray_tpu_torch.parallel import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(fsdp=-1, ep=1))
    try:
        run = moe_mesh_path(torch, models, attention, mesh, steps, seed, card)
    finally:
        torch.distributed.destroy_process_group()
    return {"mixtral_8x7b_mesh": run,
            "reference": check_expert_tp_reference(torch, models, card)}


# Phase 15a: TINY's head_dim (16), zero-padded to 64 by `flash_attention`,
# through the fp32 kernels on the card: logits and loss within 1e-5 and
# grads within 1e-4 (of each tensor's max) of the plain versions' on the
# CPU, as phase 3 holds the unpadded models.
TINY_PADDED_TOL = (1e-5, 1e-4)
# Phase 15b(i): the port's fp32 logits on the imported weights against an
# independent HF-layout forward, max |diff| relative to max |logit|.
HF_REF_TOL = 1e-3
# Phase 15b(ii): the engine's first-token logits (its prefill's, kept in
# its prefix cache) against forward's at the same position, max |diff| in
# units of the logits' std: phase 6's SERVE_LOGITS_TOL, whose logits have
# unit spread. A fault of the imported weights' serving (a wrong layer,
# head or position) moves the logits by the order of their spread.
HF_SERVE_LOGITS_TOL = 0.25
# Phases 16 and 17: a PPO (16) or DreamerV3 (17c) update on the card
# against the same update on the CPU, from the same weights, batch and
# noise: params, optimizer moments and metrics within atol + rtol * |CPU's|
# (as the CPU tests hold the port to JAX).
RL_CARD_CPU_TOL = (1e-5, 1e-5)
# Phase 19b: steps a turn of the worker actor and the direct step.
CLUSTER_STEPS = 10
# Phase 17c: a DreamerV3 update makes ~70,000 categorical draws (argmax of
# logits + Gumbel noise); where a draw's top two lie closer than the
# devices' rounding, card and CPU pick different samples and the updates
# part, which says nothing of the port. So the update held to
# RL_CARD_CPU_TOL is the first of up to DREAMER_TIE_DRAWS draws of batch
# and noise whose every sample the CPU decides by a top-2 gap above
# DREAMER_TIE_GAP. At the defaults about 0.6 draws an update fall below
# 1e-5 (0.8 per unit of gap near zero, measured on the CPU), so about one
# update in two is taken; fp32 rounding moves the perturbed logits by
# ~1e-6.
DREAMER_TIE_GAP = 1e-5
DREAMER_TIE_DRAWS = 8


def tiny_padded(torch, models, attention, card: str) -> dict:
    """Phase 15a: TINY at fp32 (head_dim 16) through `flash_attention` on
    the card, which pads the head dim to 64 and launches the kernels, and
    on the CPU, which runs their plain versions: forward logits, loss and
    grads; 2L / L / L launches on the card."""
    import dataclasses
    import numpy as np

    cfg = dataclasses.replace(models.configs.TINY, compute_dtype=torch.float32)
    params = models.init_params(cfg, torch.Generator().manual_seed(15), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (2, 97), dtype=np.int32))
    attention.reset_launches()
    with torch.no_grad():
        logits_gpu = models.forward(_tree_to(params, "cuda"), tokens[:, :-1].cuda(), cfg).cpu()
    l_gpu, g_gpu = reference_grads(torch, models, cfg, params, tokens, "cuda")
    torch.cuda.synchronize()
    launches = dict(attention.launches)
    with torch.no_grad():
        logits_cpu = models.forward(params, tokens[:, :-1], cfg)
    l_cpu, g_cpu = reference_grads(torch, models, cfg, params, tokens, "cpu")
    logit_diff = float((logits_gpu - logits_cpu).abs().max())
    worst = worst_grad_diff(g_gpu, g_cpu)
    padded = attention.padded_head_dim(cfg.head_dim)
    log(f"15a [{card}]: TINY (head_dim {cfg.head_dim}, padded to {padded}) fp32, kernels "
        f"on the card vs plain on the CPU: logits max diff {logit_diff:.3g}, loss "
        f"{l_gpu:.6f} vs {l_cpu:.6f}, worst grad diff {worst:.3g} of its tensor's max; "
        f"launches {launches}")
    n = cfg.n_layers
    if launches != {"fa_fwd": 2 * n, "fa_bwd_dq": n, "fa_bwd_dkv": n}:
        raise AssertionError(f"15a: TINY's forward and grads launched {launches}")
    out_tol, grad_tol = TINY_PADDED_TOL
    if (logit_diff > out_tol or not math.isclose(l_gpu, l_cpu, rel_tol=out_tol)
            or worst > grad_tol):
        raise AssertionError("15a: TINY's card results part from the CPU's")
    return {"head_dim": cfg.head_dim, "padded_head_dim": padded,
            "logits_max_diff": logit_diff, "loss_card": l_gpu, "loss_cpu": l_cpu,
            "worst_grad_diff": worst, "launches": launches}


def hf_llama_config(models, n_layers: int):
    """An HF Llama config at `configs.LLAMA3_8B`'s widths with plain RoPE,
    as a plain attribute object (the card's machine has no transformers)."""
    import types

    c = models.configs.LLAMA3_8B
    return types.SimpleNamespace(
        model_type="llama", vocab_size=c.vocab_size, hidden_size=c.d_model,
        num_hidden_layers=n_layers, num_attention_heads=c.n_heads,
        num_key_value_heads=c.n_kv_heads, intermediate_size=c.d_ff,
        max_position_embeddings=c.max_seq_len, rope_theta=c.rope_theta,
        rms_norm_eps=c.norm_eps, hidden_act="silu", tie_word_embeddings=False,
        rope_scaling=None, attention_bias=False, mlp_bias=False)


def hf_state_dict(torch, hf, dtype, seed: int, device: str = "cuda") -> dict:
    """An HF-layout Llama state dict drawn on the card from `seed` and kept
    on `device` ("cpu": each tensor is copied to pageable host memory as
    it is drawn): Linear weights [out, in] and embeddings N(0, 0.02^2)
    (HF's initializer range), norm weights 1 + N(0, 0.1^2)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, hd = hf.hidden_size, hf.hidden_size // hf.num_attention_heads
    kv, f, v = hf.num_key_value_heads * hd, hf.intermediate_size, hf.vocab_size

    def w(*shape, std=0.02, mean=0.0):
        t = torch.randn(shape, generator=gen, device="cuda", dtype=dtype) * std + mean
        return t.to(device)

    sd = {"model.embed_tokens.weight": w(v, d), "model.norm.weight": w(d, std=0.1, mean=1.0),
          "lm_head.weight": w(v, d)}
    for i in range(hf.num_hidden_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": w(d, std=0.1, mean=1.0),
                   p + "self_attn.q_proj.weight": w(d, d),
                   p + "self_attn.k_proj.weight": w(kv, d),
                   p + "self_attn.v_proj.weight": w(kv, d),
                   p + "self_attn.o_proj.weight": w(d, d),
                   p + "post_attention_layernorm.weight": w(d, std=0.1, mean=1.0),
                   p + "mlp.gate_proj.weight": w(f, d),
                   p + "mlp.up_proj.weight": w(f, d),
                   p + "mlp.down_proj.weight": w(d, f)})
    return sd


def hf_llama_logits(torch, sd: dict, hf, tokens):
    """An independent Llama forward on the HF layout: y = x @ W.T with W
    [out, in], RMSNorm w * x / rms(x), rotate-half RoPE from inv_freq =
    theta^(-2i/hd), kv heads repeated for GQA, causal softmax attention,
    SiLU-gated MLP, untied head. Computes in the state dict's dtype."""
    F = torch.nn.functional
    b, t = tokens.shape
    d, h, kvh = hf.hidden_size, hf.num_attention_heads, hf.num_key_value_heads
    hd = d // h
    inv_freq = 1.0 / (hf.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device="cuda") / hd))
    ang = torch.arange(t, dtype=torch.float32, device="cuda")[:, None] * inv_freq[None]
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()

    def rms(x, w):
        return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + hf.rms_norm_eps))

    def rope(x):
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return x * cos + torch.cat([-x2, x1], -1) * sin

    mask = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
    x = sd["model.embed_tokens.weight"][tokens]
    for i in range(hf.num_hidden_layers):
        p = f"model.layers.{i}."
        y = rms(x, sd[p + "input_layernorm.weight"])
        q = (y @ sd[p + "self_attn.q_proj.weight"].T).view(b, t, h, hd).transpose(1, 2)
        k = (y @ sd[p + "self_attn.k_proj.weight"].T).view(b, t, kvh, hd).transpose(1, 2)
        v = (y @ sd[p + "self_attn.v_proj.weight"].T).view(b, t, kvh, hd).transpose(1, 2)
        q, k = rope(q), rope(k)
        k, v = k.repeat_interleave(h // kvh, 1), v.repeat_interleave(h // kvh, 1)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        o = torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v
        x = x + o.transpose(1, 2).reshape(b, t, d) @ sd[p + "self_attn.o_proj.weight"].T
        y = rms(x, sd[p + "post_attention_layernorm.weight"])
        x = x + (F.silu(y @ sd[p + "mlp.gate_proj.weight"].T)
                 * (y @ sd[p + "mlp.up_proj.weight"].T)) @ sd[p + "mlp.down_proj.weight"].T
    return rms(x, sd["model.norm.weight"]) @ sd["lm_head.weight"].T


def hf_import_reference(torch, models, attention, seed: int, card: str) -> dict:
    """Phase 15b(i): a 2-layer fp32 HF Llama at llama3-8b's widths,
    imported by `from_hf`: `forward`'s logits against `hf_llama_logits`
    within HF_REF_TOL; the forward's launches are this path's."""
    import dataclasses
    import numpy as np

    from ray_tpu_torch.models.hf_convert import from_hf

    hf = hf_llama_config(models, 2)
    sd = hf_state_dict(torch, hf, torch.float32, seed + 150)
    cfg, params = from_hf((hf, sd), name="hf-llama3-8b-2l")
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32, remat=False)
    tokens = torch.from_numpy(np.random.default_rng(seed + 150).integers(
        0, hf.vocab_size, (2, 256))).cuda()
    with torch.no_grad():
        want = hf_llama_logits(torch, sd, hf, tokens)
        attention.reset_launches()
        got = models.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        launches = dict(attention.launches)
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"15b(i) [{card}]: HF import at llama3-8b widths, 2 layers fp32: forward vs "
        f"the HF-layout reference, max |diff| {rel:.3g} of max |logit| "
        f"{float(want.abs().max()):.4f}; launches {launches}")
    if rel > HF_REF_TOL:
        raise AssertionError(f"15b(i): imported logits part from the HF layout's by {rel}")
    if launches != {"fa_fwd": hf.num_hidden_layers, "fa_bwd_dq": 0, "fa_bwd_dkv": 0}:
        raise AssertionError(f"15b(i): the forward launched {launches}")
    return {"n_layers": 2, "tokens": list(tokens.shape), "rel_max_diff": rel,
            "launches": launches}


def hf_import_serve(torch, models, attention, seed: int, card: str) -> dict:
    """Phase 15b(ii): a 32-layer bf16 HF Llama at llama3-8b's widths in
    host memory, imported onto the card by `from_hf` (seconds and peak
    memory), then `LLMEngine` answers 4 requests of 16 greedy tokens, held
    to the teacher-forced `forward` as in phase 6, with each request's
    first-token logits within HF_SERVE_LOGITS_TOL of forward's."""
    import numpy as np

    from ray_tpu_torch.models.hf_convert import from_hf
    from ray_tpu_torch.serve import LLMEngine

    hf = hf_llama_config(models, 32)
    torch.cuda.empty_cache()
    sd = hf_state_dict(torch, hf, torch.bfloat16, seed + 151, device="cpu")
    sd_gib = sum(t.numel() * t.element_size() for t in sd.values()) / 2**30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = from_hf((hf, sd), name="hf-llama3-8b", param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    peak_import = torch.cuda.max_memory_allocated() / 2**30
    del sd
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 151)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (17, 60, 100, 128)]
    engine = LLMEngine(cfg, params, num_slots=4, max_len=256, prefill_buckets=(64, 128),
                       prefix_cache_size=len(prompts), seed=seed)
    try:
        attention.reset_launches()
        results, run_s = run_streams(engine, prompts, 16)
        launches = dict(attention.launches)
    finally:
        engine.shutdown()
    if any(launches.values()):
        raise AssertionError(f"15b(ii): the serving path launched {launches}")
    firsts = []

    def first_token(i, p, logits):
        # The engine's prefill logits, kept in its prefix cache.
        stored = engine._prefix_cache[tuple(p)]["logits"].reshape(-1).float()
        first = logits[len(p) - 1].float()
        firsts.append((float((stored - first).abs().max()), float(first.std())))

    agreement = forward_agreement(torch, models, engine.params, cfg, prompts,
                                  [r[0] for r in results], card, on_logits=first_token)
    del engine
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params
    torch.cuda.empty_cache()
    worst_first = max(diff / std for diff, std in firsts)
    log(f"15b(ii) [{card}]: 32-layer bf16 import of {sd_gib:.2f} GiB from host memory in "
        f"{import_s:.2f} s ({sd_gib / import_s:.2f} GiB/s; peak {peak_import:.2f} GiB on "
        f"the card), LLMEngine answered {len(prompts)} requests of 16 greedy tokens in "
        f"{run_s:.2f} s; first-token logits vs forward (max |diff|, std) {firsts}, worst "
        f"{worst_first:.3f} std (at most {HF_SERVE_LOGITS_TOL}); peak {peak:.2f} GiB")
    if worst_first > HF_SERVE_LOGITS_TOL:
        raise AssertionError(f"15b(ii): first-token logits part from forward's: {firsts}")
    return {"n_layers": 32, "checkpoint_gib": sd_gib, "import_s": import_s,
            "peak_import_gib": peak_import, "requests": len(prompts), "new_tokens": 16,
            "run_s": run_s, "ttft_ms": [r[1] for r in results], "peak_gib": peak,
            "first_token_logits": [{"max_abs_diff": d_, "std": s_} for d_, s_ in firsts],
            "teacher_forced": agreement}


def _timed(torch, fn, log_to: list):
    """`fn`, appending the ms of each call (synchronized) to `log_to`."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        log_to.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def rllib_phase(torch, seed: int, card: str) -> dict:
    """Phase 16: RLlib on the card at the JAX package's defaults (hidden
    (64, 64), 8 envs x 128 steps, PPO minibatch 256 x 4 epochs): PPO on
    CartPole for 10 iterations; two updates each of IMPALA and APPO on a
    CartPole batch and of DQN on prioritized samples of it; SAC on Pendulum
    for 3 iterations; two CQLLearner updates on a seeded batch; then one
    PPO update at fp32 on the card against the CPU's from the same
    weights, batch and permutations (within RL_CARD_CPU_TOL)."""
    import numpy as np

    from ray_tpu_torch.rllib import appo, cql, dqn, impala, ppo, sac

    out = {}
    algo = ppo.PPOConfig().environment("CartPole-v1").debugging(seed=seed).build()
    update_ms, returns = [], []
    algo.learner.update = _timed(torch, algo.learner.update, update_ms)
    t0 = time.perf_counter()
    for _ in range(10):
        returns.append(algo.train().get("episode_return_mean"))
    wall = time.perf_counter() - t0
    steps = 10 * 8 * 128
    out["ppo_cartpole"] = {"iterations": 10, "env_steps": steps,
                           "env_steps_per_s": steps / wall, "update_ms": update_ms,
                           "episode_return_mean": returns}
    batch = algo.workers[0].sample(128)["batch"]
    algo.stop()

    rng = np.random.default_rng(seed)
    for name, learner in (
            ("impala", impala.ImpalaLearner(4, 2, impala.ImpalaHyperparams(), seed=seed)),
            ("appo", appo.AppoLearner(4, 2, appo.AppoHyperparams(), seed=seed))):
        ms = []
        for _ in range(2):
            metrics = _timed(torch, learner.update, ms)(batch)
        out[name] = {"update_ms": ms, "metrics": metrics}
    buf = dqn.PrioritizedReplayBuffer(4096, seed=seed)
    buf.add_batch({"obs": batch["obs"][:, :-1].reshape(-1, 4),
                   "actions": batch["actions"][:, :-1].reshape(-1),
                   "rewards": batch["rewards"][:, :-1].reshape(-1),
                   "next_obs": batch["obs"][:, 1:].reshape(-1, 4),
                   "terminals": batch["dones"][:, :-1].reshape(-1)})
    learner, ms = dqn.DQNLearner(4, 2, dqn.DQNHyperparams(), seed=seed), []
    for _ in range(2):
        sample = buf.sample(64)
        loss, td = _timed(torch, learner.update, ms)(sample)
        buf.update_priorities(sample["batch_indexes"], td)
    out["dqn"] = {"update_ms": ms, "loss": loss}

    algo = (sac.SACConfig().environment("Pendulum-v1").training(learning_starts=1024)
            .debugging(seed=seed).build())
    ms, sac_returns = [], []
    algo.learner.update = _timed(torch, algo.learner.update, ms)
    t0 = time.perf_counter()
    for _ in range(3):
        sac_returns.append(algo.train().get("episode_return_mean"))
    out["sac_pendulum"] = {"iterations": 3, "updates": len(ms),
                           "update_ms_median": statistics.median(ms),
                           "wall_s": time.perf_counter() - t0,
                           "episode_return_mean": sac_returns}
    algo.stop()

    learner = cql.CQLLearner(3, 1, sac.SACHyperparams(act_limit=2.0), seed=seed)
    b = {"obs": rng.normal(size=(256, 3)).astype(np.float32),
         "actions": rng.uniform(-2, 2, (256, 1)).astype(np.float32),
         "rewards": rng.normal(size=256).astype(np.float32),
         "next_obs": rng.normal(size=(256, 3)).astype(np.float32),
         "terminals": np.zeros(256, np.float32)}
    ms = []
    for _ in range(2):
        metrics = _timed(torch, learner.update, ms)(b)
    out["cql"] = {"update_ms": ms, "metrics": metrics}

    on = {d: ppo.PPOLearner(4, 2, ppo.PPOHyperparams(), seed=seed, device=d)
          for d in ("cuda", "cpu")}
    on["cuda"].set_weights(on["cpu"].get_weights())
    noise = on["cpu"].draw_noise(batch)
    got = {d: learner.update(batch, noise) for d, learner in on.items()}
    w = {d: learner.get_weights() for d, learner in on.items()}
    worst = max(float(np.max(np.abs(w["cuda"][k] - w["cpu"][k]))) for k in w["cpu"])
    metric_diff = max(abs(got["cuda"][k] - got["cpu"][k]) for k in got["cpu"])
    atol, rtol = RL_CARD_CPU_TOL
    share = max([float(np.max(np.abs(w["cuda"][k] - w["cpu"][k])
                              / (atol + rtol * np.abs(w["cpu"][k])))) for k in w["cpu"]]
                + [abs(got["cuda"][k] - got["cpu"][k]) / (atol + rtol * abs(got["cpu"][k]))
                   for k in got["cpu"]])
    out["ppo_card_vs_cpu"] = {"params_max_diff": worst, "metrics_max_diff": metric_diff,
                              "tolerance_share": share}
    log(f"16 [{card}]: PPO CartPole 10 iterations: {steps / wall:.0f} env steps/s, "
        f"update {statistics.median(update_ms):.2f} ms median, returns {returns}; "
        f"IMPALA {out['impala']['update_ms'][-1]:.2f} ms, APPO "
        f"{out['appo']['update_ms'][-1]:.2f} ms, DQN {out['dqn']['update_ms'][-1]:.2f} ms, "
        f"SAC {out['sac_pendulum']['update_ms_median']:.2f} ms median over "
        f"{out['sac_pendulum']['updates']} updates (returns {sac_returns}), CQL "
        f"{out['cql']['update_ms'][-1]:.2f} ms an update; PPO card vs CPU: params "
        f"{worst:.3g}, metrics {metric_diff:.3g}, {share:.3g} of the tolerance")
    finite = [*out["impala"]["metrics"].values(), *out["appo"]["metrics"].values(),
              *out["cql"]["metrics"].values(), out["dqn"]["loss"]]
    if not all(math.isfinite(v) for v in finite) or not out["sac_pendulum"]["updates"]:
        raise AssertionError(f"16: non-finite learner metrics or no SAC update: {out}")
    if share > 1.0:
        raise AssertionError(f"16: the PPO update parts card vs CPU: {worst}, {metric_diff}")
    return out


def _finite(metrics) -> bool:
    return all(math.isfinite(v) for m in metrics for v in m.values())


def dreamer_runs(torch, dreamerv3, seed: int, card: str) -> tuple:
    """Phase 17(a)-(b): DreamerV3 at its config's defaults on CartPole for
    8 iterations and on Pendulum for 3; returns the readings and the
    CartPole algorithm (its replay and trained state feed 17c)."""
    out, algos = {}, {}
    for name, env, iters in (("cartpole", "CartPole-v1", 8), ("pendulum", "Pendulum-v1", 3)):
        algo = dreamerv3.DreamerV3Config().environment(env).debugging(seed=seed).build()
        update_ms, step_ms, metrics = [], [], []
        algo.learner.update = _timed(torch, algo.learner.update, update_ms)
        algo._policy_step = _timed(torch, algo._policy_step, step_ms)
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics.append(algo.train())
        wall = time.perf_counter() - t0
        out[name] = {"iterations": iters, "env_steps": algo._env_steps,
                     "env_steps_per_s": algo._env_steps / wall, "wall_s": wall,
                     "updates": len(update_ms),
                     "update_ms_median": statistics.median(update_ms),
                     "policy_step_ms_median": statistics.median(step_ms),
                     "episode_return_mean": [m.get("episode_return_mean") for m in metrics],
                     "last": metrics[-1]}
        if not update_ms or not _finite(metrics):
            raise AssertionError(f"17 {name}: no update or non-finite metrics: {metrics}")
        log(f"17 [{card}]: DreamerV3 {env} {iters} iterations: "
            f"{out[name]['env_steps_per_s']:.0f} env steps/s, update "
            f"{out[name]['update_ms_median']:.2f} ms median over {len(update_ms)}, policy "
            f"step {out[name]['policy_step_ms_median']:.3f} ms median over {len(step_ms)}")
        algos[name] = algo
    return out, algos["cartpole"]


def dreamer_card_vs_cpu(torch, dreamerv3, algo, card: str) -> dict:
    """Phase 17(c): one DreamerV3 update at fp32 on the card against the CPU,
    from 17a's trained state (its noise generator aside), on a batch of its
    replay and the same noise (see DREAMER_TIE_GAP)."""
    import numpy as np

    start = {k: v for k, v in algo.learner.get_state().items() if k != "rng"}
    hp, spec = algo.learner.hp, algo.act_spec
    source = dreamerv3.DreamerV3Learner(algo.env.obs_dim, spec, hp, device="cpu")

    def learner(device):
        out = dreamerv3.DreamerV3Learner(algo.env.obs_dim, spec, hp, device=device)
        out.set_state(start)
        return out

    categorical, skipped = dreamerv3._categorical, []
    for _ in range(DREAMER_TIE_DRAWS):
        batch = algo.replay.sample(hp.batch_size, hp.batch_length)
        noise = source.draw_noise(batch)
        gaps = []

        def recorded(logits, gumbel):
            top = (logits + gumbel).topk(2, -1).values
            gaps.append(float((top[..., 0] - top[..., 1]).min().detach()))
            return categorical(logits, gumbel)

        cpu = learner("cpu")
        dreamerv3._categorical = recorded
        try:
            got_cpu = cpu.update(batch, noise)
        finally:
            dreamerv3._categorical = categorical
        if min(gaps) > DREAMER_TIE_GAP:
            break
        skipped.append(min(gaps))
    else:
        raise AssertionError(f"17c: every draw had a sample tie: {skipped}")
    on_card = learner("cuda")
    got_card = on_card.update(batch, noise)
    atol, rtol = RL_CARD_CPU_TOL
    share, worst = 0.0, {}

    def hold(name, got, want):
        nonlocal share
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        diff = np.abs(got - want)
        worst[name] = max(worst.get(name, 0.0), float(diff.max()))
        share = max(share, float((diff / (atol + rtol * np.abs(want))).max()))

    card_state, cpu_state = on_card.get_state(), cpu.get_state()
    for tree in ("wm_params", "actor_params", "critic_params", "slow_critic"):
        for k, v in cpu_state[tree].items():
            hold(tree, card_state[tree][k], v)
    for opt in ("wm_opt", "actor_opt", "critic_opt"):
        if card_state[opt]["count"] != cpu_state[opt]["count"]:
            raise AssertionError(f"17c: {opt} counts part")
        for moment in ("mu", "nu"):
            for k, v in cpu_state[opt][moment].items():
                hold(f"{opt}/{moment}", card_state[opt][moment][k], v)
    hold("return_scale", card_state["return_scale"], cpu_state["return_scale"])
    for k, v in got_cpu.items():
        hold("metrics", got_card[k], v)
    out = {"draws_skipped_for_ties": skipped, "min_gap": min(gaps),
           "max_abs_diff": worst, "tolerance_share": share,
           "metrics_card": got_card, "metrics_cpu": got_cpu}
    log(f"17c [{card}]: DreamerV3 update card vs CPU: {share:.3g} of the tolerance "
        f"(worst |diff| {max(worst.values()):.3g}; {len(skipped)} draws skipped for "
        f"ties, min gap {min(gaps):.3g})")
    if share > 1.0:
        raise AssertionError(f"17c: the DreamerV3 update parts card vs CPU: {worst}")
    return out


def offline_learners(torch, seed: int, card: str) -> dict:
    """Phase 17(d): PPO's CartPole rollouts (4 iterations at its defaults)
    recorded as JSON shards, read back here, and 10 updates each of
    BCLearner and MARWILLearner (BCConfig's lr and batch of 256 rows)."""
    import shutil
    import tempfile

    import numpy as np

    from ray_tpu_torch.rllib import offline, ppo

    algo = ppo.PPOConfig().environment("CartPole-v1").debugging(seed=seed).build()
    path = tempfile.mkdtemp(prefix="rtt_offline_")
    try:
        offline.record_rollouts(algo, path, num_iterations=4, fmt="json")
        rows = []
        for name in sorted(os.listdir(path)):
            with open(os.path.join(path, name)) as f:
                rows += [json.loads(line) for line in f]
    finally:
        shutil.rmtree(path, ignore_errors=True)
        algo.stop()
    data = offline._columnar(rows)
    obs, actions = data["obs"], data["actions"].astype(np.int64)
    returns = offline.discounted_returns(data["rewards"].astype(np.float32),
                                         data["dones"].astype(bool), 0.99)
    cfg = offline.MARWILConfig()
    rng = np.random.default_rng(seed)
    bc = offline.BCLearner(4, 2, cfg.lr, seed=seed)
    marwil = offline.MARWILLearner(4, 2, cfg.lr, beta=cfg.beta, vf_coeff=cfg.vf_coeff,
                                   seed=seed)
    bc_ms, marwil_ms, bc_loss, marwil_m = [], [], [], []
    for _ in range(10):
        idx = rng.integers(0, len(obs), cfg.train_batch_size)
        bc_loss.append(_timed(torch, bc.update, bc_ms)(obs[idx], actions[idx]))
        marwil_m.append(_timed(torch, marwil.update, marwil_ms)(
            obs[idx], actions[idx], returns[idx]))
    out = {"rows": len(rows), "bc_update_ms": bc_ms, "marwil_update_ms": marwil_ms,
           "bc_loss": bc_loss, "marwil_last": marwil_m[-1]}
    if len(rows) != 4 * 8 * 128 or not _finite(marwil_m + [{"bc": v} for v in bc_loss]):
        raise AssertionError(f"17d: rows or non-finite offline losses: {out}")
    log(f"17d [{card}]: {len(rows)} recorded rows; BC update "
        f"{statistics.median(bc_ms):.2f} ms median, MARWIL "
        f"{statistics.median(marwil_ms):.2f} ms median (10 each)")
    return out


def dreamer_and_offline_phase(torch, seed: int, card: str) -> dict:
    """Phase 17: DreamerV3 (a, b), its update card vs CPU (c), and the
    offline learners on recorded rollouts (d)."""
    from ray_tpu_torch.rllib import dreamerv3

    runs, algo = dreamer_runs(torch, dreamerv3, seed, card)
    return {**runs, "card_vs_cpu": dreamer_card_vs_cpu(torch, dreamerv3, algo, card),
            "offline": offline_learners(torch, seed, card)}


def _sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


class Bench350mTrainer:
    """Phase 18a's actor (made remote with num_gpus=1): phase 4's train step
    on a state of its own, initialised from the same seed as the direct one."""

    def __init__(self, cfg, seed: int, device: str):
        import torch

        from ray_tpu_torch import models

        init_fn, self._step = bench_train_step(models, cfg, device)
        self.state = init_fn(torch.Generator(device=device).manual_seed(seed))

    def step(self, tokens) -> tuple:
        """(loss, ms to enqueue the step on this actor's thread)."""
        t0 = time.perf_counter()
        self.state, metrics = self._step(self.state, {"tokens": tokens})
        host_ms = (time.perf_counter() - t0) * 1e3
        return float(metrics["loss"]), host_ms

    def params(self) -> dict:
        return self.state.params


def actor_train_turns(torch, models, attention, rt, steps: int, seed: int, card: str,
                      cfg=None, batch: int = 8, seq: int = 2048,
                      device: str = "cuda") -> tuple:
    """Phase 18a: phase 4's train step inside a num_gpus=1 actor, in turns
    with the direct step on a state of its own from the same seed, on phase
    4's batches. Returns (results, the actor)."""
    import numpy as np

    cfg = cfg or models.configs.BENCH_350M
    init_fn, step_fn = bench_train_step(models, cfg, device)
    state = init_fn(torch.Generator(device=device).manual_seed(seed))
    actor = rt.remote(num_gpus=1)(Bench350mTrainer).remote(cfg, seed, device)
    corpus = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (steps, batch, seq + 1), dtype=np.int32))
    if device == "cuda":
        corpus = corpus.pin_memory()
    per_step = 1 if device == "cuda" else 0  # the plain versions count nothing
    expected = {"fa_fwd": 2 * cfg.n_layers * per_step,
                "fa_bwd_dq": cfg.n_layers * per_step, "fa_bwd_dkv": cfg.n_layers * per_step}

    def direct(tokens) -> tuple:
        nonlocal state
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens})
        host_ms = (time.perf_counter() - t0) * 1e3
        return float(metrics["loss"]), host_ms

    def via_actor(tokens) -> tuple:
        return rt.get(actor.step.remote(tokens))

    runs = {who: {"losses": [], "step_ms": [], "host_ms": [], "launches_per_step": []}
            for who in ("direct", "actor")}
    attention.reset_launches()
    for i in range(steps):
        tokens = corpus[i].to(device)
        for who in (("direct", "actor") if i % 2 == 0 else ("actor", "direct")):
            seen = dict(attention.launches)
            _sync(torch, device)
            t0 = time.perf_counter()
            loss, host_ms = (direct if who == "direct" else via_actor)(tokens)
            _sync(torch, device)
            run = runs[who]
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
            run["host_ms"].append(host_ms)
            run["losses"].append(loss)
            run["launches_per_step"].append(
                {n: attention.launches[n] - seen[n] for n in seen})
        d, a = runs["direct"], runs["actor"]
        log(f"18a step {i}: loss {d['losses'][i]:.6f} direct {d['step_ms'][i]:.1f} ms "
            f"(host {d['host_ms'][i]:.1f}), actor {a['step_ms'][i]:.1f} ms (host "
            f"{a['host_ms'][i]:.1f}); actor launches {a['launches_per_step'][i]}")
        if a["losses"][i] != d["losses"][i] or not math.isfinite(d["losses"][i]):
            raise AssertionError(f"18a step {i}: the actor's loss {a['losses'][i]!r} is "
                                 f"not the direct step's {d['losses'][i]!r}")
        for who, run in runs.items():
            if run["launches_per_step"][i] != expected:
                raise AssertionError(f"18a step {i}: {who} launches "
                                     f"{run['launches_per_step'][i]} != {expected}")
    total = dict(attention.launches)
    out = {"config": cfg.name, "batch": batch, "seq": seq, "steps": steps, **runs}
    for who, run in runs.items():
        run["launches"] = {n: sum(c[n] for c in run["launches_per_step"]) for n in total}
        run["median_step_ms"] = statistics.median(run["step_ms"][1:] or run["step_ms"])
        run["median_host_ms"] = statistics.median(run["host_ms"][1:] or run["host_ms"])
    if total != {n: runs["direct"]["launches"][n] + runs["actor"]["launches"][n]
                 for n in total}:
        raise AssertionError(f"18a: launches outside the steps: {total}")
    pairs = [a - d for a, d in zip(runs["actor"]["step_ms"][1:], runs["direct"]["step_ms"][1:])]
    out["launches"] = runs["actor"]["launches"]
    out["runtime_adds_ms"] = runs["actor"]["median_step_ms"] - runs["direct"]["median_step_ms"]
    out["runtime_adds_ms_paired_median"] = statistics.median(pairs) if pairs else None
    log(f"18a [{card}]: {cfg.name} {batch} x {seq}, {steps} steps in turns, losses "
        f"bit-equal: direct {runs['direct']['median_step_ms']:.2f} ms median (host "
        f"{runs['direct']['median_host_ms']:.2f}), actor {runs['actor']['median_step_ms']:.2f} "
        f"ms (host {runs['actor']['median_host_ms']:.2f}); the runtime adds "
        f"{out['runtime_adds_ms']:.3f} ms a step (paired median "
        f"{out['runtime_adds_ms_paired_median']}); actor launches {out['launches']}")
    return out, actor


def put_get_params(torch, models, rt, actor, card: str, device: str = "cuda") -> dict:
    """Phase 18b: the actor's params fetched from it (through the store),
    then `put` and `get` in this process; bit-equal, on the card's device 0."""
    from ray_tpu_torch.core import serialization

    t0 = time.perf_counter()
    params = rt.get(actor.params.remote())
    _sync(torch, device)
    fetch_s = time.perf_counter() - t0
    leaves = models.training.tree_leaves(params)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    t0 = time.perf_counter()
    ref = rt.put(params)
    put_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = rt.get(ref)
    _sync(torch, device)
    get_s = time.perf_counter() - t0
    want = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    got = models.training.tree_leaves(back)
    bad = [i for i, (g, p) in enumerate(zip(got, leaves))
           if g.device != want or g.dtype != p.dtype or not torch.equal(g, p)]
    del back, ref
    # The put's two parts: pickling (each tensor's copy to the host) and
    # the store's one contiguous payload.
    t0 = time.perf_counter()
    meta, buffers = serialization.serialize(params)
    serialize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serialization.concat(meta, buffers)
    concat_s = time.perf_counter() - t0
    del buffers
    gib = nbytes / 2**30
    out = {"params": sum(t.numel() for t in leaves), "bytes": nbytes, "leaves": len(leaves),
           "fetch_s": fetch_s, "put_s": put_s, "get_s": get_s,
           "put_gib_per_s": gib / put_s, "get_gib_per_s": gib / get_s,
           "put_serialize_s": serialize_s, "put_concat_s": concat_s}
    log(f"18b [{card}]: {out['params'] / 1e6:.1f} M params ({gib:.3f} GiB, {len(leaves)} "
        f"tensors): fetched from the actor in {fetch_s * 1e3:.1f} ms, put "
        f"{put_s * 1e3:.1f} ms ({out['put_gib_per_s']:.2f} GiB/s; apart: pickling with "
        f"the host copies {serialize_s * 1e3:.1f} ms, the payload {concat_s * 1e3:.1f} ms), "
        f"get {get_s * 1e3:.1f} ms ({out['get_gib_per_s']:.2f} GiB/s), bit-equal on {want}")
    if bad or len(got) != len(leaves):
        raise AssertionError(f"18b: {len(bad)} tensors came back changed or elsewhere")
    return out


def gpu_resources(torch, card: str) -> dict:
    """Phase 18c: the node's resources as the multi-process runtime's node
    daemon will read them, through the time-boxed GPU probe."""
    from ray_tpu_torch.core.distributed import resources

    t0 = time.perf_counter()
    res = resources.detect_node_resources()
    probe_s = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    types = [k.split(":", 1)[1] for k in res if k.startswith("accelerator_type:")]
    out = {"resources": res, "probe_s": probe_s, "probe": resources.probe_gpus(),
           "device_name": name}
    log(f"18c [{card}]: detect_node_resources() {res} in {probe_s:.2f} s (the probe's "
        f"child process)")
    if res.get("GPU") != 1.0 or len(types) != 1 or types[0] not in name:
        raise AssertionError(f"18c: resources {res} do not show one {name}")
    return out


def _tolerance_share(got: dict, want: dict, tol) -> float:
    """The largest share of atol + rtol*|want| any element of two flat
    dicts of arrays (or floats) takes."""
    import numpy as np

    atol, rtol = tol
    return max(float(np.max(np.abs(np.asarray(got[k]) - np.asarray(want[k]))
                            / (atol + rtol * np.abs(np.asarray(want[k])))))
               for k in want)


def remote_ppo(torch, rt, seed: int, card: str, device: str = "cuda",
               iterations: int = 5, label: str = "18d") -> dict:
    """Phase 18d: PPO on CartPole at the JAX defaults, 2 remote env runners
    and 2 remote learner actors, in turns with phase 16's local PPO; then
    one remote-learner update card against CPU."""
    from ray_tpu_torch.rllib import ppo

    def config(dev: str, remote: bool, **evaluation):
        c = (ppo.PPOConfig().environment("CartPole-v1").debugging(seed=seed)
             .resources(device=dev))
        if remote:
            c = c.env_runners(num_env_runners=2).learners(num_learners=2,
                                                          remote_learners=True)
        return c.evaluation(**evaluation)

    algos = {"local": config(device, False).build(), "remote": config(device, True).build()}
    ms = {who: [] for who in algos}
    returns = {who: [] for who in algos}
    for i in range(iterations):
        for who in (("local", "remote") if i % 2 == 0 else ("remote", "local")):
            _sync(torch, device)
            t0 = time.perf_counter()
            m = algos[who].train()
            _sync(torch, device)
            ms[who].append((time.perf_counter() - t0) * 1e3)
            returns[who].append(m.get("episode_return_mean"))
            if not all(math.isfinite(v) for k, v in m.items() if "loss" in k):
                raise AssertionError(f"{label}: {who} PPO metrics not finite: {m}")
    out = {}
    for who, algo in algos.items():
        cfg = algo.config
        steps = max(1, cfg.num_env_runners) * cfg.num_envs_per_env_runner * \
            cfg.rollout_fragment_length
        out[who] = {"iterations": iterations, "env_steps_per_iteration": steps,
                    "iteration_ms": ms[who], "median_iteration_ms": statistics.median(ms[who]),
                    "env_steps_per_s": steps * iterations / (sum(ms[who]) / 1e3),
                    # The first iteration also starts the actors (in
                    # worker processes: CUDA and the imports).
                    "env_steps_per_s_after_first":
                        steps * (iterations - 1) / (sum(ms[who][1:]) / 1e3),
                    "episode_return_mean": returns[who]}
        algo.stop()

    # Card against CPU: the CPU algorithm's runners sample one batch; both
    # learner groups update on it under the same permutations for each
    # actor's shard, then broadcast; greedy evaluation on the remote
    # evaluation runner must return the same episodes.
    pair = {d: config(d, True, evaluation_num_env_runners=1, evaluation_duration=4).build()
            for d in (device, "cpu")}
    pair[device].set_weights(pair["cpu"].get_weights())
    batch, _ = pair["cpu"]._sample_rollouts()
    drawer = ppo.PPOLearner(4, 2, pair["cpu"].config.hyperparams(), seed=seed, device="cpu")
    noise = [drawer.draw_noise(shard) for shard in pair["cpu"].learner._split(batch)]
    metrics = {d: algo.learner.update(batch, noise) for d, algo in pair.items()}
    for algo in pair.values():
        algo._broadcast_weights()
    state = {d: algo.learner.get_state() for d, algo in pair.items()}
    evals = {d: algo.evaluate() for d, algo in pair.items()}
    for algo in pair.values():
        algo.stop()
    dev, cpu = state[device], state["cpu"]
    share = max(_tolerance_share(dev["params"], cpu["params"], RL_CARD_CPU_TOL),
                _tolerance_share(dev["opt_state"]["mu"], cpu["opt_state"]["mu"],
                                 RL_CARD_CPU_TOL),
                _tolerance_share(dev["opt_state"]["nu"], cpu["opt_state"]["nu"],
                                 RL_CARD_CPU_TOL),
                _tolerance_share(metrics[device], metrics["cpu"], RL_CARD_CPU_TOL))
    worst = max(float(abs(dev["params"][k] - cpu["params"][k]).max()) for k in cpu["params"])
    out["card_vs_cpu"] = {"tolerance_share": share, "params_max_diff": worst,
                          "metrics": metrics, "evaluation": evals,
                          "batch_rows": int(batch["rewards"].size)}
    log(f"{label} [{card}]: PPO CartPole, {iterations} iterations each in turns: local "
        f"{out['local']['env_steps_per_s']:.0f} env steps/s, "
        f"{out['local']['median_iteration_ms']:.1f} ms an iteration; 2 remote runners + 2 "
        f"remote learners {out['remote']['env_steps_per_s']:.0f} env steps/s, "
        f"{out['remote']['median_iteration_ms']:.1f} ms an iteration; remote update card "
        f"vs CPU {share:.3g} of RL_CARD_CPU_TOL (params {worst:.3g}), greedy returns "
        f"{evals[device]} / {evals['cpu']}")
    if share > 1.0 or dev["opt_state"]["count"] != cpu["opt_state"]["count"]:
        raise AssertionError(f"{label}: the remote update parts card vs CPU: {share}")
    if evals[device] != evals["cpu"]:
        raise AssertionError(f"{label}: greedy evaluation parts card vs CPU: {evals}")
    return out


def runtime_phase(torch, models, attention, steps: int, seed: int, card: str) -> dict:
    """Phase 18: the task/actor core on the card (a-d), on the in-process
    engine, shut down at the end."""
    import ray_tpu_torch as rt

    rt.init(local_mode=True)
    try:
        train, actor = actor_train_turns(torch, models, attention, rt, steps, seed, card)
        store = put_get_params(torch, models, rt, actor, card)
        rt.kill(actor)
        return {"actor_train": train, "put_get": store,
                "resources": gpu_resources(torch, card),
                "ppo": remote_ppo(torch, rt, seed, card)}
    finally:
        rt.shutdown()


class WorkerBench350mTrainer(Bench350mTrainer):
    """Phase 19b's actor: Bench350mTrainer in a worker process of the
    cluster, counting its own kernel launches and timing the store from its
    side."""

    def reset_launches(self) -> None:
        from ray_tpu_torch.ops import attention

        attention.reset_launches()

    def launches(self) -> dict:
        from ray_tpu_torch.ops import attention

        return dict(attention.launches)

    def step_counted(self, tokens) -> tuple:
        """(loss, host ms, this step's launches in this process)."""
        from ray_tpu_torch.ops import attention

        seen = dict(attention.launches)
        loss, host_ms = self.step(tokens)
        return loss, host_ms, {n: attention.launches[n] - seen[n] for n in seen}

    def whereabouts(self) -> dict:
        import torch

        from ray_tpu_torch import models
        from ray_tpu_torch.core.distributed import worker_main

        leaves = models.training.tree_leaves(self.state.params)
        return {"pid": os.getpid(), "started_by": worker_main.STARTED_BY,
                "torch_at_boot": worker_main.TORCH_AT_BOOT,
                "device": str(leaves[0].device) if leaves else None,
                "cuda_devices": torch.cuda.device_count(),
                "foreign_modules": sorted(m for m in sys.modules if m.split(".")[0]
                                          in ("jax", "jaxlib", "ray_tpu"))}

    def put_params(self) -> tuple:
        """([a ref to the params], the put's seconds) from this process."""
        import torch

        import ray_tpu_torch as rt

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = rt.put(self.state.params)
        return [ref], time.perf_counter() - t0

    def get_params(self, refs) -> tuple:
        """(the get's seconds, tensors that differ from this actor's own
        params or lie elsewhere) for params another process put."""
        import torch

        import ray_tpu_torch as rt
        from ray_tpu_torch import models

        t0 = time.perf_counter()
        got = rt.get(refs[0])
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        get_s = time.perf_counter() - t0
        mine = models.training.tree_leaves(self.state.params)
        back = models.training.tree_leaves(got)
        bad = sum(1 for g, p in zip(back, mine)
                  if g.device != p.device or g.dtype != p.dtype or not torch.equal(g, p))
        return get_s, bad + abs(len(back) - len(mine))


def cluster_train_turns(torch, models, attention, rt, steps: int, seed: int, card: str,
                        cfg=None, batch: int = 8, seq: int = 2048,
                        device: str = "cuda") -> tuple:
    """Phase 19b: phase 4's train step inside a num_gpus=1 actor in a worker
    process, in turns with the direct step here on a state of its own from
    the same seed, on phase 4's batches. The worker's launch counters are
    its own and come back from the actor. Returns (results, the actor, the
    direct step's state)."""
    import numpy as np

    cfg = cfg or models.configs.BENCH_350M
    init_fn, step_fn = bench_train_step(models, cfg, device)
    state = init_fn(torch.Generator(device=device).manual_seed(seed))
    t0 = time.perf_counter()
    actor = rt.remote(num_gpus=1)(WorkerBench350mTrainer).remote(cfg, seed, device)
    where = rt.get(actor.whereabouts.remote(), timeout=600)
    where["ready_s"] = time.perf_counter() - t0
    corpus = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (steps, batch, seq + 1), dtype=np.int32))
    if device == "cuda":
        corpus = corpus.pin_memory()
    per_step = 1 if device == "cuda" else 0  # the plain versions count nothing
    expected = {"fa_fwd": 2 * cfg.n_layers * per_step,
                "fa_bwd_dq": cfg.n_layers * per_step, "fa_bwd_dkv": cfg.n_layers * per_step}

    def direct(tokens) -> tuple:
        nonlocal state
        seen = dict(attention.launches)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens})
        host_ms = (time.perf_counter() - t0) * 1e3
        loss = float(metrics["loss"])
        return loss, host_ms, {n: attention.launches[n] - seen[n] for n in seen}

    def via_actor(tokens) -> tuple:
        return rt.get(actor.step_counted.remote(tokens))

    runs = {who: {"losses": [], "step_ms": [], "host_ms": [], "launches_per_step": []}
            for who in ("direct", "actor")}
    attention.reset_launches()
    rt.get(actor.reset_launches.remote())
    for i in range(steps):
        tokens = corpus[i].to(device)
        for who in (("direct", "actor") if i % 2 == 0 else ("actor", "direct")):
            _sync(torch, device)
            t0 = time.perf_counter()
            loss, host_ms, launched = (direct if who == "direct" else via_actor)(tokens)
            _sync(torch, device)
            run = runs[who]
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
            run["host_ms"].append(host_ms)
            run["losses"].append(loss)
            run["launches_per_step"].append(launched)
        d, a = runs["direct"], runs["actor"]
        log(f"19b step {i}: loss {d['losses'][i]:.6f} direct {d['step_ms'][i]:.1f} ms "
            f"(host {d['host_ms'][i]:.1f}), worker actor {a['step_ms'][i]:.1f} ms (host "
            f"{a['host_ms'][i]:.1f}); worker launches {a['launches_per_step'][i]}")
        if a["losses"][i] != d["losses"][i] or not math.isfinite(d["losses"][i]):
            raise AssertionError(f"19b step {i}: the worker actor's loss {a['losses'][i]!r} "
                                 f"is not the direct step's {d['losses'][i]!r}")
        for who, run in runs.items():
            if run["launches_per_step"][i] != expected:
                raise AssertionError(f"19b step {i}: {who} launches "
                                     f"{run['launches_per_step'][i]} != {expected}")
    totals = {"direct": dict(attention.launches), "actor": rt.get(actor.launches.remote())}
    out = {"config": cfg.name, "batch": batch, "seq": seq, "steps": steps,
           "worker": where, **runs}
    for who, run in runs.items():
        run["launches"] = {n: sum(c[n] for c in run["launches_per_step"])
                           for n in totals[who]}
        if totals[who] != run["launches"]:
            raise AssertionError(f"19b: {who} launches outside the steps: {totals[who]}")
        run["median_step_ms"] = statistics.median(run["step_ms"][1:] or run["step_ms"])
        run["median_host_ms"] = statistics.median(run["host_ms"][1:] or run["host_ms"])
    pairs = [a - d for a, d in zip(runs["actor"]["step_ms"][1:], runs["direct"]["step_ms"][1:])]
    out["launches"] = runs["actor"]["launches"]
    out["runtime_adds_ms"] = runs["actor"]["median_step_ms"] - runs["direct"]["median_step_ms"]
    out["runtime_adds_ms_paired_median"] = statistics.median(pairs) if pairs else None
    if where["foreign_modules"] or where["device"] != (
            "cuda:0" if device == "cuda" else "cpu"):
        raise AssertionError(f"19b: the worker actor is not what it should be: {where}")
    log(f"19b [{card}]: {cfg.name} {batch} x {seq}, {steps} steps in turns, the actor in "
        f"worker process {where['pid']} ({where['started_by']}: "
        f"{'forked by the zygote' if where['started_by'] == 'zygote' else 'cold-spawned'}, "
        f"torch loaded at boot: {where['torch_at_boot']}; ready in "
        f"{where['ready_s']:.2f} s), "
        f"losses bit-equal: direct {runs['direct']['median_step_ms']:.2f} ms median (host "
        f"{runs['direct']['median_host_ms']:.2f}), worker actor "
        f"{runs['actor']['median_step_ms']:.2f} ms (host "
        f"{runs['actor']['median_host_ms']:.2f}); the runtime adds "
        f"{out['runtime_adds_ms']:.3f} ms a step (paired median "
        f"{out['runtime_adds_ms_paired_median']}); worker launches {out['launches']}")
    return out, actor, state


def cluster_put_get(torch, models, rt, actor, direct_params, card: str,
                    device: str = "cuda") -> dict:
    """Phase 19c: the worker actor's params `put` in its process and `get`
    here, then `put` here and `get` there; each end bit-equal (here to the
    direct step's params, which the same steps made; there to the actor's
    own), on cuda:0."""
    refs, worker_put_s = rt.get(actor.put_params.remote())
    t0 = time.perf_counter()
    params = rt.get(refs[0])
    _sync(torch, device)
    get_s = time.perf_counter() - t0
    leaves = models.training.tree_leaves(params)
    want = models.training.tree_leaves(direct_params)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    bad_here = sum(1 for g, p in zip(leaves, want)
                   if g.device != dev or g.dtype != p.dtype or not torch.equal(g, p))
    del refs
    t0 = time.perf_counter()
    ref = rt.put(params)
    put_s = time.perf_counter() - t0
    worker_get_s, bad_there = rt.get(actor.get_params.remote([ref]))
    del ref, params
    gib = nbytes / 2**30
    out = {"params": sum(t.numel() for t in leaves), "bytes": nbytes, "leaves": len(leaves),
           "worker_put_s": worker_put_s, "driver_get_s": get_s,
           "driver_put_s": put_s, "worker_get_s": worker_get_s,
           "worker_to_driver": {"put_gib_per_s": gib / worker_put_s,
                                "get_gib_per_s": gib / get_s},
           "driver_to_worker": {"put_gib_per_s": gib / put_s,
                                "get_gib_per_s": gib / worker_get_s}}
    log(f"19c [{card}]: {out['params'] / 1e6:.1f} M params ({gib:.3f} GiB, {len(leaves)} "
        f"tensors): worker put {worker_put_s * 1e3:.1f} ms "
        f"({out['worker_to_driver']['put_gib_per_s']:.2f} GiB/s), get here "
        f"{get_s * 1e3:.1f} ms ({out['worker_to_driver']['get_gib_per_s']:.2f} GiB/s); put "
        f"here {put_s * 1e3:.1f} ms ({out['driver_to_worker']['put_gib_per_s']:.2f} GiB/s), "
        f"worker get {worker_get_s * 1e3:.1f} ms "
        f"({out['driver_to_worker']['get_gib_per_s']:.2f} GiB/s); bit-equal on {dev}")
    if bad_here or bad_there or len(leaves) != len(want):
        raise AssertionError(f"19c: {bad_here} tensors here and {bad_there} in the worker "
                             f"came back changed or elsewhere")
    return out


class _Echo:
    """Phase 19d's actor: one method that does nothing."""

    def ping(self):
        return None


def _noop():
    return None


def round_trips(rt, n: int = 1000) -> dict:
    """Phase 19d: the median round trip (submit and get) of a task and of an
    actor call that do nothing, in microseconds, over `n` of each."""
    task = rt.remote(_noop)
    actor = rt.remote(_Echo).remote()
    out = {}
    for what, call in (("task_us", lambda: task.remote()),
                       ("actor_call_us", lambda: actor.ping.remote())):
        for _ in range(20):
            rt.get(call())
        us = []
        for _ in range(n):
            t0 = time.perf_counter()
            rt.get(call())
            us.append((time.perf_counter() - t0) * 1e6)
        out[what] = statistics.median(us)
        out[what.replace("_us", "_p99_us")] = sorted(us)[int(0.99 * (n - 1))]
    rt.kill(actor)
    return out


def _host_state(torch) -> dict:
    """This process's threads, the container's pids and memory, and the
    card's free memory: what a runtime's fresh processes start with."""
    import threading

    out = {"threads": threading.active_count(),
           "os_threads": len(os.listdir("/proc/self/task"))}
    for name in ("pids.current", "pids.max", "memory.current", "memory.max"):
        for root in ("/sys/fs/cgroup", "/sys/fs/cgroup/pids", "/sys/fs/cgroup/memory"):
            try:
                with open(os.path.join(root, name)) as f:
                    out[name] = f.read().strip()
                break
            except OSError:
                continue
    try:
        import psutil

        vm = psutil.virtual_memory()
        out["host_available_gib"] = vm.available / 2**30
    except ImportError:
        pass
    if torch.cuda.is_available():
        free, total = torch.cuda.mem_get_info()
        out["card_free_gib"] = free / 2**30
    return out


def _dump_node_logs(rt, lines: int = 25) -> None:
    """The tail of every log file of this cluster's node (the zygote's, the
    workers'), and its processes, printed for a failure."""
    import subprocess

    from ray_tpu_torch.util.profiling import node_log_dir

    try:
        node_ids = [rt.api._worker.node_id]
    except Exception:  # noqa: BLE001 the runtime may be gone
        node_ids = []
    log_root = os.path.dirname(node_log_dir("x" * 12))
    if os.path.isdir(log_root) and not node_ids:
        node_ids = os.listdir(log_root)
    for node_id in node_ids:
        d = node_log_dir(node_id)
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            if name.endswith((".log", ".err", ".out")):
                with open(os.path.join(d, name), errors="replace") as f:
                    tail = f.readlines()[-lines:]
                log(f"--- {d}/{name} (last {len(tail)} lines)\n" + "".join(tail))
    ps = subprocess.run(["ps", "-eo", "pid,ppid,stat,etime,rss,nlwp,args"],
                        capture_output=True, text=True).stdout
    log("--- processes\n" + "\n".join(l for l in ps.splitlines()
                                        if "ray_tpu_torch.core" in l or "PID" in l))


def cluster_phase(torch, models, attention, steps: int, seed: int, card: str,
                  cfg=None, batch: int = 8, seq: int = 2048, device: str = "cuda",
                  num_cpus: int = 16, trips: int = 1000) -> dict:
    """Phase 19: the multi-process runtime on one host (a-e), shut down at
    the end; then 19d's round trips on the in-process engine beside it.
    `num_cpus` is the logical CPU count: 19e's card-vs-CPU pair holds ten
    actors of one CPU at once."""
    import ray_tpu_torch as rt

    host = _host_state(torch)
    log(f"19 [{card}]: host before init: {host}")
    t0 = time.perf_counter()
    rt.init(num_cpus=num_cpus, num_gpus=None if device == "cuda" else 1)
    init_s = time.perf_counter() - t0
    out = {"host": host}
    try:
        res = rt.cluster_resources()
        types = [k.split(":", 1)[1] for k in res if k.startswith("accelerator_type:")]
        out["init"] = {"seconds": init_s, "cluster_resources": res,
                       "nodes": len(rt.nodes())}
        log(f"19a [{card}]: ray_tpu_torch.init(num_cpus={num_cpus}) {init_s:.2f} s (GCS, "
            f"node daemon with its GPU probe, zygote), cluster_resources() {res}")
        if res.get("GPU") != 1.0 or (device == "cuda" and (
                len(types) != 1 or types[0] not in torch.cuda.get_device_name(0))):
            raise AssertionError(f"19a: cluster_resources {res} do not show one card")
        train, actor, state = cluster_train_turns(torch, models, attention, rt, steps, seed,
                                                  card, cfg=cfg, batch=batch, seq=seq,
                                                  device=device)
        out["actor_train"] = train
        out["put_get"] = cluster_put_get(torch, models, rt, actor, state.params, card,
                                         device=device)
        rt.kill(actor)
        del state
        if device == "cuda":
            torch.cuda.empty_cache()
        out["round_trips"] = {"cluster": round_trips(rt, trips)}
        out["ppo"] = remote_ppo(torch, rt, seed, card, device=device, label="19e")
    except BaseException:
        log(f"19 [{card}]: failed; host now: {_host_state(torch)}")
        _dump_node_logs(rt)
        raise
    finally:
        rt.shutdown()
    rt.init(local_mode=True)
    try:
        out["round_trips"]["local"] = round_trips(rt, trips)
    finally:
        rt.shutdown()
    c, loc = out["round_trips"]["cluster"], out["round_trips"]["local"]
    log(f"19d [{card}]: round trip of a no-op task {c['task_us']:.0f} us median (p99 "
        f"{c['task_p99_us']:.0f}) across processes vs {loc['task_us']:.0f} us in process; "
        f"of an actor call {c['actor_call_us']:.0f} us (p99 {c['actor_call_p99_us']:.0f}) "
        f"vs {loc['actor_call_us']:.0f} us")
    p = out["ppo"]
    log(f"19e [{card}]: PPO CartPole in worker processes: 2 remote runners + 2 remote "
        f"learners {p['remote']['env_steps_per_s']:.0f} env steps/s "
        f"({p['remote']['env_steps_per_s_after_first']:.0f} after the first iteration, "
        f"which starts the actors: {p['remote']['iteration_ms'][0]:.0f} ms), "
        f"{p['remote']['median_iteration_ms']:.1f} ms an iteration; local "
        f"{p['local']['env_steps_per_s']:.0f} env steps/s "
        f"({p['local']['env_steps_per_s_after_first']:.0f}), "
        f"{p['local']['median_iteration_ms']:.1f} ms")
    return out


def _http_token_stream(port: int, body: dict, rid: str):
    """Tokens of one request streamed by the proxy as chunked JSONL; the
    response must echo the request id."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/llm?stream=1&method=stream",
        data=json.dumps(body).encode(), headers={"X-Request-Id": rid})
    with urllib.request.urlopen(req, timeout=900) as r:
        if r.headers.get("X-Request-Id") != rid:
            raise AssertionError(f"20: the proxy answered {rid} with "
                                 f"{r.headers.get('X-Request-Id')}")
        for line in r:
            item = json.loads(line)
            if "token" not in item:
                raise AssertionError(f"20: stream {rid} sent {item}")
            yield item["token"]


def _http_json(port: int, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/llm",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=900) as r:
        return json.loads(r.read())


class _CardMemory:
    """The card's peak memory in use by every process (the replica, the
    prefill actor, this one), sampled every 0.1 s from `mem_get_info`."""

    def __init__(self, torch):
        import threading

        self.peak = 0
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.1):
                free, total = torch.cuda.mem_get_info()
                self.peak = max(self.peak, total - free)

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()

    def stop(self) -> float:
        self._stop.set()
        self._thread.join()
        return self.peak / 2**30


def _wait_ready(serve, app: str, timeout: float = 900) -> None:
    """Until `serve.status()` shows a replica of `app` ready (constructed
    and past a health probe)."""
    deadline = time.perf_counter() + timeout
    while serve.status().get(app, {}).get("ready", 0) < 1:
        if time.perf_counter() > deadline:
            raise AssertionError(f"20: {app} not ready in {timeout} s: {serve.status()}")
        time.sleep(0.2)


def _wait_store(store, want: tuple, timeout: float = 60) -> tuple:
    """The store's (used bytes, objects) once they are `want`, or as they
    are at the timeout."""
    deadline = time.perf_counter() + timeout
    while (store.used, store.num_objects) != want and time.perf_counter() < deadline:
        time.sleep(0.2)
    return store.used, store.num_objects


def serve_plane_phase(torch, models, attention, seed: int, card: str, phase6=None,
                      cfg=None, device: str = "cuda", num_cpus: int = 16,
                      num_slots: int = 8, max_len: int = 2048,
                      new_tokens: int = 64) -> dict:
    """Phase 20: llama3-8b (`cfg`) deployed with the port's serve plane on
    its one-host cluster, the replica a `num_gpus=1` actor in a worker
    process: (a) `serve.run` until `serve.status()` shows it ready; (b)
    phase 6's eight requests at once, four streamed over HTTP as JSONL and
    four through the handle, with the transport of each; (e) the median
    round trip of a 1-token request over the handle and over HTTP; (c) the
    store arena, and the store back at its baseline once the deployment
    goes; (d) a `disagg=True` deployment whose 1900-token prompt must be
    prefilled by the prefill actor and give the unified deployment's
    tokens. After the cluster is down, the greedy tokens are held to
    `forward` on weights remade from the seed, whose digest must be the
    replica's. `phase6`: phase 6's results, printed beside these. Passing
    `cfg` (a TransformerConfig) and `device="cpu"` rehearses it on the
    CPU."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import LLMDeployment
    from ray_tpu_torch.serve.llm import _to_compute, params_digest

    cuda = device == "cuda"
    cfg = cfg or models.configs.LLAMA3_8B
    # The registry name, as a user binds it; a rehearsal's own config as is.
    cfg_arg = cfg.name if cfg is models.configs.LLAMA3_8B else cfg
    kw = {"num_slots": num_slots, "max_len": max_len, "seed": seed, "device": device}
    rng = np.random.default_rng(seed)
    prompts, temps, waits = serve_traffic(rng, cfg)
    alone = rng.integers(0, cfg.vocab_size, 1900).tolist()
    if cuda:
        torch.cuda.empty_cache()
    out = {"config": cfg.name, "num_slots": num_slots, "max_len": max_len}
    rt.init(num_cpus=num_cpus, num_gpus=None if cuda else 1)
    try:
        store = rt.api._global_worker().store
        baseline = (store.used, store.num_objects)
        deployment = serve.deployment(LLMDeployment).options(
            ray_actor_options={"num_gpus": 1})
        t0 = time.perf_counter()
        serve.run(deployment.bind(cfg_arg, **kw), name="llm", _http=True,
                  route_prefix="/llm")
        _wait_ready(serve, "llm")
        out["ready_s"] = time.perf_counter() - t0
        h = serve.get_app_handle("llm")
        t0 = time.perf_counter()
        h.options(method_name="warmup").remote().result(timeout=900)
        out["warmup_s"] = time.perf_counter() - t0
        controller = rt.get_actor("serve:controller")
        replica = rt.get_actor(rt.get(controller.get_routing.remote("llm"))["replicas"][0])
        log(f"20a [{card}]: serve.run of {cfg.name}'s LLMDeployment (num_gpus=1, "
            f"{num_slots} slots, max_len {max_len}) ready in {out['ready_s']:.1f} s "
            f"(serve.status); warmup {out['warmup_s']:.1f} s")

        # (b) phase 6's traffic: even requests over HTTP, odd through the handle.
        port = serve.http_port()
        handle_streams = {}

        def streams(i, prompt, max_tokens, temperature):
            body = {"tokens": prompt, "max_tokens": max_tokens,
                    "temperature": temperature}
            if i % 2 == 0:
                return _http_token_stream(port, body, f"phase20-{i}")
            resp = h.options(method_name="stream").remote_streaming(body)
            handle_streams[i] = resp
            return (item["token"] for item in resp)

        lane0 = rt.get(replica.stats.remote(), timeout=60).get("rails", {})
        results, run_s = run_streams(None, prompts, new_tokens, temps=temps,
                                     waits=waits, streams=streams)
        lane = rt.get(replica.stats.remote(), timeout=60)["rails"]
        attached = lane["attached_total"] - lane0.get("attached_total", 0)
        spilled = lane["spilled_total"] - lane0.get("spilled_total", 0)
        on_rails = {i: r.rails_used for i, r in handle_streams.items()}
        # The replica's lane counts every stream it pinned to a ring: the
        # handle's four say which they are, the proxy's are the rest.
        http_rails = attached - sum(on_rails.values())
        transport = ["rails" if (on_rails[i] if i in on_rails else http_rails == 4)
                     else "rpc" for i in range(len(prompts))]
        launches = h.options(method_name="stats").remote().result(
            timeout=60)["kernel_launches"]
        ttft = [r[1] for r in results]
        decode = stream_decode_rates(results)
        out["traffic"] = {"prompts": [len(p) for p in prompts], "temperatures": temps,
                          "via": ["http" if i % 2 == 0 else "handle"
                                  for i in range(len(prompts))],
                          "transport": transport, "rails_attached": attached,
                          "rails_spilled": spilled, "run_s": run_s, "ttft_ms": ttft,
                          "decode_tokens_per_s": decode,
                          "tokens_per_s": len(prompts) * new_tokens / run_s,
                          "replica_kernel_launches": launches}
        log(f"20b [{card}]: 8 requests (prompts {[len(p) for p in prompts]}, temps "
            f"{temps}; even over HTTP JSONL, odd through the handle) done in "
            f"{run_s:.2f} s ({len(prompts) * new_tokens / run_s:.1f} tokens/s); client "
            f"TTFT ms {[round(t, 1) for t in ttft]}; decode tokens/s a request "
            f"{[round(d, 1) for d in decode]}; transport {transport} (replica lane: "
            f"{attached} attached, {spilled} spilled); replica attention launches "
            f"{launches}")
        if phase6 is not None:
            log(f"20b [{card}]: phase 6 in process, same traffic: TTFT ms "
                f"{phase6['ttft_ms']}, decode tokens/s a request "
                f"{[round(d, 1) for d in phase6['mixed_decode_tokens_per_s']]}, "
                f"{len(prompts) * new_tokens / phase6['mixed_run_s']:.1f} tokens/s")
        if any(launches.values()):
            raise AssertionError(f"20b: the replica launched attention kernels {launches}")
        if transport != ["rails"] * len(prompts) or spilled:
            raise AssertionError(f"20b: streams not all on the rails: {transport}, "
                                 f"lane {lane}")

        # The 1900-token prompt alone on the unified deployment, for (d).
        unified = h.remote({"tokens": alone, "max_tokens": new_tokens}).result(
            timeout=900)["tokens"]
        # (e) round trips of a 1-token request.
        out["one_token_round_trip_ms"] = {
            "handle": one_token_round_trips(lambda p: h.remote(
                {"tokens": p, "max_tokens": 1}).result(timeout=600), rng, cfg),
            "http": one_token_round_trips(lambda p: _http_json(
                port, {"tokens": p, "max_tokens": 1}), rng, cfg),
            "in_process": phase6["one_token_round_trip_ms"] if phase6 else None}
        log(f"20e [{card}]: 1-token request, median of 20: "
            f"{json.dumps(out['one_token_round_trip_ms'])} ms")

        # (c) the arena, and the store once the deployment goes.
        digest = h.options(method_name="weights_digest").remote().result(timeout=600)
        stats = h.options(method_name="stats").remote().result(timeout=60)
        arena = {"arena_bytes": stats["arena_bytes"], "in_store": stats["arena_in_store"]}
        held = (store.used, store.num_objects)
        serve.delete("llm")
        after = _wait_store(store, baseline)
        out["arena"] = {**arena, "store_baseline": baseline, "store_with_replica": held,
                        "store_after_delete": after}
        log(f"20c [{card}]: arena {arena['arena_bytes']} bytes, in the store "
            f"{arena['in_store']}; store (used bytes, objects) {baseline} before, "
            f"{held} with the replica, {after} after serve.delete")
        if after != baseline:
            raise AssertionError(f"20c: the store is at {after}, not back at {baseline}")

        # (d) disaggregated prefill of the same prompt.
        mem = _CardMemory(torch) if cuda else None
        t0 = time.perf_counter()
        serve.run(deployment.bind(cfg_arg, disagg=True, **kw), name="disagg")
        _wait_ready(serve, "disagg")
        hd = serve.get_app_handle("disagg")
        hd.options(method_name="warmup").remote().result(timeout=900)
        t1 = time.perf_counter()
        offloaded = hd.remote({"tokens": alone, "max_tokens": new_tokens}).result(
            timeout=900)["tokens"]
        request_s = time.perf_counter() - t1
        dstats = hd.options(method_name="stats").remote().result(timeout=60)
        peak = mem.stop() if mem else None
        out["disagg"] = {"deploy_s": t1 - t0, "request_s": request_s,
                         "disagg_prefills": dstats["disagg_prefills"],
                         "adopted_blocks": dstats["adopted_blocks"],
                         "prefill_chunks": dstats["prefill_chunks"],
                         "tokens_equal": offloaded == unified, "peak_card_gib": peak}
        log(f"20d [{card}]: disagg deployment ready and warm in {t1 - t0:.1f} s; the "
            f"1900-token prompt in {request_s:.1f} s (prefill actor started on first "
            f"use): disagg_prefills {dstats['disagg_prefills']}, adopted blocks "
            f"{dstats['adopted_blocks']}, local prefill chunks "
            f"{dstats['prefill_chunks']}; tokens == unified: {offloaded == unified}; "
            f"peak card memory (all processes) {peak} GiB")
        if dstats["disagg_prefills"] != 1 or dstats["adopted_blocks"] <= 0:
            raise AssertionError(f"20d: the prompt was not offloaded: {dstats}")
        if offloaded != unified:
            raise AssertionError(f"20d: disagg tokens {offloaded} != unified {unified}")
        serve.shutdown()
        # Both arenas and the prefill actor's returned frame (owned by the
        # replica, which frees it before it exits) are gone.
        after = _wait_store(store, baseline)
        out["arena"]["store_after_shutdown"] = after
        log(f"20c [{card}]: store (used bytes, objects) {after} after serve.shutdown "
            f"(baseline {baseline})")
        if after != baseline:
            raise AssertionError(f"20c: after serve.shutdown the store is at {after}, "
                                 f"not back at {baseline}")
    except BaseException:
        log(f"20 [{card}]: failed; host now: {_host_state(torch)}")
        _dump_node_logs(rt)
        raise
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()

    # The greedy tokens against forward on weights remade from the seed,
    # once the cluster's processes have given the card back.
    if cuda:
        deadline = time.perf_counter() + 120
        while torch.cuda.mem_get_info()[0] < 0.75 * torch.cuda.mem_get_info()[1]:
            if time.perf_counter() > deadline:
                raise AssertionError(f"20: the card is still held: {_host_state(torch)}")
            time.sleep(0.5)
    with torch.no_grad():
        masters = models.init_params(
            cfg, torch.Generator(device=device).manual_seed(seed), device=device)
        params = _to_compute(masters, cfg.compute_dtype, torch.device(device))
        del masters
        if cuda:
            torch.cuda.empty_cache()
        remade = params_digest(params, cfg.compute_dtype)
        if remade != digest:
            raise AssertionError(f"20: the replica's weights digest {digest} != {remade}")
        greedy = [i for i, t in enumerate(temps) if t == 0]
        out["teacher_forced"] = forward_agreement(
            torch, models, params, cfg, [prompts[i] for i in greedy] + [alone],
            [results[i][0] for i in greedy] + [unified], card, device=device)
    del params
    if cuda:
        torch.cuda.empty_cache()
    out["weights_digest"] = digest
    out["replica_stats"] = stats
    return out


TRAIN_PLANE_STEPS = 10
# Step after which phase 21's loop saves the whole train state.
TRAIN_PLANE_CKPT_STEP = 5
# How long attempt 0 of 21b waits, after reporting its checkpoint, for the
# SIGKILL the driver sends; a run that outlives it fails.
TRAIN_PLANE_KILL_DEADLINE_S = 300.0


def _tree_nbytes(tree) -> int:
    return sum(_tree_nbytes(v) if isinstance(v, dict) else
               (v.numel() * v.element_size() if hasattr(v, "element_size") else 0)
               for v in tree.values())


def train_plane_loop(config) -> None:
    """Phase 21's train loop, run by `train.TorchTrainer` in its worker:
    phase 4's step from the seed, or from `train.get_checkpoint()` loaded
    in place; each step reports its loss, this process's kernel launches
    and times; the whole state is saved after TRAIN_PLANE_CKPT_STEP. With
    `hold`, an attempt that did not resume writes a beacon after its
    checkpoint and waits for the driver's SIGKILL."""
    import numpy as np
    import torch

    from ray_tpu_torch import models, train
    from ray_tpu_torch.ops import attention

    cfg, device, steps = config["cfg"], config["device"], config["steps"]
    init_fn, step_fn = bench_train_step(models, cfg, device)
    state = init_fn(torch.Generator(device=device).manual_seed(config["seed"]))
    ckpt = train.get_checkpoint()
    restore = None
    if ckpt is not None:
        _sync(torch, device)
        t0 = time.perf_counter()
        tree = train.load_pytree(ckpt, target=models.training.train_state_tree(state))
        _sync(torch, device)
        restore = {"seconds": time.perf_counter() - t0, "bytes": _tree_nbytes(tree),
                   "path": ckpt.path}
        state.step = int(tree["step"])
        del tree
    corpus = torch.from_numpy(np.random.default_rng(config["seed"]).integers(
        0, cfg.vocab_size, (steps, config["batch"], config["seq"] + 1), dtype=np.int32))
    card = torch.cuda.get_device_name() if device == "cuda" else "cpu"
    for i in range(state.step, steps):
        tokens = corpus[i].to(device)
        with train.step_phases():
            start = time.time()
            with train.phase("compute"):
                seen = dict(attention.launches)
                _sync(torch, device)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, {"tokens": tokens})
                host_ms = (time.perf_counter() - t0) * 1e3
                loss = float(metrics["loss"])
                _sync(torch, device)
                step_ms = (time.perf_counter() - t0) * 1e3
                launched = {n: attention.launches[n] - seen[n] for n in seen}
            report = {"step": state.step, "loss": loss, "launches": launched,
                      "step_ms": step_ms, "host_ms": host_ms, "device": card,
                      "pid": os.getpid(), "start_ts": start, "restore": restore}
            restore = None
            if state.step != TRAIN_PLANE_CKPT_STEP:
                train.report(report)
                continue
            trial = train.get_context().get_trial_dir()
            report["free_bytes_before_save"] = shutil.disk_usage(trial).free
            tree = models.training.train_state_tree(state)
            src = os.path.join(trial, f"save_{os.getpid()}")
            _sync(torch, device)
            t0 = time.perf_counter()
            saved = train.save_pytree(tree, src, step=state.step)
            report["save"] = {"seconds": time.perf_counter() - t0,
                              "bytes": _tree_nbytes(tree)}
            del tree
            t0 = time.perf_counter()
            train.report(report, checkpoint=saved)
            report_s = time.perf_counter() - t0
            shutil.rmtree(src, ignore_errors=True)
        # The session's copy into checkpoint_%06d, timed by the report.
        train.report({"step": state.step, "copy_s": report_s})
        if config.get("hold") and ckpt is None:
            # Hold for the SIGKILL only once the trainer has drained the
            # checkpoint's report: a report still queued in this process
            # dies with it, and the gang would restart from scratch.
            from ray_tpu_torch.train import session

            queued = session._get().results
            while not queued.empty():
                time.sleep(0.01)
            time.sleep(0.5)  # the poll's reply on its way; the cut stays here
            with open(config["beacon"], "w") as f:
                f.write(str(os.getpid()))
            deadline = time.monotonic() + TRAIN_PLANE_KILL_DEADLINE_S
            while not os.path.exists(config["beacon"] + ".never"):
                if time.monotonic() > deadline:
                    raise RuntimeError("21b: attempt 0 was never killed")
                time.sleep(0.05)


def _plane_steps(result) -> list:
    return [m for m in result.metrics_history if "loss" in m]


def _check_plane_steps(label, steps, reference, expected, card_name) -> None:
    for m in steps:
        i = m["step"] - 1
        if m["loss"] != reference[i] or not math.isfinite(m["loss"]):
            raise AssertionError(f"{label} step {m['step']}: loss {m['loss']!r} is not the "
                                 f"direct step's {reference[i]!r}")
        if m["launches"] != expected:
            raise AssertionError(f"{label} step {m['step']}: launches {m['launches']} != "
                                 f"{expected}")
        if m["device"] != card_name:
            raise AssertionError(f"{label} step {m['step']}: ran on {m['device']}, not "
                                 f"{card_name}")


def _gib_s(rec) -> float:
    return rec["bytes"] / 2**30 / rec["seconds"] if rec and rec["seconds"] else float("nan")


def train_plane_phase(torch, models, attention, seed: int, card: str, cfg=None,
                      batch: int = 8, seq: int = 2048, device: str = "cuda",
                      reference=None, direct_step_ms=None, phase4_mfu=None,
                      num_cpus: int = 16, then=None) -> dict:
    """Phase 21: bench-350m (`cfg`) trained through `train.TorchTrainer` on
    the one-host runtime, one worker with the card: (a) a clean fit of
    TRAIN_PLANE_STEPS steps saving the whole state after step
    TRAIN_PLANE_CKPT_STEP; (b) the same fit, elastic, its rank SIGKILLed
    right after that checkpoint, replaced in place on its kept bundle and
    resumed from the checkpoint; (c) what `util.state` and
    `util.timeline` recorded of both. Every step's loss is held bit for bit
    to `reference` (the direct step's on the same seed and batches; made
    here when not given), and its launches, counted in the worker, to
    2L / L / L. The store's (used bytes, objects) must be back at their
    baseline after (b). `then(rt=..., reference=..., direct_step_ms=...,
    storage=...)` runs on the same cluster before it shuts down (phase 22);
    its result is out["then"]."""
    import tempfile
    from types import SimpleNamespace

    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.util import chaos, state as rt_state, timeline

    cuda = device == "cuda"
    cfg = cfg or models.configs.BENCH_350M
    steps = TRAIN_PLANE_STEPS
    if reference is None:
        init_fn, step_fn = bench_train_step(models, cfg, device)
        st = init_fn(torch.Generator(device=device).manual_seed(seed))
        corpus = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (steps, batch, seq + 1), dtype=np.int32)
        reference, times = [], []
        for i in range(steps):
            tokens = torch.from_numpy(corpus[i]).to(device)
            _sync(torch, device)
            t0 = time.perf_counter()
            st, m = step_fn(st, {"tokens": tokens})
            reference.append(float(m["loss"]))
            _sync(torch, device)
            times.append((time.perf_counter() - t0) * 1e3)
        direct_step_ms = statistics.median(times[1:])
        del st
    per_step = 1 if cuda else 0  # the plain versions count nothing
    expected = {"fa_fwd": 2 * cfg.n_layers * per_step,
                "fa_bwd_dq": cfg.n_layers * per_step, "fa_bwd_dkv": cfg.n_layers * per_step}
    card_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    fpt = 6.0 * cfg.num_params + 6 * cfg.n_layers * cfg.d_model * seq
    flops_per_step = fpt * batch * seq
    peak_var = "RAY_TPU_TRAIN_OBS_PEAK_FLOPS"
    peak_before = os.environ.get(peak_var)
    os.environ[peak_var] = repr(PEAK_BF16_FLOPS)
    storage = tempfile.mkdtemp(prefix="chip_smoke_train_")
    if cuda:
        torch.cuda.empty_cache()
    out = {"config": cfg.name, "batch": batch, "seq": seq, "steps": steps,
           "flops_per_step": flops_per_step}
    t_phase = time.perf_counter()
    rt.init(num_cpus=num_cpus, num_gpus=None if cuda else 1)
    try:
        store = rt.api._global_worker().store
        baseline = (store.used, store.num_objects)
        config = {"cfg": cfg, "device": device, "steps": steps, "seed": seed,
                  "batch": batch, "seq": seq}
        # On the CPU (a rehearsal) the worker's bundle still reserves the
        # GPU that init(num_gpus=1) declares, as the card's bundle does.
        scaling = train.ScalingConfig(
            num_workers=1, use_gpu=cuda, flops_per_step=flops_per_step,
            resources_per_worker=None if cuda else {"GPU": 1.0})

        # (a) a clean fit
        t0 = time.perf_counter()
        clean = train.TorchTrainer(
            train_plane_loop, train_loop_config=config, scaling_config=scaling,
            run_config=train.RunConfig(name="bench350m_clean", storage_path=storage)).fit()
        fit_s = time.perf_counter() - t0
        if clean.error is not None:
            raise AssertionError(f"21a: the fit failed: {clean.error}")
        done = _plane_steps(clean)
        if [m["step"] for m in done] != list(range(1, steps + 1)):
            raise AssertionError(f"21a: steps {[m['step'] for m in done]}")
        _check_plane_steps("21a", done, reference, expected, card_name)
        if not (clean.checkpoint and clean.checkpoint.path.endswith("checkpoint_000001")):
            raise AssertionError(f"21a: Result.checkpoint is {clean.checkpoint}")
        saved = done[TRAIN_PLANE_CKPT_STEP - 1]
        copy_s = next(m["copy_s"] for m in clean.metrics_history if "copy_s" in m)
        worker_ms = statistics.median(m["step_ms"] for m in done[1:])
        out["clean"] = {
            "fit_s": fit_s, "losses": [m["loss"] for m in done],
            "step_ms": [m["step_ms"] for m in done], "host_ms": [m["host_ms"] for m in done],
            "median_step_ms": worker_ms, "direct_median_step_ms": direct_step_ms,
            "median_host_ms": statistics.median(m["host_ms"] for m in done[1:]),
            "launches": {n: sum(m["launches"][n] for m in done) for n in expected},
            "save": saved["save"], "save_gib_s": _gib_s(saved["save"]),
            "session_copy_s": copy_s, "free_bytes_before_save": saved["free_bytes_before_save"],
            "checkpoint": os.path.basename(clean.checkpoint.path)}
        c = out["clean"]
        log(f"21a [{card}]: {cfg.name} {batch} x {seq} through TorchTrainer (1 worker, "
            f"{card_name}), {steps} steps in {fit_s:.1f} s, losses bit-equal to the direct "
            f"step's, launches {expected} a step in the worker; worker step "
            f"{worker_ms:.2f} ms median (host {c['median_host_ms']:.2f}) vs direct "
            f"{direct_step_ms}; save_pytree of {saved['save']['bytes'] / 2**30:.2f} GiB "
            f"in {saved['save']['seconds']:.2f} s ({c['save_gib_s']:.2f} GiB/s), the "
            f"session's copy {copy_s:.2f} s, {c['free_bytes_before_save'] / 2**30:.1f} GiB "
            f"free before the save; Result.checkpoint {c['checkpoint']}")
        shutil.rmtree(os.path.join(storage, "bench350m_clean"), ignore_errors=True)

        # (b) an elastic fit with a kill
        beacon = os.path.join(storage, "rank0_pid")
        fc = train.FailureConfig(elastic=True, max_failures=2, replace_timeout_s=60,
                                 backoff_initial_s=0.1, backoff_max_s=0.5, backoff_jitter=0.0)
        trainer = train.TorchTrainer(
            train_plane_loop, train_loop_config={**config, "hold": True, "beacon": beacon},
            scaling_config=scaling,
            run_config=train.RunConfig(name="bench350m_elastic", storage_path=storage,
                                       failure_config=fc))
        killed = {}

        def kill():
            deadline = time.monotonic() + TRAIN_PLANE_KILL_DEADLINE_S
            while not os.path.exists(beacon) and time.monotonic() < deadline:
                time.sleep(0.02)
            try:
                with open(beacon) as f:
                    pid = int(f.read())
            except (OSError, ValueError):
                return
            killed["ts"] = time.time()
            killed["ok"] = chaos.kill_rank(SimpleNamespace(pids=[pid]), 0)
            killed["pid"] = pid

        import threading

        killer = threading.Thread(target=kill, daemon=True)
        killer.start()
        t0 = time.perf_counter()
        elastic = trainer.fit()
        fit_s = time.perf_counter() - t0
        killer.join(timeout=10)
        if elastic.error is not None:
            raise AssertionError(f"21b: the fit failed: {elastic.error}")
        if not killed.get("ok"):
            raise AssertionError(f"21b: rank 0 was not killed: {killed}")
        done = _plane_steps(elastic)
        before = [m for m in done if m["pid"] == killed["pid"]]
        after = [m for m in done if m["pid"] != killed["pid"]]
        if ([m["step"] for m in before] != list(range(1, TRAIN_PLANE_CKPT_STEP + 1))
                or [m["step"] for m in after]
                != list(range(TRAIN_PLANE_CKPT_STEP + 1, steps + 1))):
            raise AssertionError(f"21b: steps {[(m['pid'], m['step']) for m in done]}")
        _check_plane_steps("21b", done, reference, expected, card_name)
        ek = elastic.elastic
        if ek["restarts"]["death"] < 1 or ek["shrinks"] != 0:
            raise AssertionError(f"21b: elastic accounting {ek}")
        trial = os.path.join(storage, "bench350m_elastic")
        seqs = sorted(n for n in os.listdir(trial) if n.startswith("checkpoint_"))
        ck_steps = [train.Checkpoint(os.path.join(trial, n)).get_metadata()["step"]
                    for n in seqs]
        if not ck_steps or ck_steps != sorted(ck_steps):
            raise AssertionError(f"21b: checkpoints {seqs} hold steps {ck_steps}")
        restore = after[0]["restore"]
        gap_s = after[0]["start_ts"] - killed["ts"]
        store_after = _wait_store(store, baseline)
        out["elastic"] = {
            "fit_s": fit_s, "losses": [m["loss"] for m in done], "elastic": ek,
            "checkpoints": dict(zip(seqs, ck_steps)), "restore": restore,
            "restore_gib_s": _gib_s(restore), "restart_gap_s": gap_s,
            "median_step_ms_after": statistics.median(m["step_ms"] for m in after[1:]),
            "store_baseline": baseline, "store_after": store_after}
        log(f"21b [{card}]: elastic fit in {fit_s:.1f} s: rank 0 (pid {killed['pid']}) "
            f"SIGKILLed after its step-{TRAIN_PLANE_CKPT_STEP} checkpoint, replaced in place "
            f"(restarts {ek['restarts']}, shrinks {ek['shrinks']}, final world "
            f"{ek['final_world']}); load_pytree restored {restore['bytes'] / 2**30:.2f} GiB in "
            f"{restore['seconds']:.2f} s ({out['elastic']['restore_gib_s']:.2f} GiB/s); "
            f"restart gap from the kill to the new gang's first step {gap_s:.2f} s; steps "
            f"{TRAIN_PLANE_CKPT_STEP + 1}-{steps} bit-equal to the direct step's; checkpoints "
            f"{out['elastic']['checkpoints']}; store (used bytes, objects) {baseline} before, "
            f"{store_after} after")
        if store_after != baseline:
            raise AssertionError(f"21b: the store is at {store_after}, not back at {baseline}")

        # (c) what the plane recorded
        def recorded():
            runs = rt_state.train_runs()
            c, e = runs.get("bench350m_clean"), runs.get("bench350m_elastic")
            if (c and e and c["steps"] >= steps - 1 and "mfu" in c
                    and e["restarts"] >= 1 and e["attempt"] >= 1):
                return c, e
            return None

        deadline = time.monotonic() + 60
        got = recorded()
        while got is None and time.monotonic() < deadline:
            time.sleep(0.5)
            got = recorded()
        if got is None:
            raise AssertionError(f"21c: train_runs() {rt_state.train_runs()}")
        c, e = got
        spans = [sp for sp in timeline.fetch_spans(trace_id=c["run_id"])
                 if sp["name"] == "train.step" and sp["attrs"].get("rank") == 0]
        findings = [f for f in rt_state.doctor()["findings"]
                    if f.get("run") == "bench350m_clean"]
        out["recorded"] = {"clean": c, "elastic": e, "clean_step_spans": len(spans),
                           "clean_findings": findings, "phase4_mfu": phase4_mfu}
        log(f"21c [{card}]: train_runs(): clean {c['steps']} steps, restarts "
            f"{c['restarts']}, split {c['split']}, {c['achieved_flops'] / 1e12:.1f} TFLOP/s "
            f"achieved, mfu {c['mfu']} (phase 4's {phase4_mfu}); elastic restarts "
            f"{e['restarts']}, lost_restart_s {e['lost_restart_s']}, split {e['split']}; "
            f"{len(spans)} train.step spans of rank 0 under {c['run_id']}; doctor's train "
            f"findings on the clean run: {findings}")
        if c["restarts"] != 0 or not c["split"] or not spans:
            raise AssertionError(f"21c: the clean run's record {c}, {len(spans)} spans")
        if e["restarts"] != 1 or not e["lost_restart_s"] > 0:
            raise AssertionError(f"21c: the elastic run's record {e}")
        if findings:
            raise AssertionError(f"21c: doctor flags the clean run: {findings}")
        out["phase_s"] = time.perf_counter() - t_phase
        if then is not None:
            out["then"] = then(rt=rt, reference=reference, direct_step_ms=direct_step_ms,
                               storage=storage)
    except BaseException:
        log(f"21-22 [{card}]: failed; host now: {_host_state(torch)}")
        _dump_node_logs(rt)
        raise
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
        if peak_before is None:
            os.environ.pop(peak_var, None)
        else:
            os.environ[peak_var] = peak_before
    return out


# Phase 22b: the tokenised corpus fed through the data plane (131,072 rows of
# 2,049 int32 tokens: 1.0 GiB) and its blocks.
DATA_PLANE_ROWS = 131_072
DATA_PLANE_BLOCKS = 64
# Phase 22a: the blocks of the trainer's corpus.
DATA_INGEST_BLOCKS = 8


def data_ingest_loop(config) -> None:
    """Phase 22a's train loop, run by `train.TorchTrainer` in its worker:
    phase 4's step from the seed, each step's tokens read from the
    StreamingIngest shard with `iter_device_batches` on `config["device"]`;
    each step reports its loss, the rows it trained on, this process's
    kernel launches and times, and the feed its hits and misses."""
    import torch

    from ray_tpu_torch import models, train
    from ray_tpu_torch.ops import attention

    cfg, device = config["cfg"], config["device"]
    init_fn, step_fn = bench_train_step(models, cfg, device)
    state = init_fn(torch.Generator(device=device).manual_seed(config["seed"]))
    card = torch.cuda.get_device_name() if device == "cuda" else "cpu"
    shard = train.get_dataset_shard("train")
    with shard.iter_device_batches(batch_size=config["batch"], device=device) as feed:
        for batch in feed:
            seen = dict(attention.launches)
            _sync(torch, device)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, {"tokens": batch["tokens"]})
            host_ms = (time.perf_counter() - t0) * 1e3
            loss = float(metrics["loss"])
            _sync(torch, device)
            step_ms = (time.perf_counter() - t0) * 1e3
            train.report({"step": state.step, "loss": loss, "rows": batch["row"].tolist(),
                          "launches": {n: attention.launches[n] - seen[n] for n in seen},
                          "step_ms": step_ms, "host_ms": host_ms, "device": card})
    train.report({"feed": {"hits": feed.hits, "misses": feed.misses}})


def _gauge(name: str, dataset: str = "ds"):
    """The last value of a data gauge in this process's registry."""
    from ray_tpu_torch.util.metrics import registry_dump

    for m in registry_dump():
        if m["name"] == name:
            for key, value in m.get("samples", []):
                if ("dataset", dataset) in [tuple(kv) for kv in key]:
                    return value
    return None


def _store_sampler(store):
    """A thread sampling the store's used bytes every 20 ms; returns the
    thread, its stop event and the list of samples."""
    import threading

    stop, samples = threading.Event(), []

    def run():
        while not stop.is_set():
            samples.append(store.used)
            time.sleep(0.02)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, stop, samples


def data_plane_phase(torch, models, attention, seed: int, card: str, rt, reference,
                     direct_step_ms, cfg=None, batch: int = 8, seq: int = 2048,
                     device: str = "cuda", storage: str = None,
                     corpus_rows: int = DATA_PLANE_ROWS) -> dict:
    """Phase 22, on phase 21's cluster (`rt` initialised): (a) phase 4's
    cell (`cfg`) trained by `train.TorchTrainer` for TRAIN_PLANE_STEPS steps
    from `datasets={"train": StreamingIngest(ds)}`, ds the seeded corpus of
    phase 21's loop in DATA_INGEST_BLOCKS blocks and one map_batches stage,
    read in the worker with `iter_device_batches`: losses bit-equal to
    `reference` (the direct step's), 2L / L / L launches a step, every row
    once; (b) a seeded corpus of `corpus_rows` rows of seq + 1 int32 tokens
    in DATA_PLANE_BLOCKS blocks through map_batches, `random_shuffle(seed=0)`
    and `iter_device_batches(batch_size=batch)` in the driver: every row
    once, the tokens' sum intact, and none of its objects left in the store
    after the dataset is dropped; (c) PPO's CartPole rollouts and a SAC Pendulum
    replay recorded as JSON shards, read through `read_samples`, and BC,
    MARWIL (3 iterations each) and CQL (2) trained on them on `device`."""
    import gc
    import importlib.util
    import tempfile

    import numpy as np

    from ray_tpu_torch import data as rd, train
    from ray_tpu_torch.rllib import cql, offline, ppo, sac

    cuda = device == "cuda"
    cfg = cfg or models.configs.BENCH_350M
    steps = TRAIN_PLANE_STEPS
    card_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    have = {m: importlib.util.find_spec(m) is not None for m in ("pyarrow", "pandas")}
    log(f"22 [{card}]: importable here: {have}")
    out = {"importable": have}
    storage = storage or tempfile.mkdtemp(prefix="chip_smoke_data_")
    store = rt.api._global_worker().store
    t_phase = time.perf_counter()

    # (a) the ingest path: StreamingIngest -> TorchTrainer's worker
    corpus = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (steps, batch, seq + 1), dtype=np.int32)
    n = steps * batch
    ds = rd.from_numpy({"tokens": corpus.reshape(n, seq + 1), "row": np.arange(n)},
                       parallelism=DATA_INGEST_BLOCKS)

    def as_tokens(b):
        return {"tokens": b["tokens"].astype(np.int32, copy=False), "row": b["row"]}

    ds = ds.map_batches(as_tokens, batch_format="numpy")
    ingest = rd.StreamingIngest(ds)
    per_step = 1 if cuda else 0  # the plain versions count nothing
    expected = {"fa_fwd": 2 * cfg.n_layers * per_step,
                "fa_bwd_dq": cfg.n_layers * per_step, "fa_bwd_dkv": cfg.n_layers * per_step}
    t0 = time.perf_counter()
    result = train.TorchTrainer(
        data_ingest_loop, train_loop_config={"cfg": cfg, "device": device, "seed": seed,
                                             "batch": batch},
        scaling_config=train.ScalingConfig(
            num_workers=1, use_gpu=cuda, resources_per_worker=None if cuda else {"GPU": 1.0}),
        datasets={"train": ingest},
        run_config=train.RunConfig(name="bench350m_ingest", storage_path=storage)).fit()
    fit_s = time.perf_counter() - t0
    if result.error is not None:
        raise AssertionError(f"22a: the fit failed: {result.error}")
    done = _plane_steps(result)
    if [m["step"] for m in done] != list(range(1, steps + 1)):
        raise AssertionError(f"22a: steps {[m['step'] for m in done]}")
    _check_plane_steps("22a", done, reference, expected, card_name)
    rows = [r for m in done for r in m["rows"]]
    if sorted(rows) != list(range(n)):
        raise AssertionError(f"22a: rows {rows} are not every row of the {n} once")
    feed = next(m["feed"] for m in result.metrics_history if "feed" in m)
    stats = rt.get(ingest.coordinator.stats.remote())
    worker_ms = statistics.median(m["step_ms"] for m in done[1:])
    out["ingest"] = {
        "fit_s": fit_s, "losses": [m["loss"] for m in done],
        "step_ms": [m["step_ms"] for m in done], "host_ms": [m["host_ms"] for m in done],
        "median_step_ms": worker_ms, "direct_median_step_ms": direct_step_ms,
        "median_host_ms": statistics.median(m["host_ms"] for m in done[1:]),
        "launches": {k: sum(m["launches"][k] for m in done) for k in expected},
        "feed": feed, "stats": stats}
    log(f"22a [{card}]: {cfg.name} {batch} x {seq} through TorchTrainer from "
        f"StreamingIngest({DATA_INGEST_BLOCKS} blocks + map_batches), {steps} steps in "
        f"{fit_s:.1f} s, losses bit-equal to the direct step's, launches {expected} a "
        f"step in the worker, rows 0-{n - 1} once each; worker step {worker_ms:.2f} ms "
        f"median (host {out['ingest']['median_host_ms']:.2f}) vs direct {direct_step_ms}; "
        f"feed hits {feed['hits']}, misses {feed['misses']}; ds.stats():\n{stats}")
    shutil.rmtree(os.path.join(storage, "bench350m_ingest"), ignore_errors=True)
    del ds, ingest, result, corpus

    # (b) the data plane at a real size: 1.0 GiB through the shuffle. The
    # read stage makes each block's tokens from the seed and its first row:
    # blocks put from the driver would ride in the read tasks as nested
    # refs, which the owner keeps for a transit grace after their use.
    per_block = -(-corpus_rows // DATA_PLANE_BLOCKS)

    def corpus_block(b):
        rows = b["id"]
        rng = np.random.default_rng([seed + 1, int(rows[0])])
        return {"tokens": rng.integers(0, cfg.vocab_size, (len(rows), seq + 1),
                                       dtype=np.int32), "row": rows}

    t0 = time.perf_counter()
    token_sum = sum(int(corpus_block({"id": np.arange(a, min(a + per_block, corpus_rows))})
                        ["tokens"].sum(dtype=np.int64))
                    for a in range(0, corpus_rows, per_block))
    make_s = time.perf_counter() - t0
    nbytes = corpus_rows * ((seq + 1) * 4 + 8)
    before = set(store.list_objects())
    used_before = store.used
    ds = (rd.range(corpus_rows, parallelism=DATA_PLANE_BLOCKS)
          .map_batches(corpus_block, batch_format="numpy").random_shuffle(seed=0))
    counts = torch.zeros(corpus_rows, dtype=torch.int32, device=device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    ones = torch.ones(batch, dtype=torch.int32, device=device)
    sampler, stop, used = _store_sampler(store)
    _sync(torch, device)
    t0 = time.perf_counter()
    with ds.iter_device_batches(batch_size=batch, device=device) as feed:
        for b in feed:
            counts.index_add_(0, b["row"], ones[:len(b["row"])])
            total += b["tokens"].sum(dtype=torch.int64)
    _sync(torch, device)
    seconds = time.perf_counter() - t0
    stop.set()
    sampler.join(timeout=5)
    once = bool((counts == 1).all())
    intact = int(total) == token_sum
    stages = [{"name": st.name, "tasks": st.tasks, "wall_s": st.wall_s, "stall_s": st.stall_s,
               "spilled_tasks": st.spilled_tasks, "bytes_out": st.bytes_out}
              for st in ds._last_stats.stages]
    shuffle = {"bytes": _gauge("data_shuffle_bytes"), "seconds": _gauge("data_shuffle_seconds"),
               "gbps": _gauge("data_shuffle_gbps")}
    hits, misses = feed.hits, feed.misses
    del ds, feed, b, counts
    gc.collect()
    rt.api._global_worker().flush_frees()
    deadline = time.perf_counter() + 60
    while set(store.list_objects()) - before and time.perf_counter() < deadline:
        time.sleep(0.2)
    left = set(store.list_objects()) - before
    out["corpus"] = {
        "rows": corpus_rows, "blocks": DATA_PLANE_BLOCKS, "bytes": nbytes,
        "make_s": make_s, "seconds": seconds,
        "gib_s": nbytes / 2**30 / seconds, "rows_s": corpus_rows / seconds,
        "shuffle": shuffle, "stages": stages, "feed": {"hits": hits, "misses": misses},
        "peak_store_bytes": max(used), "store_used_before": used_before,
        "store_used_after": store.used, "objects_left": len(left),
        "every_row_once": once, "tokens_intact": intact}
    log(f"22b [{card}]: {corpus_rows} rows x {seq + 1} int32 ({nbytes / 2**30:.3f} GiB) "
        f"in {DATA_PLANE_BLOCKS} blocks: read (each block's tokens made from the seed) + "
        f"map_batches -> random_shuffle(seed=0) -> iter_device_batches({batch}) on "
        f"{card_name}: {seconds:.2f} s, {out['corpus']['gib_s']:.3f} GiB/s, "
        f"{out['corpus']['rows_s']:.0f} rows/s; shuffle {shuffle}; stages {stages}; feed "
        f"hits {hits}, misses {misses}; peak store {max(used) / 2**30:.3f} GiB; every row "
        f"once: {once}, tokens intact: {intact}; store {used_before} bytes before, "
        f"{store.used} after, {len(left)} of its objects left")
    if not (once and intact):
        raise AssertionError("22b: rows missing, repeated or altered by the data plane")
    if left:
        raise AssertionError(f"22b: {len(left)} objects of the dataset are still in the store")

    # (c) the offline reader: BC, MARWIL and CQL from JSON shards
    path = tempfile.mkdtemp(prefix="rtt_offline_", dir=storage)
    algo = (ppo.PPOConfig().environment("CartPole-v1").resources(device=device)
            .debugging(seed=seed).build())
    offline.record_rollouts(algo, path, num_iterations=4, fmt="json")
    algo.stop()
    written = 4 * algo.config.num_envs_per_env_runner * algo.config.rollout_fragment_length
    offline_out = {"rollout_rows_written": written,
                   "rollout_rows_read": offline.read_samples(path).count()}
    for name, config in (("bc", offline.BCConfig()), ("marwil", offline.MARWILConfig())):
        algo = (config.environment("CartPole-v1").offline_data(input_path=path)
                .resources(device=device).debugging(seed=seed).build())
        ms, metrics = [], []
        for _ in range(3):
            _sync(torch, device)
            t0 = time.perf_counter()
            metrics.append(algo.train())
            _sync(torch, device)
            ms.append((time.perf_counter() - t0) * 1e3)
        algo.stop()
        offline_out[name] = {"iteration_ms": ms, "metrics": metrics[-1]}
    algo = (sac.SACConfig().environment("Pendulum-v1").training(learning_starts=1024)
            .resources(device=device).debugging(seed=seed).build())
    for _ in range(2):
        algo.train()
    replay = tempfile.mkdtemp(prefix="rtt_replay_", dir=storage)
    cql.record_replay(algo, replay, fmt="json")
    offline_out["replay_rows_written"] = len(algo.replay)
    algo.stop()
    offline_out["replay_rows_read"] = offline.read_samples(replay).count()
    algo = (cql.CQLConfig().environment("Pendulum-v1").offline_data(input_path=replay)
            .resources(device=device).debugging(seed=seed).build())
    ms, metrics = [], []
    for _ in range(2):
        _sync(torch, device)
        t0 = time.perf_counter()
        metrics.append(algo.train())
        _sync(torch, device)
        ms.append((time.perf_counter() - t0) * 1e3)
    algo.stop()
    offline_out["cql"] = {"iteration_ms": ms, "metrics": metrics[-1]}
    out["offline"] = offline_out
    learned = [offline_out[k]["metrics"] for k in ("bc", "marwil", "cql")]
    finite = all(math.isfinite(v) for m in learned for v in m.values()
                 if isinstance(v, (int, float)))
    log(f"22c [{card}]: {offline_out['rollout_rows_read']} of "
        f"{offline_out['rollout_rows_written']} rollout rows and "
        f"{offline_out['replay_rows_read']} of {offline_out['replay_rows_written']} replay "
        f"rows read through read_samples; ms an iteration: BC "
        f"{offline_out['bc']['iteration_ms']}, MARWIL {offline_out['marwil']['iteration_ms']}, "
        f"CQL {offline_out['cql']['iteration_ms']}; metrics finite: {finite}")
    if (offline_out["rollout_rows_read"] != written
            or offline_out["replay_rows_read"] != offline_out["replay_rows_written"]
            or not finite):
        raise AssertionError(f"22c: rows read != rows written, or non-finite metrics: "
                             f"{offline_out}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def import_and_rllib_phase(torch, models, attention, seed: int, card: str) -> dict:
    """Phases 15 and 16."""
    return {"tiny_padded": tiny_padded(torch, models, attention, card),
            "hf_reference": hf_import_reference(torch, models, attention, seed, card),
            "hf_serve": hf_import_serve(torch, models, attention, seed, card),
            "rllib": rllib_phase(torch, seed, card)}


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
    marks = [("start", time.perf_counter())]  # (phase, wall clock after it)

    t0 = time.perf_counter()
    _cuda.library_path("flash_attention")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    log("build report: " + json.dumps(build_report(_cuda)))

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = check_kernels(torch, attention, gen)
    marks.append(('1-2 kernels', time.perf_counter()))
    full_grads = check_reference(torch, models)["card_grads"]
    run = main_path(torch, models, attention, args.steps, args.seed)
    log("main path: " + json.dumps(run))
    marks.append(('3-4 reference and main path', time.perf_counter()))
    serve_ref = check_serving_reference(torch, models, card)
    log("serving reference: " + json.dumps(serve_ref))
    params, serve_run = serve_main_path(torch, models, attention, args.seed, card)
    log("serving main path: " + json.dumps(serve_run))
    marks.append(('5-6 serving', time.perf_counter()))
    slice_ref = check_serving_slice(torch, models, card)
    log("serving slice reference: " + json.dumps(slice_ref))
    slice_run = serve_slice_main_path(torch, models, attention, params, args.seed, card)
    log("serving slice main path: " + json.dumps(slice_run))
    marks.append(('7-8 serving slice', time.perf_counter()))
    tp_llama = tp_engine_phase(torch, models, attention, params, models.configs.LLAMA3_8B,
                               args.seed, card, "14b", plain_turns=True)
    log("14b tensor-parallel LLMEngine: " + json.dumps(tp_llama))
    marks.append(('14b', time.perf_counter()))
    del params
    torch.cuda.empty_cache()
    moe_ref = check_remat_and_moe_reference(torch, models, card, full_grads)
    del full_grads
    log("remat and MoE reference: " + json.dumps(moe_ref))
    remat = remat_turns(torch, models, attention, args.steps, args.seed, card)
    log("remat turns: " + json.dumps(remat))
    marks.append(('9-10 remat', time.perf_counter()))
    moe_train = moe_train_path(torch, models, attention, args.steps, args.seed, card)
    log("mixtral train: " + json.dumps(moe_train))
    marks.append(('11a', time.perf_counter()))
    moe_serve = moe_serve_path(torch, models, attention, args.seed, card)
    log("mixtral serve: " + json.dumps(moe_serve))
    marks.append(('11b, 14c', time.perf_counter()))
    sharded = mesh_phase(torch, models, attention, args.steps, args.seed, card)
    log("sharded train: " + json.dumps(sharded))
    marks.append(('12', time.perf_counter()))
    piped = pipeline_phase(torch, models, attention, args.steps, args.seed, card)
    log("pipeline and context parallel: " + json.dumps(piped))
    marks.append(('13', time.perf_counter()))
    experts = expert_mesh_phase(torch, models, attention, args.steps, args.seed, card)
    log("14a/d expert parallelism: " + json.dumps(experts))
    marks.append(('14a, 14d', time.perf_counter()))
    late = import_and_rllib_phase(torch, models, attention, args.seed, card)
    log("15-16 HF import and RLlib: " + json.dumps(late))
    marks.append(('15-16', time.perf_counter()))
    dreamer = dreamer_and_offline_phase(torch, args.seed, card)
    log("17 DreamerV3 and offline learners: " + json.dumps(dreamer))
    marks.append(('17', time.perf_counter()))
    t0 = time.perf_counter()
    runtime = runtime_phase(torch, models, attention, args.steps, args.seed, card)
    log(f"18 task/actor core ({time.perf_counter() - t0:.1f} s): " + json.dumps(runtime))
    marks.append(("18", time.perf_counter()))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cluster = cluster_phase(torch, models, attention, CLUSTER_STEPS, args.seed, card)
    log(f"19 multi-process runtime ({time.perf_counter() - t0:.1f} s): "
        + json.dumps(cluster))
    marks.append(("19", time.perf_counter()))
    t0 = time.perf_counter()
    plane = serve_plane_phase(torch, models, attention, args.seed, card, phase6=serve_run)
    log(f"20 serve plane ({time.perf_counter() - t0:.1f} s): " + json.dumps(plane))
    marks.append(("20", time.perf_counter()))
    t0 = time.perf_counter()
    direct = cluster["actor_train"]["direct"]
    same = CLUSTER_STEPS == TRAIN_PLANE_STEPS  # 19b's direct run: the same steps
    trainer = train_plane_phase(
        torch, models, attention, args.seed, card,
        reference=direct["losses"] if same else None,
        direct_step_ms=direct["median_step_ms"] if same else None,
        phase4_mfu=run["mfu_bf16_989"],
        then=functools.partial(data_plane_phase, torch, models, attention, args.seed, card))
    data = trainer.pop("then")
    log(f"21 train plane ({trainer['phase_s']:.1f} s): " + json.dumps(trainer))
    log(f"22 data plane ({data['phase_s']:.1f} s; 21-22 {time.perf_counter() - t0:.1f} s): "
        + json.dumps(data))
    marks.append(("21-22", time.perf_counter()))
    log("phase seconds: " + json.dumps(
        {name: round(t - prev, 1) for (_, prev), (name, t) in zip(marks, marks[1:])}
        | {"total": round(marks[-1][1] - marks[0][1], 1)}))

    kernels = []
    for name, replaces in KERNELS.items():
        main_shape = rows[name]["shapes"][0]  # bench-350m, bf16, causal
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": run["launches"][name],
            # This slice's main path: the mixtral-8x7b train steps of phase 11a.
            "launches_mixtral_8x7b_train": moe_train["launches"][name],
            # This slice's main path: phase 12b's bench-1b4 mesh steps.
            "launches_bench_1b4_mesh_train": sharded["bench_1b4"]["launches"][name],
            # This slice's main paths: phase 13a's pipeline steps and 13b's
            # Ulysses call.
            "launches_bench_350m_pipeline_train":
                piped["bench_350m_pipeline"]["launches"][name],
            "launches_ulysses": piped["context_parallel"]["launches"]["ulysses"][name],
            # This slice's main path: phase 14a's mixtral-8x7b mesh steps.
            "launches_mixtral_8x7b_mesh_train":
                experts["mixtral_8x7b_mesh"]["launches"][name],
            # This slice's paths: 15b(i)'s forward on the imported llama3-8b
            # widths (D 128), and 15a's TINY (D 16, padded to 64).
            "launches_hf_llama3_8b_forward":
                late["hf_reference"]["launches"][name],
            "launches_tiny_padded": late["tiny_padded"]["launches"][name],
            # This slice's main path: 18a's steps inside the num_gpus=1 actor.
            "launches_bench_350m_actor_train":
                runtime["actor_train"]["launches"][name],
            # This slice's main path: 19b's steps inside the num_gpus=1
            # actor in a worker process, counted by that process.
            "launches_bench_350m_cluster_actor_train":
                cluster["actor_train"]["launches"][name],
            # Phase 20: the llama3-8b replica's own counters over phase 6's
            # traffic (serving computes attention without the kernels).
            "launches_llama3_8b_serve_replica":
                plane["traffic"]["replica_kernel_launches"][name],
            # Phase 21a: the clean fit's steps in TorchTrainer's worker,
            # counted by that process.
            "launches_bench_350m_trainer": trainer["clean"]["launches"][name],
            # Phase 22a: the steps in TorchTrainer's worker fed by
            # StreamingIngest through iter_device_batches, counted there.
            "launches_bench_350m_data_ingest": data["ingest"]["launches"][name],
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
