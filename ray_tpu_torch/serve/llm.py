"""Continuous-batching LLM engines (counterpart of `ray_tpu/serve/llm.py`).

Two engines share one public surface (generate / generate_stream /
engine_stats / shutdown):

  LLMEngine       fixed-slot: requests share a fixed set of contiguous
                  KV-cache slots (`models/decoding.py` `KVCache`), prefill
                  admits whole bucket-padded prompts, a whole-prompt
                  prefix cache skips the prefill of repeated prompts, and
                  every tick advances all active slots with one decode
                  burst. Opt-in and deprecated in the JAX package.

  PagedLLMEngine  paged/block KV cache: KV lives in a flat pool of
                  fixed-size blocks (`PagedKVCache`); each request holds a
                  block table, blocks are allocated on demand
                  (`serve/kv_cache.py` `KVBlockAllocator`), shared between
                  requests with a common prompt prefix (refcounted
                  copy-on-write), and long prompts prefill in chunks
                  interleaved with decode bursts. It also takes and hands
                  out KV frames (`import_prefix` / `export_streams`), the
                  surface disaggregated prefill and live migration use.

Both can verify prompt-lookup drafts (`speculation_k >= 2`): a tick
verifies K candidates per slot in one width-K call, exact under greedy
decoding.

Both serve MoE models (`n_experts > 0`) with exact, dropless routing.

`LLMEngine(mesh=...)` serves tensor-parallel: every rank of the mesh runs
one engine on its tp shard of the weights and the cache, the ranks' ticks
in lockstep (`dryrun_tp_serving` drives it once).

The paged engine's block pool can reserve its bytes in the node's
object store (`store=`, the arena of `serve/kv_cache.py`). Both engines
record serve spans and histograms (`serve/observability.py`) through
their `_obs_*` hooks.

`LLMDeployment` wraps either engine as a Serve deployment: build it with
`serve.deployment(LLMDeployment).bind(...)`; replicas each own an engine
and the pow-2 router spreads requests. With `disagg=True` long prompts
prefill on dedicated prefill actors (`serve/disagg.py`).
"""
from __future__ import annotations

import math
import queue
import threading
import time
import uuid
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.models.decoding import (
    cache_shardings, gather_blocks, init_cache, init_paged_cache,
    make_engine_fns, make_paged_engine_fns, make_paged_spec_fns,
    make_prefix_cache_fns, make_spec_fns, ngram_propose, sample_one,
    scatter_blocks)
from ray_tpu_torch.models.transformer import (
    TransformerConfig, init_params, param_logical_axes, resolve_device)
from ray_tpu_torch.parallel.mesh import AXIS_TENSOR, MeshConfig, build_mesh
from ray_tpu_torch.parallel.sharding import (
    TP_RULES, local_shard, local_tensor, param_shardings)
from ray_tpu_torch.serve.kv_cache import KVBlockAllocator
from ray_tpu_torch.util import tracing

# Canonical home is the typed error tree (it crosses the replica -> proxy
# wire); re-exported here for the engines' import path.
from ray_tpu_torch.exceptions import StreamQueueFullError  # noqa: F401

# A tensor-parallel engine's first rank sends its followers a plan at least
# this often when idle, so no follower waits on a collective for long; a
# follower waits this long for the request its plan admits.
LOCKSTEP_IDLE_S = 1.0
LOCKSTEP_ADMIT_S = 300.0


class _Request:
    __slots__ = ("prompt", "max_tokens", "temperature", "out_tokens",
                 "done", "error", "slot", "submitted_at", "first_token_at",
                 "token_q", "dropped", "blocks", "pos", "prefilling",
                 "no_register", "trace", "submitted_wall", "last_emit_wall")

    def __init__(self, prompt, max_tokens, temperature, stream=False,
                 trace: Optional[dict] = None):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.out_tokens: List[int] = []
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.slot = -1
        self.submitted_at = time.perf_counter()
        self.first_token_at: Optional[float] = None
        # Serve trace context ({"trace_id": <request id>, ...}, None when
        # serve tracing is off): engine tick spans parent under it, and
        # its trace_id is the request id that `export_streams` keys a
        # migration ticket by. Direct engine use (no proxy or handle
        # upstream) mints its own, so span coverage is the same with and
        # without the HTTP front. Wall clocks beside the perf counters:
        # spans need epoch stamps.
        self.trace = (trace if trace is not None
                      else tracing.serve_ctx(uuid.uuid4().hex))
        self.submitted_wall = time.time()
        self.last_emit_wall: Optional[float] = None
        # Streaming consumers read tokens as the engine emits them.
        # BOUNDED: at the bound the stream drops with an explicit error
        # (the engine frees the slot and blocks).
        self.token_q: Optional["queue.Queue"] = (
            queue.Queue(maxsize=max(1, get_config().serve_stream_queue_max))
            if stream else None)
        self.dropped = False
        self.blocks: List[int] = []   # paged engine: owned pool blocks
        self.pos = 0                  # paged engine: tokens prefilled
        self.prefilling = True        # paged engine: not yet decoding
        # Resumed contexts embed generated tokens in `prompt`: never
        # publish them as a reusable prompt prefix.
        self.no_register = False

    def emit(self, tok: int) -> None:
        self.out_tokens.append(tok)
        if self.token_q is not None and not self.dropped:
            try:
                self.token_q.put_nowait(tok)
            except queue.Full:
                self.dropped = True
                self.error = StreamQueueFullError(
                    f"stream consumer fell {self.token_q.maxsize} tokens "
                    f"behind; stream dropped "
                    f"(RAY_TPU_SERVE_STREAM_QUEUE_MAX)",
                    queue_max=self.token_q.maxsize)


class _EngineBase:
    """Request-facing surface and the loop. Subclasses provide `max_len`,
    `stats`, `device`, `eos_id`, `_spec_k`, `_spec_ngram`, `_slots`,
    `_last_tokens`, `_pending_put(req)` and `_tick()`, and start `_thread`
    on `_loop`."""

    @staticmethod
    def _resume_ctx(prompt_tokens, max_tokens, resume_tokens):
        """Fold an interrupted stream's already-emitted tokens into the
        admission context: the resumed request prefills `prompt + resume`
        and generates only the REMAINING `max_tokens - len(resume)`
        tokens, so a caller that kept the emitted prefix sees each token
        exactly once."""
        if not resume_tokens:
            return list(prompt_tokens), max_tokens, False
        ctx = list(prompt_tokens) + list(resume_tokens)
        return ctx, max(0, max_tokens - len(resume_tokens)), True

    def generate(self, prompt_tokens: List[int], *, max_tokens: int = 64,
                 temperature: float = 0.0,
                 timeout: Optional[float] = 300,
                 resume_tokens: Optional[List[int]] = None,
                 trace: Optional[dict] = None) -> List[int]:
        ctx, remaining, resumed = self._resume_ctx(
            prompt_tokens, max_tokens, resume_tokens)
        if len(ctx) >= self.max_len:
            raise ValueError(f"prompt ({len(ctx)}) >= max_len")
        if resumed and remaining == 0:
            return []
        req = _Request(ctx, remaining, temperature, trace=trace)
        req.no_register = resumed
        self.stats["requests"] += 1
        self._pending_put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.out_tokens

    def generate_stream(self, prompt_tokens: List[int], *,
                        max_tokens: int = 64, temperature: float = 0.0,
                        timeout: Optional[float] = 300,
                        resume_tokens: Optional[List[int]] = None,
                        trace: Optional[dict] = None):
        """Yield tokens as the engine produces them (TTFT = first yield;
        the loop keeps decoding other slots while the consumer reads).
        `resume_tokens` re-admits an interrupted stream: the engine
        recomputes KV for prompt+resume and yields only the
        continuation."""
        ctx, remaining, resumed = self._resume_ctx(
            prompt_tokens, max_tokens, resume_tokens)
        if len(ctx) >= self.max_len:
            raise ValueError(f"prompt ({len(ctx)}) >= max_len")
        if resumed and remaining == 0:
            return
        req = _Request(ctx, remaining, temperature, stream=True, trace=trace)
        req.no_register = resumed
        self.stats["requests"] += 1
        self._pending_put(req)
        deadline = time.monotonic() + (timeout or 300)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("generation timed out")
            try:
                tok = req.token_q.get(timeout=min(remaining, 0.25))
            except queue.Empty:
                # A dropped stream may not fit its end sentinel into the
                # full queue: the done event is the fallback signal.
                if req.done.is_set() and req.token_q.empty():
                    if req.error is not None:
                        raise req.error
                    return
                continue
            if tok is None:
                if req.error is not None:
                    raise req.error
                return
            yield tok

    def engine_stats(self) -> Dict[str, Any]:
        s = dict(self.stats)
        s["p_ttft_mean"] = (s["ttft_sum"] / s["completed"]
                            if s["completed"] else None)
        return s

    def shutdown(self, timeout: float = 30.0):
        """Stop the loop and join its thread for up to `timeout` s (a tick
        in flight on the device finishes first)."""
        self._stop = True
        self._work.set()
        self._thread.join(timeout=timeout)

    def _loop(self):
        # Clear before the tick, wait after it: a request put while the
        # tick runs sets the event again, so no wake-up is lost, and an
        # idle engine blocks in wait() instead of polling. The tick lock
        # keeps callers on other threads (import_prefix, export_streams)
        # off the cache while a tick writes it.
        with torch.no_grad():
            while not self._stop:
                self._work.clear()
                with self._tick_lock:
                    progressed = self._tick()
                if not progressed:
                    self._work.wait()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. A copy, so later edits of
        the host state cannot reach a queued step; pinned on CUDA, so the
        copy does not wait for the work already queued."""
        t = torch.from_numpy(np.array(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _temp(self, temperature: float) -> torch.Tensor:
        return torch.tensor(temperature, dtype=torch.float32,
                            device=self.device)

    def _free_slot(self) -> int:
        for i, r in enumerate(self._slots):
            if r is None:
                return i
        return -1

    def _emit(self, slot: int, req: "_Request", toks) -> int:
        """Emit `toks` to `req` in order, stopping at its max_tokens (the
        over-generated tail is trimmed) and after its eos. Returns the
        number emitted."""
        n0 = len(req.out_tokens)
        for tok in toks:
            tok = int(tok)
            if len(req.out_tokens) >= req.max_tokens:
                break
            req.emit(tok)
            self._last_tokens[slot] = tok
            self.stats["tokens_generated"] += 1
            if self.eos_id is not None and tok == self.eos_id:
                break
        return len(req.out_tokens) - n0

    def _drafts(self, rows, width: int):
        """Speculative candidates for the (row, slot) pairs `rows`: a
        (width, K) matrix whose column 0 is each slot's last token and
        whose other columns are its n-gram proposals, padded with the last
        token (a padding token that happens to be accepted is by
        definition the true greedy continuation). Sampled slots propose
        nothing. Returns (candidates, slots with a draft, greedy slots)."""
        k = self._spec_k
        cand = np.zeros((width, k), np.int32)
        drafted = greedy = 0
        for j, i in rows:
            req = self._slots[i]
            cand[j] = self._last_tokens[i]
            if req.temperature == 0.0:
                greedy += 1
                props = ngram_propose(req.prompt + req.out_tokens, k - 1,
                                      self._spec_ngram)
                cand[j, 1:1 + len(props)] = props
                drafted += bool(props)
        return cand, drafted, greedy

    @staticmethod
    def _spec_pays(drafted: int, greedy: int, total: int) -> bool:
        """Verify only when a majority of the greedy slots carry a draft
        and greedy slots are a majority of the `total` active ones: slots
        without a draft advance one token per verify call, so a lone
        drafted slot must not take the burst-deep decode from the rest."""
        return drafted > 0 and 2 * drafted >= greedy and 2 * greedy >= total

    def _finish_request(self, req: "_Request") -> None:
        """Complete one request: stats + stream sentinel + done event."""
        self.stats["completed"] += 1
        if req.first_token_at is not None:
            self.stats["ttft_sum"] += (req.first_token_at
                                       - req.submitted_at)
        if req.token_q is not None:
            try:
                req.token_q.put_nowait(None)  # stream sentinel
            except queue.Full:
                pass  # dropped stream: done event carries the signal
        req.done.set()

    def _end_with_error(self, req: "_Request", e: BaseException) -> None:
        req.error = e
        if req.token_q is not None:
            try:
                req.token_q.put_nowait(None)
            except queue.Full:
                pass
        req.done.set()
        self._work.set()   # the freed slot may admit the queue head

    # -- serving observability ------------------------------------------
    # Spans attribute each engine phase (queue_wait / prefill_chunk /
    # decode_burst) to the request's trace; histograms decompose TTFT /
    # ITL per app.  Spans gate on req.trace (None when the
    # RAY_TPU_SERVE_TRACE_ENABLED kill switch is off); histograms record
    # either way.  The app tag is learned lazily from traced requests —
    # standalone engines (bench, unit tests) report under "-".
    _app_hint = "-"

    def _obs_app(self, req: "_Request") -> str:
        app = req.trace.get("app") if req.trace else None
        if app:
            self._app_hint = app
            return app
        return self._app_hint

    def _obs_admitted(self, req: "_Request") -> None:
        from ray_tpu_torch.serve import observability

        now = time.time()
        tracing.record_serve_span(req.trace, "serve.engine.queue_wait",
                                  req.submitted_wall, now,
                                  tokens=len(req.prompt))
        observability.observe_phase(self._obs_app(req), "queue_wait",
                                    now - req.submitted_wall)

    def _obs_first_token(self, req: "_Request") -> None:
        from ray_tpu_torch.serve import observability

        observability.metrics()["ttft"].observe(
            req.first_token_at - req.submitted_at,
            {"app": self._obs_app(req)})
        req.last_emit_wall = time.time()

    def _obs_prefill(self, req: "_Request", t0: float,
                     n_tokens: int) -> None:
        from ray_tpu_torch.serve import observability

        t1 = time.time()
        tracing.record_serve_span(req.trace, "serve.engine.prefill_chunk",
                                  t0, t1, tokens=n_tokens, pos=req.pos)
        observability.observe_phase(self._obs_app(req), "prefill", t1 - t0)

    def _obs_burst(self, req: "_Request", t0: float, t1: float,
                   n_new: int) -> None:
        """Per fused-burst, per-request: one decode_burst span, one
        decode_step phase sample, and ONE inter-token-latency sample at
        the burst-mean gap (per-token observes would cost more than the
        decode itself at small models)."""
        if n_new <= 0:
            return
        from ray_tpu_torch.serve import observability

        app = self._obs_app(req)
        tracing.record_serve_span(req.trace, "serve.engine.decode_burst",
                                  t0, t1, tokens=n_new)
        observability.observe_phase(app, "decode_step", t1 - t0)
        if req.last_emit_wall is not None and t1 > req.last_emit_wall:
            observability.metrics()["itl"].observe(
                (t1 - req.last_emit_wall) / n_new, {"app": app})
        req.last_emit_wall = t1


class LLMEngine(_EngineBase):
    """Fixed-slot engine over the contiguous KV cache.

    Engine tick: [admit one waiting request into a free slot: a prefix-
    cache hit copies its stored KV, a miss prefills the bucket-padded
    prompt] -> [one verify call, when speculation is on and enough slots
    carry drafts, else one decode burst over every slot]. Device work is
    always num_slots wide; inactive slots ride along and keep their cache.

    Runs on `device` ("cuda" by default; "cpu" runs the same code on CPU
    tensors). Tokens come back to the host once per burst.

    With a `mesh` (whose device type replaces `device`) it serves tensor-
    parallel, as the JAX engine does: the params are split over the
    mesh's tp axis by `TP_RULES`, each rank copying only its shard to its
    device (pass host tensors, and no rank holds the whole model), and
    the cache over kv heads (`cache_shardings`). Every rank of the mesh
    builds the engine and is given the same requests in the same order,
    as every rank of an SPMD program runs the same code; ranks apart on
    other axes than tp are replicas. Every rank computes the whole logits
    and samples them with the same seeded generator, so all emit the same
    tokens. While the engine runs, its loop thread issues collectives
    over the mesh's groups: the caller issues none there until
    `shutdown()`.
    """

    def __init__(self, cfg: TransformerConfig, params, *, num_slots: int = 8,
                 max_len: int = 1024, prefill_buckets=(64, 128, 256, 512),
                 eos_id: Optional[int] = None, seed: int = 0,
                 max_burst: int = 8, prefix_cache_size: int = 4,
                 speculation_k: int = 0, speculation_ngram: int = 2,
                 mesh: DeviceMesh | None = None,
                 device: torch.device | str = "cuda"):
        if mesh is not None:
            tp = mesh.size(mesh.mesh_dim_names.index(AXIS_TENSOR)) \
                if AXIS_TENSOR in mesh.mesh_dim_names else 1
            for dim_name, dim in (("n_kv_heads", cfg.n_kv_heads),
                                  ("n_heads", cfg.n_heads),
                                  ("d_ff", cfg.d_ff),
                                  ("vocab_size", cfg.vocab_size)):
                if dim % tp:
                    raise ValueError(
                        f"tensor parallelism {tp} does not divide "
                        f"{dim_name}={dim} for model {cfg.name!r} — "
                        f"pick a tp that divides all sharded dims")
            device = mesh.device_type
            params = _local_shards(params, param_shardings(
                param_logical_axes(cfg), mesh, TP_RULES))
        self.device = resolve_device(device)
        self.cfg = cfg
        with torch.no_grad():
            self.params = _to_compute(params, cfg.compute_dtype, self.device)
        # The ranks tick in lockstep (`_loop`); one rank needs no plan.
        self._lockstep = mesh if mesh is not None and mesh.size() > 1 else None
        self.num_slots = num_slots
        self.max_len = max_len
        self.buckets = tuple(b for b in sorted(prefill_buckets)
                             if b <= max_len)
        self.eos_id = eos_id
        # EOS is only checked between bursts, so with an eos_id short
        # bursts trade throughput for less overshoot.
        self.max_burst = max(1, max_burst if eos_id is None else
                             min(max_burst, 4))
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = init_cache(
            cfg, num_slots, max_len, device=self.device,
            shardings=None if mesh is None else cache_shardings(mesh))
        self._prefill, self._decode = make_engine_fns(cfg, mesh)
        # Whole-prompt prefix cache: a repeated prompt skips prefill (one
        # device copy of its snapshotted KV + one sampling call). The
        # insertion-ordered dict is the LRU; 0 disables.
        self._prefix_cache_size = max(0, prefix_cache_size)
        self._prefix_cache: Dict[tuple, dict] = {}
        self._px_extract, self._px_insert, self._px_sample = \
            make_prefix_cache_fns()
        self._spec_k = speculation_k if speculation_k >= 2 else 0
        self._spec_ngram = max(1, speculation_ngram)
        # _maybe_finish keeps a margin of one advance (a burst or a verify
        # window) below max_len, without deepening the burst itself.
        self._advance_margin = max(self.max_burst, self._spec_k)
        self._verify = make_spec_fns(cfg, mesh)
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._slots: List[Optional[_Request]] = [None] * num_slots
        self._last_tokens = np.zeros((num_slots,), np.int32)
        self._work = threading.Event()
        self._stop = False
        self._tick_lock = threading.Lock()
        self.stats = {"requests": 0, "tokens_generated": 0,
                      "ttft_sum": 0.0, "completed": 0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "spec_proposed": 0, "spec_accepted": 0}
        # Host clock per decode burst, as PagedLLMEngine.burst_log; the
        # lanes are always num_slots wide. Bounded.
        self.burst_log: deque = deque(maxlen=4096)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    def _pending_put(self, req: "_Request") -> None:
        self._pending.put(req)
        self._work.set()

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_len

    def _loop(self):
        if self._lockstep is None:
            return super()._loop()
        # Each rank runs its own engine, and a loop that chose its ticks
        # from its own request queue could admit a request on another tick
        # than its peers: their collectives would then differ, and the
        # ranks deadlock. (The JAX engine is one controller over all the
        # devices: one queue, one choice.) So the mesh's first rank plans
        # each tick (stop, or admit its queue head) and the others follow;
        # the tick's other choices (verify or decode) are planned the same
        # way, and the burst depth is the engine's constant.
        leads = all(c == 0 for c in self._lockstep.get_coordinate())
        with torch.no_grad():
            while True:
                self._work.clear()
                with self._tick_lock:
                    stop, admit = self._plan(
                        self._stop, self._free_slot() >= 0 and not self._pending.empty())
                    if stop:
                        return
                    progressed = self._tick(bool(admit))
                if not progressed and leads:
                    self._work.wait(LOCKSTEP_IDLE_S)

    def _plan(self, *choices) -> list:
        """This tick's `choices` as the mesh's first rank made them, on
        every rank (a rank's own, without a lockstep mesh)."""
        if self._lockstep is None:
            return [int(c) for c in choices]
        plan = torch.tensor([int(c) for c in choices], dtype=torch.int64)
        _broadcast_from_first(plan, self._lockstep)
        return plan.tolist()

    def _admit(self, admit: Optional[bool] = None) -> bool:
        """Admit the queue head into a free slot, if both exist; under a
        lockstep plan (`admit`), exactly when the plan says, waiting for
        the request the plan's first rank admits."""
        slot = self._free_slot()
        if slot < 0 or admit is False:
            return False
        try:
            req = (self._pending.get_nowait() if admit is None else
                   self._pending.get(timeout=LOCKSTEP_ADMIT_S))
        except queue.Empty:
            if admit:
                raise RuntimeError(
                    f"the tick plan admits a request and none came in "
                    f"{LOCKSTEP_ADMIT_S} s: every rank of the mesh must be "
                    f"given the same requests") from None
            return False
        try:
            self._obs_admitted(req)
            n = len(req.prompt)
            key = tuple(req.prompt)
            entry = (self._prefix_cache.get(key)
                     if self._prefix_cache_size else None)
            if entry is not None:
                # Hit: copy the snapshotted KV in and re-sample the stored
                # last-token logits under THIS request's temperature.
                self.cache = self._px_insert(self.cache, entry["k"],
                                             entry["v"], slot, n)
                tok = self._px_sample(entry["logits"],
                                      self._temp(req.temperature), self._gen)
                self._prefix_cache[key] = self._prefix_cache.pop(key)
                self.stats["prefix_hits"] += 1
            else:
                t0 = time.time()
                bucket = self._bucket_for(n)
                toks = np.zeros((1, bucket), np.int32)
                toks[0, :n] = req.prompt
                self.cache, tok, last_logits = self._prefill(
                    self.params, self.cache, self._dev(toks), slot, n,
                    req.temperature, self._gen)
                self.stats["prefix_misses"] += 1
                self._obs_prefill(req, t0, n)
                if self._prefix_cache_size:
                    # Snapshot only the prompt's bucket of KV.
                    k_slice, v_slice = self._px_extract(self.cache, slot,
                                                        bucket)
                    self._prefix_cache[key] = {"k": k_slice, "v": v_slice,
                                               "logits": last_logits}
                    while len(self._prefix_cache) > self._prefix_cache_size:
                        self._prefix_cache.pop(next(iter(self._prefix_cache)))
            tok = int(tok)
            req.first_token_at = time.perf_counter()
            self._obs_first_token(req)
            req.emit(tok)
            req.slot = slot
            self._slots[slot] = req
            self._last_tokens[slot] = tok
            self._maybe_finish(slot)
        except BaseException as e:  # noqa: BLE001
            self._fail_request(req, e)
        return True

    def _fail_request(self, req: "_Request", e: BaseException) -> None:
        if 0 <= req.slot < self.num_slots and self._slots[req.slot] is req:
            self._slots[req.slot] = None
        self._end_with_error(req, e)

    def _maybe_finish(self, slot: int) -> None:
        req = self._slots[slot]
        if req is None:
            return
        tok = req.out_tokens[-1] if req.out_tokens else None
        hit_eos = self.eos_id is not None and tok == self.eos_id
        full = (len(req.prompt) + len(req.out_tokens)
                >= self.max_len - 1 - self._advance_margin)
        if hit_eos or full or len(req.out_tokens) >= req.max_tokens \
                or req.dropped:
            self._slots[slot] = None
            self._finish_request(req)

    def _spec_tick(self, active_mask: np.ndarray, temps: np.ndarray) -> bool:
        """One verify call over every slot. False when too few slots carry
        a draft: the caller runs the plain burst instead."""
        live = [(i, i) for i, r in enumerate(self._slots) if r is not None]
        cand, drafted, greedy = self._drafts(live, self.num_slots)
        if not self._plan(self._spec_pays(drafted, greedy,
                                          int(active_mask.sum())))[0]:
            return False
        # Every candidate column of a greedy slot counts as proposed:
        # padding can be accepted too, and accepted never exceeds proposed.
        self.stats["spec_proposed"] += (self._spec_k - 1) * greedy
        self.cache, tok_out, accepted = self._verify(
            self.params, self.cache, self._dev(cand), self._dev(active_mask),
            self._dev(temps), self._gen)
        tok_out, accepted = tok_out.cpu().numpy(), accepted.cpu().numpy()
        for i, _ in live:
            a = int(accepted[i])
            self.stats["spec_accepted"] += a
            self._emit(i, self._slots[i], tok_out[i, :a + 1])
            self._maybe_finish(i)
        return True

    def _tick(self, admit: Optional[bool] = None) -> bool:
        admitted = self._admit(admit)
        active_mask = np.array([r is not None for r in self._slots])
        if not active_mask.any():
            return admitted
        try:
            temps = np.array([r.temperature if r else 0.0
                              for r in self._slots], np.float32)
            if self._spec_k and self._spec_tick(active_mask, temps):
                return True
            # One burst depth, one shape: slots that reach max_tokens
            # mid-burst over-generate and are trimmed; _maybe_finish's
            # margin keeps the burst inside the cache.
            burst = self.max_burst
            kv_tokens = sum(len(r.prompt) + len(r.out_tokens) - 1
                            for r in self._slots if r is not None)
            w0 = time.time()
            t0 = time.perf_counter()
            self.cache, tok_mat = self._decode(
                self.params, self.cache, self._dev(self._last_tokens),
                self._dev(active_mask), self._dev(temps), self._gen,
                n_steps=burst)
            t_enq = time.perf_counter()
            tok_mat = tok_mat.cpu().numpy()          # (burst, S)
            t1 = time.perf_counter()
            w1 = time.time()
            emitted = 0
            for i, req in enumerate(self._slots):
                if req is None:
                    continue
                n_new = self._emit(i, req, tok_mat[:, i])
                emitted += n_new
                self._obs_burst(req, w0, w1, n_new)
                self._maybe_finish(i)
            self.burst_log.append((t0, t_enq, t1, self.num_slots, emitted,
                                   int(active_mask.sum()), kv_tokens))
        except BaseException as e:  # noqa: BLE001
            for req in self._slots:
                if req is not None:
                    self._fail_request(req, e)
        return True


class PagedLLMEngine(_EngineBase):
    """Paged/block KV-cache engine.

    Engine tick: [admit waiting requests] -> [one decode burst, or one
    verify call when speculation is on and enough slots carry drafts,
    over every DECODING slot] -> [prefill chunks for the oldest PREFILLING
    slots, up to `prefill_chunk` tokens]. Decode never waits for a whole
    prompt: a max-length prompt occupies at most `prefill_chunk` tokens of
    device time per tick, bounding the inter-token latency of active
    streams.

    Admission: a request needs pool blocks covering its (non-shared)
    prompt remainder. When the pool can't cover it, the request WAITS at
    the head of the queue (no error) until completions free blocks.

    Runs on `device` ("cuda" by default; "cpu" runs the same code on CPU
    tensors). Tokens come back to the host once per burst.
    """

    def __init__(self, cfg: TransformerConfig, params, *,
                 num_slots: int = 32, max_len: int = 1024,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 max_burst: int = 8, prefix_sharing: Optional[bool] = None,
                 speculation_k: Optional[int] = None,
                 speculation_ngram: Optional[int] = None,
                 store=None, device: torch.device | str = "cuda"):
        knobs = get_config()
        self.device = resolve_device(device)
        self.cfg = cfg
        # The JAX step casts the fp32 masters to the compute dtype inside
        # every call; the copy made once here holds the same values, and
        # casting ~32 GB of masters per step would set llama3-8b's
        # decode time.
        with torch.no_grad():
            self.params = _to_compute(params, cfg.compute_dtype, self.device)
        self.num_slots = num_slots
        self.max_len = max_len
        self.block_size = block_size or knobs.kv_block_size
        # Default pool budget == a fixed-slot reservation for the same
        # (num_slots, max_len). +1 for the null block.
        self.num_blocks = (num_blocks or knobs.kv_block_count
                           or (num_slots * max_len) // self.block_size + 1)
        self.prefill_chunk = prefill_chunk or knobs.serve_prefill_chunk
        # Shape tiers (powers of two) keep device work proportional to
        # LOAD, not capacity: a burst over 3 active streams runs at width
        # 4, not num_slots; a 16-token chunk runs at width 32, not
        # prefill_chunk.
        self._width_tiers = self._tiers(4, num_slots)
        self._chunk_tiers = self._tiers(32, self.prefill_chunk)
        self.eos_id = eos_id
        self.max_burst = max(1, max_burst if eos_id is None else
                             min(max_burst, 4))
        if speculation_k is None:
            speculation_k = knobs.serve_speculation_k
        if speculation_ngram is None:
            speculation_ngram = knobs.serve_speculation_ngram
        self._spec_k = speculation_k if speculation_k >= 2 else 0
        self._spec_ngram = max(1, speculation_ngram)
        # A tick advances a burst or a verify window: _maybe_finish's
        # margin and the tables' growth cover whichever is larger.
        self._advance_margin = max(self.max_burst, self._spec_k)
        self._b_max = math.ceil(max_len / self.block_size)
        prefix_sharing = (knobs.kv_block_prefix_sharing
                          if prefix_sharing is None else prefix_sharing)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = init_paged_cache(cfg, self.num_blocks, self.block_size,
                                      device=self.device)
        self._prefill_chunk_fn, self._decode, self._copy_block = \
            make_paged_engine_fns(cfg)
        self._verify = make_paged_spec_fns(cfg)
        # The pool's bytes, reserved in the node's object store when the
        # engine is given one (the arena; `serve/kv_cache.py`).
        bytes_per_block = (2 * cfg.n_layers * self.block_size
                           * cfg.n_kv_heads * cfg.head_dim
                           * cfg.compute_dtype.itemsize)
        self.allocator = KVBlockAllocator(
            self.num_blocks, self.block_size, store=store,
            bytes_per_block=bytes_per_block if store is not None else 0,
            prefix_sharing=prefix_sharing)
        # Host-side engine state: per-slot block tables + lengths (the
        # device step only ever sees fixed (S, B_max) arrays).
        self._tables = np.zeros((num_slots, self._b_max), np.int32)
        self._lengths = np.zeros((num_slots,), np.int32)
        self._last_tokens = np.zeros((num_slots,), np.int32)
        self._slots: List[Optional[_Request]] = [None] * num_slots
        self._prefillq: deque = deque()   # slots awaiting prefill chunks
        self._pending: deque = deque()
        self._pending_lock = threading.Lock()
        self._work = threading.Event()
        self._stop = False
        self._tick_lock = threading.Lock()
        self.stats = {"requests": 0, "tokens_generated": 0,
                      "ttft_sum": 0.0, "completed": 0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefill_chunks": 0, "queue_waits": 0,
                      "preemptions": 0, "adopted_blocks": 0,
                      "migrated_blocks": 0, "migrate_fallbacks": 0,
                      "disagg_prefills": 0,
                      "spec_proposed": 0, "spec_accepted": 0}
        # Host clock per decode burst (perf_counter s): start, enqueued
        # (the burst function returned), tokens on the host; the lane
        # width, the tokens emitted, the active lanes and the KV tokens
        # they held at the burst's start. `verify_log` holds the same for
        # each verify call. Bounded.
        self.burst_log: deque = deque(maxlen=4096)
        self.verify_log: deque = deque(maxlen=4096)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="paged-llm-engine")
        self._thread.start()

    def _pending_put(self, req: "_Request") -> None:
        with self._pending_lock:
            self._pending.append(req)
        self._work.set()

    def engine_stats(self) -> Dict[str, Any]:
        s = super().engine_stats()
        s.update(self.allocator.snapshot())
        s["arena_in_store"] = self.allocator.arena_in_store
        s["queue_depth"] = len(self._pending)
        s["active"] = sum(1 for r in self._slots if r is not None)
        return s

    def warmup(self) -> None:
        """Run every width and chunk tier once (first launches, library
        handles). Inactive-lane calls scatter into the null block:
        garbage no request reads."""
        with torch.no_grad():
            for w in self._width_tiers:
                z = self._dev(np.zeros((w,), np.int32))
                tables = self._dev(np.zeros((w, self._b_max), np.int32))
                off = self._dev(np.zeros((w,), bool))
                temps = self._dev(np.zeros((w,), np.float32))
                self.cache, _ = self._decode(
                    self.params, self.cache, z, tables, z, off, temps,
                    self._gen, n_steps=self.max_burst)
                if self._spec_k:
                    self.cache, _, _ = self._verify(
                        self.params, self.cache,
                        self._dev(np.zeros((w, self._spec_k), np.int32)),
                        tables, z, off, temps, self._gen)
            for c in self._chunk_tiers:
                self.cache, _ = self._prefill_chunk_fn(
                    self.params, self.cache,
                    self._dev(np.zeros((c,), np.int32)),
                    self._dev(np.zeros((self._b_max,), np.int32)), 0, 1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def shutdown(self, timeout: float = 30.0):
        super().shutdown(timeout)
        # Return the arena to the store (the leak guard's baseline).
        self.allocator.release()

    def gauges(self) -> Dict[str, float]:
        """Cheap autoscaling signals."""
        snap = self.allocator.snapshot()
        return {"queue_depth": float(len(self._pending)),
                "active": float(sum(1 for r in self._slots
                                    if r is not None)),
                "occupancy": snap["occupancy"]}

    # -- engine loop ----------------------------------------------------
    @staticmethod
    def _tiers(lo: int, hi: int) -> List[int]:
        out = []
        w = lo
        while w < hi:
            out.append(w)
            w *= 2
        out.append(hi)
        return out

    def _tier_for(self, tiers: List[int], n: int) -> int:
        for t in tiers:
            if n <= t:
                return t
        return tiers[-1]

    def _table_row(self, slot: int, blocks: List[int]) -> None:
        self._tables[slot, :] = 0
        self._tables[slot, :len(blocks)] = blocks

    def _sample_first(self, logits: torch.Tensor, temperature: float) -> int:
        return int(sample_one(logits, self._temp(temperature), self._gen))

    def _admit_one(self) -> bool:
        slot = self._free_slot()
        if slot < 0:
            return False
        with self._pending_lock:
            req = self._pending[0] if self._pending else None
        if req is None:
            return False
        bs = self.block_size
        n = len(req.prompt)
        shared, covered, meta = self.allocator.lookup_prefix(req.prompt)
        if covered == n and meta is None and shared:
            # Whole-prompt chain without stored logits (evicted): fall
            # back to re-prefilling the tail chunk.
            self.allocator.free(shared[-1:])
            shared = shared[:-1]
            covered = len(shared) * bs
        need = math.ceil(n / bs) - len(shared)
        # Admission wants one burst of decode growth on top of the
        # prompt: cuts (but can't eliminate; preemption is the backstop)
        # admit-then-deadlock on growth blocks.
        headroom = need + math.ceil(self.max_burst / bs)
        alloc = ((self.allocator.alloc(need)
                  if self.allocator.can_alloc(headroom) else None)
                 if need > 0 else [])
        if alloc is None:
            # Pool exhausted: the request WAITS at the queue head (no
            # error); completions free blocks and wake the loop.
            self.allocator.free(shared)
            self.stats["queue_waits"] += 1
            return False
        with self._pending_lock:
            self._pending.popleft()
        self._obs_admitted(req)
        blocks = shared + alloc
        req.blocks = blocks
        req.slot = slot
        req.pos = covered
        self._slots[slot] = req
        self._table_row(slot, blocks)
        self._lengths[slot] = 0
        if covered > 0:
            self.stats["prefix_hits"] += 1
        if covered == n:
            # Whole-prompt hit: sample the first token from the stored
            # last-logits under THIS request's temperature, no prompt
            # forward at all. COW the (shared) partial tail before decode
            # appends into it.
            try:
                self._cow_tail(req)
                self._begin_decode(req, self._sample_first(
                    meta, req.temperature))
            except BaseException as e:  # noqa: BLE001
                self._fail_request(req, e)
            return True
        if covered == 0:
            self.stats["prefix_misses"] += 1
        self._prefillq.append(slot)
        return True

    def _cow_tail(self, req: "_Request", n_ctx: Optional[int] = None
                  ) -> None:
        """Give `req` an exclusively owned, writable tail block (device
        copy when the tail is shared or registered)."""
        n = len(req.prompt) if n_ctx is None else n_ctx
        if n % self.block_size == 0 or not req.blocks:
            return  # aligned: first append allocates a fresh block
        tail = req.blocks[-1]
        new, copied = self.allocator.cow(tail)
        if copied:
            self.cache = self._copy_block(self.cache, new, tail)
            req.blocks[-1] = new
            self._table_row(req.slot, req.blocks)

    def _begin_decode(self, req: "_Request", first_tok: int) -> None:
        # KV written so far = the prefilled context (a preempted request
        # re-enters here with out_tokens already emitted).
        n_ctx = len(req.prompt) + len(req.out_tokens)
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
            self._obs_first_token(req)
        req.prefilling = False
        req.emit(first_tok)
        self._last_tokens[req.slot] = first_tok
        self._lengths[req.slot] = n_ctx
        self._maybe_finish(req.slot)

    def _fail_request(self, req: "_Request", e: BaseException) -> None:
        slot = req.slot
        if 0 <= slot < self.num_slots and self._slots[slot] is req:
            self._slots[slot] = None
            self._tables[slot, :] = 0
        if slot in self._prefillq:
            self._prefillq.remove(slot)
        self.allocator.free(req.blocks)
        req.blocks = []
        self._end_with_error(req, e)

    def _prefill_tick(self) -> bool:
        """Prefill chunks in FIFO order under a TOKEN budget of
        `prefill_chunk` per engine tick: a max-length prompt consumes the
        whole budget in one wide chunk (then yields the device back to
        decode: the ITL bound), while a tickful of short prompts batches
        several narrow chunks into the same budget."""
        budget = self.prefill_chunk
        progressed = False
        while self._prefillq and budget > 0:
            slot = self._prefillq[0]
            req = self._slots[slot]
            if req is None:
                self._prefillq.popleft()
                continue
            try:
                # Preempted requests re-prefill their WHOLE context:
                # prompt plus the tokens already emitted (the stream keeps
                # every token; only the KV is recomputed).
                ctx = req.prompt + req.out_tokens
                n = len(ctx)
                if not req.blocks:   # preemption freed them: re-alloc
                    # Resume only with one burst of growth headroom on top
                    # of the context, or the resumed request re-stalls on
                    # the blocks it just freed and ping-pongs.
                    bs = self.block_size
                    headroom = math.ceil((n + self.max_burst) / bs)
                    alloc = (self.allocator.alloc(math.ceil(n / bs))
                             if self.allocator.can_alloc(headroom)
                             else None)
                    if alloc is None:
                        self.stats["queue_waits"] += 1
                        break        # wait for completions to free blocks
                    req.blocks = alloc
                    self._table_row(slot, req.blocks)
                t0 = time.time()
                nv = min(budget, n - req.pos)
                c = self._tier_for(self._chunk_tiers, nv)
                nv = min(nv, c)
                toks = np.zeros((c,), np.int32)
                toks[:nv] = ctx[req.pos:req.pos + nv]
                self.cache, last_logits = self._prefill_chunk_fn(
                    self.params, self.cache, self._dev(toks),
                    self._dev(self._tables[slot]), req.pos, nv)
                req.pos += nv
                budget -= nv
                progressed = True
                self.stats["prefill_chunks"] += 1
                self._obs_prefill(req, t0, nv)
                if req.pos >= n:
                    self._prefillq.popleft()
                    if not req.out_tokens and not req.no_register:
                        # Publish the prompt's blocks for prefix reuse
                        # BEFORE our own appends diverge the tail (COW
                        # keeps the registered copy pristine).
                        self.allocator.register_prefix(
                            req.prompt, req.blocks, meta=last_logits)
                    self._cow_tail(req, n)
                    self._begin_decode(req, self._sample_first(
                        last_logits, req.temperature))
            except BaseException as e:  # noqa: BLE001
                if self._prefillq and self._prefillq[0] == slot:
                    self._prefillq.popleft()
                self._fail_request(req, e)
        return progressed

    def _ensure_blocks(self, req: "_Request", upto: int) -> bool:
        """Extend `req`'s table to cover positions [0, upto), allocating
        on demand. False = pool exhausted; the slot sits out this burst
        (it resumes when completions free blocks)."""
        need = math.ceil(upto / self.block_size) - len(req.blocks)
        if need <= 0:
            return True
        alloc = self.allocator.alloc(need)
        if alloc is None:
            return False
        req.blocks.extend(alloc)
        self._table_row(req.slot, req.blocks)
        return True

    def _decode_tick(self) -> bool:
        burst = self.max_burst
        idx: List[int] = []
        stalled: List[int] = []
        for i, req in enumerate(self._slots):
            if req is None or req.prefilling:
                continue
            # Cover a burst or a verify window, whichever is longer, so
            # the choice between them below needs no second allocation
            # and a verify call never scatters past the table.
            if self._ensure_blocks(req, int(self._lengths[i])
                                   + self._advance_margin):
                idx.append(i)
            else:
                stalled.append(i)
        if not idx:
            if len(stalled) >= 2:
                # Deadlock: every decoder needs growth blocks and the
                # pool is exhausted by the decoders themselves. Preempt
                # the youngest (recompute preemption): its blocks free
                # the others; it re-prefills prompt+emitted later.
                self._preempt(max(stalled,
                                  key=lambda i:
                                  self._slots[i].submitted_at))
                return True   # the freed blocks let the next tick run
            return False
        # Compact the active slots into the smallest width tier: device
        # work tracks the number of LIVE streams, not the configured
        # capacity. All per-slot state is host-side, so lane mapping is
        # just row selection.
        w = self._tier_for(self._width_tiers, len(idx))
        tokens = np.zeros((w,), np.int32)
        tables = np.zeros((w, self._b_max), np.int32)
        lengths = np.zeros((w,), np.int32)
        active = np.zeros((w,), bool)
        temps = np.zeros((w,), np.float32)
        for j, i in enumerate(idx):
            tokens[j] = self._last_tokens[i]
            tables[j] = self._tables[i]
            lengths[j] = self._lengths[i]
            active[j] = True
            temps[j] = self._slots[i].temperature
        try:
            if self._spec_k and self._spec_tick(idx, tables, lengths,
                                                active, temps):
                return True
            w0 = time.time()
            t0 = time.perf_counter()
            self.cache, tok_mat = self._decode(
                self.params, self.cache, self._dev(tokens),
                self._dev(tables), self._dev(lengths), self._dev(active),
                self._dev(temps), self._gen, n_steps=burst)
            t_enq = time.perf_counter()
            tok_mat = tok_mat.cpu().numpy()          # (burst, w)
            t1 = time.perf_counter()
            w1 = time.time()
            emitted = 0
            for j, i in enumerate(idx):
                self._lengths[i] += burst   # KV written for every step
                req = self._slots[i]
                n_new = self._emit(i, req, tok_mat[:, j])
                emitted += n_new
                self._obs_burst(req, w0, w1, n_new)
                self._maybe_finish(i)
            self.burst_log.append((t0, t_enq, t1, w, emitted, len(idx),
                                   int(lengths.sum())))
        except BaseException as e:  # noqa: BLE001
            for req in self._slots:
                if req is not None:
                    self._fail_request(req, e)
        return True

    def _spec_tick(self, idx: List[int], tables, lengths, active,
                   temps) -> bool:
        """One verify call over the compacted decode lanes. False when too
        few slots carry a draft: the caller runs the plain burst. Runs
        inside _decode_tick's try block, after _ensure_blocks extended
        every lane's table over the K window, so the scatter lands in
        blocks the slot owns alone and a rejected draft is undone by
        length arithmetic."""
        cand, drafted, greedy = self._drafts(enumerate(idx),
                                             tables.shape[0])
        if not self._spec_pays(drafted, greedy, len(idx)):
            return False
        self.stats["spec_proposed"] += (self._spec_k - 1) * greedy
        w0 = time.time()
        t0 = time.perf_counter()
        self.cache, tok_out, accepted = self._verify(
            self.params, self.cache, self._dev(cand), self._dev(tables),
            self._dev(lengths), self._dev(active), self._dev(temps),
            self._gen)
        t_enq = time.perf_counter()
        tok_out, accepted = tok_out.cpu().numpy(), accepted.cpu().numpy()
        t1 = time.perf_counter()
        w1 = time.time()
        emitted = 0
        for j, i in enumerate(idx):
            a = int(accepted[j])
            self.stats["spec_accepted"] += a
            # KV was written for the whole window; only a+1 positions are
            # real, and advancing by a+1 is the rollback.
            self._lengths[i] += a + 1
            req = self._slots[i]
            n_new = self._emit(i, req, tok_out[j, :a + 1])
            emitted += n_new
            self._obs_burst(req, w0, w1, n_new)
            self._maybe_finish(i)
        self.verify_log.append((t0, t_enq, t1, tables.shape[0], emitted,
                                len(idx), int(lengths.sum())))
        return True

    def _preempt(self, slot: int) -> None:
        """Evict a stalled decoder: free its blocks (unblocking the
        others) and queue it for full-context re-prefill. The stream
        keeps every emitted token; only KV is recomputed."""
        req = self._slots[slot]
        self.allocator.free(req.blocks)
        req.blocks = []
        self._tables[slot, :] = 0
        self._lengths[slot] = 0
        req.pos = 0
        req.prefilling = True
        self._prefillq.append(slot)
        self.stats["preemptions"] += 1

    def _maybe_finish(self, slot: int) -> None:
        req = self._slots[slot]
        if req is None:
            return
        tok = req.out_tokens[-1] if req.out_tokens else None
        hit_eos = self.eos_id is not None and tok == self.eos_id
        full = (len(req.prompt) + len(req.out_tokens)
                >= self.max_len - 1 - self._advance_margin)
        if hit_eos or full or len(req.out_tokens) >= req.max_tokens \
                or req.dropped:
            self._slots[slot] = None
            self._tables[slot, :] = 0
            self.allocator.free(req.blocks)
            req.blocks = []
            self._finish_request(req)
            self._work.set()   # freed blocks may unblock the queue head

    def _tick(self) -> bool:
        progressed = False
        while self._admit_one():
            progressed = True
        progressed |= self._decode_tick()
        progressed |= self._prefill_tick()
        return progressed

    # -- disaggregated serving / live migration -------------------------
    def import_prefix(self, tokens: List[int], kv, block_size: int,
                      last_logits=None) -> int:
        """Adopt a KV frame computed by ANOTHER engine (a prefill worker's
        handoff, or a draining engine's `export_streams` ticket) into this
        pool: allocate blocks, scatter the frame, register the prefix and
        park the blocks cached-free. The next admission of a prompt that
        starts with ``tokens`` takes the ordinary prefix-hit path.

        Returns the number of blocks imported; 0 when the frame cannot be
        adopted (geometry mismatch, pool exhausted, sharing off), and the
        caller recomputes. Safe to call from any thread (tick lock).
        `kv` is a numpy array or a tensor (a prefill actor's bf16 frame
        travels as a tensor: numpy has no bfloat16)."""
        if not isinstance(kv, torch.Tensor):
            kv = np.asarray(kv)
        n_need = -(-len(tokens) // self.block_size)
        if (block_size != self.block_size or kv.ndim != 6
                or kv.shape[0] != 2
                or kv.shape[1:] != (self.cfg.n_layers, kv.shape[2],
                                    self.block_size, self.cfg.n_kv_heads,
                                    self.cfg.head_dim)
                or kv.shape[2] < n_need):
            return 0
        meta = (torch.as_tensor(last_logits, device=self.device).clone()
                if last_logits is not None else None)
        with self._tick_lock, torch.no_grad():
            blocks = self.allocator.adopt(tokens, meta=meta)
            if blocks is None:
                return 0
            self.cache = scatter_blocks(self.cache, blocks,
                                        kv[:, :, :len(blocks)])
            # Our allocation reference retires; the registered blocks park
            # cached-free with contents intact, like a finished request's
            # published prefix.
            self.allocator.free(blocks)
            return len(blocks)

    def export_streams(self) -> List[Dict[str, Any]]:
        """Snapshot every in-flight DECODING stream as a migration ticket:
        {"request_id" (its trace id), "tokens" (the context whose KV is
        written: the last emitted token's KV is pending as the next decode
        input, so it stays out), "block_size", "kv" (the covering blocks'
        frame, host numpy (2, L, n, block_size, Hkv, D))}. The receiving
        engine `import_prefix`es the frame and re-admits prompt + emitted
        with `resume_tokens`, which prefix-hits the imported chain. The KV
        round trip is exact, so a greedy stream continues as if it had
        never moved. numpy has no bfloat16: a bf16 frame ships as float32,
        which holds every bf16 value exactly."""
        out: List[Dict[str, Any]] = []
        bs = self.block_size
        with self._tick_lock, torch.no_grad():
            for i, req in enumerate(self._slots):
                if req is None or req.prefilling or req.token_q is None:
                    continue
                rid = (req.trace or {}).get("trace_id")
                if not rid:
                    continue  # untraceable: the caller recomputes
                ctx = req.prompt + req.out_tokens
                n_kv = min(int(self._lengths[i]), len(ctx))
                nb = min(len(req.blocks), -(-n_kv // bs)) if n_kv else 0
                if nb <= 0:
                    continue
                frame = gather_blocks(self.cache, req.blocks[:nb]).cpu()
                if frame.dtype == torch.bfloat16:
                    frame = frame.float()
                out.append({"request_id": rid, "tokens": list(ctx[:n_kv]),
                            "block_size": bs, "kv": frame.numpy()})
        return out


def _broadcast_from_first(t: torch.Tensor, mesh: DeviceMesh) -> None:
    """Overwrite the CPU tensor `t` on every rank of `mesh` with its value
    on the mesh's first rank: a broadcast along each mesh dim in turn,
    from its index 0 (after dim i every rank holds the value of the rank
    with its coordinates, zero on dims up to i). CPU tensors go over the
    groups' gloo backend."""
    for dim in range(mesh.ndim):
        if mesh.size(dim) > 1:
            group = mesh.get_group(dim)
            dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)


def _local_shards(params, shardings):
    """This rank's shard of every leaf, laid out by `shardings`: a view of
    the whole leaf where it lies, or a DTensor's local shard when it is
    laid out so already (any other DTensor is gathered first). Host
    tensors keep the whole model off the device, as the JAX engine shards
    host copies; only each rank's shard is then copied to its device."""
    def shard(w, sharding):
        w = w.detach()
        if isinstance(w, DTensor):
            if w.device_mesh == sharding.mesh and \
                    tuple(w.placements) == sharding.placements:
                return local_tensor(w)
            w = w.full_tensor()
        return local_shard(w, sharding)

    return {name: (_local_shards(w, shardings[name]) if isinstance(w, dict)
                   else shard(w, shardings[name]))
            for name, w in params.items()}


def dryrun_tp_serving(cfg: TransformerConfig, tp: int, *, timeout: float = 45.0,
                      device_type: str = "cuda") -> None:
    """A tensor-parallel `LLMEngine` over the first `tp` ranks of the
    default process group (started as a world-1 group when there is none)
    generates 4 tokens from random weights, as the JAX package's serving
    dry-run does; `timeout` bounds the generation. Every rank must call
    it; the ranks past tp return at once."""
    mesh = build_mesh(MeshConfig(tp=tp, fsdp=1), device_type=device_type, n_ranks=tp)
    if mesh.get_coordinate() is None:
        return
    device = resolve_device(device_type)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(1),
                         device=device)
    eng = LLMEngine(cfg, params, num_slots=2, max_len=64,
                    prefill_buckets=(16,), prefix_cache_size=0, mesh=mesh)
    try:
        out = eng.generate([1, 2, 3], max_tokens=4, timeout=timeout)
        if len(out) != 4:
            raise RuntimeError(f"dryrun_tp_serving: {len(out)} tokens, not 4")
    finally:
        eng.shutdown()


def _to_compute(params, dtype: torch.dtype, device: torch.device):
    """The parameter tree on `device`, with the weights the model casts at
    use (all but the norms, which it reads in fp32) in the compute dtype.
    A tensor already on `device` in that dtype is taken as it is, not
    copied."""
    return {name: (_to_compute(w, dtype, device) if isinstance(w, dict)
                   else w.detach().to(device=device) if name.endswith("norm")
                   else w.detach().to(device=device, dtype=dtype))
            for name, w in params.items()}


def params_digest(params, dtype: torch.dtype, samples: int = 4096) -> str:
    """Digest of a parameter tree as the engines hold it: for every leaf,
    its name, its shape and an even sample of about `samples` of its
    values, the weights cast to the compute `dtype` (norms as they are).
    fp32 masters and the engine's compute-dtype copy of them digest
    alike, so a driver can check a replica's weights from the seed
    without holding a second copy."""
    import hashlib

    h = hashlib.sha1()

    def walk(tree, prefix):
        for name in sorted(tree):
            w = tree[name]
            if isinstance(w, dict):
                walk(w, f"{prefix}{name}/")
                continue
            flat = w.detach().reshape(-1)
            x = flat[::max(1, flat.numel() // samples)]
            if not name.endswith("norm"):
                x = x.to(dtype)
            h.update(f"{prefix}{name}{tuple(w.shape)}".encode())
            h.update(x.float().cpu().numpy().tobytes())

    walk(params, "")
    return h.hexdigest()[:16]


class LLMDeployment:
    """Serve-deployable wrapper: __call__({"tokens": [...], ...}) →
    {"tokens": [...]}.  Build with serve.deployment(LLMDeployment).bind(...).
    The port's counterpart of the JAX package's `LLMDeployment`.

    `engine="paged"` (default) serves through the paged KV-cache engine;
    `engine="fixed"` is DEPRECATED explicit opt-in to the fixed-slot
    engine (emits a DeprecationWarning — the paged engine covers its
    whole feature set at equal HBM, including speculative decoding).
    Tensor-parallel deployments still fall back to the fixed engine
    without a warning (the paged kernels are single-device for now)."""

    def __init__(self, cfg_name, *, engine: str = "paged",
                 num_slots: int = 8, max_len: int = 512, seed: int = 0,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache_size: int = 4,
                 speculation_k: Optional[int] = None,
                 tensor_parallel: int = 0,
                 prefix_sharing: Optional[bool] = None,
                 disagg: Optional[bool] = None,
                 params_loader: Optional[Callable] = None,
                 device: torch.device | str = "cuda"):
        """`cfg_name`: a registry name (ray_tpu_torch.models.configs) or a
        TransformerConfig instance, e.g. the config half of
        `ray_tpu_torch.models.hf_convert.from_hf(...)`, with
        `params_loader` returning the converted weights (serve real HF
        checkpoints). Without a loader the weights are `init_params` drawn
        from a `torch.Generator` seeded with `seed`. The engine runs on
        `device` ("cuda" unless the caller asks for the CPU)."""
        from ray_tpu_torch.models import configs

        device = resolve_device(device)
        cfg = (cfg_name if isinstance(cfg_name, TransformerConfig)
               else configs.get(cfg_name))
        mesh = None
        if tensor_parallel > 1:
            # Claim N local cards as a tp mesh for this replica (the
            # router still spreads requests across replicas).
            visible = (torch.cuda.device_count()
                       if device.type == "cuda" else 1)
            if visible < tensor_parallel:
                raise ValueError(
                    f"tensor_parallel={tensor_parallel} > "
                    f"{visible} visible devices")
            mesh = build_mesh(MeshConfig(tp=tensor_parallel, fsdp=1),
                              device_type=device.type,
                              n_ranks=tensor_parallel)
            engine = "fixed"
        elif engine == "fixed":
            warnings.warn(
                "LLMDeployment(engine='fixed') is deprecated: the paged "
                "engine is the default and covers the fixed engine's "
                "feature set (prefix caching, speculative decoding) at "
                "equal HBM with block-granular sharing. The fixed "
                "engine remains only as the tensor-parallel fallback "
                "and for explicit opt-in.",
                DeprecationWarning, stacklevel=2)
        with torch.no_grad():
            params = (params_loader() if params_loader
                      else init_params(
                          cfg, torch.Generator(device=device).manual_seed(
                              seed), device=device))
        if engine == "paged":
            store = None
            try:
                import ray_tpu_torch.api as _api

                if _api.is_initialized():
                    store = getattr(_api._global_worker(), "store", None)
            except Exception:  # noqa: BLE001 standalone use
                store = None
            self.engine = PagedLLMEngine(
                cfg, params, num_slots=num_slots, max_len=max_len,
                block_size=block_size, num_blocks=num_blocks,
                prefill_chunk=prefill_chunk, seed=seed,
                prefix_sharing=prefix_sharing,
                speculation_k=speculation_k, store=store, device=device)
        else:
            self.engine = LLMEngine(cfg, params, num_slots=num_slots,
                                    max_len=max_len,
                                    prefix_cache_size=prefix_cache_size,
                                    speculation_k=speculation_k or 0,
                                    mesh=mesh, device=device)
        # The engine holds its compute-dtype copy; the fp32 masters go
        # now, and with them the allocator's hold on their memory.
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
        # Disaggregated serving: this replica decodes; chunked prefill
        # of long prompts offloads to dedicated prefill actors whose
        # finished KV blocks ship back as frames (serve/disagg.py).
        if disagg is None:
            disagg = get_config().serve_disagg_enabled
        self._disagg = None
        self.disagg_role = "unified"
        # Prefill actors re-derive weights from (cfg, seed); a custom
        # params_loader would hand them different weights than this
        # replica decodes with — KV frames would silently mismatch.
        if disagg and engine == "paged" and params_loader is None:
            from ray_tpu_torch.serve.disagg import DisaggPrefillClient

            self._disagg = DisaggPrefillClient(
                cfg_name=cfg_name, seed=seed,
                block_size=self.engine.block_size,
                max_len=max_len, device=str(device))
            self.disagg_role = "decode"

    def set_serve_context(self, app: str, replica_id: str) -> None:
        """Replica-actor hook: lets the disagg client tag its prefill
        actors' gauge pushes with the hosting app."""
        if self._disagg is not None:
            self._disagg.set_serve_context(app, replica_id)

    def _maybe_offload_prefill(self, tokens,
                               trace: Optional[dict] = None) -> None:
        """Disagg hot path: a long prompt whose KV this replica doesn't
        already hold prefills on a dedicated prefill actor; the finished
        blocks ship back as a frame and import into the local pool, so
        the engine's own admission sees a whole-prompt prefix hit and
        the decode loop never runs the long prefill chunks.  Any
        failure (actor down, pool full) degrades to local prefill."""
        if self._disagg is None:
            return
        t0 = time.time()
        try:
            offloaded = self._disagg.prefill_into(self.engine,
                                                  list(tokens))
        except Exception:  # noqa: BLE001 degrade to local prefill
            return
        if offloaded:
            tracing.record_serve_span(trace, "serve.prefill.offload",
                                      t0, time.time(),
                                      tokens=len(tokens))

    def weights_digest(self) -> str:
        """Digest of the weights this replica serves (`params_digest`):
        a caller that remade them from the same seed can check that they
        are these."""
        return params_digest(self.engine.params, self.engine.cfg.compute_dtype)

    def warmup(self) -> None:
        """Run the engine's every width and chunk tier once (the paged
        engine's `warmup`), so a replica's first requests do not pay its
        first launches."""
        warm = getattr(self.engine, "warmup", None)
        if warm is not None:
            warm()

    def __del__(self):
        """Stop the engine (the paged one gives its arena back to the
        store); the replica runs this on a graceful exit."""
        engine = getattr(self, "engine", None)
        if engine is not None:
            engine.shutdown()

    def __call__(self, request: dict,
                 _serve_trace: Optional[dict] = None) -> dict:
        self._maybe_offload_prefill(request["tokens"],
                                    trace=_serve_trace)
        toks = self.engine.generate(
            request["tokens"],
            max_tokens=int(request.get("max_tokens", 32)),
            temperature=float(request.get("temperature", 0.0)),
            trace=_serve_trace)
        return {"tokens": toks}

    def stream(self, request: dict, _serve_resume: Optional[dict] = None,
               _serve_trace: Optional[dict] = None):
        """Streaming entry: yields {"token": t} dicts (served over
        chunked HTTP by the proxy; call via handle.remote_streaming).

        `_serve_resume` is the replica-injected failover context
        ({"offset": n, "items": [...]}): the tokens a dead replica
        already delivered are re-admitted through the engine's recompute
        path (resume_tokens) so this replica yields only the
        continuation — no duplicated or re-generated tokens."""
        resume = [it["token"] for it in (_serve_resume or {}).get(
            "items", []) if isinstance(it, dict) and "token" in it]
        if not resume:
            self._maybe_offload_prefill(request["tokens"])
        for tok in self.engine.generate_stream(
                request["tokens"],
                max_tokens=int(request.get("max_tokens", 32)),
                temperature=float(request.get("temperature", 0.0)),
                resume_tokens=resume or None,
                trace=_serve_trace):
            yield {"token": tok}

    def stats(self, _request: Optional[dict] = None) -> dict:
        """The engine's statistics, and the attention kernels' launch
        counts in this replica's process (`ops.attention.launches`)."""
        from ray_tpu_torch.ops import attention

        return dict(self.engine.engine_stats(),
                    kernel_launches=dict(attention.launches))

    def serve_state(self) -> dict:
        """Replica gauge-loop hook: disagg role + the digests of this
        engine's registered (aligned) prefixes.  Rides the existing
        report_serve_gauges/syncer push into the GCS-resident prefix
        registry (no new RPC plane); the handle's prefix-affinity
        routing reads the merged owner map back out of controller
        routing state."""
        cfg = get_config()
        state: dict = {"role": self.disagg_role}
        es = self.engine.engine_stats()
        if es.get("spec_proposed"):
            state["spec_accept_rate"] = round(
                es.get("spec_accepted", 0) / es["spec_proposed"], 4)
        alloc = getattr(self.engine, "allocator", None)
        if alloc is not None and cfg.serve_prefix_registry_enabled:
            state["block_size"] = int(self.engine.block_size)
            state["prefixes"] = alloc.prefix_digests(
                limit=cfg.serve_prefix_registry_max_entries)
        return state

    def adopt_kv(self, tokens, kv, block_size: int, last_logits=None,
                 source: str = "migrate") -> int:
        """Import a shipped KV frame (migration ticket / disagg handoff)
        into the hosted engine's pool.  Raises KVMigrationError when the
        engine can't adopt it — the caller's recompute fallback takes
        over.  Returns the number of blocks imported."""
        from ray_tpu_torch.exceptions import KVMigrationError

        imp = getattr(self.engine, "import_prefix", None)
        if imp is None:
            raise KVMigrationError(
                reason="engine has no paged block pool to adopt into")
        n = imp(tokens, kv, block_size, last_logits=last_logits)
        if n <= 0:
            raise KVMigrationError(
                reason=f"import_prefix rejected frame "
                       f"({len(tokens)} tokens, block_size "
                       f"{block_size})")
        key = ("migrated_blocks" if source == "migrate"
               else "adopted_blocks")
        self.engine.stats[key] += n
        return n

    def engine_gauges(self) -> dict:
        """Replica gauge hook: the Replica actor piggybacks these on the
        node daemon's syncer push (serve autoscaling input)."""
        g = getattr(self.engine, "gauges", None)
        if g is not None:
            return g()
        s = self.engine.engine_stats()
        return {"queue_depth": 0.0,
                "active": float(s.get("requests", 0)
                                - s.get("completed", 0)),
                "occupancy": 0.0}
