"""Bounded task-event pipeline: worker buffer -> coalesced flush -> GCS.

The port's copy of `ray_tpu/core/distributed/task_events.py`,
importing `ray_tpu_torch` only.

Analogue of the reference's task-event plane (ref: src/ray/core_worker/
task_event_buffer.h TaskEventBuffer — a bounded worker-side buffer
flushing coalesced task attempts on an interval; src/ray/gcs/gcs_server/
gcs_task_manager.h GcsTaskManager — per-job capped storage with
oldest-attempt eviction, powering `ray list tasks`). Before this module
the repro had the SINK (an unbounded GCS list) but no pipeline: workers
appended flat records to an ad-hoc list, drops were silent, the driver
never reported submission states, and `list_tasks` could not say whether
its answer was complete.

Two halves:

  TaskEventBuffer  (every process that touches a task: driver records
                   SUBMITTED/LEASED, executors record RUNNING/terminal):
                   status transitions coalesce into ONE record per
                   (task_id, attempt) in a bounded ring; a flusher ships
                   them to the GCS on a coalescing interval OFF the hot
                   path. When the GCS is down or the ring overflows,
                   oldest attempts drop with per-kind counters — task
                   execution never blocks on telemetry.

  GcsTaskManager   (GCS side, registered as the `TaskEvents` service):
                   merges records from all reporters by (job, task,
                   attempt), enforces a per-job cap with oldest-attempt
                   eviction, GCs finished jobs after a TTL, and surfaces
                   dropped/evicted counts through the state API so
                   `list_tasks`/`summarize_tasks` report completeness
                   honestly instead of pretending the window is the
                   world.

Profile events (object transfers, user spans) are opt-in
(RAY_TPU_TASK_EVENTS_PROFILE=1) and ride the same bounded pipeline.
Every knob is a `RAY_TPU_TASK_EVENTS_*` env var (config.py).
"""
from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import get_config

logger = logging.getLogger(__name__)

# Status-transition order; a record's `state` only moves forward (a late
# SUBMITTED arriving after RUNNING must not regress the attempt).
STATES = ("SUBMITTED", "LEASED", "RUNNING", "FINISHED", "FAILED")
_RANK = {s: i for i, s in enumerate(STATES)}
TERMINAL_STATES = ("FINISHED", "FAILED")

_IDENTITY_FIELDS = ("name", "job_id", "actor_id", "node_id", "worker_id",
                    "pid", "submit_node_id", "submit_pid")

# Per-attempt resource attribution (executor-side TaskUsageProbe) and
# hung-task watchdog annotations (daemon-side auto-captured stack
# dumps) ride the same coalesced record: a newer report overwrites.
_RESOURCE_FIELDS = ("cpu_time_s", "rss_delta_bytes", "rss_peak_bytes",
                    "device_mem_bytes", "device_mem_delta_bytes",
                    "hung", "hung_stack", "hung_ts")
_EXTRA_FIELDS = _IDENTITY_FIELDS + _RESOURCE_FIELDS


def _buffer_metrics() -> dict:
    """Process-wide pipeline counters, created once (many buffers can
    coexist in one process — driver + in-proc harness daemons — and all
    share these through registry adoption)."""
    global _METRICS
    if _METRICS is None:
        from ray_tpu_torch.util.metrics import Counter

        _METRICS = {
            "recorded": Counter(
                "raytpu_task_events_recorded_total",
                "Task events recorded into the local buffer",
                tag_keys=("kind",)),
            "dropped": Counter(
                "raytpu_task_events_dropped_total",
                "Task events dropped (ring overflow while the GCS is "
                "unreachable)", tag_keys=("kind",)),
            "flushed": Counter(
                "raytpu_task_events_flushed_total",
                "Task events successfully flushed to the GCS"),
            "flush_failures": Counter(
                "raytpu_task_events_flush_failures_total",
                "Flush RPCs that failed (events re-buffered)"),
        }
    return _METRICS


_METRICS: Optional[dict] = None


class TaskEventBuffer:
    """Per-process bounded task-event ring + coalescing flusher.

    `flush_fn` is an async callable receiving the payload kwargs for one
    `TaskEvents.add_task_events` RPC; the buffer owns retry/drop policy,
    the caller owns transport. Thread-safe: records come from executor
    threads and the driver's submit path; the flusher runs on the
    process's RPC loop.
    """

    def __init__(self, *,
                 flush_fn: Callable[..., Awaitable[Any]],
                 node_id: str = "",
                 worker_id: str = "",
                 pid: int = 0):
        cfg = get_config()
        self.node_id = node_id
        self.worker_id = worker_id
        self.pid = pid
        self._flush_fn = flush_fn
        self.capacity = max(16, cfg.task_events_max_buffer)
        self.flush_period_s = cfg.task_events_flush_ms / 1000.0
        self._lock = threading.Lock()
        # HOT PATH: raw transitions land here with ONE deque.append —
        # GIL-atomic, no lock, no dict merging. The driver's submit
        # thread, the lane loop, and 4 executor threads all record;
        # a shared mutex here ping-ponged the GIL at 0.5ms switch
        # quanta and cost ~20% of many_tasks throughput. Coalescing
        # happens in the flusher (_apply_pending), off the hot path.
        self._pending: deque = deque()
        # (task_id, attempt) -> coalesced attempt record. Insertion
        # order IS drop order: overflow evicts the oldest attempt.
        # Touched only under _lock (flusher + stats).
        self._attempts: "OrderedDict[Tuple[str, int], dict]" = OrderedDict()
        self._profile: deque = deque()
        # Per-kind drops not yet reported to the GCS (shipped with the
        # next successful flush so the sink can account completeness).
        self._dropped_unreported = {"status": 0, "profile": 0}
        self.dropped_total = {"status": 0, "profile": 0}
        self.flushed_total = 0
        self.flush_failures = 0
        self._m = _buffer_metrics()
        self._spans_pending: List[dict] = []
        self._stop = False

    # -- record path (hot; must never block on the GCS) -----------------
    def record_status(self, task_id: str, attempt: int, state: str,
                      ts: Optional[float] = None,
                      error: Optional[str] = None,
                      **fields) -> None:
        if not get_config().task_events_enabled:
            return
        if len(self._pending) >= self.capacity:
            # The flusher can't keep up (GCS down AND a record storm):
            # drop-at-ingress with an accurate counter rather than grow.
            with self._lock:
                self._drop_locked("status")
            return
        self._pending.append(
            (task_id, int(attempt), state,
             ts if ts is not None else time.time(), error,
             fields or None))

    def record_attempt(self, task_id: str, attempt: int,
                       transitions: List[Tuple[str, float]],
                       error: Optional[str] = None,
                       **fields) -> None:
        """Record several transitions of one attempt with a single
        append — the executor's per-task fast path (an attempt's whole
        SUBMITTED/LEASED/RUNNING/terminal history arrives at once when
        the submission half rides the spec)."""
        if not get_config().task_events_enabled:
            return
        if len(self._pending) >= self.capacity:
            with self._lock:
                self._drop_locked("status")
            return
        self._pending.append(
            (task_id, int(attempt), transitions, None, error,
             fields or None))

    def _apply_one_locked(self, task_id: str, attempt: int, state,
                          ts, error, fields) -> None:
        if not isinstance(state, str):
            # record_attempt fast path: `state` is a whole transition
            # list — build (or fold into) the record in one shot, no
            # per-transition dispatch. This is the executor's per-task
            # path; an eager RUNNING mark may already hold the slot.
            transitions = state
            key = (task_id, attempt)
            last_state, last_ts = transitions[-1]
            rec = self._attempts.get(key)
            if rec is None:
                while len(self._attempts) >= self.capacity:
                    self._attempts.popitem(last=False)
                    self._drop_locked("status")
                rec = self._attempts[key] = {
                    "task_id": task_id, "attempt": attempt,
                    "state": last_state,
                    "state_ts": dict(transitions)}
            else:
                st = rec["state_ts"]
                for s2, t2 in transitions:
                    if s2 not in st or s2 in TERMINAL_STATES:
                        st[s2] = t2
                if (_RANK.get(last_state, 0)
                        >= _RANK.get(rec["state"], 0)):
                    rec["state"] = last_state
            run_ts = rec["state_ts"].get("RUNNING")
            if run_ts is not None:
                rec.setdefault("start_ts", run_ts)
            if last_state in TERMINAL_STATES:
                rec["end_ts"] = last_ts
            if error is not None:
                rec["error"] = error
            if fields:
                for k in _EXTRA_FIELDS:
                    v = fields.get(k)
                    if v is not None:
                        rec[k] = v
            return
        key = (task_id, attempt)
        rec = self._attempts.get(key)
        if rec is None:
            while len(self._attempts) >= self.capacity:
                self._attempts.popitem(last=False)
                self._drop_locked("status")
            rec = self._attempts[key] = {
                "task_id": task_id, "attempt": attempt,
                "state": state, "state_ts": {},
            }
        # Identity is per-SIDE: submission states stamp the caller's
        # process (submit_*), execution states the worker's — the
        # GCS merge must not let a driver's flush claim the
        # execution row (the timeline draws its flow arrow between
        # exactly these two identities).
        if _RANK.get(state, 0) < _RANK["RUNNING"]:
            rec.setdefault("submit_node_id", self.node_id or None)
            rec.setdefault("submit_pid", self.pid or None)
        else:
            rec.setdefault("node_id", self.node_id or None)
            rec.setdefault("worker_id", self.worker_id or None)
            rec.setdefault("pid", self.pid or None)
        st = rec["state_ts"]
        # Keep the FIRST timestamp per state (a retried record_status
        # must not slide history), but let terminal states overwrite
        # (a retry's new outcome supersedes).
        if state not in st or state in TERMINAL_STATES:
            st[state] = ts
        if _RANK.get(state, 0) >= _RANK.get(rec["state"], 0):
            rec["state"] = state
        if state == "RUNNING":
            rec.setdefault("start_ts", ts)
        if state in TERMINAL_STATES:
            rec["end_ts"] = ts
        if error is not None:
            rec["error"] = error
        if fields:
            for k in _EXTRA_FIELDS:
                v = fields.get(k)
                if v is not None:
                    rec[k] = v

    def _apply_pending_locked(self) -> None:
        """Coalesce raw transitions into per-attempt records (flusher
        context). popleft races concurrent appends safely: deque ops are
        GIL-atomic, and anything appended mid-drain just waits for the
        next cycle."""
        n = 0
        while True:
            try:
                item = self._pending.popleft()
            except IndexError:
                break
            self._apply_one_locked(*item)
            n += 1
        if n:
            self._m["recorded"].inc(n, tags={"kind": "status"})

    def record_profile(self, name: str, category: str, start_ts: float,
                       end_ts: float, **attrs) -> None:
        """Opt-in profile event (object transfer, user-annotated work)
        riding the same bounded pipeline (ref: profile events in
        core_worker.proto task events)."""
        cfg = get_config()
        if not (cfg.task_events_enabled and cfg.task_events_profile):
            return
        with self._lock:
            while len(self._profile) >= self.capacity:
                self._profile.popleft()
                self._drop_locked("profile")
            self._profile.append({
                "kind": "profile", "name": name, "category": category,
                "start_ts": start_ts, "end_ts": end_ts,
                "node_id": self.node_id or None,
                "pid": self.pid or None, **attrs,
            })
        self._m["recorded"].inc(tags={"kind": "profile"})

    def _drop_locked(self, kind: str) -> None:
        self._dropped_unreported[kind] += 1
        self.dropped_total[kind] += 1
        self._m["dropped"].inc(tags={"kind": kind})

    # -- flush path ------------------------------------------------------
    def drain(self) -> Optional[dict]:
        """Coalesce + take everything pending as one add_task_events
        payload (None when there is nothing to ship)."""
        with self._lock:
            self._apply_pending_locked()
            if (not self._attempts and not self._profile
                    and not any(self._dropped_unreported.values())):
                return None
            # None-valued identity fields are dead wire weight (a driver
            # record ships no worker identity and vice versa): stripping
            # them shrinks the pickle AND the GCS-side merge loop.
            events = [{k: v for k, v in rec.items() if v is not None}
                      for rec in self._attempts.values()]
            self._attempts = OrderedDict()
            profile = list(self._profile)
            self._profile.clear()
            dropped = dict(self._dropped_unreported)
            self._dropped_unreported = {"status": 0, "profile": 0}
        return {"events": events, "profile": profile, "dropped": dropped}

    def _restore(self, payload: dict) -> None:
        """Put a failed flush back at the FRONT of the ring (oldest
        events drop first on overflow), merging with anything recorded
        while the flush was in flight."""
        with self._lock:
            for kind, n in payload.get("dropped", {}).items():
                self._dropped_unreported[kind] += n
            restored: "OrderedDict[Tuple[str, int], dict]" = OrderedDict()
            for rec in payload.get("events", []):
                restored[(rec["task_id"], rec["attempt"])] = rec
            for key, rec in self._attempts.items():
                old = restored.get(key)
                if old is None:
                    restored[key] = rec
                else:
                    merge_attempt(old, rec)
            self._attempts = restored
            while len(self._attempts) > self.capacity:
                self._attempts.popitem(last=False)
                self._drop_locked("status")
            prof = payload.get("profile", [])
            if prof:
                self._profile.extendleft(reversed(prof))
                while len(self._profile) > self.capacity:
                    self._profile.popleft()
                    self._drop_locked("profile")

    async def flush_once(self) -> bool:
        """One flush attempt; True if something shipped. Failures
        re-buffer (bounded) and count — never raise."""
        payload = self.drain()
        if payload is None:
            return False
        try:
            await self._flush_fn(**payload)
        except asyncio.CancelledError:
            self._restore(payload)
            raise
        except Exception as e:  # noqa: BLE001 — GCS down/mid-restart
            self.flush_failures += 1
            self._m["flush_failures"].inc()
            self._restore(payload)
            logger.debug("task-event flush failed: %s", e)
            return False
        n = len(payload["events"]) + len(payload["profile"])
        self.flushed_total += n
        self._m["flushed"].inc(n)
        return True

    async def flush_loop(self) -> None:
        """Coalescing flusher with idle backoff: a parked worker (one of
        hundreds of warm actors) must not tick at full cadence forever —
        activity snaps the delay back (same discipline as the location
        flusher)."""
        delay = self.flush_period_s
        while not self._stop:
            # A backed-off sleep must still wake within one period of
            # new spans appearing: a long-parked warm worker that lands
            # a restarted train gang mints its whole (short) leg under a
            # 16 s delay and would lose every span at teardown.
            slept = 0.0
            while not self._stop:
                await asyncio.sleep(min(self.flush_period_s,
                                        delay - slept))
                slept += self.flush_period_s
                if slept >= delay or self._spans_waiting():
                    break
            self._drain_span_source()
            shipped = await self._ship_spans()
            if await self.flush_once() or shipped:
                delay = self.flush_period_s
            else:
                delay = min(delay * 2, max(self.flush_period_s, 16.0))

    def _spans_waiting(self) -> bool:
        if self._spans_pending:
            return True
        cfg = get_config()
        if not (cfg.tracing_enabled or cfg.serve_trace_enabled
                or cfg.train_obs_enabled):
            return False
        from ray_tpu_torch.util import tracing

        return tracing.has_pending()

    def _drain_span_source(self) -> None:
        cfg = get_config()
        if (cfg.tracing_enabled or cfg.serve_trace_enabled
                or cfg.train_obs_enabled):
            from ray_tpu_torch.util import tracing

            self._spans_pending.extend(tracing.drain())

    async def flush_final(self) -> None:
        """Last-gasp flush at teardown (gang shutdown, process exit):
        drain freshly minted spans and ship everything still buffered so
        a short-lived leg's trace survives the actor dying before the
        next flush tick. Best effort — the GCS may already be gone."""
        self._drain_span_source()
        await self._ship_spans()
        await self.flush_once()

    async def _ship_spans(self) -> bool:
        spans = self._spans_pending
        if not spans:
            return False
        self._spans_pending = []
        try:
            await self._flush_fn(events=[], profile=spans, dropped={})
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 re-buffer, bounded
            self._spans_pending = spans[-self.capacity:]
            return False
        return True

    def stop(self) -> None:
        self._stop = True

    def stats(self) -> dict:
        with self._lock:
            self._apply_pending_locked()
            return {
                "pending": len(self._attempts),
                "pending_profile": len(self._profile),
                "dropped": dict(self.dropped_total),
                "unreported_dropped": dict(self._dropped_unreported),
                "flushed": self.flushed_total,
                "flush_failures": self.flush_failures,
                "capacity": self.capacity,
            }


def merge_attempt(dst: dict, src: dict) -> None:
    """Fold `src`'s transitions into `dst` (same (task_id, attempt)):
    union of state_ts (src wins ties — it is newer), state advances by
    rank, identity fields fill in. Used by both the buffer's re-buffer
    merge and the GCS's cross-reporter merge (driver knows SUBMITTED,
    the executor knows RUNNING)."""
    st = dst.setdefault("state_ts", {})
    for state, ts in (src.get("state_ts") or {}).items():
        if state not in st or state in TERMINAL_STATES:
            st[state] = ts
    if _RANK.get(src.get("state"), -1) >= _RANK.get(dst.get("state"), -1):
        dst["state"] = src.get("state")
    for k in ("start_ts",):
        if dst.get(k) is None and src.get(k) is not None:
            dst[k] = src[k]
    for k in ("end_ts", "error"):
        if src.get(k) is not None:
            dst[k] = src[k]
    for k in _IDENTITY_FIELDS:
        if dst.get(k) is None and src.get(k) is not None:
            dst[k] = src[k]
    # Resource/hung annotations: the newer report wins (a retry's fresh
    # usage supersedes; the watchdog's hung flag survives the executor's
    # later terminal record because that record simply omits it).
    for k in _RESOURCE_FIELDS:
        if src.get(k) is not None:
            dst[k] = src[k]


class GcsTaskManager:
    """GCS-side task-event store (ref: gcs_task_manager.h): per-job
    capped OrderedDicts of coalesced attempts, span/profile rings, and
    honest accounting of everything dropped or evicted on the way in.
    Registered as the `TaskEvents` RPC service (the name the state API,
    CLI and timeline already speak)."""

    GC_SWEEP_MIN_INTERVAL_S = 5.0

    def __init__(self, max_spans: int = 50000):
        # job_id -> OrderedDict[(task_id, attempt) -> record]
        self._jobs: Dict[str, "OrderedDict[Tuple[str, int], dict]"] = {}
        self._spans: deque = deque(maxlen=max_spans)
        self._profile: deque = deque(maxlen=max_spans)
        self._finished_jobs: Dict[str, float] = {}
        self._last_gc = 0.0
        self.counters = {
            "added": 0, "evicted": 0, "gc_jobs": 0, "gc_events": 0,
            "worker_dropped_status": 0, "worker_dropped_profile": 0,
            "spans": 0, "profile": 0,
        }
        self._evicted_by_job: Dict[str, int] = {}
        from ray_tpu_torch.util.metrics import Counter, Gauge

        self._m_added = Counter(
            "raytpu_gcs_task_events_added_total",
            "Task attempt records merged into the GCS task manager")
        self._m_evicted = Counter(
            "raytpu_gcs_task_events_evicted_total",
            "Oldest attempts evicted by the per-job storage cap")
        self._m_stored = Gauge(
            "raytpu_gcs_task_events_stored",
            "Task attempt records currently stored")

    # -- ingest ----------------------------------------------------------
    def add_task_events(self, events: Optional[List[dict]] = None,
                        profile: Optional[List[dict]] = None,
                        dropped: Optional[Dict[str, int]] = None) -> dict:
        cap = max(1, get_config().task_events_max_per_job)
        n_added = n_evicted = 0
        for rec in events or ():
            job = rec.get("job_id") or ""
            table = self._jobs.get(job)
            if table is None:
                table = self._jobs[job] = OrderedDict()
            key = (rec.get("task_id"), rec.get("attempt", 0))
            cur = table.get(key)
            if cur is None:
                while len(table) >= cap:
                    table.popitem(last=False)
                    n_evicted += 1
                    self._evicted_by_job[job] = \
                        self._evicted_by_job.get(job, 0) + 1
                # The decoded record is ours (fresh off the wire): store
                # it without a defensive copy.
                table[key] = rec
            else:
                merge_attempt(cur, rec)
            n_added += 1
        if n_added:
            self.counters["added"] += n_added
            self._m_added.inc(n_added)
        if n_evicted:
            self.counters["evicted"] += n_evicted
            self._m_evicted.inc(n_evicted)
        for rec in profile or ():
            if rec.get("kind") == "span":
                self._spans.append(rec)
                self.counters["spans"] += 1
            else:
                self._profile.append(rec)
                self.counters["profile"] += 1
        for kind, n in (dropped or {}).items():
            self.counters[f"worker_dropped_{kind}"] = \
                self.counters.get(f"worker_dropped_{kind}", 0) + int(n)
        self._maybe_gc()
        return {"ok": True}

    def add_events(self, events: List[dict]) -> dict:
        """Legacy flat-record surface (spans from pre-pipeline flushers,
        tests, external tools): converted into the coalesced model."""
        status: List[dict] = []
        profile: List[dict] = []
        for e in events or ():
            kind = e.get("kind")
            if kind in ("span", "profile"):
                profile.append(e)
                continue
            rec = {k: e.get(k) for k in
                   ("task_id", "name", "job_id", "actor_id", "node_id",
                    "worker_id", "pid", "error", "start_ts", "end_ts")}
            rec["attempt"] = e.get("attempt", 0)
            rec["state"] = e.get("state", "RUNNING")
            st = {}
            if e.get("start_ts") is not None:
                st["RUNNING"] = e["start_ts"]
            if (e.get("end_ts") is not None
                    and rec["state"] in TERMINAL_STATES):
                st[rec["state"]] = e["end_ts"]
            rec["state_ts"] = st
            status.append(rec)
        return self.add_task_events(events=status, profile=profile)

    # -- query -----------------------------------------------------------
    def list_events(self, job_id: Optional[str] = None,
                    limit: int = 10000) -> List[dict]:
        """Flattened rows, newest-last-activity first: task attempts
        (with their full state_ts history), then spans and profile
        events (kind-tagged; the state API filters those out)."""
        rows: List[dict] = []
        for job, table in self._jobs.items():
            if job_id is not None and job != job_id:
                continue
            rows.extend(table.values())
        rows.sort(key=lambda r: r.get("end_ts")
                  or max(r.get("state_ts", {}).values(), default=0.0),
                  reverse=True)
        rows = [dict(r) for r in rows[:limit]]
        room = limit - len(rows)
        if room > 0 and job_id is None:
            extra = list(self._spans) + list(self._profile)
            rows.extend(extra[-room:])
        return rows

    def list_spans(self, trace_id: Optional[str] = None,
                   limit: int = 10000) -> List[dict]:
        """Tracing spans oldest-first, optionally filtered to one trace.
        Serve traces use the request id as trace id, so this is the
        `ray-tpu serve trace <request-id>` backend."""
        rows = [dict(s) for s in self._spans
                if trace_id is None or s.get("trace_id") == trace_id]
        return rows[-limit:]

    def get_task(self, task_id: str) -> List[dict]:
        """Every stored attempt of one task (ref: `ray get tasks`)."""
        out = []
        for table in self._jobs.values():
            for (tid, _attempt), rec in table.items():
                if tid == task_id:
                    out.append(dict(rec))
        out.sort(key=lambda r: r.get("attempt", 0))
        return out

    def stats(self) -> dict:
        """Completeness accounting for the state API: how much telemetry
        exists vs. how much was dropped (worker-side) or evicted
        (GCS-side cap) or GC'd."""
        stored = sum(len(t) for t in self._jobs.values())
        self._m_stored.set(stored)
        return {
            "jobs": len(self._jobs),
            "stored": stored,
            "spans": len(self._spans),
            "profile": len(self._profile),
            "evicted_by_job": dict(self._evicted_by_job),
            **self.counters,
        }

    def summarize(self) -> dict:
        """Per-name state counts + per-name resource rollups (p50/p99
        cpu/rss over the stored window) plus completeness meta (the
        honest version of `ray summary tasks`)."""
        from ray_tpu_torch.util.metrics import percentile

        names: Dict[str, Dict[str, int]] = {}
        res: Dict[str, Dict[str, list]] = {}
        for table in self._jobs.values():
            for rec in table.values():
                name = rec.get("name") or "task"
                per = names.setdefault(name, {})
                state = rec.get("state", "UNKNOWN")
                per[state] = per.get(state, 0) + 1
                cpu = rec.get("cpu_time_s")
                rss = rec.get("rss_delta_bytes")
                if cpu is None and rss is None:
                    continue
                u = res.setdefault(name, {"cpu": [], "rss": []})
                if cpu is not None:
                    u["cpu"].append(cpu)
                if rss is not None:
                    u["rss"].append(rss)
        usage = {}
        for name, u in res.items():
            usage[name] = {
                "n": max(len(u["cpu"]), len(u["rss"])),
                "cpu_time_s": {
                    "p50": percentile(u["cpu"], 50),
                    "p99": percentile(u["cpu"], 99),
                    "max": max(u["cpu"], default=0.0),
                },
                "rss_delta_bytes": {
                    "p50": percentile(u["rss"], 50),
                    "p99": percentile(u["rss"], 99),
                    "max": max(u["rss"], default=0),
                },
            }
        s = self.stats()
        return {"tasks": names,
                "usage": usage,
                "completeness": {
                    "stored": s["stored"],
                    "evicted": s["evicted"],
                    "worker_dropped_status":
                        s.get("worker_dropped_status", 0),
                    "worker_dropped_profile":
                        s.get("worker_dropped_profile", 0),
                    "gc_events": s["gc_events"],
                }}

    def hung_tasks(self, limit: int = 100) -> List[dict]:
        """Attempts the watchdog flagged as hung that are STILL running
        (a flagged attempt that later finished drops out — the flag
        stays on the record for post-mortems, but the live view answers
        "what is stuck right now"). Newest-flagged first."""
        out: List[dict] = []
        for table in self._jobs.values():
            for rec in table.values():
                if not rec.get("hung") or rec.get("state") != "RUNNING":
                    continue
                out.append({k: rec.get(k) for k in (
                    "task_id", "attempt", "name", "job_id", "node_id",
                    "worker_id", "pid", "hung_ts", "start_ts")})
        out.sort(key=lambda r: r.get("hung_ts") or 0.0, reverse=True)
        return out[:limit]

    # -- lifecycle -------------------------------------------------------
    def on_job_finished(self, job_id: str) -> None:
        self._finished_jobs[job_id] = time.time()

    def _maybe_gc(self) -> None:
        now = time.time()
        if now - self._last_gc < self.GC_SWEEP_MIN_INTERVAL_S:
            return
        self._last_gc = now
        self.gc_finished_jobs(now)

    def gc_finished_jobs(self, now: Optional[float] = None) -> int:
        """Drop stored events of jobs finished longer than the TTL ago;
        returns events freed. Called lazily from the ingest path and
        directly by tests."""
        now = now if now is not None else time.time()
        ttl = get_config().task_events_finished_job_ttl_s
        freed = 0
        for job_id, t_finished in list(self._finished_jobs.items()):
            if now - t_finished < ttl:
                continue
            table = self._jobs.pop(job_id, None)
            self._finished_jobs.pop(job_id, None)
            self._evicted_by_job.pop(job_id, None)
            if table:
                freed += len(table)
                self.counters["gc_events"] += len(table)
                self.counters["gc_jobs"] += 1
        return freed
