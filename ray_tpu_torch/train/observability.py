"""Train-plane goodput observability: per-step phase attribution.
Counterpart of `ray_tpu/train/observability.py`.

The worker half of the train observability stack. A training run is a
black box between `train.report()` calls unless the step loop is
instrumented, and training efficiency is dominated by exactly the
stalls a wall clock can't see: input-pipeline waits and slowest-rank
synchronization barriers. This module attributes every second of a
rank's step loop to one of five buckets:

  data_wait    blocked on the input pipeline (auto-charged by
               `data/streaming/prefetch.py` when the device prefetcher
               blocks, and by the iterator wrapper
               `session.get_dataset_shard` installs — StreamingIngest
               loops get it for free)
  compute      time the user marks with `train.phase("compute")`
  sync         cross-rank barriers the user marks (allreduce, pjit
               dispatch fences)
  checkpoint   `train.report(checkpoint=...)`'s persist — timed
               automatically by the session
  other        the unattributed remainder of each step; counted as
               productive by the GCS goodput split (a stall you did
               not measure cannot be blamed)

Steps are delimited either explicitly (`with train.step_phases():`)
or implicitly — each `train.report()` closes the open step — so
uninstrumented loops still produce step timing, skew windows, and
goodput splits.

Everything federates over existing planes, no new RPCs: cumulative
counters ride the gauge → node daemon → syncer → GCS path (the serve
replica gauge precedent), histograms ride the piggybacked registry
dump, and per-step spans (trace_id == run id == experiment name +
fit attempt) ride the worker TaskEventBuffer span flush into the GCS
TaskEvents sink, where `ray-tpu train trace <run>` finds them.

Kill switch: RAY_TPU_TRAIN_OBS_ENABLED=0 turns all of it off — the
recorder becomes a no-op shell, no pusher thread starts, no spans
mint.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import Counter, Histogram, registry_dump

PHASES = ("data_wait", "compute", "sync", "checkpoint")

# Step/phase wall times live in the 1ms..minutes band (a train step is
# rarely sub-millisecond); the default RPC-latency boundaries waste
# their sub-ms floor here.
_STEP_BOUNDARIES = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1, 2.5, 5, 10, 30, 60, 300)

_M: Optional[dict] = None
_m_lock = threading.Lock()


def _metrics() -> dict:
    global _M
    with _m_lock:
        if _M is None:
            _M = {
                "step_seconds": Histogram(
                    "raytpu_train_step_seconds",
                    "Wall time of one training step on one rank",
                    _STEP_BOUNDARIES, ("run", "rank")),
                "phase_seconds": Histogram(
                    "raytpu_train_phase_seconds",
                    "Per-step time attributed to one phase on one rank",
                    _STEP_BOUNDARIES, ("run", "rank", "phase")),
                "persist_seconds": Histogram(
                    "raytpu_train_checkpoint_persist_seconds",
                    "Wall time of train.report()'s checkpoint persist "
                    "(rmtree + copytree into the trial dir)",
                    _STEP_BOUNDARIES, ("run", "rank")),
                "steps_total": Counter(
                    "raytpu_train_steps_total",
                    "Training steps completed", ("run", "rank")),
            }
        return _M


# The process-wide active recorder. One training session exists per
# worker process (train/session.py module global); the device
# prefetcher and benches reach the recorder through this hook without
# importing the session machinery.
_active: Optional["StepPhaseRecorder"] = None


def get_active() -> Optional["StepPhaseRecorder"]:
    return _active


def set_active(rec: Optional["StepPhaseRecorder"]) -> None:
    global _active
    _active = rec


def on_data_wait(seconds: float) -> None:
    """Charge input-pipeline block time to the active recorder's
    current step. Best-effort hook for `data/streaming/prefetch.py`:
    no active session (plain Dataset consumption outside a train
    loop) means no-op."""
    rec = _active
    if rec is not None:
        rec.add_phase("data_wait", seconds)


_run_seq_lock = threading.Lock()
_run_seq: Dict[str, int] = {}


def next_run_id(experiment: str) -> str:
    """Mint the run id for one fit(): experiment name + fit attempt
    ("mnist#0", "mnist#1", ...). Stable across gang restarts WITHIN a
    fit — satellite requirement: the failover leg of a chaos run shows
    up in the same trace — while separate fits of the same experiment
    get distinct traces."""
    with _run_seq_lock:
        seq = _run_seq.get(experiment, 0)
        _run_seq[experiment] = seq + 1
    return f"{experiment}#{seq}"


def emit_run_event(run: str, run_id: str, message: str,
                   severity: str = "INFO", **fields) -> None:
    """Best-effort train-plane event into the GCS EventLog
    (source="train"): gang starts carry the restart gap the
    TrainRunState charges to `lost_restart`, joining the elastic
    supervisor's own restart/shrink/grow events."""
    if not get_config().train_obs_enabled:
        return
    try:
        from ray_tpu_torch.api import _global_worker

        _global_worker().gcs.call(
            "EventLog", "add_event", source="train", severity=severity,
            message=message,
            fields={"run": run, "run_id": run_id, **fields}, timeout=10)
    except Exception:  # noqa: BLE001 — events are best-effort
        pass


class _PhaseTimer:
    __slots__ = ("_rec", "_name", "_t0")

    def __init__(self, rec: "StepPhaseRecorder", name: str):
        self._rec = rec
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._rec.add_phase(self._name, time.perf_counter() - self._t0)
        return False


class _NullTimer:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class StepPhaseRecorder:
    """Per-rank step/phase accounting for one run attempt.

    Owned by the TrainSession (or constructed standalone by benches).
    Thread-safe for the one-writer-per-phase pattern the train loop
    uses: the user thread opens/closes steps and phases while the
    pusher thread reads cumulative totals under the same lock.
    """

    def __init__(self, run: str, run_id: str, rank: int, world_size: int,
                 attempt: int = 0,
                 flops_per_step: Optional[float] = None,
                 enabled: Optional[bool] = None):
        cfg = get_config()
        self.enabled = (cfg.train_obs_enabled if enabled is None
                        else bool(enabled))
        self.run = run                  # experiment name (gauge key)
        self.run_id = run_id            # trace id: "<name>#<fit-seq>"
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.attempt = int(attempt)     # gang-restart index within a fit
        self.flops_per_step = flops_per_step
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=max(1,
                                               cfg.train_obs_window_steps))
        self._trace_steps = cfg.train_obs_trace_steps
        self.started_ts = time.time()
        self.steps_total = 0
        self.first_step: Optional[int] = None
        self.last_step: Optional[int] = None
        self.last_step_ts: float = 0.0
        self.step_s_total = 0.0
        self.phase_s: Dict[str, float] = {p: 0.0 for p in PHASES}
        self.phase_s["other"] = 0.0
        # Open-step state (None between steps).
        self._step_t0: Optional[float] = None
        self._step_wall0: Optional[float] = None
        self._step_phases: Dict[str, float] = {}
        self._step_intervals: List[tuple] = []
        self._step_explicit = False
        self._tags = {"run": self.run, "rank": str(self.rank)}
        # Set when the rank's loop has returned (its session's end).
        self.finished = False

    # -- step lifecycle ---------------------------------------------------

    def step_start(self, explicit: bool = False) -> None:
        if not self.enabled:
            return
        with self._lock:
            if self._step_t0 is None:
                self._step_t0 = time.perf_counter()
                self._step_wall0 = time.time()
                self._step_phases = {}
                self._step_intervals = []
            self._step_explicit = self._step_explicit or explicit

    def step_end(self) -> None:
        """Close the open step: fold measured phases, charge the
        unattributed remainder to `other`, observe histograms, mint
        spans. No-op when no step is open."""
        if not self.enabled:
            return
        with self._lock:
            if self._step_t0 is None:
                return
            wall = time.perf_counter() - self._step_t0
            wall0 = self._step_wall0 or time.time()
            phases = self._step_phases
            intervals = self._step_intervals
            self._step_t0 = None
            self._step_wall0 = None
            self._step_phases = {}
            self._step_intervals = []
            self._step_explicit = False
            step_index = self.steps_total
            self.steps_total += 1
            if self.first_step is None:
                self.first_step = step_index
            self.last_step = step_index
            self.last_step_ts = time.time()
            self.step_s_total += wall
            other = wall
            for name, dur in phases.items():
                self.phase_s[name] = self.phase_s.get(name, 0.0) + dur
                other -= dur
            other = max(0.0, other)
            self.phase_s["other"] += other
            self._window.append(wall)
        m = _metrics()
        m["step_seconds"].observe(wall, self._tags)
        m["steps_total"].inc(1, self._tags)
        for name, dur in phases.items():
            m["phase_seconds"].observe(dur, {**self._tags, "phase": name})
        self._mint_step_span(step_index, wall0, wall0 + wall, phases,
                             intervals, other)

    def _mint_step_span(self, step_index, start_ts, end_ts, phases,
                        intervals, other) -> None:
        if self._trace_steps == 0 or step_index >= self._trace_steps:
            return
        parent = tracing.record_train_span(
            self.run_id, "train.step", start_ts, end_ts,
            rank=self.rank, step=step_index, attempt=self.attempt,
            other_s=round(other, 6),
            **{f"{k}_s": round(v, 6) for k, v in phases.items()})
        if parent is None:
            return
        for name, t0, t1 in intervals:
            tracing.record_train_span(
                self.run_id, f"phase.{name}", t0, t1, parent_id=parent,
                rank=self.rank, step=step_index, attempt=self.attempt)

    # -- phases -----------------------------------------------------------

    def phase(self, name: str):
        """Context manager attributing the block's wall time to `name`
        within the current step (opening one implicitly if needed).
        Unknown names are allowed — they show up as their own
        attribution bucket but are not part of the goodput split."""
        if not self.enabled:
            return _NULL_TIMER
        self.step_start()
        return _PhaseTimer(self, name)

    def add_phase(self, name: str, seconds: float) -> None:
        """Charge already-measured time to a phase of the current step
        (the after-the-fact entry point: prefetcher block times, the
        report() persist)."""
        if not self.enabled or seconds <= 0:
            return
        with self._lock:
            if self._step_t0 is None:
                # Time measured outside any step (e.g. the warmup fetch
                # before the loop): open an implicit step backdated to
                # when the measured block began, so the step's wall
                # covers the time just charged to it.
                self._step_t0 = time.perf_counter() - seconds
                self._step_wall0 = time.time() - seconds
                self._step_phases = {}
                self._step_intervals = []
            self._step_phases[name] = (self._step_phases.get(name, 0.0)
                                       + seconds)
            now = time.time()
            self._step_intervals.append((name, now - seconds, now))

    def on_report(self) -> None:
        """`train.report()` delimits implicit steps; explicit
        `step_phases()` blocks close at CM exit instead so a loop that
        reports mid-step is not cut short."""
        if not self.enabled:
            return
        with self._lock:
            explicit = self._step_explicit
        if not explicit:
            self.step_end()

    def observe_persist(self, seconds: float) -> None:
        """Satellite: the checkpoint persist used to block the user
        loop untimed — fold it into the `checkpoint` phase and export
        its own histogram so slow persists stop masquerading as slow
        steps."""
        if not self.enabled:
            return
        self.add_phase("checkpoint", seconds)
        _metrics()["persist_seconds"].observe(seconds, self._tags)

    # -- federation -------------------------------------------------------

    def gauges(self) -> Dict[str, Any]:
        """Cumulative per-rank counters for the node-daemon push. The
        GCS TrainRunState retains these across TTL expiry, so a rank
        that stops pushing (SIGSTOP, death) stays attributable."""
        with self._lock:
            window = list(self._window)
            out: Dict[str, Any] = {
                "rank": self.rank,
                "world": self.world_size,
                "attempt": self.attempt,
                "run_id": self.run_id,
                "started_ts": self.started_ts,
                "steps": self.steps_total,
                "first_step": self.first_step,
                "last_step": self.last_step,
                "last_step_ts": self.last_step_ts,
                "step_s": round(self.step_s_total, 6),
            }
            for name, total in self.phase_s.items():
                out[f"{name}_s"] = round(total, 6)
        if window:
            out["window_steps"] = len(window)
            out["window_step_s"] = round(sum(window), 6)
        if self.flops_per_step:
            out["flops_per_step"] = float(self.flops_per_step)
        if self.finished:
            out["finished"] = True
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Local attribution summary (benches, tests): cumulative phase
        seconds plus the derived busy fraction — productive share of
        attributed wall time, where unmeasured remainder counts as
        productive (same optimistic split the GCS applies)."""
        g = self.gauges()
        total = g.get("step_s", 0.0)
        busy = g.get("compute_s", 0.0) + g.get("other_s", 0.0)
        g["busy_fraction"] = (busy / total) if total > 0 else 0.0
        return g


@contextlib.contextmanager
def step(rec: Optional["StepPhaseRecorder"]):
    """One explicit training step on `rec` (None-safe): phases inside
    attribute to this step; the step closes at block exit."""
    if rec is None or not rec.enabled:
        yield rec
        return
    rec.step_start(explicit=True)
    try:
        yield rec
    finally:
        rec.step_end()


class PhasedIterator:
    """Iterator wrapper charging `__next__` block time to `data_wait`
    — what `session.get_dataset_shard` installs around plain-iterable
    shards so hand-fed loops get input attribution for free (Dataset
    shards get it from the device prefetcher hook instead)."""

    def __init__(self, it, rec: Optional["StepPhaseRecorder"] = None):
        self._it = iter(it)
        self._rec = rec

    def __iter__(self):
        return self

    def __next__(self):
        rec = self._rec if self._rec is not None else _active
        if rec is None or not rec.enabled:
            return next(self._it)
        t0 = time.perf_counter()
        try:
            return next(self._it)
        finally:
            rec.add_phase("data_wait", time.perf_counter() - t0)


class GaugePusher:
    """Background per-rank gauge push to the local node daemon
    (modeled on serve/replica.py's `_gauge_loop`): cumulative step and
    phase counters every `train_obs_push_s`, with the process metric
    registry piggybacked so the per-rank histograms reach the GCS
    federation. Local mode (no daemon) degrades to registry-only."""

    def __init__(self, rec: StepPhaseRecorder):
        self._rec = rec
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if not self._rec.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="train-obs-push", daemon=True)
        self._thread.start()

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        if flush:
            self._push_once()
            self._flush_spans()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    @staticmethod
    def _flush_spans() -> None:
        """Synchronously ship any step/phase spans still buffered in
        this process. The gang's workers are torn down right after the
        loop fn returns, before the event flusher's next tick — without
        this a short failover leg (restart, finish in under one flush
        period) leaves its whole trace in a dying process."""
        try:
            from ray_tpu_torch.api import _global_worker, is_initialized

            if not is_initialized():
                return
            core = _global_worker()
            buf = getattr(core, "task_events", None)
            loop = getattr(core, "loop_thread", None)
            if buf is None or loop is None:
                return
            loop.run(buf.flush_final(), timeout=5)
        except Exception:  # noqa: BLE001 telemetry must not kill training
            pass

    def _loop(self) -> None:
        period = max(0.1, get_config().train_obs_push_s)
        while not self._stop.wait(period):
            self._push_once()

    def _push_once(self) -> None:
        try:
            from ray_tpu_torch.api import _global_worker, is_initialized

            if not is_initialized():
                return
            daemon = getattr(_global_worker(), "daemon", None)
            if daemon is None:
                return
            daemon.call("NodeDaemon", "report_train_gauges",
                        run=self._rec.run, rank=self._rec.rank,
                        gauges=self._rec.gauges(),
                        metrics=registry_dump(), timeout=2)
        except Exception:  # noqa: BLE001 telemetry must not kill training
            pass
