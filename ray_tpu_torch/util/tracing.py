"""Distributed tracing: spans with cross-task context propagation.

The port's copy of `ray_tpu/util/tracing.py`,
importing `ray_tpu_torch` only.

Analogue of the reference's OpenTelemetry tracing hooks
(ref: python/ray/util/tracing/tracing_helper.py — _OpenTelemetryProxy
:34, `_DictPropagator` :165 injecting the span context into the
TaskSpec, extracted around task execution in _raylet.pyx). Here the span
model is self-contained (no opentelemetry dependency in a zero-egress
image): spans carry trace_id/span_id/parent_id, the current context
propagates via a contextvar, `inject()/extract()` move it through task
specs, and finished spans flush into the GCS TaskEvents sink (kind
"span"). An OTLP-shaped exporter can be plugged via `set_exporter`.
The serving-plane spans (`serve_ctx`, `serve_span`, `record_serve_span`)
and the train-plane ones (`record_train_span`) are here.

Opt-in: RAY_TPU_TRACING_ENABLED=1 (ref: ray.init(_tracing_startup_hook)).
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.core.config import get_config

_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "ray_tpu_span", default=None)
_buffer: List[dict] = []
_buffer_lock = threading.Lock()
_exporter: Optional[Callable[[List[dict]], None]] = None
MAX_BUFFER = 10000
# Which node this process runs on (set by the core worker at init):
# stamped onto finished spans so the timeline can place them under the
# emitting node/worker rows instead of a synthetic trace_id process.
_node_id: Optional[str] = None


def set_node_context(node_id: str) -> None:
    global _node_id
    _node_id = node_id


def enabled() -> bool:
    return get_config().tracing_enabled


def serve_enabled() -> bool:
    """Serving-plane request tracing (independent of the generic task
    tracing opt-in; RAY_TPU_SERVE_TRACE_ENABLED=0 is the kill switch)."""
    return get_config().serve_trace_enabled


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs",
                 "start", "end")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs or {}
        self.start = time.time()
        self.end: Optional[float] = None

    def finish(self, end_ts: Optional[float] = None) -> dict:
        import os

        self.end = time.time() if end_ts is None else end_ts
        record = {
            "kind": "span",
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ts": self.start,
            "end_ts": self.end,
            "node_id": _node_id,
            "pid": os.getpid(),
            "attrs": self.attrs,
        }
        with _buffer_lock:
            _buffer.append(record)
            if len(_buffer) > MAX_BUFFER:
                del _buffer[:MAX_BUFFER // 2]
        return record


@contextlib.contextmanager
def span(name: str, **attrs):
    """Open a span under the current context (no-op when tracing is
    off). Usage: `with tracing.span("preprocess", rows=n): ...`"""
    if not enabled():
        yield None
        return
    parent = _current.get()
    s = Span(name,
             trace_id=(parent.trace_id if parent else uuid.uuid4().hex),
             parent_id=(parent.span_id if parent else None),
             attrs=attrs)
    token = _current.set(s)
    try:
        yield s
    finally:
        _current.reset(token)
        s.finish()


def inject() -> Optional[Dict[str, str]]:
    """Serialize the current span context for a TaskSpec (ref:
    _DictPropagator.inject_current_context)."""
    if not enabled():
        return None
    cur = _current.get()
    if cur is None:
        return None
    return {"trace_id": cur.trace_id, "span_id": cur.span_id}


@contextlib.contextmanager
def extract_and_span(ctx: Optional[Dict[str, str]], name: str, **attrs):
    """Open an execution-side span whose parent is the submitted
    context (ref: the execute-side wrapper in _raylet.pyx)."""
    if not enabled() or ctx is None:
        yield None
        return
    s = Span(name, trace_id=ctx["trace_id"],
             parent_id=ctx.get("span_id"), attrs=attrs)
    token = _current.set(s)
    try:
        yield s
    finally:
        _current.reset(token)
        s.finish()


# ---------------------------------------------------------------------------
# Serving-plane request traces: the serve path passes an EXPLICIT context
# dict ({"trace_id": <request id>, "span_id": <parent>}) from hop to hop
# (proxy -> handle -> replica -> engine) instead of relying on the
# contextvar — the engine emits spans from its own tick thread, replicas
# from puller threads, none of which inherit the request's context.  The
# request id IS the trace id, so `ray-tpu serve trace <request-id>`
# is a trace_id filter over the GCS span sink.
# ---------------------------------------------------------------------------

def serve_ctx(request_id: str, parent_span_id: Optional[str] = None,
              **extra) -> Optional[Dict[str, Any]]:
    """Mint a serve trace context from a request id; None when serve
    tracing is off (every downstream helper no-ops on None)."""
    if not serve_enabled() or not request_id:
        return None
    ctx: Dict[str, Any] = {"trace_id": request_id,
                           "span_id": parent_span_id}
    ctx.update(extra)
    return ctx


def child_ctx(ctx: Optional[Dict[str, Any]],
              span: Optional["Span"]) -> Optional[Dict[str, Any]]:
    """Context for the next hop: same trace, parented under `span`."""
    if ctx is None:
        return None
    if span is None:
        return ctx
    out = dict(ctx)
    out["span_id"] = span.span_id
    return out


@contextlib.contextmanager
def serve_span(ctx: Optional[Dict[str, Any]], name: str, **attrs):
    """Open a serve-plane span under an explicit request context.
    No-op (yields None) when tracing is off or there is no context —
    the caller never branches."""
    if ctx is None or not serve_enabled():
        yield None
        return
    if ctx.get("resumed"):
        attrs.setdefault("resumed", 1)
    s = Span(name, trace_id=ctx["trace_id"],
             parent_id=ctx.get("span_id"), attrs=attrs)
    try:
        yield s
    finally:
        s.finish()


def record_serve_span(ctx: Optional[Dict[str, Any]], name: str,
                      start_ts: float, end_ts: Optional[float] = None,
                      **attrs) -> None:
    """Record an already-timed serve span (engine ticks measure their
    own wall window; spans are minted after the fact)."""
    if ctx is None or not serve_enabled():
        return
    if ctx.get("resumed"):
        attrs.setdefault("resumed", 1)
    s = Span(name, trace_id=ctx["trace_id"],
             parent_id=ctx.get("span_id"), attrs=attrs)
    s.start = start_ts
    s.finish(end_ts)


def train_enabled() -> bool:
    """Train-plane step/phase tracing — shares the
    RAY_TPU_TRAIN_OBS_ENABLED kill switch with the rest of the train
    observability stack (gauges, TrainRunState)."""
    return get_config().train_obs_enabled


def record_train_span(run_id: Optional[str], name: str, start_ts: float,
                      end_ts: Optional[float] = None,
                      parent_id: Optional[str] = None,
                      **attrs) -> Optional[str]:
    """Record an already-timed train-plane span. The run id IS the
    trace id (experiment name + fit attempt), so `ray-tpu train trace
    <run>` is a trace_id filter over the GCS span sink — the same query
    shape as serve request traces. Step loops measure their own wall
    windows, so spans are minted after the fact; returns the span id so
    phase children can parent under their step."""
    if not run_id or not train_enabled():
        return None
    s = Span(name, trace_id=run_id, parent_id=parent_id, attrs=attrs)
    s.start = start_ts
    s.finish(end_ts)
    return s.span_id


def drain() -> List[dict]:
    """Take all finished spans (the worker's event flusher ships them to
    the GCS TaskEvents sink)."""
    global _buffer
    with _buffer_lock:
        out, _buffer = _buffer, []
    if _exporter is not None and out:
        try:
            _exporter(out)
        except Exception:  # noqa: BLE001 exporter must not break flushing
            pass
    return out


def has_pending() -> bool:
    """Cheap liveness probe for the flush loop's idle backoff: a parked
    worker that suddenly mints spans (e.g. lands a restarted train gang)
    must wake within one flush period, not sit out a backed-off sleep."""
    return bool(_buffer)


def set_exporter(fn: Optional[Callable[[List[dict]], None]]) -> None:
    """Install an exporter invoked with each drained span batch (e.g. an
    OTLP forwarder); pass None to remove."""
    global _exporter
    _exporter = fn


def spans_to_chrome_trace(spans: List[dict]) -> List[dict]:
    """Chrome-tracing events for `ray-tpu timeline` merging. Spans land
    under the emitting node/worker rows (pid=node, tid=worker pid), the
    same rows their task slices render on — NOT under a synthetic
    pid=trace_id process, which scattered every trace into its own
    process group and never lined up with the task rows in perfetto.
    The trace/span lineage stays available in args."""
    out = []
    for s in spans:
        node = s.get("node_id")
        out.append({
            "name": s["name"],
            "cat": "span",
            "ph": "X",
            "ts": s["start_ts"] * 1e6,
            "dur": (s["end_ts"] - s["start_ts"]) * 1e6,
            "pid": f"node:{node[:8]}" if node else "node:?",
            "tid": f"worker:{s.get('pid', '?')}",
            "args": {**s.get("attrs", {}),
                     "trace_id": s.get("trace_id"),
                     "span_id": s.get("span_id"),
                     "parent_id": s.get("parent_id")},
        })
    return out
