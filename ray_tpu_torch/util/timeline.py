"""Chrome-trace timeline export from the GCS task-event sink.
Counterpart of `ray_tpu/util/timeline.py`, over the port's GCS.

ref: `ray timeline` (python/ray/_private/state.py:917 chrome_tracing_dump
over profile events, _private/profiling.py). Open the output in
chrome://tracing or https://ui.perfetto.dev.

One merged trace: task status transitions (submit slice on the caller's
row, run slice on the worker's row, joined by a flow arrow), tracing
spans (on the emitting node/worker rows), and opt-in profile events
(object transfers etc.) — all in the same process/thread grid so a
task's whole life reads left-to-right across rows.
"""
from __future__ import annotations

import json
from typing import List, Optional


def fetch_task_events(limit: int = 10000) -> List[dict]:
    from ray_tpu_torch.api import _global_worker

    return _global_worker().gcs.call("TaskEvents", "list_events",
                                     limit=limit, timeout=30)


def _node_row(node_id) -> str:
    return f"node:{(node_id or '?')[:8]}"


def chrome_trace(events: Optional[List[dict]] = None) -> List[dict]:
    """Convert task events to chrome-trace events: 'X' (complete) slices
    plus 's'/'f' flow arrows from each attempt's submit slice to its run
    slice."""
    if events is None:
        events = fetch_task_events()
    trace: List[dict] = []
    flow_seq = 0
    for e in events:
        kind = e.get("kind")
        if kind == "span":
            from ray_tpu_torch.util.tracing import spans_to_chrome_trace

            trace.extend(spans_to_chrome_trace([e]))
            continue
        if kind == "profile":
            start, end = e.get("start_ts"), e.get("end_ts")
            if start is None or end is None:
                continue
            row = _node_row(e.get("node_id"))
            trace.append({
                "name": e.get("name", "profile"),
                "cat": e.get("category", "profile"),
                "ph": "X",
                "ts": start * 1e6,
                "dur": max(0.0, end - start) * 1e6,
                "pid": row,
                "tid": f"worker:{e.get('pid', '?')}",
                "args": {k: v for k, v in e.items()
                         if k not in ("kind", "name", "category",
                                      "start_ts", "end_ts")},
            })
            if e.get("samples") is not None:
                # Counter track: `ray-tpu profile` captures annotate
                # the node row with their sample weight, so a capture
                # window reads as a labelled spike next to the tasks
                # it sampled (perfetto renders 'C' events as tracks).
                counter = {"name": "cpu_profile_samples",
                           "cat": "cpu_profile", "ph": "C", "pid": row}
                trace.append({**counter, "ts": start * 1e6,
                              "args": {"samples": e["samples"]}})
                trace.append({**counter, "ts": end * 1e6,
                              "args": {"samples": 0}})
            continue
        name = e.get("name", "task")
        st = e.get("state_ts") or {}
        run_start = e.get("start_ts") or st.get("RUNNING")
        end = e.get("end_ts")
        args = {
            "task_id": e.get("task_id"),
            "state": e.get("state"),
            "attempt": e.get("attempt"),
            "error": e.get("error"),
            "state_ts": st,
        }
        run_row = None
        if run_start is not None and end is not None:
            run_row = (_node_row(e.get("node_id")),
                       f"worker:{e.get('pid', '?')}")
            trace.append({
                "name": name,
                "cat": "actor_task" if e.get("actor_id") else "task",
                "ph": "X",
                "ts": run_start * 1e6,
                "dur": max(0.0, end - run_start) * 1e6,
                "pid": run_row[0],
                "tid": run_row[1],
                "args": args,
            })
        submit_ts = st.get("SUBMITTED")
        if submit_ts is not None:
            # Submit slice on the CALLER's row, spanning submission to
            # lease/run handoff (floored so perfetto renders it).
            handoff = st.get("LEASED") or run_start
            sub_row = (_node_row(e.get("submit_node_id")),
                       f"driver:{e.get('submit_pid', '?')}")
            trace.append({
                "name": f"submit:{name}",
                "cat": "submit",
                "ph": "X",
                "ts": submit_ts * 1e6,
                "dur": max(1.0, ((handoff or submit_ts) - submit_ts)
                           * 1e6),
                "pid": sub_row[0],
                "tid": sub_row[1],
                "args": args,
            })
            if run_row is not None and run_start >= submit_ts:
                # Flow arrow: submit -> run. Same id binds the pair; the
                # 's' sits inside the submit slice, the 'f' at the run
                # slice's start (bp=e attaches to the enclosing slice).
                flow_seq += 1
                fid = (f"{e.get('task_id', flow_seq)}:"
                       f"{e.get('attempt', 0)}")
                flow = {"name": "submit_to_run", "cat": "task_flow",
                        "id": fid}
                trace.append({**flow, "ph": "s", "ts": submit_ts * 1e6,
                              "pid": sub_row[0], "tid": sub_row[1]})
                trace.append({**flow, "ph": "f", "bp": "e",
                              "ts": run_start * 1e6,
                              "pid": run_row[0], "tid": run_row[1]})
    return trace


def timeline(filename: str = "timeline.json") -> str:
    """Dump the cluster's task timeline as a chrome trace; returns path."""
    with open(filename, "w") as f:
        json.dump(chrome_trace(), f)
    return filename


# ---------------------------------------------------------------------------
# Per-request serve traces (`ray-tpu serve trace <request-id>`): the
# request id IS the trace id, so one trace_id filter over the GCS span
# sink yields the request's whole serving path — proxy admission, handle
# routing (and failover re-routes), replica hop, engine queue_wait /
# prefill chunks / per-burst decode, stream batches.
# ---------------------------------------------------------------------------

def fetch_spans(trace_id: Optional[str] = None,
                limit: int = 10000) -> List[dict]:
    from ray_tpu_torch.api import _global_worker

    return _global_worker().gcs.call("TaskEvents", "list_spans",
                                     trace_id=trace_id, limit=limit,
                                     timeout=30)


def request_chrome_trace(spans: List[dict]) -> List[dict]:
    """Chrome-trace events for ONE request: a dedicated
    `request:<id>` process whose threads are the serving hops, so the
    track reads top-to-bottom in causal order (proxy -> handle ->
    replica -> engine) and left-to-right in time.  Hop = the span-name
    segment after "serve." ("proxy.request" -> "proxy"); resumed spans
    render in their own `<hop> (resumed)` rows so a failover shows as a
    visible second act on the same track."""
    out: List[dict] = []
    hop_order = {"proxy": 0, "handle": 1, "replica": 2, "engine": 3}
    for s in spans:
        if s.get("end_ts") is None or s.get("start_ts") is None:
            continue
        parts = s.get("name", "").split(".")
        hop = parts[1] if len(parts) > 1 and parts[0] == "serve" \
            else parts[0] or "span"
        attrs = s.get("attrs", {}) or {}
        tid = f"{hop_order.get(hop, 9)}:{hop}"
        if attrs.get("resumed"):
            tid += " (resumed)"
        out.append({
            "name": s.get("name", "span"),
            "cat": "serve_request",
            "ph": "X",
            "ts": s["start_ts"] * 1e6,
            "dur": max(1.0, (s["end_ts"] - s["start_ts"]) * 1e6),
            "pid": f"request:{(s.get('trace_id') or '?')[:12]}",
            "tid": tid,
            "args": {**attrs,
                     "trace_id": s.get("trace_id"),
                     "span_id": s.get("span_id"),
                     "parent_id": s.get("parent_id"),
                     "node_id": s.get("node_id"),
                     "pid": s.get("pid")},
        })
    return out


def request_trace(request_id: str,
                  filename: Optional[str] = None) -> str:
    """Dump one request's serving-path spans as a chrome trace; returns
    the path (default `trace-<first 12 of id>.json`)."""
    spans = fetch_spans(trace_id=request_id)
    if not spans:
        raise ValueError(
            f"no spans recorded for request {request_id!r} (is "
            f"RAY_TPU_SERVE_TRACE_ENABLED=0, or has the span buffer "
            f"not flushed yet?)")
    if filename is None:
        filename = f"trace-{request_id[:12]}.json"
    with open(filename, "w") as f:
        json.dump(request_chrome_trace(spans), f)
    return filename


# ---------------------------------------------------------------------------
# Per-run train traces (`ray-tpu train trace <run>`): the run id
# (experiment name + fit attempt, e.g. "mnist#0") IS the trace id.
# Stable across gang restarts within a fit, so a chaos run's failover
# leg renders in the same trace as the attempt it replaced.
# ---------------------------------------------------------------------------

def train_chrome_trace(spans: List[dict]) -> List[dict]:
    """Chrome-trace events for ONE training run: a dedicated
    `run:<id>` process with one thread PER RANK, so cross-rank skew is
    visible as ragged step edges down the rank rows.  `train.step`
    spans carry the per-phase attribution in args; `phase.*` child
    spans nest inside their step slice on the same rank row.  A gang
    restart's new attempt renders on `rank N (attempt K)` rows — the
    visible second act of a failover."""
    out: List[dict] = []
    for s in spans:
        if s.get("end_ts") is None or s.get("start_ts") is None:
            continue
        attrs = s.get("attrs", {}) or {}
        rank = attrs.get("rank", "?")
        attempt = attrs.get("attempt", 0)
        tid = f"{rank:>04}:rank {rank}" if isinstance(rank, int) \
            else f"zzzz:rank {rank}"
        if attempt:
            tid += f" (attempt {attempt})"
        out.append({
            "name": s.get("name", "span"),
            "cat": "train_run",
            "ph": "X",
            "ts": s["start_ts"] * 1e6,
            "dur": max(1.0, (s["end_ts"] - s["start_ts"]) * 1e6),
            "pid": f"run:{s.get('trace_id') or '?'}",
            "tid": tid,
            "args": {**attrs,
                     "trace_id": s.get("trace_id"),
                     "span_id": s.get("span_id"),
                     "parent_id": s.get("parent_id"),
                     "node_id": s.get("node_id"),
                     "pid": s.get("pid")},
        })
    return out


def train_trace(run_id: str, filename: Optional[str] = None) -> str:
    """Dump one training run's per-rank step/phase spans as a chrome
    trace; returns the path (default `train-trace-<run>.json`)."""
    spans = fetch_spans(trace_id=run_id)
    if not spans and "#" not in run_id:
        # Bare experiment name: take every fit attempt of it
        # ("mnist" matches "mnist#0", "mnist#1", ...).
        spans = [s for s in fetch_spans()
                 if (s.get("trace_id") or "").startswith(f"{run_id}#")]
    if not spans:
        raise ValueError(
            f"no spans recorded for train run {run_id!r} (is "
            f"RAY_TPU_TRAIN_OBS_ENABLED=0, or has the span buffer "
            f"not flushed yet?)")
    if filename is None:
        filename = f"train-trace-{run_id.replace('#', '_')}.json"
    with open(filename, "w") as f:
        json.dump(train_chrome_trace(spans), f)
    return filename
