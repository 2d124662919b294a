"""State API: programmatic cluster introspection.
Counterpart of `ray_tpu/util/state.py`, over the port's GCS.

Analogue of the reference state SDK (ref: python/ray/util/state/api.py —
list_tasks/list_actors/list_nodes/list_placement_groups/list_jobs,
backed by the GCS task-event and registry tables; CLI in state_cli.py —
ours is `ray-tpu list ...`). Each call is one GCS RPC through the
ambient driver connection; `filters` are (key, predicate, value) tuples
with predicate "=", "!=", "contains" or "prefix" (the reference surface
plus the substring forms `ray-tpu stack --task` name-matching needs).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

Filter = Tuple[str, str, Any]


def _gcs():
    from ray_tpu_torch.api import _global_worker

    return _global_worker().gcs


def _apply_filters(rows: List[dict],
                   filters: Optional[List[Filter]]) -> List[dict]:
    if not filters:
        return rows
    out = []
    for row in rows:
        ok = True
        for key, pred, value in filters:
            have = row.get(key)
            if pred == "=":
                ok = have == value
            elif pred == "!=":
                ok = have != value
            elif pred == "contains":
                ok = have is not None and str(value) in str(have)
            elif pred == "prefix":
                ok = (have is not None
                      and str(have).startswith(str(value)))
            else:
                raise ValueError(
                    f"unsupported predicate {pred!r} "
                    f"(valid: '=', '!=', 'contains', 'prefix')")
            if not ok:
                break
        if ok:
            out.append(row)
    return out


def list_nodes(filters: Optional[List[Filter]] = None,
               limit: int = 10000) -> List[dict]:
    rows = _gcs().call("NodeInfo", "list_nodes", timeout=30)
    return _apply_filters(rows, filters)[:limit]


def list_actors(filters: Optional[List[Filter]] = None,
                limit: int = 10000) -> List[dict]:
    rows = _gcs().call("ActorManager", "list_actors", timeout=30)
    return _apply_filters(rows, filters)[:limit]


def list_tasks(filters: Optional[List[Filter]] = None,
               limit: int = 10000) -> List[dict]:
    """Task attempts with their full status-transition history: each row
    carries `state_ts` ({state: wall time} for SUBMITTED/LEASED/RUNNING/
    FINISHED|FAILED) merged across the driver's and executor's reports.
    Use task_events_stats() for how complete this window is."""
    rows = _gcs().call("TaskEvents", "list_events", limit=limit,
                       timeout=30)
    rows = [r for r in rows if r.get("kind") not in ("span", "profile")]
    return _apply_filters(rows, filters)[:limit]


def get_task(task_id: str) -> List[dict]:
    """All stored attempts of one task (ref: `ray get tasks <id>`)."""
    return _gcs().call("TaskEvents", "get_task", task_id=task_id,
                       timeout=30)


def task_events_stats() -> dict:
    """Completeness accounting for the task-event window: stored counts
    plus everything dropped worker-side (bounded ring under a dead GCS)
    or evicted GCS-side (per-job cap, finished-job GC)."""
    return _gcs().call("TaskEvents", "stats", timeout=30)


def list_placement_groups(filters: Optional[List[Filter]] = None,
                          limit: int = 10000) -> List[dict]:
    rows = _gcs().call("PlacementGroups", "list_pgs", timeout=30)
    return _apply_filters(rows, filters)[:limit]


def list_jobs(filters: Optional[List[Filter]] = None,
              limit: int = 10000) -> List[dict]:
    rows = _gcs().call("JobManager", "list_jobs", timeout=30)
    return _apply_filters(rows, filters)[:limit]


def list_workers(filters: Optional[List[Filter]] = None,
                 limit: int = 10000) -> List[dict]:
    from ray_tpu_torch.api import _global_worker
    from ray_tpu_torch.core.distributed.rpc import SyncRpcClient

    w = _global_worker()
    rows: List[dict] = []
    for n in list_nodes():
        if not n["alive"]:
            continue
        client = SyncRpcClient(n["address"], w.loop_thread)
        try:
            for worker in client.call("NodeDaemon", "list_workers",
                                      timeout=10):
                worker["node_id"] = n["node_id"]
                rows.append(worker)
        except Exception:  # noqa: BLE001 node mid-restart
            continue
        finally:
            client.close()
    return _apply_filters(rows, filters)[:limit]


def summarize_tasks() -> Dict[str, Dict[str, int]]:
    """Per-task-name state counts (ref: `ray summary tasks`), computed
    GCS-side over the full stored window (not a list_tasks page)."""
    return _gcs().call("TaskEvents", "summarize", timeout=30)["tasks"]


def task_summary() -> dict:
    """summarize_tasks plus the completeness meta: {"tasks": per-name
    state counts, "completeness": stored/evicted/dropped accounting} —
    the honest version (a capped window must say it is a window)."""
    return _gcs().call("TaskEvents", "summarize", timeout=30)


def get_actor(actor_id: str) -> Optional[dict]:
    return _gcs().call("ActorManager", "get_actor", actor_id=actor_id,
                       timeout=30)


def dump_stacks(node_id: Optional[str] = None,
                worker_id: Optional[str] = None,
                pids: Optional[List[int]] = None) -> List[dict]:
    """Signal-safe all-thread stack dumps from every (matching) live
    worker in the cluster, fanned out by the GCS Diagnosis service —
    works even for workers wedged in GIL-holding native code (the
    faulthandler/SIGUSR1 path, not in-process sampling)."""
    return _gcs().call("Diagnosis", "dump_stacks", node_id=node_id,
                       worker_id=worker_id, pids=pids, timeout=60)


def summarize_stacks(node_id: Optional[str] = None) -> dict:
    """Cluster stack dump grouped by identical thread stacks: the
    one-line hang answer ("412/512 workers blocked in all_reduce at
    collective.py:...") under "groups", raw per-node dumps under
    "nodes"."""
    return _gcs().call("Diagnosis", "summarize_stacks", node_id=node_id,
                       timeout=60)


def hung_tasks() -> List[dict]:
    """Attempts the hung-task watchdog flagged that are still RUNNING
    (also surfaced under cluster_status()["observability"])."""
    return _gcs().call("Metrics", "cluster_summary",
                       timeout=30).get("hung_tasks", [])


def elastic_events(limit: int = 100) -> List[dict]:
    """Elastic-training plane events (gang restarts, shrinks, grows,
    replacement timeouts) emitted by the ElasticSupervisor via the GCS
    event log."""
    return _gcs().call("EventLog", "list_events", source="elastic",
                       limit=limit, timeout=30)


def cluster_events(kind: Optional[str] = None,
                   node_id: Optional[str] = None,
                   since: Optional[float] = None,
                   until: Optional[float] = None,
                   limit: int = 200) -> List[dict]:
    """Cluster flight-recorder timeline: durable state transitions
    (node join/death/re-registration, serve failover, drain + KV
    migration, autoscale and elastic resizes, PG repair) oldest-first.
    `kind` is a prefix match ("node" matches node.join/node.death...);
    `since`/`until` are wall-clock bounds. Survives GCS restarts."""
    return _gcs().call("FlightRecorder", "list_events", kind=kind,
                       node_id=node_id, since=since, until=until,
                       limit=limit, timeout=30)


def gcs_load() -> dict:
    """GCS control-plane self-observability: per-service x per-caller-
    component load shares (requests/bytes/handler time) since GCS boot,
    the slow-handler audit, the event-loop audit, and flight-journal
    stats. Same blob as cluster_status()["observability"]["gcs"]."""
    return _gcs().call("Metrics", "gcs_load", timeout=30)


def doctor() -> dict:
    """One fused cluster health report: ranked findings over federated
    metrics freshness, hung tasks, task-event loss, GCS load shares,
    event-loop lag, and recent flight-recorder entries. Each finding
    has a severity, a score (higher = worse) and an actionable hint."""
    return _gcs().call("Metrics", "doctor", timeout=30)


def placement_groups() -> List[dict]:
    """All placement groups with gang state: per-PG `placed`/
    `bundle_count` shows a gang mid-repair (holes being re-reserved)."""
    return _gcs().call("PlacementGroups", "list_pgs", timeout=30)


def cluster_status() -> dict:
    """The autoscaler's view: demand, idle times, resource requests —
    enriched with the observability rollup (metrics federation
    freshness, task-event completeness, watchdog-flagged hung tasks)
    under "observability"."""
    status = _gcs().call("AutoscalerState", "get_cluster_status",
                         timeout=30)
    try:
        status["observability"] = _gcs().call("Metrics", "cluster_summary",
                                              timeout=30)
    except Exception:  # noqa: BLE001 — pre-federation GCS
        pass
    return status


def cluster_metrics() -> str:
    """The GCS's federated Prometheus exposition: every node's last
    syncer-shipped snapshot merged, node-labelled."""
    return _gcs().call("Metrics", "federated_text", timeout=30)


def serve_summary() -> dict:
    """Serving-plane observability rollup: per-app replica gauges plus
    the latency/counter view mined from the federated serve metrics
    ({"apps", "latency" (ttft/itl/phase means), "counters"}).  Same
    blob as cluster_status()["observability"]["serve"]."""
    return _gcs().call("Metrics", "cluster_summary",
                       timeout=30).get("serve", {})


def train_runs() -> dict:
    """Train-plane goodput view: per-run wall-time split (productive
    compute vs data-stall vs sync-stall vs checkpoint vs
    lost-to-restart), current step rate, cross-rank skew window with
    blame-rank attribution, restart accounting, and the optional MFU
    estimate ({run: {...}}). Same blob as
    cluster_status()["observability"]["train"]["runs"]."""
    return _gcs().call("Train", "summary", timeout=30).get("runs", {})


def train_trace(run_id: str, filename: Optional[str] = None) -> str:
    """Dump one training run's per-rank step/phase span tracks as a
    chrome/perfetto trace; returns the written path. Convenience
    re-export of ray_tpu_torch.util.timeline.train_trace."""
    from ray_tpu_torch.util.timeline import train_trace as _tt

    return _tt(run_id, filename=filename)


def request_trace(request_id: str,
                  filename: Optional[str] = None) -> str:
    """Dump one serve request's end-to-end span track (proxy -> handle
    -> replica -> engine) as a chrome/perfetto trace; returns the
    written path. Convenience re-export of
    ray_tpu_torch.util.timeline.request_trace."""
    from ray_tpu_torch.util.timeline import request_trace as _rt

    return _rt(request_id, filename=filename)
