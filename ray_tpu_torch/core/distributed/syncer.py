"""Cluster-state syncer: versioned delta broadcast between daemons and GCS.

The port's copy of `ray_tpu/core/distributed/syncer.py`,
importing `ray_tpu_torch` only.

Analogue of the reference RaySyncer (ref: src/ray/protobuf/ray_syncer.proto:62
RaySyncerMessage{version, node_id, message_type, sync_message};
src/ray/common/ray_syncer/ray_syncer.h:88 — each node reports versioned
RESOURCE_VIEW / COMMANDS snapshots over a long-lived bidi stream, receivers
apply them idempotently by (node_id, version)). Before this subsystem every
daemon re-sent its whole resource dict on a poll-loop heartbeat and re-read
the whole node table at 1 Hz — O(nodes²) control-plane bytes that capped the
scale envelope at single-digit daemons (VERDICT "What's missing" #2; control
plane sync overhead is exactly what limits concurrency at pod scale,
arXiv:2011.03641).

Two halves:

  NodeSyncer     (daemon / virtual-node side): keeps a monotonically
                 versioned local view (resources, load, object-store stats,
                 worker-pool depth), diffs it against the last acknowledged
                 snapshot every coalescing interval, and pushes ONLY the
                 changed keys. Unchanged ticks are suppressed; an idle node
                 degrades to a tiny keepalive that piggybacks liveness on
                 the sync channel. On (re)connect — GCS restart, stale-node
                 verdict, version gap — it resyncs with one full snapshot.

  ClusterSyncer  (GCS side): merges per-node versions with sequence-numbered
                 idempotent apply (duplicates ignored, gaps answered with a
                 resync request), folds the result into NodeInfo's
                 ClusterView (the same object the scheduler and autoscaler
                 read), and fans a coalesced cluster view back out to
                 subscribed daemons over a server-streaming RPC — the
                 spillback view that used to be a 1 Hz full list_nodes poll.

Every knob is a `RAY_TPU_SYNCER_*` env var (config.py); both halves export
Prometheus counters for deltas sent/suppressed/bytes so the delta-vs-full
ratio is assertable (bench_scale many_nodes does exactly that).
"""
from __future__ import annotations

import asyncio
import logging
import pickle
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.distributed.scheduler import (
    apply_node_wire,
    node_wire,
)

logger = logging.getLogger(__name__)

# State keys a node may report. Anything else in a push is dropped at
# apply time — the version seam (wire.py PROTOCOL_VERSION) covers real
# schema changes; this guard just keeps a buggy reporter from growing
# NodeView attributes dynamically.
STATE_KEYS = (
    "available",        # resources free right now
    "queued",           # queued lease demand (autoscaler input)
    "store_used",       # shm object-store bytes in use
    "store_objects",    # objects in the shm store
    "spilled_bytes",    # bytes spilled to disk
    "workers",          # worker-pool depth: live worker processes
    "idle_workers",     # ... of which idle (warm pool)
    "busy_workers",     # ... of which leased/actor-bound
    "serve",            # per-app serve replica gauges (autoscale input)
    "train",            # per-(run, rank) train step/phase gauges
)


class NodeSyncer:
    """Daemon-side reporter + cluster-view receiver.

    Transport-agnostic: `gcs` is anything with ``async call(service,
    method, **kw)`` and ``stream(service, method, **kw)`` (an
    AsyncRpcClient in production; tests pass fakes, and many virtual
    nodes share one multiplexed client).
    """

    def __init__(
        self,
        *,
        gcs: Any,
        node_id: str,
        collect: Callable[[], Dict[str, Any]],
        on_view: Optional[Callable[[dict], None]] = None,
        on_reregister: Optional[Callable[[], Awaitable[None]]] = None,
        report_interval_s: Optional[float] = None,
        keepalive_s: Optional[float] = None,
        metrics: Optional[dict] = None,
        metrics_provider: Optional[Callable[[], Any]] = None,
    ):
        cfg = get_config()
        self.gcs = gcs
        self.node_id = node_id
        self._collect = collect
        self._on_view = on_view
        self._on_reregister = on_reregister
        self.report_interval_s = (
            report_interval_s if report_interval_s is not None
            else cfg.syncer_report_interval_ms / 1000.0)
        self.keepalive_s = (keepalive_s if keepalive_s is not None
                            else cfg.syncer_keepalive_ms / 1000.0)
        # Metrics federation: a registry snapshot piggybacks on an
        # ordinary push (delta, full, OR keepalive — idle nodes must
        # stay fresh in the GCS's federated view) at a much slower
        # cadence than the delta interval. None/0 disables.
        self._metrics_provider = metrics_provider
        self.metrics_interval_s = cfg.metrics_sync_interval_ms / 1000.0
        self._last_metrics_t = 0.0
        # None => next push is a full snapshot (first contact / resync).
        self._last_sent: Optional[Dict[str, Any]] = None
        self.version = 0
        self._dirty = asyncio.Event()
        self._last_push_t = 0.0         # monotonic, successful pushes only
        self._last_view_t = 0.0         # monotonic, last broadcast applied
        self.view_version = 0           # cluster_version last applied
        # Prometheus counters are optional (the daemon passes its own,
        # node_id-tagged; 1000 in-process virtual nodes would collide on
        # the registry, so they rely on this dict instead).
        self._metrics = metrics or {}
        self.stats = {
            "deltas_sent": 0, "full_syncs": 0, "keepalives": 0,
            "suppressed": 0, "bytes_sent": 0, "errors": 0,
            "resyncs_requested": 0, "stale_verdicts": 0,
            "view_payloads": 0,
        }

    # -- public hooks ---------------------------------------------------
    def mark_dirty(self) -> None:
        """Hot-path hint (lease grant/return): wake the report loop now
        instead of at the next tick. Coalescing still applies — pushes
        never exceed 1/report_interval."""
        self._dirty.set()

    def force_full_resync(self) -> None:
        """Next push sends a full snapshot (re-registration, operator)."""
        self._last_sent = None

    def healthy(self) -> bool:
        """Did a push succeed recently enough that liveness is riding the
        sync channel? The heartbeat loop uses this to degrade itself to a
        slow fallback."""
        return (time.monotonic() - self._last_push_t
                < max(self.keepalive_s * 2, self.report_interval_s * 4))

    def view_fresh(self, max_age_s: float = 5.0) -> bool:
        """Has a broadcast been applied recently? The daemon's list_nodes
        poll loop only runs while this is False."""
        return time.monotonic() - self._last_view_t < max_age_s

    # -- report path ----------------------------------------------------
    async def sync_once(self) -> str:
        """One report cycle. Returns what happened: 'full' | 'delta' |
        'keepalive' | 'suppressed'. Raises on transport errors (the loop
        owns backoff)."""
        state = self._collect()
        now = time.monotonic()
        if self._last_sent is None:
            return await self._push(state, full=True)
        delta = {k: v for k, v in state.items()
                 if self._last_sent.get(k) != v}
        if not delta:
            if now - self._last_push_t >= self.keepalive_s:
                return await self._push(None, keepalive=True)
            self.stats["suppressed"] += 1
            self._inc("suppressed")
            return "suppressed"
        return await self._push(state, delta=delta)

    def _metrics_payload(self) -> Optional[Any]:
        """Registry snapshot to piggyback, when due (rate-limited to
        metrics_interval_s; never blocks or fails the push)."""
        if (self._metrics_provider is None
                or self.metrics_interval_s <= 0):
            return None
        now = time.monotonic()
        if now - self._last_metrics_t < self.metrics_interval_s:
            return None
        self._last_metrics_t = now
        try:
            return self._metrics_provider()
        except Exception:  # noqa: BLE001 telemetry must not break sync
            return None

    async def _push(self, state: Optional[Dict[str, Any]],
                    delta: Optional[Dict[str, Any]] = None,
                    full: bool = False, keepalive: bool = False) -> str:
        msnap = self._metrics_payload()
        # GCS load attribution: pushes are the syncer's own load, not
        # the daemon's scheduler default.
        whoami = (self.node_id, "syncer")
        if keepalive:
            reply = await self.gcs.call(
                "Syncer", "push_update", node_id=self.node_id,
                version=self.version, keepalive=True, metrics=msnap,
                _caller=whoami, timeout=10)
            kind = "keepalive"
        else:
            payload = dict(state) if full else delta
            base = self.version
            version = self.version + 1
            reply = await self.gcs.call(
                "Syncer", "push_update", node_id=self.node_id,
                version=version, base_version=base, state=payload,
                full=full, metrics=msnap, _caller=whoami, timeout=10)
            kind = "full" if full else "delta"
        if not reply.get("registered", True):
            # The GCS does not know us (restart) or marked us dead
            # (stale-node verdict): re-register, then resync fully.
            self.stats["stale_verdicts"] += 1
            self.force_full_resync()
            if self._on_reregister is not None:
                await self._on_reregister()
            return "stale"
        if reply.get("resync"):
            # Version gap (a delta we sent was lost, or the GCS restarted
            # between pushes): the next cycle sends a full snapshot.
            self.stats["resyncs_requested"] += 1
            self.force_full_resync()
            return "resync"
        self._last_push_t = time.monotonic()
        if keepalive:
            self.stats["keepalives"] += 1
            self._inc("keepalives")
            return kind
        self.version += 1
        self._last_sent = dict(state)
        nbytes = len(pickle.dumps(payload, protocol=5))
        self.stats["bytes_sent"] += nbytes
        self._inc("bytes", nbytes)
        if full:
            self.stats["full_syncs"] += 1
            self._inc("full_syncs")
        else:
            self.stats["deltas_sent"] += 1
            self._inc("deltas")
        return kind

    async def report_loop(self) -> None:
        backoff = self.report_interval_s
        while True:
            try:
                await asyncio.wait_for(self._dirty.wait(),
                                       timeout=self.report_interval_s)
                # Dirty wake: still honor the coalescing floor so a storm
                # of grants/returns batches into one delta per interval.
                gap = self.report_interval_s - (time.monotonic()
                                                - self._last_push_t)
                if gap > 0:
                    await asyncio.sleep(gap)
            except asyncio.TimeoutError:
                pass
            self._dirty.clear()
            try:
                await self.sync_once()
                backoff = self.report_interval_s
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                # GCS down/unreachable: capped exponential backoff, and
                # the next successful push after a gap resyncs anyway.
                self.stats["errors"] += 1
                logger.debug("syncer push failed: %s (retry in %.1fs)",
                             e, backoff)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2,
                              get_config().heartbeat_backoff_cap_s)

    # -- receive path (cluster-view fan-out) ----------------------------
    def apply_view_payload(self, payload: dict, view) -> None:
        """Fold one broadcast payload into a ClusterView (the daemon's
        spillback view)."""
        apply_node_wire(view, payload)
        self.view_version = payload.get("cluster_version", self.view_version)
        self._last_view_t = time.monotonic()
        self.stats["view_payloads"] += 1
        if self._on_view is not None:
            self._on_view(payload)

    async def subscribe_loop(self, view) -> None:
        """Long-lived server-streaming subscription to the GCS's coalesced
        cluster view; reconnects with backoff across GCS restarts."""
        backoff = 0.2
        while True:
            try:
                stream = self.gcs.stream("Syncer", "stream_cluster_view",
                                         node_id=self.node_id)
                async for payload in stream:
                    self.apply_view_payload(payload, view)
                    backoff = 0.2
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                logger.debug("cluster-view stream lost: %s (retry in "
                             "%.1fs)", e, backoff)
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2,
                          get_config().heartbeat_backoff_cap_s)

    def _inc(self, key: str, n: float = 1) -> None:
        m = self._metrics.get(key)
        if m is not None:
            m.inc(n)


class ClusterSyncer:
    """GCS-side merge + fan-out (ref: RaySyncer's receiver half +
    gcs_resource_manager's UpdateFromResourceView). Registered as the
    `Syncer` RPC service on the GCS server."""

    def __init__(self, gcs):
        self._gcs = gcs
        # node_id -> last applied version. Absent => the node must full-
        # sync first (fresh registration, GCS restart, post-death).
        self.versions: Dict[str, int] = {}
        self.cluster_version = 0
        self._dirty: set = set()        # node_ids changed since last fan-out
        self._dead_dirty: set = set()   # deaths to announce
        self._wake = asyncio.Event()
        self._subs: Dict[int, asyncio.Queue] = {}
        self._sub_seq = 0
        self.stats_counters = {
            "applied_deltas": 0, "applied_full": 0, "keepalives": 0,
            "stale_ignored": 0, "resync_requests": 0,
            "stale_node_verdicts": 0, "broadcasts": 0,
            "broadcast_payload_nodes": 0, "dirty_marks": 0,
        }
        self._init_metrics()

    def _init_metrics(self) -> None:
        from ray_tpu_torch.util.metrics import Counter, Gauge

        self._m_deltas = Counter(
            "raytpu_syncer_updates_applied_total",
            "Delta updates applied by the GCS syncer")
        self._m_full = Counter(
            "raytpu_syncer_full_syncs_total",
            "Full node-state snapshots applied by the GCS syncer")
        self._m_stale = Counter(
            "raytpu_syncer_stale_updates_total",
            "Duplicate/out-of-order updates ignored (idempotent apply)")
        self._m_resync = Counter(
            "raytpu_syncer_resync_requests_total",
            "Version gaps answered with a resync request")
        self._m_broadcasts = Counter(
            "raytpu_syncer_broadcasts_total",
            "Coalesced cluster-view fan-outs")
        self._m_subs = Gauge(
            "raytpu_syncer_subscribers",
            "Live cluster-view stream subscribers")

    # -- RPC surface ----------------------------------------------------
    def push_update(self, node_id: str, version: int,
                    base_version: int = 0,
                    state: Optional[Dict[str, Any]] = None,
                    full: bool = False, keepalive: bool = False,
                    metrics: Optional[Any] = None) -> dict:
        """Apply one node update. Sequence-numbered and idempotent:
        duplicates/out-of-order arrivals are ignored, gaps get a resync
        verdict, and every accepted message (keepalives included)
        refreshes the node's liveness — the stream IS the heartbeat.
        A piggybacked registry snapshot (`metrics`) feeds the GCS's
        federated exposition."""
        view = self._gcs.nodes.view
        n = view.nodes.get(node_id)
        if n is None:
            return {"registered": False,
                    "reason": "unknown node; register first"}
        if not n.alive:
            # Stale-node verdict (mirrors NodeInfo.heartbeat): a dead
            # node's pushes must not resurrect its entry silently.
            self.stats_counters["stale_node_verdicts"] += 1
            return {"registered": False, "stale": True,
                    "reason": f"node {node_id[:8]} is marked dead"}
        if metrics is not None:
            fed = getattr(self._gcs, "metrics", None)
            if fed is not None:
                fed.ingest(node_id, metrics)
        cur = self.versions.get(node_id)
        if keepalive:
            n.last_heartbeat = time.monotonic()
            self.stats_counters["keepalives"] += 1
            return {"ok": True, "applied": cur}
        if full:
            # A full snapshot is authoritative for its version; replaying
            # the same version is a no-op by value, so accept-and-apply
            # keeps the path idempotent under at-least-once retries.
            view.apply_state(node_id, {k: v for k, v in (state or {}).items()
                                       if k in STATE_KEYS})
            self.versions[node_id] = version
            self.stats_counters["applied_full"] += 1
            self._m_full.inc()
            self._mark_dirty(node_id)
            self._retain_train(state)
            return {"ok": True, "applied": version}
        if cur is None or base_version != cur:
            if cur is not None and version <= cur:
                # Duplicate or reordered old delta: already applied.
                self.stats_counters["stale_ignored"] += 1
                self._m_stale.inc()
                return {"ok": True, "applied": cur}
            self.stats_counters["resync_requests"] += 1
            self._m_resync.inc()
            return {"ok": False, "resync": True, "applied": cur}
        view.apply_state(node_id, {k: v for k, v in (state or {}).items()
                                   if k in STATE_KEYS})
        self.versions[node_id] = version
        self.stats_counters["applied_deltas"] += 1
        self._m_deltas.inc()
        self._mark_dirty(node_id)
        self._retain_train(state)
        return {"ok": True, "applied": version}

    def _retain_train(self, state: Optional[Dict[str, Any]]) -> None:
        """Fold a node's train gauges into the GCS's retained run view as
        they arrive: the daemon sweeps a finished run's gauges after
        `train_obs_gauge_ttl_s`, and a run no reader asked about before
        then would otherwise never be retained."""
        runs = getattr(self._gcs, "train_runs", None)
        if runs is not None and state and state.get("train"):
            runs.refresh()

    async def stream_cluster_view(self, node_id: str = ""):
        """Server-streaming fan-out: a full snapshot on subscribe, then
        coalesced deltas as nodes change. A subscriber that falls behind
        (queue full) is healed with a fresh full snapshot instead of an
        unbounded backlog."""
        q: asyncio.Queue = asyncio.Queue(maxsize=64)
        self._sub_seq += 1
        sid = self._sub_seq
        self._subs[sid] = q
        self._m_subs.set(len(self._subs))
        try:
            yield self._full_payload()
            while True:
                yield await q.get()
        finally:
            self._subs.pop(sid, None)
            self._m_subs.set(len(self._subs))

    def stats(self) -> dict:
        """Counters for tests/benches — the delta-vs-full ratio here is
        the proof the control plane ships deltas, not full-state posts."""
        return {
            "cluster_version": self.cluster_version,
            "nodes_tracked": len(self.versions),
            "subscribers": len(self._subs),
            **self.stats_counters,
        }

    # -- NodeInfo integration -------------------------------------------
    def on_node_registered(self, node_id: str) -> None:
        """Fresh (re-)registration: the node must full-sync before deltas
        apply, and the fan-out must announce it."""
        self.versions.pop(node_id, None)
        self._mark_dirty(node_id)

    def on_node_heartbeat(self, node_id: str) -> None:
        """A legacy/fallback heartbeat applied state through NodeInfo
        directly; mark the node so the fan-out stays coherent."""
        self._mark_dirty(node_id)

    def on_node_dead(self, node_id: str) -> None:
        self.versions.pop(node_id, None)
        self._dead_dirty.add(node_id)
        self.cluster_version += 1
        self._wake.set()

    def _mark_dirty(self, node_id: str) -> None:
        self._dirty.add(node_id)
        self.stats_counters["dirty_marks"] += 1
        self.cluster_version += 1
        self._wake.set()

    # -- fan-out --------------------------------------------------------
    def _full_payload(self) -> dict:
        return {
            "cluster_version": self.cluster_version,
            "full": True,
            "nodes": {nid: node_wire(n)
                      for nid, n in self._gcs.nodes.view.nodes.items()},
            "dead": [],
        }

    def _delta_payload(self) -> Optional[dict]:
        dirty, self._dirty = self._dirty, set()
        dead, self._dead_dirty = self._dead_dirty, set()
        view = self._gcs.nodes.view
        nodes = {nid: node_wire(view.nodes[nid])
                 for nid in dirty if nid in view.nodes}
        if not nodes and not dead:
            return None
        return {"cluster_version": self.cluster_version, "full": False,
                "nodes": nodes, "dead": sorted(dead)}

    async def broadcast_loop(self) -> None:
        interval = get_config().syncer_broadcast_interval_ms / 1000.0
        while True:
            await self._wake.wait()
            # Coalescing window: everything that lands while we sleep
            # rides the same payload.
            await asyncio.sleep(interval)
            self._wake.clear()
            payload = self._delta_payload()
            if payload is None:
                continue
            self.stats_counters["broadcasts"] += 1
            self.stats_counters["broadcast_payload_nodes"] += len(
                payload["nodes"])
            self._m_broadcasts.inc()
            for q in list(self._subs.values()):
                try:
                    q.put_nowait(payload)
                except asyncio.QueueFull:
                    # Slow subscriber: drop its backlog, queue one full
                    # snapshot that supersedes everything it missed.
                    while not q.empty():
                        try:
                            q.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                    try:
                        q.put_nowait(self._full_payload())
                    except asyncio.QueueFull:
                        pass


def collect_queued_demand(lease_waiters, infeasible_waits) -> List[dict]:
    """Shared shape for the queued-demand report (heartbeat fallback and
    syncer state use the same aggregation)."""
    queued = [dict(d) for (d, *_rest) in lease_waiters]
    queued.extend(dict(d) for d in infeasible_waits.values())
    return queued
