"""Node daemon: the per-host raylet equivalent.

The port's copy of `ray_tpu/core/distributed/node_daemon.py`,
importing `ray_tpu_torch` only.

Analogue of the reference raylet (ref: src/ray/raylet/node_manager.h:125 —
worker lease protocol, local scheduling, worker pool worker_pool.h:156,
dependency mgmt, PG resource reservation placement_group_resource_manager.h;
object transfer object_manager.h:117). One process per host:

  * registers with the GCS, heartbeats available resources
  * owns the host's shm object store directory and serves chunked pulls
  * spawns/pools worker processes; grants leases against local resources
  * spills tasks to other nodes via the hybrid policy when overloaded
  * reserves/returns placement-group bundles
  * starts dedicated actor workers on GCS request; reports worker deaths
"""
from __future__ import annotations

import asyncio
import logging
import os
import random
import struct
import subprocess
import sys
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import ObjectExistsError, ObjectStore
from ray_tpu_torch.core.distributed import resources as rs
from ray_tpu_torch.core.distributed.accelerators import (
    ChipAllocator, visible_chip_env)
from ray_tpu_torch.core.distributed.rpc import AsyncRpcClient, RpcServer
from ray_tpu_torch.core.distributed.transfer import (
    ChunkSink, chunk_ranges, make_transfer_metrics, plan_broadcast_tree)
from ray_tpu_torch.core.distributed.wire import Raw
from ray_tpu_torch.core.distributed.scheduler import (
    ClusterView, NodeView, pick_feasible_node, pick_node)
from ray_tpu_torch.core.distributed.syncer import (
    NodeSyncer, collect_queued_demand)
from ray_tpu_torch.core.distributed.worker_zygote import (
    ZygoteBooting, ZygoteError, ZygoteHandle, start_zygote)

logger = logging.getLogger(__name__)

# A zygote that has not listened this long after its launch is wedged in
# its preload: replace it rather than cold-spawn past it forever.
ZYGOTE_BOOT_LIMIT_S = 120.0
# How long stop() waits for SIGTERMed tpu_profiling workers to write their
# traces before it SIGKILLs them (inside the driver's 3 s wait for a daemon).
TRACE_EXPORT_GRACE_S = 2.5


class WorkerHandle:
    def __init__(self, proc: subprocess.Popen, worker_id: str,
                 env_key: str = "", gpu_ids: Tuple[int, ...] = ()):
        self.proc = proc
        self.worker_id = worker_id
        self.address: Optional[str] = None      # set on register
        self.busy = False
        self.actor_id: Optional[str] = None
        self.job_id: Optional[str] = None       # last lease's job (logs)
        self.env_key = env_key        # runtime-env identity of this worker
        # The card ids its CUDA_VISIBLE_DEVICES was started with (none:
        # the node's own view, for leases without GPUs). Fixed for the
        # process's life: CUDA reads the variable once, so the pool is
        # keyed by them.
        self.gpu_ids = tuple(gpu_ids)
        # (runtime, container_name) for containerized workers: the Popen
        # is only the podman/docker CLIENT — killing it leaves the
        # container running, so teardown must kill by name.
        self.container: Optional[Tuple[str, str]] = None
        self.last_idle = time.monotonic()
        self.registered = asyncio.Event()
        self.traced = False     # runs the tpu_profiling trace hook

    def kill(self, term: bool = False) -> None:
        """Stop this worker INCLUDING its container, if any."""
        if self.container is not None:
            runtime, name = self.container
            try:
                subprocess.run([runtime, "kill", name],
                               capture_output=True, timeout=20)
            except Exception:  # noqa: BLE001 best effort
                pass
        try:
            (self.proc.terminate if term else self.proc.kill)()
        except Exception:  # noqa: BLE001
            pass


class Lease:
    def __init__(self, lease_id: str, demand: rs.ResourceSet,
                 worker: WorkerHandle,
                 placement: Optional[Tuple[str, int]],
                 gpu_ids: Tuple[int, ...] = ()):
        self.lease_id = lease_id
        self.demand = demand
        self.worker = worker
        self.placement = placement
        # The cards this lease holds and its GPU count: kept while a
        # pinned lease gives its demand back, so no id is granted twice.
        self.gpu_ids = gpu_ids
        self.gpu_quantity = demand.get("GPU", 0.0)
        self.granted_at = time.monotonic()


class HangWatchdog:
    """Flags RUNNING attempts that exceeded the hang threshold with no
    progress, auto-capturing ONE rate-limited stack dump per attempt
    (ref: the reference's `ray stack`-driven
    hang triage, done by hand — here the daemon does the first capture
    automatically). Pure policy: the daemon supplies `dump` (async,
    info -> raw text or None) and `record` (info, text -> None), so
    tests can drive `scan` with synthetic observations."""

    MAX_TRACKED = 4096

    def __init__(self, *, dump, record,
                 threshold_s: Optional[float] = None,
                 min_dump_interval_s: Optional[float] = None):
        self._dump = dump
        self._record = record
        self._threshold_s = threshold_s
        self._min_interval_s = min_dump_interval_s
        # (task_id, attempt) -> dump wall time; one capture per attempt,
        # surviving the attempt's disappearance (a retried attempt gets
        # a NEW attempt number and its own budget).
        self._dumped: Dict[Tuple[str, int], float] = {}
        self._last_dump = 0.0
        self.fired_total = 0

    def _cfg(self) -> Tuple[float, float]:
        cfg = get_config()
        return (self._threshold_s if self._threshold_s is not None
                else cfg.hang_threshold_s,
                self._min_interval_s if self._min_interval_s is not None
                else cfg.hang_dump_min_interval_s)

    async def scan(self, running: List[dict],
                   now: Optional[float] = None) -> int:
        """One pass over the currently running attempts; returns how
        many hung attempts were dumped this pass. An attempt that
        completes under the threshold is simply never seen old enough —
        it can never be flagged."""
        threshold, min_interval = self._cfg()
        if threshold <= 0:
            return 0
        now = time.time() if now is None else now
        fired = 0
        for info in running:
            key = (info.get("task_id"), int(info.get("attempt", 0)))
            st = info.get("start_ts")
            age = 0.0 if st is None else now - float(st)
            if age < threshold or key in self._dumped:
                continue
            if now - self._last_dump < min_interval:
                # Global rate limit: a mass hang must not become a
                # signal storm; the attempt stays eligible next scan.
                continue
            self._last_dump = now
            self._dumped[key] = now
            while len(self._dumped) > self.MAX_TRACKED:
                del self._dumped[next(iter(self._dumped))]
            try:
                raw = await self._dump(info)
            except Exception as e:  # noqa: BLE001 dump is best-effort
                logger.debug("watchdog dump failed: %s", e)
                raw = None
            try:
                self._record(dict(info), raw)
            except Exception:  # noqa: BLE001
                logger.exception("watchdog record failed")
            fired += 1
            self.fired_total += 1
        return fired


def _alive_now(proc) -> bool:
    """Whether a worker process is alive, confirmed through /proc for a
    forked worker (`ForkedProc.poll_now`), for the grant and pool paths."""
    return getattr(proc, "poll_now", proc.poll)() is None


class NodeDaemon:
    def __init__(
        self,
        *,
        gcs_address: str,
        host: str = "127.0.0.1",
        port: int = 0,
        node_id: Optional[str] = None,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        custom_resources: Optional[Dict[str, float]] = None,
        store_dir: Optional[str] = None,
        object_store_memory: int = 0,
        labels: Optional[Dict[str, str]] = None,
    ):
        self.gcs_address = gcs_address
        self.node_id = node_id or uuid.uuid4().hex
        self.server = RpcServer(host, port)
        # Filled by start(), which runs the GPU probe while the zygote boots.
        self._resource_args = (num_cpus, num_gpus, custom_resources)
        self.total: Dict[str, float] = {}
        self.available: Dict[str, float] = {}
        self._gpus = ChipAllocator(0)    # sized with the resources
        self.labels = labels or {}
        # Auto-label with this host's GPU worker id so host gangs
        # (gpu_host_placement_group bundle ordering) can prefer it.
        if "GPU_WORKER_ID" not in self.labels:
            from ray_tpu_torch.core.distributed.accelerators import get_worker_id

            wid = get_worker_id()
            if wid is not None:
                self.labels["GPU_WORKER_ID"] = str(wid)
        self.store_dir = store_dir or f"/dev/shm/raytpu_{self.node_id[:12]}"
        self.store = ObjectStore(self.store_dir,
                                 capacity=object_store_memory or 0)
        # Worker stdout/stderr files live OUTSIDE shm (logs are disk data,
        # ref: session_latest/logs layout, node.py get_logs_dir_path).
        # node_log_dir is the shared helper: workers derive the SAME path
        # from their node_id, so the per-pid stack-dump files rendezvous
        # here without extra spawn plumbing.
        from ray_tpu_torch.util.profiling import node_log_dir

        self.log_dir = node_log_dir(self.node_id)
        os.makedirs(self.log_dir, exist_ok=True)
        self.gcs: Optional[AsyncRpcClient] = None

        self._workers: Dict[str, WorkerHandle] = {}     # worker_id -> handle
        self._idle: deque = deque()                      # idle task workers
        self._leases: Dict[str, Lease] = {}
        self._pg_bundles: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self._lease_waiters: deque = deque()             # asyncio futures
        self._infeasible_waits: Dict[int, rs.ResourceSet] = {}
        self._infeasible_seq = 0
        # Push manager state (ref: push_manager.h:30 — dedup + bounded
        # concurrent pushes; receiving side fills the store directly).
        self._push_inflight: Dict[Tuple[str, bytes], asyncio.Future] = {}
        self._push_sem = asyncio.Semaphore(4)
        # In-flight receives: object_id -> ChunkSink writing straight
        # into the store's mmap (create-then-fill). Chunks may land in
        # any order; the sink seals itself at full coverage, and
        # get_object_chunk can RE-SERVE landed ranges before seal (the
        # broadcast relay pipeline).
        self._recv_partials: Dict[bytes, ChunkSink] = {}
        # Pooled clients to peer daemons (push/relay/broadcast): one
        # multiplexed connection per peer instead of a dial per chunk.
        self._peer_clients: Dict[str, AsyncRpcClient] = {}
        self._view = ClusterView()
        # Versioned delta reporter + cluster-view receiver (syncer.py);
        # None when RAY_TPU_SYNCER_ENABLED=0 (legacy full-state
        # heartbeats + 1 Hz list_nodes polling).
        self.syncer: Optional[NodeSyncer] = None
        self._tasks: List[asyncio.Task] = []
        self._soft_limit = 1  # set with the resources in start()
        self._env_builder = None  # RuntimeEnvBuilder, lazy (needs gcs)
        # Worker zygotes, one per runtime-env key (insertion order = LRU;
        # ref: worker_pool.h:347 prestart + forkserver-style templates).
        # NOT in self._workers: the OOM sweep and idle reaping never see
        # them — killing the template would re-cold-start the node.
        self._zygotes: Dict[str, ZygoteHandle] = {}
        # Cross-host channel rings this daemon hosts or pushes into:
        # path -> {"ch": Channel, "lock": threading.Lock}. The lock
        # serializes channel_push executor threads per ring, which also
        # makes the versioned-write dedupe check sound.
        self._channels: Dict[str, dict] = {}
        # Serve replica gauges: (app, replica) -> {"ts", "gauges"}.
        # Replicas on this node push queue depth / KV-pool occupancy
        # here; the aggregate rides the SYNCER delta to the GCS so the
        # serve controller reads one merged view instead of polling
        # every replica per autoscale decision.
        self._serve_gauges: Dict[tuple, dict] = {}
        # Train-rank gauges: (run, rank) -> {"ts", "gauges"}. Training
        # ranks on this node push cumulative step/phase counters here
        # (train/observability.py GaugePusher); the per-run map rides
        # the syncer delta to the GCS TrainRunState. TTL-swept — but
        # the GCS retains what it saw, so a SIGSTOPped rank stays
        # attributable after it ages out here.
        self._train_gauges: Dict[tuple, dict] = {}
        # Worker-process metric registry dumps: origin -> {"ts", "dump"}.
        # Replicas piggyback theirs on the gauge push, other serve
        # workers (HTTP proxy) use report_metrics; _metrics_dump merges
        # them into the federation payload so worker-side serve series
        # (TTFT/ITL histograms, KV counters) reach the GCS exposition.
        self._worker_metric_dumps: Dict[str, dict] = {}
        self._init_metrics()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start(self) -> int:
        from ray_tpu_torch.core.distributed.rpc import set_caller_identity

        self.server.add_service("NodeDaemon", self)
        port = await self.server.start()
        if get_config().zygote_enabled:
            # Eager default-env zygote: its interpreter boot and preload
            # (torch's import) overlap the GPU probe below and daemon idle
            # time, so the first lease already forks.
            self._ensure_zygote("", None)
        # GPUs and the card's model come from the time-boxed probe
        # subprocess (resources.py): this process never initialises CUDA,
        # so the zygote it launches can fork workers that use the cards.
        num_cpus, num_gpus, custom = self._resource_args
        self.total = await asyncio.get_running_loop().run_in_executor(
            None, lambda: rs.detect_node_resources(num_cpus, num_gpus,
                                                   custom=custom))
        self.available = dict(self.total)
        self._gpus = ChipAllocator(int(self.total.get("GPU", 0)))
        self._soft_limit = int(get_config().num_workers_soft_limit
                               or self.total.get("CPU", 1))
        # GCS load attribution: the daemon's default identity is its
        # scheduling plane (leases, heartbeats, object directory);
        # subsystems acting as a different component (syncer pushes,
        # task-event flushes) pass an explicit per-call `_caller`.
        set_caller_identity(self.node_id, "scheduler")
        self.gcs = AsyncRpcClient(self.gcs_address)
        await self.gcs.call(
            "NodeInfo", "register_node", node_id=self.node_id,
            address=self.server.address, resources=self.total,
            store_dir=self.store_dir, labels=self.labels, timeout=30)
        from ray_tpu_torch.core.distributed.log_monitor import LogMonitor

        self._dead_worker_info: Dict[str, dict] = {}

        def worker_info(worker_id: str) -> dict:
            h = self._workers.get(worker_id)
            if h is None:
                return self._dead_worker_info.get(worker_id, {})
            return {"actor_id": h.actor_id, "job_id": h.job_id,
                    "pid": h.proc.pid}

        self._log_monitor = LogMonitor(self.log_dir, self.node_id,
                                       worker_info)
        if get_config().syncer_enabled:
            self.syncer = NodeSyncer(
                gcs=self.gcs, node_id=self.node_id,
                collect=self._syncer_state,
                on_reregister=self._re_register,
                # Metrics federation: this node's whole registry
                # piggybacks on the sync channel at a slow cadence; the
                # GCS merges all nodes' snapshots into one node-labelled
                # /metrics exposition.
                metrics_provider=self._metrics_dump,
                metrics={
                    "deltas": self._m_sync_deltas,
                    "suppressed": self._m_sync_suppressed,
                    "bytes": self._m_sync_bytes,
                    "full_syncs": self._m_sync_full,
                    "keepalives": self._m_sync_keepalives,
                })
        # Daemon-side task-event buffer: the hung-task watchdog's
        # auto-captured dumps ride the SAME bounded ring/drop accounting
        # as executor records (task_events.py).
        from ray_tpu_torch.core.distributed.task_events import TaskEventBuffer

        self.task_events = TaskEventBuffer(
            flush_fn=self._flush_task_events, node_id=self.node_id,
            pid=os.getpid())
        self._watchdog = HangWatchdog(
            dump=self._watchdog_dump, record=self._watchdog_record)
        self._tasks = [
            asyncio.ensure_future(self._heartbeat_loop()),
            asyncio.ensure_future(self._monitor_workers_loop()),
            asyncio.ensure_future(self._refresh_view_loop()),
            asyncio.ensure_future(self._memory_monitor_loop()),
            asyncio.ensure_future(self._log_monitor.run(self.gcs)),
            asyncio.ensure_future(self.task_events.flush_loop()),
            asyncio.ensure_future(self._hang_watchdog_loop()),
        ]
        if self.syncer is not None:
            self._tasks += [
                asyncio.ensure_future(self.syncer.report_loop()),
                asyncio.ensure_future(
                    self.syncer.subscribe_loop(self._view)),
            ]
        self._start_metrics_http()
        logger.info("node daemon %s on %s (resources=%s store=%s)",
                    self.node_id[:8], self.server.address, self.total,
                    self.store_dir)
        return port

    async def stop(self):
        srv = getattr(self, "_metrics_http", None)
        if srv is not None:
            srv.shutdown()
        for t in self._tasks:
            t.cancel()
        tracing = []
        for w in list(self._workers.values()):
            try:
                # A traced worker writes its trace on SIGTERM (worker_main);
                # SIGKILL would lose it. The driver waits 3 s for a daemon.
                w.kill(term=w.traced)
                if w.traced:
                    tracing.append(w)
            except Exception:  # noqa: BLE001
                pass
        deadline = time.monotonic() + TRACE_EXPORT_GRACE_S
        while tracing and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
            tracing = [w for w in tracing if w.proc.poll() is None]
        for w in tracing:
            w.kill()
        for zh in list(self._zygotes.values()):
            zh.kill()
        self._zygotes.clear()
        for ent in list(self._channels.values()):
            try:
                ent["ch"].close()
                ent["ch"].unlink()
            except Exception:  # noqa: BLE001
                pass
        self._channels.clear()
        for sink in list(self._recv_partials.values()):
            try:
                sink.abort()
            except Exception:  # noqa: BLE001
                pass
        self._recv_partials.clear()
        for client in list(self._peer_clients.values()):
            try:
                await client.close()
            except Exception:  # noqa: BLE001
                pass
        self._peer_clients.clear()
        await self.server.stop()
        self.store.disconnect()
        ObjectStore.destroy(self.store_dir)

    def _syncer_state(self) -> Dict[str, Any]:
        """Local versioned view the syncer diffs + ships: resources,
        queued load, object-store stats, worker-pool depth (ref: the
        raylet's RESOURCE_VIEW sync message, ray_syncer.proto:62)."""
        busy = sum(1 for h in self._workers.values() if h.busy)
        return {
            "available": dict(self.available),
            "queued": collect_queued_demand(self._lease_waiters,
                                            self._infeasible_waits),
            "store_used": self.store.used,
            "store_objects": self.store.num_objects,
            "spilled_bytes": self.store.spilled_bytes,
            "workers": len(self._workers),
            "idle_workers": len(self._idle),
            "busy_workers": busy,
            "serve": self._serve_state(),
            "train": self._train_state(),
        }

    def _serve_state(self) -> Dict[str, Any]:
        """Per-app aggregate of this node's replica gauges (TTL-swept so
        a dead replica's numbers stop counting).  Values are rounded so
        tiny float jitter doesn't defeat the syncer's delta suppression."""
        ttl = get_config().serve_gauge_ttl_s
        now = time.monotonic()
        apps: Dict[str, Dict[str, float]] = {}
        for key, ent in list(self._serve_gauges.items()):
            if now - ent["ts"] > ttl:
                del self._serve_gauges[key]
                # Drop the dead replica's mirrored gauge rows too —
                # a stale exposition row is worse than a missing one.
                mirror = getattr(self, "_m_serve_gauge", None)
                for name in ent["gauges"]:
                    if mirror is not None:
                        mirror.remove({"app": key[0], "replica": key[1],
                                       "gauge": name})
                continue
            app = key[0]
            agg = apps.setdefault(app, {"replicas": 0.0})
            agg["replicas"] += 1
            for name, val in ent["gauges"].items():
                try:
                    agg[name] = round(agg.get(name, 0.0) + float(val), 3)
                except (TypeError, ValueError):
                    continue
            # Per-replica disagg state (role, published prefix digests)
            # rides the same TTL sweep: a SIGKILLed replica's registry
            # entries stop routing within serve_gauge_ttl_s.
            if ent.get("state"):
                agg.setdefault("_replicas", {})[key[1]] = ent["state"]
        return apps

    async def report_serve_gauges(self, app: str, replica: str,
                                  gauges: Dict[str, float],
                                  metrics: Optional[list] = None,
                                  state: Optional[dict] = None) -> dict:
        """Replica -> local daemon gauge push (the serve-autoscaling
        leg of the syncer plane; replicas never talk to the GCS).

        Each gauge is also mirrored into this daemon's own registry as
        raytpu_serve_replica_gauge{app,replica,gauge} so the engine
        gauges appear verbatim in the federated exposition, and the
        optional `metrics` registry dump piggybacks into
        _metrics_dump's merge (histograms/counters the replica process
        records).  `state` carries non-additive per-replica facts —
        disagg role and published prefix digests — surfaced under the
        app's `_replicas` submap instead of the float aggregation."""
        self._serve_gauges[(app, replica)] = {
            "ts": time.monotonic(), "gauges": dict(gauges),
            "state": dict(state) if state else None}
        for name, val in gauges.items():
            try:
                self._m_serve_gauge.set(float(val), {
                    "app": app, "replica": replica, "gauge": name})
            except (TypeError, ValueError):
                continue
        if metrics is not None:
            self._worker_metric_dumps[f"replica:{replica}"] = {
                "ts": time.monotonic(), "dump": metrics}
        if self.syncer is not None:
            self.syncer.mark_dirty()
        return {"ok": True}

    async def report_metrics(self, origin: str, dump: list) -> dict:
        """Generic worker -> local daemon metrics push (serve HTTP
        proxy and friends): the dump is merged into this node's
        federation payload under the node's label, TTL-swept so a dead
        worker's series age out."""
        self._worker_metric_dumps[str(origin)] = {
            "ts": time.monotonic(), "dump": dump}
        return {"ok": True}

    def _train_state(self) -> Dict[str, Any]:
        """Per-run map of this node's training-rank gauges, keyed
        run -> "rank@attempt" (ranks are NOT summed — the GCS skew
        computation needs each rank's step window separately). TTL-swept
        so a finished run's counters stop shipping; the push timestamp
        rides along as `ts_age_s` so the GCS can spot a rank that went
        quiet (SIGSTOP) before the TTL reaps it."""
        ttl = get_config().train_obs_gauge_ttl_s
        now = time.monotonic()
        runs: Dict[str, Dict[str, dict]] = {}
        for key, ent in list(self._train_gauges.items()):
            age = now - ent["ts"]
            if age > ttl:
                del self._train_gauges[key]
                continue
            run, rank = key
            g = dict(ent["gauges"])
            g["ts_age_s"] = round(age, 1)
            runs.setdefault(run, {})[f"{rank}@{g.get('attempt', 0)}"] = g
        return runs

    async def report_train_gauges(self, run: str, rank: int,
                                  gauges: Dict[str, Any],
                                  metrics: Optional[list] = None) -> dict:
        """Training rank -> local daemon gauge push (the train-plane
        leg of the syncer federation; ranks never talk to the GCS).
        The optional `metrics` registry dump piggybacks the rank's
        raytpu_train_* histograms into the node's federation payload,
        same as serve replicas."""
        self._train_gauges[(run, int(rank))] = {
            "ts": time.monotonic(), "gauges": dict(gauges)}
        if metrics is not None:
            self._worker_metric_dumps[f"train:{run}:{rank}"] = {
                "ts": time.monotonic(), "dump": metrics}
        if self.syncer is not None:
            self.syncer.mark_dirty()
        return {"ok": True}

    async def _re_register(self) -> None:
        """(Re-)register this node and force the syncer to full-resync —
        the GCS forgot us (restart) or marked us dead (stale verdict)."""
        await self.gcs.call(
            "NodeInfo", "register_node", node_id=self.node_id,
            address=self.server.address, resources=self.total,
            store_dir=self.store_dir, labels=self.labels, timeout=10)
        if self.syncer is not None:
            self.syncer.force_full_resync()
            self.syncer.mark_dirty()

    async def _heartbeat_loop(self):
        cfg = get_config()
        base = cfg.health_check_period_ms / 1000 / 2
        cap = max(base, cfg.heartbeat_backoff_cap_s)
        backoff = base
        while True:
            try:
                # Queued demand feeds the autoscaler (ref: the raylet's
                # resource-load report through the syncer): leases waiting
                # on busy local resources plus infeasible-here demands
                # still waiting for a capable node to join the cluster.
                queued = collect_queued_demand(self._lease_waiters,
                                               self._infeasible_waits)
                reply = await self.gcs.call(
                    "NodeInfo", "heartbeat", node_id=self.node_id,
                    available=dict(self.available),
                    queued_demand=queued, timeout=10)
                if not reply.get("registered"):
                    if reply.get("stale"):
                        logger.warning(
                            "GCS verdict: stale node (%s); re-registering "
                            "as a fresh incarnation",
                            reply.get("reason", ""))
                    await self._re_register()
                backoff = base
            except Exception as e:  # noqa: BLE001
                # Capped exponential backoff — a down GCS must not be
                # hammered at full cadence, and the failure must be
                # visible (counter + warning, not a swallowed debug).
                self._m_heartbeat_failures.inc()
                logger.warning("heartbeat failed: %s (retry in %.1fs)",
                               e, backoff)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, cap)
                continue
            period = base
            if self.syncer is not None and self.syncer.healthy():
                # Liveness rides the sync stream (pushes + keepalives);
                # this loop degrades to a slow safety-net probe.
                period = base * max(
                    1.0, cfg.syncer_heartbeat_fallback_factor)
            await asyncio.sleep(period)

    async def _refresh_view_once(self) -> None:
        nodes = await self.gcs.call("NodeInfo", "list_nodes", timeout=10)
        fresh = {}
        for n in nodes:
            fresh[n["node_id"]] = NodeView(
                node_id=n["node_id"], address=n["address"],
                total=n["total"], available=n["available"],
                alive=n["alive"], store_dir=n["store_dir"])
        # Mutate in place: the syncer's subscribe loop folds broadcasts
        # into this same ClusterView object.
        self._view.nodes = fresh

    async def _refresh_view_loop(self):
        while True:
            if self.syncer is not None and self.syncer.view_fresh():
                # The spillback view is being fed by the GCS fan-out
                # stream; polling the full node table would be O(nodes)
                # redundant bytes per tick.
                await asyncio.sleep(1.0)
                continue
            try:
                await self._refresh_view_once()
            except Exception:  # noqa: BLE001
                pass
            await asyncio.sleep(1.0)

    # ------------------------------------------------------------------
    # worker pool (ref: worker_pool.h:156)
    # ------------------------------------------------------------------
    async def _built_env(self, runtime_env: Optional[dict]):
        """Build (or fetch cached) node-local runtime env artifacts."""
        if not runtime_env:
            return None
        if self._env_builder is None:
            from ray_tpu_torch.core.distributed.runtime_env_agent import (
                RuntimeEnvBuilder, node_env_dir)

            self._env_builder = RuntimeEnvBuilder(
                self.gcs, node_env_dir(self.node_id))
        return await self._env_builder.ensure_env(runtime_env)

    # -- zygote fork path (ref: worker_pool.h:347 PrestartWorkers;
    # worker_zygote.py docstring for the fork-safety contract) ---------
    def _zygote_compatible(self, built_env) -> bool:
        """Fork is only equivalent to a cold spawn when the child would
        run THIS platform's python in this mount namespace."""
        if not get_config().zygote_enabled:
            return False
        if not sys.platform.startswith("linux"):
            return False  # fork+threads semantics unsafe elsewhere
        if built_env is None:
            return True
        if built_env.container:
            return False  # worker lives in another mount/pid namespace
        if built_env.python != sys.executable:
            return False  # conda/venv env: different interpreter binary
        return True

    def _visible_env(self, gpu_ids) -> Dict[str, str]:
        """The env that scopes a worker to a lease's card ids (none for no
        ids): ids index the cards this node sees, which are the host's own
        unless the daemon itself was started scoped."""
        if not gpu_ids:
            return {}
        node_cards = [c for c in os.environ.get(
            "CUDA_VISIBLE_DEVICES", "").split(",") if c.strip()]
        if len(node_cards) >= len(self._gpus.free):
            return visible_chip_env([node_cards[i] for i in gpu_ids])
        return visible_chip_env(list(gpu_ids))

    def _acquire_gpus(self, demand, env_key: str):
        """Card ids for a lease's GPU demand, preferring a set an idle
        worker of this env already sees (so it can be reused), or None
        when no set of cards fits."""
        if demand.get("GPU", 0.0) <= rs.EPS:
            return ()
        prefer = [h.gpu_ids for h in self._idle
                  if h.env_key == env_key and h.gpu_ids]
        return self._gpus.acquire(demand["GPU"], prefer)

    def _zygote_socket_path(self, env_key: str) -> str:
        return os.path.join(self.log_dir,
                            f"zygote-{env_key or 'default'}.sock")

    def _ensure_zygote(self, env_key: str,
                       built_env) -> Optional[ZygoteHandle]:
        """Running zygote for this runtime-env key, launching (or
        relaunching after a crash) as needed. Non-blocking: the returned
        handle's socket may still be booting."""
        zh = self._zygotes.pop(env_key, None)
        if zh is not None and zh.alive():
            self._zygotes[env_key] = zh     # re-insert: LRU freshest
            return zh
        if zh is not None:
            logger.warning("zygote for env %r died (code %s); relaunching",
                           env_key or "default", zh.proc.returncode)
            zh.kill()
            self._m_zygote_restarts.inc()
        while len(self._zygotes) >= max(1, get_config().zygote_max):
            old_key, old = next(iter(self._zygotes.items()))
            self._zygotes.pop(old_key)
            old.kill()
        env = {}
        cwd = None
        if built_env is not None:
            env.update(built_env.env_vars)
            if built_env.pythonpath:
                from ray_tpu_torch.core.distributed.driver import child_env

                base = child_env().get("PYTHONPATH", "")
                env["PYTHONPATH"] = ":".join(
                    built_env.pythonpath
                    + [p for p in base.split(":") if p])
            cwd = built_env.cwd
        try:
            proc = start_zygote(
                gcs_address=self.gcs_address,
                daemon_address=self.server.address,
                node_id=self.node_id,
                store_dir=self.store_dir,
                socket_path=self._zygote_socket_path(env_key),
                log_path=os.path.join(
                    self.log_dir, f"zygote-{env_key or 'default'}.log"),
                env=env, cwd=cwd,
                preload=get_config().zygote_preload)
        except Exception as e:  # noqa: BLE001
            logger.warning("zygote launch failed: %s", e)
            return None
        zh = ZygoteHandle(proc, self._zygote_socket_path(env_key),
                          env_key=env_key)
        self._zygotes[env_key] = zh
        return zh

    async def _await_zygote(self, env_key: str, built_env) -> None:
        """Give a booting zygote up to `zygote_boot_wait_s` to listen
        before a spawn, polling without blocking the loop. A zygote still
        booting after that is kept: this spawn cold-starts meanwhile."""
        if not self._zygote_compatible(built_env):
            return
        zh = self._ensure_zygote(env_key, built_env)
        deadline = time.monotonic() + get_config().zygote_boot_wait_s
        while zh is not None and time.monotonic() < deadline:
            try:
                if zh.try_connect():
                    return
            except ZygoteError:
                return  # exited: _try_fork_worker replaces it
            await asyncio.sleep(0.02)

    def _try_fork_worker(self, actor_id: Optional[str], built_env,
                         env_key: str, gpu_ids=()
                         ) -> Optional[WorkerHandle]:
        zh = self._ensure_zygote(env_key, built_env)
        if zh is None:
            return None
        worker_id = uuid.uuid4().hex
        out = os.path.join(self.log_dir, f"worker-{worker_id}.out")
        err = os.path.join(self.log_dir, f"worker-{worker_id}.err")
        t0 = time.monotonic()
        try:
            # No wait here: this runs on the daemon's loop. Callers that
            # can wait do so first, in _await_zygote.
            # The child sets CUDA_VISIBLE_DEVICES before it imports
            # anything that could touch the driver (the zygote never has).
            proc = zh.fork_worker(worker_id, out, err, boot_wait=0.0,
                                  env=self._visible_env(gpu_ids))
        except ZygoteBooting:
            if time.monotonic() - zh.started_at < ZYGOTE_BOOT_LIMIT_S:
                return None
            logger.warning("zygote for env %r still booting after %.0fs; "
                           "replacing it", env_key or "default",
                           ZYGOTE_BOOT_LIMIT_S)
            self._zygotes.pop(env_key, None)
            zh.kill()
            self._m_zygote_restarts.inc()
            return None
        except ZygoteError as e:
            # One strike: a wedged/crashed zygote is replaced on the
            # next _ensure_zygote; THIS spawn cold-starts.
            logger.warning("zygote fork failed (%s); cold-spawning", e)
            self._zygotes.pop(env_key, None)
            zh.kill()
            self._m_zygote_restarts.inc()
            return None
        self._m_fork_latency.observe(time.monotonic() - t0)
        self._m_forked.inc()
        self._m_spawned.inc()
        handle = WorkerHandle(proc, worker_id, env_key=env_key,
                              gpu_ids=gpu_ids)
        handle.actor_id = actor_id
        self._workers[worker_id] = handle
        return handle

    def _spawn_worker(self, actor_id: Optional[str] = None,
                      built_env=None, env_key: str = "",
                      gpu_ids=()) -> WorkerHandle:
        handle = None
        if self._zygote_compatible(built_env):
            handle = self._try_fork_worker(actor_id, built_env, env_key,
                                           gpu_ids)
        if handle is None:
            handle = self._cold_spawn_worker(actor_id, built_env, env_key,
                                             gpu_ids)
        handle.traced = bool(built_env is not None and built_env.env_vars.get(
            "RAY_TPU_JAX_TRACE_DIR"))
        return handle

    def _cold_spawn_worker(self, actor_id: Optional[str] = None,
                           built_env=None,
                           env_key: str = "",
                           gpu_ids=()) -> WorkerHandle:
        from ray_tpu_torch.core.distributed.driver import child_env

        worker_id = uuid.uuid4().hex
        env = child_env()
        env["RAY_TPU_WORKER_ID"] = worker_id
        env.update(self._visible_env(gpu_ids))
        python = sys.executable
        cwd = None
        if built_env is not None:
            env.update(built_env.env_vars)
            if built_env.pythonpath:
                env["PYTHONPATH"] = ":".join(
                    built_env.pythonpath
                    + [p for p in env.get("PYTHONPATH", "").split(":") if p])
            python = built_env.python
            cwd = built_env.cwd
        cmd = [
            python, "-m", "ray_tpu_torch.core.distributed.worker_main",
            "--gcs-address", self.gcs_address,
            "--daemon-address", self.server.address,
            "--node-id", self.node_id,
            "--store-dir", self.store_dir,
            "--worker-id", worker_id,
        ]
        container_name = None
        if built_env is not None and built_env.container:
            # Container plugin: the worker runs inside podman/docker;
            # env/cwd must ride the run flags, not Popen's env, and the
            # container is named so teardown can kill IT (killing the
            # client process leaves the container running).
            container_name = f"rtpu-worker-{worker_id[:16]}"
            cmd = built_env.wrap_command(cmd, env, name=container_name)
        # Per-worker log files; the LogMonitor tails them to the GCS
        # (ref: worker stdout/stderr files under session logs,
        # node.py:1042 + log_monitor.py tailing).
        out_f = open(os.path.join(self.log_dir,
                                  f"worker-{worker_id}.out"), "ab")
        err_f = open(os.path.join(self.log_dir,
                                  f"worker-{worker_id}.err"), "ab")
        from ray_tpu_torch.core.distributed.driver import pdeathsig_preexec

        try:
            # die_with_parent: a SIGKILL'd daemon must not orphan its
            # workers (they'd keep serving a dead node's address).
            proc = subprocess.Popen(cmd, env=env, cwd=cwd,
                                    stdout=out_f, stderr=err_f,
                                    preexec_fn=pdeathsig_preexec)
        finally:
            out_f.close()
            err_f.close()
        self._m_spawned.inc()
        self._m_cold_spawned.inc()
        handle = WorkerHandle(proc, worker_id, env_key=env_key,
                              gpu_ids=gpu_ids)
        handle.actor_id = actor_id
        if container_name is not None:
            handle.container = (built_env.container[0], container_name)
        self._workers[worker_id] = handle
        return handle

    # ------------------------------------------------------------------
    # metrics (ref: src/ray/stats/metric_defs.cc 43 DEFINE_stats; exported
    # to Prometheus via the per-node metrics agent in the reference)
    # ------------------------------------------------------------------
    def _init_metrics(self) -> None:
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        tags = {"node_id": self.node_id[:12]}
        self._m_serve_gauge = Gauge(
            "raytpu_serve_replica_gauge",
            "Serve replica engine gauges (queue depth, active, KV "
            "occupancy...) mirrored from report_serve_gauges",
            tag_keys=("app", "replica", "gauge")).set_default_tags(tags)
        self._m_leases = Counter(
            "raytpu_leases_granted_total",
            "Worker leases granted by this daemon").set_default_tags(tags)
        self._m_spawned = Counter(
            "raytpu_workers_spawned_total",
            "Worker processes spawned").set_default_tags(tags)
        self._m_workers = Gauge(
            "raytpu_workers", "Live worker processes").set_default_tags(tags)
        self._m_busy = Gauge(
            "raytpu_workers_busy", "Busy workers").set_default_tags(tags)
        self._m_waiters = Gauge(
            "raytpu_lease_waiters",
            "Lease requests queued on resources").set_default_tags(tags)
        self._m_store_used = Gauge(
            "raytpu_object_store_used_bytes",
            "Shm store bytes in use").set_default_tags(tags)
        self._m_store_objects = Gauge(
            "raytpu_object_store_objects",
            "Objects in the shm store").set_default_tags(tags)
        self._m_spilled = Gauge(
            "raytpu_object_store_spilled_bytes",
            "Bytes spilled to disk").set_default_tags(tags)
        self._m_lease_wait = Histogram(
            "raytpu_lease_grant_seconds",
            "Lease request to grant latency",
            boundaries=(0.001, 0.01, 0.1, 1, 10)).set_default_tags(tags)
        self._m_oom_kills = Counter(
            "raytpu_oom_worker_kills_total",
            "Workers killed by the memory monitor").set_default_tags(tags)
        # Zygote / warm-pool subsystem (worker_zygote.py).
        self._m_forked = Counter(
            "raytpu_workers_forked_total",
            "Workers started by zygote fork").set_default_tags(tags)
        self._m_cold_spawned = Counter(
            "raytpu_workers_cold_spawned_total",
            "Workers started by cold process spawn").set_default_tags(tags)
        self._m_fork_latency = Histogram(
            "raytpu_zygote_fork_seconds",
            "Zygote fork request latency",
            boundaries=(0.001, 0.005, 0.02, 0.1, 0.5, 2)
        ).set_default_tags(tags)
        self._m_zygote_restarts = Counter(
            "raytpu_zygote_restarts_total",
            "Zygote relaunches after crash/wedge").set_default_tags(tags)
        self._m_prestarted = Counter(
            "raytpu_workers_prestarted_total",
            "Warm workers prestarted against lease backlog"
        ).set_default_tags(tags)
        self._m_pg_prewarmed = Counter(
            "raytpu_pg_prewarmed_workers_total",
            "Warm workers prestarted on pg bundle commit"
        ).set_default_tags(tags)
        self._m_heartbeat_failures = Counter(
            "raytpu_heartbeat_failures_total",
            "Heartbeat RPCs to the GCS that failed").set_default_tags(tags)
        # Diagnosis plane: signal-safe dumps + hung-task watchdog.
        self._m_stack_dumps = Counter(
            "raytpu_stack_dumps_total",
            "Signal-safe worker stack dumps captured").set_default_tags(
            tags)
        self._m_hung = Counter(
            "raytpu_hung_tasks_total",
            "Task attempts flagged hung by the watchdog"
        ).set_default_tags(tags)
        # Cluster-state syncer (syncer.py): the delta/suppressed/bytes
        # trio is what proves the control plane ships deltas, not
        # full-state posts.
        self._m_sync_deltas = Counter(
            "raytpu_syncer_deltas_sent_total",
            "Versioned state deltas pushed to the GCS"
        ).set_default_tags(tags)
        self._m_sync_suppressed = Counter(
            "raytpu_syncer_deltas_suppressed_total",
            "Report ticks suppressed because nothing changed"
        ).set_default_tags(tags)
        self._m_sync_bytes = Counter(
            "raytpu_syncer_bytes_sent_total",
            "Serialized bytes of state pushed to the GCS"
        ).set_default_tags(tags)
        self._m_sync_full = Counter(
            "raytpu_syncer_full_syncs_sent_total",
            "Full snapshot resyncs pushed (connect/reconnect/gap)"
        ).set_default_tags(tags)
        self._m_sync_keepalives = Counter(
            "raytpu_syncer_keepalives_sent_total",
            "Liveness keepalives piggybacked on the sync channel"
        ).set_default_tags(tags)
        # Object transfer plane (transfer.py): in/out chunk bytes prove
        # where data actually moved — the broadcast acceptance check
        # (owner uplink <= fanout*size, not N*size) reads bytes_out.
        self._m_xfer = make_transfer_metrics(tags)
        self._m_xfer_in = self._m_xfer["bytes_in"]
        self._m_xfer_out = self._m_xfer["bytes_out"]

    def _refresh_gauges(self) -> None:
        # Called from HTTP handler threads too: iterate over snapshots,
        # never live dicts the event loop mutates.
        workers = list(self._workers.values())
        self._m_workers.set(
            sum(1 for h in workers if h.proc.poll() is None))
        self._m_busy.set(sum(1 for h in workers if h.busy))
        self._m_waiters.set(len(self._lease_waiters))
        self._m_store_used.set(self.store.used)
        self._m_store_objects.set(self.store.num_objects)
        self._m_spilled.set(self.store.spilled_bytes)

    def get_metrics(self) -> str:
        """Prometheus exposition text; also served over HTTP when
        RAY_TPU_METRICS_EXPORT_PORT is set (ref: metrics agent scrape
        endpoint, dashboard/modules/metrics)."""
        from ray_tpu_torch.util.metrics import get_registry

        self._refresh_gauges()
        return get_registry().prometheus_text()

    def _metrics_dump(self):
        """Structured registry snapshot for the syncer's federation
        piggyback (gauges refreshed first, like the text exposition),
        merged with the TTL-live worker-process dumps pushed via
        report_serve_gauges / report_metrics — counters and histograms
        with identical labelsets sum (several replicas of one app on a
        node aggregate per app), gauges last-write-win."""
        from ray_tpu_torch.util.metrics import merge_dump_lists, registry_dump

        self._refresh_gauges()
        dumps = [registry_dump()]
        ttl = get_config().serve_gauge_ttl_s
        now = time.monotonic()
        for origin, ent in list(self._worker_metric_dumps.items()):
            if now - ent["ts"] > ttl:
                del self._worker_metric_dumps[origin]
                continue
            dumps.append(ent["dump"])
        if len(dumps) == 1:
            return dumps[0]
        return merge_dump_lists(dumps)

    def _start_metrics_http(self) -> None:
        port = get_config().metrics_export_port
        if not port:
            return
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        daemon = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = daemon.get_metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        try:
            srv = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        except OSError as e:
            logger.warning("metrics HTTP port %d unavailable: %s", port, e)
            return
        self._metrics_http = srv
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        logger.info("metrics exported on :%d/metrics", srv.server_address[1])

    def debug_state(self) -> dict:
        """Scheduler-state snapshot (ref: DebugString dumps the reference
        raylet emits into its logs)."""
        return {
            "total": dict(self.total),
            "available": dict(self.available),
            "leases": len(self._leases),
            "lease_waiters": len(self._lease_waiters),
            "workers": len(self._workers),
            "idle_workers": len(self._idle),
            "busy_workers": sum(1 for h in self._workers.values()
                                if h.busy),
            "pg_bundles": len(self._pg_bundles),
            "gpu_free": list(self._gpus.free),
            "pg_bundles_uncommitted": sum(
                1 for b in self._pg_bundles.values()
                if not b.get("committed", True)),
            "zygotes": sum(1 for z in self._zygotes.values()
                           if z.alive()),
            "syncer": (dict(self.syncer.stats,
                            version=self.syncer.version,
                            view_version=self.syncer.view_version)
                       if self.syncer is not None else None),
        }

    def list_workers(self) -> list:
        return [{"worker_id": h.worker_id, "pid": h.proc.pid,
                 "actor_id": h.actor_id, "busy": h.busy,
                 "address": h.address,
                 "alive": h.proc.poll() is None}
                for h in self._workers.values()]

    def kill_worker(self, worker_id: Optional[str] = None,
                    pid: Optional[int] = None) -> dict:
        """Chaos-harness hook (ref: _private/test_utils.py:1560
        WorkerKillerActor): SIGKILL one of this node's workers."""
        for h in self._workers.values():
            if h.worker_id == worker_id or (pid and h.proc.pid == pid):
                try:
                    h.kill()
                except Exception:  # noqa: BLE001
                    return {"ok": False}
                return {"ok": True, "pid": h.proc.pid}
        return {"ok": False}

    def signal_worker(self, sig: int, worker_id: Optional[str] = None,
                      pid: Optional[int] = None) -> dict:
        """Chaos-harness hook: deliver an arbitrary signal to one of
        this node's workers (SIGSTOP makes a deterministic straggler,
        SIGCONT heals it). Only pids the daemon owns are signalable."""
        for h in self._workers.values():
            if h.worker_id == worker_id or (pid and h.proc.pid == pid):
                try:
                    os.kill(h.proc.pid, int(sig))
                except Exception as e:  # noqa: BLE001
                    return {"ok": False, "error": str(e)}
                return {"ok": True, "pid": h.proc.pid}
        return {"ok": False, "error": "no such worker"}

    def kill_random_worker(self, include_actor_workers: bool = False,
                           seed: Optional[int] = None) -> dict:
        rng = random.Random(seed)
        candidates = [
            h for h in self._workers.values()
            if h.proc.poll() is None
            and (include_actor_workers or h.actor_id is None)
        ]
        if not candidates:
            return {"ok": False, "reason": "no candidate workers"}
        victim = rng.choice(candidates)
        try:
            victim.kill()
        except Exception:  # noqa: BLE001
            return {"ok": False}
        return {"ok": True, "pid": victim.proc.pid,
                "worker_id": victim.worker_id}

    async def register_worker(self, worker_id: str, address: str,
                              pid: int) -> dict:
        handle = self._workers.get(worker_id)
        if handle is None:
            return {"ok": False}
        handle.address = address
        handle.registered.set()
        if handle.actor_id is None and not handle.busy:
            if handle not in self._idle:
                # Idleness starts NOW, not at spawn: last_idle was
                # stamped in the constructor, and a slow-registering
                # worker appended with that stale stamp would sit behind
                # younger idlers, breaking _reap_idle_workers' deque-is-
                # idle-ordered assumption (it stops at the first
                # too-young front entry).
                handle.last_idle = time.monotonic()
                self._idle.append(handle)
            self._pump_lease_queue()
        return {"ok": True}

    def _take_idle_worker(self, env_key: str,
                          gpu_ids=()) -> Optional[WorkerHandle]:
        """Pop a live, registered idle worker of this env that sees exactly
        these cards — or None. A worker never changes the cards it sees
        (CUDA reads the variable once), so the pool is keyed by both.
        Non-matching idlers keep their front-to-back (longest-idle-
        first) order, same discipline as _get_idle_worker."""
        kept = []
        found = None
        gpu_ids = tuple(gpu_ids)
        while self._idle:
            handle = self._idle.popleft()
            if (_alive_now(handle.proc) and handle.address
                    and not handle.busy):
                if handle.env_key == env_key and handle.gpu_ids == gpu_ids:
                    found = handle
                    break
                kept.append(handle)
        self._idle.extendleft(reversed(kept))
        return found

    async def _get_idle_worker(self, runtime_env: Optional[dict] = None,
                               gpu_ids=()) -> WorkerHandle:
        from ray_tpu_torch.runtime_env import env_hash

        env_key = env_hash(runtime_env)
        # Other-env idlers go back to the FRONT in their original order:
        # _reap_idle_workers assumes self._idle[0] is the longest-idle
        # worker, and these were popped from the front.
        found = self._take_idle_worker(env_key, gpu_ids)
        if found is not None:
            return found
        built = await self._built_env(runtime_env)
        await self._await_zygote(env_key, built)
        found = self._take_idle_worker(env_key, gpu_ids)
        if found is not None:
            return found
        # Spawn a fresh one and wait for registration — polling the
        # process too: a worker that dies pre-registration (crash, chaos
        # kill) must fail the grant within ~0.1 s, not pin the subtracted
        # resources for the full registration timeout.
        handle = self._spawn_worker(built_env=built, env_key=env_key,
                                    gpu_ids=gpu_ids)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + get_config().worker_register_timeout_s
        while True:
            try:
                await asyncio.wait_for(handle.registered.wait(), timeout=0.1)
                # register_worker appended the new worker to _idle (it
                # cannot know this grant is waiting for it) — claim it
                # back out, or a busy leased worker sits in the idle
                # deque where the reaper/OOM sweep would kill it as
                # expendable.
                try:
                    self._idle.remove(handle)
                except ValueError:
                    pass
                return handle
            except asyncio.TimeoutError:
                if handle.proc.poll() is not None:
                    self._workers.pop(handle.worker_id, None)
                    raise RuntimeError(
                        "worker died before registering") from None
                if loop.time() >= deadline:
                    handle.kill()
                    self._workers.pop(handle.worker_id, None)
                    raise RuntimeError(
                        "worker failed to register in time") from None

    # ------------------------------------------------------------------
    # backlog-driven prestart (ref: worker_pool.h:347 PrestartWorkers)
    # ------------------------------------------------------------------
    def _maybe_prestart_workers(self) -> None:
        """When default-env lease requests queue up, start warm workers
        ahead of the grants: the spawn (fork, ~ms; cold, ~150ms+)
        overlaps the wait for resources instead of following it."""
        cfg = get_config()
        if not cfg.worker_prestart_enabled:
            return
        backlog = sum(1 for (_d, _p, fut, _t, renv) in self._lease_waiters
                      if not renv and not fut.done())
        if backlog < max(1, cfg.zygote_prestart_watermark):
            return
        # Attribute-only scans — no per-handle poll() syscalls: at warm-
        # pool scale this runs against 1k+ handles on every lease, and a
        # dead-but-uncollected handle only overcounts until the monitor
        # loop prunes it (≤1 s), which just delays prestart one beat.
        idle = len(self._idle)
        starting = sum(1 for h in self._workers.values()
                       if h.address is None and h.actor_id is None)
        cap = int(cfg.zygote_warm_pool_cap or self._soft_limit)
        want = min(backlog, cap) - idle - starting
        if want <= 0:
            return
        for _ in range(want):
            try:
                self._spawn_worker()
            except Exception as e:  # noqa: BLE001
                logger.debug("prestart spawn failed: %s", e)
                return
        self._m_prestarted.inc(want)

    def _maybe_refill_warm_pool(self, env_key: str, built_env) -> None:
        """Keep `actor_schedule_concurrency` warm workers ahead of actor
        demand: called on every start_actor, so a creation storm settles
        into pop-warm-worker + async refill — the fork+boot pipeline
        overlaps the NEXT creations instead of serializing inside each
        (ref: worker_pool.h:347 PrestartWorkers, which the reference
        pops actor workers from)."""
        cfg = get_config()
        if not cfg.worker_prestart_enabled:
            return
        depth = min(max(1, cfg.actor_schedule_concurrency),
                    int(cfg.zygote_warm_pool_cap or self._soft_limit))
        # Attribute-only scans (see _maybe_prestart_workers): this runs
        # on EVERY start_actor against every live handle — per-handle
        # poll() syscalls here were a measurable slice of a 1k-actor
        # creation storm on a small host.
        idle = sum(1 for h in self._idle if h.env_key == env_key)
        starting = sum(1 for h in self._workers.values()
                       if h.address is None and h.actor_id is None
                       and h.env_key == env_key)
        want = depth - idle - starting
        if want <= 0:
            return
        for _ in range(want):
            try:
                self._spawn_worker(built_env=built_env, env_key=env_key)
            except Exception as e:  # noqa: BLE001
                logger.debug("warm refill spawn failed: %s", e)
                return
        self._m_prestarted.inc(want)

    async def prestart_workers(self, count: int = 1,
                               runtime_env: Optional[dict] = None) -> dict:
        """Explicit warm-pool fill RPC (the reference exposes the same
        hook as NodeManager PrestartWorkers): start up to `count`
        workers of the given runtime env, bounded by the warm-pool cap."""
        from ray_tpu_torch.runtime_env import env_hash

        built = await self._built_env(runtime_env)
        env_key = env_hash(runtime_env)
        cap = int(get_config().zygote_warm_pool_cap or self._soft_limit)
        idle = len(self._idle)
        started = 0
        for _ in range(max(0, min(int(count), cap - idle))):
            self._spawn_worker(built_env=built, env_key=env_key)
            started += 1
        if started:
            self._m_prestarted.inc(started)
        return {"ok": True, "started": started}

    def flush_idle_workers(self) -> dict:
        """Kill every idle pooled worker (bench/test hook: forces the
        next lease onto the fork-or-cold start path). Zygotes are
        untouched — they are templates, not pool members."""
        killed = 0
        while self._idle:
            handle = self._idle.popleft()
            if handle.busy:
                continue  # mid-grant claim raced in; not idle
            self._workers.pop(handle.worker_id, None)
            self._retire_worker_logs(handle)
            try:
                handle.kill()
            except Exception:  # noqa: BLE001
                pass
            killed += 1
        return {"ok": True, "killed": killed}

    def zygote_state(self) -> dict:
        """Zygote snapshot (tests/tools)."""
        return {"zygotes": [
            {"env_key": k, "pid": zh.proc.pid, "alive": zh.alive(),
             "forks": zh.forks}
            for k, zh in self._zygotes.items()]}

    # ------------------------------------------------------------------
    # memory monitor + OOM killing (ref: memory_monitor.h:52, LIFO-
    # retriable WorkerKillingPolicy worker_killing_policy.h:64)
    # ------------------------------------------------------------------
    @staticmethod
    def _memory_usage_fraction() -> float:
        try:
            import psutil

            return psutil.virtual_memory().percent / 100.0
        except Exception:  # noqa: BLE001
            try:
                info = {}
                with open("/proc/meminfo") as f:
                    for line in f:
                        k, v = line.split(":", 1)
                        info[k] = int(v.strip().split()[0])
                return 1.0 - info["MemAvailable"] / info["MemTotal"]
            except Exception:  # noqa: BLE001
                return 0.0

    async def _memory_monitor_loop(self):
        cfg = get_config()
        period = cfg.memory_monitor_refresh_ms / 1000.0
        if period <= 0:
            return
        while True:
            await asyncio.sleep(period)
            usage = self._memory_usage_fraction()
            if usage > cfg.memory_usage_threshold:
                self.relieve_memory_pressure(usage)

    def relieve_memory_pressure(self, usage: float) -> dict:
        """One sweep under pressure: drop all idle workers, then kill the
        NEWEST leased task worker (LIFO keeps long-running work alive —
        the retried victim loses the least progress; actors are never
        chosen, matching the reference's retriable-first policy).
        Returns what was done (also an RPC for tests/operators)."""
        killed_idle = 0
        while self._idle:
            handle = self._idle.popleft()
            if handle.busy:
                continue  # mid-grant claim raced in; not expendable
            self._workers.pop(handle.worker_id, None)
            try:
                handle.kill()
            except Exception:  # noqa: BLE001
                pass
            killed_idle += 1
        victim = None
        newest = None
        for lease in self._leases.values():
            w = lease.worker
            if w.actor_id is not None or w.proc.poll() is not None:
                continue
            if newest is None or lease.granted_at > newest.granted_at:
                newest = lease
        if newest is not None:
            victim = newest.worker
            logger.warning(
                "memory pressure (%.0f%%): killing newest task worker "
                "%s (lease age %.1fs); the task retries elsewhere",
                usage * 100, victim.worker_id[:8],
                time.monotonic() - newest.granted_at)
            try:
                victim.kill()
            except Exception:  # noqa: BLE001
                pass
            self._m_oom_kills.inc()
        return {"killed_idle": killed_idle,
                "killed_worker": victim.worker_id if victim else None,
                "usage": usage}

    def _reap_idle_workers(self) -> None:
        """Enforce num_workers_soft_limit: idle task workers beyond the
        limit that exceeded the idle-kill threshold are terminated
        (ref: worker_pool idle eviction, worker_pool.h:156 pool semantics)."""
        threshold = (get_config().idle_worker_killing_time_threshold_ms
                     / 1000.0)
        if self._lease_waiters:
            # Queued demand will consume these idlers the moment
            # resources free — reaping them now would just churn spawns
            # against the prestart policy.
            return
        now = time.monotonic()
        n_task_workers = sum(1 for h in self._workers.values()
                             if h.actor_id is None)
        while n_task_workers > self._soft_limit and self._idle:
            handle = self._idle[0]
            if handle.busy:
                self._idle.popleft()  # mid-grant claim raced in
                continue
            if now - handle.last_idle < threshold:
                break  # deque is in idle order; newer ones won't qualify
            self._idle.popleft()
            self._workers.pop(handle.worker_id, None)
            self._retire_worker_logs(handle)
            try:
                handle.kill(term=True)
            except Exception:  # noqa: BLE001
                pass
            n_task_workers -= 1

    def _retire_worker_logs(self, handle: WorkerHandle) -> None:
        """Tombstone attribution for the final tail sweep, then let the
        log monitor drain + unlink the dead worker's files."""
        from ray_tpu_torch.util.profiling import stack_dump_path

        try:  # the dead worker's stack-dump file has no further reader
            os.unlink(stack_dump_path(self.log_dir, handle.proc.pid))
        except OSError:
            pass
        mon = getattr(self, "_log_monitor", None)
        if mon is None:
            return
        self._dead_worker_info[handle.worker_id] = {
            "actor_id": handle.actor_id, "job_id": handle.job_id,
            "pid": handle.proc.pid}
        while len(self._dead_worker_info) > 512:
            self._dead_worker_info.pop(next(iter(self._dead_worker_info)))
        mon.retire(handle.worker_id)

    async def _monitor_workers_loop(self):
        while True:
            # Adaptive cadence: each tick polls EVERY worker handle, so
            # at warm-pool scale (1k+ live workers) the base 0.25 s
            # period alone costs several % of a small host's core in
            # kill(0) probes and dict scans. Death-detection latency
            # degrades to at most 1 s when the pool is huge — the same
            # trade the log monitor makes.
            await asyncio.sleep(
                min(1.0, max(0.25, len(self._workers) / 1000.0)))
            self._reap_idle_workers()
            self._maybe_prestart_workers()
            self._expire_prepared_bundles()
            # Crashed zygotes: drop the handle (and relaunch the
            # default-env one eagerly — it is the hot path for every
            # pool/actor spawn; per-env zygotes relaunch on demand).
            for key, zh in list(self._zygotes.items()):
                if not zh.alive():
                    self._zygotes.pop(key, None)
                    zh.kill()
                    self._m_zygote_restarts.inc()
                    logger.warning(
                        "zygote for env %r exited with code %s",
                        key or "default", zh.proc.returncode)
                    # Eager relaunch for the default-env (hot-path)
                    # zygote, rate-limited so a zygote that dies at
                    # boot (bad preload, unbindable socket) cannot
                    # become a 4 Hz spawn storm — spawns meanwhile
                    # ride the cold fallback.
                    now = time.monotonic()
                    if (key == "" and get_config().zygote_enabled
                            and now - getattr(self, "_zygote_relaunch_ts",
                                              0.0) > 2.0):
                        self._zygote_relaunch_ts = now
                        self._ensure_zygote("", None)
            for wid, handle in list(self._workers.items()):
                if handle.proc.poll() is not None:
                    self._workers.pop(wid, None)
                    self._retire_worker_logs(handle)
                    if handle in self._idle:
                        self._idle.remove(handle)
                    if handle.actor_id is not None:
                        try:
                            await self.gcs.call(
                                "ActorManager", "report_actor_failure",
                                actor_id=handle.actor_id,
                                reason=f"worker process exited with code "
                                       f"{handle.proc.returncode}",
                                timeout=10)
                        except Exception:  # noqa: BLE001
                            pass
                    # Leases held by the dead worker are returned.
                    for lease in list(self._leases.values()):
                        if lease.worker is handle:
                            self._return_lease_internal(lease.lease_id)
                    if handle.address and handle.proc.returncode != 0:
                        # A killed or crashed owner cannot free what it
                        # owned (a clean exit flushed its own frees):
                        # free its objects everywhere, so the store
                        # returns to its baseline and its borrowers get
                        # OwnerDiedError.
                        try:
                            await self.gcs.call(
                                "ObjectDirectory", "free_owned",
                                owner=handle.address, timeout=30)
                        except Exception as e:  # noqa: BLE001
                            logger.debug("free_owned(%s) failed: %s",
                                         handle.address, e)

    # ------------------------------------------------------------------
    # lease protocol (ref: NodeManager::HandleRequestWorkerLease,
    # node_manager.cc:1696; local dispatch local_task_manager.h:58)
    # ------------------------------------------------------------------
    async def request_lease(self, demand: Dict[str, float],
                            strategy: str = "hybrid",
                            affinity: Optional[str] = None,
                            soft: bool = False,
                            placement: Optional[Tuple[str, int]] = None,
                            runtime_env: Optional[dict] = None,
                            job_id: str = "",
                            parked: bool = False) -> dict:
        reply = await self._request_lease(demand, strategy, affinity, soft,
                                          placement, runtime_env, parked)
        if job_id and reply.get("granted"):
            # Log attribution: worker lines stream to the leasing job's
            # driver (ref: log records carry the worker's job).
            lease = self._leases.get(reply["lease_id"])
            if lease is not None:
                lease.worker.job_id = job_id
        return reply

    async def _request_lease(self, demand: Dict[str, float],
                             strategy: str = "hybrid",
                             affinity: Optional[str] = None,
                             soft: bool = False,
                             placement: Optional[Tuple[str, int]] = None,
                             runtime_env: Optional[dict] = None,
                             parked: bool = False) -> dict:
        cfg = get_config()
        # Placement-group leases draw from the reserved bundle.
        if placement is not None:
            pg_id, bundle_idx = placement
            if bundle_idx < 0:
                bundle_idx = self._find_pg_bundle(pg_id, demand)
                if bundle_idx is None:
                    spill = await self._pg_spill_target(pg_id)
                    if spill:
                        return {"spill_to": spill}
                    return {"granted": False,
                            "error": f"placement group {pg_id[:8]} has no "
                                     f"bundle fitting {demand} here"}
                placement = (pg_id, bundle_idx)
            bundle = self._pg_bundles.get((pg_id, bundle_idx))
            if bundle is not None and not bundle.get("committed", True):
                bundle = None  # prepared-only: unusable until commit
            if bundle is None:
                spill = await self._pg_spill_target(pg_id, bundle_idx)
                if spill:
                    return {"spill_to": spill}
                return {"granted": False,
                        "error": f"bundle {pg_id[:8]}:{bundle_idx} not "
                                 f"reserved on this node"}
            if not rs.fits(bundle["available"], demand):
                return await self._wait_for_lease(demand, placement,
                                                  runtime_env)
            rs.subtract(bundle["available"], demand)
            return await self._grant_safely(demand, placement, runtime_env)

        # Affinity pins to a node.
        if strategy == "node_affinity" and affinity is not None:
            if affinity != self.node_id:
                target = self._view.nodes.get(affinity)
                if target is None:
                    # A node ABSENT from the view may be lag, not death:
                    # the view refreshes at 1 Hz and a lease arriving
                    # right after the target registered fails spuriously
                    # (client retries are fast enough to all land inside
                    # the lag window). Wait out up to ~2 refresh cycles.
                    # An entry that IS present with alive=False is a
                    # GCS-confirmed death — fail immediately, waiting
                    # cannot help. The budget here must stay small: the
                    # soft-affinity fall-through can still enter the
                    # 0.6x-lease-timeout infeasible wait below, and the
                    # combined total must end strictly before the
                    # client's lease RPC timeout (same knob).
                    loop = asyncio.get_running_loop()
                    deadline = loop.time() + min(
                        2.5, 0.2 * cfg.worker_lease_timeout_ms / 1000.0)
                    while loop.time() < deadline:
                        await asyncio.sleep(0.05)
                        target = self._view.nodes.get(affinity)
                        if target is not None:
                            break
                if target is not None and target.alive:
                    return {"spill_to": target.address}
                if not soft:
                    return {"granted": False,
                            "error": f"node {affinity[:8]} not available"}

        if not rs.feasible(self.total, demand):
            # Never runnable here: spill to a feasible node. If none is in
            # view yet, wait for one — the cluster may still be forming or
            # scaling up; the reference queues infeasible tasks rather than
            # failing them (ref: cluster_task_manager.h:42 infeasible queue).
            # The wait must end strictly before the client's lease RPC
            # timeout (same knob) or the error below could never be seen;
            # the background view refresher (1 Hz) supplies fresh state, so
            # this loop only re-reads self._view.
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 0.6 * cfg.worker_lease_timeout_ms / 1000.0
            self._infeasible_seq += 1
            wait_key = self._infeasible_seq
            # Visible to the autoscaler via heartbeats while we wait: this
            # demand is what should trigger a scale-up.
            self._infeasible_waits[wait_key] = demand
            try:
                while True:
                    # A feasible-by-total node takes the request even when
                    # busy right now — its daemon queues the lease until
                    # capacity frees, like the reference's waiting queues.
                    node = pick_feasible_node(self._view, demand,
                                              exclude=self.node_id)
                    if node is not None:
                        return {"spill_to": node.address}
                    if rs.feasible(self.total, demand):
                        break  # dynamic resources appeared locally
                    if loop.time() >= deadline:
                        return {"granted": False,
                                "error": f"no node can satisfy {demand}"}
                    await asyncio.sleep(0.25)
            finally:
                self._infeasible_waits.pop(wait_key, None)

        if rs.fits(self.available, demand):
            rs.subtract(self.available, demand)
            self._ledger("sub:direct", demand)
            return await self._grant_safely(demand, None, runtime_env)

        # Local node busy: consider spilling (hybrid policy). A PARKED
        # request (terminal spill target) queues here instead.
        node = (None if parked else
                pick_node(self._view, demand, strategy=strategy,
                          local_node_id=self.node_id,
                          spread_threshold=cfg.scheduler_spread_threshold))
        if node is not None and node.node_id != self.node_id:
            return {"spill_to": node.address}
        if strategy == "spread" and not parked:
            # SPREAD must not park behind local capacity: the 1 Hz view
            # can lag the local grant that just consumed our CPUs, so
            # pick_node tie-breaks to the (apparently idle) local node —
            # and parked waiters only re-pump on LOCAL release, so a
            # burst of spread tasks serializes on one node while the
            # rest of the cluster idles. Any other fitting node beats
            # waiting here. `park: True` makes the spill terminal: the
            # target queues the request rather than re-spilling on ITS
            # stale view (no ping-pong between busy nodes).
            others = [n for n in self._view.alive_nodes()
                      if n.node_id != self.node_id
                      and rs.fits(n.available, demand)]
            if others:
                # UNIFORM choice, not least-utilized-first: a burst of
                # waiters all consulting the same stale view would pile
                # onto one "least utilized" target and serialize there.
                return {"spill_to": random.choice(others).address,
                        "park": True}
        return await self._wait_for_lease(demand, None, runtime_env)

    async def _wait_for_lease(self, demand, placement,
                              runtime_env=None) -> dict:
        fut = asyncio.get_running_loop().create_future()
        self._lease_waiters.append((demand, placement, fut,
                                    time.monotonic(), runtime_env))
        self._maybe_prestart_workers()
        return await fut

    async def _grant_safely(self, demand, placement,
                            runtime_env=None) -> dict:
        """_grant shielded against RPC cancellation: a client that gives
        up (deadline) mid-grant must not leak the subtracted resources or
        the leased worker (the orphaned lease starves the node forever)."""
        task = asyncio.ensure_future(
            self._grant(demand, placement, runtime_env))
        try:
            return await asyncio.shield(task)
        except asyncio.CancelledError:
            def undo(t):
                try:
                    reply = t.result()
                except BaseException:  # noqa: BLE001 _grant rolled back
                    return
                if reply.get("granted"):
                    self._return_lease_internal(reply["lease_id"])
                else:
                    # grant failed after our subtraction was rolled back
                    # inside _grant — nothing else to undo.
                    pass
            task.add_done_callback(undo)
            raise

    def _pump_lease_queue(self) -> None:
        """Grant queued lease requests that now fit (FIFO with skip)."""
        if not self._lease_waiters:
            return
        remaining = deque()

        async def grant_later(demand, placement, fut, runtime_env):
            try:
                reply = await self._grant(demand, placement, runtime_env)
            except Exception as e:  # noqa: BLE001
                if not fut.done():
                    fut.set_exception(e)
                return
            if fut.done():
                # Waiter cancelled (client deadline) while we granted:
                # undo, or the lease + resources leak forever.
                if reply.get("granted"):
                    self._return_lease_internal(reply["lease_id"])
            else:
                fut.set_result(reply)

        while self._lease_waiters:
            (demand, placement, fut, queued_at,
             runtime_env) = self._lease_waiters.popleft()
            if fut.done():
                continue
            ok = False
            if placement is not None:
                bundle = self._pg_bundles.get(tuple(placement))
                if (bundle is not None and bundle.get("committed", True)
                        and rs.fits(bundle["available"], demand)):
                    rs.subtract(bundle["available"], demand)
                    ok = True
            elif rs.fits(self.available, demand):
                rs.subtract(self.available, demand)
                self._ledger("sub:pump", demand)
                ok = True
            if ok:
                self._m_lease_wait.observe(time.monotonic() - queued_at)
                asyncio.ensure_future(
                    grant_later(demand, placement, fut, runtime_env))
            else:
                remaining.append((demand, placement, fut, queued_at,
                                  runtime_env))
        self._lease_waiters = remaining

    async def _grant(self, demand, placement, runtime_env=None) -> dict:
        from ray_tpu_torch.core.distributed.runtime_env_agent import (
            RuntimeEnvBuildError)

        from ray_tpu_torch.runtime_env import env_hash

        gpu_ids = self._acquire_gpus(demand, env_hash(runtime_env))
        if gpu_ids is None:
            # The GPU count fits but no set of cards does (fractional
            # shares spread over them): retry once some are returned.
            self._release_demand(demand, placement)
            return {"granted": False, "transient": True,
                    "error": f"no set of cards fits GPU={demand['GPU']} "
                             f"(free shares {self._gpus.free})"}
        try:
            worker = await self._get_idle_worker(runtime_env, gpu_ids)
        except RuntimeEnvBuildError as e:
            # Definitive: a broken runtime_env spec will not fix itself —
            # the client must fail fast, not retry-rebuild for minutes.
            self._release_demand(demand, placement)
            self._gpus.release(gpu_ids, demand.get("GPU", 0.0))
            return {"granted": False, "transient": False, "error": str(e)}
        except Exception as e:  # noqa: BLE001
            # Roll back the resource subtraction. Worker-start failures
            # are transient (crash/chaos/slow start) — the resources are
            # back, so the client should retry, not give up.
            self._release_demand(demand, placement)
            self._gpus.release(gpu_ids, demand.get("GPU", 0.0))
            return {"granted": False, "transient": True, "error": str(e)}
        worker.busy = True
        lease_id = uuid.uuid4().hex
        self._leases[lease_id] = Lease(lease_id, demand, worker, placement,
                                       gpu_ids)
        self._m_leases.inc()
        if self.syncer is not None:
            self.syncer.mark_dirty()  # availability changed: sync promptly
        self._ledger(f"grant:{lease_id[:8]}:pid{worker.proc.pid}", demand)
        return {"granted": True, "worker_address": worker.address,
                "lease_id": lease_id, "node_id": self.node_id,
                "daemon_address": self.server.address}

    def _ledger(self, tag: str, demand) -> None:
        import os as _os
        # lint: allow-knob -- debug tracing gate toggled live on a running daemon
        if _os.environ.get("RAY_TPU_LEDGER"):
            import sys as _sys
            print(f"LEDGER {tag} {demand.get('CPU')} avail="
                  f"{self.available.get('CPU')}", file=_sys.stderr,
                  flush=True)

    def _release_demand(self, demand, placement) -> None:
        if placement is not None:
            bundle = self._pg_bundles.get(tuple(placement))
            if bundle is not None:
                rs.add(bundle["available"], demand)
        else:
            rs.add(self.available, demand)
            self._ledger("add:release", demand)

    def return_lease(self, lease_id: str) -> dict:
        self._return_lease_internal(lease_id)
        return {"ok": True}

    def _return_lease_internal(self, lease_id: str) -> None:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            self._ledger(f"return-miss:{lease_id[:8]}", {})
            return
        self._ledger(f"return:{lease_id[:8]}", lease.demand)
        self._release_demand(lease.demand, lease.placement)
        self._gpus.release(lease.gpu_ids, lease.gpu_quantity)
        worker = lease.worker
        if _alive_now(worker.proc) and worker.actor_id is None:
            worker.busy = False
            worker.last_idle = time.monotonic()
            if worker not in self._idle:
                self._idle.append(worker)
        if self.syncer is not None:
            self.syncer.mark_dirty()  # resources freed: sync promptly
        self._pump_lease_queue()

    def pin_lease(self, lease_id: str) -> dict:
        """Pin a granted lease for a pre-leased task lane.

        The lease's resources go back to the pool — a pinned lane worker
        holds 0 resources while alive, exactly the actor model — but the
        worker stays busy/bound: it is never re-leased, never reaped,
        and keeps executing lane frames until `return_lease` unpins it
        (which returns it to the idle pool). The Lease record stays in
        `_leases` with empty demand so the dead-worker sweep's automatic
        lease return needs no special case."""
        lease = self._leases.get(lease_id)
        if lease is None:
            return {"ok": False, "error": f"no such lease {lease_id[:8]}"}
        if lease.worker.proc.poll() is not None:
            return {"ok": False, "error": "worker dead"}
        self._release_demand(lease.demand, lease.placement)
        self._ledger(f"pin:{lease_id[:8]}", lease.demand)
        lease.demand = {}
        if self.syncer is not None:
            self.syncer.mark_dirty()  # resources freed: sync promptly
        self._pump_lease_queue()
        return {"ok": True}

    # ------------------------------------------------------------------
    # cross-host channel endpoints (compiled execution plane): remote
    # writers push serialized ring payloads as raw frames; this daemon
    # lands them in the LOCAL shm ring its readers poll.
    # ------------------------------------------------------------------
    def _is_channel_path(self, path) -> bool:
        """True for a ring file: its real name starts ``rtpu_chan_`` and it
        lies in this daemon's store directory (rings `channel_create`
        made) or in `Channel.create`'s default directory (rings a process
        of this node made). Every endpoint that names a path refuses any
        other file, so an RPC caller cannot read, map or write it."""
        from ray_tpu_torch.experimental.channel import DEFAULT_DIRECTORY

        if not isinstance(path, str) or not path:
            return False
        real = os.path.realpath(path)
        return (os.path.basename(real).startswith("rtpu_chan_")
                and os.path.dirname(real) in {
                    os.path.realpath(self.store_dir),
                    os.path.realpath(DEFAULT_DIRECTORY)})

    def _channel_entry(self, path: str, capacity: int, n_readers: int,
                       n_slots: int) -> dict:
        from ray_tpu_torch.experimental.channel import Channel

        ent = self._channels.get(path)
        if ent is None:
            ent = {"ch": Channel(path, capacity, n_readers, n_slots),
                   "lock": threading.Lock()}
            self._channels[path] = ent
        return ent

    def channel_create(self, n_readers: int,
                       capacity: Optional[int] = None,
                       n_slots: Optional[int] = None) -> dict:
        """Create a ring on THIS node for readers that live here."""
        from ray_tpu_torch.experimental import channel as chmod

        os.makedirs(self.store_dir, exist_ok=True)
        ch = chmod.Channel.create(
            n_readers, capacity or chmod.DEFAULT_CAPACITY,
            n_slots or chmod.DEFAULT_SLOTS, directory=self.store_dir)
        self._channels[ch.path] = {"ch": ch, "lock": threading.Lock()}
        return {"path": ch.path, "capacity": ch.capacity,
                "n_readers": ch.n_readers, "n_slots": ch.n_slots}

    async def channel_push(self, path: str, capacity: int, n_readers: int,
                           n_slots: int, version: int, data,
                           push_timeout: Optional[float] = None) -> dict:
        """Land one versioned payload in a local ring. Blocks (in an
        executor thread) until the ring has a free slot, so the writer's
        backpressure crosses the RPC hop. `version <= w_seq` is acked
        without writing — the dedupe that makes writer retries safe."""
        from ray_tpu_torch.experimental.channel import (
            ChannelClosedError, ChannelTimeoutError)

        if not self._is_channel_path(path):
            return {"error": "not a channel path"}
        if not os.path.exists(path):
            return {"closed": True}
        ent = self._channel_entry(path, capacity, n_readers, n_slots)
        ch, lock = ent["ch"], ent["lock"]
        version = int(version)

        def _push():
            with lock:
                if version <= ch.version():
                    return {"ok": True, "version": version,
                            "deduped": True}
                ch.write_bytes(data, timeout=push_timeout)
                return {"ok": True, "version": version}

        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, _push)
        except ChannelClosedError:
            return {"closed": True}
        except ChannelTimeoutError:
            return {"timeout": True}
        except Exception as e:  # noqa: BLE001
            return {"error": str(e)}

    def channel_version(self, path: str) -> dict:
        from ray_tpu_torch.experimental.channel import _HDR

        if not self._is_channel_path(path):
            return {"version": 0, "closed": True,
                    "error": "not a channel path"}
        try:
            with open(path, "rb") as f:
                hdr = f.read(_HDR.size)
            _, closed, _, _, _, wseq = _HDR.unpack_from(hdr, 0)
            return {"version": wseq, "closed": bool(closed)}
        except (OSError, struct.error):
            return {"version": 0, "closed": True}

    def channel_close(self, path: str) -> dict:
        """Set the ring's closed flag: every blocked read/write raises."""
        if not self._is_channel_path(path):
            return {"ok": False, "error": "not a channel path"}
        try:
            fd = os.open(path, os.O_RDWR)
            try:
                os.pwrite(fd, struct.pack("<I", 1), 4)
            finally:
                os.close(fd)
            return {"ok": True}
        except OSError as e:
            return {"ok": False, "error": str(e)}

    def channel_unlink(self, path: str) -> dict:
        if not self._is_channel_path(path):
            return {"ok": False, "error": "not a channel path"}
        ent = self._channels.pop(path, None)
        if ent is not None:
            try:
                ent["ch"].unlink()
            except Exception:  # noqa: BLE001
                pass
        try:
            os.unlink(path)
        except OSError:
            pass
        return {"ok": True}

    def _find_pg_bundle(self, pg_id: str, demand) -> Optional[int]:
        for (pid, idx), bundle in self._pg_bundles.items():
            if (pid == pg_id and bundle.get("committed", True)
                    and rs.fits(bundle["available"], demand)):
                return idx
        return None

    async def _pg_spill_target(self, pg_id: str,
                               bundle_idx: Optional[int] = None
                               ) -> Optional[str]:
        """Daemon address of the node hosting this PG bundle (GCS lookup)."""
        try:
            info = await self.gcs.call("PlacementGroups", "get_pg",
                                       pg_id=pg_id, timeout=10)
        except Exception:  # noqa: BLE001
            return None
        if info is None or info["state"] != "CREATED" or not info["nodes"]:
            return None
        if bundle_idx is None or bundle_idx < 0:
            candidates = [n for n in info["nodes"] if n != self.node_id]
            target = candidates[0] if candidates else None
        else:
            target = info["nodes"][bundle_idx] if bundle_idx < len(
                info["nodes"]) else None
        if target is None or target == self.node_id:
            return None
        node = self._view.nodes.get(target)
        if node is not None and node.alive:
            return node.address
        # The 1 Hz view refresher may not have learned the target node yet
        # (races cluster formation); the GCS registry is authoritative.
        try:
            for n in await self.gcs.call("NodeInfo", "list_nodes",
                                         timeout=10):
                if n["node_id"] == target and n["alive"]:
                    return n["address"]
        except Exception:  # noqa: BLE001
            pass
        return None

    # ------------------------------------------------------------------
    # placement groups (ref: placement_group_resource_manager.h)
    # ------------------------------------------------------------------
    def reserve_pg_bundle(self, pg_id: str, bundle_idx: int,
                          resources: Dict[str, float],
                          ttl_s: Optional[float] = None) -> dict:
        """PREPARE phase of the two-phase gang reserve (ref:
        gcs_placement_group_scheduler.h:274 prepare/commit): resources
        leave the pool immediately, but the bundle is unusable (leases
        and actors reject it) until commit_pg_bundle. If the GCS dies or
        a peer node's prepare fails, the TTL sweep returns the resources
        — a half-placed gang can never leak bundles."""
        existing = self._pg_bundles.get((pg_id, bundle_idx))
        if existing is not None:
            # Idempotent re-prepare (GCS retry of a timed-out RPC whose
            # first attempt actually landed): refresh the TTL.
            if not existing["committed"]:
                existing["expires_at"] = time.monotonic() + float(
                    ttl_s or get_config().pg_prepare_ttl_s)
            return {"ok": True}
        if not rs.fits(self.available, resources):
            return {"ok": False, "error": "insufficient resources"}
        rs.subtract(self.available, resources)
        self._pg_bundles[(pg_id, bundle_idx)] = {
            "resources": dict(resources),
            "available": dict(resources),
            "committed": False,
            "expires_at": time.monotonic() + float(
                ttl_s or get_config().pg_prepare_ttl_s),
        }
        return {"ok": True}

    def commit_pg_bundle(self, pg_id: str, bundle_idx: int) -> dict:
        """COMMIT phase: the whole gang prepared, so this bundle becomes
        usable (and permanent until returned). Pre-warms one pool worker
        so the gang's actor/lease start rides a zygote fork."""
        bundle = self._pg_bundles.get((pg_id, bundle_idx))
        if bundle is None:
            # Prepared bundle already expired or was rolled back — the
            # GCS must treat the gang as failed and retry from scratch.
            return {"ok": False, "error": "bundle not prepared"}
        bundle["committed"] = True
        bundle["expires_at"] = None
        self._maybe_prewarm_for_bundle()
        self._pump_lease_queue()
        return {"ok": True}

    def _maybe_prewarm_for_bundle(self) -> None:
        """One warm default-env worker per committed bundle (bounded by
        the warm-pool cap): gang start pops these instead of forking
        inside the critical path."""
        cfg = get_config()
        if not (cfg.pg_prewarm_enabled and cfg.worker_prestart_enabled):
            return
        idle = len(self._idle)
        starting = sum(1 for h in self._workers.values()
                       if h.address is None and h.actor_id is None)
        cap = int(cfg.zygote_warm_pool_cap or self._soft_limit)
        if idle + starting >= cap:
            return
        try:
            self._spawn_worker()
        except Exception as e:  # noqa: BLE001
            logger.debug("pg prewarm spawn failed: %s", e)
            return
        self._m_prestarted.inc()
        self._m_pg_prewarmed.inc()

    def _expire_prepared_bundles(self) -> None:
        """TTL backstop for the prepare phase (runs from the monitor
        loop): uncommitted bundles whose GCS never came back roll back
        on their own."""
        now = time.monotonic()
        for key, bundle in list(self._pg_bundles.items()):
            exp = bundle.get("expires_at")
            if bundle.get("committed") or exp is None or now < exp:
                continue
            self._pg_bundles.pop(key, None)
            rs.add(self.available, bundle["resources"])
            logger.warning("prepared pg bundle %s:%d expired after "
                           "%.1fs without commit; resources returned",
                           key[0][:8], key[1],
                           get_config().pg_prepare_ttl_s)
            self._pump_lease_queue()

    def return_pg_bundle(self, pg_id: str, bundle_idx: int) -> dict:
        bundle = self._pg_bundles.pop((pg_id, bundle_idx), None)
        if bundle is not None:
            rs.add(self.available, bundle["resources"])
            self._pump_lease_queue()
        return {"ok": True}

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    async def start_actor(self, actor_id: str, cls_blob_key: bytes,
                          args_blob: bytes, demand: Dict[str, float],
                          runtime_env: Optional[dict] = None,
                          max_concurrency: int = 1,
                          concurrency_groups: Optional[Dict[str, int]] = None,
                          placement: Optional[Tuple[str, int]] = None,
                          owner_job: str = "") -> dict:
        if placement is not None:
            placement = tuple(placement)
            bundle = self._pg_bundles.get(placement)
            if (bundle is None or not bundle.get("committed", True)
                    or not rs.fits(bundle["available"], demand)):
                return {"ok": False, "error": "pg bundle unavailable"}
            rs.subtract(bundle["available"], demand)
        else:
            if not rs.fits(self.available, demand):
                return {"ok": False, "error": "insufficient resources"}
            rs.subtract(self.available, demand)
        from ray_tpu_torch.runtime_env import env_hash

        env_key = env_hash(runtime_env)
        gpu_ids = self._acquire_gpus(demand, env_key)
        if gpu_ids is None:
            self._release_demand(demand, placement)
            return {"ok": False, "error": "insufficient resources: no set "
                                          "of cards fits the GPU demand"}

        def undo() -> None:
            self._release_demand(demand, placement)
            self._gpus.release(gpu_ids, demand.get("GPU", 0.0))

        try:
            built = await self._built_env(runtime_env)
        except asyncio.CancelledError:
            # Client deadline mid-build: roll back and let cancellation
            # propagate — it is not a creation verdict.
            undo()
            raise
        except Exception as e:  # noqa: BLE001
            undo()
            return {"ok": False,
                    "error": f"runtime_env build failed: {e}",
                    "creation_error": True}
        # Warm-pool fast path (ref: the reference pops actor-creation
        # workers from the same pool as task workers): an idle, already-
        # registered worker of the right env skips spawn + registration
        # entirely — actor readiness becomes one create_actor RPC.
        handle = self._take_idle_worker(env_key, gpu_ids)
        if handle is not None:
            handle.actor_id = actor_id
        else:
            await self._await_zygote(env_key, built)
            handle = self._take_idle_worker(env_key, gpu_ids)
            if handle is not None:
                handle.actor_id = actor_id
            else:
                handle = self._spawn_worker(actor_id=actor_id,
                                            built_env=built,
                                            env_key=env_key,
                                            gpu_ids=gpu_ids)
        self._maybe_refill_warm_pool(env_key, built)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + get_config().worker_register_timeout_s
        while not handle.registered.is_set():
            try:
                await asyncio.wait_for(handle.registered.wait(), timeout=0.1)
            except asyncio.TimeoutError:
                if (handle.proc.poll() is not None
                        or loop.time() >= deadline):
                    handle.kill()
                    self._workers.pop(handle.worker_id, None)
                    undo()
                    return {"ok": False,
                            "error": "actor worker failed to start"}
        handle.busy = True
        handle.job_id = owner_job or handle.job_id
        client = AsyncRpcClient(handle.address)
        try:
            reply = await client.call(
                "Worker", "create_actor", actor_id=actor_id,
                cls_blob_key=cls_blob_key, args_blob=args_blob,
                max_concurrency=max_concurrency,
                concurrency_groups=concurrency_groups,
                timeout=get_config().actor_creation_timeout_s)
        except BaseException:
            handle.kill()
            self._workers.pop(handle.worker_id, None)
            undo()
            raise
        finally:
            await client.close()
        if not reply.get("ok"):
            handle.kill()
            self._workers.pop(handle.worker_id, None)
            undo()
            return {"ok": False, "error": reply.get("error"),
                    "creation_error": True}
        # Track so the demand (and the cards) return if/when the actor dies.
        lease_id = f"actor-{actor_id}"
        self._leases[lease_id] = Lease(lease_id, demand, handle, placement,
                                       gpu_ids)
        return {"ok": True, "worker_address": handle.address}

    async def kill_worker(self, worker_address: str) -> dict:
        for handle in self._workers.values():
            if handle.address == worker_address:
                handle.kill()
                return {"ok": True}
        return {"ok": False}

    # ------------------------------------------------------------------
    # diagnosis plane: signal-safe stack dumps + hung-task watchdog
    # (profiling.py helpers; the GCS `Diagnosis` service fans
    # dump_worker_stacks out over every daemon)
    # ------------------------------------------------------------------
    async def _flush_task_events(self, **payload) -> None:
        await self.gcs.call("TaskEvents", "add_task_events", timeout=10,
                            _caller=(self.node_id, "task-events"),
                            **payload)

    def _dump_lock(self, pid: int) -> asyncio.Lock:
        """Per-pid dump serialization: concurrent dumps of ONE worker
        would race each other's size-offset bookkeeping."""
        locks = getattr(self, "_dump_locks", None)
        if locks is None:
            locks = self._dump_locks = {}
        if len(locks) > 1024:
            locks.clear()
        return locks.setdefault(pid, asyncio.Lock())

    async def _signal_dump(self, pid: int,
                           timeout_s: float = 3.0) -> dict:
        """Signal-safe stack extraction: SIGUSR1 the worker (its
        faulthandler handler appends an all-thread traceback to the
        per-pid dump file WITHOUT needing the GIL), tail the file, and
        return the new bytes. This is the path that still answers when
        the worker is wedged in a GIL-holding native call — the case
        the in-process sampling `profile` RPC can never see."""
        import signal as _signal

        from ray_tpu_torch.util.profiling import stack_dump_path

        path = stack_dump_path(self.log_dir, pid)
        async with self._dump_lock(pid):
            try:
                pre = os.path.getsize(path)
            except OSError:
                pre = 0
            if pre > (1 << 20):
                # The handler writes with O_APPEND, so truncating the
                # quiescent file is safe — appends land at the new EOF.
                try:
                    os.truncate(path, 0)
                    pre = 0
                except OSError:
                    pass
            try:
                os.kill(pid, _signal.SIGUSR1)
            except ProcessLookupError:
                return {"ok": False, "error": "process gone"}
            except PermissionError as e:
                return {"ok": False, "error": f"signal failed: {e}"}
            self._m_stack_dumps.inc()
            loop = asyncio.get_running_loop()
            deadline = loop.time() + timeout_s
            last = pre
            while loop.time() < deadline:
                await asyncio.sleep(0.05)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    size = pre
                if size > pre and size == last:
                    break       # grew, then stable for one poll: done
                last = size
            if last <= pre:
                return {"ok": False,
                        "error": "no dump produced (worker without a "
                                 "SIGUSR1 faulthandler, or gone)"}
            with open(path, "rb") as f:
                f.seek(pre)
                raw = f.read(min(last - pre, 256 * 1024)).decode(
                    "utf-8", "replace")
        return {"ok": True, "raw": raw}

    async def dump_worker_stacks(self, worker_id: Optional[str] = None,
                                 pids: Optional[List[int]] = None
                                 ) -> dict:
        """All-thread tracebacks of this node's live workers (filtered
        by worker-id prefix and/or pid list), via the signal-safe path.
        Powers `ray-tpu stack` through the GCS Diagnosis fan-out."""
        from ray_tpu_torch.util.profiling import parse_faulthandler_dump

        targets = []
        for h in list(self._workers.values()):
            if h.proc.poll() is not None:
                continue
            if worker_id and not h.worker_id.startswith(worker_id):
                continue
            if pids and h.proc.pid not in pids:
                continue
            targets.append(h)

        async def one(h) -> dict:
            rep = await self._signal_dump(h.proc.pid)
            rep.update(worker_id=h.worker_id, pid=h.proc.pid,
                       actor_id=h.actor_id)
            if rep.get("ok"):
                rep["threads"] = parse_faulthandler_dump(rep["raw"])
            return rep

        workers = list(await asyncio.gather(*(one(h) for h in targets)))
        return {"node_id": self.node_id, "workers": workers}

    async def _hang_watchdog_loop(self):
        cfg = get_config()
        if cfg.hang_threshold_s <= 0:
            return
        # worker_id -> last successful running_tasks snapshot: when a
        # worker stops answering (GIL wedged), the watchdog falls back
        # to the attempts it LAST saw running there.
        self._last_running: Dict[str, List[dict]] = {}
        self._unresponsive: Dict[str, int] = {}
        self._next_poll: Dict[str, float] = {}
        period = max(0.2, cfg.hang_poll_interval_s)
        while True:
            await asyncio.sleep(period)
            try:
                await self._watchdog_tick(period)
            except Exception:  # noqa: BLE001 watchdog must not die
                logger.exception("hang watchdog tick failed")

    async def _watchdog_tick(self, period: float) -> None:
        cfg = get_config()
        # Lazy per-worker cadence: an attempt can't exceed the hang
        # threshold sooner than `threshold` after it starts, so polling
        # each busy worker ~4x per threshold catches every hang within
        # 1.25x threshold while keeping the watchdog O(busy/threshold)
        # RPCs per second — a 1k-actor warm fleet must not cost 1k
        # connects every tick. Cached snapshots keep aging in between.
        repoll = max(period, cfg.hang_threshold_s / 4.0)
        now_m = time.monotonic()
        busy: List[WorkerHandle] = []
        due: List[WorkerHandle] = []
        for h in list(self._workers.values()):
            if (not h.busy or h.address is None
                    or h.proc.poll() is not None):
                self._last_running.pop(h.worker_id, None)
                self._unresponsive.pop(h.worker_id, None)
                self._next_poll.pop(h.worker_id, None)
                continue
            busy.append(h)
            if now_m >= self._next_poll.get(h.worker_id, 0.0):
                self._next_poll[h.worker_id] = now_m + repoll
                due.append(h)

        sem = asyncio.Semaphore(16)

        async def poll(h: WorkerHandle) -> None:
            async with sem:
                client = AsyncRpcClient(h.address)
                try:
                    rep = await client.call("Worker", "running_tasks",
                                            timeout=min(2.0, repoll))
                    self._last_running[h.worker_id] = rep.get("tasks") \
                        or []
                    self._unresponsive.pop(h.worker_id, None)
                except Exception:  # noqa: BLE001 — wedged or mid-
                    # restart: the LAST snapshot still names the
                    # attempt to blame, and the signal-dump path works
                    # regardless of the RPC loop's health.
                    self._unresponsive[h.worker_id] = \
                        self._unresponsive.get(h.worker_id, 0) + 1
                finally:
                    await client.close()

        if due:
            await asyncio.gather(*(poll(h) for h in due))
        running: List[dict] = []
        for h in busy:
            for info in self._last_running.get(h.worker_id) or ():
                info = dict(info)
                info["worker_id"] = h.worker_id
                info["wpid"] = h.proc.pid
                running.append(info)
        await self._watchdog.scan(running)

    async def _watchdog_dump(self, info: dict) -> Optional[str]:
        rep = await self._signal_dump(int(info.get("wpid") or 0))
        return rep.get("raw") if rep.get("ok") else None

    def _watchdog_record(self, info: dict, raw: Optional[str]) -> None:
        """Attach the auto-captured dump to the attempt's task-event
        record (bounded size; rides the daemon buffer's ring/drop
        accounting) and surface the hang in the cluster event log."""
        text = (raw or "")[:get_config().hang_dump_max_bytes] or None
        now = time.time()
        self.task_events.record_status(
            info["task_id"], info.get("attempt", 0), "RUNNING",
            ts=info.get("start_ts"), name=info.get("name"),
            job_id=info.get("job_id"), actor_id=info.get("actor_id"),
            node_id=self.node_id, worker_id=info.get("worker_id"),
            pid=info.get("wpid"), hung=True, hung_stack=text,
            hung_ts=now)
        self._m_hung.inc()
        logger.warning(
            "hung task %s (%s) on worker %s pid=%s: running %.0fs; "
            "stack dump %s", (info.get("task_id") or "")[:12],
            info.get("name"), (info.get("worker_id") or "")[:8],
            info.get("wpid"), now - (info.get("start_ts") or now),
            "captured" if text else "unavailable")

        async def log_event():
            try:
                await self.gcs.call(
                    "EventLog", "add_event", source="task",
                    severity="WARNING",
                    message=f"hung task {info.get('name')} "
                            f"({(info.get('task_id') or '')[:12]}) on "
                            f"node {self.node_id[:8]}: no progress for "
                            f"{now - (info.get('start_ts') or now):.0f}s",
                    fields={"task_id": info.get("task_id"),
                            "node_id": self.node_id,
                            "pid": info.get("wpid")}, timeout=10)
            except Exception:  # noqa: BLE001
                pass

        asyncio.ensure_future(log_event())

    # ------------------------------------------------------------------
    # object plane (transfer.py: raw-frame chunks, create-then-fill
    # receive, striped pulls, broadcast relay tree)
    # ------------------------------------------------------------------
    PEER_CLIENT_CAP = 32

    def _peer_client(self, address: str) -> AsyncRpcClient:
        """Pooled multiplexed connection to a peer daemon (LRU-capped):
        chunk RPCs must not pay a TCP dial per chunk."""
        client = self._peer_clients.pop(address, None)
        if client is None:
            client = AsyncRpcClient(address)
            while len(self._peer_clients) >= self.PEER_CLIENT_CAP:
                _, old = self._peer_clients.popitem()
                asyncio.ensure_future(old.close())
        self._peer_clients[address] = client    # re-insert: LRU freshest
        return client

    def _expire_recv_partials(self) -> None:
        """Abort receives whose sender died mid-transfer — an abandoned
        partial pins its full store reservation, not just RAM."""
        ttl = get_config().transfer_partial_ttl_s
        now = time.monotonic()
        for ob, sink in list(self._recv_partials.items()):
            if now - sink.last_touch > ttl:
                self._recv_partials.pop(ob, None)
                try:
                    sink.abort()
                except Exception:  # noqa: BLE001
                    pass

    def _new_recv_sink(self, object_id: bytes,
                       total_size: int) -> ChunkSink:
        """Create-then-fill receive surface for one incoming object;
        registers the location and drops the partial on completion."""
        oid = ObjectID(object_id)

        def on_complete() -> None:
            self._recv_partials.pop(object_id, None)

            async def register() -> None:
                try:
                    await self.gcs.call(
                        "ObjectDirectory", "add_location",
                        object_id=object_id, node_id=self.node_id,
                        size=total_size, timeout=10)
                except Exception:  # noqa: BLE001
                    pass

            asyncio.ensure_future(register())

        partial = self.store.create_for_receive(oid, total_size)
        sink = ChunkSink(partial, total_size, on_complete=on_complete)
        if not sink.sealed:               # zero-size seals immediately
            self._recv_partials[object_id] = sink
        return sink

    async def push_object(self, object_id: bytes,
                          target_address: str) -> dict:
        """Proactively push a local object into another node's store
        (ref: src/ray/object_manager/push_manager.h:30 — deduplicated,
        bounded-concurrency chunked pushes). Used for pre-staging /
        replication; the pull path stays the default. Chunks ride raw
        frames (wire.Raw memoryviews of the shm mapping) with a small
        pipeline of RPCs in flight toward the receiver."""
        oid = ObjectID(object_id)
        key = (target_address, object_id)
        existing = self._push_inflight.get(key)
        if existing is not None:
            # Dedup shares the in-flight transfer's OUTCOME — a bare
            # "ok" here would report success for a push that then fails.
            return await asyncio.shield(existing)
        buf = self.store.get_buffer(oid)
        if buf is None:
            return {"ok": False, "error": "object not local"}
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._push_inflight[key] = fut
        try:
            async with self._push_sem:
                cfg = get_config()
                total = buf.size
                raw = cfg.transfer_raw_frames
                client = self._peer_client(target_address)
                pending: set = set()
                depth = max(1, cfg.transfer_push_pipeline)
                ranges = (chunk_ranges(
                    total, cfg.object_transfer_chunk_bytes) or [(0, 0)])
                for off, ln in ranges:
                    while len(pending) >= depth:
                        done, pending = await asyncio.wait(
                            pending,
                            return_when=asyncio.FIRST_COMPLETED)
                        for t in done:
                            t.result()   # surface receiver failures
                    view = buf.view[off:off + ln]
                    pending.add(asyncio.ensure_future(client.call(
                        "NodeDaemon", "receive_object_chunk",
                        object_id=object_id, offset=off,
                        total_size=total,
                        data=Raw(view) if raw else bytes(view),
                        last=off + ln >= total, timeout=120)))
                    self._m_xfer_out.inc(ln)
                if pending:
                    done, _ = await asyncio.wait(pending)
                    for t in done:
                        t.result()
            reply = {"ok": True, "bytes": total}
        except Exception as e:  # noqa: BLE001
            reply = {"ok": False, "error": repr(e)}
        finally:
            buf.release()
            self._push_inflight.pop(key, None)
        if not fut.done():
            fut.set_result(reply)
        return reply

    async def receive_object_chunk(self, object_id: bytes, offset: int,
                                   total_size: int, data,
                                   last: bool = False) -> dict:
        """Receiving side of push/relay: chunks land at their offset
        DIRECTLY in the store's mmap (create-then-fill) — the receiver
        heap holds only the in-flight frame, never the object. Order-
        independent: the sink seals on full coverage, not on `last`."""
        oid = ObjectID(object_id)
        self._expire_recv_partials()
        sink = self._recv_partials.get(object_id)
        if sink is None:
            if self.store.contains(oid):
                return {"ok": True, "already": True}
            try:
                sink = self._new_recv_sink(object_id, total_size)
            except ObjectExistsError:
                # Raced in via the pull path / a local put mid-create.
                return {"ok": True, "already": True}
        sink.write(offset, data)
        self._m_xfer_in.inc(len(data))
        return {"ok": True, "sealed": sink.sealed}

    async def get_object_chunk(self, object_id: bytes, offset: int,
                               length: int, wait: bool = False,
                               raw: bool = True) -> dict:
        """Serve one chunk as a raw frame — a memoryview straight off
        the shm mapping, zero copies on this side (the legacy bytes()
        path survives only for raw=False / kill-switch callers). Serves
        from an in-flight partial too when the range has landed
        (`wait=True` long-polls for it): broadcast children stream an
        object out of this daemon while it is still arriving."""
        oid = ObjectID(object_id)
        use_raw = raw and get_config().transfer_raw_frames
        buf = self.store.get_buffer(oid)
        if buf is None:
            sink = self._recv_partials.get(object_id)
            if sink is not None:
                end = min(offset + length, sink.size)
                have = sink.has(offset, end)
                if not have and wait:
                    have = await sink.wait_range(
                        offset, end,
                        get_config().transfer_chunk_timeout_s)
                if sink.sealed:
                    buf = self.store.get_buffer(oid)   # serve sealed
                elif have:
                    view = sink.read(offset, end)
                    self._m_xfer_out.inc(end - offset)
                    return {"total_size": sink.size,
                            "data": Raw(view) if use_raw
                            else bytes(view)}
            if buf is None:
                return {"missing": True}
        total = buf.size
        end = min(offset + length, total)
        view = buf.view[offset:end]
        # The slice keeps the mmap alive through the transport write;
        # release the store ref NOW so eviction/GC never waits on us.
        buf.release()
        self._m_xfer_out.inc(len(view))
        return {"total_size": total,
                "data": Raw(view) if use_raw else bytes(view)}

    async def object_info(self, object_id: bytes) -> dict:
        """Size/seal state of a local (possibly still-arriving) object.
        Range readers (streaming-shuffle reducers fetching one
        partition's slice of a bundle) call this first to learn the
        object size without pulling a byte of payload."""
        oid = ObjectID(object_id)
        buf = self.store.get_buffer(oid)
        if buf is not None:
            size = buf.size
            buf.release()
            return {"size": size, "sealed": True}
        sink = self._recv_partials.get(object_id)
        if sink is not None:
            return {"size": sink.size, "sealed": sink.sealed}
        return {"missing": True}

    async def stream_pull_object(self, object_id: bytes,
                                 raw: bool = False):
        """Chunked whole-object stream (ref: object_manager.proto Push,
        5 MiB chunks ray_config_def.h:352). Legacy single-source path —
        striped pulls use get_object_chunk; raw=True upgrades the
        payloads to raw frames."""
        oid = ObjectID(object_id)
        use_raw = raw and get_config().transfer_raw_frames
        buf = self.store.get_buffer(oid)
        if buf is None:
            yield {"missing": True}
            return
        try:
            chunk = get_config().object_transfer_chunk_bytes
            total = buf.size
            for off in range(0, total, chunk):
                view = buf.view[off:off + chunk]
                self._m_xfer_out.inc(len(view))
                yield {
                    "offset": off,
                    "total_size": total,
                    "data": Raw(view) if use_raw else bytes(view),
                }
            if total == 0:
                yield {"offset": 0, "total_size": 0, "data": b""}
        finally:
            buf.release()

    async def broadcast_object(self, object_id: bytes,
                               targets: List[str]) -> dict:
        """1->N pre-staging over a log-N relay tree (the weight-
        distribution primitive): this node serves only its <=fanout
        children; each child relays to its subtree WHILE its own copy
        is still arriving (partial re-serve in get_object_chunk). The
        owner's uplink therefore carries fanout*size bytes, not
        N*size. Returns when the whole subtree has sealed."""
        oid = ObjectID(object_id)
        buf = self.store.get_buffer(oid)
        if buf is None:
            return {"ok": False, "error": "object not local"}
        total = buf.size
        buf.release()
        cfg = get_config()
        plan = plan_broadcast_tree(
            [t for t in targets if t != self.server.address],
            cfg.transfer_broadcast_fanout)
        timeout = max(120.0, total / (4 << 20))
        replies = await asyncio.gather(
            *(self._peer_client(child).call(
                "NodeDaemon", "relay_object", object_id=object_id,
                total_size=total, parent_address=self.server.address,
                subtree=subtree, timeout=timeout)
              for child, subtree in plan),
            return_exceptions=True)
        nodes = 0
        errors: List[str] = []
        for rep in replies:
            if isinstance(rep, BaseException):
                errors.append(repr(rep))
            elif rep.get("ok"):
                nodes += rep.get("nodes", 0)
            else:
                errors.append(str(rep.get("error")))
                nodes += rep.get("nodes", 0)
        return {"ok": not errors, "nodes": nodes, "bytes": total,
                "errors": errors}

    async def relay_object(self, object_id: bytes, total_size: int,
                           parent_address: str,
                           subtree: List[str]) -> dict:
        """One node of the broadcast tree: pull chunks from the parent
        (which may itself still be receiving — wait=True long-polls)
        while this node's children pull the same ranges from US as they
        land. The relay returns once this node AND its subtree sealed."""
        oid = ObjectID(object_id)
        cfg = get_config()
        sink: Optional[ChunkSink] = None
        if not self.store.contains(oid):
            sink = self._recv_partials.get(object_id)
            if sink is None:
                try:
                    sink = self._new_recv_sink(object_id, total_size)
                except ObjectExistsError:
                    sink = None      # raced in: serve from the store
        # Children first: they start pulling from this daemon's partial
        # immediately, pipelining the tree instead of serializing it.
        plan = plan_broadcast_tree(
            [t for t in subtree if t != self.server.address],
            cfg.transfer_broadcast_fanout)
        timeout = max(120.0, total_size / (4 << 20))
        child_calls = [
            asyncio.ensure_future(self._peer_client(child).call(
                "NodeDaemon", "relay_object", object_id=object_id,
                total_size=total_size,
                parent_address=self.server.address,
                subtree=st, timeout=timeout))
            for child, st in plan]
        error: Optional[str] = None
        try:
            if sink is not None and not sink.sealed:
                client = self._peer_client(parent_address)
                pending: Dict[asyncio.Task, Tuple[int, int]] = {}
                depth = max(1, cfg.transfer_push_pipeline)
                per_chunk_timeout = cfg.transfer_chunk_timeout_s + 5.0

                def spawn(off: int, ln: int) -> None:
                    task = asyncio.ensure_future(client.call(
                        "NodeDaemon", "get_object_chunk",
                        object_id=object_id, offset=off, length=ln,
                        wait=True, timeout=per_chunk_timeout))
                    pending[task] = (off, ln)

                ranges = chunk_ranges(
                    total_size, cfg.object_transfer_chunk_bytes)
                ranges.reverse()
                try:
                    while (ranges or pending) and not sink.sealed:
                        while ranges and len(pending) < depth:
                            off, ln = ranges.pop()
                            spawn(off, ln)
                        if not pending:
                            break
                        done, _ = await asyncio.wait(
                            pending,
                            return_when=asyncio.FIRST_COMPLETED)
                        for task in done:
                            off, ln = pending.pop(task)
                            rep = task.result()
                            if rep.get("missing"):
                                raise RuntimeError(
                                    f"parent {parent_address} lost "
                                    f"{oid.hex()[:12]} mid-broadcast")
                            sink.write(off, rep["data"])
                            self._m_xfer_in.inc(ln)
                finally:
                    # A racing push may have sealed the sink with our
                    # fetches still out — never leave tasks un-awaited.
                    for task in pending:
                        task.cancel()
                if not sink.sealed:
                    raise RuntimeError("relay pull did not complete")
        except Exception as e:  # noqa: BLE001
            error = repr(e)
            if sink is not None and not sink.sealed:
                self._recv_partials.pop(object_id, None)
                sink.abort()
        child_replies = await asyncio.gather(*child_calls,
                                             return_exceptions=True)
        nodes = 0 if error else 1
        errors = [error] if error else []
        for rep in child_replies:
            if isinstance(rep, BaseException):
                errors.append(repr(rep))
            elif rep.get("ok"):
                nodes += rep.get("nodes", 0)
            else:
                errors.append(str(rep.get("error")))
                nodes += rep.get("nodes", 0)
        if errors:
            return {"ok": False, "nodes": nodes,
                    "error": "; ".join(e for e in errors if e)}
        return {"ok": True, "nodes": nodes}

    def delete_objects(self, object_ids: List[bytes]) -> dict:
        for ob in object_ids:
            self.store.delete(ObjectID(ob), force=False)
        return {"ok": True}

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------
    def node_stats(self) -> dict:
        return {
            "node_id": self.node_id,
            "total": self.total,
            "available": self.available,
            "num_workers": len(self._workers),
            "num_idle": len(self._idle),
            "num_leases": len(self._leases),
            "store_used": self.store.used,
            "store_objects": self.store.num_objects,
            "pg_bundles": list(self._pg_bundles.keys()),
        }

    def ping(self) -> dict:
        return {"ok": True}


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--node-id", default=None)
    parser.add_argument("--num-cpus", type=float, default=None)
    parser.add_argument("--num-gpus", type=float, default=None)
    parser.add_argument("--store-dir", default=None)
    parser.add_argument("--object-store-memory", type=int, default=0)
    parser.add_argument("--resources", default="{}")
    args = parser.parse_args()

    logging.basicConfig(
        level=logging.INFO,
        format="[raylet] %(asctime)s %(levelname)s %(message)s")
    # Exit when the spawning driver/launcher dies (workers then follow
    # via their PDEATHSIG, which is safe for THEM: they are forked from
    # this process's long-lived main thread).
    from ray_tpu_torch.core.distributed.driver import start_watch_parent_thread

    start_watch_parent_thread()

    import json

    async def run():
        import signal

        daemon = NodeDaemon(
            gcs_address=args.gcs_address, host=args.host, port=args.port,
            node_id=args.node_id, num_cpus=args.num_cpus,
            num_gpus=args.num_gpus,
            custom_resources=json.loads(args.resources),
            store_dir=args.store_dir,
            object_store_memory=args.object_store_memory)
        port = await daemon.start()
        print(f"DAEMON_PORT={port} NODE_ID={daemon.node_id} "
              f"STORE_DIR={daemon.store_dir}", flush=True)
        stop_event = asyncio.Event()
        loop = asyncio.get_running_loop()
        # Workers fate-share with the daemon (ref: runtime_env
        # ARCHITECTURE.md "fate-shares"): on TERM/INT, kill every child
        # worker before exiting.
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop_event.set)
        await stop_event.wait()
        await daemon.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
