"""Autoscaler v2: a reconciling instance manager with durable states. The
port's copy of `ray_tpu/autoscaler/v2.py`.

Analogue of the reference's autoscaler v2
(ref: python/ray/autoscaler/v2/instance_manager/instance_manager.py —
InstanceUpdateEvent state machine; v2/scheduler.py ResourceDemandScheduler;
v2/instance_manager/reconciler.py Reconciler.sync_from). Where v1's
`StandardAutoscaler.update()` recomputes everything from scratch each
pass and keeps launch state only in live threads, v2 keeps ONE durable
record per instance walking an explicit lifecycle:

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING
                 |             |            |
                 v             v            v
          ALLOCATION_FAILED  (stuck ->  RAY_STOPPING/DRAINING
            (requeue/attempt)  retire)      -> TERMINATING -> TERMINATED

Every transition is appended to the record's history and the whole table
is persisted (storage callback — GCS KV in production), so a restarted
autoscaler resumes mid-launch instead of double-launching, and a launch
that never joins is detected by TIMEOUT IN STATE, terminated, and
retried up to `max_attempts` (stuck-instance recovery, which v1 only
approximates for the never-joined case).

The scheduler half stays demand-driven: pending gang/queued demand is
bin-packed (binpack.plan_scaling) into desired instance counts; surplus
idle instances drain. Both halves meet in `reconcile()` — one
idempotent pass, unit-drivable without a cluster.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import time
import uuid
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.autoscaler import NodeTypeConfig
from ray_tpu_torch.autoscaler.binpack import plan_scaling
from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger(__name__)

# Lifecycle states (ref: instance_manager.proto InstanceStatus).
QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RAY_RUNNING = "RAY_RUNNING"
RAY_STOPPING = "RAY_STOPPING"
TERMINATING = "TERMINATING"
TERMINATED = "TERMINATED"
ALLOCATION_FAILED = "ALLOCATION_FAILED"

ACTIVE_STATES = (QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING, RAY_STOPPING,
                 TERMINATING)


@dataclasses.dataclass
class InstanceRecord:
    instance_id: str                 # manager-scoped, stable across cloud
    node_type: str
    status: str = QUEUED
    cloud_id: str = ""               # provider instance id once REQUESTED
    ray_node_id: str = ""
    attempt: int = 0
    status_since: float = dataclasses.field(default_factory=time.monotonic)
    history: List[dict] = dataclasses.field(default_factory=list)

    def transition(self, status: str, reason: str = "") -> None:
        self.history.append({"from": self.status, "to": status,
                             "reason": reason, "ts": time.time()})
        self.status = status
        self.status_since = time.monotonic()

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class InstanceManager:
    """Durable instance table + one reconciliation step.

    `persist` is called with the serialized table after every mutating
    pass (wire it to GCS KV put); `restore` loads it back on restart.
    """

    def __init__(
        self,
        provider: NodeProvider,
        node_types: Dict[str, NodeTypeConfig],
        *,
        launch_timeout_s: float = 120.0,
        drain_timeout_s: float = 60.0,
        idle_timeout_s: float = 60.0,
        max_attempts: int = 3,
        persist: Optional[Callable[[bytes], None]] = None,
    ):
        self.provider = provider
        self.node_types = node_types
        self.launch_timeout_s = launch_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self.idle_timeout_s = idle_timeout_s
        self.max_attempts = max_attempts
        self.MAX_DEAD_RECORDS = 64
        self._persist = persist
        self.instances: Dict[str, InstanceRecord] = {}

    # -- durability -----------------------------------------------------
    def dump(self) -> bytes:
        return json.dumps({iid: r.as_dict()
                           for iid, r in self.instances.items()}).encode()

    def restore(self, blob: Optional[bytes]) -> None:
        if not blob:
            return
        for iid, d in json.loads(blob.decode()).items():
            d = dict(d)
            # status_since is monotonic-clock local; a restart restarts
            # the in-state timer (conservative: never fires early).
            d["status_since"] = time.monotonic()
            self.instances[iid] = InstanceRecord(**d)

    def _save(self) -> None:
        if self._persist is not None:
            try:
                self._persist(self.dump())
            except Exception:  # noqa: BLE001 persistence outage must not
                logger.warning("instance table persist failed",
                               exc_info=True)

    # -- queries --------------------------------------------------------
    def active(self, *states: str) -> List[InstanceRecord]:
        states = states or ACTIVE_STATES
        return [r for r in self.instances.values() if r.status in states]

    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.instances.values():
            out[r.status] = out.get(r.status, 0) + 1
        return out

    # -- scheduling (demand -> desired QUEUED records) -------------------
    def schedule(self, status: dict,
                 resource_requests: Optional[List[dict]] = None) -> None:
        """Bin-pack unmet demand into new QUEUED records (ref:
        v2/scheduler.py ResourceDemandScheduler.schedule)."""
        nodes = status.get("nodes") or []
        demands = [dict(d) for n in nodes if n.get("alive")
                   for d in n.get("queued_demand") or []]
        demands += [dict(d) for d in status.get("pending_actors") or []]
        pending_pgs = status.get("pending_pgs") or []
        requests = [dict(b) for b in resource_requests or []]
        if not demands and not pending_pgs and not requests:
            return
        # Capacity already spoken for: live nodes' availability plus
        # every in-flight instance's type resources (launching capacity
        # must not double-launch).
        running = [dict(n.get("available") or {}) for n in nodes
                   if n.get("alive")]
        totals = [dict(n.get("total") or {}) for n in nodes
                  if n.get("alive")]
        pending_types = [r.node_type
                         for r in self.active(QUEUED, REQUESTED,
                                              ALLOCATED)]
        type_counts = {
            name: sum(1 for r in self.active()
                      if r.node_type == name)
            for name in self.node_types}
        plan = plan_scaling(
            {name: cfg.as_plan_dict()
             for name, cfg in self.node_types.items()},
            running=running, pending_types=pending_types,
            demands=demands, pending_pgs=pending_pgs,
            resource_requests=requests, type_counts=type_counts,
            totals=totals)
        for node_type, count in plan.to_launch.items():
            for _ in range(count):
                iid = f"{node_type}#{uuid.uuid4().hex[:8]}"
                self.instances[iid] = InstanceRecord(iid, node_type)
                logger.info("scheduled %s (demand)", iid)
        if plan.to_launch:
            self._save()

    # -- reconciliation --------------------------------------------------
    def reconcile(self, status: dict) -> Dict[str, int]:
        """One idempotent pass: advance every record against the
        provider view + ray cluster state (ref: Reconciler.sync_from).
        Returns the post-pass status summary."""
        nodes = {n["node_id"]: n
                 for n in status.get("nodes") or [] if n.get("node_id")}
        mutated = False
        now = time.monotonic()

        # Phase 1 — issue creates for QUEUED records, THEN snapshot the
        # provider view (a pre-create snapshot would miss the instances
        # just requested and stall them a pass in REQUESTED).
        for rec in list(self.instances.values()):
            if rec.status == QUEUED:
                cfg = self.node_types.get(rec.node_type)
                try:
                    cloud_id = self.provider.create_node(
                        rec.node_type,
                        cfg.node_config if cfg else {})
                except Exception as e:  # noqa: BLE001 cloud refusal
                    rec.attempt += 1
                    rec.transition(
                        ALLOCATION_FAILED if rec.attempt
                        >= self.max_attempts else QUEUED,
                        f"create_node failed: {e}")
                    mutated = True
                    continue
                rec.cloud_id = cloud_id
                rec.transition(REQUESTED, "create_node issued")
                mutated = True
        provider_view = self.provider.non_terminated_nodes()

        # Phase 2 — advance everything else against the fresh view.
        for rec in list(self.instances.values()):
            if rec.status == REQUESTED:
                if rec.cloud_id in provider_view:
                    rec.transition(ALLOCATED, "provider reports instance")
                    mutated = True
                elif now - rec.status_since > self.launch_timeout_s:
                    self._retire(rec, "allocation timed out")
                    mutated = True

            if rec.status == ALLOCATED:
                inst = provider_view.get(rec.cloud_id)
                ray_node = (nodes.get(inst.ray_node_id)
                            if inst is not None and inst.ray_node_id
                            else None)
                if inst is None:
                    # Preempted/deleted underneath us.
                    self._retire(rec, "instance vanished from provider")
                    mutated = True
                elif ray_node is not None and ray_node.get("alive"):
                    rec.ray_node_id = inst.ray_node_id
                    rec.transition(RAY_RUNNING, "node registered")
                    mutated = True
                elif now - rec.status_since > self.launch_timeout_s:
                    # STUCK: allocated but the daemon never joined.
                    self._retire(rec, "ray never started (stuck)")
                    mutated = True

            if rec.status == RAY_RUNNING:
                node = nodes.get(rec.ray_node_id)
                if node is None or not node.get("alive"):
                    rec.transition(TERMINATING, "ray node died")
                    mutated = True
                elif (node.get("idle_s", 0) > self.idle_timeout_s
                        and self._above_floor(rec.node_type)):
                    rec.transition(RAY_STOPPING, "idle past timeout")
                    mutated = True

            if rec.status == RAY_STOPPING:
                # Drain grace: running work finishes; then terminate.
                node = nodes.get(rec.ray_node_id)
                idle = node is None or not node.get("alive") \
                    or node.get("idle_s", 0) > 0
                if idle or now - rec.status_since > self.drain_timeout_s:
                    rec.transition(TERMINATING, "drained")
                    mutated = True

            if rec.status == TERMINATING:
                try:
                    self.provider.terminate_node(rec.cloud_id)
                except Exception:  # noqa: BLE001 already gone
                    pass
                rec.transition(TERMINATED, "terminate issued")
                mutated = True

        # Prune dead records beyond a bounded tombstone tail: the table
        # (and its persisted blob, and every pass's iteration) must not
        # grow forever under node churn. Keep the most recent terminal
        # records for debugging/audit.
        dead = [r for r in self.instances.values()
                if r.status in (TERMINATED, ALLOCATION_FAILED)]
        if len(dead) > self.MAX_DEAD_RECORDS:
            dead.sort(key=lambda r: r.status_since)
            for r in dead[:len(dead) - self.MAX_DEAD_RECORDS]:
                del self.instances[r.instance_id]
            mutated = True

        if mutated:
            self._save()
        return self.summary()

    def _retire(self, rec: InstanceRecord, reason: str) -> None:
        """Terminate a failed/stuck launch and requeue a replacement
        while the attempt budget lasts (stuck-instance recovery)."""
        if rec.cloud_id:
            try:
                self.provider.terminate_node(rec.cloud_id)
            except Exception:  # noqa: BLE001
                pass
        rec.transition(TERMINATED, reason)
        if rec.attempt + 1 < self.max_attempts:
            iid = f"{rec.node_type}#{uuid.uuid4().hex[:8]}"
            repl = InstanceRecord(iid, rec.node_type,
                                  attempt=rec.attempt + 1)
            repl.history.append({"from": "", "to": QUEUED,
                                 "reason": f"replaces {rec.instance_id}: "
                                           f"{reason}",
                                 "ts": time.time()})
            self.instances[iid] = repl
            logger.warning("%s retired (%s); requeued as %s (attempt %d)",
                           rec.instance_id, reason, iid, repl.attempt)
        else:
            logger.error("%s retired (%s); attempt budget exhausted",
                         rec.instance_id, reason)

    def _above_floor(self, node_type: str) -> bool:
        cfg = self.node_types.get(node_type)
        floor = cfg.min_workers if cfg else 0
        alive = sum(1 for r in self.instances.values()
                    if r.node_type == node_type and r.status in
                    (RAY_RUNNING, ALLOCATED, REQUESTED, QUEUED))
        return alive > floor


class AutoscalerV2:
    """GCS-wired driver: read cluster status, persist the table in GCS
    KV, run schedule+reconcile each tick (ref: v2 autoscaler sdk)."""

    KV_NAMESPACE = "autoscaler"
    KV_KEY = b"v2_instances"

    def __init__(self, gcs_address: str, provider: NodeProvider,
                 node_types: Dict[str, NodeTypeConfig], **im_kwargs):
        from ray_tpu_torch.core.distributed.rpc import (
            EventLoopThread,
            SyncRpcClient,
        )

        self._loop = EventLoopThread("autoscaler-v2")
        self._gcs = SyncRpcClient(gcs_address, self._loop)
        self.manager = InstanceManager(
            provider, node_types, persist=self._kv_persist, **im_kwargs)
        self.manager.restore(self._kv_load())

    def _kv_persist(self, blob: bytes) -> None:
        self._gcs.call("KV", "put", namespace=self.KV_NAMESPACE,
                       key=self.KV_KEY, value=blob, overwrite=True,
                       timeout=10)

    def _kv_load(self) -> Optional[bytes]:
        try:
            return self._gcs.call("KV", "get",
                                  namespace=self.KV_NAMESPACE,
                                  key=self.KV_KEY, timeout=10)
        except Exception:  # noqa: BLE001 fresh cluster
            return None

    def update(self) -> Dict[str, int]:
        status = self._gcs.call("AutoscalerState", "get_cluster_status",
                                timeout=10)
        requests = status.get("resource_requests") or []
        self.manager.schedule(status, requests)
        return self.manager.reconcile(status)
