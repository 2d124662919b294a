"""StandardAutoscaler: one reconciliation pass per update(). The port's
copy of `ray_tpu/autoscaler/autoscaler.py`.

Analogue of the reference `StandardAutoscaler.update`
(ref: python/ray/autoscaler/_private/autoscaler.py:172 — the
non-actor-based control loop the monitor drives; v2 equivalent
autoscaler/v2/instance_manager/). Each pass:

  1. read cluster state from the GCS AutoscalerState service
     (queued demand, pending actors/PGs, sdk resource requests, idle time)
  2. reconcile provider instances vs registered nodes; reap instances
     that never joined within `launch_timeout_s`
  3. bin-pack pending demand (binpack.plan_scaling) and launch what the
     current + booting capacity can't hold
  4. terminate nodes idle past `idle_timeout_s`, respecting per-type
     min_workers and any standing resource_requests floor
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch.autoscaler.binpack import fits_after_removal, plan_scaling
from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class NodeTypeConfig:
    """One launchable shape (ref: available_node_types in the reference's
    cluster YAML — autoscaler/ray-schema.json). A GPU node type's
    resources carry "GPU", the number of cards one host adds."""
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 0
    node_config: dict = dataclasses.field(default_factory=dict)

    def as_plan_dict(self) -> dict:
        return {"resources": self.resources, "max_workers": self.max_workers}


class StandardAutoscaler:
    def __init__(
        self,
        gcs_address: str,
        provider: NodeProvider,
        node_types: Dict[str, NodeTypeConfig],
        *,
        idle_timeout_s: float = 60.0,
        launch_timeout_s: float = 120.0,
        max_concurrent_launches: int = 8,
    ):
        from ray_tpu_torch.core.distributed.rpc import (
            EventLoopThread,
            SyncRpcClient,
        )

        self.provider = provider
        self.node_types = node_types
        self.idle_timeout_s = idle_timeout_s
        self.launch_timeout_s = launch_timeout_s
        self.max_concurrent_launches = max_concurrent_launches
        self._loop = EventLoopThread("autoscaler")
        self._gcs = SyncRpcClient(gcs_address, self._loop)
        self._launching: Dict[str, threading.Thread] = {}
        self._lock = threading.Lock()
        self.last_status: dict = {}

    # -- one reconciliation pass ---------------------------------------
    def update(self) -> dict:
        status = self._gcs.call("AutoscalerState", "get_cluster_status",
                                timeout=10)
        instances = self.provider.non_terminated_nodes()
        nodes_by_id = {n["node_id"]: n for n in status["nodes"]}

        running, pending_types, totals = [], [], []
        type_counts: Dict[str, int] = {}
        joined = {}      # instance_id -> node dict
        for iid, inst in instances.items():
            type_counts[inst.node_type] = type_counts.get(inst.node_type,
                                                          0) + 1
            node = nodes_by_id.get(inst.ray_node_id)
            if node is not None and node["alive"]:
                joined[iid] = node
            elif (time.monotonic() - inst.launched_at
                  > self.launch_timeout_s):
                logger.warning("instance %s (%s) never joined; terminating",
                               iid, inst.node_type)
                self.provider.terminate_node(iid)
                type_counts[inst.node_type] -= 1
            else:
                pending_types.append(inst.node_type)
        # Launches still executing in threads count as future capacity AND
        # toward per-type totals (caps and the min_workers floor), else a
        # slow provider.create_node re-launches the same need every pass.
        with self._lock:
            for iid, th in list(self._launching.items()):
                if not th.is_alive():
                    del self._launching[iid]
                else:
                    t = iid.split("#", 1)[0]
                    pending_types.append(t)
                    type_counts[t] = type_counts.get(t, 0) + 1

        # Demand/capacity arrives from every alive node — including the
        # provider-independent head node, which we must count but never
        # touch.
        demands: List[dict] = list(status["pending_actors"])
        provider_node_ids = {i.ray_node_id for i in instances.values()}
        for node in status["nodes"]:
            if not node["alive"]:
                continue
            running.append(node["available"])
            totals.append(node["total"])
            demands.extend(node["queued_demand"])

        plan = plan_scaling(
            {name: t.as_plan_dict() for name, t in self.node_types.items()},
            running=running,
            pending_types=pending_types,
            demands=demands,
            pending_pgs=status["pending_pgs"],
            resource_requests=status["resource_requests"],
            type_counts=type_counts,
            totals=totals,
        )

        # min_workers floor per type (type_counts already includes booting
        # instances and in-flight launch threads).
        for name, cfg in self.node_types.items():
            have = (type_counts.get(name, 0) + plan.to_launch.get(name, 0))
            if have < cfg.min_workers:
                plan.to_launch[name] = (plan.to_launch.get(name, 0)
                                        + cfg.min_workers - have)

        launched = self._launch(plan.to_launch)
        terminated = []
        if not plan.to_launch and not demands and not status["pending_pgs"]:
            terminated = self._terminate_idle(joined, type_counts, totals,
                                              status["resource_requests"])

        self.last_status = {
            "instances": {i: inst.as_dict()
                          for i, inst in instances.items()},
            "demands": demands,
            "pending_pgs": status["pending_pgs"],
            "to_launch": plan.to_launch,
            "launched": launched,
            "terminated": terminated,
            "infeasible": plan.infeasible,
        }
        if plan.infeasible:
            logger.warning("infeasible demand (no node type fits): %s",
                           plan.infeasible)
        return self.last_status

    def _launch(self, to_launch: Dict[str, int]) -> int:
        count = 0
        with self._lock:
            in_flight = len(self._launching)
        for name, n in to_launch.items():
            cfg = self.node_types[name]
            for _ in range(n):
                if in_flight + count >= self.max_concurrent_launches:
                    return count
                # Launch in a thread: create_node may block (the fake
                # provider waits for the daemon handshake; clouds wait on
                # API calls) and one slow launch must not stall the loop.
                key = f"{name}#{time.monotonic_ns()}#{count}"

                def run(nm=name, c=cfg):
                    try:
                        self.provider.create_node(nm, c.node_config)
                    except Exception as e:  # noqa: BLE001
                        logger.warning("launch of %s failed: %s", nm, e)

                th = threading.Thread(target=run, daemon=True,
                                      name=f"launch-{name}")
                with self._lock:
                    self._launching[key] = th
                th.start()
                count += 1
        return count

    def _terminate_idle(self, joined: Dict[str, dict],
                        type_counts: Dict[str, int],
                        totals: List[dict],
                        resource_requests: List[dict]) -> List[str]:
        terminated = []
        # Longest-idle first.
        order = sorted(joined.items(), key=lambda kv: -kv[1]["idle_s"])
        for iid, node in order:
            if node["idle_s"] < self.idle_timeout_s:
                continue
            inst = self.provider.non_terminated_nodes().get(iid)
            if inst is None:
                continue
            cfg = self.node_types.get(inst.node_type)
            if cfg is None or type_counts.get(inst.node_type,
                                              0) <= cfg.min_workers:
                continue
            try:
                idx = next(i for i, t in enumerate(totals)
                           if t == node["total"])
            except StopIteration:
                idx = -1
            if resource_requests and idx >= 0 and not fits_after_removal(
                    totals, idx, resource_requests):
                continue
            logger.info("terminating idle node %s (idle %.1fs)",
                        node["node_id"][:8], node["idle_s"])
            # Drain first so the GCS stops scheduling onto it while the
            # provider tears it down (ref: DrainNode in the autoscaler
            # proto — graceful preference over hard kill).
            try:
                self._gcs.call("NodeInfo", "drain_node",
                               node_id=node["node_id"], timeout=10)
            except Exception:  # noqa: BLE001
                pass
            self.provider.terminate_node(iid)
            type_counts[inst.node_type] -= 1
            if idx >= 0:
                totals.pop(idx)
            terminated.append(iid)
        return terminated

    def close(self) -> None:
        try:
            self._gcs.close()
        finally:
            self._loop.stop()
