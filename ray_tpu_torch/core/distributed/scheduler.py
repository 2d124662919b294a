"""Cluster scheduling policies.

The port's copy of `ray_tpu/core/distributed/scheduler.py`,
importing `ray_tpu_torch` only.

Analogue of the reference's scheduler policy umbrella
(ref: src/ray/raylet/scheduling/scheduling_policy.h:26; hybrid top-k design
comment policy/hybrid_scheduling_policy.h:26-49; spread/affinity/bundle
policies in policy/*.h). Operates on a ClusterView assembled from GCS
heartbeats; used both by node daemons (task spillback) and by the GCS
(actor/PG placement).
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.distributed import resources as rs


@dataclasses.dataclass
class NodeView:
    node_id: str
    address: str            # daemon RPC address
    total: rs.ResourceSet
    available: rs.ResourceSet
    alive: bool = True
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    store_dir: str = ""
    last_heartbeat: float = dataclasses.field(default_factory=time.monotonic)
    # Autoscaler inputs (ref: the raylet reports resource load + idle time
    # through the syncer to the GCS autoscaler state,
    # gcs_autoscaler_state_manager.h): demands queued on this node's
    # daemon and the last moment it was observed busy.
    queued: List[rs.ResourceSet] = dataclasses.field(default_factory=list)
    last_busy: float = dataclasses.field(default_factory=time.monotonic)
    # Synced node stats (syncer.py STATE_KEYS): object-store pressure and
    # worker-pool depth, shipped as deltas alongside resources.
    store_used: int = 0
    store_objects: int = 0
    spilled_bytes: int = 0
    workers: int = 0
    idle_workers: int = 0
    busy_workers: int = 0
    # Serve replica gauges aggregated per app on this node (queue depth,
    # active streams, KV-pool occupancy) — the controller's autoscale
    # signal rides the syncer instead of per-decision replica polls.
    serve: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # Train-rank step/phase gauges on this node, keyed run -> "rank@N"
    # (node_daemon._train_state): the GCS TrainRunState's goodput/skew
    # input rides the syncer the same way serve gauges do.
    train: Dict[str, dict] = dataclasses.field(default_factory=dict)


# Dynamic NodeView attributes the syncer may overwrite from a reported
# state dict (the "available"/"queued" pair keeps heartbeat parity).
_SYNCED_ATTRS = ("available", "queued", "store_used", "store_objects",
                 "spilled_bytes", "workers", "idle_workers", "busy_workers",
                 "serve", "train")
# Everything a daemon needs of a peer to make spillback decisions —
# the cluster-view fan-out entry.
_WIRE_ATTRS = ("node_id", "address", "total", "available", "alive",
               "labels", "store_dir", "queued") + _SYNCED_ATTRS[2:]


def node_wire(n: NodeView) -> dict:
    """NodeView -> broadcast wire dict (plain primitives only)."""
    return {a: getattr(n, a) for a in _WIRE_ATTRS}


def apply_node_wire(view: "ClusterView", payload: dict) -> None:
    """Fold a syncer broadcast payload (full or delta) into a view."""
    if payload.get("full"):
        view.nodes = {}
    for nid, wire in (payload.get("nodes") or {}).items():
        n = view.nodes.get(nid)
        if n is None:
            view.nodes[nid] = NodeView(
                node_id=nid, address=wire.get("address", ""),
                total=dict(wire.get("total") or {}),
                available=dict(wire.get("available") or {}),
                alive=wire.get("alive", True),
                labels=dict(wire.get("labels") or {}),
                store_dir=wire.get("store_dir", ""))
            n = view.nodes[nid]
        for attr in _WIRE_ATTRS:
            if attr in wire:
                setattr(n, attr, wire[attr])
        n.last_heartbeat = time.monotonic()
    for nid in payload.get("dead") or ():
        n = view.nodes.get(nid)
        if n is not None:
            n.alive = False


class ClusterView:
    def __init__(self):
        self.nodes: Dict[str, NodeView] = {}

    def alive_nodes(self) -> List[NodeView]:
        return [n for n in self.nodes.values() if n.alive]

    def update(self, node_id: str, available: rs.ResourceSet,
               queued: Optional[List[rs.ResourceSet]] = None) -> None:
        n = self.nodes.get(node_id)
        if n is not None:
            n.available = available
            if queued is not None:
                n.queued = queued
            n.last_heartbeat = time.monotonic()
            if n.queued or rs.utilization(n.total, n.available) > rs.EPS:
                n.last_busy = n.last_heartbeat

    def apply_state(self, node_id: str, state: Dict) -> bool:
        """Apply a (partial) synced state dict — the syncer's delta-apply
        seam. Refreshes liveness exactly like a heartbeat would."""
        n = self.nodes.get(node_id)
        if n is None:
            return False
        for attr in _SYNCED_ATTRS:
            if attr in state:
                setattr(n, attr, state[attr])
        n.last_heartbeat = time.monotonic()
        if n.queued or rs.utilization(n.total, n.available) > rs.EPS:
            n.last_busy = n.last_heartbeat
        return True


def pick_node(
    view: ClusterView,
    demand: rs.ResourceSet,
    *,
    strategy: str = "hybrid",          # hybrid | spread | node_affinity
    local_node_id: Optional[str] = None,
    affinity_node_id: Optional[str] = None,
    affinity_soft: bool = False,
    spread_threshold: float = 0.5,
    top_k_fraction: float = 0.2,
    rng: Optional[random.Random] = None,
) -> Optional[NodeView]:
    """Pick a node for `demand`, or None if nothing fits right now.

    hybrid (default, ref hybrid_scheduling_policy.h): prefer the local node
    while its critical utilization stays under `spread_threshold`; otherwise
    pick uniformly among the top-k least-utilized nodes that fit. This
    approximates bin-packing at low load and spreads at high load.
    """
    rng = rng or random
    alive = view.alive_nodes()
    if not alive:
        return None

    if strategy == "node_affinity" and affinity_node_id is not None:
        n = view.nodes.get(affinity_node_id)
        if n is not None and n.alive and rs.fits(n.available, demand):
            return n
        if not affinity_soft:
            return None
        strategy = "hybrid"

    fitting = [n for n in alive if rs.fits(n.available, demand)]
    if not fitting:
        return None

    def rank(n: NodeView):
        # Primary: least utilized. Tie-breaks come from the synced view:
        # shorter queued backlog, then a warm (idle) worker already
        # booted — landing there turns the spawn into a pool pop.
        return (rs.utilization(n.total, n.available, demand),
                len(n.queued), -n.idle_workers)

    if strategy == "spread":
        # Least utilized first => round-robin-ish spread under churn.
        fitting.sort(key=rank)
        return fitting[0]

    # hybrid
    if local_node_id is not None:
        local = view.nodes.get(local_node_id)
        if (local is not None and local.alive
                and rs.fits(local.available, demand)
                and rs.utilization(local.total, local.available,
                                   demand) < spread_threshold):
            return local
    fitting.sort(key=rank)
    k = max(1, int(len(fitting) * top_k_fraction))
    return rng.choice(fitting[:k])


def pick_feasible_node(view: ClusterView, demand: rs.ResourceSet,
                       exclude: Optional[str] = None) -> Optional[NodeView]:
    """A node whose TOTAL resources could ever satisfy `demand`, preferring
    one that fits right now. Used to forward never-runnable-here requests to
    a node where they can queue (ref: the reference parks infeasible tasks
    in the owning raylet's queue, cluster_task_manager.h:42)."""
    candidates = [n for n in view.alive_nodes()
                  if n.node_id != exclude and rs.feasible(n.total, demand)]
    if not candidates:
        return None
    now = [n for n in candidates if rs.fits(n.available, demand)]
    pool = now or candidates
    pool.sort(key=lambda n: rs.utilization(n.total, n.available, demand))
    return pool[0]


# ---------------------------------------------------------------------------
# Placement group bundle placement (ref: policy/bundle_scheduling_policy.h)
# ---------------------------------------------------------------------------

def place_bundles(
    view: ClusterView,
    bundles: List[rs.ResourceSet],
    strategy: str,
    preplaced: Optional[List[Optional[str]]] = None,
    bundle_labels: Optional[List[Optional[Dict[str, str]]]] = None,
) -> Optional[List[Optional[str]]]:
    """Map each bundle to a node id, or None if unplaceable.

    PACK: minimize node count (all on one node if possible).
    SPREAD: spread across distinct nodes, best effort.
    STRICT_PACK: all bundles on a single node or fail — on TPU this is the
    slice-atomic gang (a pjit program's hosts must share an ICI domain).
    STRICT_SPREAD: each bundle on a distinct node or fail.

    `preplaced[i]` pins bundle i to a node it is ALREADY reserved on
    (bundle-granular gang repair: only the holes are placed; preplaced
    bundles' resources are not re-counted — the daemons subtracted them
    at reserve time). `bundle_labels[i]` is a soft per-bundle node-label
    preference (ICI-topology hint): matching nodes are tried first, but
    a non-matching node still satisfies the bundle.
    """
    alive = sorted(view.alive_nodes(),
                   key=lambda n: rs.utilization(n.total, n.available))
    if not alive:
        return None
    preplaced = preplaced or [None] * len(bundles)
    missing = [i for i, nid in enumerate(preplaced) if nid is None]
    if not missing:
        return list(preplaced)

    def try_fit_all_on(node: NodeView) -> bool:
        avail = dict(node.available)
        for i in missing:
            if not rs.fits(avail, bundles[i]):
                return False
            rs.subtract(avail, bundles[i])
        return True

    if strategy in ("PACK", "STRICT_PACK"):
        pinned = {nid for nid in preplaced if nid is not None}
        if strategy == "STRICT_PACK" and pinned:
            # The gang already lives on one node: holes must land there.
            n = view.nodes.get(next(iter(pinned)))
            if n is None or not n.alive or not try_fit_all_on(n):
                return None
            return [n.node_id if nid is None else nid for nid in preplaced]
        for n in alive:
            if try_fit_all_on(n):
                return [n.node_id if nid is None else nid
                        for nid in preplaced]
        if strategy == "STRICT_PACK":
            return None
        # PACK fallback: greedy first-fit over nodes.
        return _greedy(alive, bundles, prefer_distinct=False,
                       preplaced=preplaced, bundle_labels=bundle_labels)

    if strategy in ("SPREAD", "STRICT_SPREAD"):
        placement = _greedy(alive, bundles, prefer_distinct=True,
                            preplaced=preplaced,
                            bundle_labels=bundle_labels,
                            exclusive=(strategy == "STRICT_SPREAD"))
        if placement is None:
            return None
        if strategy == "STRICT_SPREAD" and len(set(placement)) != len(bundles):
            return None
        return placement

    raise ValueError(f"unknown placement strategy {strategy}")


def _labels_match(node: NodeView,
                  selector: Optional[Dict[str, str]]) -> bool:
    if not selector:
        return True
    return all(node.labels.get(k) == v for k, v in selector.items())


def _greedy(nodes: List[NodeView], bundles: List[rs.ResourceSet],
            prefer_distinct: bool,
            preplaced: Optional[List[Optional[str]]] = None,
            bundle_labels: Optional[List[Optional[Dict[str, str]]]] = None,
            exclusive: bool = False) -> Optional[List[Optional[str]]]:
    avail = {n.node_id: dict(n.available) for n in nodes}
    preplaced = preplaced or [None] * len(bundles)
    placement: List[Optional[str]] = list(preplaced)
    used_nodes: set = {nid for nid in preplaced if nid is not None}
    for i, b in enumerate(bundles):
        if placement[i] is not None:
            continue
        chosen = None
        sel = bundle_labels[i] if bundle_labels else None
        candidates = sorted(
            nodes, key=lambda n: (n.node_id in used_nodes
                                  if prefer_distinct else False,
                                  not _labels_match(n, sel),
                                  rs.utilization(n.total, avail[n.node_id])))
        for n in candidates:
            if exclusive and n.node_id in used_nodes:
                continue  # STRICT: preplaced/used nodes are off limits
            if rs.fits(avail[n.node_id], b):
                chosen = n
                break
        if chosen is None:
            return None
        rs.subtract(avail[chosen.node_id], b)
        used_nodes.add(chosen.node_id)
        placement[i] = chosen.node_id
    return placement
