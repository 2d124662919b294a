"""Pure scaling arithmetic: what to launch for the pending demand. The
port's copy of `ray_tpu/autoscaler/binpack.py`.

Analogue of the reference autoscaler v2 resource scheduler
(ref: python/ray/autoscaler/v2/scheduler.py — ResourceDemandScheduler:
bin-pack pending demand onto existing + to-be-launched node shapes). Pure
functions over plain dicts so the planner is unit-testable without any
cluster (the reference tests its scheduler the same way).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core.distributed import resources as rs


@dataclasses.dataclass
class _Slot:
    """One placement target while planning: an existing node's spare
    capacity, a booting instance's full shape, or a node we decide to
    launch."""
    avail: rs.ResourceSet
    spread_groups: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class ScalingPlan:
    to_launch: Dict[str, int]          # node type -> count
    infeasible: List[rs.ResourceSet]   # demand no allowed type can hold


def _expand_pg_demands(pending_pgs: List[dict]
                       ) -> List[Tuple[rs.ResourceSet, Optional[int]]]:
    """Turn pending placement groups into (bundle, spread_group) demands.

    STRICT_PACK gangs (a GPU host gang) must land on ONE node,
    so they collapse to a single summed bundle; STRICT_SPREAD bundles
    carry a group id so the packer keeps them on distinct slots.
    """
    out: List[Tuple[rs.ResourceSet, Optional[int]]] = []
    for gid, pg in enumerate(pending_pgs):
        bundles = pg.get("bundles", [])
        strategy = pg.get("strategy", "PACK")
        if strategy == "STRICT_PACK":
            merged: rs.ResourceSet = {}
            for b in bundles:
                rs.add(merged, b)
            if merged:
                out.append((merged, None))
        elif strategy == "STRICT_SPREAD":
            out.extend((dict(b), gid) for b in bundles)
        else:  # PACK / SPREAD may share or split nodes freely
            out.extend((dict(b), None) for b in bundles)
    return out


def _first_fit(slots: List[_Slot], demand: rs.ResourceSet,
               spread_group: Optional[int]) -> bool:
    for slot in slots:
        if spread_group is not None and spread_group in slot.spread_groups:
            continue
        if rs.fits(slot.avail, demand):
            rs.subtract(slot.avail, demand)
            if spread_group is not None:
                slot.spread_groups.add(spread_group)
            return True
    return False


def plan_scaling(
    node_types: Dict[str, dict],
    *,
    running: List[rs.ResourceSet],
    pending_types: List[str],
    demands: Optional[List[rs.ResourceSet]] = None,
    pending_pgs: Optional[List[dict]] = None,
    resource_requests: Optional[List[rs.ResourceSet]] = None,
    type_counts: Optional[Dict[str, int]] = None,
    totals: Optional[List[rs.ResourceSet]] = None,
) -> ScalingPlan:
    """Decide how many nodes of each type to launch.

    node_types[name] needs "resources" (the shape one instance adds) and
    "max_workers"; `running` is each live node's *available* resources;
    `pending_types` are instances already launching (their full shape
    counts as future capacity); `demands` are queued task/actor shapes;
    `resource_requests` are explicit sdk targets packed against cluster
    *totals* (`totals`) rather than current availability.
    """
    demands = demands or []
    pending_pgs = pending_pgs or []
    resource_requests = resource_requests or []
    counts: Dict[str, int] = dict(type_counts or {})
    for t in pending_types:
        counts.setdefault(t, 0)

    to_launch: Dict[str, int] = {}
    infeasible: List[rs.ResourceSet] = []

    def open_node(demand: rs.ResourceSet) -> Optional[_Slot]:
        """Launch-decide one more node able to hold `demand`; smallest
        sufficient shape first so we don't burn GPU hosts on CPU work."""
        candidates = sorted(
            node_types.items(),
            key=lambda kv: sum(kv[1].get("resources", {}).values()))
        for name, cfg in candidates:
            shape = cfg.get("resources", {})
            limit = cfg.get("max_workers", 0)
            if not rs.fits(shape, demand):
                continue
            if counts.get(name, 0) + to_launch.get(name, 0) >= limit:
                continue
            to_launch[name] = to_launch.get(name, 0) + 1
            return _Slot(avail=dict(shape))
        return None

    def pack_all(demand_list: List[Tuple[rs.ResourceSet, Optional[int]]],
                 slots: List[_Slot]) -> None:
        # Largest demand first (first-fit-decreasing keeps fragmentation
        # low, same heuristic as the reference scheduler).
        for demand, group in sorted(demand_list,
                                    key=lambda d: -sum(d[0].values())):
            if not demand:
                continue
            if _first_fit(slots, demand, group):
                continue
            slot = open_node(demand)
            if slot is None:
                infeasible.append(demand)
                continue
            rs.subtract(slot.avail, demand)
            if group is not None:
                slot.spread_groups.add(group)
            slots.append(slot)

    # Phase 1: real queued demand vs current spare + booting capacity.
    slots = [_Slot(avail=dict(a)) for a in running]
    slots += [_Slot(avail=dict(node_types[t].get("resources", {})))
              for t in pending_types if t in node_types]
    work = [(dict(d), None) for d in demands]
    work += _expand_pg_demands(pending_pgs)
    pack_all(work, slots)

    # Phase 2: explicit resource_requests vs cluster TOTALS (they express
    # "keep the cluster at least this big", not "this much must be free
    # right now" — sdk.request_resources semantics).
    if resource_requests:
        total_slots = [_Slot(avail=dict(t)) for t in (totals or running)]
        total_slots += [_Slot(avail=dict(node_types[t].get("resources", {})))
                        for t in pending_types if t in node_types]
        for name, n in to_launch.items():
            shape = node_types[name].get("resources", {})
            total_slots += [_Slot(avail=dict(shape)) for _ in range(n)]
        pack_all([(dict(d), None) for d in resource_requests], total_slots)

    return ScalingPlan(to_launch=to_launch, infeasible=infeasible)


def fits_after_removal(
    totals: List[rs.ResourceSet],
    remove_idx: int,
    resource_requests: List[rs.ResourceSet],
) -> bool:
    """Would the explicit resource_requests still pack into the cluster
    totals if node `remove_idx` were terminated? Guards idle termination
    against violating a standing sdk.request_resources floor."""
    slots = [_Slot(avail=dict(t)) for i, t in enumerate(totals)
             if i != remove_idx]
    for demand in sorted(resource_requests, key=lambda d: -sum(d.values())):
        if not _first_fit(slots, demand, None):
            return False
    return True
