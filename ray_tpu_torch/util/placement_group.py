"""Placement groups: gang resource reservation, counterpart of
`ray_tpu/util/placement_group.py`.

Analogue of the reference API (ref: python/ray/util/placement_group.py —
placement_group() :145, PlacementGroup handle :41; strategies
PACK/SPREAD/STRICT_PACK/STRICT_SPREAD). The local engine keeps records and
creates a group at once; the multi-process runtime reserves the bundles
through the GCS. `gpu_host_placement_group` is the counterpart of the JAX
package's slice-atomic `tpu_slice_placement_group`: one bundle per GPU
host, ordered by `ici_snake_order` over the hosts' `GPU_WORKER_ID` labels.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.core.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID,
                 bundles: List[Dict[str, float]], strategy: str):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self, timeout: Optional[float] = None) -> bool:
        """Block until reserved (or timeout); returns created-ness.

        Long-polls the GCS (wait_pg, same pattern as actor resolution):
        the reply arrives on the gang's next state TRANSITION, so a
        pending gang costs one parked RPC per ~2s instead of a 50ms
        polling loop per waiting driver."""
        from ray_tpu_torch.api import _global_worker

        worker = _global_worker()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                info = worker.get_placement_group(self.id)
                return info is not None and info["state"] == "CREATED"
            park = 2.0 if remaining is None else min(2.0, remaining)
            info = worker.wait_placement_group(
                self.id, known_state="PENDING", park_s=park)
            if info is not None and info["state"] == "CREATED":
                return True
            if info is None or info["state"] == "REMOVED":
                return False

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout=timeout_seconds)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs, self.strategy))


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: Optional[str] = None,
                    lifetime: Optional[str] = None,
                    bundle_labels: Optional[List[Optional[Dict[
                        str, str]]]] = None) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be non-empty resource dicts")
    from ray_tpu_torch.api import _global_worker

    worker = _global_worker()
    pg_id = PlacementGroupID.generate()
    worker.create_placement_group(
        pg_id, [dict(b) for b in bundles], strategy, name=name,
        detached=(lifetime == "detached"), bundle_labels=bundle_labels)
    return PlacementGroup(pg_id, [dict(b) for b in bundles], strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    from ray_tpu_torch.api import _global_worker

    _global_worker().remove_placement_group(pg.id)


def placement_group_table() -> List[dict]:
    from ray_tpu_torch.api import _global_worker

    return _global_worker().list_placement_groups()


def ici_snake_order(num_hosts: int,
                    topology: Optional[str] = None) -> List[int]:
    """Bundle index -> host worker id, snaking through the host grid.

    A program's collectives run fastest when consecutive ranks are
    neighbours; a boustrophedon walk of the host grid keeps every
    adjacent pair one hop apart. `topology` is the host grid as "XxY"
    (e.g. "4x4"); None or a 1-D grid degrades to identity."""
    if not topology or "x" not in topology:
        return list(range(num_hosts))
    try:
        dims = [int(d) for d in topology.lower().split("x")]
    except ValueError:
        return list(range(num_hosts))
    cols = dims[0]
    rows = max(1, num_hosts // cols) if cols else 1
    order: List[int] = []
    for r in range(rows):
        row = list(range(r * cols, min((r + 1) * cols, num_hosts)))
        order.extend(reversed(row) if r % 2 else row)
    order.extend(range(len(order), num_hosts))  # ragged tail
    return order[:num_hosts]


def gpu_host_placement_group(
        num_hosts: int, gpus_per_host: int = 8,
        cpus_per_host: float = 1.0,
        topology: Optional[str] = None,
        bundle_order: Optional[Callable[[int, Optional[str]],
                                        List[int]]] = None,
        accelerator_type: Optional[str] = None
) -> PlacementGroup:
    """A host-atomic GPU gang: one bundle of `{"CPU": cpus_per_host,
    "GPU": gpus_per_host}` per host, STRICT_SPREAD across hosts (the
    counterpart of the JAX package's `tpu_slice_placement_group`).

    `topology`/`bundle_order` pick the bundle ordering: bundle i carries
    a soft label preference for the host whose `GPU_WORKER_ID` label
    (the node daemon sets it from `GPU_WORKER_ID` in its environment) is
    order[i], so rank i of the gang lands beside rank i±1 in the host
    grid (snake order by default; pass `bundle_order`
    for other wirings). The preference is soft: placement still
    succeeds on clusters without GPU_WORKER_ID labels. With
    `accelerator_type` ("H100"), each bundle also asks for that card model,
    as a task's ``accelerator_type=`` option does."""
    order = (bundle_order(num_hosts, topology) if bundle_order is not None
             else ici_snake_order(num_hosts, topology))
    if sorted(order) != list(range(num_hosts)):
        raise ValueError(f"bundle_order must permute 0..{num_hosts - 1}, "
                         f"got {order}")
    bundle = {"CPU": cpus_per_host, "GPU": float(gpus_per_host)}
    if accelerator_type:
        bundle[f"accelerator_type:{accelerator_type}"] = 0.001
    bundles = [dict(bundle) for _ in range(num_hosts)]
    labels = [{"GPU_WORKER_ID": str(order[i])} for i in range(num_hosts)]
    return placement_group(bundles, strategy="STRICT_SPREAD",
                           bundle_labels=labels)
