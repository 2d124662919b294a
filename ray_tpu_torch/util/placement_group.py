"""Placement groups: gang resource reservation, counterpart of
`ray_tpu/util/placement_group.py`.

Analogue of the reference API (ref: python/ray/util/placement_group.py —
placement_group() :145, PlacementGroup handle :41; strategies
PACK/SPREAD/STRICT_PACK/STRICT_SPREAD). The local engine keeps records and
creates a group at once; the multi-process runtime reserves the bundles
through the GCS. The slice-atomic gang (`tpu_slice_placement_group` in the
JAX package) and its GPU counterpart, a host-local GPU gang, are ROADMAP
queue A, item 10a-iv.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

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
