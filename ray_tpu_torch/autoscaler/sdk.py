"""Autoscaler SDK, the port's copy of `ray_tpu/autoscaler/sdk.py`
(ref: python/ray/autoscaler/sdk/sdk.py —
request_resources: ask the autoscaler to size the cluster for a set of
bundles immediately, independent of current load)."""
from __future__ import annotations

from typing import Dict, List, Optional


def request_resources(num_cpus: Optional[int] = None,
                      bundles: Optional[List[Dict[str, float]]] = None
                      ) -> None:
    """Command the cluster to scale so these shapes could be placed.
    Replaces any previous request; request_resources(bundles=[]) clears."""
    import ray_tpu_torch.api as api

    out: List[Dict[str, float]] = []
    if num_cpus:
        out.append({"CPU": float(num_cpus)})
    if bundles:
        out.extend(dict(b) for b in bundles)
    worker = api._global_worker()
    worker.gcs.call("AutoscalerState", "request_resources",
                    bundles=out, timeout=30)
