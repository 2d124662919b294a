"""GPU host helpers: worker-side introspection + driver-side host gangs,
counterpart of `ray_tpu/util/tpu.py`.

A node's GPUs show in its resources as ``GPU`` (one per card) and, where
the card's model is known, ``accelerator_type:<model>`` (e.g.
``accelerator_type:H100``, `core/distributed/resources.py`). A host's index
in its gang of hosts is its ``GPU_WORKER_ID`` label, which the node daemon
takes from ``GPU_WORKER_ID`` in its environment
(`accelerators.get_worker_id`).

Each function of the JAX module and its counterpart here:

- ``get_current_pod_name`` -> none. It names the TPU slice a host belongs
  to (``TPU_NAME``); GPU hosts form no named slice, so there is nothing to
  return.
- ``get_current_pod_worker_count`` -> none. A TPU host reads its slice's
  host count from its pod type; a GPU host has no such type. The driver
  counts GPU hosts with `list_hosts`.
- ``get_num_tpu_chips_on_node`` -> `get_num_gpus_on_node`; beside it
  `get_current_accelerator_type` and `get_current_worker_id`.
- ``TpuSlice`` and ``list_slices(pod_type)`` -> `GpuHost` and
  `list_hosts(accelerator_type)`: one entry per alive node with cards.
- ``reserve_slice(pod_type, ...)`` -> `reserve_hosts(num_hosts, ...)`:
  a `gpu_host_placement_group` (one bundle per host, STRICT_SPREAD), held
  by a `GangReservation` (``SliceReservation`` there).
"""
from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.core.distributed import accelerators
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    gpu_host_placement_group,
    remove_placement_group,
)

ACCELERATOR_PREFIX = "accelerator_type:"


def _node_resources() -> Optional[dict]:
    """The resources of the node this process runs on, from the cluster
    view, or None when not connected."""
    import ray_tpu_torch

    try:
        node_id = ray_tpu_torch.get_runtime_context().get_node_id()
        for n in ray_tpu_torch.nodes():
            if n["NodeID"] == node_id:
                return n["Resources"]
    except Exception:  # noqa: BLE001 — not connected
        pass
    return None


def _accelerator_of(resources: dict) -> Optional[str]:
    return next((k[len(ACCELERATOR_PREFIX):] for k in resources
                 if k.startswith(ACCELERATOR_PREFIX)), None)


# ---------------------------------------------------------------------------
# worker-side introspection (runs inside a task/actor on a GPU host)
# ---------------------------------------------------------------------------

def get_num_gpus_on_node() -> int:
    """GPUs on THIS host: its ``GPU`` resource, else a local probe."""
    res = _node_resources()
    if res is not None:
        return int(res.get("GPU", 0))
    try:
        from ray_tpu_torch.core.distributed.resources import probe_gpu_count

        return int(probe_gpu_count())
    except Exception:  # noqa: BLE001
        return 0


def get_current_accelerator_type() -> Optional[str]:
    """The card model this host advertises ("H100"), else None."""
    res = _node_resources()
    if res is not None:
        return _accelerator_of(res)
    from ray_tpu_torch.core.distributed.resources import probe_gpu_name

    return accelerators.accelerator_type(probe_gpu_name())


def get_current_worker_id() -> Optional[int]:
    """This host's index in its gang of GPU hosts (``GPU_WORKER_ID``), or
    None."""
    return accelerators.get_worker_id()


# ---------------------------------------------------------------------------
# driver-side host discovery + atomic reservation
# ---------------------------------------------------------------------------

class GpuHost:
    """One discovered GPU host: its node, card model and card count."""

    def __init__(self, node_id: str, accelerator_type: Optional[str],
                 num_gpus: float):
        self.node_id = node_id
        self.accelerator_type = accelerator_type
        self.num_gpus = num_gpus

    def __repr__(self) -> str:
        return (f"GpuHost({self.node_id[:12]}, {self.accelerator_type}, "
                f"{self.num_gpus:g} GPUs)")


def list_hosts(accelerator_type: Optional[str] = None) -> List[GpuHost]:
    """Every alive node with cards (of `accelerator_type`, if given)."""
    import ray_tpu_torch

    hosts = []
    for n in ray_tpu_torch.nodes():
        gpus = float(n["Resources"].get("GPU", 0))
        if not n["Alive"] or gpus <= 0:
            continue
        model = _accelerator_of(n["Resources"])
        if accelerator_type is not None and model != accelerator_type:
            continue
        hosts.append(GpuHost(n["NodeID"], model, gpus))
    return hosts


class GangReservation:
    """Holds a reserved host gang; schedule its members into `pg`'s
    bundles (bundle i for rank i, on `hosts[i]`)."""

    def __init__(self, hosts: List[GpuHost], pg: PlacementGroup):
        self.hosts = hosts
        self.pg = pg

    def release(self) -> None:
        remove_placement_group(self.pg)


def reserve_hosts(num_hosts: int, gpus_per_host: int = 1,
                  accelerator_type: Optional[str] = None,
                  timeout: float = 60.0, cpus_per_host: float = 1.0,
                  topology: Optional[str] = None) -> GangReservation:
    """Reserve `num_hosts` GPU hosts at once, `gpus_per_host` cards each
    (of `accelerator_type`, if given).

    The gang is a `gpu_host_placement_group` (one bundle per host,
    STRICT_SPREAD), so its own bundles lie on different hosts. Two gangs
    exclude each other from a host only when a bundle takes all of that
    host's cards (`gpus_per_host` equal to the host's count): then a
    second reservation waits until the first is released. With fewer,
    two gangs can share a host. A reservation not placed within `timeout`
    raises TimeoutError."""
    import time as _time

    from ray_tpu_torch.api import _global_worker

    deadline = _time.monotonic() + timeout
    pg = gpu_host_placement_group(num_hosts, gpus_per_host=gpus_per_host,
                                  cpus_per_host=cpus_per_host,
                                  topology=topology,
                                  accelerator_type=accelerator_type)
    if not pg.ready(timeout=max(0.5, deadline - _time.monotonic())):
        remove_placement_group(pg)
        raise TimeoutError(f"could not reserve {num_hosts} GPU hosts of "
                           f"{gpus_per_host} GPUs in {timeout}s")
    placed = _global_worker().get_placement_group(pg.id)["nodes"]
    by_node = {h.node_id: h for h in list_hosts()}
    return GangReservation([by_node[n] for n in placed], pg)
