"""GPU accelerator manager: the card's model and per-worker visibility,
counterpart of `ray_tpu/core/distributed/accelerators.py` (TPU topology
there).

Behaviour parity with the reference's NVIDIAGPUAcceleratorManager
(ref: python/ray/_private/accelerators/nvidia_gpu.py):

- the accelerator type is the model parsed from the device name
  ("NVIDIA H100 80GB HBM3" -> "H100"), advertised as the resource
  ``accelerator_type:H100`` that ``accelerator_type=`` demands target;
- a task or actor asks for a fraction of one GPU (up to 1) or a whole
  number of them;
- a worker granted GPU ids sees exactly those through
  ``CUDA_VISIBLE_DEVICES``: the node daemon grants ids from its
  `ChipAllocator` with each lease and starts (or forks) the lease's worker
  with `visible_chip_env` of them, before anything in it touches CUDA.

Nothing here probes the CUDA driver: `resources.py` counts the cards in a
time-boxed subprocess and passes the name in.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
# A GPU host's index within its gang of hosts, the counterpart of a TPU
# host's ``TPU_WORKER_ID``: set by whoever starts the node.
WORKER_ID_ENV = "GPU_WORKER_ID"

# "<vendor> <MODEL>...": the model is the second word, up to a non
# alphanumeric ("Tesla V100-SXM2-16GB" -> "V100").
_GPU_NAME_RE = re.compile(r"\w+\s+([A-Z0-9]+)")


def accelerator_type(device_name: Optional[str]) -> Optional[str]:
    """The model in a CUDA device name, or None if there is none."""
    match = _GPU_NAME_RE.match(device_name or "")
    return match.group(1) if match else None


def gpu_extra_resources(device_name: Optional[str]) -> Dict[str, float]:
    """``{"accelerator_type:<model>": 1}`` for a node whose cards are named
    `device_name`, or nothing when the model is unknown."""
    model = accelerator_type(device_name)
    return {f"accelerator_type:{model}": 1.0} if model else {}


def validate_chip_request(quantity: float) -> Tuple[bool, Optional[str]]:
    """A GPU request is a fraction of one card (0 < q <= 1) or a whole count
    (ref: nvidia_gpu.py, fractional GPUs)."""
    if 0 < quantity <= 1 or (quantity > 1 and float(quantity).is_integer()):
        return True, None
    return False, (
        f"Requested GPU={quantity}; a request is a fraction of one GPU (up "
        f"to 1) or a whole number of GPUs")


def visible_chip_env(chip_ids: Sequence) -> Dict[str, str]:
    """The env var that scopes a worker process to its granted GPUs."""
    return {VISIBLE_DEVICES_ENV: ",".join(str(i) for i in chip_ids)}


def get_worker_id() -> Optional[int]:
    """This host's index in its gang of GPU hosts: ``GPU_WORKER_ID``, or
    None (a host that was not given one). The node daemon labels itself
    ``GPU_WORKER_ID`` with it, which the bundles of
    `util.placement_group.gpu_host_placement_group` prefer."""
    raw = os.environ.get(WORKER_ID_ENV, "").strip()
    try:
        return int(raw) if raw else None
    except ValueError:
        return None


def granted_chip_ids() -> List[int]:
    """The GPU ids ``CUDA_VISIBLE_DEVICES`` lists: the daemon sets it to a
    GPU lease's cards; a process without one lists what its node's own
    environment sets (usually nothing: empty)."""
    value = os.environ.get(VISIBLE_DEVICES_ENV, "")
    return [int(x) for x in value.split(",") if x.strip().isdigit()]


class ChipAllocator:
    """Which cards of a node each lease holds (ref: the raylet's GPU
    instance accounting, resource_instance_set.h). Each card has a share
    of 1.0: a request up to 1 takes that much of one card (fractional
    leases share it), a whole count takes that many free cards. An id is
    never granted beyond its share, and `release` gives it back."""

    EPS = 1e-9

    def __init__(self, count: int = 0):
        self.free = [1.0] * int(count)

    def acquire(self, quantity: float,
                prefer: Iterable[Sequence[int]] = ()
                ) -> Optional[Tuple[int, ...]]:
        """Ids for a request of `quantity` GPUs (empty for none), or None
        when no card set fits. A `prefer`red set that fits wins (the ids
        an idle worker already sees), then the lowest ids."""
        q = float(quantity or 0.0)
        if q <= self.EPS:
            return ()
        need = 1 if q <= 1 else int(round(q))
        share = min(q, 1.0)

        def fits(ids) -> bool:
            return (len(ids) == need and len(set(ids)) == need
                    and all(0 <= i < len(self.free)
                            and self.free[i] + self.EPS >= share
                            for i in ids))

        chosen = next((tuple(ids) for ids in prefer if fits(ids)), None)
        if chosen is None:
            ids = [i for i, f in enumerate(self.free)
                   if f + self.EPS >= share][:need]
            chosen = tuple(ids) if fits(ids) else None
        if chosen is not None:
            for i in chosen:
                self.free[i] -= share
        return chosen

    def release(self, ids: Sequence[int], quantity: float) -> None:
        share = min(float(quantity or 0.0), 1.0)
        for i in ids:
            if 0 <= i < len(self.free):
                self.free[i] = min(1.0, self.free[i] + share)
