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
  ``CUDA_VISIBLE_DEVICES``.

Nothing here probes the CUDA driver: `resources.py` counts the cards in a
time-boxed subprocess and passes the name in.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"

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


def visible_chip_env(chip_ids: List[int]) -> Dict[str, str]:
    """The env var that scopes a worker process to its granted GPUs."""
    return {VISIBLE_DEVICES_ENV: ",".join(str(i) for i in chip_ids)}

