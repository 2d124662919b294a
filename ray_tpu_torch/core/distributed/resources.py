"""Resource sets and node resource accounting, counterpart of
`ray_tpu/core/distributed/resources.py` with GPUs in place of TPUs.

Analogue of the reference's scheduling resources (ref: src/ray/common/
scheduling/resource_set.h, cluster_resource_data.h). Resources are
name→float maps ("CPU", "GPU", "memory", custom labels, and
"accelerator_type:<model>" as the reference's NVIDIA accelerator manager
advertises it, ref: _private/accelerators/nvidia_gpu.py).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

ResourceSet = Dict[str, float]

EPS = 1e-9


def fits(available: ResourceSet, demand: ResourceSet) -> bool:
    for k, v in demand.items():
        if v > EPS and available.get(k, 0.0) + EPS < v:
            return False
    return True


def feasible(total: ResourceSet, demand: ResourceSet) -> bool:
    """Could the demand EVER fit on a node with these total resources?"""
    return fits(total, demand)


def subtract(avail: ResourceSet, demand: ResourceSet) -> None:
    for k, v in demand.items():
        if v > EPS:
            avail[k] = avail.get(k, 0.0) - v


def add(avail: ResourceSet, demand: ResourceSet) -> None:
    for k, v in demand.items():
        if v > EPS:
            avail[k] = avail.get(k, 0.0) + v


def utilization(total: ResourceSet, available: ResourceSet,
                demand: Optional[ResourceSet] = None) -> float:
    """Critical-resource utilization in [0,1]: the max over resource types
    the demand cares about (all types if demand is None). Matches the
    reference's best-node scoring input (ref: policy/scheduling_options.h)."""
    worst = 0.0
    keys = demand.keys() if demand else total.keys()
    for k in keys:
        t = total.get(k, 0.0)
        if t <= EPS:
            continue
        used = t - available.get(k, 0.0)
        worst = max(worst, used / t)
    return worst


_gpu_probe_cache: Optional[Tuple[int, str]] = None


def run_gpu_probe(timeout_s: float) -> Tuple[int, str, str]:
    """Time-boxed subprocess probe: (gpu_count, device 0's name,
    diagnostics)."""
    import subprocess
    import sys

    code = ("import torch\n"
            "n = torch.cuda.device_count()\n"
            "print('GPUCOUNT=%d' % n)\n"
            "print('GPUNAME=' + (torch.cuda.get_device_name(0) if n else ''))\n")
    try:
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=timeout_s)
        found = dict(line.split("=", 1) for line in out.stdout.splitlines()
                     if line.startswith(("GPUCOUNT=", "GPUNAME=")))
        if "GPUCOUNT" in found:
            return (int(found["GPUCOUNT"]), found.get("GPUNAME", ""),
                    out.stdout.strip())
        return 0, "", (out.stderr or out.stdout).strip()[-500:]
    except subprocess.TimeoutExpired:
        return 0, "", f"probe timed out after {timeout_s}s (driver init hang)"
    except (OSError, ValueError) as e:
        return 0, "", f"probe failed: {e}"


def probe_gpus(timeout_s: Optional[float] = None) -> Tuple[int, str]:
    """(local GPU count, device 0's name), WITHOUT ever blocking the caller.

    `torch.cuda.device_count()` initialises the driver, which can hang when
    it is wedged, so the probe runs in a *time-boxed subprocess*: on timeout
    or error the answer is 0 and the control plane stays alive.

    Overrides (checked in order):
      - RAY_TPU_NUM_GPUS: trust the operator, skip probing (name unknown).
      - RAY_TPU_DISABLE_GPU_DETECTION=1: always 0.
      - CUDA_VISIBLE_DEVICES set empty in our env: always 0 (test/CI mode).
    """
    global _gpu_probe_cache
    import os

    forced = os.environ.get("RAY_TPU_NUM_GPUS")
    if forced is not None:
        return int(float(forced)), ""
    if os.environ.get("RAY_TPU_DISABLE_GPU_DETECTION", "").lower() in (
            "1", "true", "yes"):
        return 0, ""
    if os.environ.get("CUDA_VISIBLE_DEVICES", None) == "":
        return 0, ""
    if _gpu_probe_cache is not None:
        return _gpu_probe_cache
    if timeout_s is None:
        timeout_s = float(os.environ.get("RAY_TPU_GPU_DETECT_TIMEOUT_S", "30"))

    count, name, _ = run_gpu_probe(timeout_s)
    _gpu_probe_cache = (count, name)
    return _gpu_probe_cache


def probe_gpu_count(timeout_s: Optional[float] = None) -> int:
    """Count local GPUs without ever blocking the caller (`probe_gpus`)."""
    return probe_gpus(timeout_s)[0]


def detect_node_resources(num_cpus: Optional[float] = None,
                          num_gpus: Optional[float] = None,
                          memory: Optional[int] = None,
                          custom: Optional[ResourceSet] = None) -> ResourceSet:
    """Autodetect this host's resources: GPUs via a time-boxed probe, and
    the card's model as an ``accelerator_type:<model>`` resource (e.g.
    ``accelerator_type:H100``, ref: nvidia_gpu.py's name parsing)."""
    import os

    from ray_tpu_torch.core.distributed.accelerators import gpu_extra_resources

    res: ResourceSet = {}
    res["CPU"] = float(num_cpus if num_cpus is not None
                       else (os.cpu_count() or 1))
    if num_gpus is not None:
        n, name = float(num_gpus), ""
    else:
        count, name = probe_gpus()
        n = float(count)
    if n > 0:
        res["GPU"] = n
        res.update(gpu_extra_resources(name))
    if memory is None:
        try:
            import psutil

            memory = int(psutil.virtual_memory().total * 0.7)
        except Exception:
            memory = 8 << 30
    res["memory"] = float(memory)
    if custom:
        res.update(custom)
    return res
