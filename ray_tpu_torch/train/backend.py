"""Distributed-training backends, counterpart of `ray_tpu/train/backend.py`.

The JAX package's `JaxBackend` wires the JAX coordination service; here
`TorchBackend` takes its place and wires a torch.distributed process
group: rank 0's address is the rendezvous, every worker calls
`on_start`, and after that `parallel.build_mesh` lays a DeviceMesh over
the group. NCCL carries CUDA tensors, gloo CPU ones.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist


class Backend:
    """Hook interface: the environment a worker group hands its workers,
    and what each does at start and shutdown.

    `master_env` receives rank-0's (ip, port) with the port probed on
    rank-0's own host — a port free on the driver may be taken on the
    worker's host.
    """

    def master_env(self, master_ip: str, master_port: int) -> Dict[str, str]:
        return {}

    def on_start(self, rank: int, world_size: int,
                 master_env: Dict[str, str]) -> None:
        pass

    def on_shutdown(self) -> None:
        pass


class TorchBackend(Backend):
    """A torch.distributed process group across the workers: NCCL (with
    gloo for CPU tensors) and one card per rank when `device` is CUDA (the
    card the rank's lease granted), gloo alone on the CPU."""

    def __init__(self, device: str = "cuda"):
        self.device = torch.device(device).type

    def master_env(self, master_ip: str, master_port: int) -> Dict[str, str]:
        return {"MASTER_ADDR": master_ip, "MASTER_PORT": str(master_port)}

    def on_start(self, rank, world_size, master_env) -> None:
        if dist.is_initialized():
            return
        init = f"tcp://{master_env['MASTER_ADDR']}:{master_env['MASTER_PORT']}"
        if self.device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("TorchBackend(device='cuda'): no CUDA device")
            # The card this worker sees: its lease's, which the node
            # daemon scoped CUDA_VISIBLE_DEVICES to, so it is cuda:0 here
            # whatever the card's id on the host.
            card = torch.device("cuda", 0)
            torch.cuda.set_device(card)
            dist.init_process_group("cpu:gloo,cuda:nccl", init_method=init,
                                    rank=rank, world_size=world_size,
                                    device_id=card)
        else:
            dist.init_process_group("gloo", init_method=init, rank=rank,
                                    world_size=world_size)

    def on_shutdown(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


BACKENDS = {"torch": TorchBackend, None: Backend}


def resolve_backend(name: Optional[str]) -> Backend:
    if isinstance(name, Backend):
        return name
    cls = BACKENDS.get(name)
    if cls is None:
        raise ValueError(f"unknown backend {name!r}; one of {list(BACKENDS)}")
    return cls()
