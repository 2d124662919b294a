"""Device meshes over torch.distributed, counterpart of
`ray_tpu/parallel/mesh.py`.

The five axis names, `MeshConfig.resolve` and the canonical order are the
JAX package's. `build_mesh` returns a `DeviceMesh` whose dims carry those
names, over the ranks of the default process group: one rank per device,
as torch.distributed runs it. In a process with no group it starts a
world-1 group itself (NCCL for CUDA tensors, gloo for CPU ones), so one
process needs no rendezvous address.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# Canonical axis names, outermost to innermost.
AXIS_DATA = "dp"      # pure data parallel: gradients summed only
AXIS_FSDP = "fsdp"    # data parallel with parameter sharding (ZeRO-3)
AXIS_EXPERT = "ep"    # MoE expert parallel
AXIS_SEQ = "sp"       # sequence/context parallel
AXIS_TENSOR = "tp"    # tensor (Megatron) parallel

_CANONICAL_ORDER = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_SEQ, AXIS_TENSOR)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each parallelism axis.  -1 on at most one axis means
    "absorb all remaining devices" (like torch's device_mesh -1)."""

    dp: int = 1
    fsdp: int = -1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {AXIS_DATA: self.dp, AXIS_FSDP: self.fsdp,
                 AXIS_EXPERT: self.ep, AXIS_SEQ: self.sp, AXIS_TENSOR: self.tp}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} wants {fixed} devices but {n_devices} are available")
        return sizes


def mesh_shape_for(n_devices: int, config: MeshConfig | None = None) -> dict[str, int]:
    return (config or MeshConfig()).resolve(n_devices)


def _start_world_group(device_type: str) -> None:
    """A world-1 process group for this process alone. On CUDA it holds
    both backends (CPU tensors over gloo, CUDA tensors over NCCL), so a
    "cpu" mesh can sit beside a "cuda" one; NCCL starts eagerly, and a
    failed start raises here."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_mesh(device_type='cuda') needs a CUDA device and none "
                "is available; pass device_type='cpu' to run on the CPU")
        dist.init_process_group(
            "cpu:gloo,cuda:nccl", store=dist.HashStore(), rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
    elif device_type == "cpu":
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        raise ValueError(f"device_type {device_type!r}: expected 'cuda' or 'cpu'")


def ensure_group(device_type: str) -> None:
    """The default process group, started as a world-1 group for this
    process when there is none; raises for CUDA without a device."""
    if not dist.is_initialized():
        _start_world_group(device_type)
    elif device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh with device_type='cuda' needs a CUDA device")


def build_mesh(
    config: MeshConfig | None = None,
    *,
    device_type: str = "cuda",
    axis_order: Sequence[str] = _CANONICAL_ORDER,
    n_ranks: int | None = None,
) -> DeviceMesh:
    """A DeviceMesh over every rank of the default process group, or its
    first `n_ranks` (as JAX builds one over the first devices), its dims
    named and ordered by `axis_order`, sized by `config` (all ranks on
    fsdp by default). Rank r sits at the row-major position r, as
    `np.reshape` lays JAX's devices out on a flat topology. Every rank must
    call it; a rank past `n_ranks` is in no position of the mesh
    (`get_coordinate()` is None)."""
    ensure_group(device_type)
    world = dist.get_world_size()
    n = world if n_ranks is None else n_ranks
    if n > world:
        raise ValueError(f"a mesh of {n} ranks over a group of {world}")
    sizes = mesh_shape_for(n, config)
    shape = tuple(sizes[a] for a in axis_order)
    if n == world:
        return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_order))
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_order))


def local_mesh(n: int | None = None, *, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D fsdp mesh; `n`, when given, must be the world size."""
    mesh = build_mesh(MeshConfig(fsdp=-1), device_type=device_type)
    if n is not None and n != mesh.size():
        raise ValueError(f"local_mesh({n}): the process group has "
                         f"{mesh.size()} ranks")
    return mesh


def mesh_axis_sizes(mesh: DeviceMesh) -> Mapping[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_rows(n_rows: int, sizes: Mapping[str, int],
               coordinate: Mapping[str, int], axes: Sequence[str]) -> slice:
    """The rows of a global batch of `n_rows` that a rank at `coordinate`
    holds when the batch splits over the mesh `axes`, the first outermost
    (as PartitionSpec(("dp", "fsdp")) splits it)."""
    shards = math.prod(sizes[a] for a in axes)
    if n_rows % shards:
        raise ValueError(f"a batch of {n_rows} rows does not split over "
                         f"{dict((a, sizes[a]) for a in axes)}")
    index = 0
    for a in axes:
        index = index * sizes[a] + coordinate[a]
    per = n_rows // shards
    return slice(index * per, (index + 1) * per)


def local_batch_rows(mesh: DeviceMesh, n_rows: int, axes: Sequence[str]) -> slice:
    """`batch_rows` for this rank of `mesh`."""
    return batch_rows(n_rows, mesh_axis_sizes(mesh),
                      dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())), axes)
