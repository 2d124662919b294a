"""Parallelism substrate of the port (counterpart of `ray_tpu.parallel`):
a `DeviceMesh` with the JAX package's axis names, the logical sharding
rules laid out as DTensor placements, and collectives over named mesh
dims on torch.distributed (NCCL on the card, gloo on the CPU). The GPipe
pipeline is `ray_tpu_torch.parallel.pipeline`, imported on its own: it
builds on `ray_tpu_torch.models`, which imports this package."""
from ray_tpu_torch.parallel.mesh import (
    MeshConfig,
    build_mesh,
    local_mesh,
    mesh_shape_for,
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_TENSOR,
    AXIS_SEQ,
    AXIS_EXPERT,
)
from ray_tpu_torch.parallel.sharding import (
    LogicalRules,
    DEFAULT_RULES,
    DDP_RULES,
    TP_RULES,
    logical_to_mesh,
    shard_pytree,
    with_logical_constraint,
    param_shardings,
)
from ray_tpu_torch.parallel.collectives import (
    all_gather,
    all_to_all,
    pmean,
    ppermute_ring,
    psum,
    psum_scatter,
)

__all__ = [
    "MeshConfig",
    "build_mesh",
    "local_mesh",
    "mesh_shape_for",
    "AXIS_DATA",
    "AXIS_FSDP",
    "AXIS_TENSOR",
    "AXIS_SEQ",
    "AXIS_EXPERT",
    "LogicalRules",
    "DEFAULT_RULES",
    "DDP_RULES",
    "TP_RULES",
    "logical_to_mesh",
    "shard_pytree",
    "with_logical_constraint",
    "param_shardings",
    "psum",
    "pmean",
    "all_gather",
    "psum_scatter",
    "all_to_all",
    "ppermute_ring",
]
