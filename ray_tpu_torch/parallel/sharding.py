"""Logical-axis sharding rules on DTensor, counterpart of
`ray_tpu/parallel/sharding.py`.

Parameters are annotated with logical axis names ("embed", "heads",
"mlp", "vocab", ...) and a rule table maps them to mesh axes, as in the
JAX package: swapping the table re-lays-out the model (DDP, FSDP, fsdp x
tp) with no model-code change. `logical_to_mesh` gives the same
PartitionSpec-shaped tuple as JAX's; `placements` turns it into one
`Shard(i)` or `Replicate()` per mesh dim, which `distribute_tensor` takes.

The model computes on local tensors: `gather_param` is where a parameter
leaves DTensor, gathered over the data dims just before use.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor, Partial, Placement, Replicate, Shard, distribute_tensor)

from ray_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_EXPERT, AXIS_FSDP, AXIS_SEQ, AXIS_TENSOR, mesh_axis_sizes)

# rule table: logical axis name -> mesh axis (or tuple of mesh axes, or None)
LogicalRules = Mapping[str, Any]

# The workhorse layout: batch over (dp, fsdp); params sharded over fsdp on
# their largest axis and over tp on the head/mlp axis; sequence over sp.
DEFAULT_RULES: LogicalRules = {
    "batch": (AXIS_DATA, AXIS_FSDP),
    "seq": AXIS_SEQ,
    "embed": AXIS_FSDP,
    "heads": AXIS_TENSOR,
    "kv_heads": AXIS_TENSOR,
    "head_dim": None,
    "mlp": AXIS_TENSOR,
    "vocab": AXIS_TENSOR,
    "expert": AXIS_EXPERT,
    "layers": None,
}

# Inference layout: params split over tp on their head/mlp/vocab axes,
# everything else replicated.
TP_RULES: LogicalRules = {
    "batch": None, "seq": None, "embed": None,
    "heads": AXIS_TENSOR, "kv_heads": AXIS_TENSOR, "head_dim": None,
    "mlp": AXIS_TENSOR, "vocab": AXIS_TENSOR, "expert": None,
    "layers": None,
}

# Pure data-parallel: replicate every parameter (DDP-equivalent).
DDP_RULES: LogicalRules = {
    "batch": (AXIS_DATA, AXIS_FSDP),
    "seq": None, "embed": None, "heads": None, "kv_heads": None,
    "head_dim": None, "mlp": None, "vocab": None, "expert": AXIS_EXPERT,
    "layers": None,
}

# What a spec holds for one tensor dim: no mesh axis, one, or several.
SpecEntry = str | tuple[str, ...] | None


def logical_to_mesh(logical: Sequence[str | None],
                    rules: LogicalRules = DEFAULT_RULES) -> tuple[SpecEntry, ...]:
    """Map a tuple of logical axis names to a PartitionSpec-shaped tuple."""
    out = []
    used: set[str] = set()
    for name in logical:
        axis = rules.get(name) if name is not None else None
        # A mesh axis may appear only once in a spec; later conflicts replicate.
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return tuple(out)


def _entry_axes(entry: SpecEntry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence[SpecEntry], mesh: DeviceMesh) -> tuple[Placement, ...]:
    """One placement per mesh dim: Shard(i) where the spec puts that mesh
    axis on tensor dim i, else Replicate(). Axes the mesh lacks are
    dropped, as JAX drops them from a constraint. Several mesh dims on one
    tensor dim split it outermost first, which DTensor does in mesh-dim
    order, so a spec must list them in that order."""
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = [a for a in _entry_axes(entry) if a in names]
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec entry {entry} splits tensor dim {i} in "
                             f"another order than the mesh dims {names}")
        for a in axes:
            out[names.index(a)] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as `jax.sharding.NamedSharding` pairs them."""
    mesh: DeviceMesh
    spec: tuple[SpecEntry, ...]

    @property
    def placements(self) -> tuple[Placement, ...]:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """Each rank's local shape of a global `shape` (even splits only,
        as JAX's `shard_shape`)."""
        sizes = mesh_axis_sizes(self.mesh)
        out = list(shape)
        for i, entry in enumerate(self.spec):
            n = math.prod(sizes.get(a, 1) for a in _entry_axes(entry))
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"over {entry} ({n} ways)")
            out[i] //= n
        return tuple(out)


def _tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts (and the matching leaves of `rest`)."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


def param_shardings(logical_tree: Any, mesh: DeviceMesh,
                    rules: LogicalRules = DEFAULT_RULES):
    """Map a (nested dict) tree of logical-axis tuples to NamedShardings."""
    return _tree_map(lambda logical: NamedSharding(mesh, logical_to_mesh(logical, rules)),
                     logical_tree)


def shard_pytree(tree: Any, shardings: Any):
    """Full tensors on every rank -> DTensors laid out by `shardings`
    (each rank keeps its shard; the values are rank 0's)."""
    return _tree_map(lambda t, s: distribute_tensor(t, s.mesh, s.placements),
                     tree, shardings)


def local_shard(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of a whole tensor `t` under `sharding`, the block
    the DTensor `distribute_tensor` makes would hold here, as a view of
    `t` on its own device (the mesh's device is not touched). Several mesh
    axes on one dim split it outermost first, as `placements` lays them."""
    mesh = sharding.mesh
    sizes = mesh_axis_sizes(mesh)
    coordinate = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    shard = sharding.shard_shape(t.shape)
    for i, entry in enumerate(sharding.spec):
        index = 0
        for a in _entry_axes(entry):
            if a in sizes:
                index = index * sizes[a] + coordinate[a]
        t = t.narrow(i, index * shard[i], shard[i])
    return t


def with_logical_constraint(x, logical: Sequence[str | None],
                            rules: LogicalRules = DEFAULT_RULES,
                            mesh: DeviceMesh | None = None):
    """Lay a DTensor out by logical names; a no-op outside a mesh and on a
    plain (rank-local) tensor."""
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(logical_to_mesh(logical, rules), mesh))


def mesh_axes(rules: LogicalRules, logical: str, mesh: DeviceMesh) -> tuple[str, ...]:
    """The mesh axes of `mesh` that `rules` map the logical axis to."""
    return tuple(a for a in _entry_axes(rules.get(logical))
                 if a in mesh.mesh_dim_names)


def gather_param(w, keep: Sequence[str] = (), partial: Sequence[str] = ()):
    """The tensor a rank computes with from a parameter: a DTensor is
    gathered to Replicate() on every mesh dim but `keep`'s, whose
    placement stays, and becomes its local tensor; a plain tensor passes.

    Its gradient is Partial() over the `partial` dims (the data dims: each
    rank's grad covers its own rows, and backward sums them, by reduce-
    scatter onto a shard), and placed as the forward is over the rest
    (every rank there computed the same grad, whole or of its shard).
    `to_local()`'s default would treat the local grad as Replicate() and
    drop the other data ranks' grads."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    kept = [p if n in keep else Replicate() for n, p in zip(names, w.placements)]
    grads = [Partial() if n in partial else p for n, p in zip(names, kept)]
    return w.redistribute(w.device_mesh, kept).to_local(grad_placements=grads)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a DTensor, the very tensor it holds (a write to
    it writes the DTensor), its collective awaited; a plain tensor itself."""
    if not isinstance(t, DTensor):
        return t
    with torch.no_grad():
        t = t.to_local()
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def shard_axes(t: torch.Tensor) -> dict[int, tuple[str, ...]]:
    """{tensor dim: the mesh axes of more than one rank that split it} of a
    DTensor ({} for a plain tensor)."""
    if not isinstance(t, DTensor):
        return {}
    out: dict[int, tuple[str, ...]] = {}
    mesh = t.device_mesh
    for name, p in zip(mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard) and mesh.size(mesh.mesh_dim_names.index(name)) > 1:
            out[p.dim] = out.get(p.dim, ()) + (name,)
    return out
