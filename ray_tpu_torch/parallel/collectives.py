"""Collectives over named mesh dims, counterpart of
`ray_tpu/parallel/collectives.py`.

JAX's run inside an SPMD program, where axis names are bound; here each
acts on this rank's local tensor over a dim of an explicit `mesh`, through
torch.distributed's functional collectives, and waits for its result
(an unwaited result would warn at exit). `axis` may name several mesh
dims where JAX allows it (psum, pmean).

`psum` is differentiable with the transpose JAX gives it under shard_map:
backward passes each rank its own cotangent. `pvary` is its pair:
identity forward, psum of the cotangents backward; a replicated
activation goes through it before a product with a weight sharded over
`axis`, whose ranks each give a partial gradient of it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor


def _axes(axis: str | Sequence[str]) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _group(mesh: DeviceMesh, axis: str):
    return mesh, mesh.mesh_dim_names.index(axis)


def _all_reduce(x: torch.Tensor, axes: tuple[str, ...], mesh: DeviceMesh):
    for a in axes:
        x = funcol.wait_tensor(funcol.all_reduce(x, "sum", _group(mesh, a)))
    return x


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return _all_reduce(x, axes, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.axes, ctx.mesh), None, None


def psum(x: torch.Tensor, axis: str | Sequence[str], *, mesh: DeviceMesh):
    axes = _axes(axis)
    return _Psum.apply(x, axes, mesh) if axes else x


def pvary(x: torch.Tensor, axis: str | Sequence[str], *, mesh: DeviceMesh):
    axes = _axes(axis)
    return _Pvary.apply(x, axes, mesh) if axes else x


def pmean(x: torch.Tensor, axis: str | Sequence[str], *, mesh: DeviceMesh):
    n = 1
    for a in _axes(axis):
        n *= axis_size(a, mesh=mesh)
    return psum(x, axis, mesh=mesh) / n


def all_gather(x: torch.Tensor, axis: str, *, mesh: DeviceMesh, dim: int = 0,
               tiled: bool = True):
    """Every rank's x along `dim`: concatenated (tiled) or stacked."""
    if not tiled:
        x = x.unsqueeze(dim)
    return funcol.wait_tensor(funcol.all_gather_tensor(
        x.contiguous(), dim % x.dim(), _group(mesh, axis)))


def psum_scatter(x: torch.Tensor, axis: str, *, mesh: DeviceMesh, dim: int = 0,
                 tiled: bool = True):
    """The sum over ranks, each rank keeping its block of `dim` (untiled:
    dim has the axis' size, and each rank keeps its index, squeezed)."""
    out = funcol.wait_tensor(funcol.reduce_scatter_tensor(
        x.contiguous(), "sum", dim % x.dim(), _group(mesh, axis)))
    return out if tiled else out.squeeze(dim)


def all_to_all(x: torch.Tensor, axis: str, *, mesh: DeviceMesh, split_dim: int,
               concat_dim: int, tiled: bool = True):
    """Block j of `split_dim` goes to rank j; the blocks received are
    concatenated along `concat_dim` in rank order (untiled: split_dim has
    the axis' size and is removed, and the blocks stack on concat_dim)."""
    n = axis_size(axis, mesh=mesh)
    if not tiled:
        x = x.movedim(split_dim, 0)
    else:
        x = torch.stack(x.chunk(n, split_dim))
    out = funcol.wait_tensor(funcol.all_to_all_single(
        x.contiguous(), None, None, _group(mesh, axis)))
    if not tiled:
        return out.movedim(0, concat_dim)
    return torch.cat(out.unbind(0), dim=concat_dim)


def axis_index(axis: str, *, mesh: DeviceMesh) -> int:
    return mesh.get_local_rank(axis)


def axis_size(axis: str, *, mesh: DeviceMesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def ppermute_ring(x: torch.Tensor, axis: str, *, mesh: DeviceMesh, shift: int = 1):
    """Rotate shards around the `axis` ring by `shift`: rank i's value
    lands on rank i+shift, i.e. each rank receives the value of its
    `-shift` neighbour."""
    n = axis_size(axis, mesh=mesh)
    if n == 1 or shift % n == 0:
        return x.clone()
    i = axis_index(axis, mesh=mesh)
    group = mesh.get_group(axis)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dist.get_global_rank(group, (i + shift) % n), group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (i - shift) % n), group)])
    for r in reqs:
        r.wait()
    return out


def unshard(x) -> np.ndarray:
    """Gather a (sharded) tensor to a host numpy array (debug/eval path);
    a DTensor gathers over every rank, so each must call it."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy()
