"""Checkpoints: directory handles + tensor-tree (de)serialization,
counterpart of `ray_tpu/train/checkpoint.py`.

Mirrors the reference's `Checkpoint` directory-handle design
(ref: python/ray/train/_checkpoint.py:56 — a path + filesystem, moved
around by upload/download). The payload is a torch.distributed.checkpoint
(DCP) directory where the JAX package writes Orbax: every rank writes its
own shards, so checkpointing scales with the gang.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import uuid
import warnings
from contextlib import contextmanager
from typing import Any, Iterator, Optional


class Checkpoint:
    """Handle to a checkpoint directory (local or fsspec-style path)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, dest: Optional[str] = None) -> str:
        """Materialize into `dest` (copy); returns the directory path."""
        if dest is None:
            dest = os.path.join(tempfile.gettempdir(),
                                f"rtpu_ckpt_{uuid.uuid4().hex[:8]}")
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextmanager
    def as_directory(self) -> Iterator[str]:
        yield self.path

    def update_metadata(self, metadata: dict) -> None:
        with open(os.path.join(self.path, ".metadata.json"), "w") as f:
            json.dump(metadata, f)

    def get_metadata(self) -> dict:
        p = os.path.join(self.path, ".metadata.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"


@contextmanager
def _single_process_quiet() -> Iterator[None]:
    """DCP warns on every call outside a process group that it assumes one
    process; that is what `no_dist` asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="torch.distributed is disabled")
        yield


def save_pytree(tree: Any, path: str, *, step: int = 0) -> Checkpoint:
    """Write a nested dict of tensors (DTensors included; other leaves are
    pickled) with torch.distributed.checkpoint; blocks until durable.

    Under a process group every rank calls it and writes its own shards,
    as each host writes its own under Orbax; DCP plans the save over the
    default group, so call it where the group lives (the train loop's
    thread). Rank 0 clears `path` first and writes `.metadata.json`.
    """
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    grouped = dist.is_available() and dist.is_initialized()
    rank0 = not grouped or dist.get_rank() == 0
    if rank0:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            shutil.rmtree(path)
    if grouped and dist.get_world_size() > 1:
        dist.barrier()
    with _single_process_quiet():
        dcp.save(tree, checkpoint_id=path, no_dist=not grouped)
    ckpt = Checkpoint(path)
    if rank0:
        ckpt.update_metadata({"step": step})
    return ckpt


def load_pytree(checkpoint: Checkpoint, target: Any = None) -> Any:
    """Restore a nested dict. With `target` (a tree of the same keys) every
    tensor is loaded in place, onto the target's devices, dtypes and
    placements (a DTensor target is resharded from whatever layout was
    saved), and the target is returned; without it every tensor comes back
    whole on the CPU."""
    import torch
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    grouped = dist.is_available() and dist.is_initialized()
    if target is not None:
        with _single_process_quiet():
            dcp.load(target, checkpoint_id=checkpoint.path,
                     no_dist=not grouped)
        return target
    reader = dcp.FileSystemReader(checkpoint.path)
    meta = reader.read_metadata()
    flat = {k: (torch.empty(m.size, dtype=m.properties.dtype)
                if isinstance(m, TensorStorageMetadata) else None)
            for k, m in meta.state_dict_metadata.items()}
    with _single_process_quiet():
        dcp.load(flat, storage_reader=reader, no_dist=True)
    tree: dict = {}
    for key, value in flat.items():
        path = meta.planner_data.get(key, (key,))
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree
