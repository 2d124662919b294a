"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

It runs beside `ray_tpu`, which stays the reference, and imports nothing
from it. Ported so far: `ops` (flash attention as hand-written CUDA
kernels, ring and Ulysses attention over a sequence-split axis, norms,
rotary embeddings, MoE), `models` (transformer, configs, the train step
on one device or sharded over a mesh, sequence axis included, with AdamW,
SGD or Adafactor, decoding on the contiguous and the paged KV cache, the
weight bridge from JAX), `parallel` (the device mesh, the logical sharding
rules on DTensor, differentiable collectives over named mesh dims, the
GPipe pipeline over a pp axis), `data` (the pinned,
prefetching device feed), `train` (the torch.distributed backend),
`serve` (the fixed-slot and paged serving engines, with speculative
decoding and KV import/export, and the block allocator), `rllib` (imported
on its own) and the task/actor core: `init(local_mode=True)` runs tasks
and actors on the in-process engine (`core/local_engine.py`), with
`remote`, `get`, `put`, `wait`, named actors, placement-group records,
`util` (ActorPool, Queue, placement groups, scheduling strategies) and the
GPU resource primitives of `core/distributed/` (`resources.py`,
`accelerators.py`). The multi-process runtime (ROADMAP queue A, item
10a-ii) and the layers above it (10b-10d) are not ported yet: `init()`
without `local_mode` raises.
"""
from ray_tpu_torch import core, data, exceptions, models, ops, parallel, serve, train
from ray_tpu_torch.actor import ActorClass, ActorHandle, method
from ray_tpu_torch.api import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    register_cross_lang,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.streaming import ObjectRefGenerator
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context

__all__ = [
    "core", "data", "models", "ops", "parallel", "serve", "train",
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "register_cross_lang", "cluster_resources",
    "available_resources", "nodes", "ObjectRef", "ObjectRefGenerator",
    "ActorClass", "ActorHandle", "method", "RemoteFunction",
    "get_runtime_context", "exceptions",
]
