"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

It runs beside `ray_tpu`, which stays the reference, and imports nothing
from it. Ported so far: `ops` (flash attention as hand-written CUDA
kernels, ring and Ulysses attention over a sequence-split axis, norms,
rotary embeddings, MoE), `models` (transformer, configs, the train step
on one device or sharded over a mesh, sequence axis included, with AdamW,
SGD or Adafactor, decoding on the contiguous and the paged KV cache, the
weight bridge from JAX), `parallel` (the device mesh, the logical sharding
rules on DTensor, differentiable collectives over named mesh dims, the
GPipe pipeline over a pp axis), `data` (datasets of numpy-column blocks
on the runtime, the streaming executor, shuffle, `streaming_split` and
the pinned, prefetching device feed),
`serve` (the fixed-slot and paged serving engines, with speculative
decoding and KV import/export, and the block allocator), `rllib` (imported
on its own) and the task/actor core: `init(local_mode=True)` runs tasks
and actors on the in-process engine (`core/local_engine.py`), with
`remote`, `get`, `put`, `wait`, named actors, placement-group records,
`util` (ActorPool, Queue, placement groups, scheduling strategies, metrics,
tracing, profiling) and the single-host multi-process runtime of
`core/distributed/` (GCS, node daemon, zygote-forked workers, the
shared-memory object store): `init()` starts such a cluster and
`init(address=...)` joins one; on it, `serve`'s control plane
(deployments, the controller, handles, the HTTP proxy, `LLMDeployment`)
and `experimental` (the shared-memory channel rings); and `train`'s
plane (`TorchTrainer`, worker groups, sessions, DCP checkpoints, the
elastic supervisor, train observability) with `util`'s chaos, state and
timeline readers. Multi-node clusters and the client (ROADMAP queue A,
item 10a-iii), the DAG layer (10c-ii) and tune (10d-ii) are not ported
yet.

A bare `import ray_tpu_torch` stays light, as `import ray_tpu` does: the
subpackages (`models`, `ops`, `serve`, ...) import on first touch, so the
control-plane processes never import them.
"""
from ray_tpu_torch import exceptions
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

_SUBPACKAGES = ("core", "data", "models", "ops", "parallel", "rllib", "serve",
                "train", "util")


def __getattr__(name):
    """Lazy subpackage access: `ray_tpu_torch.models`, `.ops`, ... import on
    first touch."""
    if name in _SUBPACKAGES:
        import importlib

        mod = importlib.import_module(f"ray_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = [
    "core", "data", "models", "ops", "parallel", "serve", "train",
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "register_cross_lang", "cluster_resources",
    "available_resources", "nodes", "ObjectRef", "ObjectRefGenerator",
    "ActorClass", "ActorHandle", "method", "RemoteFunction",
    "get_runtime_context", "exceptions",
]
