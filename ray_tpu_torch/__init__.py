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
decoding and KV import/export, and the block allocator) and, of `core`,
the serving knobs. The rest of the runtime is not ported yet.
"""
from ray_tpu_torch import core, data, models, ops, parallel, serve, train

__all__ = ["core", "data", "models", "ops", "parallel", "serve", "train"]
