"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

It runs beside `ray_tpu`, which stays the reference, and imports nothing
from it. Ported so far: `ops` (flash attention as hand-written CUDA
kernels, norms, rotary embeddings), `models` (transformer, configs, the
single-device train step, decoding on the contiguous and the paged KV
cache, the weight bridge from JAX), `serve` (the fixed-slot and paged
serving engines, with speculative decoding and KV import/export, and the
block allocator) and, of `core`, the serving knobs. The rest of the runtime is not ported yet.
"""
from ray_tpu_torch import core, models, ops, serve

__all__ = ["core", "models", "ops", "serve"]
