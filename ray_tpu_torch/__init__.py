"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

It runs beside `ray_tpu`, which stays the reference, and imports nothing
from it. Ported so far: `ops` (flash attention as hand-written CUDA
kernels, norms, rotary embeddings), `models` (transformer, configs, the
single-device train step, paged decoding, the weight bridge from JAX),
`serve` (the paged serving engine and its block allocator) and, of
`core`, the serving knobs. The rest of the runtime is not ported yet.
"""
from ray_tpu_torch import core, models, ops, serve

__all__ = ["core", "models", "ops", "serve"]
