"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

It runs beside `ray_tpu`, which stays the reference, and imports nothing
from it. This slice holds the single-device train step: `ops` (flash
attention as hand-written CUDA kernels, norms, rotary embeddings) and
`models` (transformer, configs, train step, weight bridge from JAX). No
runtime layer is ported yet.
"""
from ray_tpu_torch import models, ops

__all__ = ["models", "ops"]
