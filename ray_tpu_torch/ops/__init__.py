"""Compute ops of the PyTorch/CUDA port (counterpart of `ray_tpu.ops`).

Attention runs hand-written CUDA kernels for Hopper on CUDA tensors and
their plain versions on CPU tensors; norms, rotary embeddings and the MoE
layer (`ops/moe.py`) are plain tensor math, as they are plain XLA in the
JAX package.
"""
from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rotary import apply_rope, rope_frequencies

__all__ = [
    "flash_attention",
    "mha_reference",
    "rms_norm",
    "apply_rope",
    "rope_frequencies",
]
