"""Models of the PyTorch/CUDA port (counterpart of `ray_tpu.models`).

Plain functions on a nested dict of tensors with the JAX package's
parameter tree, plus a thin `nn.Module`; `training` holds the
single-device train step, `decoding` the serving steps, and
`jax_bridge` carries weights across.
"""
from ray_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
)
from ray_tpu_torch.models import configs, decoding, jax_bridge, training

__all__ = [
    "Transformer",
    "TransformerConfig",
    "init_params",
    "forward",
    "loss_fn",
    "configs",
    "decoding",
    "jax_bridge",
    "training",
]
