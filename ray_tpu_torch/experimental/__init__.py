"""Experimental substrate for compiled DAGs (ref: python/ray/experimental/
channel.py — mutable-object channels backing accelerated DAGs).

The port's copy of `ray_tpu/experimental/__init__.py`, importing
`ray_tpu_torch` only.
"""
from ray_tpu_torch.experimental.channel import (  # noqa: F401
    Channel,
    ChannelClosedError,
    ChannelTimeoutError,
)
