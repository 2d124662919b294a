"""Pipeline-resident device prefetch, counterpart of
`ray_tpu/data/streaming/prefetch.py`.

The prefetcher lives in `data/feed.py`, beside `torch_feed`, which copies
each batch to the card on a side stream; this module re-exports it under
the JAX package's module name.
"""
from ray_tpu_torch.data.feed import DevicePrefetcher, device_prefetching

__all__ = ["DevicePrefetcher", "device_prefetching"]
