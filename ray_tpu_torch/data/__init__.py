"""Data feed of the port (counterpart of the device feed in
`ray_tpu.data`): the bounded device prefetcher and `torch_feed`, which
stages batches in pinned memory and copies them to the card ahead of the
step. The dataset and its executor are runtime layers, ported later."""
from ray_tpu_torch.data.feed import (
    DevicePrefetcher,
    TorchFeed,
    device_prefetching,
    torch_feed,
)

__all__ = ["DevicePrefetcher", "TorchFeed", "device_prefetching", "torch_feed"]
