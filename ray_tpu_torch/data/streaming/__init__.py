"""Streaming data plane, counterpart of `ray_tpu/data/streaming/`:
backpressured Dataset execution over the port's runtime.

- ``executor``  — byte-budgeted operator graph (per-operator in-flight
  byte caps, stall accounting, spill fallback); ``data/execution.py`` is
  the ``RAY_TPU_DATA_STREAM_ENABLED=0`` fallback.
- ``shuffle``   — all-to-all shuffle through one offset-addressed bundle
  per mapper.
- ``split``     — ack-based streaming split coordinator that re-splits on
  elastic world-size change mid-epoch without dropping or duplicating
  samples.
- ``prefetch``  — the device prefetcher of ``data/feed.py`` (the copy of
  batch k+1 to the card overlaps compute on batch k).
- ``metrics``   — per-operator data-plane gauges pushed to the node daemon.
"""
from ray_tpu_torch.data.streaming.executor import streaming_enabled, streaming_execute
from ray_tpu_torch.data.streaming.prefetch import DevicePrefetcher
from ray_tpu_torch.data.streaming.split import StreamSplitCoordinator

__all__ = [
    "DevicePrefetcher",
    "StreamSplitCoordinator",
    "streaming_enabled",
    "streaming_execute",
]
