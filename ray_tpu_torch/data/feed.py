"""Device feed for training loops, counterpart of
`ray_tpu/data/streaming/prefetch.py` and `ray_tpu/data/dataset.py::_jax_feed`.

`DevicePrefetcher` keeps the JAX package's semantics: a producer thread
pulls host batches, moves them to the device and parks up to `depth` of
them in a bounded queue, so the transfer of batch k+1 overlaps the step
on batch k. A *hit* means the consumer found a batch ready when it asked,
a *miss* that it waited (the feed is behind the step). `close()` stops
the producer when the consumer leaves early; an error of the source is
raised at the consumer.

`torch_feed` is the transfer: each batch is staged in pinned host memory
and copied to the card with `non_blocking` on a side stream; the
consumer's stream waits on the copy's event, and `record_stream` keeps
the caching allocator from handing the batch's memory to the side stream
again while the consumer's kernels may still read it. Under a mesh each
rank copies only its rows (the batch splits over dp and fsdp, outermost
first) and receives them as a DTensor of the global batch, which the
train step takes as it takes a host array.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ray_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_FSDP, local_batch_rows
from ray_tpu_torch.parallel.sharding import local_tensor, placements

_SENTINEL = object()
# The mesh axes a fed batch splits over, as DEFAULT_RULES' "batch".
FEED_AXES = (AXIS_DATA, AXIS_FSDP)


class DevicePrefetcher:
    """Bounded background producer of device-resident batches."""

    def __init__(self, batch_iter: Iterator[Any],
                 to_device: Callable[[Any], Any], *,
                 depth: int = 2, name: str = "train"):
        self._src = batch_iter
        self._to_device = to_device
        self._depth = max(1, depth)
        self._q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self.hits = 0
        self.misses = 0
        self._thread = threading.Thread(
            target=self._run, name=f"data-prefetch-{name}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for batch in self._src:
                dev = self._to_device(batch)
                while not self._stop.is_set():
                    try:
                        self._q.put(dev, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — raised at the consumer
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self._q.get_nowait()
            self.hits += 1
        except queue.Empty:
            self.misses += 1
            item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer early (the consumer abandoned the epoch)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def device_prefetching(batch_iter: Iterator[Any], to_device, *,
                       depth: int, name: str = "train") -> Iterator[Any]:
    """Generator wrapper that guarantees producer shutdown when the
    consumer stops early (break out of a partial epoch)."""
    pf = DevicePrefetcher(batch_iter, to_device, depth=depth, name=name)
    try:
        yield from pf
    finally:
        pf.close()


class TorchFeed(DevicePrefetcher):
    """A DevicePrefetcher whose producer copies on a side stream; each
    batch is handed over on the consumer's stream (see `torch_feed`)."""

    def __next__(self) -> dict:
        batch, ready = super().__next__()
        if ready is not None:
            stream = torch.cuda.current_stream(ready.device)
            stream.wait_event(ready)
            for t in batch.values():
                local_tensor(t).record_stream(stream)
        return batch


def torch_feed(batch_iter: Iterator[dict], *, device: torch.device | str,
               mesh: DeviceMesh | None = None, dtypes: dict | None = None,
               prefetch: int = 2) -> TorchFeed:
    """Feed numpy batches ({name: (B, ...) array}) to `device`, `prefetch`
    ahead of the consumer, cast to `dtypes` ({name: numpy dtype}) first.

    On CUDA the copy is pinned and asynchronous (module docstring). Under a
    `mesh` (whose device type replaces `device`) each rank gets a DTensor
    of the global batch holding its rows. Use it as a context manager, or
    call `close()`, when leaving before the source ends."""
    if mesh is not None:
        device = mesh.device_type
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("torch_feed: no CUDA device for device='cuda'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        side = torch.cuda.Stream(device)

    def stage(array: np.ndarray) -> torch.Tensor:
        if device.type != "cuda":
            return torch.tensor(array)  # a copy, as a transfer makes
        dtype = torch.from_numpy(np.empty(0, array.dtype)).dtype
        pinned = torch.empty(array.shape, dtype=dtype, pin_memory=True)
        np.copyto(pinned.numpy(), array)
        with torch.cuda.stream(side):
            return pinned.to(device, non_blocking=True)

    def to_device(np_batch: dict):
        out = {}
        for k, v in np_batch.items():
            v = np.asarray(v)
            if dtypes and k in dtypes:
                v = v.astype(dtypes[k])
            if mesh is None:
                out[k] = stage(v)
                continue
            rows = v[local_batch_rows(mesh, v.shape[0], FEED_AXES)]
            spec = (FEED_AXES,) + (None,) * (v.ndim - 1)
            out[k] = DTensor.from_local(stage(rows), mesh, placements(spec, mesh),
                                        run_check=False)
        if device.type != "cuda":
            return out, None
        ready = torch.cuda.Event()
        ready.record(side)
        return out, ready

    return TorchFeed(batch_iter, to_device, depth=prefetch)
