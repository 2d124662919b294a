"""Pull manager: prioritized, deduplicated, bounded object transfer.

The port's copy of `ray_tpu/core/distributed/pull_manager.py`,
importing `ray_tpu_torch` only.

Analogue of the reference `PullManager`
(ref: src/ray/object_manager/pull_manager.h:52 — prioritized pull
request queues with an in-flight bandwidth budget; request classes
get > task-arg > prefetch, matching its TaskArgs/Get/Wait bundles).

Why it exists even in a pull-based design: concurrent `get()`s of the
same remote object must share ONE transfer; a storm of pulls must not
hold unbounded chunk buffers in RAM; and a user blocking in `get()`
must cut ahead of background prefetch. All transfer work runs on the
process's RPC loop; sync callers block on a concurrent future.

Two transfer backends:
* striped (default in the core worker): `fetch_chunk` + `open_sink`
  hand each transfer to transfer.striped_pull — chunks stream from ALL
  replica locations at once under a bytes window, landing directly in
  the local store's mmap (create-then-fill). The pull result carries
  the object's size; the bytes are already sealed locally.
* legacy: a whole-object `fetch(address, oid)` callable tried one
  replica at a time, returning the bytes (kept for tests and simple
  embedders).
"""
from __future__ import annotations

import asyncio
import itertools
import logging
from collections import deque
from typing import Any, Awaitable, Callable, Deque, Dict, List, Optional, \
    Tuple

logger = logging.getLogger(__name__)

PRIORITY_GET = 0        # a caller is blocked in ray.get()
PRIORITY_TASK_ARG = 1   # a leased worker needs args to start
PRIORITY_PREFETCH = 2   # speculative (dataset prefetch etc.)

# (result, stale_node_ids): result None => no location produced the
# object; bytes under the legacy backend; the object's total size (int)
# under the striped backend (the data is already in the local store).
PullResult = Tuple[Optional[Any], List[str]]
FetchFn = Callable[[str, bytes], Awaitable[Optional[bytes]]]


class _ClassQueue:
    """Priority-class queue with a reserved minimum-service share.

    A plain priority queue starves the lowest class under sustained
    higher-priority load — observed as dataset-prefetch pulls deferred
    past their deadline while get/task-arg traffic flows.  Here a pop
    normally serves the best (lowest-numbered) non-empty class in FIFO
    order, but every `fifo_every`-th pop serves the GLOBALLY oldest
    queued request regardless of class.  A request at global-FIFO depth
    d is therefore served after at most ``fifo_every * d`` pops — a
    deterministic bound that needs no clocks or aging timers (ref:
    src/ray/object_manager/pull_manager.h:52 — the reference likewise
    keeps lower-priority bundles activatable under quota rather than
    strictly dominated).
    """

    def __init__(self, fifo_every: int = 4):
        self._fifo_every = max(2, fifo_every)
        self._classes: Dict[int, Deque] = {}
        self._pops = 0
        self._event = asyncio.Event()

    def put(self, priority: int, seq: int, item) -> None:
        self._classes.setdefault(priority, deque()).append((seq, item))
        self._event.set()

    async def get(self):
        # Multi-consumer wakeup: re-check emptiness after clear() so a
        # put() racing between the check and the clear is never lost.
        while True:
            live = [(p, d) for p, d in self._classes.items() if d]
            if live:
                break
            self._event.clear()
            if any(self._classes.values()):
                continue
            await self._event.wait()
        self._pops += 1
        if self._pops % self._fifo_every == 0:
            _, d = min(live, key=lambda pd: pd[1][0][0])  # oldest head seq
        else:
            _, d = min(live, key=lambda pd: pd[0])        # best class
        seq, item = d.popleft()
        return seq, item


class PullManager:
    def __init__(self, loop: asyncio.AbstractEventLoop,
                 fetch: Optional[FetchFn] = None,
                 max_concurrent: int = 4,
                 max_inflight_bytes: int = 256 << 20,
                 min_service_every: int = 4,
                 fetch_chunk=None, open_sink=None, metrics=None):
        if fetch is None and (fetch_chunk is None or open_sink is None):
            raise ValueError(
                "PullManager needs a legacy fetch fn or the striped "
                "fetch_chunk + open_sink pair")
        self._loop = loop
        self._fetch = fetch
        self._fetch_chunk = fetch_chunk
        self._open_sink = open_sink
        self._metrics = metrics
        self._max_concurrent = max_concurrent
        self._max_inflight_bytes = max_inflight_bytes
        self._min_service_every = min_service_every
        self._inflight_bytes = 0
        self._queue: Optional[_ClassQueue] = None
        self._inflight: Dict[bytes, asyncio.Future] = {}
        self._seq = itertools.count()      # FIFO within a priority class
        self._started = False
        self._bytes_freed: Optional[asyncio.Event] = None
        # Strong roots: asyncio keeps only weak refs to tasks, and a
        # puller waiting on OUR queue is an unreferenced cycle the GC
        # collects mid-flight (same bug class as EventLoopThread._bg_tasks).
        self._pullers: List[asyncio.Task] = []

    # -- sync facade ----------------------------------------------------
    def pull_sync(self, oid_b: bytes,
                  nodes: List[Tuple[str, str]],   # (node_id, address)
                  size_hint: int,
                  priority: int = PRIORITY_GET,
                  timeout: Optional[float] = 150.0) -> PullResult:
        fut = asyncio.run_coroutine_threadsafe(
            self.pull(oid_b, nodes, size_hint, priority), self._loop)
        return fut.result(timeout)

    # -- async core -----------------------------------------------------
    async def pull(self, oid_b: bytes, nodes: List[Tuple[str, str]],
                   size_hint: int,
                   priority: int = PRIORITY_GET) -> PullResult:
        self._ensure_started()
        existing = self._inflight.get(oid_b)
        if existing is not None:
            # Share the transfer; stale bookkeeping belongs to its owner.
            data = await asyncio.shield(existing)
            return data, []
        fut: asyncio.Future = self._loop.create_future()
        self._inflight[oid_b] = fut
        done: asyncio.Future = self._loop.create_future()
        self._queue.put(
            priority, next(self._seq),
            (oid_b, list(nodes), max(size_hint, 1), fut, done))
        try:
            return await done
        finally:
            self._inflight.pop(oid_b, None)

    def _ensure_started(self) -> None:
        if self._started:
            return
        self._started = True
        self._queue = _ClassQueue(self._min_service_every)
        self._bytes_freed = asyncio.Event()
        for _ in range(self._max_concurrent):
            self._pullers.append(asyncio.ensure_future(self._puller()))

    async def _puller(self) -> None:
        while True:
            _, (oid_b, nodes, size, fut, done) = await self._queue.get()
            # Bandwidth budget: block this puller until the estimated
            # bytes fit (one oversized object is always admitted alone).
            while (self._inflight_bytes > 0
                   and self._inflight_bytes + size
                   > self._max_inflight_bytes):
                self._bytes_freed.clear()
                await self._bytes_freed.wait()
            self._inflight_bytes += size
            try:
                data, stale = await self._transfer(oid_b, nodes)
            except Exception as e:  # noqa: BLE001
                data, stale = None, []
                logger.debug("pull of %s failed: %s", oid_b.hex()[:12], e)
            finally:
                self._inflight_bytes -= size
                self._bytes_freed.set()
            if not fut.done():
                fut.set_result(data)
            if not done.done():
                done.set_result((data, stale))

    async def _transfer(self, oid_b: bytes,
                        nodes: List[Tuple[str, str]]) -> PullResult:
        if self._fetch_chunk is not None:
            from ray_tpu_torch.core.config import get_config
            from ray_tpu_torch.core.distributed.transfer import striped_pull

            cfg = get_config()
            return await striped_pull(
                oid_b, list(nodes), self._fetch_chunk, self._open_sink,
                chunk_bytes=cfg.object_transfer_chunk_bytes,
                window_bytes=cfg.transfer_window_bytes,
                per_source=cfg.transfer_per_source_inflight,
                metrics=self._metrics)
        stale: List[str] = []
        for node_id, address in nodes:
            try:
                data = await self._fetch(address, oid_b)
            except Exception as e:  # noqa: BLE001
                logger.debug("pull from %s failed: %s", address, e)
                continue           # unreachable: node may come back
            if data is None:
                stale.append(node_id)   # answered "missing": evicted
                continue
            return data, stale
        return None, stale
