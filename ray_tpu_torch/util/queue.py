"""Distributed queue: a FIFO shared between tasks/actors; a copy of
`ray_tpu/util/queue.py`.

Analogue of `ray.util.queue.Queue` (ref: python/ray/util/queue.py — an
actor-backed asyncio queue with put/get/qsize and the Empty/Full
exceptions of the stdlib queue module).
"""
from __future__ import annotations

import asyncio
from typing import Any, List, Optional

from queue import Empty, Full  # noqa: F401 — re-exported, stdlib parity


class _QueueActor:
    def __init__(self, maxsize: int):
        self._q: asyncio.Queue = asyncio.Queue(maxsize)

    async def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        try:
            if timeout is None:
                await self._q.put(item)
            else:
                await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except (TimeoutError, asyncio.TimeoutError):
            return False

    async def put_nowait(self, item: Any) -> bool:
        # Async like everything else: a sync method on an async actor
        # runs on a pool thread and would mutate the loop-bound
        # asyncio.Queue from the wrong thread (lost wakeups).
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get(self, timeout: Optional[float] = None) -> tuple:
        try:
            if timeout is None:
                return True, await self._q.get()
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except (TimeoutError, asyncio.TimeoutError):
            return False, None

    async def get_nowait(self) -> tuple:
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def qsize(self) -> int:
        return self._q.qsize()

    async def empty(self) -> bool:
        return self._q.empty()

    async def full(self) -> bool:
        return self._q.full()


class Queue:
    """Driver/worker-shareable FIFO; pickles by actor handle, so any
    process holding it talks to the same queue actor."""

    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict]
                 = None, _actor=None):
        import ray_tpu_torch

        if _actor is not None:
            self._actor = _actor
            return
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 16)
        self._actor = ray_tpu_torch.remote(_QueueActor).options(**opts).remote(
            maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        import ray_tpu_torch

        if not block:
            if not ray_tpu_torch.get(self._actor.put_nowait.remote(item)):
                raise Full
            return
        if not ray_tpu_torch.get(self._actor.put.remote(item, timeout)):
            raise Full

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch

        if not block:
            ok, item = ray_tpu_torch.get(self._actor.get_nowait.remote())
        else:
            ok, item = ray_tpu_torch.get(self._actor.get.remote(timeout))
        if not ok:
            raise Empty
        return item

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.empty.remote())

    def full(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.full.remote())

    def shutdown(self) -> None:
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:  # noqa: BLE001
            pass

    def __reduce__(self):
        # By handle: every deserialized copy talks to the SAME actor
        # (and must not spawn a fresh queue via __init__).
        return (_queue_from_actor, (self._actor,))


def _queue_from_actor(actor) -> "Queue":
    return Queue(_actor=actor)
