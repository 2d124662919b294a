"""ActorPool: fan work over a fixed set of actors; a copy of
`ray_tpu/util/actor_pool.py`.

Analogue of `ray.util.ActorPool` (ref: python/ray/util/actor_pool.py —
submit/map/map_unordered over idle actors, get_next/get_next_unordered
consumption).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._pending_order: List[Any] = []   # submission order

    def has_free(self) -> bool:
        return bool(self._idle)

    def has_next(self) -> bool:
        return bool(self._future_to_actor)

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef; blocks-free (raises if no idle
        actor — push after a get_next to recycle)."""
        if not self._idle:
            raise ValueError("no idle actors; consume results first")
        actor = self._idle.pop(0)
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor
        self._pending_order.append(ref)

    def get_next(self, timeout: float = None) -> Any:
        """Next result in SUBMISSION order. A timeout raises BEFORE any
        state changes, so the caller can retry and the busy actor is not
        handed new work."""
        import ray_tpu_torch

        if not self._pending_order:
            raise StopIteration("no pending results")
        ref = self._pending_order[0]
        if timeout is not None:
            done, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=timeout)
            if not done:
                raise TimeoutError("next result not ready within timeout")
        self._pending_order.pop(0)
        actor = self._future_to_actor.pop(ref)
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._idle.append(actor)

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Next COMPLETED result, any order."""
        import ray_tpu_torch

        if not self._future_to_actor:
            raise StopIteration("no pending results")
        done, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                               num_returns=1, timeout=timeout)
        if not done:
            raise TimeoutError("no result within timeout")
        ref = done[0]
        actor = self._future_to_actor.pop(ref)
        self._pending_order.remove(ref)
        self._idle.append(actor)
        return ray_tpu_torch.get(ref)

    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]):
        """Ordered streaming map (ref: ActorPool.map)."""
        values = list(values)
        i = 0
        while i < len(values) or self.has_next():
            while i < len(values) and self.has_free():
                self.submit(fn, values[i])
                i += 1
            if self.has_next():
                yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]):
        values = list(values)
        i = 0
        while i < len(values) or self.has_next():
            while i < len(values) and self.has_free():
                self.submit(fn, values[i])
                i += 1
            if self.has_next():
                yield self.get_next_unordered()

    def push(self, actor: Any) -> None:
        self._idle.append(actor)

    def pop_idle(self) -> Any:
        return self._idle.pop(0) if self._idle else None
