"""Streaming generator returns: consume task outputs as they are yielded;
a copy of `ray_tpu/core/streaming.py`.

ref: the reference's `ObjectRefGenerator` (`python/ray/_raylet.pyx:272`,
`num_returns="streaming"`): a generator task's yields become object refs
the caller can iterate BEFORE the task finishes — the substrate its Data
and Serve streaming paths build on.

The local engine hands out a `LocalRefGenerator`; `ObjectRefGenerator` is
the multi-process engine's (`core/distributed/core_worker.py`). Divergence
from the reference there: the reference streams
items through the owner's report RPC; here drivers are not RPC servers (`caller_address` is an
opaque owner id), so in-flight items are discovered through the object
directory — the worker stores each yielded value and registers its
location immediately, and `ObjectRefGenerator.__next__` polls the
directory until the item (or the task-completion reply, which fixes the
final count) arrives. Consumed refs resolve through the ordinary `get`
path (inline-cached from the completion reply when small, pulled from
the producing node's store otherwise).

Error semantics: a generator body that raises AFTER yielding k items
invalidates the stream at the next `__next__` — the raising exception
surfaces there (the reference packs it into the (k+1)-th ref instead;
same information, one hop earlier).

Lifecycle: stream item objects are NOT entered into the distributed
refcount (the item count is unknown at submission); they live in the
producing node's store under ordinary LRU eviction and in the owner's
bounded inline cache. Consume streams promptly or copy items out —
matching the reference's guidance that generator refs are not meant as
long-lived storage.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ray_tpu_torch import exceptions as rexc
from ray_tpu_torch.core.ids import ObjectID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef


class LocalRefGenerator:
    """local_mode counterpart of ObjectRefGenerator: refs arrive on a
    queue from the in-process pool task."""

    def __init__(self, items, timeout: float = 300.0):
        self._items = items
        self._timeout = timeout
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_ref(self._timeout)

    def completed(self) -> bool:
        return self._done

    def next_ref(self, timeout: float):
        import queue as _queue

        if self._done:
            raise StopIteration
        try:
            kind, payload = self._items.get(timeout=timeout)
        except _queue.Empty:
            raise rexc.GetTimeoutError(
                f"stream item not produced within {timeout}s") from None
        if kind == "item":
            return payload
        self._done = True
        if kind == "err":
            raise payload
        raise StopIteration


class StreamState:
    """Shared between the owner's stream coroutine and the generator."""

    def __init__(self):
        self.count: Optional[int] = None    # total yields; None = running
        self.error: Optional[BaseException] = None
        self.done = threading.Event()

    def finish(self, count: Optional[int],
               error: Optional[BaseException]) -> None:
        self.count = count
        self.error = error
        self.done.set()


class ObjectRefGenerator:
    """Iterate a streaming task's return refs as they are produced.

    Yields `ObjectRef`s (resolve values with `ray_tpu_torch.get`), matching
    the reference's generator semantics. Thread-compatible with the
    owning worker's sync GCS client."""

    def __init__(self, worker, task_id: TaskID, state: StreamState,
                 timeout: float = 300.0):
        self._worker = worker
        self._task_id = task_id
        self._state = state
        self._timeout = timeout
        self._emitted = 0

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        return self.next_ref(self._timeout)

    def completed(self) -> bool:
        return self._state.done.is_set()

    def next_ref(self, timeout: float) -> ObjectRef:
        """`__next__` with an explicit per-item timeout — for streams
        whose yields are farther apart than the default 300s (long
        epochs, deeply queued tasks)."""
        return self._next_ref(timeout)

    def _next_ref(self, timeout: float) -> ObjectRef:
        i = self._emitted + 1
        oid = ObjectID.for_task_return(self._task_id, i)
        state = self._state
        deadline = time.monotonic() + timeout
        backoff = 0.02
        # Items yielded BEFORE a mid-stream failure stay consumable
        # (reference semantics: the error rides after the produced
        # refs); their directory registration may still be in flight
        # when the failure reply lands, so availability gets a short
        # grace window before the error surfaces.
        error_grace: Optional[float] = None
        while True:
            if self._available(oid):
                break
            if state.done.is_set():
                if state.error is not None:
                    if error_grace is None:
                        error_grace = time.monotonic() + 0.3
                    if time.monotonic() >= error_grace:
                        raise state.error
                elif state.count is None or i > state.count:
                    raise StopIteration
                else:
                    break  # completed: reply registered/cached item i
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise rexc.GetTimeoutError(
                    f"stream item {i} of task "
                    f"{self._task_id.hex()[:16]} not produced within "
                    f"{timeout}s")
            if state.done.is_set():
                # done.wait() returns immediately on a set event — a
                # plain sleep paces the error-grace availability polls
                # instead of hammering the directory.
                time.sleep(min(backoff, remaining))
            else:
                state.done.wait(min(backoff, remaining))
            backoff = min(backoff * 1.6, 0.25)
        self._emitted = i
        return ObjectRef(oid, self._worker.address)

    def _available(self, oid: ObjectID) -> bool:
        """The item exists once the producing worker registered its
        location (or it landed locally via the reply's inline cache)."""
        if self._worker._inline_cache.get(oid) is not None \
                or self._worker.store.contains(oid):
            return True
        try:
            info = self._worker.gcs.call(
                "ObjectDirectory", "get_locations",
                object_id=oid.binary(), timeout=10)
            return bool(info.get("nodes"))
        except Exception:  # noqa: BLE001 transient GCS hiccup
            return False
