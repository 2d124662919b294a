"""@serve.batch dynamic request batching.

The port's copy of `ray_tpu/serve/batching.py`, importing `ray_tpu_torch`
only.

Reference: `@serve.batch` + `_BatchQueue`
(ref: python/ray/serve/batching.py:456, :76): calls accumulate until
max_batch_size or batch_wait_timeout_s, then the wrapped function runs once
on the list and each caller gets its element back.  Sync-callable variant
(our replicas execute in threads, not asyncio).
"""
from __future__ import annotations

import functools
import threading
from typing import Any, Callable, List, Optional


class _Pending:
    __slots__ = ("value", "event", "result", "error")

    def __init__(self, value):
        self.value = value
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._wait = wait_timeout_s
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._flusher: Optional[threading.Timer] = None

    def submit(self, item) -> Any:
        p = _Pending(item)
        flush_now = False
        with self._lock:
            self._queue.append(p)
            if len(self._queue) >= self._max:
                flush_now = True
            elif self._flusher is None:
                self._flusher = threading.Timer(self._wait, self._flush)
                self._flusher.daemon = True
                self._flusher.start()
        if flush_now:
            self._flush()
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def _flush(self):
        with self._lock:
            # At most max_batch_size a call: callers can join a full
            # queue before this flush takes it, and wait for the next.
            batch = self._queue[:self._max]
            self._queue = self._queue[self._max:]
            if self._flusher is not None:
                self._flusher.cancel()
                self._flusher = None
            if self._queue:
                self._flusher = threading.Timer(
                    0.0 if len(self._queue) >= self._max else self._wait,
                    self._flush)
                self._flusher.daemon = True
                self._flusher.start()
        if not batch:
            return
        try:
            results = self._fn([p.value for p in batch])
            if len(results) != len(batch):
                raise ValueError(
                    f"batch fn returned {len(results)} results for "
                    f"{len(batch)} inputs")
            for p, r in zip(batch, results):
                p.result = r
        except BaseException as e:  # noqa: BLE001
            for p in batch:
                p.error = e
        finally:
            for p in batch:
                p.event.set()


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: fn(list) -> list becomes fn(item) -> item with dynamic
    batching across concurrent callers."""
    def wrap(fn):
        func_queue: list = []  # lazily-created queue for plain functions
        attr = f"__rtpu_batch_queue_{fn.__name__}"

        @functools.wraps(fn)
        def inner(*args):
            if len(args) == 2:
                # Method: store the queue on the instance so its lifetime
                # (and the captured self) ends with the instance.
                self_obj, item = args
                q = getattr(self_obj, attr, None)
                if q is None:
                    q = _BatchQueue(
                        functools.partial(fn, self_obj),
                        max_batch_size, batch_wait_timeout_s)
                    setattr(self_obj, attr, q)
            else:
                (item,) = args
                if not func_queue:
                    func_queue.append(_BatchQueue(
                        fn, max_batch_size, batch_wait_timeout_s))
                q = func_queue[0]
            return q.submit(item)

        return inner

    return wrap if _fn is None else wrap(_fn)
