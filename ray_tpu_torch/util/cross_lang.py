"""Cross-language workers: call C++-DEFINED remote functions from Python.

The port's copy of `ray_tpu/util/cross_lang.py`: the C++ headers of `cpp/`
speak the port's wire protocol as they speak the JAX package's (the same
`PROTOCOL_VERSION` and typed codec), so one C++ binary serves both.

Counterpart of the C++ worker API (cpp/include/ray_tpu_worker/
ray_tpu_worker.hpp; ref: the reference's C++ worker runtime,
cpp/src/ray/runtime/task/task_executor.cc, and Python-side cross-language
calls, python/ray/cross_language.py). A compiled C++ worker binary
registers functions with RAY_TPU_REMOTE and serves them over the native
frame protocol; `CppWorker` spawns it (handshake: `CPP_WORKER_PORT=` on
stdout), and `.invoke()/.submit()` route calls with the shared Value
data model (None/bool/int/float/bytes/str/list/dict).

    worker = CppWorker("./my_cpp_worker")
    worker.invoke("Add", 2.0, 3.0)          # -> 5.0, blocking
    fut = worker.submit("Add", 1, 2)        # concurrent.futures.Future
    worker.functions()                      # registered names

C++ ACTORS (stateful; ref: cpp/include/ray/api/actor_handle.h —
ActorHandle<T>.Task(&T::Method) with serial per-actor execution):

    h = worker.create_actor("Counter", 10)
    h.call("Inc", 5)                        # -> 15, blocking
    fut = h.submit("Inc", 1)                # ordered: per-handle FIFO
    h.kill()                                # state destroyed
    worker.close()
"""
from __future__ import annotations

import os
import subprocess
import threading
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional

from ray_tpu_torch.core.distributed.rpc import EventLoopThread, SyncRpcClient
from ray_tpu_torch.core.distributed.wire import CODEC_TYPED


class CppFunctionError(Exception):
    """A C++ remote function raised / was not found."""


def _unwrap(reply: dict) -> Any:
    """Unpack the app-level {'ok', 'value'|'error'} envelope."""
    if not reply.get("ok"):
        raise CppFunctionError(reply.get("error", "unknown error"))
    return reply.get("value")


def _reap_actor(worker_ref, actor_id: int, serial) -> None:
    """GC finalizer for a dropped handle: C++ actors die with their
    last handle, like Python actors (must not reference the handle)."""
    serial.shutdown(wait=False)
    w = worker_ref()
    if w is None or w._closed:
        return
    try:
        w._client.call("CppWorker", "kill_actor", timeout=5,
                       actor_id=actor_id)
    except Exception:  # noqa: BLE001 worker already gone
        pass


class CppActorHandle:
    """Handle to a stateful actor living in the C++ worker process.

    Method calls execute SERIALLY on the instance (C++ side holds a
    per-instance mutex) and `submit()` preserves per-handle submission
    order with a single dispatch thread — the same ordering contract
    Python actor handles give their callers. A method that raises keeps
    the actor alive (matching Python actors: task errors are not actor
    deaths); `kill()` destroys the instance, after which every call
    fails with a clear "no such C++ actor" error.
    """

    def __init__(self, worker: "CppWorker", actor_id: int,
                 type_name: str):
        self._worker = worker
        self._id = actor_id
        self._type = type_name
        self._serial = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"cpp-actor-{actor_id}")
        self._finalizer = weakref.finalize(
            self, _reap_actor, weakref.ref(worker), actor_id,
            self._serial)

    @property
    def actor_id(self) -> int:
        return self._id

    def _call_rpc(self, method: str, args: tuple,
                  timeout: float) -> Any:
        return _unwrap(self._worker._client.call(
            "CppWorker", "call_actor", timeout=timeout,
            actor_id=self._id, name=method, args=list(args)))

    def call(self, method: str, *args: Any,
             timeout: float = 60.0) -> Any:
        """Invoke an actor method; blocks for the result. Rides the
        same serial dispatch thread as submit(), so a blocking call
        always observes every earlier submission from this handle."""
        return self.submit(method, *args, timeout=timeout).result()

    def submit(self, method: str, *args: Any,
               timeout: float = 60.0) -> "Future":
        """Async call; per-handle FIFO ordering is guaranteed."""
        return self._serial.submit(self._call_rpc, method, args,
                                   timeout)

    def kill(self, timeout: float = 30.0) -> None:
        """Destroy the actor instance (idempotence is an error: a
        second kill raises, mirroring ray.kill on a dead actor)."""
        self._serial.shutdown(wait=True)
        self._serial = ThreadPoolExecutor(   # handle stays usable for
            max_workers=1,                   # error-path calls
            thread_name_prefix=f"cpp-actor-{self._id}")
        self._finalizer.detach()             # kill is explicit now
        _unwrap(self._worker._client.call(
            "CppWorker", "kill_actor", timeout=timeout,
            actor_id=self._id))

    def __repr__(self) -> str:
        return f"CppActorHandle({self._type}#{self._id})"


class CppWorker:
    """Owns one C++ worker process and a connection pool to it."""

    def __init__(self, binary: str, *, args: Optional[List[str]] = None,
                 startup_timeout_s: float = 30.0, max_concurrency: int = 8):
        if not os.path.exists(binary):
            raise FileNotFoundError(f"C++ worker binary {binary!r}")
        from ray_tpu_torch.core.distributed.driver import (
            pdeathsig_preexec,
            _read_handshake,
        )

        self._proc = subprocess.Popen(
            [binary, *(args or [])], stdout=subprocess.PIPE, stderr=None,
            preexec_fn=pdeathsig_preexec)
        info = _read_handshake(self._proc, r"CPP_WORKER_PORT=(?P<port>\d+)",
                               "C++ worker")
        self.address = f"127.0.0.1:{info['port']}"
        self._loop = EventLoopThread("cpp-worker")
        # The typed wire codec is the cross-language contract: C++
        # workers never see pickle (wire.py; ref: the reference's
        # proto3 cross-language seam).
        self._client = SyncRpcClient(self.address, self._loop,
                                     codec=CODEC_TYPED)
        self._pool = ThreadPoolExecutor(
            max_workers=max_concurrency,
            thread_name_prefix="cpp-worker-call")
        self._closed = False
        self._lock = threading.Lock()

    # -- calls ----------------------------------------------------------
    def invoke(self, fn: str, *args: Any, timeout: float = 60.0) -> Any:
        """Call a registered C++ function; blocks for the result."""
        return _unwrap(self._client.call("CppWorker", "invoke",
                                         timeout=timeout, fn=fn,
                                         args=list(args)))

    def submit(self, fn: str, *args: Any,
               timeout: float = 60.0) -> "Future":
        """Async call; returns a concurrent.futures.Future."""
        return self._pool.submit(self.invoke, fn, *args, timeout=timeout)

    def functions(self, timeout: float = 10.0) -> List[str]:
        return sorted(_unwrap(self._client.call(
            "CppWorker", "list_functions", timeout=timeout)) or [])

    def ping(self, timeout: float = 10.0) -> bool:
        reply = self._client.call("CppWorker", "ping", timeout=timeout)
        return reply.get("value") == "pong"

    # -- actors ---------------------------------------------------------
    def create_actor(self, type_name: str, *args: Any,
                     timeout: float = 60.0) -> CppActorHandle:
        """Construct a registered C++ actor; returns its handle."""
        actor_id = _unwrap(self._client.call(
            "CppWorker", "create_actor", timeout=timeout,
            type=type_name, args=list(args)))
        return CppActorHandle(self, int(actor_id), type_name)

    def actor_types(self, timeout: float = 10.0) -> List[str]:
        return sorted(_unwrap(self._client.call(
            "CppWorker", "list_actor_types", timeout=timeout)) or [])

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pool.shutdown(wait=False)
        self._client.close()
        self._loop.stop()
        try:
            self._proc.terminate()
            self._proc.wait(timeout=5)
        except Exception:  # noqa: BLE001
            try:
                self._proc.kill()
            except Exception:  # noqa: BLE001
                pass

    def __enter__(self) -> "CppWorker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
