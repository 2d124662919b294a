"""In-process execution engine (``init(local_mode=True)``), counterpart of
`ray_tpu/core/local_engine.py`.

Implements the full task/actor/object semantics of the distributed runtime in
one process: ordered actor queues, concurrency groups, retries, named actors,
reference-counted object lifetimes. It is both a debugging mode (like the
reference's local mode) and the executable spec the distributed engine mirrors
(ref semantics: src/ray/core_worker/core_worker.h:291,
transport/actor_scheduling_queue.h ordered dispatch).

Tasks and actor methods run on thread pools, and torch keeps some state
per thread: grad mode, inference mode and the current CUDA device. A call
captures the submitting thread's (`_thread_state`) and runs under it
(`_as_caller`), so a task computes what a direct call would have, and a
call never inherits what an earlier one left on a pooled thread. An async
actor's coroutines run on its event loop's thread as they are.

Where it parts from the JAX package's local engine:
- a stored object pins the objects of the refs serialized inside it until
  it is freed (`_store_value`); there, a ref returned by a task loses its
  object once the task's own ref dies;
- placement groups are records, created at once, and the public API works
  on them (`bundle_labels`, `wait_placement_group`); there,
  ``placement_group()`` raises;
- a ref's release never waits on a lock (`_ref_removed`): it runs from
  ``ObjectRef.__del__``, so from a garbage collection that any allocation
  may start, also one inside the store's lock. There, the store's plain
  lock deadlocks its own thread in that case.
"""
from __future__ import annotations

import asyncio
import contextlib
import inspect
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef, install_refcounter, uninstall_refcounter
from ray_tpu_torch.core.task_spec import TaskOptions
from ray_tpu_torch import exceptions as rexc


def _thread_state() -> tuple:
    """The calling thread's grad mode, inference mode and CUDA device (None
    while CUDA is not initialised in this process)."""
    device = torch.cuda.current_device() if torch.cuda.is_initialized() else None
    return torch.is_grad_enabled(), torch.is_inference_mode_enabled(), device


@contextlib.contextmanager
def _as_caller(state: tuple):
    """Run the body under a captured `_thread_state`, restoring this
    thread's own afterwards."""
    grad, inference, device = state
    with torch.inference_mode(inference), torch.set_grad_enabled(grad), \
            (torch.cuda.device(device) if device is not None
             else contextlib.nullcontext()):
        yield


# How long a ref's release waits for the engine's lock before it leaves the
# release to the lock's next holder (`LocalCoreWorker._ref_removed`).
_RELEASE_LOCK_WAIT_S = 0.05


class _Store:
    """In-memory object store with completion futures."""

    def __init__(self):
        # RLock: a collection started by an allocation inside this lock can
        # run ObjectRef.__del__, which deletes from this store on this thread.
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._data: Dict[ObjectID, bytes] = {}
        self._events: Dict[ObjectID, threading.Event] = {}

    def _event(self, oid: ObjectID) -> threading.Event:
        with self._lock:
            ev = self._events.get(oid)
            if ev is None:
                ev = self._events[oid] = threading.Event()
            return ev

    def put(self, oid: ObjectID, payload: bytes) -> None:
        with self._lock:
            self._data[oid] = payload
            ev = self._events.setdefault(oid, threading.Event())
            self._cond.notify_all()
        ev.set()

    def put_if_absent(self, oid: ObjectID, payload: bytes) -> None:
        with self._lock:
            if oid in self._data:
                return
            self._data[oid] = payload
            ev = self._events.setdefault(oid, threading.Event())
            self._cond.notify_all()
        ev.set()

    def wait_any(self, oids, timeout: Optional[float]) -> None:
        """Block until any of `oids` is present (or timeout)."""
        with self._lock:
            self._cond.wait_for(
                lambda: any(o in self._data for o in oids), timeout)

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._data

    def wait(self, oid: ObjectID, timeout: Optional[float]) -> bool:
        return self._event(oid).wait(timeout)

    def get(self, oid: ObjectID) -> bytes:
        with self._lock:
            return self._data[oid]

    def delete(self, oid: ObjectID) -> None:
        with self._lock:
            self._data.pop(oid, None)
            self._events.pop(oid, None)


class _LocalActor:
    """One actor instance with an ordered dispatch queue.

    Default: a single thread executes calls in submission order (the
    reference's SequentialActorSubmitQueue semantics). With
    ``max_concurrency > 1`` calls run on a pool that wide; async actors run
    coroutine methods concurrently on a dedicated event loop.
    """

    def __init__(self, actor_id: ActorID, cls: type, args, kwargs,
                 options: TaskOptions):
        self.actor_id = actor_id
        self.options = options
        self.name = options.name
        self.dead = False
        self.death_reason = ""
        self._cls = cls
        self._is_async = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(cls, inspect.isfunction)
        )
        maxc = max(1, options.max_concurrency)
        if self._is_async and options.max_concurrency == 1:
            maxc = 1000  # async actors default to high concurrency
        self._pool = ThreadPoolExecutor(
            max_workers=maxc, thread_name_prefix=f"actor-{actor_id.hex()[:8]}"
        )
        self._order_lock = threading.Lock()
        # Return ids of calls accepted but not yet stored — failed with
        # ActorDiedError if the actor is killed first (otherwise get() on
        # them would hang forever).
        self.pending_lock = threading.Lock()
        self.pending_returns: set = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        if self._is_async:
            self._loop = asyncio.new_event_loop()
            t = threading.Thread(target=self._loop.run_forever, daemon=True)
            t.start()
        # Construct synchronously so creation errors surface on first call.
        self.instance = None
        self.creation_error: Optional[BaseException] = None
        try:
            self.instance = cls(*args, **kwargs)
            # Same compiled-DAG escape hatch the distributed worker
            # installs (the reference's `__ray_call__`): it runs as a
            # method call, so under the caller's `_thread_state`.
            inst = self.instance

            def __raytpu_apply__(fn, *a, **kw):
                return fn(inst, *a, **kw)

            try:
                inst.__raytpu_apply__ = __raytpu_apply__
            except AttributeError:
                pass
        except BaseException as e:  # noqa: BLE001
            self.creation_error = e

    def submit(self, method_name: str, args, kwargs, run_and_store) -> None:
        if self._is_async and self._loop is not None:
            method = getattr(self.instance, method_name, None)
            if method is not None and inspect.iscoroutinefunction(method):
                # Resolve blocking arg dependencies on a pool thread, then run
                # the coroutine on the actor's event loop — never block the
                # loop itself (it may be the producer of those very args).
                def dispatch():
                    coro = run_and_store(self, method_name, args, kwargs,
                                         is_async=True)
                    if coro is not None:
                        asyncio.run_coroutine_threadsafe(coro, self._loop)

                self._pool.submit(dispatch)
                return
        if self.options.max_concurrency <= 1 and not self._is_async:
            # ordered execution: single queue
            self._pool.submit(self._run_ordered, method_name, args, kwargs,
                              run_and_store)
        else:
            self._pool.submit(run_and_store, self, method_name, args, kwargs)

    def _run_ordered(self, method_name, args, kwargs, run_and_store):
        with self._order_lock:
            run_and_store(self, method_name, args, kwargs)

    def kill(self, reason: str = "killed via kill()"):
        self.dead = True
        self.death_reason = reason
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)


class LocalCoreWorker:
    """Single-process implementation of the core-worker interface."""

    def __init__(self, num_cpus: Optional[int] = None):
        import os

        self.node_id_hex = "local"
        self.address = "local"
        self._store = _Store()
        ncpu = num_cpus or os.cpu_count() or 8
        self._pool = ThreadPoolExecutor(max_workers=max(4, ncpu),
                                        thread_name_prefix="task")
        self._actors: Dict[ActorID, _LocalActor] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        # RLock: _ref_removed can re-enter from ObjectRef.__del__ during GC
        # triggered while _ref_added already holds the lock on this thread.
        self._lock = threading.RLock()
        self._refcounts: Dict[ObjectID, int] = defaultdict(int)
        # Releases that found the lock taken, done by its next holder.
        self._dropped: deque = deque()
        # Stored object -> the refs serialized inside it, each counted once
        # for as long as the object is stored (ref: reference_count.h's
        # contained-in refs).
        self._contained: Dict[ObjectID, List[ObjectID]] = {}
        self._serializing = threading.local()
        self._cancelled: set = set()
        self._pgs: Dict[str, dict] = {}
        install_refcounter(self._ref_added, self._ref_removed,
                           self._ref_serialized)

    # ---- reference counting ----
    def _ref_added(self, ref: ObjectRef) -> None:
        with self._lock:
            self._release_dropped()
            self._refcounts[ref.id()] += 1

    def _ref_removed(self, ref: ObjectRef) -> None:
        """Called from ObjectRef.__del__, so by whatever thread a collection
        started on, maybe one that holds the store's lock while another
        thread holds this one and waits for the store's. So it waits for
        this lock a moment at most (not at all behind a release already
        left over), and else leaves the release to the lock's next holder."""
        behind = bool(self._dropped)
        self._dropped.append(ref.id())
        if (self._lock.acquire(blocking=False) if behind
                else self._lock.acquire(timeout=_RELEASE_LOCK_WAIT_S)):
            try:
                self._release_dropped()
            finally:
                self._lock.release()

    def _release_dropped(self) -> None:
        """Do the releases left over; the caller holds the lock."""
        while self._dropped:
            try:
                oid = self._dropped.popleft()
            except IndexError:  # a nested call took the last one
                return
            self._release(oid)

    def _release(self, oid: ObjectID) -> None:
        with self._lock:
            n = self._refcounts.get(oid)
            if n is None:
                return
            if n <= 1:
                del self._refcounts[oid]
                self._store.delete(oid)
                for inner in self._contained.pop(oid, ()):
                    self._release(inner)
            else:
                self._refcounts[oid] = n - 1

    def _ref_serialized(self, ref: ObjectRef) -> None:
        refs = getattr(self._serializing, "refs", None)
        if refs is not None:
            refs.append(ref.id())

    # ---- object API ----
    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.from_random()
        self._store_value(oid, value)
        return ObjectRef(oid, self.address)

    def _store_value(self, oid: ObjectID, value: Any) -> None:
        """Store `value`, pinning the objects of the refs inside it while it
        is stored (the module docstring says why)."""
        self._serializing.refs = []
        try:
            payload = serialization.dumps(value)
            inner = self._serializing.refs
        finally:
            self._serializing.refs = None
        if inner:
            with self._lock:
                for i in inner:
                    self._refcounts[i] += 1
                self._contained[oid] = self._contained.get(oid, []) + inner
        self._store.put(oid, payload)

    def _store_error(self, oid: ObjectID, err: BaseException) -> None:
        try:
            payload = serialization.dumps(err, is_error=True)
        except Exception:
            # The user exception (or its cause) is unpicklable — degrade to
            # traceback text so the caller still gets an error, not a hang.
            if isinstance(err, rexc.TaskError):
                stripped = rexc.TaskError(err.function_name, err.traceback_str,
                                          cause=None, pid=err.pid,
                                          node_id=err.node_id)
            else:
                stripped = rexc.TaskError("<unknown>", repr(err))
            payload = serialization.dumps(stripped, is_error=True)
        self._store.put(oid, payload)

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise rexc.GetTimeoutError(
                    f"Get timed out waiting for {ref.hex()}")
            if not self._store.wait(ref.id(), remaining):
                raise rexc.GetTimeoutError(
                    f"Get timed out waiting for {ref.hex()}")
            out.append(serialization.deserialize(self._store.get(ref.id())))
        return out

    def wait(self, refs: List[ObjectRef], num_returns: int,
             timeout: Optional[float], fetch_local: bool = True):
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        pending = list(refs)
        while True:
            still = []
            for r in pending:
                if self._store.contains(r.id()):
                    ready.append(r)
                else:
                    still.append(r)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            self._store.wait_any([r.id() for r in pending], remaining)
            if deadline is not None and time.monotonic() >= deadline:
                break
        ready = ready[:num_returns]
        return ready, [r for r in refs if r not in ready]

    def as_future(self, ref: ObjectRef) -> Future:
        fut: Future = Future()

        def waiter():
            try:
                fut.set_result(self.get([ref])[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=waiter, daemon=True).start()
        return fut

    # ---- task API ----
    def submit_task(self, func, args, kwargs, options: TaskOptions
                    ) -> List[ObjectRef]:
        task_id = TaskID.generate()
        num_returns = options.num_returns
        return_ids = [ObjectID.for_task_return(task_id, i)
                      for i in range(1, num_returns + 1)]
        fname = getattr(func, "__qualname__", str(func))
        caller = _thread_state()

        def run(attempt=0):
            if task_id in self._cancelled:
                for oid in return_ids:
                    self._store_error(oid, rexc.TaskCancelledError(fname))
                return
            try:
                rargs, rkwargs = self._resolve_args(args, kwargs)
                with _as_caller(caller):
                    result = func(*rargs, **rkwargs)
                    if inspect.iscoroutine(result):
                        result = asyncio.run(result)
                self._store_returns(return_ids, num_returns, result, fname)
            except BaseException as e:  # noqa: BLE001
                # Application exceptions only retry when the user opted in
                # (ref: retry_exceptions in ray_option_utils); system errors
                # (worker/node death) are retried by the distributed engine.
                retryable = options.retry_exceptions and not isinstance(
                    e, rexc.RayTpuError)
                if retryable and attempt < options.max_retries:
                    self._pool.submit(run, attempt + 1)
                    return
                err = rexc.TaskError.from_exception(e, fname)
                for oid in return_ids:
                    self._store_error(oid, err)

        self._pool.submit(run)
        return [ObjectRef(oid, self.address) for oid in return_ids]

    def submit_streaming_task(self, func, args, kwargs,
                              options: TaskOptions):
        """num_returns="streaming" in local mode: the generator runs on
        the pool, each yield is stored immediately, and the returned
        iterator hands out refs as they land (same consumable-before-
        completion contract as the distributed engine)."""
        import queue as _queue

        from ray_tpu_torch.core.streaming import LocalRefGenerator

        task_id = TaskID.generate()
        fname = getattr(func, "__qualname__", str(func))
        items: "_queue.Queue" = _queue.Queue()
        caller = _thread_state()

        def run():
            try:
                rargs, rkwargs = self._resolve_args(args, kwargs)
                with _as_caller(caller):
                    result = func(*rargs, **rkwargs)
                    if not inspect.isgenerator(result):
                        raise rexc.TaskError(
                            fname, f"num_returns='streaming' task returned "
                                   f"{type(result).__name__}, not a generator")
                    n = 0
                    for v in result:
                        n += 1
                        oid = ObjectID.for_task_return(task_id, n)
                        self._store_value(oid, v)
                        items.put(("item", ObjectRef(oid, self.address)))
                items.put(("end", None))
            except BaseException as e:  # noqa: BLE001
                items.put(("err", e if isinstance(e, rexc.RayTpuError)
                           else rexc.TaskError.from_exception(e, fname)))

        self._pool.submit(run)
        return LocalRefGenerator(items)

    def _store_returns(self, return_ids, num_returns, result, fname):
        if num_returns == 1:
            self._store_value(return_ids[0], result)
        else:
            if not isinstance(result, (tuple, list)) or len(result) != num_returns:
                err = rexc.TaskError(
                    fname, f"Task declared num_returns={num_returns} but "
                    f"returned {type(result).__name__}")
                for oid in return_ids:
                    self._store_error(oid, err)
                return
            for oid, item in zip(return_ids, result):
                self._store_value(oid, item)

    def _resolve_args(self, args, kwargs):
        def resolve(v):
            if isinstance(v, ObjectRef):
                return self.get([v])[0]
            return v

        return [resolve(a) for a in args], {k: resolve(v)
                                            for k, v in kwargs.items()}

    def cancel(self, ref: ObjectRef, force: bool = False,
               recursive: bool = True) -> None:
        self._cancelled.add(ref.id().task_id())

    # ---- actor API ----
    def create_actor(self, cls, args, kwargs, options: TaskOptions) -> ActorID:
        actor_id = ActorID.generate()
        if options.name:
            key = (options.namespace or "default", options.name)
            with self._lock:
                if key in self._named_actors:
                    raise ValueError(
                        f"Actor name '{options.name}' already taken in "
                        f"namespace '{key[0]}'")
                self._named_actors[key] = actor_id
        rargs, rkwargs = self._resolve_args(args, kwargs)
        actor = _LocalActor(actor_id, cls, rargs, rkwargs, options)
        with self._lock:
            self._actors[actor_id] = actor
        return actor_id

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args,
                          kwargs, options: TaskOptions) -> List[ObjectRef]:
        if options.num_returns == "streaming":
            raise NotImplementedError(
                "actor-method streaming is not supported in local_mode "
                "(task streaming is; or run a real cluster)")
        task_id = TaskID.generate()
        num_returns = options.num_returns
        return_ids = [ObjectID.for_task_return(task_id, i)
                      for i in range(1, num_returns + 1)]
        with self._lock:
            actor = self._actors.get(actor_id)
        if actor is None or actor.dead:
            reason = actor.death_reason if actor else "actor not found"
            err = rexc.ActorDiedError(actor_id.hex(), reason)
            for oid in return_ids:
                self._store_error(oid, err)
            return [ObjectRef(oid, self.address) for oid in return_ids]

        with actor.pending_lock:
            actor.pending_returns.update(return_ids)
        caller = _thread_state()

        def finish():
            with actor.pending_lock:
                actor.pending_returns.difference_update(return_ids)

        def run_and_store(actor: _LocalActor, method_name, args, kwargs,
                          is_async=False):
            fname = f"{actor._cls.__name__}.{method_name}"
            try:
                if actor.creation_error is not None:
                    raise rexc.ActorDiedError(
                        actor_id.hex(),
                        f"creation failed: {actor.creation_error!r}")
                if actor.dead:
                    raise rexc.ActorDiedError(actor_id.hex(),
                                              actor.death_reason)
                rargs, rkwargs = self._resolve_args(args, kwargs)
                method = getattr(actor.instance, method_name)
                with _as_caller(caller):
                    result = method(*rargs, **rkwargs)
                if inspect.iscoroutine(result):
                    if is_async:
                        async def _await_and_store():
                            try:
                                res = await result
                                self._store_returns(return_ids, num_returns,
                                                    res, fname)
                            except BaseException as e:  # noqa: BLE001
                                err = rexc.ActorError.from_exception(e, fname)
                                for oid in return_ids:
                                    self._store_error(oid, err)
                            finally:
                                finish()
                        return _await_and_store()
                    with _as_caller(caller):
                        result = asyncio.run(result)
                self._store_returns(return_ids, num_returns, result, fname)
                finish()
            except BaseException as e:  # noqa: BLE001
                if isinstance(e, rexc.RayTpuError):
                    err = e
                else:
                    err = rexc.ActorError.from_exception(e, fname)
                for oid in return_ids:
                    self._store_error(oid, err)
                finish()
            return None

        actor.submit(method_name, args, kwargs, run_and_store)
        return [ObjectRef(oid, self.address) for oid in return_ids]

    def get_actor(self, name: str, namespace: Optional[str]) -> ActorID:
        key = (namespace or "default", name)
        with self._lock:
            aid = self._named_actors.get(key)
        if aid is None:
            raise ValueError(f"Failed to look up actor '{name}'")
        return aid

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        with self._lock:
            actor = self._actors.get(actor_id)
        if actor is not None:
            actor.kill()
            if actor.name:
                self._named_actors.pop(
                    (actor.options.namespace or "default", actor.name), None)
            # Fail every accepted-but-unfinished call so get() raises instead
            # of hanging (a completed call's result is never overwritten).
            with actor.pending_lock:
                pending = list(actor.pending_returns)
                actor.pending_returns.clear()
            err = rexc.ActorDiedError(actor_id.hex(), actor.death_reason)
            payload = serialization.dumps(err, is_error=True)
            for oid in pending:
                self._store.put_if_absent(oid, payload)

    def actor_state(self, actor_id: ActorID) -> str:
        with self._lock:
            a = self._actors.get(actor_id)
        if a is None:
            return "DEAD"
        return "DEAD" if a.dead else "ALIVE"

    # ---- placement groups (trivially satisfied on one node) ----
    def create_placement_group(self, pg_id, bundles, strategy,
                               name=None, detached=False,
                               bundle_labels=None) -> None:
        with self._lock:
            self._pgs[pg_id.hex()] = {
                "pg_id": pg_id.hex(), "state": "CREATED",
                "nodes": ["local"] * len(bundles), "bundles": bundles,
                "strategy": strategy,
            }

    def get_placement_group(self, pg_id):
        with self._lock:
            return self._pgs.get(pg_id.hex())

    def wait_placement_group(self, pg_id, known_state: str = "PENDING",
                             park_s: float = 0.0):
        """The record at once: a local group is created when asked for."""
        return self.get_placement_group(pg_id)

    def remove_placement_group(self, pg_id) -> None:
        with self._lock:
            pg = self._pgs.get(pg_id.hex())
            if pg is not None:
                pg["state"] = "REMOVED"

    def list_placement_groups(self):
        with self._lock:
            return list(self._pgs.values())

    # ---- internal KV (in-process; mirrors the GCS KV surface) ----
    def kv_put(self, namespace, key, value, overwrite: bool = True) -> bool:
        kv = getattr(self, "_kv_store", None)
        if kv is None:
            kv = self._kv_store = {}
        k = (bytes(namespace), bytes(key))
        if not overwrite and k in kv:
            return False
        kv[k] = value
        return True

    def kv_get(self, namespace, key):
        return getattr(self, "_kv_store", {}).get(
            (bytes(namespace), bytes(key)))

    def kv_del(self, namespace, key) -> bool:
        return getattr(self, "_kv_store", {}).pop(
            (bytes(namespace), bytes(key)), None) is not None

    def kv_keys(self, namespace, prefix: bytes = b"") -> list:
        ns = bytes(namespace)
        return [k for (n, k) in getattr(self, "_kv_store", {})
                if n == ns and k.startswith(prefix)]

    # ---- lifecycle ----
    def shutdown(self) -> None:
        uninstall_refcounter()
        for a in list(self._actors.values()):
            a.kill("shutdown")
        self._pool.shutdown(wait=False, cancel_futures=True)

    # ---- cluster introspection ----
    def cluster_resources(self) -> Dict[str, float]:
        import os

        return {"CPU": float(os.cpu_count() or 8)}

    def available_resources(self) -> Dict[str, float]:
        return self.cluster_resources()

    def nodes(self) -> List[Dict[str, Any]]:
        return [{"NodeID": "local", "Alive": True,
                 "Resources": self.cluster_resources()}]
