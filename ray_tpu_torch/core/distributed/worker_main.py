"""Worker process: executes tasks and hosts at most one actor.

The port's copy of `ray_tpu/core/distributed/worker_main.py`,
importing `ray_tpu_torch` only.

Analogue of the reference worker (ref: python/ray/_private/workers/
default_worker.py bootstrapping a C++ CoreWorker; task execution callback
_raylet.pyx:2251; actor call ordering transport/actor_scheduling_queue.h).
Exposes a `Worker` RPC service the submitters push tasks to directly after a
lease grant (the reference's CoreWorkerService.PushTask,
core_worker.proto:430).
"""
from __future__ import annotations

import argparse
import asyncio
import inspect
import logging
import os
import sys
import threading
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from ray_tpu_torch import exceptions as rexc
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import ObjectExistsError
from ray_tpu_torch.core.distributed import protocol
from ray_tpu_torch.core.distributed.core_worker import DistributedCoreWorker
from ray_tpu_torch.core.distributed.rpc import AsyncRpcClient, RpcServer
from ray_tpu_torch.util.profiling import TaskUsageProbe

logger = logging.getLogger(__name__)


class ActorRuntime:
    """Hosts the single actor instance of this worker; enforces per-caller
    submission-order execution (ref: SequentialActorSubmitQueue +
    actor_scheduling_queue.h), with `max_concurrency` pools and async-actor
    event-loop concurrency.

    ANY async method — coroutine or async generator — makes the actor an
    asyncio actor (the reference's rule): default concurrency becomes
    1000 and sync methods lose strict serialization. Keep state-mutating
    methods sync-only in a sync actor, or guard shared state, exactly as
    with the reference's async actors."""

    def __init__(self, instance, max_concurrency: int,
                 concurrency_groups: Optional[Dict[str, int]] = None):
        self.instance = instance
        self._is_async = any(
            inspect.iscoroutinefunction(m)
            or inspect.isasyncgenfunction(m)
            for _, m in inspect.getmembers(type(instance),
                                           inspect.isfunction))
        maxc = max(1, max_concurrency)
        if self._is_async and max_concurrency == 1:
            maxc = 1000
        self.max_concurrency = maxc
        # Named concurrency groups (ref: concurrency_group_manager.h):
        # each group is its own pool, so a blocked "compute" call can
        # never stall "io" calls. Methods pick their group with
        # @ray_tpu.method(concurrency_group=...); undecorated methods
        # run in the default pool. Groups apply to sync methods — async
        # methods keep the shared actor event loop.
        self._groups: Dict[str, ThreadPoolExecutor] = {}
        self._method_groups: Dict[str, str] = {}
        if concurrency_groups:
            for gname, cap in concurrency_groups.items():
                self._groups[gname] = ThreadPoolExecutor(
                    max_workers=max(1, int(cap)),
                    thread_name_prefix=f"cg-{gname}")
        # Scan decorated methods even with NO groups declared: a
        # @method(concurrency_group=...) pointing at an undeclared
        # group must fail loudly, not silently lose its isolation.
        for mname, m in inspect.getmembers(type(instance), callable):
            g = getattr(m, "__ray_tpu_concurrency_group__", None)
            if g is not None:
                if g not in self._groups:
                    raise ValueError(
                        f"method {mname!r} declares concurrency group "
                        f"{g!r} but the actor declares "
                        f"{sorted(self._groups) or 'no groups'} "
                        f"(@remote(concurrency_groups={{...}}))")
                self._method_groups[mname] = g
        # Per-caller ordered batch execution only when ONE serial pool
        # exists: with groups, routing decides the pool per method.
        self._ordered = (maxc == 1 and not self._is_async
                         and not self._groups)
        self._pool = ThreadPoolExecutor(max_workers=maxc)
        self._expected: Dict[str, int] = defaultdict(int)
        self._buffered: Dict[str, Dict[int, Any]] = defaultdict(dict)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        if self._is_async:
            self._loop = asyncio.new_event_loop()
            threading.Thread(target=self._loop.run_forever,
                             daemon=True).start()

    def admit(self, spec: dict, execute) -> "asyncio.Future":
        """Admit in per-caller seq order; the returned future resolves to
        the reply. Plain-future API so a batch RPC admits N specs without
        N coroutine Tasks.

        Ordering key: the caller's per-incarnation order_key (seqs start
        at 0 for every fresh incarnation — the submitter renumbers on
        restart, see core_worker._assign_actor_seq)."""
        caller = spec.get("order_key") or spec["caller_address"]
        seq = spec["seq"]
        main_loop = asyncio.get_running_loop()
        fut: asyncio.Future = main_loop.create_future()
        if seq < self._expected[caller]:
            # Stale-but-valid retry (same incarnation): run immediately
            # rather than orphaning it below the already-advanced base.
            self._dispatch(spec, fut, execute, main_loop)
            return fut
        self._buffered[caller][seq] = (spec, fut)
        self._drain(caller, execute, main_loop)
        return fut

    async def submit(self, spec: dict, execute) -> dict:
        return await self.admit(spec, execute)

    def _drain(self, caller: str, execute, main_loop) -> None:
        buf = self._buffered[caller]
        ready = []
        while self._expected[caller] in buf:
            seq = self._expected[caller]
            ready.append(buf.pop(seq))
            self._expected[caller] += 1
        if not ready:
            return
        if self._ordered and len(ready) > 1:
            # Ordered sync actor (every method sync when _ordered): run
            # the whole contiguous run in ONE pool job — per-call thread
            # dispatch would cost more than the methods themselves. Reply
            # delivery is chunked: one loop wakeup per 64 replies instead
            # of per reply (each call_soon_threadsafe is a syscall + a
            # GIL fight with the executing thread).
            def run_batch():
                chunk = []

                def flush():
                    items, chunk[:] = chunk[:], []

                    def deliver():
                        for f, r in items:
                            if not f.done():
                                f.set_result(r)

                    main_loop.call_soon_threadsafe(deliver)

                for spec, fut in ready:
                    chunk.append((fut, execute(spec)))
                    if len(chunk) >= 64:
                        flush()
                if chunk:
                    flush()

            self._pool.submit(run_batch)
            return
        for spec, fut in ready:
            self._dispatch(spec, fut, execute, main_loop)

    def _dispatch(self, spec, fut, execute, main_loop) -> None:
        method = getattr(self.instance, spec["method_name"], None)
        if (self._loop is not None and method is not None
                and (inspect.iscoroutinefunction(method)
                     or inspect.isasyncgenfunction(method))):
            async def run_async():
                # Arg resolution may block (remote gets): run it on the pool
                # and await via wrap_future (works across loops — the future
                # from another loop's run_in_executor would not).
                reply = await asyncio.wrap_future(
                    self._pool.submit(execute, spec, True))
                if isinstance(reply, dict):       # arg resolution failed
                    main_loop.call_soon_threadsafe(
                        lambda: fut.done() or fut.set_result(reply))
                    return
                args, kwargs = reply
                out = await execute(spec, coro_args=(args, kwargs))
                main_loop.call_soon_threadsafe(
                    lambda: fut.done() or fut.set_result(out))

            asyncio.run_coroutine_threadsafe(run_async(), self._loop)
            return

        def run_sync():
            reply = execute(spec)
            main_loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(reply))

        group = self._method_groups.get(spec["method_name"])
        pool = self._groups[group] if group is not None else self._pool
        pool.submit(run_sync)


# Module-level progress probes: long-running in-process loops (e.g. the
# train session) register a zero-arg callable returning a running-task
# style entry whose `start_ts` is the loop's LAST PROGRESS timestamp.
# `running_tasks` folds these in, so the daemon's hung-task watchdog
# flags a loop that stopped reporting — not one that is merely long.
_progress_probes: Dict[str, Any] = {}
_progress_lock = threading.Lock()


def register_progress_probe(name: str, fn) -> None:
    with _progress_lock:
        _progress_probes[name] = fn


def unregister_progress_probe(name: str) -> None:
    with _progress_lock:
        _progress_probes.pop(name, None)


class WorkerService:
    def __init__(self, core: DistributedCoreWorker, worker_id: str):
        self.core = core
        self.worker_id = worker_id
        self.actor: Optional[ActorRuntime] = None
        self.actor_id: Optional[str] = None
        self._task_pool = ThreadPoolExecutor(max_workers=4,
                                             thread_name_prefix="exec")
        # Async-stream item stores get their OWN thread: offloading to
        # _task_pool could circular-wait (a pooled task blocked on a
        # stream item whose store needs a pool slot).
        self._stream_store_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="stream-store")
        self._max_inline = get_config().max_inline_object_size
        # task_id -> executing thread ident, for cooperative
        # cancellation of RUNNING tasks (ref: CancelTask interrupting
        # the worker): cancel_task injects KeyboardInterrupt into the
        # thread at the next bytecode boundary.
        self._executing: Dict[bytes, int] = {}
        # max_calls retirement (ref: worker lifetime bounded per
        # executed-invocation count OF THAT FUNCTION — bounds leaks
        # from user/native code without churning mixed workloads).
        self._exec_counts: Dict[bytes, int] = {}
        self._retire_after_reply = False
        # Insertion-ordered (dict) so bounding evicts the OLDEST
        # tombstones, never a cancel that just arrived.
        self._cancelled_here: Dict[bytes, None] = {}
        # Makes interrupt injection atomic with execution membership:
        # cancel_task injects ONLY while the target is registered, and
        # deregistration (finally) takes the same lock — so a pending
        # KeyboardInterrupt always lands inside _execute's try, never
        # escaping into the pool's worker loop (which would kill the
        # pool thread permanently).
        self._exec_lock = threading.Lock()
        # Task-event pipeline (task_events.py TaskEventBuffer on the
        # core, ref: gcs_task_manager.h — powers `ray-tpu list tasks`
        # and the chrome-trace timeline): bounded ring + coalescing
        # flusher, drops counted instead of silent.
        self.core.task_events.worker_id = worker_id
        # Per-task resource attribution (profiling.TaskUsageProbe):
        # thread CPU-time + RSS delta/peak per attempt, riding the
        # attempt's task-event record. Resolved once — workers get the
        # knob through their spawn env.
        self._attrib = get_config().task_events_resources
        # task_id -> live attempt info for the daemon's hung-task
        # watchdog (`running_tasks` RPC). Plain dict, GIL-atomic
        # set/pop of whole entries; readers snapshot with list().
        self._running_info: Dict[bytes, dict] = {}
        # Pre-leased task lanes pinned to this worker: lane_id -> the
        # spec template the per-call delta frames are expanded against
        # (fn_key/name/job_id travel ONCE at lane_open, never per call).
        self._lanes: Dict[str, dict] = {}
        # Compiled-DAG stage loops (lane_apply) get their own threads:
        # they run for the DAG's lifetime, and parking one in
        # _task_pool would wedge the retirement drain.
        self._lane_pool: Optional[ThreadPoolExecutor] = None

    def _record_event(self, spec: dict, state: str, start_ts: float,
                      end_ts: float, error: Optional[str] = None,
                      usage: Optional[dict] = None) -> None:
        """Record an attempt's FULL history in one coalesced record: the
        submission half (SUBMITTED/LEASED timestamps + caller identity)
        rides the spec itself, so the happy path ships a single wire
        record per attempt instead of two GCS-merged halves. `usage` is
        the attempt's resource attribution (TaskUsageProbe.finish())."""
        transitions = []
        sub_ts = spec.get("submit_ts")
        ctx = spec.get("submit_ctx") or (None, None)
        if sub_ts is not None:
            transitions.append(("SUBMITTED", sub_ts))
        lease_ts = spec.get("lease_ts")
        if lease_ts is not None:
            transitions.append(("LEASED", lease_ts))
        transitions.append(("RUNNING", start_ts))
        transitions.append((state, end_ts))
        self.core.task_events.record_attempt(
            spec["task_id"].hex(), spec.get("attempt", 0), transitions,
            error=error, name=spec["options"].get("name", "task"),
            job_id=spec.get("job_id"), actor_id=spec.get("actor_id"),
            worker_id=self.worker_id, pid=os.getpid(),
            submit_node_id=ctx[0], submit_pid=ctx[1], **(usage or {}))

    # ---- helpers ------------------------------------------------------
    def _fetch_arg(self, oid: ObjectID,
                   owner: Optional[str] = None) -> Any:
        from ray_tpu_torch.core.distributed.pull_manager import PRIORITY_TASK_ARG

        # The owner address (from the RefMarker) routes small values to
        # the owner's inline cache when the store/directory has no copy.
        return self.core.get([_mkref(oid, owner)], timeout=300,
                             _priority=PRIORITY_TASK_ARG)[0]

    def _store_results(self, spec: dict, value: Any,
                       is_error: bool = False) -> List[protocol.TaskResult]:
        num_returns = spec["num_returns"]
        task_id_b = spec["task_id"]
        out: List[protocol.TaskResult] = []
        if is_error:
            values = [value] * num_returns
        elif num_returns == 1:
            values = [value]
        elif isinstance(value, (tuple, list)) and len(value) == num_returns:
            values = list(value)
        else:
            err = rexc.TaskError(
                spec["options"].get("name", "task"),
                f"declared num_returns={num_returns} but returned "
                f"{type(value).__name__}")
            return self._store_results(spec, err, is_error=True)
        from ray_tpu_torch.core.ids import TaskID

        task_id = TaskID(task_id_b)
        for i, v in enumerate(values):
            oid = ObjectID.for_task_return(task_id, i + 1)
            if v is None and not is_error:
                # The most common return on control-flow hot paths
                # (noop tasks, side-effect actors): one cached payload.
                payload = _none_payload()
                meta = bufs = None
                size = len(payload)
            else:
                # Serialize to (header, out-of-band buffers) and only
                # materialize a contiguous payload when it fits inline;
                # large results land in the store mmap via put_serialized
                # — one copy, no BytesIO round-trip.
                meta, bufs = serialization.serialize(v, is_error=is_error)
                size = serialization.serialized_size(meta, bufs)
                payload = (serialization.concat(meta, bufs)
                           if size <= self._max_inline else None)
            inline = payload if size <= self._max_inline else None
            if inline is not None:
                # The caller consumes the inline copy from the reply and
                # becomes the object's authoritative copy: third-party
                # readers fetch from the OWNER (OwnerService), so the
                # happy path makes no store write or directory record
                # (ref: owner-based in-process memory store,
                # core_worker.cc HandleGetObjectStatus). RETRIED tasks
                # write through: if this attempt's reply is lost too,
                # the next retry converges via _existing_results
                # instead of re-running the body again.
                if spec.get("attempt", 0) or spec.get("_lane_retries"):
                    try:
                        self.core.store.put_raw(oid, payload)
                    except ObjectExistsError:
                        pass
                    except Exception:  # noqa: BLE001 store full
                        pass
                    else:
                        self.core.queue_location(
                            oid, size, owner=spec.get("caller_address"))
            else:
                # No inline copy: the store write must land before the
                # reply or the caller's get() would race a missing object.
                try:
                    if payload is not None:
                        self.core.store.put_raw(oid, payload)
                    else:
                        self.core.store.put_serialized(oid, meta, bufs)
                except ObjectExistsError:
                    # Retried task, contents identical; still re-register —
                    # the first attempt may have died before add_location.
                    pass
                self.core.queue_location(oid, size,
                                         owner=spec.get("caller_address"))
            out.append(protocol.TaskResult(oid=oid.binary(),
                                           size=size,
                                           inline=inline,
                                           is_error=is_error))
        return out

    def _stream_reply(self, spec: dict, result: Any, start_ts: float,
                      error_cls=None, probe=None) -> dict:
        """Run the streaming body + record the task event (shared by
        the task and actor execution paths)."""
        import time as _time

        reply = self._execute_stream(spec, result, error_cls=error_cls)
        self._record_event(
            spec, "FAILED" if reply["error"] else "FINISHED",
            start_ts, _time.time(),
            error=repr(reply["error"]) if reply["error"] else None,
            usage=probe.finish() if probe is not None else None)
        return reply

    def _execute_stream(self, spec: dict, result: Any,
                        error_cls=None) -> dict:
        """Streaming task body: each yield is stored + its location
        registered IMMEDIATELY (consumers discover in-flight items
        through the directory, core/streaming.py); the reply carries
        the full item list (with inline copies of small values) so the
        owner can fix the final count and serve completed-stream gets
        locally."""
        from ray_tpu_torch.core.ids import TaskID

        error_cls = error_cls or rexc.TaskError
        name = spec["options"].get("name", "task")
        if not inspect.isgenerator(result):
            return {"results": [], "error": error_cls(
                name, f"num_returns='streaming' task returned "
                      f"{type(result).__name__}, not a generator")}
        task_id = TaskID(spec["task_id"])
        results: List[protocol.TaskResult] = []
        error = None
        try:
            # Register for cancel-interrupt injection around the
            # ITERATION (the generator body runs here, not at fn()-call
            # time in _execute, whose registration window closed before
            # the first yield executed). The tombstone check happens
            # ATOMICALLY with registration: a cancel that landed in the
            # unregistered gap left only the tombstone (no thread to
            # interrupt) — honoring it without registering means
            # cancel_task can never ALSO inject (it only injects at
            # registered tasks, under this same lock), so no stray
            # second interrupt escapes to a later task.
            precancelled = False
            with self._exec_lock:
                if spec["task_id"] in self._cancelled_here:
                    precancelled = True
                else:
                    self._executing[spec["task_id"]] = \
                        threading.get_ident()
            try:
                if precancelled:
                    raise KeyboardInterrupt  # handler consumes tombstone
                for i, v in enumerate(result, start=1):
                    results.append(self._store_stream_item(
                        task_id, i, v, spec.get("caller_address")))
            finally:
                with self._exec_lock:
                    self._executing.pop(spec["task_id"], None)
        except BaseException as e:  # noqa: BLE001
            # Same stray-interrupt discipline as _execute: deregister
            # again (idempotent — injection can land mid-finally).
            with self._exec_lock:
                self._executing.pop(spec["task_id"], None)
            if isinstance(e, KeyboardInterrupt):
                if spec["task_id"] in self._cancelled_here:
                    self._cancelled_here.pop(spec["task_id"], None)
                    error = rexc.TaskCancelledError(name)
                else:
                    error = rexc.WorkerCrashedError(
                        f"stream {name} interrupted by a stray cancel")
            else:
                error = (e if isinstance(e, rexc.RayTpuError)
                         else error_cls.from_exception(
                             e, name, pid=os.getpid(),
                             node_id=self.core.node_id))
        return {"results": results, "error": error}

    def _store_stream_item(self, task_id, i: int, v: Any,
                           owner: Optional[str] = None
                           ) -> protocol.TaskResult:
        """Store + register one stream yield so consumers discover it
        immediately (shared by the sync and async-generator paths);
        `owner` is the caller, whose death frees the item."""
        oid = ObjectID.for_task_return(task_id, i)
        meta, bufs = serialization.serialize(v)
        size = serialization.serialized_size(meta, bufs)
        inline = (serialization.concat(meta, bufs)
                  if size <= self._max_inline else None)
        try:
            if inline is not None:
                self.core.store.put_raw(oid, inline)
            else:
                # Large stream items: one copy straight into the store
                # mmap (no contiguous dumps() intermediate).
                self.core.store.put_serialized(oid, meta, bufs)
        except ObjectExistsError:
            pass   # retried stream: identical contents
        self.core.queue_location(oid, size, owner=owner)
        return protocol.TaskResult(oid=oid.binary(), size=size,
                                   inline=inline, is_error=False)

    async def _execute_stream_async(self, spec: dict, agen,
                                    start_ts: float, name: str) -> dict:
        """Async-generator actor methods: same per-item storage, driven
        by `async for`. Serialization + store writes are offloaded to
        the task pool — the actor's event loop (shared by every
        in-flight coroutine method) must not block on store I/O."""
        import time as _time

        from ray_tpu_torch.core.ids import TaskID

        loop = asyncio.get_running_loop()
        task_id = TaskID(spec["task_id"])
        results: List[protocol.TaskResult] = []
        error = None
        try:
            i = 0
            async for v in agen:
                i += 1
                results.append(await loop.run_in_executor(
                    self._stream_store_pool, self._store_stream_item,
                    task_id, i, v, spec.get("caller_address")))
        except BaseException as e:  # noqa: BLE001
            # Close promptly: the user generator's finally blocks must
            # not wait for the loop's asyncgen GC finalizer.
            try:
                await agen.aclose()
            except BaseException:  # noqa: BLE001
                pass
            error = (e if isinstance(e, rexc.RayTpuError)
                     else rexc.ActorError.from_exception(
                         e, name, pid=os.getpid(),
                         node_id=self.core.node_id))
        self._record_event(
            spec, "FAILED" if error else "FINISHED", start_ts,
            _time.time(), error=repr(error) if error else None)
        return {"results": results, "error": error}

    def _existing_results(self, spec: dict) -> Optional[List[
            protocol.TaskResult]]:
        """Retry memoization: if a prior attempt already stored every
        return of this task in the node's store (the attempt's reply died
        with its RPC, not its results), reuse them instead of re-running
        the function — retried batches converge instead of repeating
        completed work (return ObjectIDs are attempt-independent)."""
        from ray_tpu_torch.core.ids import TaskID

        task_id = TaskID(spec["task_id"])
        out: List[protocol.TaskResult] = []
        for i in range(spec["num_returns"]):
            oid = ObjectID.for_task_return(task_id, i + 1)
            buf = self.core.store.get_buffer(oid)
            if buf is None:
                return None
            try:
                payload = bytes(buf.view)
            finally:
                buf.release()
            is_err = serialization.is_error_payload(payload)
            inline = (payload if len(payload) <= self._max_inline
                      else None)
            if is_err and inline is None:
                return None  # can't rebuild the error reply; re-execute
            self.core.queue_location(oid, len(payload),
                                     owner=spec.get("caller_address"))
            out.append(protocol.TaskResult(
                oid=oid.binary(), size=len(payload), inline=inline,
                is_error=is_err))
        return out

    def _running_entry(self, spec: dict, name: str) -> dict:
        import time as _time

        actor_id = spec.get("actor_id")
        return {
            "task_id": spec["task_id"].hex(),
            "attempt": spec.get("attempt", 0),
            "name": name,
            "job_id": spec.get("job_id"),
            "actor_id": (actor_id.hex() if isinstance(actor_id, bytes)
                         else actor_id),
            "start_ts": _time.time(),
        }

    def _execute(self, spec: dict) -> dict:
        """Tracked execution: the attempt is visible to the daemon's
        hung-task watchdog (`running_tasks`) for exactly as long as it
        occupies an executor thread."""
        key = spec["task_id"]
        self._running_info[key] = self._running_entry(
            spec, spec["options"].get("name", "task"))
        try:
            return self._execute_task(spec)
        finally:
            self._running_info.pop(key, None)

    def _execute_task(self, spec: dict) -> dict:
        name = spec["options"].get("name", "task")
        if (spec.get("attempt", 0) or spec.get("_lane_retries")) \
                and not spec["options"].get("streaming"):
            # (streaming: num_returns==0 would make the empty prior list
            # read as a memoized success; restarts are idempotent anyway
            # — item ObjectIDs are attempt-independent.)
            prior = self._existing_results(spec)
            if prior is not None:
                err = None
                if prior and prior[0].is_error:
                    try:
                        serialization.deserialize(prior[0].inline)
                    except BaseException as e:  # noqa: BLE001 the payload
                        err = e
                return {"results": prior, "error": err}
        import time as _time

        start_ts = _time.time()
        if spec["task_id"] in self._cancelled_here:
            # Cancelled while queued in an in-flight batch on THIS
            # worker: never execute (and never charge max_calls budget).
            self._cancelled_here.pop(spec["task_id"], None)
            err = rexc.TaskCancelledError(name)
            self._record_event(spec, "FAILED", start_ts, _time.time(),
                               error=repr(err))
            return {"results": [], "error": err}
        if self._retire_after_reply:
            # Budget exhausted: hand the spec back to the lane (the
            # `requeue` sentinel re-queues WITHOUT charging the task's
            # retry budget — the task never executed).
            return {"requeue": True, "results": [], "error": None}
        mc = spec["options"].get("max_calls") or 0
        if mc:
            # Under _exec_lock: up to 4 pool threads race this RMW, and a
            # lost increment would let the worker exceed its budget.
            with self._exec_lock:
                n = self._exec_counts.get(spec["fn_key"], 0) + 1
                self._exec_counts[spec["fn_key"]] = n
                if n >= mc:
                    self._retire_after_reply = True
        # RUNNING is visible mid-execution (long tasks show up in
        # list_tasks before they finish), not only in the terminal
        # record's back-dated history. Lean on purpose: the buffer
        # stamps executor identity, the terminal record fills the rest.
        self.core.task_events.record_status(
            spec["task_id"].hex(), spec.get("attempt", 0), "RUNNING",
            ts=start_ts, name=name, job_id=spec.get("job_id"))
        probe = TaskUsageProbe() if self._attrib else None
        try:
            fn = self.core.fetch_function(spec["fn_key"])
            args, kwargs = protocol.unpack_args(spec["args_blob"],
                                                self._fetch_arg)
            from ray_tpu_torch.util import tracing

            with tracing.extract_and_span(spec.get("trace_ctx"),
                                          f"task:{name}",
                                          task_id=spec["task_id"].hex()):
                with self._exec_lock:
                    self._executing[spec["task_id"]] = \
                        threading.get_ident()
                try:
                    result = fn(*args, **kwargs)
                    if inspect.iscoroutine(result):
                        result = asyncio.run(result)
                finally:
                    with self._exec_lock:
                        self._executing.pop(spec["task_id"], None)
                if spec["options"].get("streaming"):
                    return self._stream_reply(spec, result, start_ts,
                                              probe=probe)
            reply = {"results": self._store_results(spec, result),
                     "error": None}
            self._record_event(spec, "FINISHED", start_ts, _time.time(),
                               usage=probe.finish() if probe else None)
            return reply
        except BaseException as e:  # noqa: BLE001
            # An injected interrupt can land BEFORE the inner try or
            # WHILE its finally acquires the lock, skipping the pop —
            # deregister again (idempotent) so no stale entry can route
            # a later injection at an innocent task.
            with self._exec_lock:
                self._executing.pop(spec["task_id"], None)
            if isinstance(e, KeyboardInterrupt):
                if spec["task_id"] in self._cancelled_here:
                    self._cancelled_here.pop(spec["task_id"], None)
                    err = rexc.TaskCancelledError(name)
                else:
                    # An injected interrupt that landed AFTER its
                    # target finished hit this unrelated task: surface
                    # as a retryable system failure, not an app error.
                    err = rexc.WorkerCrashedError(
                        f"task {name} interrupted by a stray cancel")
            elif isinstance(e, rexc.RayTpuError):
                err = e
            else:
                err = rexc.TaskError.from_exception(
                    e, name, pid=os.getpid(),
                    node_id=self.core.node_id)
            try:
                self._store_results(spec, err, is_error=True)
            except Exception:  # noqa: BLE001
                pass
            self._record_event(spec, "FAILED", start_ts, _time.time(),
                               error=repr(e),
                               usage=probe.finish() if probe else None)
            return {"results": [], "error": err}

    # ---- RPC surface --------------------------------------------------
    def _maybe_retire(self) -> None:
        """Exit (after the reply flushes) once a task whose max_calls
        budget this worker exhausted has completed; the daemon's pool
        respawns and lease holders ride the ordinary worker-death retry
        path."""
        if not self._retire_after_reply:
            return
        if getattr(self, "_retiring", False):
            return
        self._retiring = True
        logger.info("worker retiring (max_calls reached)")

        def die():
            import time as _time

            # Drain first: a task still executing in another pool slot
            # must finish before exit, or its side effects run twice —
            # the lane's connection-failure requeue does NOT charge
            # max_retries (the reference drains the worker before exit).
            # Pool shutdown (not an _executing poll) so a spec still
            # fetching args counts too; specs that reach _execute after
            # the retire flag get the `requeue` sentinel and finish
            # instantly. Join is bounded: a never-ending task shouldn't
            # pin the worker slot forever.
            waiter = threading.Thread(
                target=lambda: self._task_pool.shutdown(wait=True),
                daemon=True)
            waiter.start()
            waiter.join(60.0)
            # Then long enough for the (local-socket) reply bytes to
            # flush; refused specs are requeued by the lane with a delay
            # spanning this window, so they re-lease a fresh worker.
            _time.sleep(0.2)
            os._exit(0)

        threading.Thread(target=die, daemon=True).start()

    async def cancel_task(self, task_id: bytes) -> dict:
        """Interrupt a RUNNING task (ref: CancelTask): injects
        KeyboardInterrupt into the executing thread, which lands at the
        next Python bytecode boundary (a task blocked in a C call —
        time.sleep, a jitted step — is interrupted when it returns).
        Best-effort by design."""
        self._cancelled_here[task_id] = None
        # Bound the tombstones: a cancel that misses (task already
        # finished) would otherwise leak its entry forever. Oldest-first
        # eviction cannot drop the entry just added.
        while len(self._cancelled_here) > 4096:
            del self._cancelled_here[next(iter(self._cancelled_here))]
        import ctypes

        with self._exec_lock:
            tid = self._executing.get(task_id)
            if tid is None:
                return {"interrupted": False}
            n = ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tid), ctypes.py_object(KeyboardInterrupt))
            if n > 1:   # should not happen; undo rather than spray
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(tid), None)
        return {"interrupted": n == 1}

    async def push_task(self, spec: dict) -> dict:
        loop = asyncio.get_running_loop()
        try:
            reply = await loop.run_in_executor(self._task_pool,
                                               self._execute, spec)
        except RuntimeError:
            # Pool shut down by the retirement drain while this push was
            # in flight: the spec never ran — requeue, don't charge
            # retries (without this, a max_retries=0 task arriving in
            # the drain window would fail permanently unexecuted).
            return {"requeue": True, "results": [], "error": None}
        self._maybe_retire()
        return reply

    async def push_tasks_stream(self, specs: List[dict]):
        """Batched task push from a lease-reuse lane, with STREAMED
        `(index, reply)` items. The batch executes SEQUENTIALLY in one
        pool slot — the whole batch rides a single lease, so running
        specs in parallel would oversubscribe the resources that lease
        reserved (parallelism comes from the lane holding multiple
        leases, each its own batch) — but each task's reply leaves the
        worker as soon as IT finishes, so a fast task's caller — a
        get()/wait() at the owner — is never gated on a slow
        batchmate. With owner-served small results the reply IS result
        visibility, which is why per-task delivery matters (ref: the
        reference pushes tasks individually and gets this for free)."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def run_all():
            # The end sentinel is UNCONDITIONAL: an exception escaping
            # _execute (stray injected interrupt between tasks, store
            # failure in a pre-try region) must not strand the stream —
            # the lane would wait forever on a batch that never ends.
            try:
                for i, s in enumerate(specs):
                    reply = self._execute(s)
                    loop.call_soon_threadsafe(q.put_nowait, (i, reply))
            except BaseException as e:  # noqa: BLE001
                logger.exception("batch executor died mid-stream")
                raise e
            finally:
                try:
                    loop.call_soon_threadsafe(q.put_nowait, None)
                except RuntimeError:
                    pass   # loop closing; the connection dies with it

        try:
            pool_fut = loop.run_in_executor(self._task_pool, run_all)
        except RuntimeError:
            # Retirement drain closed the pool mid-push: see push_task.
            yield [(i, {"requeue": True, "results": [], "error": None})
                   for i in range(len(specs))]
            return
        try:
            done = False
            while not done:
                item = await q.get()
                if item is None:
                    break
                # Coalesce everything already completed into ONE frame:
                # micro-tasks that outpace the socket amortize framing
                # like the old batched reply did, while a slow task's
                # reply still leaves the moment it finishes.
                chunk = [item]
                while True:
                    try:
                        nxt = q.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if nxt is None:
                        done = True
                        break
                    chunk.append(nxt)
                yield chunk
            await pool_fut
        finally:
            # A client disconnect/cancel closes this generator at a
            # yield: still consume the executor future's exception (no
            # 'never retrieved' noise) and run the retirement check the
            # tail would otherwise have done.
            def _consume(f):
                try:
                    f.exception()
                except Exception:  # noqa: BLE001
                    pass

            pool_fut.add_done_callback(_consume)
            self._maybe_retire()

    # ---- pre-leased task lanes (compiled execution plane) -------------
    async def lane_open(self, lane_id: str, fn_key: bytes,
                        name: str = "task",
                        job_id: Optional[str] = None,
                        submit_ctx=None) -> dict:
        """Open a lane on this (pinned) worker: prefetch the function and
        record the spec template, so each subsequent `lane_execute` delta
        frame carries only (task id, arg blob, counters) — no TaskSpec
        pickle, no function-table lookup on the hot path."""
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(self._task_pool,
                                       self.core.fetch_function, fn_key)
        except RuntimeError:
            return {"requeue": True, "ok": False}   # retiring; re-lease
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "error": str(e)}
        self._lanes[lane_id] = {"fn_key": fn_key, "name": name,
                                "job_id": job_id,
                                "submit_ctx": submit_ctx}
        return {"ok": True}

    async def lane_execute(self, lane_id: str, task_id: bytes,
                           args_blob, num_returns: int = 1,
                           attempt: int = 0,
                           lane_retries: int = 0,
                           submit_ts: Optional[float] = None,
                           lease_ts: Optional[float] = None) -> dict:
        """One lane call: expand the delta frame against the lane's spec
        template and run it through the ordinary tracked executor (same
        memoization, cancellation, retirement and result-storing
        semantics as push_task)."""
        lane = self._lanes.get(lane_id)
        if lane is None:
            # Lane evaporated (worker restarted under the same address,
            # or close raced a call): hand the call back untouched.
            return {"requeue": True, "results": [], "error": None}
        spec = {
            "task_id": task_id,
            "fn_key": lane["fn_key"],
            "args_blob": args_blob,
            "num_returns": num_returns,
            "options": {"name": lane["name"]},
            "attempt": attempt,
            "_lane_retries": lane_retries,
            "job_id": lane["job_id"],
            # Submission history rides the delta frame (two floats), so
            # laned attempts report the same SUBMITTED→LEASED→RUNNING→
            # terminal transitions as fully-specced ones.
            "submit_ts": submit_ts,
            "lease_ts": lease_ts,
            "submit_ctx": lane["submit_ctx"],
        }
        loop = asyncio.get_running_loop()
        try:
            reply = await loop.run_in_executor(self._task_pool,
                                               self._execute, spec)
        except RuntimeError:
            # Retirement drain closed the pool mid-call: never executed.
            return {"requeue": True, "results": [], "error": None}
        self._maybe_retire()
        return reply

    async def lane_apply(self, blob, name: str = "dag_stage") -> dict:
        """Run a long-lived body (a compiled-DAG FunctionNode stage loop)
        in this pinned worker: `blob` is a cloudpickled zero-arg
        callable; the call returns when the loop exits (channel close at
        teardown). The RPC reply doubles as the loop ref."""
        loop = asyncio.get_running_loop()
        if self._lane_pool is None:
            self._lane_pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="lane")

        def run():
            fn = serialization.cloudpickle.loads(blob)
            return fn()

        try:
            await loop.run_in_executor(self._lane_pool, run)
            return {"error": None}
        except BaseException as e:  # noqa: BLE001
            if isinstance(e, rexc.RayTpuError):
                err = e
            else:
                err = rexc.TaskError.from_exception(
                    e, name, pid=os.getpid(), node_id=self.core.node_id)
            return {"error": err}

    async def lane_close(self, lane_id: str) -> dict:
        self._lanes.pop(lane_id, None)
        return {"ok": True}

    async def create_actor(self, actor_id: str, cls_blob_key: bytes,
                           args_blob: bytes,
                           max_concurrency: int = 1,
                           concurrency_groups: Optional[
                               Dict[str, int]] = None) -> dict:
        loop = asyncio.get_running_loop()

        def construct():
            cls = self.core.fetch_function(cls_blob_key)
            args, kwargs = protocol.unpack_args(args_blob, self._fetch_arg)
            return cls(*args, **kwargs)

        try:
            instance = await loop.run_in_executor(self._task_pool, construct)
        except BaseException as e:  # noqa: BLE001
            logger.exception("actor construction failed")
            return {"ok": False, "error": repr(e)}
        # Generic escape hatch used by compiled DAGs (the reference's
        # `__ray_call__`, actor.py): run an arbitrary function with the
        # actor instance as first argument, on the actor's own thread, so
        # a stage loop sees the CUDA device and grad mode a call sees.
        def __raytpu_apply__(fn, *a, **kw):
            return fn(instance, *a, **kw)

        try:
            instance.__raytpu_apply__ = __raytpu_apply__
        except AttributeError:
            pass  # __slots__ class: compiled DAG loops unsupported on it
        try:
            self.actor = ActorRuntime(instance, max_concurrency,
                                      concurrency_groups)
        except Exception as e:  # noqa: BLE001 bad group declaration:
            # surface as a creation failure, not a hung actor.
            logger.exception("actor runtime setup failed")
            return {"ok": False, "error": repr(e)}
        self.actor_id = actor_id
        return {"ok": True}

    async def push_actor_task(self, spec: dict) -> dict:
        if self.actor is None:
            return {"results": [],
                    "error": rexc.ActorDiedError(spec.get("actor_id") or "",
                                                 "no actor on this worker")}
        return await self.actor.submit(spec, self._execute_actor)

    async def push_actor_tasks(self, specs: List[dict]) -> List[dict]:
        """Batched push (one RPC per caller-side burst): admission stays
        per-spec (seq ordering), execution of a contiguous ordered run is
        drained in a single pool job."""
        if self.actor is None:
            err = rexc.ActorDiedError(
                (specs[0].get("actor_id") if specs else "") or "",
                "no actor on this worker")
            return [{"results": [], "error": err} for _ in specs]
        # Plain sequential awaits, not gather(): admit() returns real
        # futures, the batch completes roughly in order, and gather's
        # per-child callback wiring is measurable at 10k+ calls/s.
        replies = list(await asyncio.gather(*[
            self.actor.admit(s, self._execute_actor) for s in specs]))
        # Wire-compress the dominant reply shape — a single inline None
        # return (side-effect actor methods) — to the integer 0. The
        # IDENTITY check against the cached none payload is exact: only
        # _store_results' None fast path produces that object, always as
        # the sole return of a num_returns=1 call, so the caller can
        # reconstruct the full TaskResult from its own return_ids (see
        # core_worker._finish_actor_batch).
        np = _none_payload()
        for i, r in enumerate(replies):
            if r.get("error") is None:
                res = r["results"]
                if len(res) == 1 and res[0].inline is np:
                    replies[i] = 0
        return replies

    async def push_actor_tasks_delta(self, template: dict,
                                     deltas: List[tuple]) -> List[dict]:
        """Delta-frame push: a same-destination burst arrives as ONE
        template spec plus per-call (task_id, seq, submit_ts) tuples
        (see core_worker._delta_frame). Reconstitute full specs and run
        the ordinary batched admission path."""
        specs = []
        for task_id, seq, submit_ts in deltas:
            s = dict(template)
            s["task_id"] = task_id
            s["seq"] = seq
            s["submit_ts"] = submit_ts
            specs.append(s)
        return await self.push_actor_tasks(specs)

    def _execute_actor(self, spec: dict, resolve_only: bool = False,
                       coro_args=None):
        """Tracked actor execution (see _execute): arg-resolution passes
        are not tracked — only phases that can actually hang user-visibly
        on this method's body."""
        if resolve_only:
            return self._execute_actor_impl(spec, resolve_only, coro_args)
        key = spec["task_id"]
        name = (f"{type(self.actor.instance).__name__}."
                f"{spec['method_name']}" if self.actor is not None
                else spec["method_name"])
        entry = self._running_entry(spec, name)
        if coro_args is not None:
            inner = self._execute_actor_impl(spec, resolve_only, coro_args,
                                             name=name)

            async def tracked():
                self._running_info[key] = entry
                try:
                    return await inner
                finally:
                    self._running_info.pop(key, None)

            return tracked()
        self._running_info[key] = entry
        try:
            return self._execute_actor_impl(spec, resolve_only, coro_args,
                                            name=name)
        finally:
            self._running_info.pop(key, None)

    def _execute_actor_impl(self, spec: dict, resolve_only: bool = False,
                            coro_args=None, name: Optional[str] = None):
        if name is None:
            name = (f"{type(self.actor.instance).__name__}."
                    f"{spec['method_name']}")
        import time as _time

        if coro_args is not None:
            # Async path phase 2: returns an awaitable producing the reply.
            async def run():
                start_ts = _time.time()
                if spec["task_id"] in self._cancelled_here:
                    # Cancelled while buffered: reply (keeping seq
                    # contiguity) without invoking the method.
                    self._cancelled_here.pop(spec["task_id"], None)
                    err = rexc.TaskCancelledError(name)
                    self._record_event(spec, "FAILED", start_ts,
                                       _time.time(), error=repr(err))
                    return {"results": [], "error": err}
                try:
                    method = getattr(self.actor.instance,
                                     spec["method_name"])
                    if spec["options"].get("streaming"):
                        if not inspect.isasyncgenfunction(method):
                            # Reject BEFORE invoking: calling a plain
                            # coroutine method would create a never-
                            # awaited coroutine and silently skip its
                            # side effects. (Sync generator methods on
                            # async actors never reach this path —
                            # _dispatch routes them to the sync pool.)
                            err = rexc.ActorError(
                                name, "num_returns='streaming' async "
                                      "actor method must be an async "
                                      "generator (async def + yield)")
                            self._record_event(
                                spec, "FAILED", start_ts, _time.time(),
                                error=repr(err))
                            return {"results": [], "error": err}
                        raw = method(*coro_args[0], **coro_args[1])
                        return await self._execute_stream_async(
                            spec, raw, start_ts, name)
                    if inspect.isasyncgenfunction(method):
                        # awaiting an async generator is a TypeError —
                        # diagnose the missing option instead.
                        err = rexc.ActorError(
                            name, "async-generator method requires "
                                  "num_returns='streaming'")
                        self._record_event(
                            spec, "FAILED", start_ts, _time.time(),
                            error=repr(err))
                        return {"results": [], "error": err}
                    result = await method(*coro_args[0], **coro_args[1])
                    reply = {"results": self._store_results(spec, result),
                             "error": None}
                    self._record_event(spec, "FINISHED", start_ts,
                                       _time.time())
                    return reply
                except BaseException as e:  # noqa: BLE001
                    err = rexc.ActorError.from_exception(
                        e, name, pid=os.getpid(), node_id=self.core.node_id)
                    self._store_results(spec, err, is_error=True)
                    self._record_event(spec, "FAILED", start_ts,
                                       _time.time(), error=repr(e))
                    return {"results": [], "error": err}

            return run()
        try:
            args, kwargs = protocol.unpack_args(spec["args_blob"],
                                                self._fetch_arg)
        except BaseException as e:  # noqa: BLE001
            err = rexc.TaskError.from_exception(e, name)
            return {"results": [], "error": err}
        if resolve_only:
            return args, kwargs
        start_ts = _time.time()
        if spec["task_id"] in self._cancelled_here:
            # Cancelled while queued in the actor's ordered buffer: the
            # reply keeps seq contiguity, the method never runs.
            self._cancelled_here.pop(spec["task_id"], None)
            err = rexc.TaskCancelledError(name)
            self._record_event(spec, "FAILED", start_ts, _time.time(),
                               error=repr(err))
            return {"results": [], "error": err}
        probe = TaskUsageProbe() if self._attrib else None
        try:
            method = getattr(self.actor.instance, spec["method_name"])
            trace_ctx = spec.get("trace_ctx")
            if trace_ctx is None:
                # Hot path: no submitted trace context means no span can
                # open (extract_and_span yields None) — skip the span-arg
                # construction and generator/contextmanager machinery.
                span_cm = _NULL_SPAN
            else:
                from ray_tpu_torch.util import tracing

                span_cm = tracing.extract_and_span(
                    trace_ctx, f"actor:{name}",
                    task_id=spec["task_id"].hex())
            with span_cm:
                with self._exec_lock:
                    self._executing[spec["task_id"]] = \
                        threading.get_ident()
                try:
                    result = method(*args, **kwargs)
                    if inspect.iscoroutine(result):
                        result = asyncio.run(result)
                finally:
                    with self._exec_lock:
                        self._executing.pop(spec["task_id"], None)
                if spec["options"].get("streaming"):
                    return self._stream_reply(spec, result, start_ts,
                                              error_cls=rexc.ActorError,
                                              probe=probe)
            reply = {"results": self._store_results(spec, result),
                     "error": None}
            self._record_event(spec, "FINISHED", start_ts, _time.time(),
                               usage=probe.finish() if probe else None)
            return reply
        except BaseException as e:  # noqa: BLE001
            with self._exec_lock:
                self._executing.pop(spec["task_id"], None)
            if isinstance(e, KeyboardInterrupt):
                if spec["task_id"] in self._cancelled_here:
                    self._cancelled_here.pop(spec["task_id"], None)
                    err = rexc.TaskCancelledError(name)
                else:
                    err = rexc.WorkerCrashedError(
                        f"actor method {name} interrupted by a stray "
                        f"cancel")
            elif isinstance(e, rexc.RayTpuError):
                # Typed passthrough, same as the task and streaming
                # paths: callers dispatch on framework exception types
                # (e.g. the handle retries ReplicaDrainingError from
                # stream_next during a live-migration drain).
                err = e
            else:
                err = rexc.ActorError.from_exception(
                    e, name, pid=os.getpid(), node_id=self.core.node_id)
            try:
                self._store_results(spec, err, is_error=True)
            except Exception:  # noqa: BLE001
                pass
            self._record_event(spec, "FAILED", start_ts, _time.time(),
                               error=repr(e),
                               usage=probe.finish() if probe else None)
            return {"results": [], "error": err}

    async def execute_simple(self, spec: dict) -> dict:
        """Cross-language task entry (ref: the C++ worker API's task
        path, cpp/src/ray/runtime/task/): same execution as push_task
        but the reply is a PLAIN dict of primitives — no dataclasses —
        so non-Python clients with a minimal pickle codec can parse it.
        The result payload is the framed serialization bytes."""
        loop = asyncio.get_running_loop()
        reply = await loop.run_in_executor(self._task_pool, self._execute,
                                           spec)
        err = reply.get("error")
        if err is not None:
            return {"ok": False, "error_repr": repr(err)}
        r = reply["results"][0]
        inline = r.inline
        if inline is None:
            buf = self.core.store.get_buffer(ObjectID(r.oid))
            if buf is None:
                return {"ok": False,
                        "error_repr": "result evicted before reply"}
            try:
                inline = bytes(buf.view)
            finally:
                buf.release()
        return {"ok": True, "payload": inline, "oid": r.oid}

    async def profile_memory(self, duration_s: float = 2.0,
                             top_n: int = 20) -> dict:
        """On-demand heap profiling (ref: dashboard memray profiling,
        reporter/profile_manager.py:186 MemoryProfilingManager — memray
        isn't in this image, so tracemalloc supplies allocation sites):
        traces allocations for `duration_s`, returns top allocation
        sites + total traced bytes."""
        import tracemalloc

        from ray_tpu_torch.util.profiling import HEAP_TRACE_LOCK

        loop = asyncio.get_running_loop()

        def run():
            # Serialized: overlapping windows would stop each other's
            # tracing mid-snapshot (tracemalloc state is process-global).
            with HEAP_TRACE_LOCK:
                return _traced_window()

        def _traced_window():
            started_here = not tracemalloc.is_tracing()
            try:
                if started_here:
                    tracemalloc.start(10)
                before = tracemalloc.take_snapshot()
                import time as _t

                _t.sleep(duration_s)
                after = tracemalloc.take_snapshot()
                stats = after.compare_to(before, "traceback")
                top = []
                for st in stats[:top_n]:
                    frames = [f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                              for f in list(st.traceback)[-6:]]
                    top.append({"size_diff": st.size_diff,
                                "count_diff": st.count_diff,
                                "stack": ";".join(frames)})
                current, peak = tracemalloc.get_traced_memory()
                return {"top": top, "current_bytes": current,
                        "peak_bytes": peak, "duration_s": duration_s}
            finally:
                if started_here and tracemalloc.is_tracing():
                    tracemalloc.stop()

        return await loop.run_in_executor(None, run)

    async def profile(self, duration_s: float = 2.0,
                      interval_s: float = 0.01) -> dict:
        """On-demand stack sampling of this worker (ref: dashboard
        py-spy profiling, reporter/profile_manager.py:75). Runs on a
        sampler thread, so in-flight task execution keeps going and IS
        what gets sampled."""
        from ray_tpu_torch.util.profiling import profile_here

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: profile_here(duration_s, interval_s))

    def running_tasks(self) -> dict:
        """Snapshot of attempts currently occupying executor threads —
        the daemon's hung-task watchdog polls this (and falls back to
        the signal-safe dump path when even this RPC can't be served
        because a task is wedged holding the GIL)."""
        import time as _time

        tasks = [dict(v) for v in list(self._running_info.values())]
        with _progress_lock:
            probes = list(_progress_probes.values())
        for probe in probes:
            try:
                entry = probe()
            except Exception:  # noqa: BLE001
                continue
            if entry:
                tasks.append(dict(entry))
        return {"now": _time.time(), "pid": os.getpid(), "tasks": tasks}

    def ping(self) -> dict:
        return {"ok": True, "pid": os.getpid(),
                "actor_id": self.actor_id}


class _NullSpanCM:
    """Reusable no-op context manager: the tracing-off hot path enters
    it per call, so it must not allocate."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpanCM()

_NONE_PAYLOAD: Optional[bytes] = None


def _none_payload() -> bytes:
    global _NONE_PAYLOAD
    if _NONE_PAYLOAD is None:
        _NONE_PAYLOAD = serialization.dumps(None)
    return _NONE_PAYLOAD


def _mkref(oid: ObjectID, owner: Optional[str] = None):
    from ray_tpu_torch.core.object_ref import ObjectRef

    return ObjectRef(oid, owner, _skip_refcount=True)


def run_worker(args) -> None:
    # Signal-safe stack dumps FIRST — before the daemon can learn this
    # pid: faulthandler on SIGUSR1 writes all-thread tracebacks to a
    # per-pid file in the node's log dir, readable by the daemon even
    # when a task wedges the GIL in native code (the default SIGUSR1
    # disposition would TERMINATE the process, so registration must
    # precede any chance of being signalled).
    if get_config().stack_dump_enabled:
        try:
            from ray_tpu_torch.util.profiling import (
                node_log_dir, register_stack_dump_handler,
                stack_dump_path)

            register_stack_dump_handler(stack_dump_path(
                node_log_dir(args.node_id), os.getpid()))
        except Exception as e:  # noqa: BLE001 diagnosis is best-effort
            logger.warning("stack-dump handler unavailable: %s", e)
    # One event loop for ALL grpc.aio objects in this process (server and
    # clients) — grpc-python's aio poller misbehaves across multiple loops.
    from ray_tpu_torch.core.distributed.rpc import EventLoopThread

    loop_thread = EventLoopThread(name="worker-rpc")
    server = RpcServer("127.0.0.1", 0)
    loop_thread.run(server.start())
    address = server.address

    core = DistributedCoreWorker(
        gcs_address=args.gcs_address,
        node_id=args.node_id,
        daemon_address=args.daemon_address,
        store_dir=args.store_dir,
        job_id="worker",
        is_driver=False,
        worker_address=address,
        loop_thread=loop_thread,
    )
    # User code inside tasks talks to the same core worker.
    from ray_tpu_torch import api

    api._set_global_worker(core)

    service = WorkerService(core, args.worker_id)
    server.add_service("Worker", service)
    from ray_tpu_torch.core.distributed.core_worker import OwnerService

    server.add_service("Owner", OwnerService(core))

    async def register():
        daemon = AsyncRpcClient(args.daemon_address)
        await daemon.call("NodeDaemon", "register_worker",
                          worker_id=args.worker_id, address=address,
                          pid=os.getpid(), timeout=30)
        await daemon.close()

    loop_thread.run(register())
    logger.info("worker %s serving on %s", args.worker_id[:8], address)

    # Fate-share with the daemon: if it stops answering pings, exit
    # (ref: workers fate-share with their raylet). This is a BACKSTOP —
    # the kernel PDEATHSIG chain (daemon → zygote → worker) already
    # covers daemon death on Linux — so the cadence is lazy and the
    # client connection persists: a warm pool of ~1k parked workers
    # must not spend the host's CPU on connect/teardown churn.
    failures = 0
    ping_client = AsyncRpcClient(args.daemon_address)
    # lint: allow-knob -- per-worker bootstrap var set by the spawning daemon, read pre-config
    period = float(os.environ.get("RAY_TPU_WORKER_PING_PERIOD_S", "45"))
    while True:
        threading.Event().wait(period)
        try:
            async def ping():
                await ping_client.call("NodeDaemon", "ping", timeout=5)

            loop_thread.run(ping(), timeout=10)
            failures = 0
        except Exception:  # noqa: BLE001
            failures += 1
            if failures >= 3:
                logger.warning("daemon unreachable; exiting (fate-share)")
                os._exit(1)


# How this worker process started: "zygote" (forked from the warm template,
# set by worker_zygote._child_main) or "cold" (its own interpreter: the
# daemon's fallback when a fork request fails).
STARTED_BY = "cold"
# Whether torch was loaded when this worker booted (the zygote preloads it).
TORCH_AT_BOOT = False


def boot_worker(args) -> None:
    """Process body shared by the cold-spawn CLI path (`main`) and the
    zygote fork path (worker_zygote._child_main): everything after the
    per-worker identity (worker_id, env, stdio) is known. `force=True`
    because a forked child inherits the zygote's logging handlers."""
    global TORCH_AT_BOOT
    TORCH_AT_BOOT = "torch" in sys.modules
    logging.basicConfig(
        level=logging.INFO, force=True,
        format=f"[worker {args.worker_id[:6]}] %(levelname)s %(message)s")
    # tpu_profiling runtime env (the nsight analogue): trace the whole
    # worker process with torch.profiler, like `nsys profile` wraps the
    # reference's worker (_private/runtime_env/nsight.py). The variable
    # keeps the JAX package's name; the trace is a Chrome trace per pid.
    # lint: allow-knob -- per-worker channel set by the runtime-env plugin, not a cluster knob
    trace_dir = os.environ.get("RAY_TPU_JAX_TRACE_DIR")
    if trace_dir:
        try:
            import atexit
            import signal

            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            # Tasks and actor calls run on the worker's executor threads,
            # not this one: without profile_all_threads their ops are lost.
            try:
                from torch._C._profiler import _ExperimentalConfig

                experimental = {"experimental_config": _ExperimentalConfig(
                    profile_all_threads=True)}
            except (ImportError, TypeError):  # an older torch: this thread
                experimental = {}
            prof = torch.profiler.profile(activities=activities, **experimental)
            prof.start()
            stopped = []

            def stop_trace_once(*_sig):
                if not stopped:
                    stopped.append(True)
                    try:
                        prof.stop()
                        os.makedirs(trace_dir, exist_ok=True)
                        prof.export_chrome_trace(os.path.join(
                            trace_dir, f"worker_{os.getpid()}.json"))
                    except Exception:  # noqa: BLE001 already stopped
                        pass
                if _sig:  # invoked as a signal handler, not atexit
                    os._exit(0)

            atexit.register(stop_trace_once)
            # The daemon's graceful kill is SIGTERM, which does NOT run
            # atexit — without this the trace never finalizes for
            # daemon-terminated workers (SIGKILL remains unhelpable).
            signal.signal(signal.SIGTERM, stop_trace_once)
        except Exception as e:  # noqa: BLE001 profiling is best-effort
            logging.warning("torch trace capture unavailable: %s", e)
    try:
        run_worker(args)
    except KeyboardInterrupt:
        pass


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--daemon-address", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--store-dir", required=True)
    parser.add_argument("--worker-id", required=True)
    boot_worker(parser.parse_args())


if __name__ == "__main__":
    main()
