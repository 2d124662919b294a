"""DistributedCoreWorker: the per-process runtime core.

The port's copy of `ray_tpu/core/distributed/core_worker.py`,
importing `ray_tpu_torch` only.

Analogue of the reference core worker (ref: src/ray/core_worker/
core_worker.h:291 — task submission, ownership/refcount, memory store,
actor transport; direct task push after lease,
transport/direct_task_transport.h:75). Embedded in the driver and in every
worker process.

Data path: every put/task-return lands in the executing node's shm store and
its location is registered in the GCS object directory; small payloads also
ride inline in task replies as a read shortcut. get() resolves
local-store → inline-cache → remote pull (chunked stream from the holding
node's daemon, ref: object_manager.h:117 pull/push in 5 MiB chunks).
"""
from __future__ import annotations

import asyncio
import atexit
import logging
import os
import threading
import time
import uuid
from collections import defaultdict, deque
from concurrent.futures import CancelledError, Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch import exceptions as rexc
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef, install_refcounter, uninstall_refcounter
from ray_tpu_torch.core.object_store import ObjectStore
from ray_tpu_torch.core.task_spec import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SpreadSchedulingStrategy,
    TaskOptions,
)
from ray_tpu_torch.core.distributed import protocol
from ray_tpu_torch.core.distributed.rpc import (
    AsyncRpcClient,
    EventLoopThread,
    RpcError,
    RpcServer,
    SyncRpcClient,
)
from ray_tpu_torch.core.distributed.wire import Raw

logger = logging.getLogger(__name__)

ACTOR_STATES_TRANSIENT = ("PENDING_CREATION", "RESTARTING")


# Byte-exact serialized None (the serializer is deterministic for None):
# lets the hot get() path recognize a None reply without deserializing.
_NONE_PAYLOAD = serialization.dumps(None)

# One shared condition for every _LightFuture: a per-future
# threading.Condition (an RLock + waiter deque) was a measurable slice of
# actor-call submission at >10k calls/s on a single-core host. Waiters are
# rare relative to futures (get() blocks on at most a handful at a time),
# so notify_all on the shared condition wakes few threads.
_lf_cond = threading.Condition(threading.Lock())

_LF_PENDING = 0
_LF_DONE = 1
_LF_CANCELLED = 2
_LF_ERROR = 3


class _LightFuture:
    """Minimal concurrent.futures.Future replacement for the task/actor
    submission waiter: supports exactly the subset the submit/get paths
    use (done/cancel/set_result/set_exception/result/add_done_callback),
    value is always None — results travel via the inline cache / store,
    the future only signals completion."""

    __slots__ = ("_state", "_exc", "_cbs", "stream_state", "__weakref__")

    def __init__(self):
        self._state = _LF_PENDING
        self._exc = None
        self._cbs = None

    def done(self) -> bool:
        return self._state != _LF_PENDING

    def cancelled(self) -> bool:
        return self._state == _LF_CANCELLED

    def _finish(self, state: int, exc=None) -> bool:
        with _lf_cond:
            if self._state != _LF_PENDING:
                return False
            self._exc = exc
            self._state = state
            _lf_cond.notify_all()
            cbs, self._cbs = self._cbs, None
        if cbs:
            for cb in cbs:
                try:
                    cb(self)
                except Exception:  # noqa: BLE001
                    logger.exception("future callback failed")
        return True

    def set_result(self, _value=None) -> None:
        self._finish(_LF_DONE)

    def set_exception(self, exc) -> None:
        self._finish(_LF_ERROR, exc)

    def cancel(self) -> bool:
        return self._finish(_LF_CANCELLED)

    def exception(self, timeout=None):
        self.result(timeout)
        return self._exc

    def add_done_callback(self, cb) -> None:
        with _lf_cond:
            if self._state == _LF_PENDING:
                if self._cbs is None:
                    self._cbs = [cb]
                else:
                    self._cbs.append(cb)
                return
        try:
            cb(self)
        except Exception:  # noqa: BLE001
            logger.exception("future callback failed")

    def result(self, timeout=None):
        if self._state == _LF_PENDING:
            with _lf_cond:
                if timeout is None:
                    while self._state == _LF_PENDING:
                        _lf_cond.wait()
                else:
                    deadline = time.monotonic() + timeout
                    while self._state == _LF_PENDING:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise FutureTimeoutError()
                        _lf_cond.wait(remaining)
        if self._state == _LF_CANCELLED:
            raise CancelledError()
        if self._state == _LF_ERROR:
            raise self._exc
        return None


class _TaskLane:
    """Tasks with identical (demand, scheduling) share leased workers.

    The reference's direct task submitter holds a granted lease and runs
    further queued tasks of the same shape on it instead of going back to
    the raylet per task (ref: direct_task_transport.h:75 — worker lease
    reuse). Here a lane additionally BATCHES queued specs into one
    push_tasks RPC per worker round, amortizing python-grpc's ~0.5 ms
    per-unary cost. Leases are held `IDLE_HOLD_S` after the queue drains,
    then returned.
    """

    # Idle leases block OTHER lanes' parked waiters (the daemon can't
    # reclaim a held lease), so the hold must only bridge a tight
    # submit-get loop's gap (~1ms lease RT), not a human pause: 200ms
    # serialized 4 contending submitters into 300ms turns each.
    IDLE_HOLD_S = 0.02
    MAX_LEASES = 32
    # Batch size balances RPC amortization (16x fewer unaries) against
    # failure blast radius (a dying worker fails one whole batch) AND
    # placement spread: one pursuer grabbing a 64-deep queue of 200ms
    # tasks serializes 13s of work on one worker while other nodes sit
    # idle. The cap adapts to the lane's observed per-task duration
    # (_batch_cap): micro-tasks batch at 64 (every RPC is pure overhead
    # on a single-core host), long tasks go 1-2 per batch so surplus
    # queue depth spawns more pursuers → more leases → spillback
    # spreads them across nodes (the reference schedules per-task and
    # gets spread for free; lease-reuse batching must buy it back).
    BATCH = 64
    # Before any duration sample exists: small, so a burst of unknown
    # (possibly long) tasks doesn't serialize 8-deep on one worker
    # while other nodes idle; one observed batch later the cap adapts.
    FIRST_BATCH = 2
    # Lease time-slice: return the lease after this many batches even if
    # work remains (re-request immediately). The daemon can't reclaim a
    # held lease, so a lane that drains its whole queue on one lease
    # starves every other submitter's parked waiters; FIFO re-grants at
    # slice boundaries round-robin contending lanes at ~1ms re-lease
    # cost per slice (<1% of a slice's work).
    BATCHES_PER_LEASE = 4
    # Connection-level batch failures re-queue the affected specs (cheap,
    # spread over fresh batches) up to this many times per spec before
    # surfacing the failure.
    MAX_BATCH_RETRIES = 20

    def __init__(self, core: "DistributedCoreWorker", demand, sched):
        self.core = core
        self.demand = demand
        self.sched = sched
        self.queue: deque = deque()
        self.wakeup = asyncio.Event()
        # Number of _pursue coroutines alive; each holds at most one lease.
        self.pursuers = 0
        # EMA of seconds per task on this lane (None until first batch).
        self._ema_task_s: Optional[float] = None

    def _observe_batch(self, n: int, dt: float) -> None:
        per = dt / max(1, n)
        ema = self._ema_task_s
        self._ema_task_s = per if ema is None else 0.7 * ema + 0.3 * per

    def _batch_cap(self) -> int:
        ema = self._ema_task_s
        if ema is None:
            return self.FIRST_BATCH
        if ema < 0.005:
            return self.BATCH
        if ema < 0.05:
            return 8
        if ema < 0.5:
            return 2
        return 1

    async def submit(self, spec: dict) -> dict:
        fut = asyncio.get_running_loop().create_future()
        self.queue.append((spec, fut))
        self.wakeup.set()
        self._maybe_scale()
        return await fut

    def _maybe_scale(self) -> None:
        while self.pursuers < min(len(self.queue), self.MAX_LEASES):
            self.pursuers += 1
            asyncio.ensure_future(self._pursue())

    def _fail_queued(self, e: BaseException) -> None:
        err = e if isinstance(e, Exception) else RuntimeError(repr(e))
        while self.queue:
            spec, fut = self.queue.popleft()
            self.core._record_driver_failure(spec, err)
            if not fut.done():
                fut.set_exception(err)

    async def _pursue(self) -> None:
        """Acquire a lease, run queued tasks on it, repeat while work
        remains. Transient lease failures (RPC deadline while the daemon
        queues us behind busy resources, daemon restarts) back off and
        retry; only a definitive scheduler refusal fails the queue."""
        failures = 0
        cancelled = False
        try:
            while self.queue:
                try:
                    daemon, grant = await self._lease_with_spillback()
                except rexc.RayTpuError as e:
                    self._fail_queued(e)
                    return
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 transient
                    failures += 1
                    if failures > 50:
                        self._fail_queued(e)
                        return
                    await asyncio.sleep(min(0.2 * failures, 2.0))
                    continue
                failures = 0
                try:
                    await self._run_worker(daemon, grant)
                finally:
                    try:
                        await daemon.call(
                            "NodeDaemon", "return_lease",
                            lease_id=grant["lease_id"], timeout=10)
                    except asyncio.CancelledError:
                        cancelled = True
                        raise
                    except Exception:  # noqa: BLE001
                        pass
        except asyncio.CancelledError:
            # Event-loop shutdown: cancel waiters instead of spinning the
            # retry loop on a dead control plane, and do NOT respawn a
            # replacement pursuer (it would outlive the cancel sweep and
            # die as a destroyed-pending task at interpreter exit).
            cancelled = True
            for _, fut in self.queue:
                if not fut.done():
                    fut.cancel()
            self.queue.clear()
            raise
        finally:
            self.pursuers -= 1
            if not cancelled:
                self._maybe_scale()

    async def _lease_with_spillback(self):
        cfg = get_config()
        sched = self.sched
        daemon_addr = self.core.daemon_address
        parked = False
        for _ in range(16):  # bounded spillback hops
            daemon = await self.core._aclient(daemon_addr)
            grant = await daemon.call(
                "NodeDaemon", "request_lease", demand=self.demand,
                strategy=sched["strategy"], affinity=sched["affinity"],
                soft=sched["soft"], placement=sched["placement"],
                runtime_env=sched.get("runtime_env"),
                job_id=self.core.job_id, parked=parked,
                timeout=cfg.worker_lease_timeout_ms / 1000)
            if grant.get("spill_to"):
                daemon_addr = grant["spill_to"]
                # A "park" spill is terminal: the target queues us until
                # capacity frees instead of re-spilling on ITS stale
                # view (stops spread-spill ping-pong across busy nodes).
                parked = bool(grant.get("park"))
                continue
            if not grant.get("granted"):
                if grant.get("transient"):
                    # Worker-start hiccup: retryable, not a scheduler
                    # refusal — surface as a transient transport error.
                    raise RpcError(grant.get("error", "transient lease "
                                                      "failure"))
                raise rexc.RayTpuError(
                    grant.get("error", "lease not granted"))
            return daemon, grant
        raise rexc.RayTpuError("too many spillback hops")

    async def _run_worker(self, daemon, grant) -> None:
        worker = await self.core._aclient(grant["worker_address"])
        batches_run = 0
        while True:
            if batches_run >= self.BATCHES_PER_LEASE and self.queue:
                return  # time-slice over: re-lease so other lanes rotate
            batch = []
            cap = self._batch_cap()
            while self.queue and len(batch) < cap:
                spec, fut = self.queue.popleft()
                if spec["task_id"] in self.core._cancelled_tasks:
                    # Cancelled while queued: never push (ref:
                    # CancelTask on unleased tasks). Consuming the
                    # tombstone bounds the set to in-flight cancels.
                    self.core._cancelled_tasks.pop(spec["task_id"], None)
                    if not fut.done():
                        fut.set_result({
                            "results": [],
                            "error": rexc.TaskCancelledError(
                                spec["options"].get("name", "task"))})
                    continue
                batch.append((spec, fut))
            if not batch:
                # Hold the lease briefly: a follow-up burst reuses the
                # worker without another raylet round-trip.
                self.wakeup.clear()
                try:
                    await asyncio.wait_for(self.wakeup.wait(),
                                           self.IDLE_HOLD_S)
                    continue
                except (TimeoutError, asyncio.TimeoutError):
                    return
            for s, _ in batch:
                self.core._task_locations[s["task_id"]] = \
                    grant["worker_address"]
                # LEASED stamp: this attempt is bound to a granted
                # worker; the executor folds it into the attempt's
                # history record (see _stamp_submit).
                s["lease_ts"] = time.time()
            # Per-task STREAMED replies: the batch executes sequentially
            # on one lease, but each task's reply lands as soon as IT
            # finishes — a quick task's waiter is never gated on a slow
            # batchmate. (Pre-owner-serving this visibility came from
            # the executing worker's eager store write + directory
            # registration; with owner-served results the reply IS the
            # visibility.)
            push_t0 = time.monotonic()
            answered = [False] * len(batch)
            requeued = False
            try:
                async for chunk in worker.stream(
                        "Worker", "push_tasks_stream",
                        specs=[s for s, _ in batch]):
                    for i, reply in chunk:
                        spec, fut = batch[i]
                        answered[i] = True
                        self.core._task_locations.pop(spec["task_id"],
                                                      None)
                        if reply.get("requeue"):
                            # Worker retiring (max_calls): the spec
                            # never ran — requeue WITHOUT charging its
                            # retry budget, bounded like connection
                            # retries.
                            n = spec.get("_lane_retries", 0) + 1
                            spec["_lane_retries"] = n
                            if n > self.MAX_BATCH_RETRIES:
                                if not fut.done():
                                    fut.set_result({
                                        "results": [],
                                        "error": rexc.WorkerCrashedError(
                                            "worker kept retiring under "
                                            "max_calls pressure")})
                            else:
                                self.queue.append((spec, fut))
                                requeued = True
                            continue
                        if not fut.done():
                            fut.set_result(reply)
                # A stream that ENDED OK must have answered every spec;
                # requeue any gap defensively rather than stranding its
                # future forever.
                for (spec, fut), done in zip(batch, answered):
                    if done or fut.done():
                        continue
                    self.core._task_locations.pop(spec["task_id"], None)
                    n = spec.get("_lane_retries", 0) + 1
                    spec["_lane_retries"] = n
                    if n > self.MAX_BATCH_RETRIES:
                        fut.set_exception(rexc.WorkerCrashedError(
                            "batch stream ended without this task's "
                            "reply"))
                    else:
                        self.queue.append((spec, fut))
                        requeued = True
            except asyncio.CancelledError:
                # Event-loop shutdown, not a worker death: cancel the
                # unanswered remainder instead of re-queueing forever.
                for (spec, fut), done in zip(batch, answered):
                    if not done:
                        self.core._task_locations.pop(spec["task_id"],
                                                      None)
                        if not fut.done():
                            fut.cancel()
                raise
            except Exception as e:  # noqa: BLE001
                # Worker likely died mid-batch: re-queue the UNANSWERED
                # specs (fresh leases redistribute them) instead of
                # charging each a full retry attempt; answered ones
                # already completed. Locations pop per-spec BEFORE the
                # requeue (a blanket pop afterwards would clobber the
                # fresh location another pursuer may already have set
                # for a re-pushed spec, breaking cancel routing).
                err = e
                for (spec, fut), done in zip(batch, answered):
                    if done:
                        continue
                    self.core._task_locations.pop(spec["task_id"], None)
                    n = spec.get("_lane_retries", 0) + 1
                    spec["_lane_retries"] = n
                    if n > self.MAX_BATCH_RETRIES:
                        if not fut.done():
                            fut.set_exception(err)
                    else:
                        self.queue.append((spec, fut))
                self.wakeup.set()
                self._maybe_scale()
                return  # drop this lease; the worker may be gone
            self._observe_batch(len(batch), time.monotonic() - push_t0)
            if self.queue:
                # Slow tasks shrink the cap AFTER the first batch; give
                # the surplus queue fresh pursuers now (submit-time
                # scaling already happened at the old, larger cap).
                self._maybe_scale()
            batches_run += 1
            if requeued:
                self.wakeup.set()
                self._maybe_scale()
                # Span the retiring worker's exit window so the re-lease
                # grants a FRESH worker instead of looping on this one.
                await asyncio.sleep(0.3)
                return  # drop this lease


class _PinnedLane:
    """A warm, pinned lease for one repeated task signature.

    After `task_lane_min_calls` submissions of the same (function,
    resources, runtime-env) signature, the driver leases a worker once,
    PINS the lease (the daemon releases its resources back to the pool —
    actor semantics — but keeps the worker bound and un-reapable) and
    opens a lane on the worker: the fn_key/name/job_id template travels
    once, and every subsequent call is a compact delta frame (task id +
    raw arg blob + counters, wire codec 2) straight into the pinned
    worker's executor queue. No per-call TaskSpec pickle, no
    GCS/scheduler/daemon visit, no lease round-trip.

    Spillback is transparent: a full in-flight window, a lost lease, a
    retiring or dying worker all route the call back to the ordinary
    `_TaskLane` lease/scheduler path (the memoized-results check on the
    worker keeps a retried call from re-running a body whose results
    already landed). Idle lanes release their worker after
    `task_lane_idle_s` so the pool can reap it.
    """

    def __init__(self, core: "DistributedCoreWorker", key, demand, sched,
                 fn_key: bytes, name: str, exclusive: bool = False):
        self.core = core
        self.key = key
        self.demand = demand
        self.sched = sched
        self.fn_key = fn_key
        self.name = name
        self.exclusive = exclusive   # compiled-DAG stage lane: not shared
        self.lane_id = uuid.uuid4().hex
        self.state = "opening"        # opening -> ready -> closed
        self.inflight = 0
        self.last_used = time.monotonic()
        self.worker_address: Optional[str] = None
        self.node_id: Optional[str] = None
        self.daemon_address: Optional[str] = None
        self.lease_id: Optional[str] = None
        self._client: Optional[AsyncRpcClient] = None
        core._lane_stat("opened")
        self._open_task: Optional[asyncio.Future] = \
            asyncio.ensure_future(self._open())

    async def _open(self) -> None:
        """Lease + pin + lane_open. Runs once; callers await it."""
        helper = _TaskLane(self.core, self.demand, self.sched)
        try:
            daemon, grant = await helper._lease_with_spillback()
            self.lease_id = grant["lease_id"]
            self.daemon_address = grant.get("daemon_address")
            self.node_id = grant.get("node_id")
            self.worker_address = grant["worker_address"]
            pin = await daemon.call("NodeDaemon", "pin_lease",
                                    lease_id=self.lease_id, timeout=10)
            if not pin.get("ok"):
                raise RpcError(f"pin_lease: {pin.get('error')}")
            # Dedicated connection: the lane's frames never queue behind
            # the shared client's control traffic, and teardown closes it.
            self._client = AsyncRpcClient(self.worker_address)
            opened = await self._client.call(
                "Worker", "lane_open", lane_id=self.lane_id,
                fn_key=self.fn_key, name=self.name,
                job_id=self.core.job_id,
                submit_ctx=getattr(self.core, "_submit_identity", None),
                timeout=60)
            if not opened.get("ok"):
                raise RpcError(f"lane_open: {opened.get('error')}")
            self.state = "ready"
        except BaseException:
            self.close()
            raise

    def try_submit(self, spec: dict, rfut: asyncio.Future) -> bool:
        """Fast-path admission; False => caller spills to the slow path."""
        if self.state == "closed" \
                or self.inflight >= get_config().task_lane_max_inflight:
            return False
        self.inflight += 1
        self.last_used = time.monotonic()
        asyncio.ensure_future(self._call(spec, rfut))
        return True

    async def _call(self, spec: dict, rfut: asyncio.Future) -> None:
        try:
            reply = await self._execute(spec)
        except asyncio.CancelledError:
            if not rfut.done():
                rfut.cancel()
            raise
        except BaseException as e:  # noqa: BLE001 — spill via on_done
            if not rfut.done():
                rfut.set_exception(e)
        else:
            if not rfut.done():
                rfut.set_result(reply)
        finally:
            self.inflight -= 1
            self.last_used = time.monotonic()

    async def _execute(self, spec: dict) -> dict:
        if self._open_task is not None:
            await asyncio.shield(self._open_task)
            self._open_task = None
        if self.state != "ready":
            raise RpcError("lane closed")
        if spec["task_id"] in self.core._cancelled_tasks:
            self.core._cancelled_tasks.pop(spec["task_id"], None)
            return {"results": [], "error": rexc.TaskCancelledError(
                spec["options"].get("name", "task"))}
        self.core._task_locations[spec["task_id"]] = self.worker_address
        spec["lease_ts"] = time.time()
        try:
            reply = await self._client.call(
                "Worker", "lane_execute", lane_id=self.lane_id,
                task_id=spec["task_id"],
                num_returns=spec["num_returns"],
                attempt=spec.get("attempt", 0),
                lane_retries=spec.get("_lane_retries", 0),
                submit_ts=spec.get("submit_ts"),
                lease_ts=spec["lease_ts"],
                args_blob=Raw(spec["args_blob"]), timeout=None)
        except asyncio.CancelledError:
            self.core._task_locations.pop(spec["task_id"], None)
            raise
        except Exception as e:  # noqa: BLE001 — worker likely died
            self.core._task_locations.pop(spec["task_id"], None)
            spec["_lane_retries"] = spec.get("_lane_retries", 0) + 1
            self.close()
            raise RpcError(f"lane transport failure: {e!r}")
        self.core._task_locations.pop(spec["task_id"], None)
        if reply.get("requeue"):
            # Worker retiring / lane evaporated: the call never ran.
            spec["_lane_retries"] = spec.get("_lane_retries", 0) + 1
            self.close()
            raise RpcError("lane worker retiring")
        return reply

    async def apply_async(self, blob: bytes, name: str = "dag_stage"):
        """Long-running lane body (compiled-DAG stage loop): returns the
        in-flight call's coroutine result dict when the loop exits."""
        if self._open_task is not None:
            await asyncio.shield(self._open_task)
            self._open_task = None
        if self.state != "ready":
            raise RpcError("lane closed")
        return await self._client.call("Worker", "lane_apply",
                                       blob=Raw(blob), name=name,
                                       timeout=None)

    def close(self, reason: str = "") -> None:
        """Idempotent teardown: unregister, close the worker lane,
        return (unpin) the lease, drop the dedicated connection."""
        if self.state == "closed":
            return
        self.state = "closed"
        if not self.exclusive \
                and self.core._pinned_lanes.get(self.key) is self:
            del self.core._pinned_lanes[self.key]
        self.core._lane_stat("closed")
        asyncio.ensure_future(self._close_async())

    async def _close_async(self) -> None:
        client, self._client = self._client, None
        if client is not None:
            try:
                await client.call("Worker", "lane_close",
                                  lane_id=self.lane_id, timeout=5)
            except Exception:  # noqa: BLE001 — worker may be gone
                pass
            try:
                await client.close()
            except Exception:  # noqa: BLE001
                pass
        if self.daemon_address and self.lease_id:
            # Unpin: a dead worker's lease was already auto-returned by
            # the daemon's monitor; the double return is a no-op.
            try:
                daemon = await self.core._aclient(self.daemon_address)
                await daemon.call("NodeDaemon", "return_lease",
                                  lease_id=self.lease_id, timeout=10)
            except Exception:  # noqa: BLE001
                pass


class OwnerService:
    """Serves this process's owned small objects to other processes.

    The TPU-native analogue of the reference's owner-based in-process
    memory store served over CoreWorkerService.GetObjectStatus (ref:
    src/ray/core_worker/core_worker.cc HandleGetObjectStatus returning
    in-band small values; memory_store.cc): small task returns live in
    the OWNER's inline cache — never eagerly written to the node store —
    and any process holding a ref (refs pickle with their owner address)
    fetches them from the owner on a directory miss. Owner death loses
    the object, exactly as in the reference."""

    def __init__(self, core: "DistributedCoreWorker"):
        self.core = core

    def get_object(self, object_id: bytes) -> dict:
        oid = ObjectID(object_id)
        payload = self.core._inline_cache.get(oid)
        if payload is None:
            buf = self.core.store.get_buffer(oid)
            if buf is not None:
                payload = bytes(buf.view)
        return {"payload": payload,
                "pending": payload is None
                and oid in self.core._pending_objects}

    def borrow_update(self, events) -> dict:
        """Batched borrow protocol deltas from a borrower: see
        DistributedCoreWorker._ref_serialized."""
        self.core.apply_borrow_update(events)
        return {"ok": True}


class DistributedCoreWorker:
    def __init__(
        self,
        *,
        gcs_address: str,
        node_id: str,
        daemon_address: str,
        store_dir: str,
        job_id: str,
        is_driver: bool,
        worker_address: str = "",
        loop_thread: Optional[EventLoopThread] = None,
        log_to_driver: bool = True,
    ):
        self.gcs_address = gcs_address
        self.node_id = node_id
        self.node_id_hex = node_id
        self.daemon_address = daemon_address
        self.job_id = job_id
        self.is_driver = is_driver

        # grpc.aio binds its poller to one event loop per process — every
        # grpc object (server + clients) must live on this single loop.
        self.loop_thread = loop_thread or EventLoopThread(
            name="core-worker-rpc")
        self._owner_server = None
        if worker_address:
            self.address = worker_address
        else:
            # Drivers serve their owned small objects too (workers
            # register OwnerService on their existing server): every
            # owner is addressable, so inline results need no eager
            # node-store write. See OwnerService.
            self._owner_server = RpcServer("127.0.0.1", 0)
            self._owner_server.add_service("Owner", OwnerService(self))
            self.loop_thread.run(self._owner_server.start())
            self.address = self._owner_server.address
        self._owner_clients: Dict[str, SyncRpcClient] = {}
        # GCS load attribution: drivers and workers are the "client"
        # component — ad-hoc state reads, KV, object directory calls.
        from ray_tpu_torch.core.distributed.rpc import set_caller_identity

        set_caller_identity(node_id, "client")
        self.gcs = SyncRpcClient(gcs_address, self.loop_thread)
        from ray_tpu_torch.core.distributed.pull_manager import PullManager
        from ray_tpu_torch.core.distributed.transfer import (
            RawChunkFetcher, make_transfer_metrics)

        # Striped transfer backend: raw-frame chunks fetched from every
        # replica at once land straight in the local store's mmap
        # (recv_into, create-then-fill) — pull_manager.py / transfer.py.
        self._xfer_metrics = make_transfer_metrics(
            {"node_id": node_id[:12], "component": "worker"})
        self._chunk_fetcher = RawChunkFetcher()
        self._pull_manager = PullManager(
            self.loop_thread.loop,
            fetch_chunk=self._chunk_fetcher.fetch,
            open_sink=self._open_pull_sink,
            metrics=self._xfer_metrics)
        self._submit_buffer: deque = deque()
        self._submit_scheduled = False
        # Bounded task-event pipeline (task_events.py): this process's
        # status transitions (drivers: SUBMITTED/LEASED; executors:
        # RUNNING/terminal), opt-in profile events, and tracing spans
        # all coalesce here and flush to the GCS off the hot path.
        from ray_tpu_torch.core.distributed.task_events import TaskEventBuffer

        self.task_events = TaskEventBuffer(
            flush_fn=self._flush_task_events, node_id=node_id,
            pid=os.getpid())
        self._submit_identity = (node_id, os.getpid())
        if get_config().task_events_enabled or get_config().tracing_enabled:
            self.loop_thread.submit(self.task_events.flush_loop())
        if get_config().tracing_enabled:
            # Spans get stamped with this process's node so the timeline
            # places them under the emitting node/worker rows.
            from ray_tpu_torch.util import tracing

            tracing.set_node_context(node_id)
        self.loop_thread.submit(self._borrow_sweep_loop())
        self.daemon = SyncRpcClient(daemon_address, self.loop_thread)
        self.store = ObjectStore(store_dir)

        # ---- ownership / refcounts (owner = this process) ----
        self._lock = threading.RLock()
        self._owned: set = set()                 # ObjectIDs owned here
        self._refcounts: Dict[ObjectID, int] = defaultdict(int)
        self._free_batch: List[bytes] = []
        # ---- borrow protocol state (see _ref_serialized) ----
        # transit: oid -> expiry (serialized-but-unregistered handoffs,
        # one coarse window); borrow: oid -> (count, expiry) registered
        # remote borrowers.
        self._transit_pins: Dict[ObjectID, float] = {}
        self._borrow_pins: Dict[ObjectID, Tuple[int, float]] = {}
        self._borrowed_owner: Dict[ObjectID, str] = {}
        self._deferred_free: set = set()
        self._borrow_outbox: Dict[str, list] = {}
        self._borrow_flush_scheduled = False
        self._borrow_flush_lock: Optional[asyncio.Lock] = None
        self._inline_cache: Dict[ObjectID, bytes] = {}
        # Task ids tombstoned by cancel(): queued entries are swept,
        # running tasks interrupted, retries suppressed. Entries are
        # consumed wherever a cancellation completes; insertion-ordered
        # and bounded (see _tombstone) so a cancel that never meets its
        # task ages out instead of leaking.
        self._cancelled_tasks: Dict[bytes, None] = {}
        # task_id -> None for streaming tasks whose stream is still
        # running (streams register no _pending_objects entries, so
        # cancel() needs its own liveness map to route tombstones).
        self._live_streams: Dict[bytes, None] = {}
        # task_id -> worker address while a lane batch holding it is in
        # flight (routes running-task cancels to the right worker).
        self._task_locations: Dict[bytes, str] = {}
        self._inline_cache_order: deque = deque()

        # ---- pending tasks (futures resolve when reply arrives) ----
        self._pending_objects: Dict[ObjectID, Future] = {}

        # ---- lineage: task specs retained for owned task returns so a
        # lost object can be recomputed by resubmitting its creating task
        # (ref: task_manager.h:208 TaskResubmissionInterface,
        # object_recovery_manager.h:41). Entries are pinned while any
        # downstream lineage entry depends on them (ref: lineage pinning,
        # ray_config_def.h:145) and byte-capped FIFO (:158).
        self._lineage: Dict[ObjectID, dict] = {}
        self._lineage_order: List[ObjectID] = []
        self._lineage_pins: Dict[ObjectID, int] = {}
        self._lineage_bytes = 0
        # Oids whose PINNED lineage was cap-evicted: marked so a later
        # reconstruction attempt fails fast instead of hanging (the
        # reference marks such objects unreconstructable).
        self._lineage_evicted: set = set()

        # ---- function table cache ----
        self._exported_fns: set = set()
        self._fn_cache: Dict[bytes, Any] = {}
        import weakref

        self._fn_key_cache = weakref.WeakKeyDictionary()

        # ---- actor address cache ----
        self._actor_cache: Dict[str, dict] = {}
        self._actor_seq: Dict[str, int] = defaultdict(int)
        # Async channels for the submission pipeline (created lazily ON the
        # loop thread; grpc.aio binds objects to the running loop).
        self._aclients: Dict[str, AsyncRpcClient] = {}
        self._agcs: Optional[AsyncRpcClient] = None
        # Batched directory registration (one RPC per burst, not per
        # result; ref: object location updates ride batched pubsub).
        # Producers append under _loc_lock from any thread; only the
        # first append of a burst pays the loop wake-up — on one-core
        # hosts the self-pipe write alone costs ~ms under GIL contention,
        # so a wake per put() would tax the large-put fast path.
        self._loc_lock = threading.Lock()
        self._loc_batch: List[Tuple[bytes, int]] = []
        self._loc_flushing = False
        self._loc_wake_pending = False
        # Per-worker-address actor push batching.
        self._push_queues: Dict[str, "deque"] = {}
        self._push_flushing: Dict[str, bool] = {}
        # Submissions parked while their actor resolves (FIFO per actor).
        self._actor_pending: Dict[str, "deque"] = {}
        # Lease reuse lanes keyed by (demand, sched, runtime_env).
        self._lanes: Dict[tuple, "_TaskLane"] = {}
        # Pre-leased (pinned) task lanes keyed by (fn_key, demand,
        # sched, runtime_env) + per-signature call counts that decide
        # when a signature is hot enough to pin (task_lane_min_calls).
        self._pinned_lanes: Dict[tuple, "_PinnedLane"] = {}
        self._lane_calls: Dict[tuple, int] = {}
        self._lane_reaper: Optional[asyncio.Future] = None
        self.lane_stats = {"hits": 0, "misses": 0, "spills": 0,
                           "opened": 0, "closed": 0}
        from ray_tpu_torch.util.metrics import Counter

        self._m_lane = Counter(
            "raytpu_task_lane_calls_total",
            "Pre-leased task lane dispatch outcomes",
            tag_keys=("outcome",))
        # Raw runtime_env json -> normalized (pkg:// uploaded) spec.
        self._norm_env_cache: Dict[str, Optional[dict]] = {}
        # Job-level default runtime env (init(runtime_env=...)).
        self.job_runtime_env: Optional[dict] = None

        self._shutdown = False
        install_refcounter(self._ref_added, self._ref_removed,
                           self._ref_serialized)
        # Open the async GCS control connection now, off the critical
        # path: the first put() otherwise pays TCP setup inside its
        # location flush, which contends with the store write for the
        # GIL on small hosts.
        self.loop_thread.submit(self._warm_gcs())
        if is_driver:
            if log_to_driver and get_config().log_to_driver:
                self.loop_thread.submit(self._stream_logs_to_driver())
            atexit.register(self.shutdown)

    async def _stream_logs_to_driver(self) -> None:
        """Relay this job's worker stdout/stderr to the driver, prefixed
        (ref: the log_monitor → GCS pubsub → worker.py print_logs path;
        log records flow from each node's LogMonitor through the GCS
        LogManager's ``logs`` channel). Printing happens on a DEDICATED
        thread: a stalled driver stdout (`python train.py | less`) must
        block log relay only — a print() on the RPC loop would stall
        every RPC in the process."""
        import queue as _queue

        from ray_tpu_torch.core.distributed.log_monitor import format_log_prefix

        printq: "_queue.Queue" = _queue.Queue(maxsize=1000)

        def printer():
            import sys

            while True:
                rec = printq.get()
                if rec is None:
                    return
                prefix = format_log_prefix(rec)
                out = (sys.stderr if rec.get("stream") == "stderr"
                       else sys.stdout)
                for line in rec["lines"]:
                    print(f"{prefix} {line}", file=out, flush=True)

        threading.Thread(target=printer, daemon=True,
                         name="log-printer").start()
        try:
            while not self._shutdown:
                client = AsyncRpcClient(self.gcs_address)
                try:
                    async for rec in client.stream(
                            "Pubsub", "stream_subscribe", channel="logs"):
                        job = rec.get("job_id")
                        # Unattributed lines (worker startup before its
                        # first lease) pass through; other jobs' do not.
                        if job and job != self.job_id:
                            continue
                        try:
                            printq.put_nowait(rec)
                        except _queue.Full:
                            pass  # consumer stalled: drop, don't block
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 GCS blip: reconnect
                    await asyncio.sleep(1.0)
                finally:
                    try:
                        await client.close()
                    except Exception:  # noqa: BLE001
                        pass
        finally:
            try:
                printq.put_nowait(None)
            except _queue.Full:
                pass  # daemon printer thread; lost sentinel is harmless

    # ------------------------------------------------------------------
    # reference counting / distributed GC
    # ------------------------------------------------------------------
    # Borrow protocol (ref: reference_count.h borrower bookkeeping).
    # Serializing an OWNED ref adds a TTL'd transit pin — the object
    # cannot be freed while its ref rides a message to a borrower.
    # Deserializing a borrowed ref queues a batched `borrow_add` to the
    # owner (which converts one transit pin into a tracked borrow);
    # dropping the last local ref queues `borrow_release`. An owned
    # object whose local refcount hits zero while pinned defers its
    # free until the pins clear. Backstops: transit pins expire
    # TRANSIT_PIN_TTL_S after the LAST serialization; registered
    # borrows expire BORROW_TTL_S after their last add/refresh, and
    # live borrowers re-send refreshes every sweep — so a SIGKILLed
    # borrower pins the owner's object for at most one TTL, not
    # forever.
    TRANSIT_PIN_TTL_S = 600.0
    BORROW_TTL_S = 600.0

    def _ref_serialized(self, ref: ObjectRef) -> None:
        if self._shutdown:
            return
        oid = ref.id()
        owner = ref.owner_address
        with self._lock:
            if oid in self._owned:
                self._add_transit_pin_locked(oid)
            elif owner and owner != self.address:
                # Pass-through borrow: tell the owner a new transit is
                # in flight (batched, best-effort; TTL at the owner).
                self._queue_borrow_locked(owner, oid, "transit")

    # Once SOME borrower registered, remaining in-flight handoffs get
    # this grace to register before the transit pin may lapse (borrow
    # pins protect the object from then on). Counting pins per handoff
    # and retiring one per `add` would mis-pair under broadcast (one
    # serialization, N deserializers) and could steal an unrelated
    # handoff's protection — a single coarse expiry cannot.
    TRANSIT_GRACE_S = 60.0

    def _add_transit_pin_locked(self, oid: ObjectID) -> None:
        # ONE coarse expiry — TTL after the LAST serialization — so a
        # hot ref re-sent thousands of times costs O(1) state.
        self._transit_pins[oid] = \
            time.monotonic() + self.TRANSIT_PIN_TTL_S

    def _ref_added(self, ref: ObjectRef) -> None:
        oid = ref.id()
        owner = ref.owner_address
        with self._lock:
            n = self._refcounts[oid]
            self._refcounts[oid] = n + 1
            if (n == 0 and owner and owner != self.address
                    and not self._shutdown):
                self._borrowed_owner[oid] = owner
                self._queue_borrow_locked(owner, oid, "add")

    def _ref_removed(self, ref: ObjectRef) -> None:
        if self._shutdown:
            return
        with self._lock:
            self._decref_locked(ref.id())

    def _decref_locked(self, oid: ObjectID) -> None:
        n = self._refcounts.get(oid)
        if n is None:
            return
        if n <= 1:
            del self._refcounts[oid]
            self._drop_lineage_locked(oid)
            owner = self._borrowed_owner.pop(oid, None)
            if owner is not None:
                self._queue_borrow_locked(owner, oid, "release")
            if oid in self._owned:
                if self._has_pins_locked(oid):
                    # Borrowers (or in-flight handoffs) still reference
                    # this object: free when the pins clear.
                    self._deferred_free.add(oid)
                    return
                self._free_owned_locked(oid)
        else:
            self._refcounts[oid] = n - 1

    def _free_owned_locked(self, oid: ObjectID) -> None:
        self._owned.discard(oid)
        self._deferred_free.discard(oid)
        self._transit_pins.pop(oid, None)
        self._borrow_pins.pop(oid, None)
        self._inline_cache.pop(oid, None)
        self._free_batch.append(oid.binary())
        if len(self._free_batch) >= 100:
            self._flush_frees_locked()

    def _has_pins_locked(self, oid: ObjectID) -> bool:
        now = time.monotonic()
        borrow = self._borrow_pins.get(oid)
        if borrow is not None:
            count, expiry = borrow
            if count > 0 and expiry > now:
                return True
            # Expired: the borrower stopped refreshing (crashed).
            del self._borrow_pins[oid]
        expiry = self._transit_pins.get(oid)
        if expiry is not None:
            if expiry > now:
                return True
            del self._transit_pins[oid]
        return False

    def _queue_borrow_locked(self, owner: str, oid: ObjectID,
                             kind: str) -> None:
        self._borrow_outbox.setdefault(owner, []).append(
            (kind, oid.binary()))
        if not self._borrow_flush_scheduled:
            self._borrow_flush_scheduled = True
            try:
                self.loop_thread.loop.call_soon_threadsafe(
                    self._schedule_borrow_flush)
            except Exception:  # noqa: BLE001 loop shutting down
                self._borrow_flush_scheduled = False

    def _schedule_borrow_flush(self) -> None:
        # Small coalescing delay: a consume loop dropping hundreds of
        # borrowed refs flushes one RPC per owner, not one per ref.
        self.loop_thread.loop.call_later(
            0.1, lambda: asyncio.ensure_future(self._flush_borrows()))

    BORROW_FLUSH_RETRIES = 5

    async def _flush_borrows(self) -> None:
        # Serialized: two concurrent flush bodies could deliver a
        # 'release' (queued during the first flush's failing RPC) ahead
        # of the 'add' it pairs with — the owner would then hold a
        # count-1 borrow pin no borrower ever releases (until TTL).
        if self._borrow_flush_lock is None:
            self._borrow_flush_lock = asyncio.Lock()
        async with self._borrow_flush_lock:
            await self._flush_borrows_serialized()

    async def _flush_borrows_serialized(self) -> None:
        with self._lock:
            outbox, self._borrow_outbox = self._borrow_outbox, {}
            self._borrow_flush_scheduled = False
        for owner, events in outbox.items():
            wire = [(kind, oid_b) for kind, oid_b, *_ in events]
            try:
                client = await self._aclient(owner)
                await client.call(
                    "Owner", "borrow_update", events=wire, timeout=10)
            except Exception:  # noqa: BLE001
                # Transient failure must NOT drop the events — a lost
                # `add` would let a reachable owner free an object a
                # live borrower holds. Re-queue with a retry budget;
                # only a persistently unreachable (dead) owner drops
                # them, and its objects die with it anyway.
                keep = []
                for kind, oid_b, *rest in events:
                    attempts = (rest[0] if rest else 0) + 1
                    if attempts < self.BORROW_FLUSH_RETRIES:
                        keep.append((kind, oid_b, attempts))
                if keep:
                    with self._lock:
                        # PREPEND: a release queued during the retry
                        # window must not be applied before the failed
                        # add it pairs with (events are order-sensitive
                        # per oid).
                        existing = self._borrow_outbox.get(owner, [])
                        self._borrow_outbox[owner] = keep + existing
                        if not self._borrow_flush_scheduled:
                            self._borrow_flush_scheduled = True
                            self.loop_thread.loop.call_later(
                                1.0, lambda: asyncio.ensure_future(
                                    self._flush_borrows()))

    async def _borrow_sweep_loop(self) -> None:
        """Periodic borrow maintenance: refresh this process's live
        borrows at their owners (so their pins don't TTL out under us),
        expire pins whose borrower never registered or crashed, and run
        the deferred frees they were blocking."""
        while not self._shutdown:
            await asyncio.sleep(30.0)
            with self._lock:
                for oid, owner in self._borrowed_owner.items():
                    self._queue_borrow_locked(owner, oid, "refresh")
                for oid in list(self._deferred_free):
                    if (not self._has_pins_locked(oid)
                            and oid not in self._refcounts):
                        self._free_owned_locked(oid)
                self._flush_frees_locked()

    def apply_borrow_update(self, events) -> None:
        """Owner side of the protocol (called via OwnerService)."""
        now = time.monotonic()
        expiry = now + self.BORROW_TTL_S
        with self._lock:
            touched = set()
            for kind, oid_b in events:
                oid = ObjectID(oid_b)
                touched.add(oid)
                if kind == "add":
                    count, _ = self._borrow_pins.get(oid, (0, 0.0))
                    self._borrow_pins[oid] = (count + 1, expiry)
                    # A borrower registered: shorten (never extend) the
                    # transit window — other still-in-flight handoffs
                    # get TRANSIT_GRACE_S to register; after that the
                    # borrow pins carry the object.
                    texp = self._transit_pins.get(oid)
                    if texp is not None:
                        self._transit_pins[oid] = min(
                            texp, now + self.TRANSIT_GRACE_S)
                elif kind == "refresh":
                    pin = self._borrow_pins.get(oid)
                    if pin is not None:
                        self._borrow_pins[oid] = (pin[0], expiry)
                elif kind == "release":
                    count, _ = self._borrow_pins.get(oid, (0, 0.0))
                    if count > 1:
                        self._borrow_pins[oid] = (count - 1, expiry)
                    else:
                        self._borrow_pins.pop(oid, None)
                elif kind == "transit":
                    self._add_transit_pin_locked(oid)
            for oid in touched:
                if (oid in self._deferred_free
                        and not self._has_pins_locked(oid)
                        and oid not in self._refcounts):
                    self._free_owned_locked(oid)

    def _pin_task_deps(self, deps, fut: Future) -> None:
        """Pin a submitted task's argument objects until it completes
        (ref: reference_count.h:61 — 'Add references for the object
        dependencies of a submitted task'). Without this, the caller
        dropping its arg ObjectRefs after .remote() lets the free path
        delete the objects from store+directory while the task is still
        in flight — its arg fetch then stalls on an object that no
        longer exists anywhere (observed intermittently in the sort
        exchange: merge tasks racing the free of partition outputs)."""
        if not deps:
            return
        dep_oids = [ObjectID(d) for d in deps]
        with self._lock:
            for oid in dep_oids:
                self._refcounts[oid] += 1

        def unpin(_f):
            if self._shutdown:
                return
            with self._lock:
                for oid in dep_oids:
                    self._decref_locked(oid)

        fut.add_done_callback(unpin)

    def _flush_frees_locked(self):
        """Send the pending frees to the object directory; returns the
        future of the send (None when nothing was pending)."""
        batch, self._free_batch = self._free_batch, []
        if not batch:
            return None

        async def free():
            try:
                client = AsyncRpcClient(self.gcs_address)
                await client.call("ObjectDirectory", "free_objects",
                                  object_ids=batch, timeout=30)
                await client.close()
            except Exception as e:  # noqa: BLE001
                logger.debug("free_objects failed: %s", e)

        return self.loop_thread.submit(free())

    def flush_frees(self, timeout: float = 10.0) -> None:
        """Free now, and wait for it, what this process owns and has
        dropped. Frees are batched (sent at 100, by the 30 s sweep or at
        shutdown), so a process that ends without `shutdown` (a replica's
        `os._exit`) calls this first, or the objects it owned stay in
        the node's store with no owner left to free them."""
        with self._lock:
            fut = self._flush_frees_locked()
        # On the loop's own thread the send cannot run while we wait.
        if (fut is not None and threading.current_thread()
                is not self.loop_thread._thread):
            try:
                fut.result(timeout)
            except Exception as e:  # noqa: BLE001
                logger.debug("free_objects did not finish: %s", e)

    # ------------------------------------------------------------------
    # object API
    # ------------------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.from_random()
        self._store_local(oid, value)
        ref = ObjectRef(oid, self.address)
        with self._lock:
            self._owned.add(oid)
        return ref

    def _store_local(self, oid: ObjectID, value: Any,
                     is_error: bool = False) -> int:
        from ray_tpu_torch.core.object_store import ObjectExistsError

        meta, buffers = serialization.serialize(value, is_error=is_error)
        try:
            size = self.store.put_serialized(oid, meta, buffers)
        except ObjectExistsError:
            return 0
        # Location registration rides the loop asynchronously: local gets
        # hit the store directly, remote readers poll the directory until
        # the (retried) registration lands — put() itself stays store-speed.
        self.queue_location(oid, size)
        return size

    def queue_location(self, oid: ObjectID, size: int,
                       owner: Optional[str] = None) -> None:
        """Thread-safe enqueue onto the batched location flusher.

        The entry lands in the shared batch directly; the loop is woken
        at most once per burst (coalesced via _loc_wake_pending), so a
        tight put() loop pays one self-pipe write, not one per object.
        `owner` (default: this process) rides the same batch, so the
        directory learns whose death frees the object without an RPC
        per put."""
        with self._loc_lock:
            self._loc_batch.append((oid.binary(), size,
                                    owner or self.address))
            if self._loc_wake_pending:
                return
            self._loc_wake_pending = True
        self.loop_thread.loop.call_soon_threadsafe(self._loc_kick)

    async def _flush_locations(self) -> None:
        try:
            while True:
                with self._loc_lock:
                    if not self._loc_batch:
                        break
                    batch, self._loc_batch = self._loc_batch, []
                entries = [(o, self.node_id, s, w) for o, s, w in batch]
                gcs = await self._aget_gcs()
                sent = False
                for attempt in range(5):
                    try:
                        await gcs.call("ObjectDirectory", "add_locations",
                                       entries=entries, timeout=30)
                        sent = True
                        break
                    except Exception as e:  # noqa: BLE001
                        logger.debug("add_locations retry %d: %s",
                                     attempt, e)
                        await asyncio.sleep(min(0.1 * (attempt + 1), 1.0))
                if not sent:
                    # GCS outage outlasted the retry window: NEVER drop —
                    # an unregistered stored object is silent data loss
                    # for remote readers. Re-queue and retry later.
                    logger.warning(
                        "add_locations failed %d entries; retrying in 2s",
                        len(batch))
                    with self._loc_lock:
                        self._loc_batch.extend(batch)
                    self.loop_thread.loop.call_later(2.0, self._loc_kick)
                    return
        finally:
            self._loc_flushing = False

    def _loc_kick(self) -> None:
        with self._loc_lock:
            self._loc_wake_pending = False
        if self._loc_batch and not self._loc_flushing:
            self._loc_flushing = True
            asyncio.ensure_future(self._flush_locations())

    INLINE_CACHE_CAP = 10000

    def _cache_inline_locked(self, oid: ObjectID, payload: bytes) -> None:
        if oid not in self._inline_cache:
            if payload == _NONE_PAYLOAD:
                # Canonical None result: share the ONE payload object and
                # skip the eviction ring — a burst of side-effect actor
                # calls would otherwise churn (and spill) the ring with
                # thousands of identical ~100-byte entries. Freed on
                # decref like any owned inline entry, so growth stays
                # bounded by live refs.
                self._inline_cache[oid] = _NONE_PAYLOAD
                return
            self._inline_cache[oid] = payload
            self._inline_cache_order.append(oid)

    def _evict_inline_locked(self) -> None:
        while len(self._inline_cache_order) > self.INLINE_CACHE_CAP:
            old = self._inline_cache_order.popleft()
            payload = self._inline_cache.pop(old, None)
            # The inline cache is the PRIMARY copy of owned small
            # results (no eager store write — see OwnerService): an
            # owned entry with live refs spills to the node store on
            # eviction instead of vanishing.
            if (payload is not None and old in self._owned
                    and self._refcounts.get(old, 0) > 0
                    and not self.store.contains(old)):
                try:
                    self.store.put_raw(old, payload)
                    self.queue_location(old, len(payload))
                except Exception:  # noqa: BLE001 store full: keep the
                    # entry (slightly over cap) — dropping it here would
                    # lose the only copy of a live object.
                    self._inline_cache[old] = payload
                    self._inline_cache_order.append(old)
                    break

    def _cache_inline(self, oid: ObjectID, payload: bytes) -> None:
        with self._lock:
            self._cache_inline_locked(oid, payload)
            self._evict_inline_locked()

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None,
            _priority: Optional[int] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        return [self._get_one(r, deadline, _priority) for r in refs]

    def _get_one(self, ref: ObjectRef, deadline: Optional[float],
                 priority: Optional[int] = None) -> Any:
        oid = ref.id()
        backoff = 0.002
        definite_misses = 0
        first_miss_at: Optional[float] = None
        while True:
            # 1) inline cache
            payload = self._inline_cache.get(oid)
            if payload is not None:
                if payload == _NONE_PAYLOAD:
                    # Dominant actor-call reply shape (methods returning
                    # None): skip the per-get deserialize.
                    return None
                return serialization.deserialize(payload)
            # 2) local store (zero-copy)
            buf = self.store.get_buffer(oid)
            if buf is not None:
                return serialization.deserialize(buf.view)
            # 3) pending local task result
            fut = self._pending_objects.get(oid)
            if fut is not None:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise rexc.GetTimeoutError(ref.hex())
                try:
                    fut.result(timeout=remaining)
                except (TimeoutError, FutureTimeoutError):
                    raise rexc.GetTimeoutError(ref.hex()) from None
                continue
            # 4) remote fetch via directory
            pulled, num_locations = self._try_pull_remote(oid,
                                                          priority=priority)
            if pulled:
                continue  # now in local store
            # 4b) small objects live in their OWNER's inline cache (no
            # eager store write — see OwnerService): on a directory
            # miss, ask the owner directly.
            owner = ref.owner_address
            owner_definitely_missing = False
            if owner and owner != self.address:
                got, producing, absent = self._try_fetch_from_owner(
                    oid, owner)
                if got:
                    continue  # now in the inline cache
                if producing:
                    # The owner is still running the producing task:
                    # not lost, keep polling.
                    num_locations = max(num_locations, 1)
                owner_definitely_missing = absent
                if (num_locations == 0 and not (producing or absent)
                        and self._owner_died(owner)):
                    # Unreachable owner that its daemon saw die: the
                    # daemon freed what it owned, so nothing can bring
                    # the value back.
                    raise rexc.OwnerDiedError(
                        ref.hex(), f"object {ref.hex()[:16]} is lost: "
                        f"its owner {owner} died")
            # 5) object lost (no copies anywhere): lineage reconstruction
            if num_locations == 0 and self._maybe_reconstruct(oid, deadline):
                continue
            if num_locations == 0 and owner_definitely_missing \
                    and not self._lineage.get(oid):
                # Nobody has it, the owner isn't producing it, and we
                # cannot reconstruct: surface the loss instead of
                # polling forever (the borrow protocol makes this an
                # exceptional state — owner death or pin-TTL expiry).
                definite_misses += 1
                now = time.monotonic()
                if first_miss_at is None:
                    first_miss_at = now
                if definite_misses >= 10 and now - first_miss_at > 2.0:
                    raise rexc.ObjectLostError(
                        f"object {ref.hex()[:16]} exists nowhere: no "
                        f"store copy, owner {owner} has no value and "
                        f"is not producing it, and this process holds "
                        f"no lineage to reconstruct it")
            else:
                definite_misses = 0
                first_miss_at = None
            if deadline is not None and time.monotonic() >= deadline:
                raise rexc.GetTimeoutError(ref.hex())
            time.sleep(backoff)
            backoff = min(backoff * 2, 0.05)

    OWNER_CLIENT_CAP = 32

    def _owner_died(self, owner_addr: str) -> bool:
        """Whether a daemon reported the worker at `owner_addr` dead (and
        freed its objects); asked only once the owner is unreachable."""
        try:
            return bool(self.gcs.call("ObjectDirectory", "owner_died",
                                      owner=owner_addr, timeout=10))
        except Exception:  # noqa: BLE001 GCS unreachable: indeterminate
            return False

    def _try_fetch_from_owner(self, oid: ObjectID, owner_addr: str
                              ) -> Tuple[bool, bool, bool]:
        """Fetch a small object from its owner's inline cache (ref:
        in-band small-object replies via GetObjectStatus). Returns
        (fetched, owner_still_producing, definitely_absent) —
        `definitely_absent` only when the owner ANSWERED and has
        neither the value nor a producing task; an unreachable owner
        is indeterminate (transient restarts must not read as loss)."""
        client = self._owner_clients.get(owner_addr)
        if client is None:
            client = self._owner_clients[owner_addr] = SyncRpcClient(
                owner_addr, self.loop_thread)
            # Bounded: owners churn (max_calls retirement spawns fresh
            # worker addresses), so cap and close the oldest instead of
            # accreting dead-owner clients forever.
            while len(self._owner_clients) > self.OWNER_CLIENT_CAP:
                old = next(iter(self._owner_clients))
                try:
                    self._owner_clients.pop(old).close()
                except Exception:  # noqa: BLE001
                    pass
        try:
            rep = client.call("Owner", "get_object",
                              object_id=oid.binary(), timeout=10)
        except Exception:  # noqa: BLE001 owner gone/unreachable: the
            return False, False, False   # directory/lineage path decides
        payload = rep.get("payload")
        if payload is None:
            pending = bool(rep.get("pending"))
            return False, pending, not pending
        self._cache_inline(oid, payload)
        return True, False, False

    def _try_pull_remote(self, oid: ObjectID,
                         priority: Optional[int] = None
                         ) -> Tuple[bool, int]:
        """Returns (pulled_into_local_store, usable_location_count).

        A node that explicitly answers "missing" evicted its copy without
        telling the directory — such stale locations are removed so an
        object whose every copy was LRU-evicted counts as lost (and
        becomes reconstructable) rather than polling forever. Unreachable
        nodes still count: they may come back. Transfers go through the
        PullManager (dedup + priority + in-flight budget)."""
        from ray_tpu_torch.core.distributed import pull_manager as pm

        info = self.gcs.call("ObjectDirectory", "get_locations",
                             object_id=oid.binary(), timeout=30)
        stale = 0
        candidates = []
        for node in info["nodes"]:
            if node["node_id"] == self.node_id:
                if self.store.contains(oid):
                    continue  # caller re-checks; raced back in
                # Directory lists this node but the store evicted the copy.
                stale += 1
                self._remove_stale_location(oid, node["node_id"])
                continue
            candidates.append((node["node_id"], node["address"]))
        if not candidates:
            return False, len(info["nodes"]) - stale
        pull_t0 = time.time()
        try:
            total_size, stale_nodes = self._pull_manager.pull_sync(
                oid.binary(), candidates, info.get("size") or 1,
                priority=pm.PRIORITY_GET if priority is None else priority)
        except Exception as e:  # noqa: BLE001 transfer timeout/failure:
            # retriable — the caller's get loop keeps polling, exactly as
            # the per-node try/except of the pre-PullManager path did.
            logger.debug("pull of %s failed: %s", oid.hex()[:12], e)
            return False, len(info["nodes"]) - stale
        if total_size is not None:
            # Opt-in transfer profile event: pulls show up on the
            # timeline's node rows next to the tasks that waited on them.
            self.task_events.record_profile(
                f"pull:{oid.hex()[:12]}", "transfer", pull_t0,
                time.time(), object_id=oid.hex(), nbytes=total_size,
                sources=len(candidates))
        for nid in stale_nodes:
            stale += 1
            self._remove_stale_location(oid, nid)
        if total_size is None:
            return False, len(info["nodes"]) - stale
        # The striped pull sealed the bytes straight into the local
        # store (create-then-fill); register the new copy so other
        # processes (e.g. a worker fetching task args) can find it.
        try:
            self.gcs.call("ObjectDirectory", "add_location",
                          object_id=oid.binary(), node_id=self.node_id,
                          size=total_size, timeout=10)
        except Exception:  # noqa: BLE001
            pass
        return True, len(info["nodes"])

    def _remove_stale_location(self, oid: ObjectID, node_id: str) -> None:
        try:
            self.gcs.call("ObjectDirectory", "remove_location",
                          object_id=oid.binary(), node_id=node_id,
                          timeout=10)
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------------
    # lineage reconstruction (ref: object_recovery_manager.h:41 — the owner
    # resubmits the creating task when all copies of an object are lost)
    # ------------------------------------------------------------------
    def _drop_lineage_locked(self, oid: ObjectID, force: bool = False
                             ) -> None:
        """Drop `oid`'s lineage entry unless downstream lineage pins it;
        when an entry's last output is dropped, unpin (and maybe cascade-
        drop) its dependencies. Caller holds self._lock."""
        if self._lineage_pins.get(oid, 0) > 0:
            if not force:
                return
            if oid in self._lineage:
                logger.warning(
                    "lineage cap evicted pinned entry for %s — downstream "
                    "objects depending on it are no longer reconstructable",
                    oid.hex()[:8])
                if len(self._lineage_evicted) < 100_000:
                    self._lineage_evicted.add(oid)
        entry = self._lineage.pop(oid, None)
        if entry is None:
            return
        entry["live"] -= 1
        if entry["live"] > 0:
            return
        self._lineage_bytes -= entry["nbytes"]
        for dep in entry["deps"]:
            d = ObjectID(dep)
            n = self._lineage_pins.get(d, 0) - 1
            if n > 0:
                self._lineage_pins[d] = n
            else:
                self._lineage_pins.pop(d, None)
                if d not in self._refcounts:
                    self._drop_lineage_locked(d)

    def _maybe_reconstruct(self, oid: ObjectID,
                           deadline: Optional[float] = None) -> bool:
        """Resubmit the creating task of a lost owned object (on a worker
        thread) and wait for it, honoring the caller's deadline. Returns
        True if a reconstruction completed (caller re-checks the store)."""
        with self._lock:
            entry = self._lineage.get(oid)
            if entry is None:
                if oid in self._lineage_evicted:
                    raise rexc.ObjectReconstructionFailedError(
                        f"object {oid.hex()[:8]} lost; its lineage was "
                        f"evicted by the lineage cap "
                        f"(RAY_TPU_MAX_LINEAGE_BYTES)")
                return False
            fut = entry["fut"]
            if fut is None:
                if entry["attempts"] >= entry["max_attempts"]:
                    raise rexc.ObjectReconstructionFailedError(
                        f"object {oid.hex()[:8]} lost and reconstruction "
                        f"failed after {entry['attempts']} attempts")
                entry["attempts"] += 1
                entry["fut"] = fut = Future()
                logger.info("reconstructing lost object %s (attempt %d)",
                            oid.hex()[:8], entry["attempts"])
                threading.Thread(target=self._run_reconstruction,
                                 args=(oid, entry, fut),
                                 daemon=True).start()
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
            raise rexc.GetTimeoutError(oid.hex())
        try:
            fut.result(timeout=remaining)
        except (TimeoutError, FutureTimeoutError):
            # (both spelled out: they only became aliases in Python 3.11)
            raise rexc.GetTimeoutError(oid.hex()) from None
        return True

    def _run_reconstruction(self, oid: ObjectID, entry: dict,
                            fut: Future) -> None:
        try:
            # Grace recheck: location registration is asynchronous (batched
            # add_locations), so a freshly produced object can look lost
            # for a few ms. Never resubmit a task whose result is merely
            # still in flight to the directory.
            time.sleep(0.25)
            info = self.gcs.call("ObjectDirectory", "get_locations",
                                 object_id=oid.binary(), timeout=30)
            if info["nodes"] or self.store.contains(oid):
                with self._lock:
                    entry["attempts"] = max(0, entry["attempts"] - 1)
                fut.set_result(None)  # not lost; caller re-pulls
                return
            self._reconstruct_entry(entry)
            fut.set_result(None)
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)
        finally:
            with self._lock:
                entry["fut"] = None

    def _reconstruct_entry(self, entry: dict) -> None:
        # Recursively restore missing dependencies first (depth-first, like
        # the reference's recursive recovery of task args).
        for dep in entry["deps"]:
            dep_oid = ObjectID(dep)
            if self.store.contains(dep_oid):
                continue
            payload = self._inline_cache.get(dep_oid)
            if payload is not None:
                # Owner still holds the bytes: re-seed the store/directory.
                try:
                    self.store.put_raw(dep_oid, payload)
                    self.gcs.call("ObjectDirectory", "add_location",
                                  object_id=dep, node_id=self.node_id,
                                  size=len(payload), timeout=30)
                    continue
                except Exception:  # noqa: BLE001
                    pass
            # Stale-aware availability check (prunes directory entries for
            # evicted copies); reconstruct when no usable copy remains.
            pulled, usable = self._try_pull_remote(dep_oid)
            if pulled or usable > 0:
                continue
            if not self._maybe_reconstruct(dep_oid):
                raise rexc.ObjectReconstructionFailedError(
                    f"dependency {dep_oid.hex()[:8]} is lost and has no "
                    f"retained lineage — cannot reconstruct")
        spec = entry["spec"]
        spec["attempt"] = spec.get("attempt", 0) + 1
        reply = self._lease_and_push(spec, entry["demand"], entry["sched"])
        for r in reply["results"]:
            if r.inline is not None:
                self._cache_inline(ObjectID(r.oid), r.inline)

    def _open_pull_sink(self, oid_b: bytes, total_size: int):
        """Create-then-fill sink in the local store (striped_pull's
        open_sink fn): received chunks never touch the Python heap
        beyond their in-flight frame."""
        from ray_tpu_torch.core.distributed.transfer import ChunkSink

        return ChunkSink(
            self.store.create_for_receive(ObjectID(oid_b), total_size),
            total_size)

    async def _flush_task_events(self, **payload) -> None:
        """Transport for the TaskEventBuffer: one add_task_events RPC
        (the buffer owns retry/drop policy)."""
        gcs = await self._aget_gcs()
        await gcs.call("TaskEvents", "add_task_events", timeout=10,
                       _caller=(self.node_id, "task-events"), **payload)

    def _record_task_status(self, spec: dict, state: str,
                            ts: Optional[float] = None,
                            error: Optional[str] = None) -> None:
        """Record one status transition for a task spec into the bounded
        pipeline (no-op when task events are off; never blocks)."""
        opts = spec.get("options") or {}
        self.task_events.record_status(
            spec["task_id"].hex(), spec.get("attempt", 0), state, ts=ts,
            error=error, name=opts.get("name"),
            job_id=spec.get("job_id"), actor_id=spec.get("actor_id"))

    def _stamp_submit(self, spec: dict) -> None:
        """Submission-side history rides the SPEC, not a separate event:
        the executor folds submit/lease timestamps into its single
        terminal record, so the happy path ships ONE wire record per
        attempt instead of a driver record + an executor record merged
        at the GCS (half the flush volume — on a 1-core host the
        telemetry pipeline's CPU IS task throughput). The driver-side
        buffer still reports tasks that FAIL before reaching a worker
        (_record_driver_failure)."""
        spec["submit_ts"] = time.time()
        spec["submit_ctx"] = self._submit_identity

    def _record_driver_failure(self, spec: dict, error) -> None:
        """Terminal event for a task that died driver-side (lease
        refused, retries exhausted, cancelled while queued): no executor
        ever saw it, so no one else will report it. This is the rare
        complement of the executor's single-record happy path."""
        opts = spec.get("options") or {}
        te = self.task_events
        task_id = spec["task_id"].hex()
        attempt = spec.get("attempt", 0)
        sub = spec.get("submit_ts")
        if sub is not None:
            ctx = spec.get("submit_ctx") or (None, None)
            te.record_status(task_id, attempt, "SUBMITTED", ts=sub,
                             name=opts.get("name"),
                             job_id=spec.get("job_id"),
                             actor_id=spec.get("actor_id"),
                             submit_node_id=ctx[0], submit_pid=ctx[1])
        te.record_status(task_id, attempt, "FAILED", error=repr(error),
                         name=opts.get("name"),
                         job_id=spec.get("job_id"))

    def prefetch(self, refs: List[ObjectRef]) -> None:
        """Best-effort background pulls at the lowest priority (ref: the
        reference's prefetch/wait request class, pull_manager.h:52) —
        dataset pipelines warm the local store without competing with
        blocking gets."""
        def run():
            from ray_tpu_torch.core.distributed import pull_manager as pm

            # The producer's directory registration is asynchronous
            # (batched add_locations), so a single attempt right after
            # task completion races it — retry for a bounded window.
            # ROUND-ROBIN over the batch each sweep: a ref whose location
            # never appears must not starve the refs that are available
            # right now (this is the dataset-pipeline warming path).
            # The window must absorb worst-case control-plane stalls on a
            # loaded host (a 30s directory-lookup timeout per sweep is
            # possible): 60s gave up after ~2 slow sweeps and the warm
            # never landed, so the budget is several slow sweeps deep —
            # this is a daemon thread, so patience costs nothing.
            remaining = [r.id() for r in refs]
            deadline = time.monotonic() + 300.0
            backoff = 0.05
            while (remaining and not self._shutdown
                   and time.monotonic() < deadline):
                still = []
                for oid in remaining:
                    try:
                        if (self._inline_cache.get(oid) is not None
                                or self.store.contains(oid)):
                            continue
                        pulled, _ = self._try_pull_remote(
                            oid, priority=pm.PRIORITY_PREFETCH)
                        if pulled:
                            continue
                    except Exception:  # noqa: BLE001 best effort
                        pass
                    still.append(oid)
                remaining = still
                if remaining:
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 1.0)

        threading.Thread(target=run, daemon=True,
                         name="prefetch").start()

    def push_object(self, ref: ObjectRef, target_node_id: str,
                    timeout: float = 150.0) -> bool:
        """Proactively replicate an object to another node's store (ref:
        push_manager.h:30) — pre-stage data where work will run."""
        oid = ref.id()
        nodes = {n["node_id"]: n
                 for n in self.gcs.call("NodeInfo", "list_nodes",
                                        timeout=30)
                 if n["alive"]}
        target = nodes.get(target_node_id)
        if target is None:
            return False
        info = self.gcs.call("ObjectDirectory", "get_locations",
                             object_id=oid.binary(), timeout=30)
        holders = [n["node_id"] for n in info["nodes"]]
        if self.store.contains(oid) and self.node_id not in holders:
            holders.append(self.node_id)  # registration still in flight
        if target_node_id in holders:
            return True
        # Prefer this node's daemon as the pusher, else any ALIVE holder.
        if self.node_id in holders:
            holder_id = self.node_id
        else:
            holder_id = next((h for h in holders if h in nodes), None)
        if holder_id is None or holder_id not in nodes:
            return False
        client = SyncRpcClient(nodes[holder_id]["address"],
                               self.loop_thread)
        try:
            reply = client.call("NodeDaemon", "push_object",
                                object_id=oid.binary(),
                                target_address=target["address"],
                                timeout=timeout)
            return bool(reply.get("ok"))
        finally:
            client.close()

    def broadcast_object(self, ref: ObjectRef, node_ids: List[str],
                         timeout: float = 600.0) -> dict:
        """Pre-stage one object onto MANY nodes through the daemon
        relay tree (node_daemon.broadcast_object): the holder serves
        only its fanout children and the tree pipelines chunk relays,
        so weight-style 1->N distribution costs the owner fanout*size
        of uplink instead of N*size. Returns the daemon's verdict
        ({ok, nodes, bytes, errors})."""
        oid = ref.id()
        nodes = {n["node_id"]: n
                 for n in self.gcs.call("NodeInfo", "list_nodes",
                                        timeout=30)
                 if n["alive"]}
        info = self.gcs.call("ObjectDirectory", "get_locations",
                             object_id=oid.binary(), timeout=30)
        holders = [n["node_id"] for n in info["nodes"]]
        if self.store.contains(oid) and self.node_id not in holders:
            holders.append(self.node_id)  # registration still in flight
        if self.node_id in holders:
            holder_id = self.node_id
        else:
            holder_id = next((h for h in holders if h in nodes), None)
        if holder_id is None or holder_id not in nodes:
            return {"ok": False, "nodes": 0,
                    "errors": ["no live node holds the object"]}
        targets = [nodes[nid]["address"] for nid in node_ids
                   if nid in nodes and nid != holder_id
                   and nid not in holders]
        if not targets:
            return {"ok": True, "nodes": 0, "errors": []}
        client = SyncRpcClient(nodes[holder_id]["address"],
                               self.loop_thread)
        try:
            return client.call("NodeDaemon", "broadcast_object",
                               object_id=oid.binary(), targets=targets,
                               timeout=timeout)
        finally:
            client.close()

    def wait(self, refs: List[ObjectRef], num_returns: int,
             timeout: Optional[float], fetch_local: bool = True):
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        pending = list(refs)
        # Remote refs need a GCS directory lookup; back those off per-ref so
        # a long wait() doesn't poll the control plane every loop tick.
        gcs_next: Dict[bytes, float] = {}
        gcs_interval: Dict[bytes, float] = {}
        while True:
            still = []
            for r in pending:
                if self._is_ready(r, gcs_next, gcs_interval):
                    ready.append(r)
                else:
                    still.append(r)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        ready = ready[:num_returns]
        return ready, [r for r in refs if r not in ready]

    def _is_ready(self, ref: ObjectRef,
                  gcs_next: Optional[Dict[bytes, float]] = None,
                  gcs_interval: Optional[Dict[bytes, float]] = None) -> bool:
        oid = ref.id()
        if oid in self._inline_cache or self.store.contains(oid):
            return True
        fut = self._pending_objects.get(oid)
        if fut is not None:
            return fut.done()
        key = oid.binary()
        now = time.monotonic()
        if gcs_next is not None and now < gcs_next.get(key, 0.0):
            return False
        info = self.gcs.call("ObjectDirectory", "get_locations",
                             object_id=oid.binary(), timeout=30)
        if gcs_next is not None and gcs_interval is not None:
            interval = min(gcs_interval.get(key, 0.025) * 2, 1.0)
            gcs_interval[key] = interval
            gcs_next[key] = now + interval
        return bool(info["nodes"])

    def as_future(self, ref: ObjectRef) -> Future:
        fut: Future = Future()

        def waiter():
            try:
                fut.set_result(self.get([ref])[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=waiter, daemon=True).start()
        return fut

    # ------------------------------------------------------------------
    # internal KV (ref: gcs InternalKV client surface, _private/gcs_utils.py)
    # ------------------------------------------------------------------
    def kv_put(self, namespace: bytes, key: bytes, value: bytes,
               overwrite: bool = True) -> bool:
        ns = namespace.decode() if isinstance(namespace, bytes) else namespace
        return self.gcs.call("KV", "put", namespace=ns, key=key,
                             value=value, overwrite=overwrite, timeout=30)

    def kv_get(self, namespace: bytes, key: bytes) -> Optional[bytes]:
        ns = namespace.decode() if isinstance(namespace, bytes) else namespace
        return self.gcs.call("KV", "get", namespace=ns, key=key, timeout=30)

    def kv_del(self, namespace: bytes, key: bytes) -> bool:
        ns = namespace.decode() if isinstance(namespace, bytes) else namespace
        return self.gcs.call("KV", "delete", namespace=ns, key=key,
                             timeout=30)

    def kv_keys(self, namespace: bytes, prefix: bytes = b"") -> list:
        ns = namespace.decode() if isinstance(namespace, bytes) else namespace
        return self.gcs.call("KV", "keys", namespace=ns, prefix=prefix,
                             timeout=30)

    # ------------------------------------------------------------------
    # function table
    # ------------------------------------------------------------------
    def _export_function(self, func) -> bytes:
        # function_key is cloudpickle + sha1 — hundreds of µs, and it was
        # being paid on EVERY .remote() of the same function (the hottest
        # line of task submission by far). Key by function identity;
        # WeakKeyDictionary so redefined functions don't pin forever.
        try:
            key = self._fn_key_cache.get(func)
        except TypeError:  # unhashable/unweakrefable callable
            key = None
        if key is not None:
            return key
        key, blob = protocol.function_key(func)
        if key not in self._exported_fns:
            self.gcs.call("KV", "put", namespace="fn", key=key, value=blob,
                          overwrite=False, timeout=30)
            self._exported_fns.add(key)
        try:
            self._fn_key_cache[func] = key
        except TypeError:
            pass  # unhashable/unweakrefable callable: just re-hash later
        return key

    def fetch_function(self, key: bytes) -> Any:
        fn = self._fn_cache.get(key)
        if fn is None:
            blob = self.gcs.call("KV", "get", namespace="fn", key=key,
                                 timeout=30)
            if blob is None:
                raise rexc.RayTpuError(f"function {key.hex()} not found")
            fn = cloudpickle.loads(blob)
            self._fn_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    # task submission
    # ------------------------------------------------------------------
    def _promote_ref(self, ref: ObjectRef) -> None:
        """Ensure a ref's value is resolvable by another process: if only in
        the inline cache, write it to the shm store + directory."""
        oid = ref.id()
        if self.store.contains(oid):
            return
        payload = self._inline_cache.get(oid)
        if payload is not None:
            try:
                self.store.put_raw(oid, payload)
                self.gcs.call("ObjectDirectory", "add_location",
                              object_id=oid.binary(), node_id=self.node_id,
                              size=len(payload), owner=ref.owner_address,
                              timeout=30)
            except Exception:  # noqa: BLE001
                pass

    def _normalized_env(self, options: TaskOptions) -> Optional[dict]:
        """Normalize the task/actor runtime env (falls back to the job's;
        packaging uploads are cached per distinct raw spec)."""
        import json as _json

        raw = options.runtime_env or self.job_runtime_env
        if not raw:
            return None
        key = _json.dumps(raw, sort_keys=True, default=str)
        if key not in self._norm_env_cache:
            from ray_tpu_torch import runtime_env as renv

            self._norm_env_cache[key] = renv.normalize(raw, self.kv_put)
        return self._norm_env_cache[key]

    def _scheduling_fields(self, options: TaskOptions) -> dict:
        strategy = "hybrid"
        affinity = None
        soft = False
        placement = None
        st = options.scheduling_strategy
        if isinstance(st, SpreadSchedulingStrategy):
            strategy = "spread"
        elif isinstance(st, NodeAffinitySchedulingStrategy):
            strategy = "node_affinity"
            affinity = st.node_id
            soft = st.soft
        elif isinstance(st, PlacementGroupSchedulingStrategy):
            pg = st.placement_group
            placement = (pg.id.hex(), st.placement_group_bundle_index)
        return {"strategy": strategy, "affinity": affinity, "soft": soft,
                "placement": placement,
                "runtime_env": self._normalized_env(options)}

    def submit_task(self, func, args, kwargs, options: TaskOptions
                    ) -> List[ObjectRef]:
        fn_key = self._export_function(func)
        args_blob, deps = protocol.pack_args(args, kwargs, self._promote_ref)
        task_id = TaskID.generate()
        num_returns = options.num_returns
        return_ids = [ObjectID.for_task_return(task_id, i)
                      for i in range(1, num_returns + 1)]
        demand = options.resource_demand(default_cpus=1.0)
        sched = self._scheduling_fields(options)

        fut: Future = Future()
        with self._lock:
            for oid in return_ids:
                self._pending_objects[oid] = fut
                self._owned.add(oid)
        self._pin_task_deps(deps, fut)

        spec = protocol.make_task_spec(
            task_id=task_id.binary(), fn_key=fn_key, args_blob=args_blob,
            num_returns=num_returns, caller_address=self.address,
            job_id=self.job_id,
            options={"max_retries": options.max_retries,
                     "retry_exceptions": options.retry_exceptions,
                     "max_calls": options.max_calls,
                     "name": options.name
                     or getattr(func, "__qualname__", "task")},
        )
        if get_config().tracing_enabled:
            from ray_tpu_torch.util import tracing

            spec["trace_ctx"] = tracing.inject()
        self._stamp_submit(spec)
        if options.max_retries > 0 and get_config().lineage_pinning_enabled:
            with self._lock:
                entry = {"spec": spec, "demand": demand, "sched": sched,
                         "deps": deps, "attempts": 0, "fut": None,
                         "max_attempts": max(1, options.max_retries),
                         "live": len(return_ids),
                         "nbytes": len(args_blob)}
                for oid in return_ids:
                    self._lineage[oid] = entry
                    self._lineage_order.append(oid)
                for dep in deps:
                    d = ObjectID(dep)
                    self._lineage_pins[d] = self._lineage_pins.get(d, 0) + 1
                self._lineage_bytes += entry["nbytes"]
                cap = get_config().max_lineage_bytes
                while self._lineage_order and (
                        len(self._lineage_order) > 20000
                        or self._lineage_bytes > cap):
                    old = self._lineage_order.pop(0)
                    self._drop_lineage_locked(old, force=True)

        # Same batched cross-thread handoff as the actor path: one loop
        # wakeup per submission BURST (see submit_actor_task).
        self._submit_buffer.append(
            ("t", (spec, demand, sched, return_ids, fut, deps)))
        if not self._submit_scheduled:
            self._submit_scheduled = True
            self.loop_thread.loop.call_soon_threadsafe(self._drain_submits)
        return [ObjectRef(oid, self.address) for oid in return_ids]

    def submit_streaming_task(self, func, args, kwargs,
                              options: TaskOptions):
        """num_returns="streaming": run a generator task whose yields
        become refs consumable BEFORE the task finishes (ref:
        `ObjectRefGenerator`, _raylet.pyx:272). See
        core/streaming.py for the discovery design."""
        from ray_tpu_torch.core.streaming import ObjectRefGenerator, StreamState

        fn_key = self._export_function(func)
        args_blob, deps = protocol.pack_args(args, kwargs,
                                             self._promote_ref)
        task_id = TaskID.generate()
        demand = options.resource_demand(default_cpus=1.0)
        sched = self._scheduling_fields(options)
        spec = protocol.make_task_spec(
            task_id=task_id.binary(), fn_key=fn_key, args_blob=args_blob,
            num_returns=0, caller_address=self.address,
            job_id=self.job_id,
            options={"max_retries": options.max_retries,
                     "retry_exceptions": options.retry_exceptions,
                     "streaming": True,
                     "name": options.name
                     or getattr(func, "__qualname__", "task")},
        )
        if get_config().tracing_enabled:
            from ray_tpu_torch.util import tracing

            spec["trace_ctx"] = tracing.inject()
        self._stamp_submit(spec)
        state = StreamState()
        fut: Future = Future()   # pins args until the stream completes
        self._pin_task_deps(deps, fut)
        self._live_streams[task_id.binary()] = None
        self.loop_thread.loop.call_soon_threadsafe(
            lambda: asyncio.ensure_future(
                self._run_stream_to_completion(spec, demand, sched,
                                               state, fut)))
        return ObjectRefGenerator(self, task_id, state)

    async def _run_stream_to_completion(self, spec, demand, sched, state,
                                        fut) -> None:
        """Slow-path-only driver for streaming tasks (no lane batching:
        streams are long-running and item delivery is via the store +
        directory, not the reply). Retries restart the generator from
        scratch — item ObjectIDs are attempt-independent, so re-stored
        items are identical and already-consumed refs stay valid."""
        opts = spec["options"]
        max_retries = max(0, opts.get("max_retries", 3))
        attempt = 0
        try:
            while True:
                if spec["task_id"] in self._cancelled_tasks:
                    self._cancelled_tasks.pop(spec["task_id"], None)
                    state.finish(None, rexc.TaskCancelledError(
                        opts.get("name", "task")))
                    return
                spec["attempt"] = attempt
                try:
                    reply = await self._lease_and_push_async(spec, demand,
                                                             sched)
                except rexc.TaskError as e:
                    if opts.get("retry_exceptions") \
                            and attempt < max_retries:
                        attempt += 1
                        continue
                    state.finish(None, e)
                    return
                except asyncio.CancelledError:
                    state.finish(None, rexc.TaskCancelledError(
                        "owner shut down mid-stream"))
                    raise
                except rexc.TaskCancelledError as e:
                    state.finish(None, e)
                    return
                except BaseException as e:  # noqa: BLE001 system failure
                    if attempt < max_retries:
                        attempt += 1
                        # Same blip-survival backoff as the
                        # non-streaming retry loop.
                        await asyncio.sleep(min(0.1 * attempt, 1.0))
                        continue
                    state.finish(None, e if isinstance(e, rexc.RayTpuError)
                                 else rexc.TaskError(
                                     spec["options"].get("name", "task"),
                                     f"stream failed: {e!r}"))
                    return
                results = reply.get("results") or []
                for r in results:
                    if r.inline is not None:
                        self._cache_inline(ObjectID(r.oid), r.inline)
                state.finish(len(results), None)
                return
        finally:
            self._live_streams.pop(spec["task_id"], None)
            if not fut.done():
                fut.set_result(None)

    def _finish_stream_on_cancel(self, state):
        """Done-callback: a cancel sweep (loop shutdown) must release
        stream consumers instead of leaving them to time out."""
        def cb(f):
            if f.cancelled() and not state.done.is_set():
                state.finish(None, rexc.TaskCancelledError(
                    "owner shut down mid-stream"))
        return cb

    def _task_submit_on_loop(self, spec, demand, sched, return_ids, fut,
                             deps=()):
        """Fast path: enqueue straight onto the lane (one future + one
        callback per task, no asyncio.Task). Failures fall back to the
        retrying coroutine.

        Dependency gating (ref: the raylet's dependency manager,
        dependency_manager.h — a task is not dispatched until its args
        are available): a spec whose args reference THIS owner's still-
        pending task returns is held back until those tasks finish.
        Without this, a lease-reuse batch can put consumer before
        producer in ONE worker's sequential run — the consumer blocks
        fetching args its own batch hasn't produced yet (observed: the
        range-partition sort's merge tasks deadlocking behind their
        partition tasks for the full arg-fetch timeout)."""
        if deps:
            blockers = []
            with self._lock:
                for dep in deps:
                    dfut = self._pending_objects.get(ObjectID(dep))
                    if dfut is not None and dfut not in blockers:
                        blockers.append(dfut)
            if blockers:
                remaining = [len(blockers)]

                def on_dep_done(_f):
                    with self._lock:
                        remaining[0] -= 1
                        if remaining[0]:
                            return
                    self.loop_thread.loop.call_soon_threadsafe(
                        self._task_submit_on_loop, spec, demand, sched,
                        return_ids, fut, ())

                for dfut in blockers:
                    dfut.add_done_callback(on_dep_done)
                return
        if self._maybe_lane_submit(spec, demand, sched, return_ids, fut):
            return
        from ray_tpu_torch.runtime_env import env_hash

        key = (tuple(sorted(demand.items())), sched["strategy"],
               sched["affinity"], sched["soft"],
               tuple(sched["placement"]) if sched["placement"] else None,
               env_hash(sched.get("runtime_env")))
        lane = self._lanes.get(key)
        if lane is None:
            lane = self._lanes[key] = _TaskLane(self, demand, sched)
        rfut = self.loop_thread.loop.create_future()
        lane.queue.append((spec, rfut))
        lane.wakeup.set()
        lane._maybe_scale()
        rfut.add_done_callback(
            self._task_reply_cb(spec, demand, sched, return_ids, fut))

    def _task_reply_cb(self, spec, demand, sched, return_ids, fut):
        """Shared completion callback for both dispatch paths (pinned
        lane and lease-reuse lane): finish on success/app error, spill
        to the retrying slow path on any transport/lease failure."""

        def on_done(rf):
            retry = False
            try:
                reply = rf.result()
            except asyncio.CancelledError:
                # Loop shutdown (cancel sweep): don't resubmit — a retry
                # coroutine spawned mid-sweep outlives the drain and dies
                # as a destroyed-pending task at interpreter exit.
                if not fut.done():
                    fut.cancel()
                return
            except BaseException:  # noqa: BLE001 transport/lease failure
                retry = True
                reply = None
            if reply is not None:
                err = reply.get("error")
                if err is None:
                    self._finish_task(return_ids, fut,
                                      results=reply["results"])
                    return
                if isinstance(err, rexc.TaskCancelledError):
                    self._cancelled_tasks.pop(spec["task_id"], None)
                    self._finish_task(return_ids, fut, error=err)
                    return
                if (isinstance(err, rexc.TaskError)
                        and not spec["options"].get("retry_exceptions")):
                    self._finish_task(return_ids, fut, error=err)
                    return
                retry = True
            if retry:
                # Slow path owns the full retry budget.
                asyncio.ensure_future(self._run_task_to_completion_async(
                    spec, demand, sched, return_ids, fut))

        return on_done

    def _lane_stat(self, outcome: str) -> None:
        self.lane_stats[outcome] += 1
        self._m_lane.inc(tags={"outcome": outcome})

    def _maybe_lane_submit(self, spec, demand, sched, return_ids,
                           fut) -> bool:
        """Pinned-lane fast path. True => the call was admitted to a
        warm lane; False => caller proceeds down the lease-reuse path
        (signature still cold, lane ineligible, or backlog spill)."""
        cfg = get_config()
        opts = spec["options"]
        if (not cfg.task_lane_enabled or opts.get("max_calls")
                or opts.get("streaming") or sched["placement"]):
            return False
        from ray_tpu_torch.runtime_env import env_hash

        key = (spec["fn_key"], tuple(sorted(demand.items())),
               sched["strategy"], sched["affinity"], sched["soft"],
               env_hash(sched.get("runtime_env")))
        lane = self._pinned_lanes.get(key)
        if lane is None:
            n = self._lane_calls.get(key, 0) + 1
            self._lane_calls[key] = n
            if n < cfg.task_lane_min_calls:
                self._lane_stat("misses")
                return False
            while len(self._lane_calls) > 4096:  # bound cold signatures
                del self._lane_calls[next(iter(self._lane_calls))]
            lane = _PinnedLane(self, key, demand, sched, spec["fn_key"],
                               opts.get("name", "task"))
            self._pinned_lanes[key] = lane
            self._ensure_lane_reaper()
        rfut = self.loop_thread.loop.create_future()
        if not lane.try_submit(spec, rfut):
            self._lane_stat("spills")
            return False
        self._lane_stat("hits")
        rfut.add_done_callback(
            self._task_reply_cb(spec, demand, sched, return_ids, fut))
        return True

    def _ensure_lane_reaper(self) -> None:
        if self._lane_reaper is not None and not self._lane_reaper.done():
            return
        self._lane_reaper = asyncio.ensure_future(self._lane_reaper_loop())

    async def _lane_reaper_loop(self) -> None:
        """Release idle pinned lanes: a lane that stops being called
        gives its worker back after task_lane_idle_s, so the daemon's
        idle reaping / cold-start accounting works as without lanes."""
        try:
            while True:
                idle_s = max(0.05, get_config().task_lane_idle_s)
                await asyncio.sleep(min(0.5, idle_s / 2))
                now = time.monotonic()
                for lane in list(self._pinned_lanes.values()):
                    if lane.state == "ready" and lane.inflight == 0 \
                            and now - lane.last_used > idle_s:
                        lane.close("idle")
                if not self._pinned_lanes:
                    return
        except asyncio.CancelledError:
            raise

    async def _close_pinned_lanes(self) -> None:
        """Shutdown: unpin every warm lane while the daemons are still
        alive to take the lease back."""
        if self._lane_reaper is not None:
            self._lane_reaper.cancel()
            self._lane_reaper = None
        lanes = list(self._pinned_lanes.values())
        self._pinned_lanes.clear()
        closers = []
        for lane in lanes:
            if lane.state != "closed":
                lane.state = "closed"
                self._lane_stat("closed")
                closers.append(lane._close_async())
        if closers:
            await asyncio.gather(*closers, return_exceptions=True)

    # ------------------------------------------------------------------
    # exclusive lanes (compiled-DAG FunctionNode stages)
    # ------------------------------------------------------------------
    def open_exclusive_lane(self, fn, *, num_cpus: float = 1.0,
                            resources: Optional[Dict[str, float]] = None,
                            timeout: float = 120.0) -> "_PinnedLane":
        """Sync facade: lease + pin a dedicated worker for one
        compiled-DAG FunctionNode stage and open a lane on it. The lane
        is NOT in the shared registry — the DAG owns its lifecycle (and
        the idle reaper never touches it)."""
        fn_key = self._export_function(fn)
        demand = {"CPU": float(num_cpus)} if num_cpus else {}
        for k, v in (resources or {}).items():
            demand[k] = float(v)
        sched = self._scheduling_fields(TaskOptions())
        name = getattr(fn, "__qualname__", "dag_stage")

        async def open_lane():
            lane = _PinnedLane(self, None, demand, sched, fn_key, name,
                               exclusive=True)
            try:
                await lane._open_task
            finally:
                lane._open_task = None
            return lane

        return self.loop_thread.run(open_lane(), timeout=timeout)

    def lane_apply(self, lane: "_PinnedLane", blob: bytes,
                   name: str = "dag_stage") -> Future:
        """Kick off a long-running lane body (a stage loop); returns a
        concurrent future resolving to the worker's {"error": ...} reply
        when the loop exits — the compiled DAG's loop-ref analogue."""
        return asyncio.run_coroutine_threadsafe(
            lane.apply_async(blob, name), self.loop_thread.loop)

    def close_exclusive_lane(self, lane: "_PinnedLane",
                             timeout: float = 10.0) -> None:
        async def close():
            if lane.state != "closed":
                lane.state = "closed"
                self._lane_stat("closed")
                await lane._close_async()

        try:
            self.loop_thread.run(close(), timeout=timeout)
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass

    async def _run_task_to_completion_async(self, spec, demand, sched,
                                            return_ids, fut):
        """Lease a worker, push the task, store results; retries on system
        failure (ref: task retry in task_manager.h:208). Runs as a
        coroutine on the RPC loop — thousands of in-flight tasks cost
        coroutines, not threads."""
        opts = spec["options"]
        max_retries = max(0, opts.get("max_retries", 3))
        attempt = 0
        last_err: Optional[BaseException] = None
        while attempt <= max_retries:
            if spec["task_id"] in self._cancelled_tasks:
                self._cancelled_tasks.pop(spec["task_id"], None)
                self._finish_task(return_ids, fut,
                                  error=rexc.TaskCancelledError(
                                      opts.get("name", "task")))
                return
            spec["attempt"] = attempt
            try:
                reply = await self._lease_and_push_async(spec, demand, sched)
            except rexc.TaskError as e:
                # Application error: retry only with retry_exceptions.
                if opts.get("retry_exceptions") and attempt < max_retries:
                    attempt += 1
                    continue
                self._finish_task(return_ids, fut, error=e)
                return
            except asyncio.CancelledError:
                if not fut.done():
                    fut.cancel()
                raise
            except rexc.TaskCancelledError as e:
                self._cancelled_tasks.pop(spec["task_id"], None)
                self._finish_task(return_ids, fut, error=e)
                return
            except BaseException as e:  # noqa: BLE001 system failure
                last_err = e
                attempt += 1
                await asyncio.sleep(min(0.1 * attempt, 1.0))
                continue
            self._finish_task(return_ids, fut, results=reply["results"])
            return
        err = rexc.WorkerCrashedError(
            f"task failed after {max_retries + 1} attempts: {last_err}")
        self._record_driver_failure(spec, err)
        self._finish_task(return_ids, fut, error=err)

    async def _aclient(self, address: str) -> AsyncRpcClient:
        client = self._aclients.get(address)
        if client is None:
            client = AsyncRpcClient(address)
            self._aclients[address] = client
        return client

    async def _aget_gcs(self) -> AsyncRpcClient:
        if self._agcs is None:
            self._agcs = AsyncRpcClient(self.gcs_address)
        return self._agcs

    async def _warm_gcs(self) -> None:
        """Best-effort eager connect; real calls retry lazily anyway."""
        try:
            await (await self._aget_gcs())._ensure_conn()
        except Exception:  # noqa: BLE001 GCS not up yet: first call retries
            pass

    def _lease_and_push(self, spec, demand, sched) -> dict:
        """Sync facade (reconstruction path runs on plain threads)."""
        return self.loop_thread.run(
            self._lease_and_push_async(spec, demand, sched))

    async def _lease_and_push_async(self, spec, demand, sched) -> dict:
        from ray_tpu_torch.runtime_env import env_hash

        key = (tuple(sorted(demand.items())), sched["strategy"],
               sched["affinity"], sched["soft"],
               tuple(sched["placement"]) if sched["placement"] else None,
               env_hash(sched.get("runtime_env")))
        lane = self._lanes.get(key)
        if lane is None:
            lane = self._lanes[key] = _TaskLane(self, demand, sched)
        reply = await lane.submit(spec)
        if reply.get("error") is not None:
            raise reply["error"]
        return reply

    def _finish_task(self, return_ids, fut, results=None, error=None):
        if error is not None:
            payload = serialization.dumps(error, is_error=True)
            for oid in return_ids:
                self._cache_inline(oid, payload)
        else:
            for r in results:
                oid = ObjectID(r.oid)
                if r.inline is not None:
                    self._cache_inline(oid, r.inline)
        state = getattr(fut, "stream_state", None)
        if state is not None and not state.done.is_set():
            state.finish(len(results) if error is None
                         and results is not None else None, error)
        with self._lock:
            for oid in return_ids:
                self._pending_objects.pop(oid, None)
        if not fut.done():
            fut.set_result(None)

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    def create_actor(self, cls, args, kwargs, options: TaskOptions
                     ) -> ActorID:
        key, blob = protocol.function_key(cls)
        if key not in self._exported_fns:
            self.gcs.call("KV", "put", namespace="fn", key=key, value=blob,
                          overwrite=False, timeout=30)
            self._exported_fns.add(key)
        args_blob, _ = protocol.pack_args(args, kwargs, self._promote_ref)
        actor_id = ActorID.generate()
        # Actors hold 0 CPUs while alive unless explicitly requested (the
        # reference's default: creation needs a worker, lifetime is free —
        # ref: ray_option_utils actor defaults), so long-lived actors don't
        # starve the task pool.
        demand = options.resource_demand(default_cpus=0.0)
        sched = self._scheduling_fields(options)
        self.gcs.call(
            "ActorManager", "create_actor",
            record={
                "actor_id": actor_id.hex(),
                "cls_blob_key": key,
                "cls_name": getattr(cls, "__name__", "Actor"),
                "args_blob": args_blob,
                "demand": demand,
                "max_restarts": options.max_restarts,
                "name": options.name,
                "namespace": options.namespace or "default",
                "detached": options.lifetime == "detached",
                "owner_job": self.job_id,
                "max_concurrency": options.max_concurrency,
                "concurrency_groups": dict(options.concurrency_groups
                                           or {}),
                "placement": sched["placement"],
                "runtime_env": sched["runtime_env"],
            }, timeout=60)
        return actor_id

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args,
                          kwargs, options: TaskOptions):
        streaming = options.num_returns == "streaming"
        aid = actor_id.hex()
        args_blob, deps = protocol.pack_args(args, kwargs,
                                             self._promote_ref)
        task_id = TaskID.generate()
        num_returns = 0 if streaming else options.num_returns
        return_ids = [ObjectID.for_task_return(task_id, i)
                      for i in range(1, num_returns + 1)]
        fut = _LightFuture()
        addr = self.address
        # ONE lock round-trip registers everything the call owns: pending
        # entries, ownership, the returned refs' counts (the refs are
        # created _preregistered below — no per-ref _ref_added), and arg
        # pins. Return refs are self-owned, so _ref_added's borrow branch
        # can never apply; plain increments are equivalent.
        with self._lock:
            pending = self._pending_objects
            owned = self._owned
            refcounts = self._refcounts
            for oid in return_ids:
                pending[oid] = fut
                owned.add(oid)
                refcounts[oid] += 1
            if deps:
                dep_oids = [ObjectID(d) for d in deps]
                for oid in dep_oids:
                    refcounts[oid] += 1
        if deps:
            def unpin(_f, dep_oids=dep_oids):
                if self._shutdown:
                    return
                with self._lock:
                    for oid in dep_oids:
                        self._decref_locked(oid)

            fut.add_done_callback(unpin)
        # Per-(options, method) wire-options cache: the SAME dict object
        # rides every spec for this method, so a burst batch pickles it
        # once (pickle memoizes by identity). Nothing mutates
        # spec["options"] driver-side; executors see a private unpickled
        # copy.
        wire_opts = getattr(options, "_wire_opts", None)
        if wire_opts is None or wire_opts["name"] != method_name:
            wire_opts = {"max_retries": options.max_task_retries,
                         "streaming": streaming,
                         "name": method_name}
            options._wire_opts = wire_opts
        # seq is assigned on the loop at push time, per (actor,
        # incarnation-address) — each restarted incarnation starts at 0,
        # so no cross-incarnation base handshake is needed. Spec built as
        # a literal (one dict op) with the submit stamp folded in — see
        # _stamp_submit for why the stamp rides the spec.
        spec = {
            "task_id": task_id.binary(),
            "fn_key": b"",
            "args_blob": args_blob,
            "num_returns": num_returns,
            "caller_address": addr,
            "job_id": self.job_id,
            "options": wire_opts,
            "actor_id": aid,
            "method_name": method_name,
            "seq": -1,
            "attempt": 0,
            "submit_ts": time.time(),
            "submit_ctx": self._submit_identity,
        }
        if get_config().tracing_enabled:
            from ray_tpu_torch.util import tracing

            spec["trace_ctx"] = tracing.inject()
        gen = None
        if streaming:
            # Same discovery design as streaming tasks
            # (core/streaming.py); the stream state rides the waiter
            # future so every completion path — batch reply, push
            # failure, pending-drain error, cancel sweep — finishes it.
            from ray_tpu_torch.core.streaming import (
                ObjectRefGenerator,
                StreamState,
            )

            state = StreamState()
            fut.stream_state = state
            fut.add_done_callback(self._finish_stream_on_cancel(state))
            tid_bin = task_id.binary()
            self._live_streams[tid_bin] = None
            fut.add_done_callback(
                lambda _f: self._live_streams.pop(tid_bin, None))
            gen = ObjectRefGenerator(self, task_id, state)
        # Batched cross-thread handoff: one loop wakeup per BURST, not
        # per call. A per-call call_soon_threadsafe costs a syscall plus
        # a GIL fight with the busy loop thread (~700µs/submit under a
        # tight submission loop — the wakeup, not the work, dominates).
        self._submit_buffer.append(
            ("a", (aid, spec, return_ids, fut, options)))
        if not self._submit_scheduled:
            self._submit_scheduled = True
            self.loop_thread.loop.call_soon_threadsafe(self._drain_submits)
        if streaming:
            return gen
        return [ObjectRef(oid, addr, _preregistered=True)
                for oid in return_ids]

    def _drain_submits(self) -> None:
        # Clear the flag BEFORE draining: an append racing the drain then
        # schedules a (possibly empty) follow-up instead of being lost.
        self._submit_scheduled = False
        while True:
            try:
                kind, item = self._submit_buffer.popleft()
            except IndexError:
                return
            if kind == "a":
                self._actor_submit_on_loop(*item)
            else:
                self._task_submit_on_loop(*item)

    def _actor_submit_on_loop(self, aid, spec, return_ids, fut, options):
        """Fast path for resolved actors: enqueue onto the per-address
        push batch directly. Unresolved actors AND transport-failure
        retries go through the per-actor FIFO, so seqs are always
        assigned in submission/failure order by ONE drain coroutine
        (racing per-call resolvers would renumber arbitrarily).

        No per-call asyncio Future/done-callback: the whole submission
        context rides the push queue and the batch sender completes or
        retries entries directly — at 10k+ calls/s the per-call future +
        closure machinery was a measurable slice of the loop thread."""
        if spec["task_id"] in self._cancelled_tasks:
            # Cancelled before a seq was assigned: dropping here cannot
            # desync the actor's contiguous ordering.
            self._cancelled_tasks.pop(spec["task_id"], None)
            self._finish_task(return_ids, fut,
                              error=rexc.TaskCancelledError(
                                  spec["options"].get("name", "task")))
            return
        info = self._actor_cache.get(aid)
        if not (info and info["state"] == "ALIVE"):
            self._park_actor_submit(aid, (spec, return_ids, fut, options))
            return
        addr = info["worker_address"]
        self._assign_actor_seq(aid, addr, spec)
        self._enqueue_actor_push(addr, (aid, spec, return_ids, fut,
                                        options))

    def _handle_push_failure(self, aid, spec, return_ids, fut, options,
                             exc) -> None:
        self._actor_cache.pop(aid, None)
        retries = spec.get("_push_retries", 0) + 1
        spec["_push_retries"] = retries
        if retries > max(1, options.max_task_retries):
            self._finish_task(
                return_ids, fut,
                error=rexc.ActorUnavailableError(
                    f"actor call failed after {retries} pushes"))
            return
        self._park_actor_submit(aid, (spec, return_ids, fut, options))

    def _park_actor_submit(self, aid: str, item: tuple) -> None:
        pend = self._actor_pending.get(aid)
        if pend is None:
            pend = self._actor_pending[aid] = deque()
            asyncio.ensure_future(self._drain_actor_pending(aid))
        pend.append(item)

    def _enqueue_actor_push(self, addr: str, item: tuple) -> None:
        q = self._push_queues.get(addr)
        if q is None:
            q = self._push_queues[addr] = deque()
        q.append(item)
        if not self._push_flushing.get(addr):
            self._push_flushing[addr] = True
            asyncio.ensure_future(self._actor_push_flusher(addr))

    async def _drain_actor_pending(self, aid: str) -> None:
        try:
            await self._resolve_actor_async(
                aid, timeout=get_config().actor_creation_timeout_s)
        except asyncio.CancelledError:
            for _, _, fut, _ in self._actor_pending.pop(aid, ()):
                if not fut.done():
                    fut.cancel()
            raise
        except Exception as e:  # noqa: BLE001
            for spec, return_ids, fut, options in self._actor_pending.pop(
                    aid, ()):
                self._finish_task(return_ids, fut, error=e)
            return
        pend = self._actor_pending.pop(aid, deque())
        # Synchronous drain (no awaits): later fast-path submissions
        # cannot interleave ahead of the parked ones.
        while pend:
            spec, return_ids, fut, options = pend.popleft()
            self._actor_submit_on_loop(aid, spec, return_ids, fut, options)

    def _assign_actor_seq(self, aid: str, addr: str, spec: dict) -> None:
        """Per-(actor, incarnation-address) submission ordering: the first
        push a fresh incarnation sees is seq 0 (loop-thread-only, so
        assignment order == submission order). A retry to the SAME address
        keeps its seq (the runtime runs stale-but-valid seqs immediately);
        a retry to a NEW address is renumbered in the new incarnation."""
        if spec.get("_assigned_addr") == addr:
            return
        key = (aid, addr)
        seq = self._actor_seq[key]
        self._actor_seq[key] = seq + 1
        spec["seq"] = seq
        spec["_assigned_addr"] = addr
        spec["order_key"] = f"{self.address}|{addr}"

    async def _actor_push_flusher(self, addr: str) -> None:
        # Drains everything queued this tick into batch RPCs, each sent as
        # an INDEPENDENT task. A batch must never gate the send of later
        # pushes: the worker holds out-of-order seqs until the missing seq
        # arrives, so awaiting one batch before sending the next would
        # deadlock whenever a lower seq landed in a later batch (resolve
        # completion order is not seq order).
        q = self._push_queues[addr]
        try:
            try:
                client = await self._aclient(addr)
            except asyncio.CancelledError:
                # Loop shutdown, not a transport failure: cancel waiters
                # instead of re-parking (a re-park would spawn new drain
                # tasks during the cancel sweep).
                while q:
                    _, _, _, fut, _ = q.popleft()
                    if not fut.done():
                        fut.cancel()
                raise
            except Exception as e:  # noqa: BLE001
                while q:
                    aid, spec, return_ids, fut, options = q.popleft()
                    self._handle_push_failure(aid, spec, return_ids, fut,
                                              options, e)
                return
            burst = False
            while q:
                if burst and len(q) < 256:
                    # Coalescing window: under a submission burst the
                    # producer thread races this drain loop; without the
                    # pause every "batch" is 1-2 specs and the burst
                    # degenerates into thousands of tiny RPCs. A lone
                    # call never waits (burst only set after a >1 batch),
                    # so sync latency is unaffected.
                    await asyncio.sleep(0.0002)
                batch = []
                while q and len(batch) < 256:
                    batch.append(q.popleft())
                burst = len(batch) > 1
                asyncio.ensure_future(self._send_actor_batch(client, batch))
        finally:
            self._push_flushing[addr] = False

    async def _send_actor_batch(self, client: AsyncRpcClient,
                                batch: list) -> None:
        addr = client.address if hasattr(client, "address") else None
        if addr:
            for item in batch:
                self._task_locations[item[1]["task_id"]] = addr
        delta = self._delta_frame(batch)
        try:
            if delta is not None:
                replies = await client.call(
                    "Worker", "push_actor_tasks_delta",
                    template=delta[0], deltas=delta[1], timeout=None)
            else:
                replies = await client.call(
                    "Worker", "push_actor_tasks",
                    specs=[item[1] for item in batch], timeout=None)
        except asyncio.CancelledError:
            # Loop shutdown: cancel the batch, don't re-park it (same
            # respawn-during-cancel-sweep hazard as _TaskLane).
            for _, _, _, fut, _ in batch:
                if not fut.done():
                    fut.cancel()
            raise
        except Exception as e:  # noqa: BLE001
            for aid, spec, return_ids, fut, options in batch:
                self._handle_push_failure(aid, spec, return_ids, fut,
                                          options, e)
            return
        finally:
            for item in batch:
                self._task_locations.pop(item[1]["task_id"], None)
        self._finish_actor_batch(batch, replies)

    @staticmethod
    def _delta_frame(batch: list) -> Optional[tuple]:
        """Compress a same-destination burst into ONE template spec plus
        per-call (task_id, seq, submit_ts) deltas. A tight actor-call
        burst is N copies of the same spec differing only in those three
        fields; shipping the template once cuts the per-call pickle/
        unpickle and spec-dict churn on both ends of the push RPC.
        Returns None (send full specs) for singletons or heterogeneous
        batches — correctness never depends on the delta path."""
        if len(batch) < 2:
            return None
        t = batch[0][1]
        t_aid = t["actor_id"]
        t_method = t["method_name"]
        t_blob = t["args_blob"]
        t_opts = t["options"]
        t_nret = t["num_returns"]
        t_attempt = t["attempt"]
        if "trace_ctx" in t or "_push_retries" in t:
            return None
        deltas = [(t["task_id"], t["seq"], t["submit_ts"])]
        for _, s, _, _, _ in batch[1:]:
            if s["actor_id"] != t_aid \
                    or s["method_name"] != t_method \
                    or (s["args_blob"] is not t_blob
                        and s["args_blob"] != t_blob) \
                    or s["options"] is not t_opts \
                    or s["num_returns"] != t_nret \
                    or s["attempt"] != t_attempt \
                    or "trace_ctx" in s or "_push_retries" in s:
                return None
            deltas.append((s["task_id"], s["seq"], s["submit_ts"]))
        return t, deltas

    def _finish_actor_batch(self, batch: list, replies: list) -> None:
        """Complete a whole reply batch under ONE lock acquisition
        (inline-result caching + pending-object cleanup), then wake the
        waiters lock-free. The payload must be cached BEFORE the pending
        entry is popped, or a concurrent get() finds the object nowhere
        and spuriously attempts reconstruction."""
        with self._lock:
            pending = self._pending_objects
            for (aid, spec, return_ids, fut, options), reply in zip(
                    batch, replies):
                if type(reply) is int:
                    # Wire-compressed single-None reply (see
                    # worker_main.push_actor_tasks): reconstruct from our
                    # own return ids; every such result shares the ONE
                    # canonical payload object.
                    oid = return_ids[0]
                    if oid not in self._inline_cache:
                        self._inline_cache[oid] = _NONE_PAYLOAD
                    pending.pop(oid, None)
                    continue
                err = reply.get("error")
                if isinstance(err, rexc.TaskCancelledError):
                    self._cancelled_tasks.pop(spec["task_id"], None)
                if err is None:
                    for r in reply["results"]:
                        if r.inline is not None:
                            self._cache_inline_locked(ObjectID(r.oid),
                                                      r.inline)
                else:
                    payload = serialization.dumps(err, is_error=True)
                    for oid in return_ids:
                        self._cache_inline_locked(oid, payload)
                for oid in return_ids:
                    pending.pop(oid, None)
            self._evict_inline_locked()
        for (aid, spec, return_ids, fut, options), reply in zip(batch,
                                                                replies):
            state = getattr(fut, "stream_state", None)
            if state is not None and not state.done.is_set():
                err = reply.get("error")
                state.finish(None if err is not None
                             else len(reply.get("results") or ()), err)
            if not fut.done():
                fut.set_result(None)

    async def _resolve_actor_async(self, actor_id_hex: str,
                                   timeout: float = 60.0) -> dict:
        deadline = time.monotonic() + timeout
        gcs = await self._aget_gcs()
        known = ""
        while True:
            info = self._actor_cache.get(actor_id_hex)
            if info and info["state"] == "ALIVE":
                return info
            # Long-poll: the GCS replies on the next state TRANSITION
            # (or its own ~2s timeout), so a pending actor costs one
            # parked RPC instead of a 50ms polling loop per caller.
            info = await gcs.call("ActorManager", "wait_actor",
                                  actor_id=actor_id_hex,
                                  known_state=known, timeout=30)
            if info is None:
                raise rexc.ActorDiedError(actor_id_hex, "actor not found")
            self._actor_cache[actor_id_hex] = info
            if info["state"] == "ALIVE":
                return info
            if info["state"] == "DEAD":
                raise rexc.ActorDiedError(actor_id_hex,
                                          info.get("death_reason", ""))
            if time.monotonic() > deadline:
                raise rexc.GetTimeoutError(
                    f"actor {actor_id_hex[:8]} not ready in {timeout}s "
                    f"(state={info['state']})")
            known = info["state"]

    def get_actor(self, name: str, namespace: Optional[str]) -> ActorID:
        info = self.gcs.call("ActorManager", "get_actor", name=name,
                             namespace=namespace or "default", timeout=30)
        if info is None:
            raise ValueError(f"Failed to look up actor '{name}'")
        return ActorID.from_hex(info["actor_id"])

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self.gcs.call("ActorManager", "kill_actor", actor_id=actor_id.hex(),
                      no_restart=no_restart, timeout=30)
        self._actor_cache.pop(actor_id.hex(), None)

    def actor_state(self, actor_id: ActorID) -> str:
        info = self.gcs.call("ActorManager", "get_actor",
                             actor_id=actor_id.hex(), timeout=30)
        return "DEAD" if info is None else info["state"]

    # ------------------------------------------------------------------
    # placement groups
    # ------------------------------------------------------------------
    def create_placement_group(self, pg_id, bundles, strategy,
                               name=None, detached=False,
                               bundle_labels=None) -> None:
        self.gcs.call("PlacementGroups", "create_pg", pg_id=pg_id.hex(),
                      bundles=bundles, strategy=strategy, name=name,
                      owner_job=self.job_id, detached=detached,
                      bundle_labels=bundle_labels, timeout=60)

    def get_placement_group(self, pg_id) -> Optional[dict]:
        return self.gcs.call("PlacementGroups", "get_pg", pg_id=pg_id.hex(),
                             timeout=30)

    def wait_placement_group(self, pg_id, known_state: str = "",
                             park_s: float = 2.0) -> Optional[dict]:
        """Long-poll get_placement_group: returns when the gang's state
        differs from `known_state`, or after `park_s`."""
        return self.gcs.call("PlacementGroups", "wait_pg",
                             pg_id=pg_id.hex(), known_state=known_state,
                             park_s=park_s, timeout=park_s + 30)

    def remove_placement_group(self, pg_id) -> None:
        self.gcs.call("PlacementGroups", "remove_pg", pg_id=pg_id.hex(),
                      timeout=60)

    def list_placement_groups(self) -> List[dict]:
        return self.gcs.call("PlacementGroups", "list_pgs", timeout=30)

    def cancel(self, ref, force: bool = False,
               recursive: bool = True) -> None:
        """Cancel the task producing `ref` — an ObjectRef or an
        ObjectRefGenerator (ref: CoreWorker::CancelTask).

        Semantics: a task still QUEUED (lane queue, in-flight batch,
        or retry loop) is dropped and its getters raise
        TaskCancelledError; a task RUNNING pure-Python code is
        interrupted at its next bytecode boundary (KeyboardInterrupt
        injection — a task blocked inside a C call is interrupted when
        it returns); future RETRIES are suppressed either way.
        Cancelling a finished task is a no-op. ACTOR tasks are
        cancellable too: dropped before seq assignment, replied-as-
        cancelled from the ordered queue (seq contiguity preserved), or
        interrupted while running a sync method; async actor methods
        are only cancellable while queued (injecting into the shared
        event loop would break every other in-flight call). STREAMING
        tasks are cancellable through their `ObjectRefGenerator` or any
        stream item ref: the running generator is interrupted and the
        stream finishes with TaskCancelledError (ref: ray.cancel on
        ObjectRefGenerator)."""
        from ray_tpu_torch.core.streaming import ObjectRefGenerator

        if isinstance(ref, ObjectRefGenerator):
            tid = ref._task_id.binary()
            if tid not in self._live_streams:
                return   # stream already finished: no-op
        else:
            oid = ref.id()
            tid = oid.task_id().binary()
            with self._lock:
                if (oid not in self._pending_objects
                        and tid not in self._live_streams):
                    return   # already finished (or unknown): no-op
        self._tombstone(tid)

        def on_loop():
            # Wake lanes so queued entries are swept promptly...
            for lane in self._lanes.values():
                lane.wakeup.set()
            # ...and interrupt the task if a worker is RUNNING it
            # right now (KeyboardInterrupt at the next bytecode
            # boundary; best-effort).
            addr = self._task_locations.get(tid)
            if addr:
                async def fire():
                    try:
                        client = await self._aclient(addr)
                        await client.call("Worker", "cancel_task",
                                          task_id=tid, timeout=10)
                    except Exception:  # noqa: BLE001 best-effort
                        pass
                asyncio.ensure_future(fire())
        try:
            self.loop_thread.loop.call_soon_threadsafe(on_loop)
        except Exception:  # noqa: BLE001 loop shutting down
            pass

    def _tombstone(self, tid: bytes) -> None:
        # Bounded insertion-ordered, mirroring the worker-side
        # _cancelled_here cap: a tombstone whose task already finished
        # (or whose lane never re-pops it) ages out instead of leaking.
        self._cancelled_tasks[tid] = None
        while len(self._cancelled_tasks) > 4096:
            self._cancelled_tasks.pop(next(iter(self._cancelled_tasks)))

    # ------------------------------------------------------------------
    # cluster introspection
    # ------------------------------------------------------------------
    def cluster_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n in self.gcs.call("NodeInfo", "list_nodes", timeout=30):
            if n["alive"]:
                for k, v in n["total"].items():
                    out[k] += v
        return dict(out)

    def available_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n in self.gcs.call("NodeInfo", "list_nodes", timeout=30):
            if n["alive"]:
                for k, v in n["available"].items():
                    out[k] += v
        return dict(out)

    def nodes(self) -> List[dict]:
        return [
            {"NodeID": n["node_id"], "Alive": n["alive"],
             "Resources": n["total"], "Available": n["available"],
             "Address": n["address"]}
            for n in self.gcs.call("NodeInfo", "list_nodes", timeout=30)
        ]

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        uninstall_refcounter()
        self.flush_frees(timeout=5.0)
        # Ship whatever the event pipeline still holds (statuses, spans)
        # before the loop thread dies — the flusher's own tick may be
        # seconds out on an idle-backed-off process.
        try:
            self.task_events.stop()
            self.loop_thread.run(self.task_events.flush_final(), timeout=2)
        except Exception:  # noqa: BLE001
            pass
        if self._pinned_lanes or self._lane_reaper is not None:
            try:
                self.loop_thread.run(self._close_pinned_lanes(), timeout=8)
            except Exception:  # noqa: BLE001
                pass
        if self.is_driver:
            try:
                self.gcs.call("JobManager", "finish_job", job_id=self.job_id,
                              timeout=10)
            except Exception:  # noqa: BLE001
                pass
            self._stop_spawned_processes()
        try:
            self._chunk_fetcher.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            self.store.disconnect()
        except Exception:  # noqa: BLE001
            pass
        for client in self._owner_clients.values():
            try:
                client.close()
            except Exception:  # noqa: BLE001
                pass
        self._owner_clients.clear()
        if self._owner_server is not None:
            try:
                self.loop_thread.run(self._owner_server.stop(), timeout=3)
            except Exception:  # noqa: BLE001
                pass
        self.loop_thread.stop()

    def _stop_spawned_processes(self) -> None:
        # Reverse order: daemons (which kill their workers on SIGTERM) go
        # down before the GCS.
        procs = list(reversed(getattr(self, "_spawned_processes", [])))
        for p in procs:
            try:
                p.terminate()
            except Exception:  # noqa: BLE001
                pass
        for p in procs:
            try:
                p.wait(timeout=3)
            except Exception:  # noqa: BLE001
                try:
                    p.kill()
                except Exception:  # noqa: BLE001
                    pass
        tmp = getattr(self, "_cluster_tmpdir", None)
        if tmp:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
