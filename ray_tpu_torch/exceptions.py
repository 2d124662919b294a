"""Exception types raised by the runtime, counterpart of
`ray_tpu/exceptions.py`.

Mirrors the error taxonomy of the reference runtime
(ref: python/ray/exceptions.py). The same 24 classes, fields and pickled
forms as the JAX package, so a handler written for one catches the other's
errors by the same names.
"""
from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """Wraps an exception raised inside a remote task or actor method.

    The original traceback is captured as text in the executing worker and
    re-raised at the `get()` call site (ref: python/ray/exceptions.py
    RayTaskError semantics).
    """

    def __init__(
        self,
        function_name: str = "<unknown>",
        traceback_str: str = "",
        cause: Optional[BaseException] = None,
        pid: int = 0,
        node_id: str = "",
    ):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        self.pid = pid
        self.node_id = node_id
        super().__init__(traceback_str or str(cause))

    @classmethod
    def from_exception(cls, exc: BaseException, function_name: str, pid: int = 0,
                       node_id: str = "") -> "TaskError":
        tb = "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__)
        )
        return cls(function_name=function_name, traceback_str=tb, cause=exc,
                   pid=pid, node_id=node_id)

    def __str__(self):
        return (
            f"Task '{self.function_name}' failed (pid={self.pid}, "
            f"node={self.node_id[:8]}):\n{self.traceback_str}"
        )

    def __reduce__(self):
        # Exception's default __reduce__ replays self.args into
        # __init__, which for this signature stuffs the formatted
        # message into function_name and DROPS every other field on
        # unpickle. The cause is deliberately omitted from the wire:
        # user exception types may not import on the other side (its
        # text already rides in traceback_str).
        return (type(self), (self.function_name, self.traceback_str,
                             None, self.pid, self.node_id))


class ActorError(TaskError):
    """An actor method invocation failed."""


class ActorDiedError(RayTpuError):
    """The actor backing a handle has died and will not be restarted."""

    def __init__(self, actor_id: str = "", reason: str = ""):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"Actor {actor_id[:8]} died: {reason}")

    def __reduce__(self):  # see TaskError.__reduce__
        return (type(self), (self.actor_id, self.reason))


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ReplicaDrainingError(RayTpuError):
    """The serve replica is draining (downscale/redeploy) and no longer
    admits new requests.  Retry through the handle: routing excludes the
    draining replica after the next refresh.  Subclasses RayTpuError so
    the worker executor forwards it TYPED across the actor wire (see
    worker_main's RayTpuError passthrough) — callers catch it by type."""

    def __init__(self, replica_id: str = ""):
        self.replica_id = replica_id
        super().__init__(f"replica {replica_id!r} is draining; "
                         f"re-route this request")

    def __reduce__(self):  # see TaskError.__reduce__
        return (type(self), (self.replica_id,))


class KVMigrationError(RayTpuError):
    """A live KV migration (serve/disagg.py) could not be applied on the
    target replica — missing/stale ticket, frame-shape mismatch, or an
    exhausted block pool.  Callers treat it as "fall back to recompute":
    the resumed stream replays the context as an extended prompt instead
    of adopting shipped blocks.  Wire-typed (lossless __reduce__) so the
    fallback decision survives the actor boundary."""

    def __init__(self, request_id: str = "", reason: str = ""):
        self.request_id = request_id
        self.reason = reason
        super().__init__(f"KV migration failed for request "
                         f"{request_id!r}: {reason or 'unknown'}")

    def __reduce__(self):  # see TaskError.__reduce__
        return (type(self), (self.request_id, self.reason))


class TaskCancelledError(RayTpuError):
    """The task was cancelled before or during execution."""


class ObjectLostError(RayTpuError):
    """An object was evicted/lost and could not be reconstructed."""

    def __init__(self, object_id: str = "", message: str = ""):
        self.object_id = object_id
        super().__init__(message or f"Object {object_id[:8]} was lost.")

    def __reduce__(self):  # see TaskError.__reduce__
        return (type(self), (self.object_id, str(self)))


class ObjectReconstructionFailedError(ObjectLostError):
    """Lineage reconstruction of a lost object failed."""


class OwnerDiedError(ObjectLostError):
    """The owner (submitting worker) of an object died; value unrecoverable."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get(..., timeout=)` expired before the object was ready."""


class NodeDiedError(RayTpuError):
    """A node (daemon) died while hosting tasks/objects."""


class WorkerCrashedError(RayTpuError):
    """The worker process executing a task died unexpectedly."""


class RuntimeEnvSetupError(RayTpuError):
    """Creating the runtime environment for a task/actor failed."""


class OutOfMemoryError(RayTpuError):
    """Worker killed by the memory monitor."""


class PlacementGroupUnavailableError(RayTpuError):
    """Placement group cannot be scheduled with current cluster resources."""


class PendingCallsLimitExceededError(RayTpuError):
    """Backpressure: actor's pending call queue is full."""


class CrossLanguageError(RayTpuError):
    """Error crossing a language boundary."""


class ChannelError(RayTpuError):
    """Compiled-graph channel read/write failure."""


class ChannelTimeoutError(ChannelError, TimeoutError):
    """Compiled-graph channel read/write timed out."""


class DataPlaneError(RayTpuError):
    """A streaming Dataset pipeline (data/streaming) failed in a way the
    operator graph cannot retry internally — an operator task raised on
    every attempt, a shuffle bundle was lost with its producer, or the
    split coordinator died mid-epoch.  Carries the operator name so the
    consumer-side traceback points at the stage, not the iterator.
    Wire-typed (lossless __reduce__): it crosses the coordinator ->
    consumer and worker -> driver wires."""

    def __init__(self, message: str = "", operator: str = ""):
        self.operator = operator
        super().__init__(message or f"data plane failure in operator "
                         f"{operator!r}")

    def __reduce__(self):  # see TaskError.__reduce__
        return (type(self),
                (self.args[0] if self.args else "", self.operator))


class BackpressureTimeout(DataPlaneError, TimeoutError):
    """A byte-stalled operator made no forward progress for
    ``data_stream_stall_timeout_s`` — every downstream consumer stopped
    pulling (deadlocked sink, wedged trainer) while the operator sat at
    its in-flight byte cap.  Raising beats stalling forever: the stall
    seconds already accrued are in Dataset.stats().  Subclasses
    TimeoutError so generic timeout handlers also catch it."""

    def __init__(self, message: str = "", operator: str = "",
                 waited_s: float = 0.0, inflight_bytes: int = 0):
        self.waited_s = waited_s
        self.inflight_bytes = inflight_bytes
        super().__init__(
            message or (
                f"operator {operator!r} backpressured for "
                f"{waited_s:.1f}s with {inflight_bytes} bytes in flight "
                f"and no downstream progress"
            ),
            operator,
        )

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",
                             self.operator, self.waited_s,
                             self.inflight_bytes))


class StreamQueueFullError(RayTpuError):
    """A serve streaming consumer fell ``serve_stream_queue_max`` tokens
    behind and its stream was dropped (backpressure instead of unbounded
    replica RSS growth).  Crosses the replica -> proxy wire, so it lives
    in the typed tree and round-trips pickle with its bound intact."""

    def __init__(self, message: str = "", queue_max: int = 0):
        super().__init__(message)
        self.queue_max = queue_max

    def __reduce__(self):
        return (type(self),
                (self.args[0] if self.args else "", self.queue_max))
