"""Wire-format helpers shared by driver, daemon, and workers.

The port's copy of `ray_tpu/core/distributed/protocol.py`,
importing `ray_tpu_torch` only.

The task-spec/args framing analogue of the reference's TaskSpecification
protobuf (ref: src/ray/protobuf/common.proto TaskSpec) — here plain dicts
pickled by the RPC layer, with ObjectRef args replaced by resolvable markers
(inline small values ride in the spec itself, like the reference's inline
direct-call objects ≤ max_direct_call_object_size).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import cloudpickle

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef


# Which runtime a head serves. The JAX package's runtime speaks the same
# wire protocol, so a driver asks the GCS (`NodeInfo.runtime`) before it
# joins, and `JobManager.register_job` refuses a driver that does not name
# this runtime.
RUNTIME = "ray_tpu_torch"


class RefMarker:
    """Placeholder for a top-level ObjectRef argument. Carries the
    ref's owner address so the executing worker can fetch small values
    straight from the owner's inline cache (OwnerService) when the
    directory has no store copy."""

    __slots__ = ("oid_binary", "owner")

    def __init__(self, oid_binary: bytes, owner: Optional[str] = None):
        self.oid_binary = oid_binary
        self.owner = owner


def function_key(func_or_cls) -> bytes:
    """Content hash of the pickled function/class; the function-table key
    (ref: python/ray/_private/function_manager.py export-by-hash)."""
    blob = cloudpickle.dumps(func_or_cls, protocol=5)
    return hashlib.sha1(blob).digest(), blob


# Eager (not lazy): deterministic across processes, so the unpack fast
# path works in workers that never packed a no-arg call themselves.
_EMPTY_ARGS_BLOB: bytes = serialization.dumps(([], {}))
_EMPTY_DEPS: List[bytes] = []


def pack_args(args: List[Any], kwargs: Dict[str, Any],
              promote) -> Tuple[bytes, List[bytes]]:
    """Serialize (args, kwargs) replacing top-level ObjectRefs with markers.

    `promote(ref)` must guarantee the ref's value is readable from the shm
    store / directory by the executing worker. Returns (blob, dep_oids).

    No-arg calls (the dominant shape on actor hot paths) reuse one cached
    blob — zero serialization work per call.
    """
    if not args and not kwargs:
        return _EMPTY_ARGS_BLOB, _EMPTY_DEPS

    deps: List[bytes] = []

    def conv(v):
        if isinstance(v, ObjectRef):
            promote(v)
            deps.append(v.id().binary())
            return RefMarker(v.id().binary(), v.owner_address)
        return v

    packed = ([conv(a) for a in args],
              {k: conv(v) for k, v in kwargs.items()})
    return serialization.dumps(packed), deps


def unpack_args(blob: bytes, fetch) -> Tuple[List[Any], Dict[str, Any]]:
    """Deserialize an args blob, resolving RefMarkers via
    `fetch(oid, owner_address)`."""
    # No-arg fast path mirroring pack_args' cached blob: the dominant
    # actor/task hot-path shape skips deserialization entirely.
    if blob == _EMPTY_ARGS_BLOB:
        return [], {}
    args, kwargs = serialization.deserialize(blob)

    def conv(v):
        if isinstance(v, RefMarker):
            return fetch(ObjectID(v.oid_binary),
                         getattr(v, "owner", None))
        return v

    return [conv(a) for a in args], {k: conv(v) for k, v in kwargs.items()}


class TaskResult(NamedTuple):
    """One task return on the wire. NamedTuple, not dataclass: replies
    carry one per return value at tens of thousands per second, and a
    NamedTuple pickles as a bare args tuple (a dataclass drags a full
    __dict__ state round-trip)."""

    oid: bytes
    size: int
    inline: Optional[bytes] = None   # full framed payload if small
    is_error: bool = False


def make_task_spec(
    *,
    task_id: bytes,
    fn_key: bytes,
    args_blob: bytes,
    num_returns: int,
    caller_address: str,
    job_id: str,
    options: Dict[str, Any],
    actor_id: Optional[bytes] = None,
    method_name: str = "",
    seq: int = -1,
    attempt: int = 0,
) -> Dict[str, Any]:
    return {
        "task_id": task_id,
        "fn_key": fn_key,
        "args_blob": args_blob,
        "num_returns": num_returns,
        "caller_address": caller_address,
        "job_id": job_id,
        "options": options,
        "actor_id": actor_id,
        "method_name": method_name,
        "seq": seq,
        "attempt": attempt,
    }
