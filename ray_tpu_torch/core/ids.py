"""Binary IDs for tasks, objects, actors, nodes, jobs, placement groups;
a copy of `ray_tpu/core/ids.py`.

Design follows the reference ID scheme (ref: src/ray/common/id.h,
python/ray/includes/unique_ids.pxi): fixed-width random binary ids, with
ObjectIDs derived deterministically from the creating TaskID + return index
so that lineage reconstruction can recompute them.
"""
from __future__ import annotations

import hashlib
import itertools
import os
import struct
from typing import ClassVar

# ID generation is on the task-submission hot path; an os.urandom
# syscall per ID costs ~10x a counter. Uniqueness: an 8-byte per-process
# random prefix (re-drawn after fork) + a monotonically increasing
# counter, padded/truncated to the ID size.
_id_prefix: bytes = b""
_id_prefix_pid: int = -1
_id_counter = itertools.count()


def _fast_random_bytes(size: int) -> bytes:
    if size < 12:
        return os.urandom(size)  # too small for prefix+counter
    global _id_prefix, _id_prefix_pid
    pid = os.getpid()
    if pid != _id_prefix_pid:
        _id_prefix = os.urandom(16)
        _id_prefix_pid = pid
    return (_id_prefix[:size - 8]
            + struct.pack("<Q", next(_id_counter)))


class BaseID:
    SIZE: ClassVar[int] = 16
    __slots__ = ("_binary", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} must be {self.SIZE} bytes, got {len(binary)}"
            )
        self._binary = binary
        # hash(bytes) directly — no per-id (typename, binary) tuple.
        # Different ID types sharing a hash only costs a bucket probe;
        # __eq__ is type-exact, so correctness is unchanged.
        self._hash = hash(binary)

    @classmethod
    def generate(cls) -> "BaseID":
        return cls(_fast_random_bytes(cls.SIZE))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\xff" * cls.SIZE)

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    def is_nil(self) -> bool:
        return self._binary == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._binary == self._binary

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._binary.hex()})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class JobID(BaseID):
    SIZE = 4


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 16


class PlacementGroupID(BaseID):
    SIZE = 16


class TaskID(BaseID):
    SIZE = 16

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        h = hashlib.sha1(b"actor_creation:" + actor_id.binary()).digest()
        return cls(h[: cls.SIZE])


class ObjectID(BaseID):
    SIZE = 20  # 16-byte task id + 4-byte return index

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def from_random(cls) -> "ObjectID":
        return cls(os.urandom(cls.SIZE))

    def task_id(self) -> TaskID:
        return TaskID(self._binary[:16])

    def return_index(self) -> int:
        return int.from_bytes(self._binary[16:], "little")
