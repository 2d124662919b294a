"""ObjectRef: a first-class future/handle to a value in the object store;
a copy of `ray_tpu/core/object_ref.py`.

Analogue of the reference ObjectRef (ref: python/ray/_raylet.pyx ObjectRef;
ownership model in src/ray/core_worker/reference_count.h:61). Each ref knows
its owner (the worker that created it); the owner is the authority for the
object's lifetime and lineage.
"""
from __future__ import annotations

from typing import Optional

from ray_tpu_torch.core.ids import ObjectID


class ObjectRef:
    __slots__ = ("_id", "_owner", "_skip_refcount", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: Optional[str] = None,
                 *, _skip_refcount: bool = False,
                 _preregistered: bool = False):
        self._id = object_id
        self._owner = owner  # owner address "host:port" or None for local
        self._skip_refcount = _skip_refcount
        # _preregistered: the creator already counted this ref (e.g. the
        # actor-submit fast path registers all return refs under one
        # lock) — skip the add, keep the __del__ decref.
        if not (_skip_refcount or _preregistered):
            _refcounter_add(self)

    def id(self) -> ObjectID:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id.binary()

    @property
    def owner_address(self) -> Optional[str]:
        return self._owner

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self) -> int:
        return hash(self._id)

    def __repr__(self) -> str:
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        # Serializing a ref hands it to another process: the engine's
        # serialize hook PINS the object at its owner (a transit pin) so
        # it cannot be freed before the receiver registers its borrow
        # (ref: reference_count.h borrower bookkeeping — without the
        # pin, an owner that drops its last local ref right after
        # replying frees the object out from under the borrower).
        _refcounter_serialize(self)
        return (_deserialize_ref, (self._id.binary(), self._owner))

    def __del__(self):
        if not self._skip_refcount:
            _refcounter_remove(self)

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        from ray_tpu_torch.api import _global_worker

        return _global_worker().as_future(self)

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()


def _deserialize_ref(binary: bytes, owner: Optional[str]) -> ObjectRef:
    return ObjectRef(ObjectID(binary), owner)


# Reference counting hooks — installed by the active engine. Default: no-op.
_refcounter_add = lambda ref: None
_refcounter_remove = lambda ref: None
_refcounter_serialize = lambda ref: None


def install_refcounter(add, remove, serialize=None) -> None:
    global _refcounter_add, _refcounter_remove, _refcounter_serialize
    _refcounter_add = add
    _refcounter_remove = remove
    _refcounter_serialize = serialize or (lambda ref: None)


def uninstall_refcounter() -> None:
    global _refcounter_add, _refcounter_remove, _refcounter_serialize
    _refcounter_add = lambda ref: None
    _refcounter_remove = lambda ref: None
    _refcounter_serialize = lambda ref: None
