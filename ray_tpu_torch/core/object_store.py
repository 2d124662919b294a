"""Python client for the native shared-memory object store.

Pairs with ray_tpu_torch/csrc/object_store.cc, a copy of the JAX package's
store built into `_build/` by `store_build.py` (the plasma equivalent — ref:
src/ray/object_manager/plasma/client.h). Values are serialized with the
protocol-5 out-of-band format and written straight into the mmap'd object
file; reads deserialize zero-copy from the mapping (numpy arrays alias shm).
"""
from __future__ import annotations

import ctypes
import mmap
import os
import threading
import weakref
from typing import Any, List, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ObjectID

RTS_OK = 0
RTS_ERR_IO = -1
RTS_ERR_EXISTS = -2
RTS_ERR_NOT_FOUND = -3
RTS_ERR_FULL = -4
RTS_ERR_STATE = -5


class ObjectStoreFullError(Exception):
    pass


class ObjectExistsError(Exception):
    pass


def _load_lib() -> ctypes.CDLL:
    from ray_tpu_torch.core.store_build import library_path

    lib = ctypes.CDLL(library_path())
    lib.rts_connect.restype = ctypes.c_void_p
    lib.rts_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                ctypes.c_uint64]
    lib.rts_disconnect.argtypes = [ctypes.c_void_p]
    lib.rts_capacity.restype = ctypes.c_uint64
    lib.rts_capacity.argtypes = [ctypes.c_void_p]
    lib.rts_used.restype = ctypes.c_uint64
    lib.rts_used.argtypes = [ctypes.c_void_p]
    lib.rts_num_objects.restype = ctypes.c_uint64
    lib.rts_num_objects.argtypes = [ctypes.c_void_p]
    lib.rts_evict.restype = ctypes.c_uint64
    lib.rts_evict.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rts_create.restype = ctypes.c_int
    lib.rts_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint64,
                               ctypes.POINTER(ctypes.c_int)]
    lib.rts_seal.restype = ctypes.c_int
    lib.rts_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rts_abort.restype = ctypes.c_int
    lib.rts_abort.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rts_get.restype = ctypes.c_int
    lib.rts_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_uint64),
                            ctypes.POINTER(ctypes.c_int)]
    lib.rts_release.restype = ctypes.c_int
    lib.rts_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rts_contains.restype = ctypes.c_int
    lib.rts_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rts_delete.restype = ctypes.c_int
    lib.rts_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.rts_list.restype = ctypes.c_uint64
    lib.rts_list.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_uint64]
    lib.rts_stat.restype = ctypes.c_int
    lib.rts_stat.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.POINTER(ctypes.c_uint32),
                             ctypes.POINTER(ctypes.c_uint64),
                             ctypes.POINTER(ctypes.c_uint32)]
    lib.rts_recycle_bytes.restype = ctypes.c_uint64
    lib.rts_recycle_bytes.argtypes = [ctypes.c_void_p]
    return lib


_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load_lib()
    return _lib


def _direct_write_min() -> int:
    """Size floor for the large-put direct-write fast path (0 = off)."""
    from ray_tpu_torch.core.config import get_config

    return get_config().put_direct_min_bytes


def _write_all(fd: int, parts: List[memoryview]) -> None:
    """Sequential write() of iovec parts into a store file at offset 0.
    The kernel copies straight into (possibly recycled, already-warm)
    tmpfs page cache — the mmap path's per-page fault + zero-fill never
    happens, which is the entire win of the large-put fast path."""
    for part in parts:
        mv = part if part.contiguous else memoryview(bytes(part))
        while len(mv):
            n = os.write(fd, mv)
            mv = mv[n:]


class _StoreState:
    """Shared between an ObjectStore and its outstanding SharedBuffers so the
    native handle is only freed after the last buffer releases (a finalizer
    running after disconnect() must not touch freed memory)."""

    def __init__(self, handle):
        self.handle = handle
        self.live_buffers = 0
        self.closed = False
        self.lock = threading.Lock()

    def buffer_acquired(self):
        with self.lock:
            self.live_buffers += 1

    def buffer_released(self, oid_binary: bytes):
        with self.lock:
            # The handle stays valid until the last buffer releases (close()
            # defers rts_disconnect), so the shared refcount must always be
            # decremented — skipping it would pin the slot forever.
            if self.handle:
                get_lib().rts_release(self.handle, oid_binary)
            self.live_buffers -= 1
            if self.closed and self.live_buffers == 0 and self.handle:
                get_lib().rts_disconnect(self.handle)
                self.handle = None

    def close(self):
        with self.lock:
            self.closed = True
            if self.live_buffers == 0 and self.handle:
                get_lib().rts_disconnect(self.handle)
                self.handle = None


class SharedBuffer:
    """A read-only view over a sealed object's mmap; releases the store ref
    when garbage collected (or released explicitly)."""

    def __init__(self, state: _StoreState, oid: ObjectID, mm: mmap.mmap,
                 size: int):
        self._mm = mm
        self.size = size
        self.view = memoryview(mm)[:size]
        state.buffer_acquired()
        self._finalizer = weakref.finalize(
            self, SharedBuffer._release_static, state, oid.binary(), mm,
            self.view)

    def release(self) -> None:
        self._finalizer()

    @staticmethod
    def _release_static(state: _StoreState, oid_binary: bytes,
                        mm: mmap.mmap, view: memoryview) -> None:
        try:
            view.release()
            mm.close()
        except BufferError:
            pass  # numpy views still alive; mmap closes when they drop
        try:
            state.buffer_released(oid_binary)
        except Exception:
            pass


class FileBuffer:
    """Read-only view over a spilled object file (API-compatible subset of
    SharedBuffer). The OS page cache makes repeat reads cheap."""

    def __init__(self, mm: mmap.mmap, size: int):
        self._mm = mm
        self.size = size
        self.view = memoryview(mm)[:size]

    def release(self) -> None:
        try:
            self.view.release()
            self._mm.close()
        except BufferError:
            pass  # numpy views still alive; mmap closes when they drop


class PartialBuffer:
    """A created-but-unsealed object being filled at offsets: the
    create-then-fill seam of the transfer plane. `write_at` lands chunk
    bytes straight in the store's mmap (or the spill file when shm is
    full) — receivers never accumulate an object on the Python heap.
    `seal()` publishes atomically; `abort()` (also the GC finalizer)
    rolls back so a dropped transfer cannot leak a creating slot.
    """

    def __init__(self, state: _StoreState, oid: ObjectID, size: int,
                 mm: Optional[mmap.mmap], spill_tmp: Optional[str] = None,
                 spill_path: Optional[str] = None):
        self._state = state
        self._oid = oid
        self.size = size
        self._mm = mm
        self.view = memoryview(mm) if mm is not None else memoryview(b"")
        self._spill_tmp = spill_tmp
        self._spill_path = spill_path
        self._done = False
        # Safety net only: the owner is expected to seal or abort
        # explicitly. kCreating slots do self-expire (kStaleCreatingSecs)
        # but that pins `size` bytes of shm for 5 minutes.
        self._finalizer = weakref.finalize(
            self, PartialBuffer._abort_static, state, oid.binary(), mm,
            self.view, spill_tmp)

    def write_at(self, offset: int, data) -> None:
        if self._done:
            raise RuntimeError("write into sealed/aborted PartialBuffer")
        n = len(data)
        if offset < 0 or offset + n > self.size:
            raise ValueError(
                f"chunk [{offset}, {offset + n}) outside object of "
                f"{self.size} bytes")
        self.view[offset:offset + n] = data

    def _close_mapping(self) -> None:
        try:
            self.view.release()
            if self._mm is not None:
                self._mm.close()
        except BufferError:
            pass  # outstanding views; mmap closes when they drop

    def seal(self) -> None:
        if self._done:
            return
        self._done = True
        self._finalizer.detach()
        self._close_mapping()
        if self._spill_tmp is not None:
            os.rename(self._spill_tmp, self._spill_path)
            return
        rc = get_lib().rts_seal(self._state.handle, self._oid.binary())
        if rc != RTS_OK:
            raise RuntimeError(f"rts_seal failed: {rc}")

    def abort(self) -> None:
        if self._done:
            return
        self._done = True
        self._finalizer.detach()
        PartialBuffer._abort_static(self._state, self._oid.binary(),
                                    self._mm, self.view, self._spill_tmp)

    @staticmethod
    def _abort_static(state: _StoreState, oid_binary: bytes,
                      mm: Optional[mmap.mmap], view: memoryview,
                      spill_tmp: Optional[str]) -> None:
        try:
            view.release()
            if mm is not None:
                mm.close()
        except BufferError:
            pass
        if spill_tmp is not None:
            try:
                os.unlink(spill_tmp)
            except OSError:
                pass
            return
        try:
            if state.handle:
                get_lib().rts_abort(state.handle, oid_binary)
        except Exception:  # noqa: BLE001
            pass


class ArenaBuffer:
    """A long-lived writable reservation carved out of the shm store —
    the backing pool of the paged KV-cache block allocator
    (serve/kv_cache.py).

    Rides the same create-then-fill seam as PartialBuffer but closes it
    immediately: the slot is sealed right after creation (the writable
    mmap stays valid across the seal's rename — same inode) and then
    pinned with a reader ref.  Sealing dodges the store's stale-kCreating
    reclaim (kStaleCreatingSecs sweeps unsealed slots under pressure);
    the pin keeps the sealed arena off the LRU eviction list.  release()
    unpins and deletes, returning the store to quiescence — the leak
    guard tests assert used/num_objects return to baseline.

    When shm is full even after eviction the arena falls back to an
    anonymous private mapping (`in_store=False`): the pool still works,
    it just isn't accounted in the store.
    """

    def __init__(self, state: Optional[_StoreState], oid: Optional[ObjectID],
                 mm: mmap.mmap, size: int, in_store: bool):
        self._state = state
        self._oid = oid
        self._mm = mm
        self.size = size
        self.in_store = in_store
        self.view = memoryview(mm)
        if in_store:
            state.buffer_acquired()
        self._finalizer = weakref.finalize(
            self, ArenaBuffer._release_static, state,
            oid.binary() if oid is not None else None, mm, self.view,
            in_store)

    def release(self) -> None:
        self._finalizer()

    @staticmethod
    def _release_static(state: Optional[_StoreState],
                        oid_binary: Optional[bytes], mm: mmap.mmap,
                        view: memoryview, in_store: bool) -> None:
        try:
            view.release()
            mm.close()
        except BufferError:
            pass  # outstanding views; mmap closes when they drop
        if not in_store:
            return
        try:
            # buffer_released drops the rts_get pin; with no other
            # readers the delete frees the slot immediately.
            state.buffer_released(oid_binary)
            if state.handle:
                get_lib().rts_delete(state.handle, oid_binary, 1)
        except Exception:  # noqa: BLE001
            pass


class ObjectStore:
    """One connection to the node-local shm store.

    When the shm arena is full even after LRU eviction (everything pinned),
    puts overflow to per-object files under `<directory>/spill/` — the
    plasma fallback-allocation/spill equivalent (ref: src/ray/raylet/
    local_object_manager.h:41 spill/restore, plasma fallback allocator).
    Reads fall back to the spill directory transparently; since every
    process on a node shares `directory`, spilled objects stay visible to
    the daemon's transfer path and to co-located workers.
    """

    def __init__(self, directory: str, capacity: int = 0,
                 num_slots: int = 65536):
        if capacity <= 0:
            import psutil

            capacity = int(psutil.virtual_memory().total * 0.3)
        self.directory = directory
        self.capacity = capacity
        self.spill_dir = os.path.join(directory, "spill")
        handle = get_lib().rts_connect(directory.encode(), capacity, num_slots)
        if not handle:
            raise RuntimeError(f"Failed to connect to object store at "
                               f"{directory}")
        self._state = _StoreState(handle)

    # -- spill plumbing -------------------------------------------------
    def _spill_path(self, oid: ObjectID) -> str:
        return os.path.join(self.spill_dir, oid.hex())

    def _spill_write(self, oid: ObjectID, write_fn, size: int) -> int:
        """Atomically create a spill file via tmp+rename (rename is the seal:
        readers never observe a partial object)."""
        os.makedirs(self.spill_dir, exist_ok=True)
        path = self._spill_path(oid)
        if os.path.exists(path):
            raise ObjectExistsError(oid.hex())
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w+b") as f:
                if size:
                    f.truncate(size)
                    with mmap.mmap(f.fileno(), size) as mm:
                        view = memoryview(mm)
                        write_fn(view)
                        view.release()
            os.rename(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return size

    def _spill_read(self, oid: ObjectID) -> Optional[FileBuffer]:
        path = self._spill_path(oid)
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            return None
        with f:
            size = os.fstat(f.fileno()).st_size
            if size == 0:
                return FileBuffer(mmap.mmap(-1, 1), 0)
            mm = mmap.mmap(f.fileno(), size, prot=mmap.PROT_READ)
        return FileBuffer(mm, size)

    @property
    def _handle(self):
        return self._state.handle

    # -- write path -----------------------------------------------------
    def put_serialized(self, oid: ObjectID, meta: bytes,
                       buffers: List[memoryview]) -> int:
        """Write a pre-serialized object; returns its size in bytes."""
        size = serialization.serialized_size(meta, buffers)
        lib = get_lib()
        fd = ctypes.c_int(-1)
        rc = lib.rts_create(self._handle, oid.binary(), size,
                            ctypes.byref(fd))
        if rc == RTS_ERR_EXISTS:
            raise ObjectExistsError(oid.hex())
        if rc == RTS_ERR_FULL:
            # rts_create already ran LRU eviction internally; everything
            # left in shm is pinned — overflow this object to disk.
            return self._spill_write(
                oid, lambda view: serialization.write_to(view, meta, buffers),
                size)
        if rc != RTS_OK:
            raise RuntimeError(f"rts_create failed: {rc}")
        try:
            if size >= _direct_write_min() > 0:
                # Large-put fast path: hand the kernel the serialized
                # layout as an iovec.  write() copies into the tmpfs page
                # cache directly — no per-page fault + zero-fill like the
                # mmap path (~3x on this host class), and still one copy.
                _write_all(fd.value, serialization.iov_parts(meta, buffers))
            else:
                with mmap.mmap(fd.value, size) as mm:
                    view = memoryview(mm)
                    serialization.write_to(view, meta, buffers)
                    view.release()
        except BaseException:
            os.close(fd.value)
            lib.rts_abort(self._handle, oid.binary())
            raise
        else:
            os.close(fd.value)
        rc = lib.rts_seal(self._handle, oid.binary())
        if rc != RTS_OK:
            raise RuntimeError(f"rts_seal failed: {rc}")
        return size

    def put(self, oid: ObjectID, value: Any, *, is_error: bool = False) -> int:
        meta, buffers = serialization.serialize(value, is_error=is_error)
        return self.put_serialized(oid, meta, buffers)

    def put_raw(self, oid: ObjectID, data: bytes) -> int:
        """Write pre-framed bytes (e.g. received from a remote node)."""
        lib = get_lib()
        fd = ctypes.c_int(-1)
        size = len(data)
        rc = lib.rts_create(self._handle, oid.binary(), size,
                            ctypes.byref(fd))
        if rc == RTS_ERR_EXISTS:
            raise ObjectExistsError(oid.hex())
        if rc == RTS_ERR_FULL:
            def copy(view):
                view[:size] = data

            return self._spill_write(oid, copy, size)
        if rc != RTS_OK:
            raise RuntimeError(f"rts_create failed: {rc}")
        try:
            if size >= _direct_write_min() > 0:
                _write_all(fd.value, [memoryview(data)])
            elif size:
                with mmap.mmap(fd.value, size) as mm:
                    mm[:size] = data
        except BaseException:
            os.close(fd.value)
            lib.rts_abort(self._handle, oid.binary())
            raise
        else:
            os.close(fd.value)
        rc = lib.rts_seal(self._handle, oid.binary())
        if rc != RTS_OK:
            raise RuntimeError(f"rts_seal failed: {rc}")
        return size

    def create_for_receive(self, oid: ObjectID, size: int) -> PartialBuffer:
        """Create an unsealed object and hand back a writable fill-at-
        offset view (the receive side of chunked transfers). Chunks land
        directly in the shm mmap in any order; the caller seals once all
        bytes arrived. Falls back to a spill tmp file when shm is full
        even after eviction (rename-on-seal keeps the atomicity)."""
        lib = get_lib()
        fd = ctypes.c_int(-1)
        rc = lib.rts_create(self._handle, oid.binary(), size,
                            ctypes.byref(fd))
        if rc == RTS_ERR_EXISTS:
            raise ObjectExistsError(oid.hex())
        if rc == RTS_ERR_FULL:
            os.makedirs(self.spill_dir, exist_ok=True)
            path = self._spill_path(oid)
            if os.path.exists(path):
                raise ObjectExistsError(oid.hex())
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w+b") as f:
                mm = None
                if size:
                    f.truncate(size)
                    mm = mmap.mmap(f.fileno(), size)
            return PartialBuffer(self._state, oid, size, mm,
                                 spill_tmp=tmp, spill_path=path)
        if rc != RTS_OK:
            raise RuntimeError(f"rts_create failed: {rc}")
        try:
            mm = mmap.mmap(fd.value, size) if size else None
        except BaseException:
            os.close(fd.value)
            lib.rts_abort(self._handle, oid.binary())
            raise
        os.close(fd.value)
        return PartialBuffer(self._state, oid, size, mm)

    def create_arena(self, oid: ObjectID, size: int) -> ArenaBuffer:
        """Reserve a long-lived writable arena in shm (the paged
        KV-cache block pool).  create -> mmap -> seal -> pin: see
        ArenaBuffer for why the seam is closed immediately.  Falls back
        to an anonymous mapping when shm is exhausted."""
        if size <= 0:
            raise ValueError("arena size must be positive")
        lib = get_lib()
        fd = ctypes.c_int(-1)
        rc = lib.rts_create(self._handle, oid.binary(), size,
                            ctypes.byref(fd))
        if rc == RTS_ERR_EXISTS:
            raise ObjectExistsError(oid.hex())
        if rc == RTS_ERR_FULL:
            return ArenaBuffer(None, None, mmap.mmap(-1, size), size,
                               in_store=False)
        if rc != RTS_OK:
            raise RuntimeError(f"rts_create failed: {rc}")
        try:
            mm = mmap.mmap(fd.value, size)
        except BaseException:
            os.close(fd.value)
            lib.rts_abort(self._handle, oid.binary())
            raise
        os.close(fd.value)
        rc = lib.rts_seal(self._handle, oid.binary())
        if rc != RTS_OK:
            mm.close()
            lib.rts_abort(self._handle, oid.binary())
            raise RuntimeError(f"rts_seal failed: {rc}")
        # Reader pin: a sealed refcount-0 object is LRU-evictable; the
        # arena must survive store pressure for the engine's lifetime.
        sz = ctypes.c_uint64(0)
        pin_fd = ctypes.c_int(-1)
        rc = lib.rts_get(self._handle, oid.binary(), ctypes.byref(sz),
                         ctypes.byref(pin_fd))
        if rc != RTS_OK:
            mm.close()
            raise RuntimeError(f"rts_get failed pinning arena: {rc}")
        os.close(pin_fd.value)
        return ArenaBuffer(self._state, oid, mm, size, in_store=True)

    # -- read path ------------------------------------------------------
    def get_buffer(self, oid: ObjectID) -> Optional[SharedBuffer]:
        lib = get_lib()
        size = ctypes.c_uint64(0)
        fd = ctypes.c_int(-1)
        rc = lib.rts_get(self._handle, oid.binary(), ctypes.byref(size),
                         ctypes.byref(fd))
        if rc == RTS_ERR_NOT_FOUND:
            return self._spill_read(oid)
        if rc != RTS_OK:
            raise RuntimeError(f"rts_get failed: {rc}")
        try:
            mm = mmap.mmap(fd.value, size.value, prot=mmap.PROT_READ)
        finally:
            os.close(fd.value)
        return SharedBuffer(self._state, oid, mm, size.value)

    def get(self, oid: ObjectID) -> Tuple[Any, Optional[SharedBuffer]]:
        """Deserialize; the returned SharedBuffer must stay alive as long as
        zero-copy views into it (numpy arrays) are in use."""
        buf = self.get_buffer(oid)
        if buf is None:
            raise KeyError(oid.hex())
        value = serialization.deserialize(buf.view)
        return value, buf

    # -- management -----------------------------------------------------
    def stat(self, oid: ObjectID) -> Optional[dict]:
        """Slot introspection without touching refcount/LRU: dict with
        state ('creating'/'sealed'), size, refcount — or None when the
        store has no live slot (spilled objects report via the file)."""
        state = ctypes.c_uint32(0)
        size = ctypes.c_uint64(0)
        refcount = ctypes.c_uint32(0)
        rc = get_lib().rts_stat(self._handle, oid.binary(),
                                ctypes.byref(state), ctypes.byref(size),
                                ctypes.byref(refcount))
        if rc != RTS_OK:
            try:
                sz = os.stat(self._spill_path(oid)).st_size
            except OSError:
                return None
            return {"state": "sealed", "size": sz, "refcount": 0,
                    "spilled": True}
        return {"state": {1: "creating", 2: "sealed"}.get(
                    state.value, str(state.value)),
                "size": size.value, "refcount": refcount.value,
                "spilled": False}

    def contains(self, oid: ObjectID) -> bool:
        if get_lib().rts_contains(self._handle, oid.binary()):
            return True
        return os.path.exists(self._spill_path(oid))

    def delete(self, oid: ObjectID, force: bool = False) -> bool:
        ok = get_lib().rts_delete(self._handle, oid.binary(),
                                  1 if force else 0) == RTS_OK
        try:
            os.unlink(self._spill_path(oid))
            ok = True
        except OSError:
            pass
        return ok

    @property
    def spilled_bytes(self) -> int:
        try:
            with os.scandir(self.spill_dir) as it:
                return sum(e.stat().st_size for e in it
                           if e.is_file() and ".tmp." not in e.name)
        except FileNotFoundError:
            return 0

    def evict(self, nbytes: int) -> int:
        return get_lib().rts_evict(self._handle, nbytes)

    def list_objects(self, max_objects: int = 100000) -> List[ObjectID]:
        buf = ctypes.create_string_buffer(20 * max_objects)
        n = get_lib().rts_list(self._handle, buf, max_objects)
        return [ObjectID(bytes(buf[i * 20:(i + 1) * 20])) for i in range(n)]

    @property
    def used(self) -> int:
        return get_lib().rts_used(self._handle)

    @property
    def num_objects(self) -> int:
        return get_lib().rts_num_objects(self._handle)

    @property
    def recycle_bytes(self) -> int:
        """Bytes parked in the warm-file recycle pool (deleted large
        objects whose tmpfs files — and faulted-in pages — are kept for
        the next large create).  Not part of ``used``: no live object
        backs them, but they do count toward the store's tmpfs footprint
        and eviction drains them first."""
        return get_lib().rts_recycle_bytes(self._handle)

    def disconnect(self) -> None:
        self._state.close()

    @staticmethod
    def destroy(directory: str) -> None:
        """Remove every object file + index for a store directory."""
        import shutil

        shutil.rmtree(directory, ignore_errors=True)
