"""Mutable shared-memory ring channels for compiled DAGs.

The port's copy of `ray_tpu/experimental/channel.py`, importing `ray_tpu_torch`
only.

Analogue of the reference's experimental channels
(ref: python/ray/experimental/channel.py:50 `Channel`, backed by the C++
mutable-object manager, src/ray/core_worker/experimental_mutable_object_
manager.h:34): a shared-memory ring that one writer fills version-by-
version and N readers consume in order — the per-call task-submission
path (lease + RPC + object store) is bypassed entirely, which is the
whole point of compiled DAGs. The ring depth (`num_slots`) is the
per-edge pipelining budget: up to `num_slots` executions can be in
flight across a stage boundary before the writer blocks (the reference
gets the same effect from its buffered mutable objects).

Implementation: one mmap'd file in /dev/shm per channel:

    header:  magic u32 | closed u32 | slot_cap u64 | n_readers u64
             | n_slots u64 | w_seq u64
    acks:    n_readers x u64     (last version each reader consumed)
    slots:   n_slots x [ state u64 | len u64 | payload slot_cap ]

Version v (1-based) lives in slot (v-1) % n_slots. Slot state is a
seqlock: 2v-1 while the writer fills it, 2v once published.

  write(v): wait until v - min(acks) <= n_slots (ring has a free slot —
            built-in backpressure), fill the slot, publish.
  read():   wait for state == 2v of the next version's slot, copy out,
            re-check the state (a concurrent overwrite restarts), ack v.

Synchronization is polling with exponential backoff (bounds from
`RAY_TPU_CHANNEL_BACKOFF_US_MIN/MAX`, default 1µs..200µs): at
compiled-DAG rates the next version is almost always already there, so
the fast path is two mmap reads — no syscalls, no locks. Once the
backoff saturates the waiter also sched_yield()s so a busy peer pinned
to the same core can make progress.

Cross-host edges: readers always consume a LOCAL ring; a producer on a
different host writes through `RemoteChannelWriter`, which pushes the
serialized payload as a raw frame to the reader node's daemon
(`NodeDaemon.channel_push`) where it lands in the ring via the same
publish path. Ring backpressure propagates across the hop because the
push reply waits for the ring write. `FanoutWriter` fans one producer
out to consumer groups on several nodes (serialize once, publish per
node).
"""
from __future__ import annotations

import os
import mmap
import pickle
import struct
import time
import uuid
from typing import Any, List, Optional

from ray_tpu_torch.core.config import get_config

try:
    import cloudpickle  # type: ignore
except ImportError:  # pragma: no cover
    from ray_tpu_torch.core import serialization as _ser

    cloudpickle = _ser.cloudpickle

MAGIC = 0x52544348  # "RTCH"
_HDR = struct.Struct("<IIQQQQ")  # magic, closed, slot_cap, n_readers,
                                 # n_slots, w_seq
_U64 = struct.Struct("<Q")
_ACKS_OFF = _HDR.size
_WSEQ_OFF = 32      # header: magic(4) closed(4) cap@8 n_readers@16
                    #         n_slots@24 w_seq@32

DEFAULT_CAPACITY = 4 << 20
DEFAULT_SLOTS = 8
# Where `Channel.create` puts a ring unless told otherwise.
DEFAULT_DIRECTORY = "/dev/shm"


class ChannelClosedError(Exception):
    """The channel was torn down (compiled DAG teardown or actor death)."""


class ChannelTimeoutError(Exception):
    pass


class Channel:
    """One single-writer, n-reader shm ring.

    Create once (driver side) with `Channel.create(...)`; endpoints
    receive the pickled handle and lazily mmap the same file. Each reader
    must use a distinct `reader_idx` in [0, n_readers).
    """

    def __init__(self, path: str, capacity: int, n_readers: int,
                 n_slots: int = DEFAULT_SLOTS):
        self.path = path
        self.capacity = capacity        # payload bytes per slot
        self.n_readers = n_readers
        self.n_slots = n_slots
        self._mm: Optional[mmap.mmap] = None
        self._last_read: Optional[int] = None  # last consumed version
        self._w_seq: Optional[int] = None

    # -- layout ---------------------------------------------------------
    def _slots_off(self) -> int:
        return _ACKS_OFF + 8 * self.n_readers

    def _slot_off(self, idx: int) -> int:
        return self._slots_off() + idx * (16 + self.capacity)

    def _file_size(self) -> int:
        return self._slots_off() + self.n_slots * (16 + self.capacity)

    # -- lifecycle ------------------------------------------------------
    @classmethod
    def create(cls, n_readers: int, capacity: int = DEFAULT_CAPACITY,
               n_slots: int = DEFAULT_SLOTS,
               directory: str = DEFAULT_DIRECTORY) -> "Channel":
        path = os.path.join(directory, f"rtpu_chan_{uuid.uuid4().hex}")
        ch = cls(path, capacity, n_readers, n_slots)
        with open(path, "wb") as f:
            f.write(_HDR.pack(MAGIC, 0, capacity, n_readers, n_slots, 0))
            f.truncate(ch._file_size())
            f.flush()
        return ch

    def _map(self) -> mmap.mmap:
        if self._mm is None:
            fd = os.open(self.path, os.O_RDWR)
            try:
                self._mm = mmap.mmap(fd, self._file_size())
            finally:
                os.close(fd)
            magic, _, cap, nr, ns, _ = _HDR.unpack_from(self._mm, 0)
            if magic != MAGIC or cap != self.capacity \
                    or ns != self.n_slots:
                raise ValueError(f"not a channel file: {self.path}")
        return self._mm

    def close(self) -> None:
        """Mark closed: every blocked/future read or write raises."""
        try:
            mm = self._map()
            struct.pack_into("<I", mm, 4, 1)
        except (OSError, ValueError):
            pass

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass
        if self._mm is not None:
            try:
                self._mm.close()
            except Exception:  # noqa: BLE001
                pass
            self._mm = None

    def _closed(self, mm) -> bool:
        return struct.unpack_from("<I", mm, 4)[0] != 0

    # -- protocol -------------------------------------------------------
    def _wait(self, cond, mm, timeout: Optional[float], what: str):
        cfg = get_config()
        backoff = max(cfg.channel_backoff_us_min, 0.01) * 1e-6
        cap = max(cfg.channel_backoff_us_max * 1e-6, backoff)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            v = cond()
            if v is not None:
                return v
            if self._closed(mm):
                raise ChannelClosedError(self.path)
            if deadline is not None and time.monotonic() >= deadline:
                raise ChannelTimeoutError(f"{what} timed out on {self.path}")
            if backoff >= cap:
                # Saturated: stop trusting the timer alone — explicitly
                # cede the core so a same-core peer can publish/ack.
                os.sched_yield()
            time.sleep(backoff)
            backoff = min(backoff * 2, cap)

    def _min_ack(self, mm) -> int:
        return min(_U64.unpack_from(mm, _ACKS_OFF + 8 * i)[0]
                   for i in range(self.n_readers))

    def version(self) -> int:
        """Last published version (0 before the first write)."""
        return _U64.unpack_from(self._map(), _WSEQ_OFF)[0]

    def write(self, value: Any, timeout: Optional[float] = 30.0) -> None:
        self.write_bytes(cloudpickle.dumps(value), timeout)

    def write_bytes(self, data, timeout: Optional[float] = 30.0) -> int:
        """Publish one already-serialized payload; returns the version it
        landed as. Split from `write` so the daemon's channel_push can
        land raw-frame payloads without a deserialize/re-serialize hop."""
        mm = self._map()
        if len(data) > self.capacity:
            raise ValueError(
                f"serialized value ({len(data)}B) exceeds channel slot "
                f"capacity ({self.capacity}B); recreate the DAG with a "
                f"larger buffer_size_bytes")
        if self._w_seq is None:  # attach: recover the write counter
            self._w_seq = _U64.unpack_from(mm, _WSEQ_OFF)[0]
        v = self._w_seq + 1

        def slot_free():
            # Ring has room once every reader is within n_slots of v.
            if v - self._min_ack(mm) <= self.n_slots:
                return True
            return None

        self._wait(slot_free, mm, timeout, "write (readers lagging)")
        off = self._slot_off((v - 1) % self.n_slots)
        _U64.pack_into(mm, off, 2 * v - 1)           # writing
        mm[off + 16:off + 16 + len(data)] = data
        _U64.pack_into(mm, off + 8, len(data))
        _U64.pack_into(mm, off, 2 * v)               # published
        _U64.pack_into(mm, _WSEQ_OFF, v)
        self._w_seq = v
        return v

    def _recover_last_read(self, mm, reader_idx: int) -> int:
        """First touch in this process: resume from the reader's ack word
        in shared memory (mirror of the writer's _w_seq recovery) — a
        restarted/re-unpickled reader that starts at 0 would wait forever
        for a version whose slot was overwritten long ago."""
        if self._last_read is None:
            self._last_read = _U64.unpack_from(
                mm, _ACKS_OFF + 8 * reader_idx)[0]
        return self._last_read

    def peek_ready(self, reader_idx: int = 0) -> bool:
        """Is the next version already published? (non-consuming)."""
        mm = self._map()
        v = self._recover_last_read(mm, reader_idx) + 1
        off = self._slot_off((v - 1) % self.n_slots)
        return _U64.unpack_from(mm, off)[0] == 2 * v

    def read(self, timeout: Optional[float] = None,
             reader_idx: int = 0) -> Any:
        mm = self._map()
        v = self._recover_last_read(mm, reader_idx) + 1
        off = self._slot_off((v - 1) % self.n_slots)

        def published():
            return True if _U64.unpack_from(mm, off)[0] == 2 * v else None

        while True:
            self._wait(published, mm, timeout, "read")
            n = _U64.unpack_from(mm, off + 8)[0]
            data = bytes(mm[off + 16:off + 16 + n])
            if _U64.unpack_from(mm, off)[0] == 2 * v:
                break  # seqlock validation: no concurrent overwrite
        self._last_read = v
        _U64.pack_into(mm, _ACKS_OFF + 8 * reader_idx, v)
        return pickle.loads(data)

    def __reduce__(self):
        return (Channel,
                (self.path, self.capacity, self.n_readers, self.n_slots))


class RemoteChannelWriter:
    """Writer endpoint for a ring that lives on ANOTHER node.

    The ring file is mmap'd only on the reader's node; this side pushes
    each serialized payload as a raw frame (wire codec 2) to that node's
    daemon, which lands it in the ring through the same `write_bytes`
    publish path. Backpressure crosses the hop because the push reply is
    not sent until the ring write completes (or times out).

    Writes are versioned and the daemon dedupes (`version <= w_seq` is
    an ack for an already-landed write), so a reply lost to a transport
    error can be retried without double-publishing.
    """

    def __init__(self, daemon_address: str, path: str, capacity: int,
                 n_readers: int, n_slots: int = DEFAULT_SLOTS):
        self.daemon_address = daemon_address
        self.path = path
        self.capacity = capacity
        self.n_readers = n_readers
        self.n_slots = n_slots
        self._client = None
        self._w_seq: Optional[int] = None

    def _rpc(self):
        if self._client is None:
            from ray_tpu_torch.core.distributed.rpc import SyncRpcClient

            self._client = SyncRpcClient(self.daemon_address)
        return self._client

    def write(self, value: Any, timeout: Optional[float] = 30.0) -> None:
        self.write_bytes(cloudpickle.dumps(value), timeout)

    def write_bytes(self, data, timeout: Optional[float] = 30.0) -> int:
        from ray_tpu_torch.core.distributed import wire

        if len(data) > self.capacity:
            raise ValueError(
                f"serialized value ({len(data)}B) exceeds channel slot "
                f"capacity ({self.capacity}B); recreate the DAG with a "
                f"larger buffer_size_bytes")
        deadline = None if timeout is None else time.monotonic() + timeout
        if self._w_seq is None:  # attach: recover from the ring's w_seq
            rep = self._rpc().call(
                "NodeDaemon", "channel_version", path=self.path,
                timeout=30.0, idempotent=True)
            if rep.get("closed"):
                raise ChannelClosedError(self.path)
            self._w_seq = int(rep.get("version", 0))
        v = self._w_seq + 1
        attempts = 0
        while True:
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise ChannelTimeoutError(
                    f"remote write timed out on {self.path}")
            try:
                rep = self._rpc().call(
                    "NodeDaemon", "channel_push", path=self.path,
                    capacity=self.capacity, n_readers=self.n_readers,
                    n_slots=self.n_slots, version=v,
                    push_timeout=remaining, data=wire.Raw(data),
                    timeout=None if remaining is None else remaining + 10)
            except (ChannelClosedError, ChannelTimeoutError):
                raise
            except Exception as e:  # noqa: BLE001 — transport failure
                attempts += 1
                # Versioned dedupe makes the retry safe; but a dead
                # daemon means dead readers, so don't spin forever.
                if attempts >= 3 and deadline is None:
                    raise ChannelClosedError(
                        f"push to {self.daemon_address} failed: {e}")
                time.sleep(min(0.05 * attempts, 0.5))
                continue
            if rep.get("closed"):
                raise ChannelClosedError(self.path)
            if rep.get("timeout"):
                raise ChannelTimeoutError(
                    f"remote write (readers lagging) timed out on "
                    f"{self.path}")
            if rep.get("error"):
                raise RuntimeError(
                    f"channel_push {self.path}: {rep['error']}")
            self._w_seq = v
            return v

    def close(self) -> None:
        try:
            self._rpc().call("NodeDaemon", "channel_close",
                             path=self.path, timeout=10.0)
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass

    def unlink(self) -> None:
        try:
            self._rpc().call("NodeDaemon", "channel_unlink",
                             path=self.path, timeout=10.0)
        except Exception:  # noqa: BLE001
            pass
        if self._client is not None:
            try:
                self._client.close()
            except Exception:  # noqa: BLE001
                pass
            self._client = None

    def __reduce__(self):
        return (RemoteChannelWriter,
                (self.daemon_address, self.path, self.capacity,
                 self.n_readers, self.n_slots))


class FanoutWriter:
    """One producer, consumer groups on several nodes: serialize once,
    publish into each group's ring (local `Channel` or
    `RemoteChannelWriter`). Aggregate backpressure is the slowest
    group's — version v+n_slots can't publish anywhere until every
    group acked v."""

    def __init__(self, endpoints: List[Any]):
        self.endpoints = list(endpoints)
        self._iter = 0                      # completed fan-out writes
        self._done = [0] * len(self.endpoints)

    def write(self, value: Any, timeout: Optional[float] = 30.0) -> None:
        self.write_bytes(cloudpickle.dumps(value), timeout)

    def write_bytes(self, data, timeout: Optional[float] = 30.0) -> None:
        # A timeout on a slow group leaves the fan-out PARTIAL; callers
        # retry the same payload, so remember which endpoints already
        # landed this iteration and skip them (a local ring has no
        # version dedupe — re-writing it would double-publish).
        target = self._iter + 1
        for i, ep in enumerate(self.endpoints):
            if self._done[i] >= target:
                continue
            ep.write_bytes(data, timeout)
            self._done[i] = target
        self._iter = target

    def close(self) -> None:
        for ep in self.endpoints:
            ep.close()

    def unlink(self) -> None:
        for ep in self.endpoints:
            ep.unlink()

    def __reduce__(self):
        return (FanoutWriter, (self.endpoints,))
