"""Bulk object transfer engine: striped windowed pulls + broadcast trees.

The port's copy of `ray_tpu/core/distributed/transfer.py`,
importing `ray_tpu_torch` only.

The data-plane counterpart of the control-plane RPC layer (rpc.py raw
frames). Role parity with the reference's object manager transfer
machinery (ref: src/ray/object_manager/object_manager.h:117 chunked
pull/push, pull_manager.h:52 in-flight budget, push_manager.h:30
bounded pushes) plus the 1→N pre-staging shape its collective-ish
`ray.experimental` broadcast utilities cover:

* `ChunkSink` — a create-then-fill receive surface over the store's
  PartialBuffer: chunks land at offsets directly in the shm mmap (any
  order, write-once ranges), an interval set tracks coverage, and the
  object seals itself the moment the last byte arrives. Waiters
  (`wait_range`) let a daemon RE-SERVE ranges of an in-flight object —
  the mechanism broadcast relays pipeline on.
* `striped_pull` — one object fetched chunk-wise from ALL known
  replicas at once under a bytes-based in-flight window. A source that
  errors is demoted immediately: its outstanding chunks requeue onto
  the surviving sources, so a node dying mid-transfer costs only its
  in-flight window, never a restart.
* `plan_broadcast_tree` — split a target list into ≤fanout subtrees
  for the log-N relay tree (node_daemon.broadcast_object), keeping the
  owner's uplink at fanout×size instead of N×size.

Everything here is asyncio-side: call it from the process's RPC loop.
"""
from __future__ import annotations

import asyncio
import bisect
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.object_store import ObjectExistsError


def chunk_ranges(total_size: int, chunk_bytes: int
                 ) -> List[Tuple[int, int]]:
    """(offset, length) grid covering [0, total_size)."""
    if total_size <= 0:
        return []
    chunk_bytes = max(1, chunk_bytes)
    return [(off, min(chunk_bytes, total_size - off))
            for off in range(0, total_size, chunk_bytes)]


class IntervalSet:
    """Disjoint sorted [start, end) intervals with merge-on-add.

    Small by construction — transfers add chunk-grid ranges, so the set
    holds at most (in-flight window / chunk size) fragments before they
    coalesce.
    """

    def __init__(self):
        self._starts: List[int] = []
        self._ends: List[int] = []
        self.covered = 0

    def add(self, start: int, end: int) -> None:
        if end <= start:
            return
        i = bisect.bisect_left(self._ends, start)
        j = bisect.bisect_right(self._starts, end)
        if i < j:  # overlaps/touches intervals [i, j)
            start = min(start, self._starts[i])
            end = max(end, self._ends[j - 1])
            removed = sum(self._ends[k] - self._starts[k]
                          for k in range(i, j))
            del self._starts[i:j]
            del self._ends[i:j]
            self.covered -= removed
        self._starts.insert(i, start)
        self._ends.insert(i, end)
        self.covered += end - start

    def has(self, start: int, end: int) -> bool:
        if end <= start:
            return True
        i = bisect.bisect_right(self._starts, start) - 1
        return i >= 0 and self._ends[i] >= end


class ChunkSink:
    """Offset-addressed receive surface for one in-flight object.

    Wraps a store PartialBuffer; auto-seals when coverage completes.
    `wait_range`/`read` let concurrent consumers (broadcast children
    pulling from this daemon) stream ranges out while later ranges are
    still arriving.
    """

    def __init__(self, partial, total_size: int,
                 on_complete: Optional[Callable[[], None]] = None):
        self._pb = partial
        self.size = total_size
        self._have = IntervalSet()
        self._event = asyncio.Event()
        self.sealed = False
        self.aborted = False
        self.last_touch = time.monotonic()
        self._on_complete = on_complete
        if total_size == 0:
            self._seal()

    def _seal(self) -> None:
        self._pb.seal()
        self.sealed = True
        if self._on_complete is not None:
            self._on_complete()

    def write(self, offset: int, data) -> bool:
        """Land one chunk; returns True when this write completed (and
        sealed) the object. Ranges are write-once by protocol; a
        duplicate (retried chunk) is harmlessly overwritten with
        identical bytes."""
        if self.sealed or self.aborted:
            return self.sealed
        self._pb.write_at(offset, data)
        return self.commit(offset, len(data))

    def view_for(self, offset: int, length: int) -> memoryview:
        """Writable destination slice for a write-through receive
        (socket recv_into straight into the store mmap — the single-
        copy path). Pair with commit() once the bytes landed."""
        if offset < 0 or offset + length > self.size:
            raise ValueError(
                f"range [{offset}, {offset + length}) outside object "
                f"of {self.size} bytes")
        return self._pb.view[offset:offset + length]

    def commit(self, offset: int, length: int) -> bool:
        """Mark a range as landed (bytes already written via write() or
        through a view_for() slice); seals at full coverage."""
        if self.sealed or self.aborted:
            return self.sealed
        self._have.add(offset, offset + length)
        self.last_touch = time.monotonic()
        if self._have.covered >= self.size:
            self._seal()
        ev, self._event = self._event, asyncio.Event()
        ev.set()
        return self.sealed

    def has(self, offset: int, end: int) -> bool:
        return self.sealed or self._have.has(offset, end)

    async def wait_range(self, offset: int, end: int,
                         timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while not self.has(offset, end):
            if self.aborted:
                return False
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            ev = self._event
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                return False
        return True

    def read(self, offset: int, end: int) -> memoryview:
        """Zero-copy view of an already-landed range. Only valid while
        unsealed (the mapping closes at seal; sealed objects re-serve
        from the store). The returned slice keeps the mmap alive even
        across a concurrent seal — write-once ranges never mutate."""
        return self._pb.view[offset:end]

    def abort(self) -> None:
        if self.sealed or self.aborted:
            return
        self.aborted = True
        self._pb.abort()
        ev, self._event = self._event, asyncio.Event()
        ev.set()


# fetch_chunk(address, oid_b, offset, length, dest=None)
#   -> None (holder answered "missing") | (total_size, chunk_data).
# When `dest` (a writable memoryview) is given, a fetcher MAY receive
# the body straight into it (recv_into: kernel -> shm, one copy) and
# return (total_size, None); returning (total_size, data) instead means
# the engine copies via sink.write.
FetchChunkFn = Callable[..., Awaitable[Optional[Tuple[int, Any]]]]
# open_sink(oid_b, total_size) -> ChunkSink (raises ObjectExistsError
# when the object raced into the local store by other means)
OpenSinkFn = Callable[[bytes, int], ChunkSink]


async def striped_pull(
    oid_b: bytes,
    sources: List[Tuple[str, str]],          # (node_id, address)
    fetch_chunk: FetchChunkFn,
    open_sink: OpenSinkFn,
    *,
    chunk_bytes: int,
    window_bytes: int,
    per_source: int = 2,
    metrics: Optional[Dict[str, Any]] = None,
) -> Tuple[Optional[int], List[str]]:
    """Pull one object into the local store, striping chunk fetches
    across every source under a bytes-based in-flight window.

    Returns (total_size, stale_node_ids); total_size is None when no
    source produced the object. A source whose fetch raises is demoted
    for the rest of this transfer (its outstanding chunks requeue); a
    source that answers "missing" is reported stale so the caller can
    prune the directory entry.
    """
    stale: List[str] = []
    alive: List[Tuple[str, str]] = list(sources)
    inflight_gauge = metrics.get("inflight") if metrics else None
    bytes_in = metrics.get("bytes_in") if metrics else None
    gbps_hist = metrics.get("gbps") if metrics else None
    t_start = time.monotonic()

    # Phase 1: first chunk from the first usable source teaches us the
    # object's true size (the directory size is a hint).
    first: Optional[Tuple[int, Any]] = None
    while alive and first is None:
        node_id, addr = alive[0]
        try:
            first = await fetch_chunk(addr, oid_b, 0, chunk_bytes)
        except Exception:  # noqa: BLE001 — unreachable: demote
            alive.pop(0)
            continue
        if first is None:
            stale.append(node_id)
            alive.pop(0)
    if first is None:
        return None, stale
    total_size, data0 = first
    try:
        sink = open_sink(oid_b, total_size)
    except ObjectExistsError:
        return total_size, stale  # raced into the local store already
    pending: Dict[asyncio.Task, Tuple[int, int, Tuple[str, str]]] = {}
    inflight_bytes = 0
    try:
        sink.write(0, data0)
        remaining = [r for r in chunk_ranges(total_size, chunk_bytes)
                     if r[0] != 0]
        remaining.reverse()   # list-as-stack: pop() walks forward
        src_load: Dict[str, int] = {}
        rr = 0
        while remaining or pending:
            # Admit fetches up to the window, round-robin over sources
            # that still have per-source pipeline capacity.
            while remaining and alive:
                ready = [s for s in alive
                         if src_load.get(s[1], 0) < max(1, per_source)]
                if not ready:
                    break
                off, ln = remaining[-1]
                if pending and inflight_bytes + ln > window_bytes:
                    break
                remaining.pop()
                src = ready[rr % len(ready)]
                rr += 1
                task = asyncio.ensure_future(
                    fetch_chunk(src[1], oid_b, off, ln,
                                sink.view_for(off, ln)))
                pending[task] = (off, ln, src)
                src_load[src[1]] = src_load.get(src[1], 0) + 1
                inflight_bytes += ln
                if inflight_gauge is not None:
                    inflight_gauge.inc(ln)
            if not pending:
                # Chunks left but every source demoted/stale: give up.
                sink.abort()
                return None, stale
            done, _ = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED)
            for task in done:
                off, ln, (node_id, addr) = pending.pop(task)
                src_load[addr] -= 1
                inflight_bytes -= ln
                if inflight_gauge is not None:
                    inflight_gauge.dec(ln)
                try:
                    res = task.result()
                except Exception:  # noqa: BLE001 source died mid-pull:
                    # demote it; only ITS outstanding window requeues.
                    alive = [s for s in alive if s[1] != addr]
                    remaining.append((off, ln))
                    continue
                if res is None:
                    stale.append(node_id)
                    alive = [s for s in alive if s[1] != addr]
                    remaining.append((off, ln))
                    continue
                _, data = res
                if data is None:
                    sink.commit(off, ln)   # landed via recv_into dest
                else:
                    sink.write(off, data)
                if bytes_in is not None:
                    bytes_in.inc(ln)
        if not sink.sealed:  # defensive: coverage should have sealed it
            sink.abort()
            return None, stale
        if gbps_hist is not None and total_size:
            elapsed = max(time.monotonic() - t_start, 1e-9)
            gbps_hist.observe(total_size / elapsed / 1e9)
        return total_size, stale
    except BaseException:
        for task in list(pending):
            task.cancel()
        if inflight_gauge is not None and inflight_bytes:
            inflight_gauge.dec(inflight_bytes)
        sink.abort()
        raise


class _RawConn:
    """One blocking socket running one chunk request at a time, with a
    recv_into receive path: the raw-frame body goes from the kernel
    straight into the caller's destination buffer (the store mmap) —
    no StreamReader buffer, no intermediate bytes object."""

    def __init__(self, address: str, timeout: float):
        import socket as _socket

        host, port = address.rsplit(":", 1)
        self.sock = _socket.create_connection((host, int(port)),
                                              timeout=timeout)
        self.sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._req_id = 0

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray(n)
        self._recv_into_exact(memoryview(buf))
        return bytes(buf)

    def _recv_into_exact(self, view: memoryview) -> None:
        got = 0
        n = len(view)
        while got < n:
            r = self.sock.recv_into(view[got:])
            if not r:
                raise ConnectionError("peer closed mid-frame")
            got += r

    def fetch_into(self, oid_b: bytes, offset: int, length: int,
                   dest: Optional[memoryview]
                   ) -> Optional[Tuple[int, Any]]:
        """One get_object_chunk round trip. Raw replies land their body
        in `dest` (returning (total_size, None)) or, when dest is absent
        or too small, in a fresh buffer (returning (total_size, data)).
        Returns None when the holder answered "missing"."""
        import struct as _struct

        from ray_tpu_torch.core.distributed import rpc as _rpc
        from ray_tpu_torch.core.distributed import wire as _wire

        self._req_id += 1
        payload = _rpc._ser(("NodeDaemon", "get_object_chunk",
                             {"object_id": oid_b, "offset": offset,
                              "length": length}))
        self.sock.sendall(_rpc._frame(_rpc.REQ, self._req_id, payload))
        head = self._recv_exact(_rpc._HEADER.size)
        flen, version, ftype, req_id = _rpc._HEADER.unpack(head)
        if version != _wire.PROTOCOL_VERSION:
            raise _rpc.ProtocolVersionError(version, req_id)
        if (ftype != _rpc.RES or req_id != self._req_id
                or flen < _rpc._POST_LEN + 1 or flen > _rpc.MAX_FRAME):
            raise _rpc.RpcError(
                f"unexpected frame (type {ftype}, len {flen}) on a "
                f"chunk connection")
        plen = flen - _rpc._POST_LEN
        codec = self._recv_exact(1)[0]
        plen -= 1
        if codec != _wire.CODEC_RAW:
            # Small control reply: "missing", or an error to surface.
            rest = self._recv_exact(plen)
            reply = _rpc._de(bytes([codec]) + rest)
            if not reply.get("ok"):
                raise _rpc._as_exception(reply.get("error"))
            result = reply.get("result") or {}
            if result.get("missing"):
                return None
            data = result.get("data")
            return result.get("total_size", len(data or b"")), data
        (hlen,) = _struct.unpack("<I", self._recv_exact(4))
        plen -= 4
        if hlen > plen:
            raise _rpc.RpcError("corrupt raw frame header")
        header = self._recv_exact(hlen)
        body_len = plen - hlen
        reply = _wire.raw_header_loads(header)
        if not reply.get("ok"):
            # Drain the body (error replies should not carry one).
            if body_len:
                self._recv_exact(body_len)
            raise _rpc._as_exception(reply.get("error"))
        result = reply["result"]
        total_size = result["total_size"]
        if dest is not None and len(dest) >= body_len:
            self._recv_into_exact(dest[:body_len])
            return total_size, None
        data = bytearray(body_len)
        self._recv_into_exact(memoryview(data))
        return total_size, data


class RawChunkFetcher:
    """striped_pull's default fetch backend: a per-peer pool of blocking
    raw-chunk sockets driven on executor threads. recv_into writes each
    chunk body from the kernel directly into the store mmap, and the
    GIL is released for the whole receive — the event loop keeps
    scheduling while bytes land."""

    POOL_PER_PEER = 8

    def __init__(self, timeout_s: Optional[float] = None):
        import threading

        self._timeout_s = timeout_s
        self._pools: Dict[str, List[_RawConn]] = {}
        self._lock = threading.Lock()
        self._closed = False

    def _timeout(self) -> float:
        if self._timeout_s is not None:
            return self._timeout_s
        from ray_tpu_torch.core.config import get_config

        return get_config().transfer_chunk_timeout_s

    def _fetch_blocking(self, address: str, oid_b: bytes, offset: int,
                        length: int, dest) -> Optional[Tuple[int, Any]]:
        with self._lock:
            pool = self._pools.setdefault(address, [])
            conn = pool.pop() if pool else None
        if conn is None:
            conn = _RawConn(address, self._timeout())
        try:
            res = conn.fetch_into(oid_b, offset, length, dest)
        except BaseException:
            conn.close()    # unknown socket state: never repool
            raise
        with self._lock:
            pool = self._pools.setdefault(address, [])
            if self._closed or len(pool) >= self.POOL_PER_PEER:
                conn.close()
            else:
                pool.append(conn)
        return res

    async def fetch(self, address: str, oid_b: bytes, offset: int,
                    length: int, dest=None
                    ) -> Optional[Tuple[int, Any]]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, self._fetch_blocking, address, oid_b, offset, length,
            dest)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pools, self._pools = self._pools, {}
        for pool in pools.values():
            for conn in pool:
                conn.close()


def plan_broadcast_tree(targets: List[Any], fanout: int
                        ) -> List[Tuple[Any, List[Any]]]:
    """Partition an ordered target list into ≤`fanout` (child, subtree)
    slices for the relay tree: the caller sends to each child, each
    child recurses on its subtree. Depth is ceil(log_fanout(N)); every
    node's uplink carries at most fanout×size."""
    fanout = max(1, fanout)
    if not targets:
        return []
    k = min(fanout, len(targets))
    children = targets[:k]
    rest = targets[k:]
    plan: List[Tuple[Any, List[Any]]] = []
    base, extra = divmod(len(rest), k)
    pos = 0
    for i in range(k):
        take = base + (1 if i < extra else 0)
        plan.append((children[i], rest[pos:pos + take]))
        pos += take
    return plan


async def fetch_object_range(
    address: str,
    oid_b: bytes,
    offset: int,
    length: int,
    fetcher: "RawChunkFetcher",
    *,
    chunk_bytes: Optional[int] = None,
    dest: Optional[memoryview] = None,
) -> Optional[Tuple[int, memoryview]]:
    """Pull an arbitrary byte range of a remote object — the range-serve
    reuse path for streaming-shuffle bundles: a reducer fetches only its
    partition's slice of a mapper's sealed bundle instead of the whole
    object. Rides the same raw-frame `get_object_chunk` protocol as
    striped_pull (the daemon serves sealed AND in-flight partials), so
    a reducer can start on a bundle while the mapper is still writing
    later partitions.

    Returns (total_object_size, view-of-range) or None when the holder
    does not have the object. `dest` (when given) must be at least
    `length` bytes; the range lands there and the returned view aliases
    it."""
    if chunk_bytes is None:
        from ray_tpu_torch.core.config import get_config

        chunk_bytes = get_config().object_transfer_chunk_bytes
    own = dest is None
    if own:
        dest = memoryview(bytearray(length))
    total_size: Optional[int] = None
    got = 0
    for off, ln in chunk_ranges(length, chunk_bytes) or [(0, 0)]:
        res = await fetcher.fetch(address, oid_b, offset + off, ln,
                                  dest=dest[off:off + ln] if ln else None)
        if res is None:
            return None
        total_size, data = res
        if data is not None and ln:   # small/pickled reply: copy in
            dest[off:off + len(data)] = data[:ln]
            got += min(len(data), ln)
        else:
            got += ln
        # The daemon clamps reads at the object end; a short serve
        # means the requested range overruns the object.
        if offset + off + ln > total_size:
            raise ValueError(
                f"range [{offset}, {offset + length}) overruns object "
                f"of {total_size} bytes")
    return (total_size or 0), dest[:got]


def make_transfer_metrics(tags: Dict[str, str]) -> Dict[str, Any]:
    """Per-component transfer metric handles. Instances created under
    the same name share sample storage (registry adoption); per-
    daemon/worker accounting lives in the default tags — filter
    samples by node_id to read one component's counts."""
    from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

    return {
        "bytes_in": Counter(
            "raytpu_transfer_in_bytes_total",
            "Object chunk bytes received over the transfer plane"
        ).set_default_tags(tags),
        "bytes_out": Counter(
            "raytpu_transfer_out_bytes_total",
            "Object chunk bytes served over the transfer plane"
        ).set_default_tags(tags),
        "inflight": Gauge(
            "raytpu_transfer_inflight_bytes",
            "Chunk bytes currently in flight (windowed pulls)"
        ).set_default_tags(tags),
        "gbps": Histogram(
            "raytpu_transfer_gigabytes_per_second",
            "Per-transfer goodput",
            boundaries=(0.05, 0.2, 0.5, 1, 2, 5, 10)
        ).set_default_tags(tags),
    }
