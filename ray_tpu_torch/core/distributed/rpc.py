"""RPC plumbing: pickle-codec services over a length-prefixed TCP framing.

The port's copy of `ray_tpu/core/distributed/rpc.py`,
importing `ray_tpu_torch` only.

Role parity with the reference RPC framework (ref: src/ray/rpc/
grpc_server.h:85, grpc_client.h:92, client_call.h:188 — completion-queue
wrappers around generated stubs). Services are plain Python objects whose
public methods become unary RPCs; `stream_`-prefixed async generators
become server-streaming RPCs (chunked object transfer, pub/sub
long-polls).

The transport is a hand-rolled asyncio protocol, NOT grpc-python: the
reference's gRPC core is C++ with completion queues (~µs overhead), but
grpc-python's aio stack costs ~600µs per unary call on loopback — 14x
the cost of a length-prefixed frame over a plain asyncio stream (measured
in this environment: 657µs vs 47µs round-trip). Since every control-plane
hop (lease, push, heartbeat, directory update) rides this layer, the
framing IS the scheduler latency floor. Wire format:

    frame  := u32 length | u8 version | u8 type | u64 req_id | payload
    payload:= u8 codec | body    (codec 0 = pickle, 1 = typed; wire.py)
    types:    REQ, RES, STREAM_REQ, STREAM_ITEM, STREAM_END, CANCEL

The version byte is the schema seam the reference gets from proto3
(ref: src/ray/protobuf/core_worker.proto:425): a peer from a different
protocol generation receives a clear "protocol version mismatch" error
instead of a deserialize crash. The codec byte keeps pickle for
Python<->Python payloads while C++ peers speak the typed codec
(wire.py); the server always answers in the codec the request used.

Cancellation parity with gRPC deadlines: a client timeout sends CANCEL
(async) or drops the connection (sync), and the server cancels the
in-flight handler task — handlers relying on asyncio.CancelledError
semantics (lease grant shielding, runtime-env builds) behave identically.
"""
from __future__ import annotations

import asyncio
import inspect
import os
import pickle
import random
import socket
import struct
import threading
import time as _time
from typing import Any, Dict, Optional, Tuple

import cloudpickle

from ray_tpu_torch.core.distributed.wire import (
    CODEC_PICKLE,
    CODEC_RAW,
    CODEC_TYPED,
    PROTOCOL_VERSION,
    Raw,
    raw_dumps,
    raw_loads,
    scan_raw,
    typed_dumps,
    typed_loads,
    typed_safe,
)

MAX_FRAME = 512 * 1024 * 1024
# length (of version+type+id+payload), version, type, id
_HEADER = struct.Struct("<IBBQ")
_POST_LEN = 10  # bytes counted by `length` before the payload


REQ = 1
RES = 2
STREAM_REQ = 3
STREAM_ITEM = 4
STREAM_END = 5
CANCEL = 6


# ---------------------------------------------------------------------------
# Transport instrumentation (ref: the reference's per-method gRPC stats +
# instrumented asio event loops, src/ray/common/asio/instrumented_io_
# context.h). Per-service/method histograms for queue-wait and handler
# latency, inflight gauges, and bytes counters on the server and both
# clients — the framing IS the scheduler latency floor, so this is where
# control-plane regressions become visible. RAY_TPU_METRICS_RPC_ENABLED=0
# is the kill switch (the bench overhead probe flips it).
# ---------------------------------------------------------------------------

_rpc_metrics_singleton: Optional[dict] = None


def rpc_metrics() -> dict:
    """Process-wide transport metrics, created lazily (registry adoption
    makes repeat creation in in-proc harnesses safe)."""
    global _rpc_metrics_singleton
    if _rpc_metrics_singleton is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        _rpc_metrics_singleton = {
            "handler": Histogram(
                "raytpu_rpc_handler_seconds",
                "Server-side handler execution latency",
                tag_keys=("service", "method")),
            "queue_wait": Histogram(
                "raytpu_rpc_queue_wait_seconds",
                "Frame-decoded to handler-start queueing delay on the "
                "server event loop", tag_keys=("service", "method")),
            "client": Histogram(
                "raytpu_rpc_client_seconds",
                "Client-observed RPC round-trip latency",
                tag_keys=("service", "method")),
            "inflight": Gauge(
                "raytpu_rpc_inflight",
                "RPCs currently in flight", tag_keys=("side",)),
            "bytes": Counter(
                "raytpu_rpc_bytes_total",
                "Frame bytes moved over the RPC transport",
                tag_keys=("side", "direction")),
            "loop_lag": Histogram(
                "raytpu_event_loop_lag_seconds",
                "Event-loop scheduling lag (sleep-overshoot probe)",
                tag_keys=("loop",)),
        }
    return _rpc_metrics_singleton


def _instrumentation_enabled() -> bool:
    from ray_tpu_torch.core.config import get_config

    return get_config().metrics_rpc_enabled


# ---------------------------------------------------------------------------
# Caller identity (GCS load attribution)
# ---------------------------------------------------------------------------
#
# Every process declares WHO it is once (node id + component:
# syncer / serve-gauges / task-events / scheduler / client); both
# clients then ride a reserved `_caller` kwarg inside the existing
# (service, method, kwargs) request tuple — zero wire-format change, no
# protocol bump. The server pops it before handler dispatch (user
# handlers never see it) and, when an attribution sink is installed
# (the GCS), accounts request/bytes/handler-time per (service,
# component). Call sites that act as a DIFFERENT component than their
# process default (the daemon's syncer push vs its scheduler RPCs)
# pass an explicit `_caller=(node_id, component)` kwarg which wins.

_caller_identity: Optional[Tuple[str, str]] = None


def set_caller_identity(node_id: str, component: str) -> None:
    """Declare this process's default caller identity for GCS load
    attribution. Applied to every subsequent RPC from this process
    unless the call site passes an explicit ``_caller=`` kwarg."""
    global _caller_identity
    _caller_identity = (node_id, component)


def get_caller_identity() -> Optional[Tuple[str, str]]:
    return _caller_identity


def _attribution_enabled() -> bool:
    from ray_tpu_torch.core.config import get_config

    return get_config().gcs_attribution_enabled


def _inject_caller(kwargs: dict) -> None:
    if _caller_identity is not None and "_caller" not in kwargs \
            and _attribution_enabled():
        kwargs["_caller"] = _caller_identity


# Precomputed sample KEYS for the per-frame/per-call fast paths
# (metrics.*_key): the transport observes ~10 samples per RPC round
# trip, and building + sorting a tags dict per observation was a
# measurable slice of many_tasks throughput on a single-core host.
def _k(**tags) -> tuple:
    return tuple(sorted(tags.items()))


_K_SRV_IN = _k(side="server", direction="in")
_K_SRV_OUT = _k(side="server", direction="out")
_K_CLI_IN = _k(side="client", direction="in")
_K_CLI_OUT = _k(side="client", direction="out")
_K_SRV = _k(side="server")
_K_CLI = _k(side="client")
# (service, method) -> precomputed key, shared process-wide (the
# handler/queue-wait/client histograms share one tag shape).
_method_keys: Dict[Tuple[str, str], tuple] = {}


def _key_for(service: str, method: str) -> tuple:
    key = _method_keys.get((service, method))
    if key is None:
        key = _method_keys[(service, method)] = _k(service=service,
                                                   method=method)
    return key


def _payload_nbytes(payload) -> int:
    if isinstance(payload, list):
        return sum(len(p) for p in payload) + _HEADER.size
    return len(payload) + _HEADER.size


def _ser(obj: Any, codec: int = CODEC_PICKLE, safe: bool = False):
    """Codec-tagged payload. Pickle (the Python<->Python default) tries
    plain pickle first (RPC messages are dicts of primitives/bytes),
    cloudpickle as the fallback — ~3-5x faster on the hot path. Under
    the typed codec, `safe=True` (server REPLIES) projects exceptions
    and foreign objects onto the cross-language model via
    wire.typed_safe; REQUESTS stay strict so an out-of-model argument
    raises clearly instead of silently arriving as its repr string.

    A message carrying a wire.Raw marker (bulk chunk payloads) encodes
    as a RAW frame regardless of the requested codec and returns a LIST
    of buffers — typed header + the caller's body buffer untouched —
    for the transport to writev. Everything else returns bytes."""
    raw = scan_raw(obj)
    if raw is not None:
        header, body = raw_dumps(obj)
        return [b"\x02" + header, body]
    if codec == CODEC_TYPED:
        return b"\x01" + typed_dumps(typed_safe(obj) if safe else obj)
    try:
        return b"\x00" + pickle.dumps(obj, protocol=5)
    except Exception:  # noqa: BLE001 — closures, local classes, ...
        return b"\x00" + cloudpickle.dumps(obj, protocol=5)


def _de_codec(data: bytes) -> Tuple[Any, int]:
    if not data:
        raise RpcError("empty RPC payload")
    codec = data[0]
    view = memoryview(data)[1:]  # zero-copy past the codec byte
    if codec == CODEC_PICKLE:
        return pickle.loads(view), CODEC_PICKLE
    if codec == CODEC_TYPED:
        try:
            return typed_loads(view), CODEC_TYPED
        except Exception as e:  # noqa: BLE001 — corrupt payload must
            # surface as RpcError so client read loops classify it as
            # a transport fault, not an unhandled crash.
            raise RpcError(f"corrupt typed payload: {e}") from e
    if codec == CODEC_RAW:
        try:
            # The raw body arrives as a memoryview of `data`: the frame
            # bytes stay alive for exactly as long as the handler keeps
            # the view, and the chunk is never copied on the way in.
            return raw_loads(view), CODEC_RAW
        except Exception as e:  # noqa: BLE001
            raise RpcError(f"corrupt raw frame: {e}") from e
    raise RpcError(f"unknown payload codec {codec}")


def _de(data: bytes) -> Any:
    return _de_codec(data)[0]


class RpcError(Exception):
    pass


# ---------------------------------------------------------------------------
# Schedule-perturbation harness (race detection for the control plane)
# ---------------------------------------------------------------------------
#
# The reference catches ordering bugs in its C++ control plane with
# TSAN + randomized test schedules; our control plane is asyncio, where
# the realistic race surface is MESSAGE TIMING — actor seqnos, lease
# time-slicing, pubsub and pull-manager ordering all depend on when
# frames land relative to each other. With RAY_TPU_SCHED_FUZZ_MAX_MS
# set, every frame send sleeps a seeded pseudo-random delay first,
# perturbing cross-process interleavings the way a loaded host does —
# but reproducibly (RAY_TPU_SCHED_FUZZ_SEED, xor'd with the pid so each
# process gets a distinct stream). Child daemons inherit the env, so
# one setting fuzzes the whole cluster. Anything that breaks under it
# is a latent race, not a harness artifact: networks already reorder.

_fuzz_rng: Optional[random.Random] = None
_fuzz_seed: Optional[str] = None


def _sched_fuzz_delay() -> float:
    # lint: allow-knob -- fuzz harness reads env per call so seed sweeps work mid-process
    max_ms = os.environ.get("RAY_TPU_SCHED_FUZZ_MAX_MS")
    if not max_ms:
        return 0.0
    global _fuzz_rng, _fuzz_seed
    # lint: allow-knob -- fuzz harness reads env per call so seed sweeps work mid-process
    seed_s = os.environ.get("RAY_TPU_SCHED_FUZZ_SEED", "0")
    if _fuzz_rng is None or seed_s != _fuzz_seed:
        # Re-seed when the env seed changes mid-process (a test sweep
        # over seeds in one driver) — reproducibility demands the
        # driver replay the same stream as a standalone run.
        _fuzz_seed = seed_s
        _fuzz_rng = random.Random(int(seed_s) ^ os.getpid())
    return _fuzz_rng.random() * float(max_ms) / 1000.0


def _as_exception(err: Any) -> Exception:
    """Error field of a reply: a real exception under the pickle codec,
    a 'Type: message' string under the typed codec."""
    return err if isinstance(err, Exception) else RpcError(str(err))


class ProtocolVersionError(RpcError):
    """Peer speaks a different protocol generation."""

    def __init__(self, peer_version: int, req_id: int = 0):
        self.peer_version = peer_version
        self.req_id = req_id
        super().__init__(
            f"protocol version mismatch: peer sent v{peer_version}, "
            f"this node speaks v{PROTOCOL_VERSION}")


def _frame(ftype: int, req_id: int, payload: bytes) -> bytes:
    return _HEADER.pack(_POST_LEN + len(payload), PROTOCOL_VERSION,
                        ftype, req_id) + payload


def _frame_parts(ftype: int, req_id: int, parts: list) -> list:
    """Writev-style framing: header + payload buffers as separate
    segments, so a bulk body (a shm memoryview) reaches the socket
    without being concatenated into a fresh bytes object."""
    total = sum(len(p) for p in parts)
    return [_HEADER.pack(_POST_LEN + total, PROTOCOL_VERSION, ftype,
                         req_id)] + parts


async def _read_frame(reader: asyncio.StreamReader
                      ) -> Tuple[int, int, bytes]:
    head = await reader.readexactly(_HEADER.size)
    length, version, ftype, req_id = _HEADER.unpack(head)
    if length < _POST_LEN or length > MAX_FRAME:
        # < _POST_LEN would make readexactly() below receive a negative
        # count; either way the stream is garbage and must be dropped.
        raise RpcError(f"malformed frame length {length}")
    payload = await reader.readexactly(length - _POST_LEN)
    if version != PROTOCOL_VERSION:
        # Frame fully consumed, so the caller may answer before closing.
        raise ProtocolVersionError(version, req_id)
    return ftype, req_id, payload


class RpcServer:
    """Asyncio TCP server hosting named services on one port."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._services: Dict[str, Any] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()
        self._writers: set = set()
        self._metrics = rpc_metrics() if _instrumentation_enabled() \
            else None
        # GCS load attribution: when installed (GcsServer only), called
        # as sink((service, method, caller, in_nbytes), wall_s, kwargs,
        # stream=...) after every handler — caller is the popped
        # `_caller` identity tuple or None; stream=True means wall_s is
        # a stream's open lifetime, not loop occupancy. Must never
        # raise into the dispatch path.
        self.attribution_sink: Optional[Any] = None

    def add_service(self, name: str, service: Any) -> None:
        self._services[name] = service

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, limit=MAX_FRAME)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def stop(self, grace: float = 0.5) -> None:
        if self._server is not None:
            self._server.close()
        for t in list(self._conn_tasks):
            t.cancel()
        # Abort live connections: on Python 3.12+ Server.wait_closed()
        # blocks until every connection handler returns, and persistent
        # clients never hang up on their own.
        for w in list(self._writers):
            try:
                w.transport.abort()
            except Exception:  # noqa: BLE001
                pass
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), grace)
            except (Exception, asyncio.TimeoutError):  # noqa: BLE001
                pass

    # -- per-connection serving ----------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        sock = writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._writers.add(writer)
        wlock = asyncio.Lock()
        inflight: Dict[int, asyncio.Task] = {}
        metrics = self._metrics

        async def send(ftype: int, req_id: int, obj: Any,
                       codec: int = CODEC_PICKLE) -> None:
            try:
                payload = _ser(obj, codec, safe=True)
            except Exception as e:  # noqa: BLE001
                payload = _ser({"ok": False,
                                "error": RpcError(f"unpicklable: {e!r}")
                                if codec == CODEC_PICKLE
                                else f"unencodable reply: {e!r}"}, codec)
            d = _sched_fuzz_delay()
            if d:
                await asyncio.sleep(d)
            if metrics is not None:
                metrics["bytes"].inc_key(
                    _K_SRV_OUT, _payload_nbytes(payload))
            async with wlock:
                if isinstance(payload, list):
                    # Raw frame: hand each segment to the transport
                    # separately — the bulk body goes down as the
                    # handler's memoryview, never re-joined in Python.
                    for part in _frame_parts(ftype, req_id, payload):
                        writer.write(part)
                else:
                    writer.write(_frame(ftype, req_id, payload))
                await writer.drain()

        async def run_unary(req_id: int, fn, kwargs: dict, codec: int,
                            mkey: Optional[tuple] = None,
                            t_recv: float = 0.0,
                            attr: Optional[tuple] = None) -> None:
            if metrics is not None or attr is not None:
                now = _time.perf_counter()
            if metrics is not None:
                metrics["queue_wait"].observe_key(
                    mkey, max(0.0, now - t_recv))
                metrics["inflight"].inc_key(_K_SRV)
            try:
                result = fn(**kwargs)
                if inspect.isawaitable(result):
                    result = await result
                reply = {"ok": True, "result": result}
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                import traceback

                reply = {"ok": False, "error": e,
                         "traceback": traceback.format_exc()}
            finally:
                inflight.pop(req_id, None)
                if metrics is not None:
                    metrics["inflight"].inc_key(_K_SRV, -1)
                    metrics["handler"].observe_key(
                        mkey, _time.perf_counter() - now)
                if attr is not None:
                    sink = self.attribution_sink
                    if sink is not None:
                        try:
                            sink(attr, _time.perf_counter() - now, kwargs)
                        except Exception:  # noqa: BLE001
                            pass
            try:
                await send(RES, req_id, reply, codec)
            except (ConnectionError, OSError):
                pass  # client hung up mid-reply; nothing to tell it

        async def run_stream(req_id: int, fn, kwargs: dict, codec: int,
                             mkey: Optional[tuple] = None,
                             t_recv: float = 0.0,
                             attr: Optional[tuple] = None) -> None:
            if metrics is not None or attr is not None:
                now = _time.perf_counter()
            if metrics is not None:
                metrics["queue_wait"].observe_key(
                    mkey, max(0.0, now - t_recv))
                metrics["inflight"].inc_key(_K_SRV)
            try:
                async for item in fn(**kwargs):
                    await send(STREAM_ITEM, req_id, item, codec)
                end: Any = {"ok": True}
            except asyncio.CancelledError:
                inflight.pop(req_id, None)
                raise
            except (ConnectionError, OSError):
                inflight.pop(req_id, None)
                return  # consumer hung up mid-stream
            except Exception as e:  # noqa: BLE001
                end = {"ok": False, "error": e}
            finally:
                inflight.pop(req_id, None)
                if metrics is not None:
                    metrics["inflight"].inc_key(_K_SRV, -1)
                    metrics["handler"].observe_key(
                        mkey, _time.perf_counter() - now)
                if attr is not None:
                    sink = self.attribution_sink
                    if sink is not None:
                        # A stream's wall lifetime is await-time (a
                        # subscription can stay open for hours), not
                        # loop occupancy: count the request and its
                        # bytes, but no handler seconds, and keep it
                        # out of the slow-handler audit.
                        try:
                            sink(attr, _time.perf_counter() - now,
                                 kwargs, stream=True)
                        except Exception:  # noqa: BLE001
                            pass
            try:
                await send(STREAM_END, req_id, end, codec)
            except (ConnectionError, OSError):
                pass

        try:
            while True:
                try:
                    ftype, req_id, payload = await _read_frame(reader)
                except ProtocolVersionError as e:
                    # Answer with a clear typed error (the one codec a
                    # foreign-generation peer most plausibly decodes),
                    # then drop the connection — never unpickle bytes
                    # from a different protocol generation.
                    try:
                        await send(RES, e.req_id,
                                   {"ok": False, "error": str(e)},
                                   CODEC_TYPED)
                    except (ConnectionError, OSError):
                        pass
                    return
                except (asyncio.IncompleteReadError, ConnectionError,
                        OSError, RpcError):
                    return
                if ftype == CANCEL:
                    task = inflight.pop(req_id, None)
                    if task is not None:
                        task.cancel()
                    continue
                if metrics is not None:
                    t_recv = _time.perf_counter()
                    metrics["bytes"].inc_key(
                        _K_SRV_IN, len(payload) + _HEADER.size)
                else:
                    t_recv = 0.0
                try:
                    (service, method, kwargs), codec = _de_codec(payload)
                except Exception:  # noqa: BLE001
                    continue
                # Reserved attribution kwarg: popped unconditionally so
                # handlers never see it, accounted only when a sink is
                # installed (the GCS).
                caller = kwargs.pop("_caller", None) \
                    if isinstance(kwargs, dict) else None
                svc = self._services.get(service)
                fn = (None if svc is None or method.startswith("_")
                      else getattr(svc, method, None))
                if fn is None:
                    await send(RES, req_id, {
                        "ok": False,
                        "error": RpcError(
                            f"no such RPC {service}.{method}")}, codec)
                    continue
                mkey = (_key_for(service, method)
                        if metrics is not None else None)
                attr = ((service, method, caller,
                         len(payload) + _HEADER.size)
                        if self.attribution_sink is not None else None)
                runner = (run_stream if ftype == STREAM_REQ else run_unary)
                task = asyncio.ensure_future(
                    runner(req_id, fn, kwargs, codec, mkey, t_recv, attr))
                inflight[req_id] = task
                self._conn_tasks.add(task)
                task.add_done_callback(self._conn_tasks.discard)
        finally:
            # Connection gone: cancel its in-flight handlers, mirroring
            # gRPC's deadline/disconnect cancellation.
            self._writers.discard(writer)
            for task in inflight.values():
                task.cancel()
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass


class AsyncRpcClient:
    """Multiplexed connection to one peer; call services from async code.

    All I/O happens on the event loop the first call runs on (one loop
    per process, the EventLoopThread)."""

    def __init__(self, address: str, codec: int = CODEC_PICKLE):
        self.address = address
        self.codec = codec
        self._metrics = rpc_metrics() if _instrumentation_enabled() \
            else None
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._wlock: Optional[asyncio.Lock] = None
        self._conn_lock: Optional[asyncio.Lock] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._streams: Dict[int, asyncio.Queue] = {}
        self._req_id = 0
        self._reader_task: Optional[asyncio.Task] = None
        self._closed = False

    async def _ensure_conn(self) -> None:
        if self._writer is not None and not self._writer.is_closing():
            return
        if self._conn_lock is None:
            self._conn_lock = asyncio.Lock()
        async with self._conn_lock:
            if self._writer is not None and not self._writer.is_closing():
                return
            if self._closed:
                raise RpcError(f"client to {self.address} is closed")
            host, port = self.address.rsplit(":", 1)
            try:
                reader, writer = await asyncio.open_connection(
                    host, int(port), limit=MAX_FRAME)
            except OSError as e:
                raise RpcError(
                    f"connect to {self.address} failed: {e}") from e
            sock = writer.get_extra_info("socket")
            if sock is not None:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._reader, self._writer = reader, writer
            self._wlock = asyncio.Lock()
            self._reader_task = asyncio.ensure_future(self._read_loop())

    async def _read_loop(self) -> None:
        reader = self._reader
        metrics = self._metrics
        try:
            while True:
                ftype, req_id, payload = await _read_frame(reader)
                if metrics is not None:
                    metrics["bytes"].inc_key(
                        _K_CLI_IN, len(payload) + _HEADER.size)
                if ftype == RES:
                    fut = self._pending.pop(req_id, None)
                    if fut is not None and not fut.done():
                        fut.set_result(_de(payload))
                elif ftype == STREAM_ITEM:
                    q = self._streams.get(req_id)
                    if q is not None:
                        q.put_nowait(("item", _de(payload)))
                elif ftype == STREAM_END:
                    q = self._streams.pop(req_id, None)
                    if q is not None:
                        q.put_nowait(("end", _de(payload)))
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                RpcError, asyncio.CancelledError) as e:
            if isinstance(e, asyncio.CancelledError):
                # Deliberate close(): cancel waiters instead of setting
                # exceptions nobody will retrieve.
                for fut in self._pending.values():
                    if not fut.done():
                        fut.cancel()
            else:
                err = RpcError(f"connection to {self.address} lost: {e!r}")
                for fut in self._pending.values():
                    if not fut.done():
                        fut.set_exception(err)
            self._pending.clear()
            err = RpcError(f"connection to {self.address} lost: {e!r}")
            for q in self._streams.values():
                q.put_nowait(("end", {"ok": False, "error": err}))
            self._streams.clear()
            if self._writer is not None:
                try:
                    self._writer.close()
                except Exception:  # noqa: BLE001
                    pass

    async def _send(self, ftype: int, req_id: int, obj: Any) -> None:
        d = _sched_fuzz_delay()
        if d:
            await asyncio.sleep(d)
        payload = _ser(obj, self.codec)
        if self._metrics is not None:
            self._metrics["bytes"].inc_key(
                _K_CLI_OUT, _payload_nbytes(payload))
        async with self._wlock:
            if isinstance(payload, list):
                for part in _frame_parts(ftype, req_id, payload):
                    self._writer.write(part)
            else:
                self._writer.write(_frame(ftype, req_id, payload))
            await self._writer.drain()

    async def call(self, service: str, method: str,
                   timeout: Optional[float] = None, **kwargs) -> Any:
        if self._metrics is None:
            return await self._call(service, method, timeout, **kwargs)
        t0 = _time.perf_counter()
        self._metrics["inflight"].inc_key(_K_CLI)
        try:
            return await self._call(service, method, timeout, **kwargs)
        finally:
            self._metrics["inflight"].inc_key(_K_CLI, -1)
            self._metrics["client"].observe_key(
                _key_for(service, method), _time.perf_counter() - t0)

    async def _call(self, service: str, method: str,
                    timeout: Optional[float] = None, **kwargs) -> Any:
        _inject_caller(kwargs)
        await self._ensure_conn()
        self._req_id += 1
        req_id = self._req_id
        fut = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        try:
            await self._send(REQ, req_id, (service, method, kwargs))
        except (ConnectionError, OSError) as e:
            self._pending.pop(req_id, None)
            raise RpcError(
                f"RPC {service}.{method} to {self.address} failed: "
                f"{e!r}") from e
        except Exception:  # encode error (e.g. WireError): not sent
            self._pending.pop(req_id, None)
            raise
        try:
            if timeout is not None:
                reply = await asyncio.wait_for(fut, timeout)
            else:
                reply = await fut
        except (TimeoutError, asyncio.TimeoutError):
            self._pending.pop(req_id, None)
            # Parity with gRPC deadlines: cancel the server-side handler.
            try:
                await self._send(CANCEL, req_id, None)
            except Exception:  # noqa: BLE001
                pass
            raise RpcError(
                f"RPC {service}.{method} to {self.address} failed: "
                f"DEADLINE_EXCEEDED after {timeout}s") from None
        except asyncio.CancelledError:
            self._pending.pop(req_id, None)
            try:
                await self._send(CANCEL, req_id, None)
            except Exception:  # noqa: BLE001
                pass
            raise
        if not reply["ok"]:
            raise _as_exception(reply.get("error"))
        return reply["result"]

    def stream(self, service: str, method: str,
               timeout: Optional[float] = None, **kwargs):
        async def gen():
            _inject_caller(kwargs)
            await self._ensure_conn()
            self._req_id += 1
            req_id = self._req_id
            q: asyncio.Queue = asyncio.Queue()
            self._streams[req_id] = q
            await self._send(STREAM_REQ, req_id, (service, method, kwargs))
            try:
                while True:
                    if timeout is not None:
                        kind, value = await asyncio.wait_for(q.get(),
                                                             timeout)
                    else:
                        kind, value = await q.get()
                    if kind == "item":
                        yield value
                        continue
                    if not value.get("ok"):
                        raise _as_exception(value.get("error"))
                    return
            except (TimeoutError, asyncio.TimeoutError):
                raise RpcError(
                    f"stream {service}.{method} to {self.address} "
                    f"failed: DEADLINE_EXCEEDED") from None
            finally:
                if self._streams.pop(req_id, None) is not None:
                    # Early exit: stop the server-side generator.
                    try:
                        await self._send(CANCEL, req_id, None)
                    except Exception:  # noqa: BLE001
                        pass

        return gen()

    async def close(self) -> None:
        """Clean shutdown: cancel AND await the read loop (a cancelled-
        but-never-awaited task produces 'Task was destroyed but it is
        pending!' at interpreter exit), cancel pending call futures, and
        close the transport."""
        self._closed = True
        task, self._reader_task = self._reader_task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        for fut in self._pending.values():
            if not fut.done():
                fut.cancel()
        self._pending.clear()
        writer, self._writer = self._writer, None
        if writer is not None:
            try:
                writer.close()
                await asyncio.wait_for(writer.wait_closed(), 0.5)
            except (Exception, asyncio.TimeoutError):  # noqa: BLE001
                pass


class EventLoopThread:
    """A dedicated asyncio loop on a background thread.

    Synchronous frontends (the user's driver thread, worker task threads)
    submit coroutines here; all async RPC machinery lives on this loop.
    The analogue of the instrumented asio event loop each reference
    process runs (ref: src/ray/common/asio/)."""

    # Dispatch-heavy processes (driver submit thread vs RPC loop, worker
    # executor vs RPC loop) ping-pong the GIL; CPython's default 5ms
    # switch interval lets one side hold it for entire scheduling
    # quanta, serializing the pipeline (measured: n:n actor submission
    # 2.5k/s at 5ms vs 5k/s at 0.5ms). Applied only when the process is
    # still on CPython's factory default — an embedding application that
    # chose its own interval keeps it.
    SWITCH_INTERVAL_S = 0.0005
    _DEFAULT_SWITCH_INTERVAL_S = 0.005

    def __init__(self, name: str = "rpc-loop"):
        import sys as _sys

        if _sys.getswitchinterval() == self._DEFAULT_SWITCH_INTERVAL_S:
            _sys.setswitchinterval(self.SWITCH_INTERVAL_S)
        self.loop = asyncio.new_event_loop()
        # Strong roots for submitted background tasks: asyncio holds only
        # WEAK references to tasks, so a fire-and-forget coroutine whose
        # awaited future is reachable only through its own frame (task →
        # frame → client → queue → future → task) is one unreferenced
        # cycle the GC will happily collect MID-FLIGHT — the coroutine
        # silently dies with GeneratorExit (observed: the driver's log
        # subscriber vanished at the first gc pass after init).
        self._bg_tasks: set = set()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._started = threading.Event()
        self._thread.start()
        self._started.wait()
        self._maybe_start_lag_probe(name)

    def _maybe_start_lag_probe(self, name: str) -> None:
        """Event-loop lag probe (ref: instrumented_io_context.h): a
        periodic sleep measures its own scheduling overshoot — the
        direct signal that a handler is hogging the loop (the exact
        failure mode the reference's asio stats catch). Off when RPC
        instrumentation is off or RAY_TPU_METRICS_LOOP_PROBE_MS=0."""
        from ray_tpu_torch.core.config import get_config

        probe_ms = get_config().metrics_loop_probe_ms
        if not probe_ms or not _instrumentation_enabled():
            return

        async def probe() -> None:
            hist = rpc_metrics()["loop_lag"]
            tags = {"loop": name}
            interval = probe_ms / 1000.0
            while True:
                t0 = self.loop.time()
                await asyncio.sleep(interval)
                hist.observe(max(0.0, self.loop.time() - t0 - interval),
                             tags)

        self.submit(probe())

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self._started.set()
        self.loop.run_forever()

    def run(self, coro, timeout: Optional[float] = None):
        """Run coroutine on the loop, blocking the calling thread."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def submit(self, coro):
        """Fire-and-forget (returns concurrent Future). The task is
        rooted in self._bg_tasks until done — see __init__."""
        async def rooted():
            task = asyncio.current_task()
            self._bg_tasks.add(task)
            try:
                return await coro
            finally:
                self._bg_tasks.discard(task)

        return asyncio.run_coroutine_threadsafe(rooted(), self.loop)

    def stop(self):
        async def _drain():
            # Sweep REPEATEDLY: a cancelled task's cleanup can spawn new
            # tasks (e.g. a failure handler resubmitting work), and a
            # single sweep would leave those to die as destroyed-pending
            # tasks at interpreter exit.
            # Generous deadline: on a loaded single-CPU host a 2s sweep
            # budget expired mid-drain, leaving cancelled-but-unawaited
            # tasks to die as destroy-pending noise at interpreter exit.
            deadline = self.loop.time() + 6.0
            try:
                while True:
                    tasks = [t for t in asyncio.all_tasks(self.loop)
                             if t is not asyncio.current_task()]
                    if not tasks or self.loop.time() >= deadline:
                        break
                    for task in tasks:
                        task.cancel()
                    await asyncio.wait(tasks, timeout=0.5)
            finally:
                self.loop.stop()

        def _shutdown():
            asyncio.ensure_future(_drain())

        self.loop.call_soon_threadsafe(_shutdown)
        self._thread.join(timeout=4)


class _BlockingConn:
    """One blocking socket running one request at a time."""

    def __init__(self, address: str):
        host, port = address.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)), timeout=30)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = bytearray()
        self.last_recv_nbytes = 0

    def stale(self) -> bool:
        """Has the peer closed this pooled socket (restarted server)?

        A non-blocking MSG_PEEK distinguishes 'peer sent FIN/RST while
        pooled' from 'healthy idle socket' WITHOUT consuming data —
        detecting staleness BEFORE the request is sent, so the caller
        never has to guess whether a failed request already executed."""
        try:
            self.sock.setblocking(False)
            try:
                data = self.sock.recv(1, socket.MSG_PEEK)
                return data == b""      # orderly FIN
            finally:
                self.sock.setblocking(True)
        except BlockingIOError:
            return False                # nothing to read: healthy idle
        except OSError:
            return True                 # RST or dead fd

    def send_request(self, req_id: int, payload,
                     timeout: Optional[float]) -> None:
        d = _sched_fuzz_delay()
        if d:
            _time.sleep(d)
        self.sock.settimeout(timeout)
        if isinstance(payload, list):
            # Raw frame: sendall per segment (writev-style, no join).
            for part in _frame_parts(REQ, req_id, payload):
                self.sock.sendall(part)
        else:
            self.sock.sendall(_frame(REQ, req_id, payload))

    def recv_reply(self, req_id: int) -> Any:
        while True:
            ftype, rid, body = self._recv_frame()
            if ftype == RES and rid == req_id:
                return _de(body)
            # Stale frame from an abandoned request on this socket —
            # cannot happen (a timed-out socket is discarded), but skip
            # defensively rather than corrupt the stream.

    def _recv_frame(self) -> Tuple[int, int, bytes]:
        need = _HEADER.size
        while len(self._buf) < need:
            chunk = self.sock.recv(256 * 1024)
            if not chunk:
                raise ConnectionError("peer closed")
            self._buf += chunk
        length, version, ftype, req_id = _HEADER.unpack_from(self._buf, 0)
        if length < _POST_LEN or length > MAX_FRAME:
            raise RpcError(f"malformed frame length {length}")
        total = _HEADER.size + length - _POST_LEN
        while len(self._buf) < total:
            chunk = self.sock.recv(1024 * 1024)
            if not chunk:
                raise ConnectionError("peer closed")
            self._buf += chunk
        payload = bytes(self._buf[_HEADER.size:total])
        del self._buf[:total]
        self.last_recv_nbytes = total
        if version != PROTOCOL_VERSION:
            raise ProtocolVersionError(version, req_id)
        return ftype, req_id, payload

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class SyncRpcClient:
    """Blocking client: a small pool of dedicated sockets, no event-loop
    hops. The async facade costs two cross-thread wakeups per call
    (~0.5ms); a blocking socket round-trips in ~50µs, and the control
    plane's sync callers (driver get/put, worker→GCS bookkeeping) sit on
    exactly that path."""

    MAX_POOL = 16

    def __init__(self, address: str, loop_thread: EventLoopThread = None,
                 codec: int = CODEC_PICKLE):
        self.address = address
        self.codec = codec
        self._loop = loop_thread        # kept for API compatibility
        self._metrics = rpc_metrics() if _instrumentation_enabled() \
            else None
        self._pool: list = []
        self._lock = threading.Lock()
        self._req_id = 0
        self._sem = threading.BoundedSemaphore(self.MAX_POOL)

    def call(self, service: str, method: str,
             timeout: Optional[float] = None, idempotent: bool = False,
             **kwargs) -> Any:
        if self._metrics is None:
            return self._call(service, method, timeout, idempotent,
                              **kwargs)
        t0 = _time.perf_counter()
        self._metrics["inflight"].inc_key(_K_CLI)
        try:
            return self._call(service, method, timeout, idempotent,
                              **kwargs)
        finally:
            self._metrics["inflight"].inc_key(_K_CLI, -1)
            self._metrics["client"].observe_key(
                _key_for(service, method), _time.perf_counter() - t0)

    def _call(self, service: str, method: str,
              timeout: Optional[float] = None, idempotent: bool = False,
              **kwargs) -> Any:
        """One blocking RPC.

        Retry semantics (at-most-once by default): stale pooled sockets
        are detected with a MSG_PEEK probe BEFORE the request is sent,
        and a send-phase failure retries on a fresh connection — in both
        cases the request provably never executed. A failure during the
        reply phase means the server may have already executed the
        handler, so it is NOT retried (gRPC's transparent reconnect has
        the same rule) — unless the caller declares the method
        `idempotent=True` (reads, status polls, overwriting KV puts).
        """
        _inject_caller(kwargs)
        payload = _ser((service, method, kwargs), self.codec)
        with self._lock:
            self._req_id += 1
            req_id = self._req_id

        def fresh_conn() -> _BlockingConn:
            try:
                return _BlockingConn(self.address)
            except OSError as e:
                raise RpcError(
                    f"connect to {self.address} failed: {e}") from e

        def rpc_error(e, phase: str) -> RpcError:
            return RpcError(
                f"RPC {service}.{method} to {self.address} failed "
                f"({phase}): {e!r}")

        self._sem.acquire()
        conn = None
        try:
            # Pull a pooled socket, discarding any the peer has closed.
            while conn is None:
                with self._lock:
                    if not self._pool:
                        break
                    conn = self._pool.pop()
                if conn.stale():
                    conn.close()
                    conn = None
            if conn is None:
                conn = fresh_conn()
            try:
                conn.send_request(req_id, payload, timeout)
            except (ConnectionError, OSError, socket.timeout) as e:
                # Request never fully reached the server (a partial
                # frame is dropped by the server's length check): safe
                # to retry once on a fresh connection.
                conn.close()
                conn = fresh_conn()
                try:
                    conn.send_request(req_id, payload, timeout)
                except (ConnectionError, OSError, socket.timeout) as e2:
                    conn.close()
                    raise rpc_error(e2, "send") from e2
            for attempt in (0, 1):
                try:
                    reply = conn.recv_reply(req_id)
                    break
                except socket.timeout:
                    # Mid-reply socket is unusable: drop it. The server
                    # sees the close and cancels the handler (deadline
                    # parity with gRPC).
                    conn.close()
                    conn = None
                    raise RpcError(
                        f"RPC {service}.{method} to {self.address} "
                        f"failed: DEADLINE_EXCEEDED after {timeout}s"
                    ) from None
                except (ConnectionError, OSError, RpcError) as e:
                    conn.close()
                    conn = None
                    if not idempotent or attempt:
                        raise rpc_error(e, "recv") from e
                    conn = fresh_conn()
                    try:
                        conn.send_request(req_id, payload, timeout)
                    except (ConnectionError, OSError,
                            socket.timeout) as e2:
                        conn.close()
                        conn = None
                        raise rpc_error(e2, "send") from e2
            if self._metrics is not None:
                self._metrics["bytes"].inc_key(
                    _K_CLI_OUT, _payload_nbytes(payload))
                self._metrics["bytes"].inc_key(
                    _K_CLI_IN, conn.last_recv_nbytes)
            with self._lock:
                if conn is not None and len(self._pool) < self.MAX_POOL:
                    self._pool.append(conn)
                    conn = None
            if conn is not None:
                conn.close()
                conn = None
        finally:
            if conn is not None:
                conn.close()
            self._sem.release()
        if not reply["ok"]:
            raise _as_exception(reply.get("error"))
        return reply["result"]

    def close(self):
        with self._lock:
            pool, self._pool = self._pool, []
        for conn in pool:
            conn.close()
