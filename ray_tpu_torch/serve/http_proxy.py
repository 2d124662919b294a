"""HTTP ingress: async per-node proxy actor routing to deployment handles.

The port's copy of `ray_tpu/serve/http_proxy.py`, on the standard
library: the JAX package serves through aiohttp, which this one never
imports.

Reference: uvicorn-based `HTTPProxy` actor per node with streaming
responses (ref: python/ray/serve/_private/proxy.py:747; GenericProxy
routing :129). An HTTP/1.1 server on `asyncio.start_server` replaces
uvicorn here (request line and headers, `Content-Length` or chunked
request bodies, keep-alive): requests are served on the proxy's own
asyncio loop; handle calls (which block on the runtime) run on an
executor pool; streaming deployments answer with chunked JSONL — one
line per yielded item — so token streams reach the client as they are
generated (TTFT == first chunk). Bodies, status codes and headers are
the ones the JAX package's aiohttp proxy sends.

Robustness: every request gets an id (X-Request-Id in, generated
otherwise) echoed in error bodies, logs, and the response header;
admission is bounded at RAY_TPU_SERVE_PROXY_MAX_INFLIGHT in-flight
requests — beyond it the proxy SHEDS with 503 + Retry-After instead of
queueing without limit; replica-death/draining failures map to 503 (the
client should retry), client mistakes stay 404/422, and unary calls run
under the RAY_TPU_SERVE_REQUEST_DEADLINE_S deadline.  Mid-stream replica
death is invisible here: the handle's StreamingResponse fails over and
resumes exactly-once underneath the JSONL writer.

Routes: POST/GET <prefix>            -> unary   {"...": ...}
        POST/GET <prefix>?stream=1   -> chunked JSONL stream
Headers: X-Model-Id (or body {"model_id": ...}) -> multiplexed routing.
"""
from __future__ import annotations

import asyncio
import http
import json
import logging
import os
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional
from urllib.parse import parse_qsl, unquote, urlsplit

from ray_tpu_torch.util import tracing

logger = logging.getLogger("ray_tpu_torch.serve.http_proxy")

# Request bodies past this many bytes are refused with 413, as aiohttp's
# default `client_max_size` refuses them in the JAX package's proxy.
MAX_BODY_BYTES = 1 << 20


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _Request:
    """One parsed HTTP request: method, percent-decoded path, query (first
    value of each key), headers (case-insensitive), body bytes."""

    __slots__ = ("method", "path", "query", "headers", "body",
                 "keep_alive")

    def __init__(self, method: str, target: str, version: str,
                 headers: Dict[str, str], body: bytes):
        parts = urlsplit(target)
        self.method = method
        self.path = unquote(parts.path) or "/"
        self.query: Dict[str, str] = {}
        for k, v in parse_qsl(parts.query, keep_blank_values=True):
            self.query.setdefault(k, v)
        self.headers = headers
        self.body = body
        conn = headers.get("connection", "").lower()
        self.keep_alive = (conn != "close" if version == "HTTP/1.1"
                           else conn == "keep-alive")


class _Headers(dict):
    """Header map keyed by lower-cased name."""

    def get(self, key, default=None):
        return super().get(key.lower(), default)


async def _read_request(reader: asyncio.StreamReader,
                        writer: Optional[asyncio.StreamWriter] = None
                        ) -> Optional[_Request]:
    """Read one request off the connection; None at a clean end of the
    stream between requests. A client that sent `Expect: 100-continue`
    (curl does past 1 KiB) is told to go on before its body is read."""
    line = await reader.readline()
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").split()
    except ValueError:
        raise _BadRequest(400, "malformed request line") from None
    if not version.startswith("HTTP/1."):
        raise _BadRequest(505, "HTTP version not supported")
    headers = _Headers()
    while True:
        raw = await reader.readline()
        if raw in (b"\r\n", b"\n", b""):
            break
        name, sep, value = raw.decode("latin-1").partition(":")
        if not sep:
            raise _BadRequest(400, "malformed header")
        headers[name.strip().lower()] = value.strip()
    if (writer is not None
            and headers.get("expect", "").lower() == "100-continue"):
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        body = bytearray()
        while True:
            size_line = await reader.readline()
            try:
                size = int(size_line.split(b";")[0].strip(), 16)
            except ValueError:
                raise _BadRequest(400, "malformed chunk size") from None
            if size == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n",
                                                        b""):
                    pass     # trailers
                break
            if len(body) + size > MAX_BODY_BYTES:
                raise _BadRequest(413, "request body too large")
            body += await reader.readexactly(size)
            await reader.readexactly(2)
        body = bytes(body)
    else:
        try:
            length = int(headers.get("content-length", "0") or 0)
        except ValueError:
            raise _BadRequest(400, "malformed Content-Length") from None
        if length > MAX_BODY_BYTES:
            raise _BadRequest(413, "request body too large")
        body = await reader.readexactly(length) if length > 0 else b""
    return _Request(method, target, version, headers, body)


def _head(status: int, headers: Dict[str, str]) -> bytes:
    try:
        reason = http.HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class _Response:
    """A whole response, written by the connection loop."""

    sent = False

    def __init__(self, body: bytes, status: int = 200,
                 headers: Optional[Dict[str, str]] = None,
                 content_type: str = "application/json; charset=utf-8"):
        self.status = status
        self.body = body
        self.headers = {"Content-Type": content_type,
                        "Content-Length": str(len(body)),
                        **(headers or {})}

    async def send(self, writer: asyncio.StreamWriter,
                   keep_alive: bool) -> None:
        headers = dict(self.headers)
        if not keep_alive:
            headers["Connection"] = "close"
        writer.write(_head(self.status, headers) + self.body)
        await writer.drain()


def _json_response(data, status: int = 200,
                   headers: Optional[Dict[str, str]] = None) -> _Response:
    """aiohttp's `web.json_response`: the body is `json.dumps(data)`."""
    return _Response(json.dumps(data).encode(), status, headers)


class _StreamResponse:
    """A chunked response the handler writes itself (`sent` once its
    head went out)."""

    def __init__(self, writer: asyncio.StreamWriter,
                 headers: Dict[str, str], keep_alive: bool):
        self.status = 200
        self.sent = False
        self._writer = writer
        self._headers = {**headers, "Transfer-Encoding": "chunked"}
        if not keep_alive:
            self._headers["Connection"] = "close"

    async def prepare(self) -> None:
        self._writer.write(_head(self.status, self._headers))
        await self._writer.drain()
        self.sent = True

    async def write(self, data: bytes) -> None:
        if data:
            self._writer.write(b"%x\r\n%b\r\n" % (len(data), data))
            await self._writer.drain()

    async def write_eof(self) -> None:
        self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()


def _error_status(e: BaseException) -> tuple:
    """(status, retryable) for a dispatch failure — 503 + Retry-After
    for transient routing/capacity conditions, 504 for deadline, 500
    otherwise."""
    import ray_tpu_torch.exceptions as rexc

    if isinstance(e, (rexc.ActorDiedError, rexc.ActorUnavailableError,
                      rexc.ReplicaDrainingError, rexc.StreamQueueFullError)):
        return 503, True
    if isinstance(e, (rexc.GetTimeoutError, TimeoutError)):
        return 504, False
    return 500, False


class HTTPProxy:
    """Actor: owns the HTTP server + route table {prefix: app_name}."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 executor_threads: int = 64,
                 max_inflight: Optional[int] = None,
                 request_deadline_s: Optional[float] = None):
        from ray_tpu_torch.core.config import get_config

        cfg = get_config()
        self._routes: Dict[str, str] = {}
        self._handles: Dict[str, object] = {}
        self._max_inflight = (max_inflight if max_inflight is not None
                              else cfg.serve_proxy_max_inflight)
        self._deadline_s = (request_deadline_s
                            if request_deadline_s is not None
                            else cfg.serve_request_deadline_s)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._shed_total = 0
        self._executor = ThreadPoolExecutor(max_workers=executor_threads,
                                            thread_name_prefix="proxy")
        # Separate pool for stream pulls: long-running unary calls must
        # not starve in-flight token streams.
        self._stream_executor = ThreadPoolExecutor(
            max_workers=executor_threads, thread_name_prefix="proxy-stream")
        self._port: Optional[int] = None
        self._started = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._host = host
        self._want_port = port
        self._load_persisted_routes()
        # The proxy has no gauge loop to piggyback its registry on, so
        # it runs the generic worker->daemon metrics pusher (no-op in
        # local mode).
        from ray_tpu_torch.serve import observability

        self._metrics = observability.metrics()
        self._metrics_push_stop = observability.start_push_loop(
            f"proxy:{os.getpid()}")
        threading.Thread(target=self._serve_thread, daemon=True).start()
        if not self._started.wait(30):
            raise RuntimeError("HTTP proxy failed to start")

    def _load_persisted_routes(self) -> None:
        """A restarted proxy re-installs the route table from the GCS KV
        ("serve"/"routes", written by serve.run) instead of coming back
        empty — routes survive proxy AND controller death, and the GCS
        PersistentStore carries them across GCS restarts."""
        try:
            from ray_tpu_torch.api import _global_worker, is_initialized

            if not is_initialized():
                return
            blob = _global_worker().kv_get("serve", b"routes")
            if blob:
                self._routes.update(json.loads(blob.decode()))
        except Exception:  # noqa: BLE001 best-effort recovery
            pass

    # -- HTTP server on a dedicated loop --------------------------------
    def _serve_thread(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def start():
            server = await asyncio.start_server(
                self._serve_connection, self._host, self._want_port)
            self._server = server
            self._port = server.sockets[0].getsockname()[1]
            self._started.set()

        loop.run_until_complete(start())
        loop.run_forever()

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        """Requests on one connection, in turn, until the client closes
        it or a response says `Connection: close`."""
        try:
            while True:
                try:
                    request = await _read_request(reader, writer)
                except _BadRequest as e:
                    await _json_response(
                        {"error": str(e)}, status=e.status).send(
                            writer, keep_alive=False)
                    return
                if request is None:
                    return
                resp = await self._dispatch(request, writer)
                if not resp.sent:
                    await resp.send(writer, request.keep_alive)
                if not request.keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass     # the client went away mid-request or mid-response
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    def _match_route(self, path: str) -> Optional[str]:
        path = path.rstrip("/") or "/"
        app, match_len = None, -1
        for prefix, name in self._routes.items():
            if (path == prefix
                    or path.startswith(prefix.rstrip("/") + "/")):
                if len(prefix) > match_len:
                    app, match_len = name, len(prefix)
        return app

    def _handle_for(self, app_name: str):
        h = self._handles.get(app_name)
        if h is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle

            h = self._handles[app_name] = DeploymentHandle(app_name)
        return h

    def _error_response(self, e: BaseException, rid: str, path: str):
        status, retryable = _error_status(e)
        logger.warning("request %s %s failed (%d): %s",
                       rid, path, status, e)
        headers = {"X-Request-Id": rid}
        if retryable:
            headers["Retry-After"] = "1"
        return _json_response(
            {"error": str(e), "request_id": rid},
            status=status, headers=headers)

    async def _dispatch(self, request: _Request,
                        writer: asyncio.StreamWriter):
        rid = request.headers.get("X-Request-Id") or uuid.uuid4().hex
        app_name = self._match_route(request.path)
        if app_name is None:
            return _json_response(
                {"error": "no route", "request_id": rid}, status=404,
                headers={"X-Request-Id": rid})
        body = request.body
        try:
            arg = json.loads(body) if body else None
        except ValueError:
            return _json_response(
                {"error": "invalid JSON", "request_id": rid}, status=422,
                headers={"X-Request-Id": rid})
        # Bounded admission: shed beyond max_inflight with an explicit
        # 503 + Retry-After — the proxy stays responsive under overload
        # instead of parking every extra request on a 120 s blocking
        # executor wait.
        with self._inflight_lock:
            if self._inflight >= self._max_inflight:
                self._shed_total += 1
                shed = True
            else:
                self._inflight += 1
                shed = False
        if shed:
            logger.warning("request %s %s shed (inflight >= %d)",
                           rid, request.path, self._max_inflight)
            self._metrics["shed"].inc(1, {"app": app_name})
            self._metrics["requests"].inc(
                1, {"app": app_name, "status": "503"})
            return _json_response(
                {"error": "overloaded", "request_id": rid}, status=503,
                headers={"Retry-After": "1", "X-Request-Id": rid})
        # The request id IS the trace id: spans from every downstream
        # hop (handle routing, replica, engine ticks) join this trace,
        # and `ray-tpu serve trace <X-Request-Id>` renders the track.
        ctx = tracing.serve_ctx(rid)
        status = "500"
        try:
            with tracing.serve_span(ctx, "serve.proxy.request",
                                    app=app_name,
                                    path=request.path) as s:
                resp = await self._dispatch_admitted(
                    request, writer, arg, app_name, rid,
                    trace=tracing.child_ctx(ctx, s))
                status = str(resp.status)
                if s is not None:
                    s.attrs["status"] = resp.status
                return resp
        finally:
            self._metrics["requests"].inc(
                1, {"app": app_name, "status": status})
            with self._inflight_lock:
                self._inflight -= 1

    async def _dispatch_admitted(self, request: _Request,
                                 writer: asyncio.StreamWriter, arg,
                                 app_name: str, rid: str,
                                 trace: Optional[dict] = None):
        model_id = request.headers.get("X-Model-Id") or (
            arg.get("model_id") if isinstance(arg, dict) else None)
        stream = (request.query.get("stream") in ("1", "true")
                  or (isinstance(arg, dict) and arg.get("stream")))

        handle = self._handle_for(app_name)
        method = request.query.get("method") or (
            arg.get("method") if isinstance(arg, dict) else None)
        if model_id or method:
            handle = handle.options(
                multiplexed_model_id=model_id,
                method_name=method)
        loop = asyncio.get_running_loop()
        deadline = self._deadline_s

        if not stream:
            try:
                out = await loop.run_in_executor(
                    self._executor,
                    lambda: handle.remote(
                        arg, _request_id=rid, _trace=trace,
                    ).result(timeout=deadline))
            except Exception as e:  # noqa: BLE001
                return self._error_response(e, rid, request.path)
            return _json_response(out, headers={"X-Request-Id": rid})

        # Streaming: chunked JSONL, one line per yielded item. Routing
        # happens BEFORE headers go out so routing failures are clean
        # status codes, not truncated 200s.  Mid-stream replica death is
        # handled UNDER this loop by StreamingResponse's resume protocol;
        # only exhausted-failover errors surface here.
        try:
            stream_resp = await loop.run_in_executor(
                self._stream_executor,
                lambda: handle.remote_streaming(
                    arg, _request_id=rid, _trace=trace))
            it = iter(stream_resp)
        except Exception as e:  # noqa: BLE001
            return self._error_response(e, rid, request.path)

        resp = _StreamResponse(writer, {
            "Content-Type": "application/jsonl; charset=utf-8",
            "X-Request-Id": rid}, request.keep_alive)
        await resp.prepare()

        def pull_next():
            try:
                return next(it), False
            except StopIteration:
                return None, True

        n_items = 0
        n_bytes = 0
        t0 = time.time()
        try:
            while True:
                item, done = await loop.run_in_executor(
                    self._stream_executor, pull_next)
                if done:
                    break
                line = (json.dumps(item) + "\n").encode()
                n_items += 1
                n_bytes += len(line)
                await resp.write(line)
        except Exception as e:  # noqa: BLE001
            # Best-effort error line — the socket may already be gone
            # (client disconnect); the finally still cancels the stream.
            logger.warning("stream %s %s aborted: %s",
                           rid, request.path, e)
            try:
                await resp.write(
                    (json.dumps({"error": str(e), "request_id": rid})
                     + "\n").encode())
            except Exception:  # noqa: BLE001
                pass
        finally:
            stream_resp.cancel()  # idempotent; frees the replica stream
            # One span for the whole streamed body (per-batch spans come
            # from the replica's stream_next; this one carries totals +
            # how many failovers the resume protocol absorbed).
            tracing.record_serve_span(
                trace, "serve.proxy.stream", t0, items=n_items,
                bytes=n_bytes, resumes=stream_resp.resumes)
        try:
            await resp.write_eof()
        except Exception:  # noqa: BLE001
            pass
        return resp

    # -- actor RPC surface ----------------------------------------------
    def port(self) -> int:
        return self._port

    def proxy_stats(self) -> dict:
        with self._inflight_lock:
            return {"inflight": self._inflight,
                    "max_inflight": self._max_inflight,
                    "shed_total": self._shed_total}

    def set_route(self, prefix: str, app_name: str) -> bool:
        self._routes[prefix] = app_name
        return True

    def remove_route(self, prefix: str) -> bool:
        self._routes.pop(prefix, None)
        return True

    def remove_routes_for(self, app_name: str) -> bool:
        for prefix, app in list(self._routes.items()):
            if app == app_name:
                self._routes.pop(prefix, None)
        self._handles.pop(app_name, None)
        return True

    def stop(self) -> bool:
        self._metrics_push_stop.set()
        if self._loop is not None:
            server = getattr(self, "_server", None)
            if server is not None:
                self._loop.call_soon_threadsafe(server.close)
            self._loop.call_soon_threadsafe(self._loop.stop)
        return True
