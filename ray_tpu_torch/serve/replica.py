"""Replica actor: hosts one copy of the user callable.

The port's copy of `ray_tpu/serve/replica.py`, importing `ray_tpu_torch`
only.

Reference: `ReplicaActor` + `UserCallableWrapper`
(ref: python/ray/serve/_private/replica.py:230, :716).  Tracks ongoing
request count (feeds the power-of-two router), exposes a health check,
serves STREAMING responses (generator results pulled in batches — the
analogue of the reference's streaming ObjectRefGenerator replies,
_raylet.pyx:272), and carries the multiplexed-model-id request context
(ref: serve/multiplex.py).
"""
from __future__ import annotations

import asyncio
import inspect
import pickle
import queue
import threading
import time
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch.serve.multiplex import _model_id_ctx
from ray_tpu_torch.util import tracing


class _Stream:
    """Background puller: drains the user generator into a queue so the
    actor thread never blocks inside user iteration code. The request's
    multiplexed-model-id context is re-established in the puller thread
    (generator bodies run HERE, not where the generator was created)."""

    def __init__(self, iterator, model_id: Optional[str] = None,
                 ctx: Optional[dict] = None, resumed: bool = False):
        self.ctx = ctx          # serve trace context (None = untraced)
        self.resumed = resumed
        self.q: "queue.Queue" = queue.Queue(maxsize=256)
        self.error: Optional[BaseException] = None
        self.finished = threading.Event()
        self.cancelled = threading.Event()
        self.last_touch = time.monotonic()

        def pull():
            if model_id:
                _model_id_ctx.set(model_id)
            try:
                for item in iterator:
                    while True:
                        if self.cancelled.is_set():
                            close = getattr(iterator, "close", None)
                            if callable(close):
                                close()
                            return
                        try:
                            self.q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # noqa: BLE001
                self.error = e
            finally:
                self.finished.set()

        threading.Thread(target=pull, daemon=True).start()

    def next_batch(self, max_items: int, timeout_s: float) -> dict:
        self.last_touch = time.monotonic()
        items = []
        deadline = time.monotonic() + timeout_s
        while len(items) < max_items:
            try:
                remaining = max(0.0, deadline - time.monotonic())
                items.append(self.q.get(
                    timeout=remaining if not items else 0.0))
            except queue.Empty:
                if items or self.finished.is_set():
                    break
                if time.monotonic() >= deadline:
                    break
        done = (self.finished.is_set() and self.q.empty())
        if done and self.error is not None:
            raise self.error
        return {"items": items, "done": done}


class _RailsLane:
    """Pre-leased writer lane for rails streams: the serve analogue of a
    compiled-DAG stage host.  Replicas are actors, so — like the
    compiled DAG's ActorMethodNode stages, which run their loop inside
    the actor rather than on a separate leased worker — the decode tick
    loop is pinned HERE: a bounded set of dedicated pump threads, each
    dedicated to one stream for its life.  The width bound is the lane's
    lease: attach requests past it spill to the RPC pull path at
    admission (a mid-stream stage never loses its slot)."""

    def __init__(self, width: int):
        self.width = max(0, int(width))
        self._sem = threading.Semaphore(self.width)
        self._lock = threading.Lock()
        self.active = 0
        self.attached_total = 0
        self.spilled_total = 0

    def try_attach(self) -> bool:
        if self.width <= 0 or not self._sem.acquire(blocking=False):
            with self._lock:
                self.spilled_total += 1
            return False
        with self._lock:
            self.active += 1
            self.attached_total += 1
        return True

    def release(self) -> None:
        with self._lock:
            self.active -= 1
        self._sem.release()

    def stats(self) -> dict:
        with self._lock:
            return {"width": self.width, "active": self.active,
                    "attached_total": self.attached_total,
                    "spilled_total": self.spilled_total}


def _rails_writer(desc: dict):
    """Per-edge transport selection, mirroring the compiled DAG's
    `_writer_endpoint`: the ring always lives on the READER's (handle's)
    node, so a same-host replica mmaps it directly and a cross-host one
    pushes versioned raw frames through that node's daemon."""
    import os

    from ray_tpu_torch.experimental.channel import Channel, RemoteChannelWriter

    if os.path.exists(desc["path"]):
        return Channel(desc["path"], desc["capacity"], desc["n_readers"],
                       desc["n_slots"])
    addr = desc.get("daemon_address")
    if not addr:
        return None
    return RemoteChannelWriter(addr, desc["path"], desc["capacity"],
                               desc["n_readers"], desc["n_slots"])


class Replica:
    def __init__(self, cls_or_fn, init_args, init_kwargs, replica_id: str):
        self.replica_id = replica_id
        self._ongoing = 0
        self._total = 0
        self._start = time.time()
        self._streams: Dict[str, _Stream] = {}
        self._rails: Optional[_RailsLane] = None
        self._rails_lock = threading.Lock()
        self._draining = False
        # replica_id format: "serve:<app>#g<gen>#<idx>"
        self._app = replica_id.split(":", 1)[-1].split("#", 1)[0]
        # method name -> whether the resolved target accepts the
        # replica-injected `_serve_resume` / `_serve_trace` context.
        self._resume_aware: Dict[str, bool] = {}
        self._trace_aware: Dict[str, bool] = {}
        if inspect.isclass(cls_or_fn):
            self._callable = cls_or_fn(*init_args, **init_kwargs)
            self._is_func = False
        else:
            self._callable = cls_or_fn
            self._is_func = True
        ctx_hook = getattr(self._callable, "set_serve_context", None)
        if callable(ctx_hook):
            try:
                ctx_hook(self._app, replica_id)
            except Exception:  # noqa: BLE001 context is best-effort
                pass
        self._gauge_stop = threading.Event()
        threading.Thread(target=self._gauge_loop, daemon=True).start()

    # -- autoscaling gauges ---------------------------------------------
    def _gauge_loop(self, period_s: float = 1.0) -> None:
        """Push this replica's gauges (ongoing count + whatever the user
        callable's `engine_gauges()` reports, e.g. the paged engine's
        queue depth / KV occupancy) to the LOCAL node daemon; the
        daemon's syncer delta carries the aggregate to the GCS, where
        the controller reads one merged per-app view per autoscale tick
        instead of polling replicas."""
        app = self._app
        while not self._gauge_stop.wait(period_s):
            try:
                from ray_tpu_torch.api import _global_worker, is_initialized

                if not is_initialized():
                    continue
                daemon = getattr(_global_worker(), "daemon", None)
                if daemon is None:  # local mode: no daemon, no syncer
                    return
                gauges = {"ongoing": float(self._ongoing),
                          "streams": float(len(self._streams))}
                hook = getattr(self._callable, "engine_gauges", None)
                if callable(hook):
                    for k, v in (hook() or {}).items():
                        gauges[k] = float(v)
                # Fold the hosted engine's cumulative stats into this
                # process's metric registry, then piggyback the whole
                # registry dump on the gauge push — the daemon merges
                # it into its federation payload so serve histograms /
                # KV counters reach `ray-tpu metrics --federated`
                # without a second RPC plane.
                from ray_tpu_torch.serve import observability
                from ray_tpu_torch.util.metrics import registry_dump

                eng = getattr(self._callable, "engine", None)
                if eng is not None and hasattr(eng, "engine_stats"):
                    observability.mirror_engine(eng, app)
                # Disagg role + published prefix digests ride the same
                # push (the cluster-wide prefix registry's write side).
                state = None
                sthook = getattr(self._callable, "serve_state", None)
                if callable(sthook):
                    try:
                        state = sthook() or None
                    except Exception:  # noqa: BLE001
                        state = None
                # Rails pull mode rides the same state payload so
                # `ray-tpu serve status` renders compiled/fallback per
                # replica next to the disagg role.
                if self._rails is not None:
                    from ray_tpu_torch.core.config import get_config

                    rs = self._rails.stats()
                    rs["mode"] = ("compiled"
                                  if get_config().serve_rails_enabled
                                  else "fallback")
                    state = dict(state or {}, rails=rs)
                daemon.call("NodeDaemon", "report_serve_gauges",
                            app=app, replica=self.replica_id,
                            gauges=gauges, metrics=registry_dump(),
                            state=state, timeout=2)
            except Exception:  # noqa: BLE001 best-effort telemetry
                continue

    def _resolve(self, method: str):
        if self._is_func or method == "__call__":
            return self._callable
        return getattr(self._callable, method)

    def _invoke(self, method: str, args: tuple, kwargs: dict,
                model_id: Optional[str]) -> Any:
        token = _model_id_ctx.set(model_id) if model_id else None
        try:
            out = self._resolve(method)(*args, **kwargs)
            if inspect.iscoroutine(out):
                out = asyncio.run(out)
            return out
        finally:
            if token is not None:
                _model_id_ctx.reset(token)

    def _check_admission(self) -> None:
        if self._draining:
            from ray_tpu_torch.exceptions import ReplicaDrainingError

            raise ReplicaDrainingError(self.replica_id)

    def handle_request(self, method: str, args: tuple, kwargs: dict,
                       model_id: Optional[str] = None,
                       trace: Optional[dict] = None) -> Any:
        self._check_admission()
        self._ongoing += 1
        self._total += 1
        try:
            with tracing.serve_span(trace, "serve.replica.request",
                                    replica=self.replica_id,
                                    method=method) as s:
                if trace and self._accepts_kw(method, "_serve_trace",
                                              self._trace_aware):
                    inj = tracing.child_ctx(trace, s)
                    kwargs = dict(kwargs, _serve_trace=(
                        dict(inj, app=self._app) if inj else None))
                return self._invoke(method, args, kwargs, model_id)
        finally:
            self._ongoing -= 1

    # -- streaming ------------------------------------------------------
    def _accepts_kw(self, method: str, kw: str,
                    cache: Dict[str, bool]) -> bool:
        """Whether the resolved target accepts the replica-injected
        keyword `kw` (explicitly or via **kwargs); cached per method."""
        cached = cache.get(method)
        if cached is not None:
            return cached
        try:
            params = inspect.signature(self._resolve(method)).parameters
            ok = (kw in params
                  or any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in params.values()))
        except (TypeError, ValueError):
            ok = False
        cache[method] = ok
        return ok

    def _accepts_resume(self, method: str) -> bool:
        return self._accepts_kw(method, "_serve_resume",
                                self._resume_aware)

    def handle_request_streaming(self, method: str, args: tuple,
                                 kwargs: dict,
                                 model_id: Optional[str] = None,
                                 resume: Optional[dict] = None,
                                 trace: Optional[dict] = None,
                                 rails: Optional[dict] = None):
        """Start a streaming call; returns a stream id the caller pulls
        with stream_next().

        `resume` carries a failed-over stream's already-delivered prefix
        ({"offset": n, "items": [...]}).  Resume-aware callables (those
        accepting `_serve_resume`, e.g. LLMDeployment.stream) get it
        injected and recompute only the continuation; for everything
        else the generator is re-run and the first `offset` items are
        skipped server-side — either way the caller appends an
        exactly-once continuation.

        `rails` is a handle-created ring descriptor (decode on rails):
        when the lane attaches, frames push to the caller over the
        channel plane instead of stream_next pulls, and the reply is
        {"sid": ..., "rails": True/False} so the caller knows which pull
        mode this stream runs in.  A refused attach (kill switch off,
        lane at width, no route to the ring) is an admission-time spill:
        the stream serves normally over RPC."""
        self._check_admission()
        self._total += 1
        if resume and resume.get("request_id"):
            self._maybe_adopt_migration(resume)
        # Trace continuity across failover: a resumed stream keeps the
        # ORIGINAL request id as its trace id (the resume dict carries
        # it) so the whole request renders as one perfetto track; the
        # resumed=1 attribute marks post-failover spans.
        if resume and resume.get("request_id"):
            trace = tracing.serve_ctx(resume["request_id"],
                                      (trace or {}).get("span_id"),
                                      resumed=1) or trace
        attrs = {"replica": self.replica_id, "method": method}
        if resume:
            attrs["resumed"] = 1
            attrs["offset"] = int(resume.get("offset", 0))
        skip = 0
        if resume and self._accepts_resume(method):
            kwargs = dict(kwargs, _serve_resume=resume)
        elif resume:
            skip = int(resume.get("offset", 0))
        with tracing.serve_span(trace, "serve.replica.request",
                                **attrs) as s:
            if trace and self._accepts_kw(method, "_serve_trace",
                                          self._trace_aware):
                inj = tracing.child_ctx(trace, s)
                kwargs = dict(kwargs, _serve_trace=(
                    dict(inj, app=self._app) if inj else None))
            out = self._invoke(method, args, kwargs, model_id)
        if not hasattr(out, "__next__"):
            out = iter(out if hasattr(out, "__iter__") else [out])
        if skip > 0:
            import itertools

            out = itertools.islice(out, skip, None)
        sid = uuid.uuid4().hex
        self._gc_streams()
        st = _Stream(out, model_id=model_id,
                     ctx=trace, resumed=bool(resume))
        self._streams[sid] = st
        self._ongoing += 1
        if rails is not None:
            return {"sid": sid, "rails": self._rails_attach(sid, st, rails)}
        return sid

    # -- decode on rails ------------------------------------------------
    def _rails_lane(self) -> _RailsLane:
        with self._rails_lock:
            if self._rails is None:
                from ray_tpu_torch.core.config import get_config

                self._rails = _RailsLane(
                    get_config().serve_rails_max_streams)
            return self._rails

    def _rails_attach(self, sid: str, st: _Stream, desc: dict) -> bool:
        """Pin this stream onto the rails lane: open the writer endpoint
        to the handle's ring and dedicate a pump thread.  Any failure is
        an admission-time spill (return False, stream stays on RPC)."""
        from ray_tpu_torch.core.config import get_config

        if not get_config().serve_rails_enabled:
            return False
        lane = self._rails_lane()
        if not lane.try_attach():
            return False
        writer = None
        try:
            writer = _rails_writer(desc)
        except Exception:  # noqa: BLE001 bad descriptor / daemon gone
            writer = None
        if writer is None:
            lane.release()
            with lane._lock:
                lane.spilled_total += 1
            return False
        threading.Thread(target=self._rails_pump,
                         args=(sid, st, writer, lane), daemon=True).start()
        return True

    def _rails_pump(self, sid: str, st: _Stream, writer, lane: _RailsLane):
        """Pinned rails stage loop (the serve analogue of the compiled
        DAG's `_compiled_node_loop`): drain the stream's decode ticks
        into offset-tagged frames over versioned channel writes.  Errors
        ship in-band ({"err": e}); the reader decides whether they are
        retryable (drain/death -> resume over RPC) or terminal."""
        from ray_tpu_torch.experimental.channel import (
            ChannelClosedError, ChannelTimeoutError)

        def put(frame) -> bool:
            # The ring's slot window is the backpressure bound: a slow
            # consumer blocks the write, not the stream drop — retry
            # short slices until the stream itself is torn down.
            while True:
                try:
                    writer.write(frame, timeout=5.0)
                    return True
                except ChannelTimeoutError:
                    if st.cancelled.is_set():
                        return False
                except (ChannelClosedError, Exception):  # noqa: BLE001
                    return False

        offset = 0
        try:
            while True:
                try:
                    batch = st.next_batch(max_items=32, timeout_s=0.2)
                except BaseException as e:  # noqa: BLE001
                    try:
                        pickle.dumps(e)
                    except Exception:  # noqa: BLE001
                        e = RuntimeError(repr(e))
                    put({"err": e})
                    return
                n = len(batch["items"])
                if n or batch["done"]:
                    t0 = time.time()
                    if not put({"o": offset, "items": batch["items"],
                                "done": batch["done"]}):
                        return
                    offset += n
                    if n:
                        tracing.record_serve_span(
                            st.ctx, "serve.replica.rails_frame", t0,
                            items=n, done=batch["done"])
                if batch["done"]:
                    return
        finally:
            self._drop_stream(sid)
            lane.release()
            # The handle owns the ring's lifecycle; a cross-host writer
            # only needs its daemon RPC client released.
            client = getattr(writer, "_client", None)
            if client is not None:
                try:
                    client.close()
                except Exception:  # noqa: BLE001
                    pass

    # -- live KV migration (serve/disagg.py) ----------------------------
    def _maybe_adopt_migration(self, resume: dict) -> None:
        """Warm-migration consume side: a draining replica published
        this stream's KV blocks as a ticket keyed by request id; adopt
        them into the local engine BEFORE the resumed context re-admits,
        so the engine's prefix hit covers the shipped blocks and
        recompute shrinks to the un-shipped tail.  Every failure path
        degrades to the ordinary recompute-as-extended-prompt resume."""
        from ray_tpu_torch.core.config import get_config

        if not get_config().serve_kv_migrate_enabled:
            return
        adopt = getattr(self._callable, "adopt_kv", None)
        if not callable(adopt):
            return
        eng = getattr(self._callable, "engine", None)
        try:
            from ray_tpu_torch.serve import observability
            from ray_tpu_torch.serve.disagg import consume_migration_ticket

            t0 = time.time()
            ticket = consume_migration_ticket(resume["request_id"])
            if ticket is None:
                return
            adopt(ticket["tokens"], ticket["kv"], ticket["block_size"],
                  source="migrate")
            observability.observe_kv_migrate(
                self._app, max(0.0, time.time()
                               - float(ticket.get("ts") or time.time())))
            tracing.record_serve_span(
                tracing.serve_ctx(resume["request_id"]),
                "serve.kv.migrate", t0, time.time(), side="adopt",
                replica=self.replica_id,
                tokens=len(ticket["tokens"]))
        except Exception:  # noqa: BLE001 KVMigrationError / transport
            if eng is not None and hasattr(eng, "stats"):
                try:
                    eng.stats["migrate_fallbacks"] += 1
                except Exception:  # noqa: BLE001
                    pass

    def _export_migration_tickets(self) -> int:
        """Warm-migration publish side (drain path): snapshot every
        in-flight engine stream's KV blocks into GCS-KV tickets so the
        survivors can adopt instead of recompute."""
        from ray_tpu_torch.core.config import get_config

        if not get_config().serve_kv_migrate_enabled:
            return 0
        eng = getattr(self._callable, "engine", None)
        exp = getattr(eng, "export_streams", None)
        if not callable(exp):
            return 0
        try:
            from ray_tpu_torch.serve.disagg import publish_migration_tickets

            return publish_migration_tickets(self.replica_id, exp())
        except Exception:  # noqa: BLE001 degrade to recompute resume
            return 0

    def stream_next(self, stream_id: str, max_items: int = 32,
                    timeout_s: float = 1.0) -> dict:
        st = self._streams.get(stream_id)
        if st is None:
            return {"items": [], "done": True}
        t0 = time.time()
        try:
            batch = st.next_batch(max_items, timeout_s)
        except BaseException:
            self._drop_stream(stream_id)
            raise
        if batch["items"] or batch["done"]:
            # One span per DELIVERED batch (empty polls are elided so a
            # slow generator doesn't flood the trace with idle waits).
            attrs = {"items": len(batch["items"]), "done": batch["done"]}
            if st.resumed:
                attrs["resumed"] = 1
            tracing.record_serve_span(st.ctx, "serve.replica.stream_next",
                                      t0, **attrs)
            if batch["items"]:
                from ray_tpu_torch.serve import observability

                observability.observe_phase(self._app, "stream_transport",
                                            time.time() - t0)
        if batch["done"]:
            self._drop_stream(stream_id)
        return batch

    def cancel_stream(self, stream_id: str) -> bool:
        self._drop_stream(stream_id)
        return True

    def _drop_stream(self, stream_id: str) -> None:
        st = self._streams.pop(stream_id, None)
        if st is not None:
            st.cancelled.set()  # unblocks + closes the puller's generator
            self._ongoing = max(0, self._ongoing - 1)

    def _gc_streams(self, idle_s: float = 300.0) -> None:
        now = time.monotonic()
        for sid, st in list(self._streams.items()):
            if now - st.last_touch > idle_s:
                self._drop_stream(sid)

    def drain(self, timeout_s: Optional[float] = None) -> dict:
        """Stop admission and retire this replica gracefully: in-flight
        requests/streams keep running up to `timeout_s` (default
        RAY_TPU_SERVE_DRAIN_TIMEOUT_S), then the process exits.  Clients
        still attached past the deadline observe ActorDiedError and
        migrate-by-recompute through the handle's stream-resume path.
        Self-terminating: a controller that dies right after sending the
        drain RPC leaks no orphan replica."""
        from ray_tpu_torch.core.config import get_config

        knobs = get_config()
        if timeout_s is None:
            timeout_s = knobs.serve_drain_timeout_s
        first = not self._draining
        self._draining = True
        migrated = 0
        if first and self._streams and knobs.serve_kv_migrate_enabled:
            # Live migration: publish every in-flight stream's KV blocks
            # as tickets, then fail the streams with the typed draining
            # error — attached clients drain what's already queued, hit
            # the error, and the handle's resume path re-admits them on
            # a survivor that adopts the shipped blocks (recompute stays
            # the fallback for anything without a ticket).
            migrated = self._export_migration_tickets()
            from ray_tpu_torch.exceptions import ReplicaDrainingError

            for st in list(self._streams.values()):
                st.error = ReplicaDrainingError(self.replica_id)
                st.cancelled.set()
                st.finished.set()

        def reaper():
            import os

            deadline = time.monotonic() + max(0.0, float(timeout_s))
            while time.monotonic() < deadline:
                if self._ongoing <= 0 and not self._streams:
                    break
                time.sleep(0.1)
            # Linger so in-flight stream_next RPCs observe the typed
            # draining error (and fresh tickets get consumed) before
            # the process exits out from under them.
            if migrated:
                time.sleep(max(0.0, knobs.serve_kv_migrate_linger_s))
            self._gauge_stop.set()
            self._teardown_callable()
            # os._exit skips the core worker's shutdown, which sends its
            # batched frees: send them first, or what this replica owned
            # and dropped (an actor call's return, as a disagg prefill's
            # frame) stays in the node's store.
            from ray_tpu_torch import api

            flush = (getattr(api._global_worker(), "flush_frees", None)
                     if api.is_initialized() else None)
            if flush is not None:
                flush()
            os._exit(0)

        if first:
            threading.Thread(target=reaper, daemon=True).start()
        return dict(self.stats(), migrated_tickets=migrated)

    def _teardown_callable(self) -> None:
        """Graceful exit runs the deployment's own `__del__` (as the
        reference's replica shutdown does), so what it holds outside this
        process (an engine's arena in the node's object store) is given
        back before the process exits under it. The JAX package's replica
        exits without it and leaves the arena in the store."""
        fin = getattr(type(self._callable), "__del__", None)
        if self._is_func or fin is None:
            return
        try:
            fin(self._callable)
        except Exception:  # noqa: BLE001 teardown is best-effort
            pass

    def stats(self) -> dict:
        out = {"replica_id": self.replica_id, "ongoing": self._ongoing,
               "total": self._total, "streams": len(self._streams),
               "draining": self._draining,
               "uptime": time.time() - self._start}
        if self._rails is not None:
            out["rails"] = self._rails.stats()
        return out

    def getpid(self) -> int:
        """Worker-process pid — lets chaos tooling SIGKILL the actual
        process (crash semantics) rather than an actor-level kill."""
        import os

        return os.getpid()

    def check_health(self) -> bool:
        user_check = getattr(self._callable, "check_health", None)
        if callable(user_check):
            user_check()
        return True

    def reconfigure(self, user_config: Any) -> None:
        hook = getattr(self._callable, "reconfigure", None)
        if callable(hook):
            hook(user_config)
