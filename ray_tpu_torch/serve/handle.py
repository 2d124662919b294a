"""DeploymentHandle + power-of-two-choices routing.

The port's copy of `ray_tpu/serve/handle.py`, importing `ray_tpu_torch`
only.

Reference: `DeploymentHandle`/`DeploymentResponse` (ref:
python/ray/serve/handle.py:694,436) and
`PowerOfTwoChoicesReplicaScheduler` (ref: _private/replica_scheduler/
pow_2_scheduler.py:49): sample two replicas, pick the lower queue.  Queue
depth here is the handle's own outstanding-count per replica (cheap local
signal), refreshed against controller routing state on version change.
"""
from __future__ import annotations

import random
import threading
import time
import uuid
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.controller import get_or_create_controller
from ray_tpu_torch.util import tracing


def _retry_backoff(attempt: int) -> float:
    """Capped exponential + jitter between replica-failure retries
    (RAY_TPU_SERVE_RETRY_BACKOFF_*, same shape as the elastic-train
    gang-restart backoff)."""
    from ray_tpu_torch.core.config import get_config

    cfg = get_config()
    delay = min(cfg.serve_retry_backoff_max_s,
                cfg.serve_retry_backoff_initial_s
                * cfg.serve_retry_backoff_multiplier ** attempt)
    jitter = cfg.serve_retry_backoff_jitter
    return max(0.0, delay * (1 + random.uniform(-jitter, jitter)))


def _retryable_errors():
    import ray_tpu_torch.exceptions as rexc

    return (rexc.ActorDiedError, rexc.ActorUnavailableError,
            rexc.ReplicaDrainingError)


def _rails_ring():
    """Decode on rails, reader side: pre-create a shm ring on THIS node
    (reads are a local mmap poll, exactly the compiled DAG's placement
    rule) and describe it for the replica's writer endpoint — a
    same-host replica mmaps the path, a cross-host one pushes versioned
    frames through this node's daemon.  Returns None when rails are off
    or the ring can't be built (the stream then admits on RPC pulls)."""
    from ray_tpu_torch.core.config import get_config

    cfg = get_config()
    if not cfg.serve_rails_enabled:
        return None
    try:
        from ray_tpu_torch.experimental.channel import Channel

        ch = Channel.create(1, capacity=cfg.serve_rails_capacity_bytes)
    except Exception:  # noqa: BLE001 — no /dev/shm etc.
        return None
    addr = None
    try:
        from ray_tpu_torch.api import _global_worker

        addr = getattr(_global_worker(), "daemon_address", None)
    except Exception:  # noqa: BLE001 local mode
        addr = None
    return {"ch": ch,
            "desc": {"path": ch.path, "capacity": ch.capacity,
                     "n_readers": ch.n_readers, "n_slots": ch.n_slots,
                     "daemon_address": addr}}


class DeploymentResponse:
    """Future-like wrapper over the underlying ObjectRef.

    Replica death between routing and completion is retried through the
    handle (refresh + re-pick), like the reference router's transparent
    replica-failure retries (ref: _private/router.py).  Attempts and
    backoff come from RAY_TPU_SERVE_RETRY_MAX /
    RAY_TPU_SERVE_RETRY_BACKOFF_*; a draining replica (graceful
    downscale) is retried the same way as a dead one."""

    def __init__(self, ref, on_done=None, retry_fn=None):
        self._ref = ref
        self._on_done = on_done
        self._retry_fn = retry_fn
        self._done = False

    def result(self, timeout: Optional[float] = None) -> Any:
        from ray_tpu_torch.core.config import get_config

        attempts = max(1, get_config().serve_retry_max)
        try:
            for attempt in range(attempts):
                try:
                    out = ray_tpu_torch.get(self._ref, timeout=timeout)
                    break
                except _retryable_errors():
                    if self._retry_fn is None or attempt == attempts - 1:
                        raise
                    time.sleep(_retry_backoff(attempt))
                    self._ref = self._retry_fn()
        finally:
            self._settle()
        return out

    def _settle(self):
        if not self._done and self._on_done:
            self._done = True
            self._on_done()

    def _to_object_ref(self):
        return self._ref


def _rebuild_handle(app: str, method: str, model_id, stream
                    ) -> "DeploymentHandle":
    h = DeploymentHandle(app, method)
    h._model_id = model_id
    h._stream = bool(stream)
    return h


class DeploymentHandle:
    def __init__(self, app_name: str, method_name: str = "__call__"):
        self._app = app_name
        self._method = method_name
        self._controller = get_or_create_controller()
        self._version = -2
        self._replicas: Dict[str, Any] = {}
        self._outstanding: Dict[str, int] = {}
        self._lock = threading.Lock()
        # Stable id for controller-side per-handle stats (TTL'd there:
        # when this handle goes away its count ages out).
        self._handle_id = uuid.uuid4().hex
        self._last_stats_push = 0.0
        self._last_refresh = 0.0
        self._refresh_ttl = 0.5
        self._model_id: Optional[str] = None
        self._stream = False
        # model_id -> replica name that recently served it (multiplexed
        # locality, ref: pow_2_scheduler.py multiplex-aware candidates).
        self._model_affinity: Dict[str, str] = {}
        # Cluster-wide prefix registry read side (serve/disagg.py):
        # aligned-prefix digest -> owning replica, refreshed with the
        # routing table; prefix-warm requests prefer the owner.
        self._prefix_owners: Dict[str, str] = {}
        self._kv_block_size = 0

    def __reduce__(self):
        # Handles cross process boundaries by RECONSTRUCTION, not state
        # copy: a replica receiving a handle as an init arg (deployment
        # graph composition) resolves the controller and routing table
        # in its own process (ref: serve handles pickle the same way).
        # Options set via .options() (model affinity, streaming) are
        # part of the handle's contract and must survive the trip.
        return (_rebuild_handle, (self._app, self._method,
                                  self._model_id, self._stream))

    # handle.method_name.remote(...) sugar
    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return DeploymentHandle.__new_method(self, item)

    @staticmethod
    def __new_method(parent: "DeploymentHandle", method: str):
        h = DeploymentHandle.__new__(DeploymentHandle)
        h.__dict__.update(parent.__dict__)
        h._method = method
        return h

    def options(self, *, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None, **_ignored):
        h = self
        if method_name:
            h = DeploymentHandle.__new_method(h, method_name)
        if multiplexed_model_id is not None or stream is not None:
            if h is self:
                h = DeploymentHandle.__new_method(self, self._method)
            if multiplexed_model_id is not None:
                h._model_id = multiplexed_model_id
            if stream is not None:
                h._stream = stream
        return h

    def _refresh(self, force: bool = False):
        # TTL throttle: the controller round-trip must not be on every
        # request's critical path (the long-poll analogue).
        now = time.monotonic()
        if not force and now - self._last_refresh < self._refresh_ttl:
            return
        self._last_refresh = now
        try:
            routing = ray_tpu_torch.get(
                self._controller.get_routing.remote(self._app), timeout=30)
        except Exception:  # noqa: BLE001
            # Controller died: re-resolve (get_or_create restarts it; the
            # new one recovers targets from the GCS KV and re-adopts live
            # replicas).  Version counters reset across controller
            # incarnations, so force a routing rebuild.  If the
            # controller plane is entirely down, keep serving from the
            # cached replica set rather than failing the request path.
            try:
                self._controller = get_or_create_controller()
                routing = ray_tpu_torch.get(
                    self._controller.get_routing.remote(self._app),
                    timeout=30)
                force = True
                self._version = -2
            except Exception:  # noqa: BLE001
                if self._replicas:
                    return
                raise
        with self._lock:
            # Owner map updates on EVERY refresh (replicas publish new
            # prefixes without a routing-version bump).
            self._prefix_owners = routing.get("prefix_owners") or {}
            self._kv_block_size = int(routing.get("kv_block_size") or 0)
            if routing["version"] != self._version or force:
                names = routing["replicas"]
                self._replicas = {}
                for n in names:
                    try:
                        self._replicas[n] = ray_tpu_torch.get_actor(n)
                    except Exception:  # noqa: BLE001
                        pass
                self._outstanding = {n: self._outstanding.get(n, 0)
                                     for n in self._replicas}
                self._version = routing["version"]

    def _prefix_hint(self, args, kwargs):
        """Prefix-affinity routing input: the replica (if any) that owns
        registered KV blocks for this request's longest aligned token
        prefix.  Returns (owner_or_None, applicable) — `applicable` is
        True when the request was token-shaped and the registry had a
        block size to align against (so the caller can count
        remote_prefix_hit/miss only for requests that could match)."""
        from ray_tpu_torch.core.config import get_config

        if not get_config().serve_prefix_registry_enabled:
            return None, False
        with self._lock:
            owners = dict(self._prefix_owners)
            bs = self._kv_block_size
        req = (args[0] if args and isinstance(args[0], dict)
               else kwargs.get("request"))
        tokens = (req or {}).get("tokens") if isinstance(req, dict) else None
        if not tokens or not isinstance(tokens, (list, tuple)) or not bs:
            return None, False
        if not owners:
            return None, True
        from ray_tpu_torch.serve.disagg import request_digests

        # Longest covered prefix first: route to the replica holding
        # the deepest warm chain.
        for _, digest in request_digests(list(tokens), bs):
            rid = owners.get(digest)
            if rid:
                return rid, True
        return None, True

    def _count_prefix_route(self, prefer, applicable, pick) -> None:
        if not applicable:
            return
        try:
            from ray_tpu_torch.serve import observability

            observability.count_kv_event(
                self._app, "remote_prefix_hit"
                if prefer is not None and pick == prefer
                else "remote_prefix_miss")
        except Exception:  # noqa: BLE001 best-effort telemetry
            pass

    def _pick_replica(self, exclude: Optional[str] = None,
                      prefer: Optional[str] = None):
        deadline = time.monotonic() + 30
        while True:
            # Sample and index under one lock hold — a concurrent _refresh
            # may rebuild self._replicas between reads otherwise.
            with self._lock:
                names = list(self._replicas)
                # Failover re-picks avoid the replica that just failed —
                # unless it is the only one left (it may have restarted).
                if exclude in names and len(names) > 1:
                    names.remove(exclude)
                if names:
                    pick = None
                    # Multiplexed locality: prefer the replica that already
                    # holds this model (avoids a reload), unless it is
                    # clearly the most loaded one.
                    if self._model_id:
                        cand = self._model_affinity.get(self._model_id)
                        if cand in names:
                            load = self._outstanding.get(cand, 0)
                            if load <= 2 + min(
                                    (self._outstanding.get(n, 0)
                                     for n in names), default=0):
                                pick = cand
                    # Prefix affinity: the replica already holding this
                    # request's KV blocks skips the prefill entirely —
                    # worth following unless it is clearly overloaded
                    # (same guard as model affinity).
                    if pick is None and prefer in names:
                        load = self._outstanding.get(prefer, 0)
                        if load <= 2 + min(
                                (self._outstanding.get(n, 0)
                                 for n in names), default=0):
                            pick = prefer
                    if pick is None:
                        if len(names) == 1:
                            pick = names[0]
                        else:
                            a, b = random.sample(names, 2)
                            pick = (a if self._outstanding.get(a, 0)
                                    <= self._outstanding.get(b, 0) else b)
                        if self._model_id:
                            self._model_affinity[self._model_id] = pick
                            while len(self._model_affinity) > 1024:
                                self._model_affinity.pop(
                                    next(iter(self._model_affinity)))
                    self._outstanding[pick] = \
                        self._outstanding.get(pick, 0) + 1
                    return pick, self._replicas[pick]
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no replicas for app {self._app!r} after 30s")
            self._refresh(force=True)
            time.sleep(0.1)

    def _push_stats(self):
        now = time.time()
        if now - self._last_stats_push < 1.0:
            return
        self._last_stats_push = now
        total = sum(self._outstanding.values())
        try:
            self._controller.record_autoscale_stats.remote(
                self._app, total, handle_id=self._handle_id)
        except Exception:  # noqa: BLE001
            pass

    def remote(self, *args, **kwargs):
        if self._stream:
            return self.remote_streaming(*args, **kwargs)
        # Reserved keys ride the kwargs channel from the proxy (popped
        # here so user callables never see them); direct handle calls
        # mint their own request id so `ray-tpu serve trace` works
        # without the HTTP front.
        request_id = kwargs.pop("_request_id", None) or uuid.uuid4().hex
        ctx = kwargs.pop("_trace", None) or tracing.serve_ctx(request_id)
        self._refresh()
        prefer, applicable = self._prefix_hint(args, kwargs)
        with tracing.serve_span(ctx, "serve.handle.route",
                                app=self._app, method=self._method) as s:
            name, replica = self._pick_replica(prefer=prefer)
            trace = tracing.child_ctx(ctx, s)
        self._count_prefix_route(prefer, applicable, name)
        self._push_stats()
        # Mutable cell: retries re-route to a new replica; on_done must
        # decrement whichever replica CURRENTLY carries the request.
        holder = {"name": name}

        def on_done():
            with self._lock:
                n = holder["name"]
                self._outstanding[n] = max(0, self._outstanding.get(n, 1) - 1)

        def retry():
            on_done()  # release the failed pick before re-picking
            self._refresh(force=True)
            with tracing.serve_span(ctx, "serve.handle.resume",
                                    app=self._app, resumed=1):
                name2, replica2 = self._pick_replica()
            holder["name"] = name2
            return replica2.handle_request.remote(
                self._method, args, kwargs, model_id=self._model_id,
                trace=trace)

        try:
            ref = replica.handle_request.remote(
                self._method, args, kwargs, model_id=self._model_id,
                trace=trace)
        except Exception:
            # replica may have just died; refresh and retry once
            ref = retry()
        return DeploymentResponse(ref, on_done, retry_fn=retry)

    def remote_streaming(self, *args, **kwargs) -> "StreamingResponse":
        """Streaming call: the replica runs a generator; items arrive in
        pulled batches (ref: streaming ObjectRefGenerator replies,
        proxy.py:747 streaming responses).  The response carries a
        request id and its emitted-item offset; replica death mid-stream
        fails over to a surviving replica via the resume protocol
        (re-admit args + emitted prefix, dedupe the overlap)."""
        # The request id doubles as the trace id; a proxy-minted one
        # arrives via the reserved `_request_id`/`_trace` kwargs, direct
        # handle users get a fresh one (same id the resume protocol and
        # `ray-tpu serve trace` key on).
        request_id = kwargs.pop("_request_id", None) or uuid.uuid4().hex
        ctx = kwargs.pop("_trace", None) or tracing.serve_ctx(request_id)
        self._refresh()
        prefer, applicable = self._prefix_hint(args, kwargs)
        with tracing.serve_span(ctx, "serve.handle.route",
                                app=self._app, method=self._method) as s:
            name, replica = self._pick_replica(prefer=prefer)
            trace = tracing.child_ctx(ctx, s)
        self._count_prefix_route(prefer, applicable, name)
        self._push_stats()
        # Mutable cell: failovers re-route to a new replica; on_done must
        # decrement whichever replica CURRENTLY carries the stream.
        holder = {"name": name}

        def on_done():
            with self._lock:
                n = holder["name"]
                self._outstanding[n] = max(0, self._outstanding.get(n, 1) - 1)

        def resume_fn(emitted):
            failed = holder["name"]
            on_done()  # release the failed pick before re-picking
            self._refresh(force=True)
            with tracing.serve_span(ctx, "serve.handle.resume",
                                    app=self._app, resumed=1,
                                    offset=len(emitted)) as rs:
                name2, replica2 = self._pick_replica(exclude=failed)
                trace2 = tracing.child_ctx(ctx, rs)
            holder["name"] = name2
            self._push_stats()
            try:
                from ray_tpu_torch.serve import observability

                observability.metrics()["resumes"].inc(
                    1, {"app": self._app})
            except Exception:  # noqa: BLE001 best-effort telemetry
                pass
            sid_ref2 = replica2.handle_request_streaming.remote(
                self._method, args, kwargs, model_id=self._model_id,
                resume={"request_id": request_id,
                        "offset": len(emitted), "items": list(emitted)},
                trace=trace2)
            return replica2, sid_ref2

        rails = _rails_ring()
        sid_ref = replica.handle_request_streaming.remote(
            self._method, args, kwargs, model_id=self._model_id,
            trace=trace,
            **({"rails": rails["desc"]} if rails else {}))
        return StreamingResponse(replica, sid_ref, on_done,
                                 resume_fn=resume_fn,
                                 request_id=request_id, rails=rails)


class StreamingResponse:
    """Iterator over a replica-side stream; batches pulls to amortize the
    per-call RPC cost.

    Fault tolerance: the response keeps the items it has already yielded
    (the resume prefix).  When the serving replica dies, becomes
    unreachable, or refuses admission because it is draining, the
    iterator re-admits the request on another replica with
    `resume={"offset": N, "items": [...]}` — the engine recomputes KV
    for prompt + emitted tokens and continues from there — so consumers
    (including the HTTP proxy mid-stream) observe one exactly-once item
    sequence across the failover."""

    def __init__(self, replica, sid_ref, on_done, max_items: int = 32,
                 resume_fn=None, request_id: Optional[str] = None,
                 rails: Optional[dict] = None):
        self._replica = replica
        self._sid_ref = sid_ref
        self._sid = None
        self._on_done = on_done
        self._max_items = max_items
        self._settled = False
        self._resume_fn = resume_fn
        self._emitted: list = []
        self._rails = rails        # {"ch": Channel, "desc": {...}} | None
        self._rails_offset = 0     # items landed over the ring so far
        self.rails = False         # pull mode currently in effect
        self.rails_used = False    # ever attached (survives the spill)
        self.request_id = request_id or uuid.uuid4().hex
        self.resumes = 0  # failovers survived (observability/tests)

    def _settle(self):
        if not self._settled:
            self._settled = True
            if self._on_done:
                self._on_done()

    def _drop_rails(self):
        """Release the ring (normal end, cancel, or spill to RPC).  The
        replica-side pump observes the close as ChannelClosedError on
        its next write and retires its lane slot."""
        r, self._rails = self._rails, None
        self.rails = False
        if r is not None:
            try:
                r["ch"].close()
                r["ch"].unlink()
            except Exception:  # noqa: BLE001
                pass

    def __del__(self):
        self._drop_rails()

    def cancel(self):
        if self._settled:
            return  # already finished or cancelled
        if self._sid is not None:
            try:
                self._replica.cancel_stream.remote(self._sid)
            except Exception:  # noqa: BLE001
                pass
        self._drop_rails()
        self._settle()

    def _rails_next(self, pull_timeout: float) -> dict:
        """One pull over the ring: poll in short slices, probing replica
        liveness on idle slices so a SIGKILLed replica surfaces as the
        same typed error the RPC path would raise (-> resume ladder).
        Error frames re-raise in-band: retryable ones (draining, died)
        resume, user exceptions propagate to the consumer."""
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.experimental.channel import (
            ChannelClosedError, ChannelTimeoutError)
        import ray_tpu_torch.exceptions as rexc

        cfg = get_config()
        deadline = time.monotonic() + pull_timeout
        next_probe = time.monotonic() + cfg.serve_rails_probe_s
        while True:
            try:
                frame = self._rails["ch"].read(
                    timeout=cfg.serve_rails_tick_s, reader_idx=0)
            except ChannelTimeoutError:
                now = time.monotonic()
                if now >= deadline:
                    raise TimeoutError(
                        f"rails stream idle for {pull_timeout}s")
                if now >= next_probe:
                    ray_tpu_torch.get(self._replica.check_health.remote(),
                                      timeout=cfg.serve_rails_probe_s + 5.0)
                    next_probe = time.monotonic() + cfg.serve_rails_probe_s
                continue
            except ChannelClosedError:
                raise rexc.ActorUnavailableError(
                    "rails ring closed under a live stream")
            err = frame.get("err") if isinstance(frame, dict) else None
            if err is not None:
                raise err
            if int(frame.get("o", -1)) != self._rails_offset:
                # Out-of-order frame: never expected from the versioned
                # ring — treat as lane loss, not silent corruption.
                raise rexc.ActorUnavailableError(
                    f"rails frame offset {frame.get('o')} != "
                    f"{self._rails_offset}")
            self._rails_offset += len(frame["items"])
            return frame

    def __iter__(self):
        from ray_tpu_torch.core.config import get_config

        cfg = get_config()
        pull_timeout = cfg.serve_request_deadline_s
        max_resumes = max(1, cfg.serve_retry_max)
        try:
            while True:
                try:
                    if self._sid is None:
                        sid = ray_tpu_torch.get(self._sid_ref,
                                                timeout=pull_timeout)
                        if isinstance(sid, dict):
                            self.rails = (bool(sid.get("rails"))
                                          and self._rails is not None)
                            self.rails_used |= self.rails
                            sid = sid["sid"]
                        self._sid = sid
                        if not self.rails:
                            self._drop_rails()  # admission-time spill
                    if self.rails:
                        batch = self._rails_next(pull_timeout)
                    else:
                        batch = ray_tpu_torch.get(
                            self._replica.stream_next.remote(
                                self._sid, max_items=self._max_items),
                            timeout=pull_timeout)
                except _retryable_errors():
                    # Lane loss / drain / replica death: spill to the
                    # ordinary RPC path and re-admit through the resume
                    # protocol (PR 9 machinery, unchanged) — the emitted
                    # prefix pins the exactly-once sequence.
                    self._drop_rails()
                    if (self._resume_fn is None
                            or self.resumes >= max_resumes):
                        raise
                    time.sleep(_retry_backoff(self.resumes))
                    self.resumes += 1
                    self._sid = None
                    self._replica, self._sid_ref = \
                        self._resume_fn(self._emitted)
                    continue
                for item in batch["items"]:
                    self._emitted.append(item)
                    yield item
                if batch["done"]:
                    return
        finally:
            self._drop_rails()
            self._settle()
