"""Serve controller: reconcile target deployment state against reality.

The port's copy of `ray_tpu/serve/controller.py`, importing `ray_tpu_torch`
only.

Reference: singleton `ServeController` actor with `DeploymentStateManager`
reconciliation (ref: python/ray/serve/_private/controller.py:84;
deployment_state.py:2397 manager, :1207 per-deployment loop) and
request-based autoscaling (ref: _private/autoscaling_policy.py:12).

Replicas are named detached actors ("serve:<app>:<dep>#<n>") so handles in
any process resolve them through the GCS named-actor registry — that is
this build's long-poll substitute: handles re-list replicas on a version
bump (ref: _private/long_poll.py:173 LongPollHost).
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.replica import Replica

CONTROLLER_NAME = "serve:controller"


def _worker_kv():
    """Best-effort handle to the GCS internal KV (None outside a
    cluster).  Backed by the GCS PersistentStore when the cluster runs
    with gcs_storage_dir, so serve state survives both controller death
    and GCS restart."""
    try:
        from ray_tpu_torch.api import _global_worker, is_initialized

        if not is_initialized():
            return None
        return _global_worker()
    except Exception:  # noqa: BLE001
        return None


class ServeController:
    """Runs inside a detached actor; reconciliation on a background thread."""

    def __init__(self):
        # app name -> target spec
        self._targets: Dict[str, dict] = {}
        # app name -> {"replicas": {replica_name: handle}, "version": int}
        self._state: Dict[str, dict] = {}
        self._lock = threading.RLock()
        self._stop = False
        self._last_scale: Dict[str, float] = {}
        # app -> {handle_id: (ongoing, monotonic ts)} — TTL'd in
        # _autoscale_signal so dead handles stop counting.
        self._handle_stats: Dict[str, Dict[str, tuple]] = {}
        from ray_tpu_torch.core.config import get_config

        self._handle_stats_ttl_s = get_config().serve_autoscale_stats_ttl_s
        # Last syncer-merged per-app replica gauges (None outside a
        # distributed cluster); refreshed once per reconcile tick.
        self._merged_gauges: Optional[Dict[str, dict]] = None
        # Startup bookkeeping: a replica whose constructor is still
        # running (model load + jit compile can take minutes) must not
        # be killed by the health probe — grace until its FIRST
        # successful check (ref: deployment initialization_timeout_s).
        self._started_at: Dict[str, float] = {}
        self._ready: set = set()
        self._startup_grace_s = get_config().serve_startup_grace_s
        self._health_timeout_s = get_config().serve_health_timeout_s
        self._drain_timeout_s = get_config().serve_drain_timeout_s
        # Retiring replica names -> wall deadline.  Entries block actor-
        # name reuse while the draining process may still be alive and
        # keep the name out of routing; they age out after the drain
        # window (the replica self-terminates at its own deadline).
        self._draining: Dict[str, float] = {}
        # Controller failover: a restarted controller rebuilds targets
        # from the GCS KV and ADOPTS still-running replicas instead of
        # redeploying the world.
        self._recover()
        self._thread = threading.Thread(target=self._reconcile_loop,
                                        daemon=True)
        self._thread.start()

    # ---- persistence / recovery (GCS KV, "serve" namespace) ----------
    def _persist_app(self, app_name: str) -> None:
        w = _worker_kv()
        if w is None:
            return
        try:
            import cloudpickle

            spec = self._targets.get(app_name)
            key = b"app:" + app_name.encode()
            if spec is None:
                w.kv_del("serve", key)
            else:
                # cloudpickle: deployment targets are often classes/
                # closures defined in driver scope, not importable names.
                w.kv_put("serve", key, cloudpickle.dumps(spec))
        except Exception:  # noqa: BLE001 persistence is best-effort
            pass

    def _recover(self) -> None:
        w = _worker_kv()
        if w is None:
            return
        try:
            keys = w.kv_keys("serve", b"app:")
        except Exception:  # noqa: BLE001
            return
        import cloudpickle

        for key in keys or []:
            try:
                blob = w.kv_get("serve", key)
                if not blob:
                    continue
                app = key[len(b"app:"):].decode()
                self._targets[app] = cloudpickle.loads(blob)
                self._state[app] = {"replicas": {}, "gens": {},
                                    "version": 0}
            except Exception:  # noqa: BLE001
                traceback.print_exc()
        if not self._targets:
            return
        # Adopt live replicas recorded in the last published status blob:
        # ping each named actor and re-take ownership of the healthy ones
        # (no duplicate replicas); dead ones are replaced by the first
        # reconcile tick.
        try:
            import json as _json

            blob = w.kv_get("serve", b"status")
            status = _json.loads(blob.decode()) if blob else {}
        except Exception:  # noqa: BLE001
            status = {}
        for app, info in status.items():
            st = self._state.get(app)
            if st is None:
                continue
            for name in info.get("replicas", []):
                try:
                    h = ray_tpu_torch.get_actor(name)
                    ray_tpu_torch.get(h.check_health.remote(), timeout=5)
                except Exception:  # noqa: BLE001
                    continue
                try:
                    gen = int(name.rsplit("#g", 1)[1].split("#", 1)[0])
                except (IndexError, ValueError):
                    gen = self._targets[app]["gen"]
                st["replicas"][name] = h
                st["gens"][name] = gen
                self._started_at[name] = time.monotonic()
                self._ready.add(name)
            st["version"] += 1

    # ---- API used by serve.run / handles -----------------------------
    def deploy(self, app_name: str, cls_or_fn, init_args, init_kwargs,
               config: dict) -> bool:
        with self._lock:
            prev = self._targets.get(app_name)
            gen = (prev["gen"] + 1) if prev else 1
            self._targets[app_name] = {
                "target": cls_or_fn, "args": init_args, "kwargs": init_kwargs,
                "config": config,
                "num_replicas": config["num_replicas"],
                "gen": gen,  # bump => rolling replace of old-code replicas
            }
            self._state.setdefault(app_name,
                                   {"replicas": {}, "gens": {}, "version": 0})
            self._state[app_name]["version"] += 1
            self._persist_app(app_name)
        return True

    def delete_app(self, app_name: str) -> bool:
        with self._lock:
            self._targets.pop(app_name, None)
            self._persist_app(app_name)
        return True

    def get_routing(self, app_name: str) -> dict:
        with self._lock:
            st = self._state.get(app_name)
            if st is None:
                return {"version": -1, "replicas": []}
            out: dict = {"version": st["version"],
                         "replicas": list(st.get("route",
                                                 st["replicas"]))}
            # Cluster-wide prefix registry read side: the syncer-merged
            # per-replica state (role + published prefix digests) maps
            # digest -> owning replica for the handle's prefix-affinity
            # routing.  Restricted to CURRENT replicas: a SIGKILLed or
            # retired replica's stale digests never route (belt) even
            # before the daemon's gauge TTL sweeps them (suspenders).
            merged = (self._merged_gauges or {}).get(app_name) or {}
            reps = merged.get("_replicas")
            if isinstance(reps, dict):
                live = set(out["replicas"])
                owners: Dict[str, str] = {}
                roles: Dict[str, str] = {}
                for rid, ent in reps.items():
                    if not isinstance(ent, dict):
                        continue
                    if ent.get("role"):
                        roles[rid] = str(ent["role"])
                    if rid not in live:
                        continue
                    if ent.get("block_size"):
                        out["kv_block_size"] = int(ent["block_size"])
                    for d in ent.get("prefixes") or ():
                        owners[str(d)] = rid
                if owners:
                    out["prefix_owners"] = owners
                if roles:
                    out["roles"] = roles
            return out

    def list_applications(self) -> List[str]:
        with self._lock:
            return list(self._targets)

    def app_status(self, app_name: str) -> dict:
        with self._lock:
            tgt = self._targets.get(app_name)
            st = self._state.get(app_name, {"replicas": {}, "version": 0})
            return {
                "running": len(st["replicas"]),
                # Constructor finished AND passed a health probe — what
                # "can serve a request right now" actually means.
                "ready": sum(1 for n in st["replicas"]
                             if n in self._ready),
                "target": tgt["num_replicas"] if tgt else 0,
                "version": st["version"],
            }

    def record_autoscale_stats(self, app_name: str, ongoing: float,
                               handle_id: Optional[str] = None) -> None:
        """Per-handle outstanding-count report.  Entries are TTL'd: a
        handle that stops reporting (caller exited, process died) ages
        out instead of pinning its last count into the autoscale signal
        forever.  Decisions happen in `_autoscale_tick` on the reconcile
        cadence, not here — one report must not flap the target."""
        with self._lock:
            per_handle = self._handle_stats.setdefault(app_name, {})
            per_handle[handle_id or "_anon"] = (float(ongoing),
                                                time.monotonic())

    def _autoscale_signal(self, app_name: str) -> Optional[float]:
        """Cluster-wide in-flight estimate for one app.  Preferred
        source: the syncer-merged replica gauges (one GCS RPC per tick,
        fetched by the caller) — replica-reported ongoing + engine queue
        depth.  Fallback: the TTL-filtered per-handle reports."""
        merged = (self._merged_gauges or {}).get(app_name)
        if merged and merged.get("replicas"):
            return (merged.get("ongoing", 0.0)
                    + merged.get("queue_depth", 0.0))
        per_handle = self._handle_stats.get(app_name)
        if not per_handle:
            return None
        now = time.monotonic()
        ttl = self._handle_stats_ttl_s
        for hid, (_, ts) in list(per_handle.items()):
            if now - ts > ttl:
                del per_handle[hid]
        if not per_handle:
            return None
        return sum(v for v, _ in per_handle.values())

    def _fetch_merged_gauges(self) -> None:
        """One `Serve.merged` RPC per reconcile tick (the syncer-fed
        view); local mode / standalone keeps the handle fallback."""
        self._merged_gauges = None
        try:
            from ray_tpu_torch.api import _global_worker, is_initialized

            if not is_initialized():
                return
            w = _global_worker()
            gcs = getattr(w, "gcs", None)
            if gcs is None:
                return
            # GCS load attribution: the controller's gauge poll is the
            # "serve-gauges" component, not generic client traffic.
            self._merged_gauges = gcs.call(
                "Serve", "merged", timeout=5,
                _caller=(getattr(w, "node_id", "") or "controller",
                         "serve-gauges"))
        except Exception:  # noqa: BLE001 gauge plane is best-effort
            self._merged_gauges = None

    def _autoscale_tick(self) -> None:
        self._fetch_merged_gauges()
        with self._lock:
            for app_name, tgt in self._targets.items():
                asc = tgt["config"].get("autoscaling_config")
                if not asc:
                    continue
                signal = self._autoscale_signal(app_name)
                if signal is None:
                    continue
                n = max(1, tgt["num_replicas"])
                per = signal / n
                now = time.time()
                last = self._last_scale.get(app_name, 0.0)
                if per > asc["target_ongoing_requests"] \
                        and n < asc["max_replicas"] \
                        and now - last > asc["upscale_delay_s"]:
                    tgt["num_replicas"] = n + 1
                    self._last_scale[app_name] = now
                    self._persist_app(app_name)
                elif per < asc["target_ongoing_requests"] / 2 \
                        and n > asc["min_replicas"] \
                        and now - last > asc["downscale_delay_s"]:
                    tgt["num_replicas"] = n - 1
                    self._last_scale[app_name] = now
                    self._persist_app(app_name)

    def shutdown(self) -> bool:
        self._stop = True
        with self._lock:
            self._targets.clear()
        # Clear persisted serve state: an intentional shutdown must not
        # be resurrected by the next controller's recovery pass.
        w = _worker_kv()
        if w is not None:
            try:
                for key in (w.kv_keys("serve", b"app:") or []):
                    w.kv_del("serve", key)
                w.kv_del("serve", b"routes")
            except Exception:  # noqa: BLE001
                pass
        self._reconcile_once()
        # Publish the now-empty snapshot: the loop exits on _stop, so
        # without this the dashboard would show the dead apps as
        # healthy forever (no controller left to correct the blob).
        self._publish_status()
        return True

    # ---- reconciliation ----------------------------------------------
    def _reconcile_loop(self):
        while not self._stop:
            try:
                self._autoscale_tick()
                self._reconcile_once()
                self._publish_status()
            except Exception:  # noqa: BLE001
                traceback.print_exc()
            time.sleep(0.25)

    def _publish_status(self) -> None:
        """Write a compact status blob to the GCS KV ("serve"/"status")
        so out-of-worker observers — the dashboard head, `ray-tpu
        status` — see app health without actor calls into this
        controller (ref: the reference's controller snapshots consumed
        by dashboard/modules/serve). Published only on change."""
        import json as _json

        with self._lock:  # RLock: app_status re-enters safely
            snap = {}
            merged = getattr(self, "_merged_gauges", None) or {}
            for app in self._targets:
                st = self._state.get(app,
                                     {"replicas": {}, "version": 0})
                snap[app] = {**self.app_status(app),
                             "replicas": sorted(st["replicas"])}
                # Observability ride-along: the syncer-fed per-app gauge
                # aggregate (queue depth, active, tokens/s, occupancy)
                # the autoscaler already fetched this tick.
                if merged.get(app):
                    snap[app]["gauges"] = merged[app]
        if snap == getattr(self, "_last_published", None):
            return
        self._last_published = snap
        try:
            from ray_tpu_torch.api import _global_worker

            _global_worker().kv_put(
                "serve", b"status",
                _json.dumps(snap, sort_keys=True).encode())
        except Exception:  # noqa: BLE001 best-effort observability
            pass

    def _reconcile_once(self):
        with self._lock:
            apps = dict(self._state)
            targets = dict(self._targets)
        # Age out drain records once the replica's own deadline (plus
        # slack for the exit itself) has certainly passed — their actor
        # names become reusable again.
        now_wall = time.monotonic()
        for name, dl in list(self._draining.items()):
            if now_wall > dl + 5.0:
                self._draining.pop(name, None)
        RemoteReplica = ray_tpu_torch.remote(Replica)

        for app, st in apps.items():
            tgt = targets.get(app)
            want = tgt["num_replicas"] if tgt else 0
            gen = tgt["gen"] if tgt else 0
            have = dict(st["replicas"])
            gens = dict(st.get("gens", {}))

            def _forget(name):
                have.pop(name, None)
                gens.pop(name, None)
                self._started_at.pop(name, None)
                self._ready.discard(name)

            def _kill(name):
                # Hard stop: health-failed replicas only (a wedged
                # process cannot drain).
                try:
                    ray_tpu_torch.kill(have[name])
                except Exception:  # noqa: BLE001
                    pass
                _forget(name)

            def _retire(name):
                # Graceful drain (downscale / redeploy): the replica
                # stops admission, finishes in-flight streams up to the
                # drain deadline, then exits on its own; routing drops it
                # at this tick's end, and still-attached streams
                # migrate-by-recompute through the handle resume path
                # when it exits.
                handle = have[name]
                self._draining[name] = (time.monotonic()
                                        + self._drain_timeout_s)
                try:
                    handle.drain.remote(self._drain_timeout_s)
                except Exception:  # noqa: BLE001 already dead
                    _kill(name)
                    return
                _forget(name)

            def _current():
                return [n for n in have if gens.get(n) == gen]

            # Replicas of an older deploy generation (a redeploy with new
            # code/args) keep serving until the new generation is ready,
            # below; a deleted app's go now.
            if not tgt:
                for name in list(have):
                    _retire(name)
            # scale down
            while len(_current()) > want:
                _retire(sorted(_current())[-1])
            # scale up (never reuse a name whose draining process may
            # still be alive)
            idx = 0
            while len(_current()) < want:
                while True:
                    name = f"serve:{app}#g{gen}#{idx}"
                    if name not in have and name not in self._draining:
                        break
                    idx += 1
                opts = dict(tgt["config"].get("ray_actor_options") or {})
                handle = RemoteReplica.options(
                    name=name, lifetime="detached",
                    max_concurrency=tgt["config"]["max_ongoing_requests"],
                    **opts,
                ).remote(tgt["target"], tgt["args"], tgt["kwargs"], name)
                have[name] = handle
                gens[name] = gen
                self._started_at[name] = time.monotonic()
            # health check: starting replicas get grace until their first
            # successful probe; after that a failed probe means dead.
            # Probes run CONCURRENTLY under one shared wall deadline
            # (bounded gather): all refs are submitted first, then
            # collected — one wedged replica costs the tick
            # serve_health_timeout_s total, not timeout x replicas.
            refs = {}
            for name in list(have):
                try:
                    refs[name] = have[name].check_health.remote()
                except Exception:  # noqa: BLE001
                    refs[name] = None
            now = time.monotonic()
            deadline = now + self._health_timeout_s
            for name, ref in refs.items():
                try:
                    if ref is None:
                        raise RuntimeError("health submit failed")
                    ray_tpu_torch.get(ref, timeout=max(
                        0.1, deadline - time.monotonic()))
                    self._ready.add(name)
                except Exception:  # noqa: BLE001
                    still_starting = (
                        name not in self._ready
                        and now - self._started_at.get(name, now)
                        < self._startup_grace_s)
                    if not still_starting:
                        _kill(name)
            # Retire the older generation once every replica of the new
            # one passed a probe. Until then routing holds only the old
            # replicas, so no request waits on a replica still starting
            # or meets one that is draining; retiring and publishing the
            # new routing happen in this one step.
            old = [n for n in have if gens.get(n) != gen]
            if old and sum(n in self._ready for n in _current()) >= want:
                for name in old:
                    _retire(name)
                old = []
            route = old or list(have)
            with self._lock:
                cur = self._state.setdefault(
                    app, {"replicas": {}, "gens": {}, "version": 0})
                if (set(cur["replicas"]) != set(have)
                        or cur.get("route") != route):
                    cur["version"] += 1
                cur["replicas"] = have
                cur["gens"] = gens
                cur["route"] = route
            if not tgt:
                with self._lock:
                    if not self._state[app]["replicas"]:
                        self._state.pop(app, None)


def get_or_create_controller():
    """Find the detached controller actor or start it."""
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:  # noqa: BLE001
        pass
    RemoteController = ray_tpu_torch.remote(ServeController)
    try:
        return RemoteController.options(
            name=CONTROLLER_NAME, lifetime="detached",
            max_concurrency=16).remote()
    except Exception:  # noqa: BLE001  (lost the creation race)
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
