"""RayActorManager: event-based actor + actor-task management; the port's
copy of `ray_tpu/air/execution/actor_manager.py`.

ref: python/ray/air/execution/_internal/actor_manager.py:23 (the event
manager Tune's controller runs on) and tracked_actor.py /
tracked_actor_task.py. Lean reimplementation over the ray_tpu_torch runtime:
actors start asynchronously, tasks resolve through their futures, and
every outcome is delivered as a sequential callback inside `next()`.
"""
from __future__ import annotations

import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

Callback = Optional[Callable[..., Any]]


def _ready_probe(_instance):
    """Module-level so plain pickle handles it (a lambda would force
    cloudpickle on every actor start)."""
    return True


class TrackedActor:
    """Handle for a manager-owned actor (ref: tracked_actor.py)."""

    __slots__ = ("actor_id", "_mgr")

    def __init__(self, actor_id: str, mgr: "RayActorManager"):
        self.actor_id = actor_id
        self._mgr = mgr

    @property
    def state(self) -> str:
        rec = self._mgr._actors.get(self.actor_id)
        return rec["state"] if rec else "REMOVED"

    def __repr__(self) -> str:
        return f"TrackedActor({self.actor_id[:8]}, {self.state})"


class RayActorManager:
    """Owns actor lifecycles + task futures; `next()` pumps events."""

    def __init__(self):
        self._actors: Dict[str, dict] = {}
        # (tracked, method, args, kwargs, on_result, on_error) futures.
        self._task_futs: List[Tuple[Any, dict]] = []
        self._pending_start: List[Tuple[Any, dict]] = []

    # -- queries --------------------------------------------------------
    @property
    def num_live_actors(self) -> int:
        return sum(1 for a in self._actors.values()
                   if a["state"] == "STARTED")

    @property
    def num_pending_actors(self) -> int:
        return sum(1 for a in self._actors.values()
                   if a["state"] == "PENDING")

    @property
    def num_pending_tasks(self) -> int:
        return len(self._task_futs)

    def live_actors(self) -> List[TrackedActor]:
        return [a["tracked"] for a in self._actors.values()
                if a["state"] == "STARTED"]

    # -- lifecycle ------------------------------------------------------
    def add_actor(self, cls, *, kwargs: Optional[dict] = None,
                  resources: Optional[Dict[str, float]] = None,
                  max_restarts: int = 0,
                  on_start: Callback = None, on_stop: Callback = None,
                  on_error: Callback = None) -> TrackedActor:
        """Request an actor. It starts asynchronously; `on_start(tracked)`
        fires from a later `next()` once its constructor completed."""
        import ray_tpu_torch

        actor_id = uuid.uuid4().hex
        tracked = TrackedActor(actor_id, self)
        opts = {"num_cpus": (resources or {}).get("CPU", 0),
                "max_restarts": max_restarts}
        custom = {k: v for k, v in (resources or {}).items() if k != "CPU"}
        if custom:
            opts["resources"] = custom
        remote_cls = ray_tpu_torch.remote(**opts)(cls)
        handle = remote_cls.remote(**(kwargs or {}))
        rec = {
            "tracked": tracked, "handle": handle, "state": "PENDING",
            "on_start": on_start, "on_stop": on_stop,
            "on_error": on_error,
        }
        self._actors[actor_id] = rec
        # Readiness probe (ref: the __ray_ready__ future): a no-op apply
        # through the actor's generic-call escape hatch — ActorHandle
        # hides dunder attributes, so go through ActorMethod directly.
        from ray_tpu_torch.actor import ActorMethod

        ready_ref = ActorMethod(handle, "__raytpu_apply__").remote(
            _ready_probe)
        self._pending_start.append((ready_ref.future(), rec))
        return tracked

    def remove_actor(self, tracked: TrackedActor) -> None:
        """Stop an actor; `on_stop(tracked)` fires from a later next()."""
        import ray_tpu_torch

        rec = self._actors.get(tracked.actor_id)
        if rec is None or rec["state"] in ("STOPPED", "FAILED"):
            return
        try:
            ray_tpu_torch.kill(rec["handle"])
        except Exception:  # noqa: BLE001
            pass
        rec["state"] = "STOPPED"
        rec["_stop_pending"] = True

    # -- tasks ----------------------------------------------------------
    def schedule_actor_task(self, tracked: TrackedActor, method: str,
                            args: tuple = (), kwargs: Optional[dict] = None,
                            *, on_result: Callback = None,
                            on_error: Callback = None) -> None:
        """Invoke `method` on the actor; exactly one of on_result(tracked,
        result) / on_error(tracked, exception) fires from a later next()."""
        rec = self._actors.get(tracked.actor_id)
        if rec is None:
            raise ValueError("actor is not tracked (removed?)")
        ref = getattr(rec["handle"], method).remote(*args,
                                                    **(kwargs or {}))
        self._task_futs.append((ref.future(), {
            "tracked": tracked, "on_result": on_result,
            "on_error": on_error}))

    # -- event pump -----------------------------------------------------
    def next(self, timeout: Optional[float] = 1.0) -> bool:
        """Process the next ready event (actor started / stopped / task
        finished); returns True if an event was handled. Callbacks run
        HERE, sequentially — never from background threads."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._pump_stops():
                return True
            if self._pump_starts():
                return True
            if self._pump_tasks():
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def _pump_stops(self) -> bool:
        for rec in self._actors.values():
            if rec.pop("_stop_pending", False):
                if rec["on_stop"]:
                    rec["on_stop"](rec["tracked"])
                return True
        return False

    def _pump_starts(self) -> bool:
        for i, (fut, rec) in enumerate(self._pending_start):
            if not fut.done():
                continue
            del self._pending_start[i]
            if rec["state"] == "STOPPED":
                return True  # removed before start completed
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 constructor failed
                rec["state"] = "FAILED"
                if rec["on_error"]:
                    rec["on_error"](rec["tracked"], e)
                return True
            rec["state"] = "STARTED"
            if rec["on_start"]:
                rec["on_start"](rec["tracked"])
            return True
        return False

    def _pump_tasks(self) -> bool:
        for i, (fut, ctx) in enumerate(self._task_futs):
            if not fut.done():
                continue
            del self._task_futs[i]
            tracked = ctx["tracked"]
            try:
                result = fut.result()
            except Exception as e:  # noqa: BLE001
                from ray_tpu_torch import exceptions as rexc

                # Only actor-death errors change the ACTOR's state; an
                # application exception is the task's problem alone.
                if isinstance(e, (rexc.ActorDiedError,
                                  rexc.ActorUnavailableError,
                                  rexc.WorkerCrashedError)):
                    rec = self._actors.get(tracked.actor_id)
                    if rec is not None and rec["state"] == "STARTED":
                        rec["state"] = "FAILED"
                        if rec["on_error"]:
                            rec["on_error"](tracked, e)
                if ctx["on_error"]:
                    ctx["on_error"](tracked, e)
                return True
            if ctx["on_result"]:
                ctx["on_result"](tracked, result)
            return True
        return False

    # -- teardown -------------------------------------------------------
    def shutdown(self) -> None:
        for rec in list(self._actors.values()):
            if rec["state"] in ("PENDING", "STARTED"):
                self.remove_actor(rec["tracked"])
        self._task_futs.clear()
        self._pending_start.clear()
