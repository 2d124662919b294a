"""Event-driven actor execution layer shared by the AIR libraries.

ref: python/ray/air/execution/_internal/actor_manager.py:23
RayActorManager — the reference centralizes actor lifecycle + task
tracking for Tune/Train behind one event-based manager, so elastic
trials and failure handling live in ONE place instead of three bespoke
controllers. Same contract here:

    mgr = RayActorManager()
    tracked = mgr.add_actor(ActorClass, kwargs={...},
                            resources={"CPU": 1},
                            on_start=..., on_stop=..., on_error=...)
    mgr.schedule_actor_task(tracked, "step", on_result=..., on_error=...)
    while mgr.num_live_actors or mgr.num_pending_tasks:
        mgr.next(timeout=1.0)     # control is yielded explicitly;
                                  # callbacks run sequentially here

No background threads: `next()` drives everything (the reference makes
the same choice — deterministic callback ordering beats async fan-out
for a training control loop).
"""
from ray_tpu_torch.air.execution.actor_manager import RayActorManager, TrackedActor

__all__ = ["RayActorManager", "TrackedActor"]
