"""AIR substrate: shared configs + the actor/resource execution layer
(ref: python/ray/air/ — config.py, execution/)."""
from ray_tpu_torch.air.execution import RayActorManager, TrackedActor
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)

__all__ = [
    "ScalingConfig",
    "RunConfig",
    "FailureConfig",
    "CheckpointConfig",
    "RayActorManager",
    "TrackedActor",
]
