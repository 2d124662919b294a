"""Scheduling strategy classes (ref: python/ray/util/
scheduling_strategies.py); a copy of `ray_tpu/util/scheduling_strategies.py`."""
from ray_tpu_torch.core.task_spec import (
    DefaultSchedulingStrategy,
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SpreadSchedulingStrategy,
)

__all__ = [
    "DefaultSchedulingStrategy",
    "NodeAffinitySchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
    "SpreadSchedulingStrategy",
]
