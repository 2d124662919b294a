"""Utilities over the task/actor core (counterpart of `ray_tpu.util`):
placement groups, scheduling strategies, ActorPool and Queue."""
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)

__all__ = [
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "placement_group_table",
]
