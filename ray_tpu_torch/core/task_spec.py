"""Task/actor specifications and submission options, counterpart of
`ray_tpu/core/task_spec.py` with GPU demand in place of TPU demand.

Analogue of the reference TaskSpecification (ref: src/ray/common/task/
task_spec.h) and the per-task/actor option set centralized in
python/ray/_private/ray_option_utils.py.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ActorID, ObjectID, PlacementGroupID, TaskID


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2


class SchedulingStrategy:
    """Base for scheduling strategies (ref: python/ray/util/
    scheduling_strategies.py)."""


@dataclasses.dataclass
class DefaultSchedulingStrategy(SchedulingStrategy):
    pass


@dataclasses.dataclass
class SpreadSchedulingStrategy(SchedulingStrategy):
    pass


@dataclasses.dataclass
class NodeAffinitySchedulingStrategy(SchedulingStrategy):
    node_id: str = ""
    soft: bool = False


@dataclasses.dataclass
class PlacementGroupSchedulingStrategy(SchedulingStrategy):
    placement_group: Any = None  # PlacementGroup handle
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclasses.dataclass
class FunctionDescriptor:
    """Identifies a remote function/class; the pickled blob is exported once
    to the control plane's function table keyed by `function_hash`
    (ref: python/ray/_private/function_manager.py)."""

    module: str
    qualname: str
    function_hash: str

    def repr_name(self) -> str:
        return f"{self.module}.{self.qualname}"


@dataclasses.dataclass
class TaskOptions:
    num_cpus: Optional[float] = None
    num_tpus: Optional[float] = None  # accepted for API parity; mapped to GPU
    num_gpus: Optional[float] = None
    memory: Optional[int] = None
    resources: Dict[str, float] = dataclasses.field(default_factory=dict)
    num_returns: Any = 1    # int, or "streaming" (generator tasks)
    # Constrain scheduling to nodes advertising an accelerator type
    # (ref: accelerator_type= -> an "accelerator_type:X" resource
    # micro-demand; node daemons advertise theirs, accelerators.py).
    accelerator_type: Optional[str] = None
    # Retire the worker process after this many task executions (ref:
    # max_calls — bounds leaks from native/user code; 0 = unlimited).
    max_calls: int = 0
    max_retries: int = 3
    retry_exceptions: bool = False
    name: Optional[str] = None
    namespace: Optional[str] = None
    lifetime: Optional[str] = None  # None | "detached"
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    max_pending_calls: int = -1
    scheduling_strategy: Optional[SchedulingStrategy] = None
    runtime_env: Optional[Dict[str, Any]] = None
    concurrency_groups: Dict[str, int] = dataclasses.field(default_factory=dict)
    enable_task_events: bool = True
    _metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def resource_demand(self, default_cpus: float) -> Dict[str, float]:
        demand: Dict[str, float] = dict(self.resources)
        cpus = self.num_cpus if self.num_cpus is not None else default_cpus
        if cpus:
            demand["CPU"] = cpus
        gpus = self.num_gpus
        if gpus is None and self.num_tpus is not None:
            gpus = self.num_tpus
        if gpus:
            demand["GPU"] = gpus
        if self.memory:
            demand["memory"] = float(self.memory)
        if self.accelerator_type:
            demand[f"accelerator_type:{self.accelerator_type}"] = 0.001
        return demand


@dataclasses.dataclass
class TaskSpec:
    task_id: TaskID
    task_type: TaskType
    function: FunctionDescriptor
    # Serialized (args, kwargs) with top-level ObjectRefs replaced by markers.
    serialized_args: bytes
    arg_refs: List[ObjectID]  # refs the task depends on (top-level args)
    num_returns: int
    resources: Dict[str, float]
    options: TaskOptions
    caller_address: str = ""
    # Actor fields
    actor_id: Optional[ActorID] = None
    method_name: str = ""
    sequence_number: int = 0
    # Placement
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    # Retry bookkeeping
    attempt_number: int = 0

    def return_ids(self) -> List[ObjectID]:
        return [
            ObjectID.for_task_return(self.task_id, i)
            for i in range(1, self.num_returns + 1)
        ]
