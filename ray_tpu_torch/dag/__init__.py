"""Task and actor DAGs (counterpart of `ray_tpu.dag`): `.bind()` builds
the nodes, `execute` submits them, `experimental_compile` turns the graph
into stage loops over channels (`compiled_dag.py`)."""
from ray_tpu_torch.dag.dag_node import (
    DAGNode,
    FunctionNode,
    ActorClassNode,
    ActorMethodNode,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "DAGNode",
    "FunctionNode",
    "ActorClassNode",
    "ActorMethodNode",
    "InputNode",
    "MultiOutputNode",
]
