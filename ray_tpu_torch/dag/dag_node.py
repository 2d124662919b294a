"""Lazy task/actor DAGs, counterpart of `ray_tpu/dag/dag_node.py`.

Analogue of the reference DAG API (ref: python/ray/dag/dag_node.py —
DAGNode/InputNode/OutputNode; built by `.bind(...)` on remote
functions/classes/methods). `execute(input)` walks the graph, submits each
node as a task/actor call, and returns the root's ObjectRef(s).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """A node in a lazy computation graph."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- graph traversal ------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def execute(self, *input_args, **input_kwargs):
        """Execute the DAG rooted at this node; returns ObjectRef(s)."""
        cache: Dict[int, Any] = {}
        return self._execute(cache, input_args, input_kwargs)

    def _resolve_args(self, cache, input_args, input_kwargs):
        def res(v):
            if isinstance(v, DAGNode):
                return v._execute(cache, input_args, input_kwargs)
            return v

        args = [res(a) for a in self._bound_args]
        kwargs = {k: res(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute(self, cache, input_args, input_kwargs):
        key = id(self)
        if key not in cache:
            cache[key] = self._execute_impl(cache, input_args, input_kwargs)
        return cache[key]

    def _execute_impl(self, cache, input_args, input_kwargs):
        raise NotImplementedError

    # -- compiled (accelerated) DAG stub --------------------------------
    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG

        return CompiledDAG(self, **kwargs)


class InputNode(DAGNode):
    """Placeholder for the DAG's runtime input (ref: dag/input_node.py).

    Supports context-manager style: ``with InputNode() as inp: ...``.
    """

    def __init__(self, index: int = 0):
        super().__init__((), {})
        self._index = index

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_impl(self, cache, input_args, input_kwargs):
        return input_args[self._index]


class FunctionNode(DAGNode):
    def __init__(self, remote_function, args, kwargs):
        super().__init__(args, kwargs)
        self._rf = remote_function

    def _execute_impl(self, cache, input_args, input_kwargs):
        args, kwargs = self._resolve_args(cache, input_args, input_kwargs)
        return self._rf.remote(*args, **kwargs)


class ActorClassNode(DAGNode):
    """Lazy actor instantiation; materialized once per execute()."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls

    def _execute_impl(self, cache, input_args, input_kwargs):
        args, kwargs = self._resolve_args(cache, input_args, input_kwargs)
        return self._actor_cls.remote(*args, **kwargs)

    def __getattr__(self, name: str) -> "_BoundActorMethod":
        if name.startswith("_"):
            raise AttributeError(name)
        return _BoundActorMethod(self, name)


class _BoundActorMethod:
    """`actor_node.method` accessor so `.bind(...)` chains off lazy actors."""

    def __init__(self, actor_node: "ActorClassNode", method_name: str):
        self._actor_node = actor_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ActorMethodNode":
        return ActorMethodNode(self._actor_node, self._method_name, args,
                               kwargs)


class ActorMethodNode(DAGNode):
    def __init__(self, handle_or_node, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._target = handle_or_node
        self._method_name = method_name

    def _children(self) -> List["DAGNode"]:
        out = super()._children()
        if isinstance(self._target, DAGNode):
            out.append(self._target)
        return out

    def _execute_impl(self, cache, input_args, input_kwargs):
        target = self._target
        if isinstance(target, DAGNode):
            target = target._execute(cache, input_args, input_kwargs)
        args, kwargs = self._resolve_args(cache, input_args, input_kwargs)
        method = getattr(target, self._method_name)
        return method.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Groups several leaves as the DAG output (ref: dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _execute_impl(self, cache, input_args, input_kwargs):
        return [o._execute(cache, input_args, input_kwargs)
                for o in self._bound_args]
