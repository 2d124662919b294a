"""bind() entry points used by RemoteFunction/ActorClass/ActorMethod."""
from __future__ import annotations

from ray_tpu_torch.dag.dag_node import ActorClassNode, ActorMethodNode, FunctionNode


def function_bind(remote_function, *args, **kwargs) -> FunctionNode:
    return FunctionNode(remote_function, args, kwargs)


def actor_class_bind(actor_cls, args, kwargs) -> ActorClassNode:
    return ActorClassNode(actor_cls, args, kwargs)


def actor_method_bind(handle, method_name, args, kwargs) -> ActorMethodNode:
    return ActorMethodNode(handle, method_name, args, kwargs)
