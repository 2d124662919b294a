"""Actor classes and handles, counterpart of `ray_tpu/actor.py`.

Analogue of the reference's ActorClass/ActorHandle
(ref: python/ray/actor.py:563 ActorClass, :851 `_remote`, :1223 ActorHandle).
Actor method calls are ordered per-caller by default; `max_concurrency` and
async actors relax that (ref: transport/actor_scheduling_queue.h,
concurrency_group_manager.h).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Union

from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import TaskOptions
from ray_tpu_torch.remote_function import _merge_options


def method(*, concurrency_group: Optional[str] = None, **_ignored):
    """Method-level actor options (ref: python/ray/actor.py `ray.method`).

    Currently routes the method to a named concurrency group declared in
    `@remote(concurrency_groups={...})`; the group's pool bounds how many
    calls of its methods run at once, independently of other groups::

        @ray_tpu_torch.remote(concurrency_groups={"io": 2, "compute": 1})
        class A:
            @ray_tpu_torch.method(concurrency_group="io")
            def fetch(self): ...
    """

    def wrap(fn):
        if concurrency_group is not None:
            fn.__ray_tpu_concurrency_group__ = concurrency_group
        return fn

    return wrap


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly. "
            "Use '.remote(...)' instead."
        )

    def options(self, **updates) -> "ActorMethod":
        m = ActorMethod(self._handle, self._method_name, self._num_returns)
        # Merge over the method-level defaults (num_returns resets to the
        # method's own default, not the actor's creation options) and
        # validate against the full option schema so typos fail loudly.
        base = dataclasses.replace(self._handle._options,
                                   num_returns=self._num_returns)
        m._call_options = _merge_options(base, **updates)
        return m

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        from ray_tpu_torch.api import _global_worker

        worker = _global_worker()
        opts = getattr(self, "_call_options", None)
        if opts is None:
            # Cached: dataclasses.replace per call is measurable on the
            # submission hot path, and the defaults never change.
            opts = getattr(self, "_default_options", None)
            if opts is None:
                opts = dataclasses.replace(self._handle._options,
                                           num_returns=self._num_returns)
                self._default_options = opts
        refs = worker.submit_actor_task(
            self._handle._actor_id, self._method_name, list(args),
            dict(kwargs), opts)
        if opts.num_returns == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag.api import actor_method_bind

        return actor_method_bind(self._handle, self._method_name, args, kwargs)


class ActorHandle:
    def __init__(self, actor_id: ActorID, cls_name: str,
                 options: TaskOptions, method_names: List[str]):
        self._actor_id = actor_id
        self._cls_name = cls_name
        self._options = options
        self._method_names = method_names

    def __getattr__(self, item: str) -> ActorMethod:
        if item.startswith("_"):
            raise AttributeError(item)
        # Cache on the instance: __getattr__ only fires on a miss, so
        # repeated `handle.method` calls reuse one ActorMethod (and its
        # cached options) instead of allocating per call.
        method = ActorMethod(self, item)
        self.__dict__[item] = method
        return method

    def __repr__(self) -> str:
        return f"ActorHandle({self._cls_name}, {self._actor_id.hex()[:16]})"

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._cls_name, self._options,
             self._method_names),
        )

    @property
    def _ray_actor_id(self) -> ActorID:
        return self._actor_id


class ActorClass:
    def __init__(self, cls: type, options: Optional[TaskOptions] = None):
        self._cls = cls
        self._options = options or TaskOptions()
        self.__name__ = cls.__name__
        self.__qualname__ = getattr(cls, "__qualname__", cls.__name__)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated "
            "directly. Use '.remote(...)' instead."
        )

    def options(self, **updates) -> "ActorClass":
        return ActorClass(self._cls, _merge_options(self._options, **updates))

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch.api import _global_worker

        worker = _global_worker()
        actor_id = worker.create_actor(self._cls, list(args), dict(kwargs),
                                       self._options)
        methods = [m for m in dir(self._cls) if not m.startswith("__")]
        return ActorHandle(actor_id, self._cls.__name__, self._options,
                           methods)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag.api import actor_class_bind

        return actor_class_bind(self, args, kwargs)
