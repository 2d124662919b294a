"""`@remote` function wrapper, counterpart of `ray_tpu/remote_function.py`.

Analogue of the reference RemoteFunction (ref: python/ray/remote_function.py;
`_remote` at :266 resolves options and submits through the core worker).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Union

from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import TaskOptions

_NO_DAG = (".bind() builds a DAG node; ray_tpu_torch has no DAG layer yet "
           "(ROADMAP queue A, item 10c)")


def _merge_options(base: TaskOptions, **updates) -> TaskOptions:
    known = {f.name for f in dataclasses.fields(TaskOptions)}
    clean: Dict[str, Any] = {}
    for k, v in updates.items():
        if k not in known:
            raise ValueError(f"Unknown option '{k}'")
        clean[k] = v
    return dataclasses.replace(base, **clean)


class RemoteFunction:
    def __init__(self, func, options: Optional[TaskOptions] = None):
        self._function = func
        self._options = options or TaskOptions()
        functools.update_wrapper(self, func)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._function.__qualname__}' cannot be called "
            "directly. Use '.remote(...)' instead."
        )

    def options(self, **updates) -> "RemoteFunction":
        return RemoteFunction(self._function,
                              _merge_options(self._options, **updates))

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        from ray_tpu_torch.api import _global_worker

        worker = _global_worker()
        if self._options.num_returns == "streaming":
            # Generator task: yields become refs consumable before the
            # task finishes (ref: ObjectRefGenerator, _raylet.pyx:272).
            return worker.submit_streaming_task(
                self._function, list(args), dict(kwargs), self._options)
        refs = worker.submit_task(self._function, list(args), dict(kwargs),
                                  self._options)
        if self._options.num_returns == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """A lazy DAG node (ref: python/ray/dag/dag_node.py): raises, the DAG
        layer comes with the serve control plane."""
        raise NotImplementedError(_NO_DAG)
