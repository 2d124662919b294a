"""Runtime context introspection (ref: python/ray/runtime_context.py); a
copy of `ray_tpu/runtime_context.py`."""
from __future__ import annotations

import os
from typing import Optional


class RuntimeContext:
    def __init__(self, worker):
        self._worker = worker

    def get_node_id(self) -> str:
        return getattr(self._worker, "node_id", "local")

    def get_job_id(self) -> str:
        return getattr(self._worker, "job_id", "local")

    def get_worker_id(self) -> str:
        return getattr(self._worker, "address", "local")

    def get_pid(self) -> int:
        return os.getpid()

    def get_actor_id(self) -> Optional[str]:
        return getattr(self._worker, "current_actor_id", None)

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False


def get_runtime_context() -> RuntimeContext:
    from ray_tpu_torch.api import _global_worker

    return RuntimeContext(_global_worker())
