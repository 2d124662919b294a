"""Training backends of the port (counterpart of `ray_tpu.train`'s
backend hooks); the worker group that calls them is a runtime layer,
ported later."""
from ray_tpu_torch.train.backend import (
    BACKENDS, Backend, TorchBackend, resolve_backend)

__all__ = ["BACKENDS", "Backend", "TorchBackend", "resolve_backend"]
