"""ray_tpu_torch.train: distributed training orchestration (reference:
ray.train), counterpart of `ray_tpu.train`.

Gang-scheduled worker groups, session reporting, checkpointing
(torch.distributed.checkpoint), fault-tolerant and elastic restart, with
a torch.distributed group (NCCL on the card, gloo on the CPU) as the
parallelism substrate: `TorchTrainer` is the flagship, where the JAX
package has `JaxTrainer`.
"""
from ray_tpu_torch.train.backend import (
    BACKENDS, Backend, TorchBackend, resolve_backend)
from ray_tpu_torch.train.checkpoint import Checkpoint, load_pytree, save_pytree
from ray_tpu_torch.train.config import (CheckpointConfig, FailureConfig, Result,
                                        RunConfig, ScalingConfig)
from ray_tpu_torch.train.session import (get_checkpoint, get_context,
                                         get_dataset_shard, phase, report,
                                         step_phases)
from ray_tpu_torch.train.trainer import DataParallelTrainer, TorchTrainer

__all__ = [
    "Checkpoint", "save_pytree", "load_pytree",
    "ScalingConfig", "RunConfig", "FailureConfig", "CheckpointConfig",
    "Result",
    "report", "get_checkpoint", "get_context", "get_dataset_shard",
    "step_phases", "phase",
    "DataParallelTrainer", "TorchTrainer", "TorchBackend",
    "BACKENDS", "Backend", "resolve_backend",
]

# Usage tagging (ref: usage_lib.record_library_usage; local-only,
# see ray_tpu_torch/util/usage_stats.py)
from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu

_rlu("train")
del _rlu
