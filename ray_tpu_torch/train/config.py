"""Train/AIR-substrate configs, counterpart of `ray_tpu/train/config.py`.

Equivalents of the reference's dataclass configs
(ref: python/ray/air/config.py — ScalingConfig/RunConfig/FailureConfig/
CheckpointConfig; python/ray/air/result.py — Result). `ScalingConfig`
asks for one card per worker by default (`use_gpu=True`: the port's
entry points run on the card unless the caller asks for the CPU) and
carries the mesh spec the workers build.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

from ray_tpu_torch.parallel.mesh import MeshConfig


@dataclasses.dataclass
class ScalingConfig:
    """How many workers, what each worker holds, and the mesh.

    num_workers: the gang's ranks, one card each with `use_gpu` (the
    backend then runs NCCL for CUDA tensors beside gloo); `use_gpu=False`
    runs them on the CPU over gloo.
    """
    num_workers: int = 1
    use_gpu: bool = True
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    topology: Optional[str] = None       # an opaque label of the gang
    mesh: Optional[MeshConfig] = None    # per-gang device mesh spec
    # Elastic bounds (train/elastic.py): when a replacement bundle never
    # materializes the supervisor may shrink the gang down to
    # `min_workers` (default 1) and grow it back up to `max_workers`
    # (default num_workers) when capacity returns.
    min_workers: Optional[int] = None
    max_workers: Optional[int] = None
    # Optional hint for the train-plane observability MFU estimate
    # (train/observability.py): total FLOPs one optimizer step performs
    # across the gang. The GCS TrainRunState turns it into achieved
    # FLOP/s (flops_per_step * step rate) and, when
    # RAY_TPU_TRAIN_OBS_PEAK_FLOPS is set, an MFU fraction.
    flops_per_step: Optional[float] = None

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        return {"GPU": 1.0} if self.use_gpu else {"CPU": 1.0}

    def world_bounds(self) -> "tuple[int, int]":
        lo = self.min_workers if self.min_workers is not None else 1
        hi = self.max_workers if self.max_workers is not None \
            else self.num_workers
        return max(1, lo), max(1, hi)


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0  # -1 = unlimited restarts
    # Elastic fault tolerance (train/elastic.py): instead of tearing the
    # whole gang down on one rank's death/hang, kill the flagged rank,
    # reserve a replacement bundle, and gang-restart from the latest
    # checkpoint — shrinking to a smaller world size when no
    # replacement capacity appears within `replace_timeout_s`.
    elastic: bool = False
    # None => the RAY_TPU_ELASTIC_* config knobs.
    replace_timeout_s: Optional[float] = None
    backoff_initial_s: Optional[float] = None
    backoff_max_s: Optional[float] = None
    backoff_multiplier: Optional[float] = None
    backoff_jitter: Optional[float] = None
    grow_check_s: Optional[float] = None
    # Per-rank poll deadline before the supervisor declares a rank hung
    # (None => RAY_TPU_HANG_THRESHOLD_S; the daemon-side watchdog uses
    # the same knob, so its verdicts and the supervisor's agree).
    hang_timeout_s: Optional[float] = None


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    # Experiment callbacks (ref: RunConfig.callbacks + air/integrations):
    # tune.callbacks.Callback instances invoked by the Tuner loop.
    callbacks: list = dataclasses.field(default_factory=list)
    verbose: int = 1

    def resolve_storage(self) -> str:
        base = self.storage_path or os.path.expanduser("~/ray_tpu_results")
        name = self.name or "train_run"
        return os.path.join(base, name)


@dataclasses.dataclass
class Result:
    """Outcome of a training run (ref: python/ray/air/result.py)."""
    metrics: Dict[str, Any]
    checkpoint: Optional["Checkpoint"]  # noqa: F821 (train.checkpoint)
    error: Optional[BaseException] = None
    metrics_history: list = dataclasses.field(default_factory=list)
    # The run's hyperparameter/train-loop config (ref: air/result.py
    # Result.config) — a real field set by both Tune and Trainer, not
    # smuggled through the metrics namespace.
    config: Optional[Dict[str, Any]] = None
    # Elastic-run accounting (train/elastic.py): per-cause restart
    # counts, shrink/grow events, and the final world size. None for
    # non-elastic runs.
    elastic: Optional[Dict[str, Any]] = None

    @property
    def best_checkpoint(self):
        return self.checkpoint
