"""HuggingFace Transformers integration for ray_tpu_torch.train,
counterpart of `ray_tpu/train/huggingface.py`.

Analogue of the reference glue (ref: python/ray/train/huggingface/
transformers/_transformers_utils.py — RayTrainReportCallback :30 bridges
transformers' logging into train.report; prepare_trainer :104 wires the
distributed context into the HF Trainer). transformers is optional: it is
looked up by name at import, and without it the callback is a plain
object. Used inside a TorchTrainer train loop:

    def train_loop(config):
        trainer = transformers.Trainer(...)
        trainer.add_callback(RayTrainReportCallback())
        trainer = prepare_trainer(trainer)
        trainer.train()
"""
from __future__ import annotations

import importlib
import os
import tempfile
from typing import Any, Optional

try:
    TrainerCallback = importlib.import_module(
        "transformers.trainer_callback").TrainerCallback
except ImportError:  # pragma: no cover — transformers not installed
    TrainerCallback = object


class RayTrainReportCallback(TrainerCallback):
    """Report HF Trainer logs (and checkpoints when HF saves one) to the
    ray_tpu_torch.train session (ref: _transformers_utils.py:30)."""

    def on_log(self, args, state, control, logs=None, **kwargs):
        if not logs:
            return
        from ray_tpu_torch.train.session import report

        metrics = {k: v for k, v in logs.items()
                   if isinstance(v, (int, float))}
        metrics.setdefault("step", state.global_step)
        metrics.setdefault("epoch", float(state.epoch or 0))
        try:
            report(metrics)
        except RuntimeError:
            pass  # not inside a train session (plain HF run): no-op

    def on_save(self, args, state, control, **kwargs):
        from ray_tpu_torch.train.checkpoint import Checkpoint
        from ray_tpu_torch.train.session import report

        ckpt_dir = os.path.join(
            args.output_dir, f"checkpoint-{state.global_step}")
        if not os.path.isdir(ckpt_dir):
            return
        try:
            report({"step": state.global_step,
                    "checkpoint_saved": 1.0},
                   checkpoint=Checkpoint(ckpt_dir))
        except RuntimeError:
            pass


def prepare_trainer(trainer: Any) -> Any:
    """Wire the distributed session context into an HF Trainer (ref:
    _transformers_utils.py:104): world size/rank come from the gang, and
    non-rank-0 workers silence their progress bars."""
    from ray_tpu_torch.train.session import get_context

    ctx = get_context()
    try:
        rank = ctx.get_world_rank()
        world = ctx.get_world_size()
    except RuntimeError:
        return trainer  # not inside a train session
    if rank != 0:
        # Progress/report callbacks are resolved inside Trainer.__init__
        # — mutating trainer.args after the fact does nothing; the
        # callbacks themselves must go (one progress bar / one wandb run
        # per gang, not per worker).
        try:
            callbacks = importlib.import_module(
                "transformers.trainer_callback")
            trainer.remove_callback(callbacks.ProgressCallback)
            trainer.remove_callback(callbacks.PrinterCallback)
            integrations = importlib.import_module(
                "transformers.integrations")

            for cb_cls in integrations.get_reporting_integration_callbacks(
                    trainer.args.report_to):
                trainer.remove_callback(cb_cls)
        except Exception:  # noqa: BLE001 transformers-version drift
            pass
        trainer.args.disable_tqdm = True
        if world > 1:
            # Per-worker output dirs under the TRIAL directory: stable
            # across fault-tolerant restarts (resume_from_checkpoint
            # finds prior checkpoints) and unique per trial. Concurrent
            # runs must use distinct RunConfig names — the trial dir
            # (checkpoints included) is shared per name, the same
            # contract the reference's storage layout has.
            try:
                base = ctx.get_trial_dir()
            except RuntimeError:
                base = tempfile.mkdtemp(prefix="hf_gang_")
            trainer.args.output_dir = os.path.join(
                base, f"hf_worker_{rank}")
            os.makedirs(trainer.args.output_dir, exist_ok=True)
    return trainer


def prepare_model(model: Any, device: Optional[str] = None) -> Any:
    """Torch-model preparation inside a gang (ref: train/torch/
    train_loop_utils.py:158 prepare_model — DDP/FSDP wrap). The
    TorchTrainer backend has already started the process group; this
    wraps in DDP when distributed is live with more than one rank, else
    returns the model unchanged."""
    import torch

    if device is not None:
        model = model.to(device)
    if torch.distributed.is_available() \
            and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        return DistributedDataParallel(model)
    return model
