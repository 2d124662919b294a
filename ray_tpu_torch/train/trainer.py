"""Trainers: gang-launch a train loop, drain reports, restart on failure.
Counterpart of `ray_tpu/train/trainer.py`, with `TorchTrainer` (a
torch.distributed group over the gang, NCCL on the card) as the flagship
where the JAX package has `JaxTrainer`.

Reference call stack being reproduced (SURVEY.md §3.3): `BaseTrainer.fit`
→ BackendExecutor.start (PG gang) → WorkerGroup of train workers →
session report queue → fault-tolerant restart from latest checkpoint
(ref: python/ray/train/base_trainer.py:567 fit;
_internal/backend_executor.py:121 start, :690 _restart;
data_parallel_trainer.py DataParallelTrainer).  The Tune wrapping
(fit-as-a-trial) is optional here instead of mandatory.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train import observability as train_obs
from ray_tpu_torch.train.backend import Backend, TorchBackend, resolve_backend
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (FailureConfig, Result, RunConfig,
                                  ScalingConfig)
from ray_tpu_torch.train.elastic import (RESTARTS_TOTAL, RestartBackoff,
                                   classify_failure)
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


class DataParallelTrainer:
    """Run `train_loop_per_worker` on a gang of workers.

    backend_name: "torch" (a torch.distributed group: NCCL and one card
    per rank with `ScalingConfig.use_gpu`, else gloo on the CPU), or None
    (no process-group setup — single-host or pure-orchestration).
    `use_gpu=True` (the default) on a machine without a CUDA device
    raises: the trainer never falls back to the CPU."""

    backend_name: Optional[str] = None

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        backend: Optional[str] = "__class_default__",
    ):
        self._fn = train_loop_per_worker
        self._config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self._resume = resume_from_checkpoint
        if backend != "__class_default__":
            self.backend_name = backend
        if self.scaling_config.use_gpu:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ScalingConfig(use_gpu=True): no CUDA device; pass "
                    "use_gpu=False to train on the CPU")

    def _backend(self) -> Backend:
        """The gang's backend: "torch" takes its device from
        `ScalingConfig.use_gpu`."""
        if self.backend_name == "torch":
            return TorchBackend(
                "cuda" if self.scaling_config.use_gpu else "cpu")
        return resolve_backend(self.backend_name)

    # -- dataset sharding ----------------------------------------------
    def _shard_fn(self, rank: int, world: int) -> Optional[Dict[str, Any]]:
        if not self.datasets:
            return None
        shards = {}
        for name, ds in self.datasets.items():
            shard = getattr(ds, "shard", None)
            if callable(shard) and hasattr(ds, "coordinator"):
                # StreamingIngest (data/streaming/split.py): ONE
                # streaming execution shared across gang formations —
                # a world-size change resplit()s the live coordinator
                # mid-epoch instead of re-executing the dataset.
                shards[name] = shard(rank, world)
                continue
            split = getattr(ds, "split", None)
            if callable(split):
                # No silent fallback: a failed split would hand every
                # DP worker the FULL dataset — duplicated data quietly
                # changes effective epochs/statistics. Fail loudly.
                shards[name] = split(world)[rank]
            else:
                logger.warning(
                    "dataset %r has no split(); replicating it to all %d "
                    "workers (data-parallel ranks will see duplicate data)",
                    name, world)
                shards[name] = ds
        return shards

    def fit(self) -> Result:
        fc: FailureConfig = self.run_config.failure_config
        if fc.elastic:
            # Elastic plane: per-rank verdicts, single-rank replacement
            # on a kept PG, shrink-to-feasible-world when no replacement
            # bundle appears, opportunistic grow-back.
            from ray_tpu_torch.train.elastic import ElasticSupervisor

            return ElasticSupervisor(self).fit()
        max_failures = fc.max_failures
        backoff = RestartBackoff(fc)
        attempt = 0
        experiment = self.run_config.name or "train"
        run_id = train_obs.next_run_id(experiment)
        interrupt_ts: Optional[float] = None
        latest_ckpt: Optional[str] = (
            self._resume.path if self._resume else None)
        history: list = []
        last_metrics: Dict[str, Any] = {}
        while True:
            group = WorkerGroup(
                num_workers=self.scaling_config.num_workers,
                resources=self.scaling_config.worker_resources(),
                strategy=self.scaling_config.placement_strategy,
                backend_name=self._backend(),
                trial_dir=self.run_config.resolve_storage(),
                experiment_name=experiment,
                run_meta={
                    "run_id": run_id, "attempt": attempt,
                    "flops_per_step": self.scaling_config.flops_per_step})
            try:
                master_env = self._backend().master_env(
                    *group.master_addr())
                group.start_all(self._fn, self._config, master_env,
                                latest_ckpt, self._shard_fn)
                # Restart gap: wall time from failure detection to the
                # new gang running — what TrainRunState charges to the
                # run's lost_restart bucket.
                gap = (time.time() - interrupt_ts) if interrupt_ts else 0.0
                interrupt_ts = None
                train_obs.emit_run_event(
                    experiment, run_id,
                    f"gang start (attempt {attempt})", attempt=attempt,
                    world=self.scaling_config.num_workers,
                    gap_s=round(gap, 3))
                last_metrics, ckpt_path, history_part = self._drain(group)
                # A resumed gang that checkpoints no more keeps the
                # checkpoint it resumed from (the JAX package's loop
                # drops it here).
                latest_ckpt = ckpt_path or latest_ckpt
                history.extend(history_part)
                ckpt = Checkpoint(latest_ckpt) if latest_ckpt else None
                return Result(metrics=last_metrics, checkpoint=ckpt,
                              metrics_history=history,
                              config=self._config)
            except _WorkerGroupFailure as e:
                attempt += 1
                interrupt_ts = time.time()
                RESTARTS_TOTAL.inc(tags={"cause": e.cause})
                history.extend(e.history)
                if e.latest_checkpoint:
                    latest_ckpt = e.latest_checkpoint
                if max_failures >= 0 and attempt > max_failures:
                    ckpt = Checkpoint(latest_ckpt) if latest_ckpt else None
                    return Result(metrics=last_metrics, checkpoint=ckpt,
                                  error=RuntimeError(e.error),
                                  metrics_history=history,
                                  config=self._config)
                delay = backoff.next_delay()
                logger.warning(
                    "train attempt %d failed (%s), restarting from %s "
                    "in %.1fs", attempt, e.cause, latest_ckpt, delay)
                time.sleep(delay)
            finally:
                group.shutdown()

    def _drain(self, group: WorkerGroup):
        """Poll workers until all finish; surface failures with the latest
        checkpoint so a restart resumes instead of starting over."""
        latest_ckpt = None
        last_metrics: Dict[str, Any] = {}
        history: list = []
        while True:
            try:
                polls = group.poll_all()
            except BaseException as e:  # noqa: BLE001
                # A worker actor/process died (the canonical failure
                # FailureConfig covers) — surface as restartable.
                raise _WorkerGroupFailure(
                    f"worker group poll failed: {e!r}", latest_ckpt, history,
                    cause=classify_failure(repr(e)))
            for rank, p in enumerate(polls):
                for item in p["results"]:
                    if item["checkpoint"]:
                        latest_ckpt = item["checkpoint"]
                    if rank == 0:
                        last_metrics = item["metrics"]
                        history.append(item["metrics"])
            for p in polls:
                if p["error"]:
                    raise _WorkerGroupFailure(p["error"], latest_ckpt, history)
            if all(p["finished"] for p in polls):
                return last_metrics, latest_ckpt, history
            time.sleep(0.05)


class _WorkerGroupFailure(Exception):
    def __init__(self, error: str, latest_checkpoint: Optional[str],
                 history: list, cause: str = "error"):
        super().__init__(error)
        self.error = error
        self.latest_checkpoint = latest_checkpoint
        self.history = history
        self.cause = cause  # death | hang | preemption | error


class TorchTrainer(DataParallelTrainer):
    """Flagship trainer: a torch.distributed group across the gang (NCCL
    and one card per rank, or gloo on the CPU with `use_gpu=False`), over
    which `parallel.build_mesh` lays its DeviceMesh (ref:
    python/ray/train/torch/torch_trainer.py:11)."""

    backend_name = "torch"
