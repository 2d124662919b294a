"""Gang of training-worker actors on a placement group, counterpart of
`ray_tpu/train/worker_group.py`.

Reference shape: `WorkerGroup` of `RayTrainWorker` actors created by
`BackendExecutor` under a placement group
(ref: python/ray/train/_internal/worker_group.py:102,19;
_internal/backend_executor.py:197 PG creation, :427 start_training).
The user loop runs in a background thread inside each actor, which also
starts the backend there (CUDA's current device is per thread), and
results are drained by polling (`max_concurrency=4` keeps the actor
responsive beside the loop).

Elastic additions: the group can be built ON an existing placement group
(gang restart after a rank replacement keeps the surviving bundles), a
single rank can be killed without tearing the gang down, and shutdown
can leave the PG alive for the next attempt.
"""
from __future__ import annotations

import os
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.session import TrainSession, install_session, uninstall_session
from ray_tpu_torch.train.backend import resolve_backend
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.util.placement_group import (PlacementGroup, placement_group,
                                          remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy


class TrainWorker:
    """Actor hosting one rank of the gang."""

    def __init__(self, rank: int, world_size: int, backend_name, trial_dir: str,
                 experiment_name: str,
                 run_meta: Optional[Dict[str, Any]] = None):
        self.rank = rank
        self.world_size = world_size
        self.backend = resolve_backend(backend_name)
        self.trial_dir = trial_dir
        self.experiment_name = experiment_name
        # Observability identity: {"run_id", "attempt", "flops_per_step"}
        # — the stable run id (experiment + fit attempt) plus this
        # gang's restart index, stamped onto gauges and step spans.
        self.run_meta = run_meta or {}
        self.session: Optional[TrainSession] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[str] = None

    def get_ip(self) -> str:
        import socket

        return socket.gethostbyname(socket.gethostname())

    def get_address_and_port(self) -> "tuple[str, int]":
        """IP + a free port, probed ON this worker's host — a port free on
        the driver may be taken on rank-0's host (reference pattern:
        get_address_and_port runs on the worker)."""
        import socket

        s = socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return socket.gethostbyname(socket.gethostname()), port

    def pid(self) -> int:
        return os.getpid()

    def start_loop(self, fn: Callable, config: Optional[dict],
                   master_env: Dict[str, str],
                   latest_checkpoint: Optional[str],
                   dataset_shards: Optional[Dict[str, Any]] = None) -> int:
        os.makedirs(self.trial_dir, exist_ok=True)
        ckpt = Checkpoint(latest_checkpoint) if latest_checkpoint else None
        self.session = TrainSession(
            world_rank=self.rank, world_size=self.world_size,
            local_rank=self.rank,  # one worker per host in this build
            trial_dir=self.trial_dir, latest_checkpoint=ckpt,
            dataset_shards=dataset_shards,
            experiment_name=self.experiment_name,
            run_meta=self.run_meta)
        self._install_progress_probe(self.session)

        def target():
            install_session(self.session)
            try:
                self.backend.on_start(self.rank, self.world_size, master_env)
                if config is None:
                    fn()
                else:
                    fn(config)
            except BaseException:  # noqa: BLE001
                self._error = traceback.format_exc()
            finally:
                self.backend.on_shutdown()
                uninstall_session()
                self.session.finished.set()
                self._remove_progress_probe()

        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()
        return os.getpid()

    def _install_progress_probe(self, session: TrainSession) -> None:
        """Expose the train loop to the daemon's hung-task watchdog as a
        synthetic running task whose start_ts is the LAST report() time:
        a rank that stops reporting past RAY_TPU_HANG_THRESHOLD_S gets
        flagged hung (and, SIGSTOPped, stops answering running_tasks —
        the daemon's stale-snapshot fallback blames it the same way)."""
        try:
            from ray_tpu_torch.core.distributed.worker_main import (
                register_progress_probe)
        except Exception:  # noqa: BLE001
            return
        rank = self.rank

        def probe():
            if session.finished.is_set():
                return None
            return {"task_id": f"train-loop-rank{rank}",
                    "attempt": 0, "name": "train_loop",
                    "job_id": None, "actor_id": None,
                    "start_ts": session.last_progress_ts}

        register_progress_probe(f"train-loop-rank{rank}", probe)

    def _remove_progress_probe(self) -> None:
        try:
            from ray_tpu_torch.core.distributed.worker_main import (
                unregister_progress_probe)

            unregister_progress_probe(f"train-loop-rank{self.rank}")
        except Exception:  # noqa: BLE001
            pass

    def poll(self) -> dict:
        """Drain queued results; report liveness + error state."""
        out: List[dict] = []
        if self.session is not None:
            while not self.session.results.empty():
                out.append(self.session.results.get_nowait())
        return {
            "results": out,
            "finished": self.session.finished.is_set() if self.session else False,
            "error": self._error,
            "pid": os.getpid(),
            "last_progress_ts": (self.session.last_progress_ts
                                 if self.session else None),
        }


class WorkerGroup:
    def __init__(self, *, num_workers: int, resources: Dict[str, float],
                 strategy: str, backend_name, trial_dir: str,
                 experiment_name: str, pg: Optional[PlacementGroup] = None,
                 ready_timeout: float = 60.0,
                 run_meta: Optional[Dict[str, Any]] = None):
        self.num_workers = num_workers
        self._owns_pg = pg is None
        self.pg = pg if pg is not None else placement_group(
            [dict(resources)] * num_workers, strategy=strategy)
        if not self.pg.ready(timeout=ready_timeout):
            if self._owns_pg:
                remove_placement_group(self.pg)
            raise ray_tpu_torch.exceptions.PlacementGroupUnavailableError(
                f"could not reserve {num_workers} x {resources}")
        cls = ray_tpu_torch.remote(TrainWorker)
        self.workers = [
            cls.options(
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self.pg, placement_group_bundle_index=i),
                max_concurrency=4,
            ).remote(i, num_workers, backend_name, trial_dir, experiment_name,
                     run_meta or {})
            for i in range(num_workers)
        ]
        # rank -> worker pid, learned from start_all (chaos/status use).
        self.pids: List[Optional[int]] = [None] * num_workers

    def master_ip(self) -> str:
        return ray_tpu_torch.get(self.workers[0].get_ip.remote())

    def master_addr(self, timeout: float = 60.0) -> "tuple[str, int]":
        """Rank-0's (ip, free-port), probed on rank-0's own host."""
        return tuple(ray_tpu_torch.get(
            self.workers[0].get_address_and_port.remote(), timeout=timeout))

    def start_all(self, fn, config, master_env, latest_checkpoint,
                  shard_fn=None, timeout: Optional[float] = None) -> None:
        refs = []
        for i, w in enumerate(self.workers):
            shards = shard_fn(i, self.num_workers) if shard_fn else None
            refs.append(w.start_loop.remote(fn, config, master_env,
                                            latest_checkpoint, shards))
        self.pids = list(ray_tpu_torch.get(refs, timeout=timeout))

    def poll_all(self) -> List[dict]:
        return ray_tpu_torch.get([w.poll.remote() for w in self.workers])

    def poll_rank(self, rank: int, timeout: Optional[float] = None) -> dict:
        """One rank's poll with a deadline (elastic supervisor: a rank
        that cannot answer within the hang threshold is a straggler)."""
        return ray_tpu_torch.get(self.workers[rank].poll.remote(), timeout=timeout)

    def kill_rank(self, rank: int) -> None:
        """Kill ONE rank's actor process; the gang (and PG) survives."""
        try:
            ray_tpu_torch.kill(self.workers[rank])
        except Exception:  # noqa: BLE001
            pass

    def shutdown(self, remove_pg: bool = True) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass
        if remove_pg:
            try:
                remove_placement_group(self.pg)
            except Exception:  # noqa: BLE001
                pass
