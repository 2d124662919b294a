"""Per-worker training session: report / get_checkpoint / context.
Counterpart of `ray_tpu/train/session.py`.

The reference runs the user loop in a thread and funnels `train.report`
through a result queue consumed by the trainer
(ref: python/ray/train/_internal/session.py:109 `_TrainSession`, report
:661, get_checkpoint :748, get_dataset_shard :1054).  Same shape here: the
session is a module-global installed by the TrainWorker actor; `report`
enqueues (metrics, checkpoint-dir) and the trainer drains the queue via
actor polling.

The session also owns this rank's step/phase attribution
(train/observability.py): `report()` delimits implicit steps and times
the checkpoint persist into the `checkpoint` phase, `step_phases()` /
`phase()` expose explicit step markup, `get_dataset_shard` wraps plain
iterators so their blocking `next()` charges `data_wait`, and a
background pusher federates the per-rank counters over the node-daemon
gauge path.

A Tuner trial installs its session for its own thread (`per_thread=True`):
in local mode every trial is a thread of one process, so the lookup takes
the calling thread's session first and falls back to the process-wide one
that a train worker installs (whose helper threads, the feed and the
pusher, see it from any thread). A trial whose scheduler stops it ends at
its next `report`, which raises `TrialStopped` once `request_stop()` was
called.
"""
from __future__ import annotations

import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, Iterable, Optional

from ray_tpu_torch.train import observability as train_obs
from ray_tpu_torch.train.checkpoint import Checkpoint

_session_lock = threading.Lock()
_session: Optional["TrainSession"] = None
_thread_session = threading.local()


class TrialStopped(BaseException):
    """Raised by `report` in a session its Tuner stopped: ends the trial's
    loop (a BaseException, so a loop's `except Exception` does not keep
    it running)."""


class TrainSession:
    def __init__(self, *, world_rank: int, world_size: int, local_rank: int,
                 trial_dir: str, latest_checkpoint: Optional[Checkpoint],
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 experiment_name: str = "train",
                 run_meta: Optional[Dict[str, Any]] = None):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.trial_dir = trial_dir
        self.experiment_name = experiment_name
        self.latest_checkpoint = latest_checkpoint
        self.dataset_shards = dataset_shards or {}
        self.results: "queue.Queue" = queue.Queue()
        self.finished = threading.Event()
        # Last moment this rank made observable progress (a report()).
        # The worker's progress probe ships this as a running-task
        # start_ts, so the daemon's hung-task watchdog flags a loop
        # that STOPPED reporting — not one that is merely long-running.
        self.last_progress_ts = time.time()
        # Seed past any checkpoints a previous (failed) attempt persisted:
        # restarting from 0 would re-target checkpoint_000001... and mix
        # stale files into — or clobber — the dir we may be restoring from.
        self._ckpt_seq = self._existing_ckpt_max()
        # Step/phase attribution for this rank (run id == experiment
        # name + fit attempt, stable across gang restarts; the restart
        # index rides along as `attempt`).
        meta = run_meta or {}
        self.run_id = meta.get("run_id") or f"{experiment_name}#0"
        self.recorder = train_obs.StepPhaseRecorder(
            run=experiment_name, run_id=self.run_id,
            rank=world_rank, world_size=world_size,
            attempt=int(meta.get("attempt", 0) or 0),
            flops_per_step=meta.get("flops_per_step"))
        self._pusher = train_obs.GaugePusher(self.recorder)
        self._stop = threading.Event()

    def request_stop(self) -> None:
        """Make the next `report` end the loop with `TrialStopped`."""
        self._stop.set()

    def _existing_ckpt_max(self) -> int:
        try:
            names = os.listdir(self.trial_dir)
        except OSError:
            return 0
        best = 0
        for name in names:
            if not name.startswith("checkpoint_"):
                continue
            try:
                best = max(best, int(name.rsplit("_", 1)[1]))
            except ValueError:
                continue  # stray entry (tmp dirs etc.) — skip, don't reset
        return best

    # -- user-facing ----------------------------------------------------
    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        if self._stop.is_set():
            raise TrialStopped()
        persisted = None
        if checkpoint is not None:
            t0 = time.perf_counter()
            self._ckpt_seq += 1
            dest = os.path.join(self.trial_dir,
                                f"checkpoint_{self._ckpt_seq:06d}")
            if os.path.abspath(checkpoint.path) != dest:
                # Fresh dir: copytree(dirs_exist_ok=True) would only
                # overwrite same-named files, leaving stale orbax leftovers.
                shutil.rmtree(dest, ignore_errors=True)
                shutil.copytree(checkpoint.path, dest)
            persisted = dest
            self.latest_checkpoint = Checkpoint(persisted)
            self.recorder.observe_persist(time.perf_counter() - t0)
        self.last_progress_ts = time.time()
        self.recorder.on_report()
        self.results.put({"metrics": dict(metrics), "checkpoint": persisted})

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.latest_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        shard = self.dataset_shards.get(name)
        if shard is None:
            raise KeyError(f"no dataset shard named {name!r}")
        if (self.recorder.enabled
                and not hasattr(shard, "iter_batches")
                and (hasattr(shard, "__next__")
                     or hasattr(shard, "__iter__"))):
            # Plain iterator/iterable shard: time its next() into
            # data_wait. Dataset-shaped shards keep their API surface —
            # their feed goes through the device prefetcher, which
            # charges data_wait via the observability hook.
            return train_obs.PhasedIterator(shard, self.recorder)
        return shard


def install_session(s: TrainSession, *, per_thread: bool = False) -> None:
    """Install `s` for the process, or with `per_thread` for the calling
    thread (a Tuner trial). A per-thread session also becomes the process
    one when there is none, so a lone trial's helper threads see it."""
    global _session
    with _session_lock:
        if per_thread:
            _thread_session.session = s
            if _session is None:
                _session = s
        else:
            _session = s
    train_obs.set_active(s.recorder)
    s._pusher.start()


def uninstall_session() -> None:
    """Remove the calling thread's session if it has one, else the
    process-wide one."""
    global _session
    with _session_lock:
        prev = getattr(_thread_session, "session", None)
        if prev is not None:
            _thread_session.session = None
            if _session is prev:
                _session = None
        else:
            prev, _session = _session, None
    if prev is not None:
        # Close any step left open, then flush a final gauge push so
        # the GCS sees the rank's terminal counters — marked finished,
        # so a rank that stops pushing because its loop returned is not
        # taken for a stopped straggler.
        prev.recorder.step_end()
        prev.recorder.finished = True
        prev._pusher.stop(flush=True)
        if train_obs.get_active() is prev.recorder:
            train_obs.set_active(None)


def _get() -> TrainSession:
    s = getattr(_thread_session, "session", None) or _session
    if s is None:
        raise RuntimeError(
            "No training session active — call inside train_loop_per_worker")
    return s


# ---- public API (ray.train.* equivalents) -----------------------------
def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    _get().report(metrics, checkpoint=checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _get().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    return _get().get_dataset_shard(name)


def step_phases():
    """Explicit step delimiter: `with train.step_phases() as step:` —
    phases recorded inside (via `step.phase(...)` or the module-level
    `train.phase(...)`) attribute to this step, and the step closes at
    block exit rather than at the next `report()`."""
    return train_obs.step(_get().recorder)


def phase(name: str):
    """Attribute the block's wall time to one phase
    ("data_wait"/"compute"/"sync"/"checkpoint") of the current step:
    `with train.phase("compute"): loss = train_step(...)`."""
    return _get().recorder.phase(name)


class TrainContext:
    def get_world_size(self) -> int:
        return _get().world_size

    def get_world_rank(self) -> int:
        return _get().world_rank

    def get_local_rank(self) -> int:
        return _get().local_rank

    def get_trial_dir(self) -> str:
        return _get().trial_dir

    def get_experiment_name(self) -> str:
        return _get().experiment_name

    def get_run_id(self) -> str:
        return _get().run_id


def get_context() -> TrainContext:
    return TrainContext()
