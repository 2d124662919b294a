"""Tuner + trial controller; the port's copy of `ray_tpu/tune/tuner.py`,
on the port's `train/session.py`, `train/checkpoint.py` and
`train/config.py`.

Reference call stack (SURVEY.md §3.3 step 1): `Tuner.fit`
(ref: python/ray/tune/tuner.py:346 → impl/tuner_internal.py:473) drives an
event loop over trial actors (ref: tune/execution/tune_controller.py:69,
step :667).  Here each trial runs its function-trainable in a TrialActor
(thread + result queue, same session machinery as ray_tpu_torch.train); the
controller polls, feeds the scheduler, kills/STOPs, and executes PBT
exploit/explore restarts from checkpoints. Each trial's session is its own
thread's (`install_session(per_thread=True)`), so concurrent trials in
local mode, threads of one process, do not share one; a trial the
controller stops, parks or restarts is told to stop first and its loop
ends at its next `report`, and `fit()` waits for those threads in its own
process before it returns. A trial's actor asks for no
resources (as JAX's): on a node with cards it sees them all
(`node_daemon._visible_env` scopes only GPU leases), so concurrent trials
share the node's cards.
"""
from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import logging

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import Result, RunConfig
from ray_tpu_torch.train.session import (TrainSession, TrialStopped,
                                         install_session, uninstall_session)
from ray_tpu_torch.tune.schedulers import (PAUSE, STOP, FIFOScheduler,
                                           PopulationBasedTraining)
from ray_tpu_torch.tune.search import generate_variants

logger = logging.getLogger(__name__)

# Threads of stopped trials by the token `TrialActor.stop` returned, in
# the process that runs the trial: in local mode the Tuner's own.
_stopped_threads: Dict[str, Any] = {}
STOPPED_TRIAL_JOIN_S = 60.0


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Optional[Any] = None
    # Searcher plug-in (ref: tune/search/searcher.py): suggests configs
    # adaptively; None => pre-expanded grid/random variants.
    search_alg: Optional[Any] = None
    seed: Optional[int] = None


class TrialActor:
    """Runs one trial's function trainable (thread + queue)."""

    def __init__(self, trial_id: str, trial_dir: str):
        import threading

        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self._threading = threading
        self.session: Optional[TrainSession] = None
        self._thread = None
        self._error: Optional[str] = None

    def start(self, fn: Callable, config: dict,
              checkpoint_path: Optional[str]) -> bool:
        os.makedirs(self.trial_dir, exist_ok=True)
        ckpt = Checkpoint(checkpoint_path) if checkpoint_path else None
        self.session = TrainSession(
            world_rank=0, world_size=1, local_rank=0,
            trial_dir=self.trial_dir, latest_checkpoint=ckpt,
            experiment_name=self.trial_id)

        def target():
            install_session(self.session, per_thread=True)
            try:
                fn(config)
            except TrialStopped:
                pass
            except BaseException:  # noqa: BLE001
                self._error = traceback.format_exc()
            finally:
                uninstall_session()
                self.session.finished.set()

        self._thread = self._threading.Thread(target=target, daemon=True)
        self._thread.start()
        return True

    def stop(self) -> Optional[str]:
        """End the trial's loop at its next `report`; returns a token by
        which `fit()` joins the thread when it runs in the Tuner's
        process."""
        if self.session is None or self._thread is None:
            return None
        self.session.request_stop()
        token = f"{os.getpid()}:{id(self._thread)}"
        _stopped_threads[token] = self._thread
        return token

    def poll(self) -> dict:
        out = []
        if self.session is not None:
            while not self.session.results.empty():
                out.append(self.session.results.get_nowait())
        return {"results": out,
                "finished": (self.session.finished.is_set()
                             if self.session else False),
                "error": self._error}


@dataclasses.dataclass
class _Trial:
    trial_id: str
    config: dict
    actor: Any = None
    state: str = "PENDING"      # PENDING/RUNNING/TERMINATED/ERROR/STOPPED
    iteration: int = 0
    last_metrics: dict = dataclasses.field(default_factory=dict)
    history: list = dataclasses.field(default_factory=list)
    checkpoint: Optional[str] = None
    error: Optional[str] = None


class ResultGrid:
    def __init__(self, results: List[Result], trials: List[_Trial]):
        self._results = results
        self._trials = trials

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self):
        return [r.error for r in self._results if r.error]

    def get_best_result(self, metric: str, mode: str = "max") -> Result:
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(
            scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics for r in self._results])


class Tuner:
    def __init__(self, trainable: Callable, *, param_space: Dict[str, Any],
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self._fn = trainable
        self._space = param_space
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restored_trials: Optional[List[_Trial]] = None
        self._warned_callbacks: set = set()

    @classmethod
    def restore(cls, path: str, trainable: Callable,
                *, tune_config: Optional[TuneConfig] = None) -> "Tuner":
        """Resume an interrupted experiment from its state snapshot (ref:
        Tuner.restore, tune/execution/experiment_state.py): finished
        trials keep their results; unfinished ones restart from their
        last reported checkpoint."""
        import json

        state_file = os.path.join(path, "experiment_state.json")
        with open(state_file) as f:
            state = json.load(f)
        tuner = cls(trainable, param_space={},
                    tune_config=tune_config or TuneConfig(),
                    run_config=RunConfig(storage_path=os.path.dirname(path)
                                         or ".",
                                         name=os.path.basename(path)))
        trials = []
        for t in state["trials"]:
            trial = _Trial(trial_id=t["trial_id"], config=t["config"])
            trial.checkpoint = t.get("checkpoint")
            if t["state"] in ("TERMINATED", "STOPPED"):
                # Cleanly finished: keep its results as-is.
                trial.state = t["state"]
                trial.iteration = t["iteration"]
                trial.last_metrics = t["last_metrics"]
                trial.history = t.get("history", [])
                trial.error = t.get("error")
            else:
                # Resumes from its last checkpoint: stale error/history
                # belong to the aborted attempt, not the resumed one.
                trial.state = "PENDING"
            trials.append(trial)
        tuner._restored_trials = trials
        return tuner

    _SNAPSHOT_MIN_INTERVAL_S = 5.0

    def _warn_callback(self, cb) -> None:
        """A broken logger must not kill the experiment, but silence
        would hide that NOTHING is being logged — warn once per
        callback object."""
        if id(cb) not in self._warned_callbacks:
            self._warned_callbacks.add(id(cb))
            logger.warning(
                "experiment callback %s raised; further errors from it "
                "are suppressed", type(cb).__name__, exc_info=True)

    def _snapshot(self, exp_dir: str, trials: List["_Trial"],
                  force: bool = False) -> None:
        # Rate-limited: rewriting every-trial histories 20x/s would let
        # snapshot I/O dominate the control loop on long runs.
        now = time.monotonic()
        last = getattr(self, "_last_snapshot", 0.0)
        if not force and now - last < self._SNAPSHOT_MIN_INTERVAL_S:
            return
        self._last_snapshot = now
        import json

        state = {"trials": [
            {"trial_id": t.trial_id, "config": t.config, "state": t.state,
             "iteration": t.iteration, "last_metrics": t.last_metrics,
             "history": t.history, "checkpoint": t.checkpoint,
             "error": t.error}
            for t in trials]}
        tmp = os.path.join(exp_dir, ".experiment_state.tmp")
        try:
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, os.path.join(exp_dir,
                                         "experiment_state.json"))
        except (OSError, TypeError):
            pass  # unpicklable config values: snapshots are best-effort

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        scheduler = tc.scheduler or FIFOScheduler()
        searcher = tc.search_alg
        exp_dir = self.run_config.resolve_storage()
        os.makedirs(exp_dir, exist_ok=True)
        if self._restored_trials is not None:
            trials = self._restored_trials
            pending = [t for t in trials if t.state == "PENDING"]
            spawned = len(trials)
        elif searcher is not None:
            searcher.set_space(self._space, tc.metric, tc.mode, tc.seed)
            trials = []
            pending = []
            spawned = 0
        else:
            variants = generate_variants(self._space, tc.num_samples,
                                         tc.seed)
            trials = [_Trial(trial_id=f"trial_{i:04d}", config=cfg)
                      for i, cfg in enumerate(variants)]
            pending = list(trials)
            spawned = len(trials)
        running: List[_Trial] = []
        paused: List[_Trial] = []
        RemoteTrial = ray_tpu_torch.remote(TrialActor)

        def launch(trial: _Trial, checkpoint: Optional[str] = None):
            trial.actor = RemoteTrial.options(max_concurrency=4).remote(
                trial.trial_id, os.path.join(exp_dir, trial.trial_id))
            ray_tpu_torch.get(trial.actor.start.remote(
                self._fn, trial.config, checkpoint or trial.checkpoint),
                timeout=60)
            trial.state = "RUNNING"
            running.append(trial)
            # Config-aware schedulers (PB2's bandit) hear every (re)launch.
            if hasattr(scheduler, "on_trial_config"):
                scheduler.on_trial_config(trial.trial_id, trial.config)

        stopped_tokens: List[str] = []

        def halt(trial: _Trial) -> None:
            """Stop the trial's loop at its next report, then kill its
            actor."""
            try:
                token = ray_tpu_torch.get(trial.actor.stop.remote(),
                                          timeout=30)
                if token:
                    stopped_tokens.append(token)
            except Exception:  # noqa: BLE001 the actor is already gone
                pass
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:  # noqa: BLE001
                pass

        def fill_slots():
            nonlocal spawned
            while pending and len(running) < tc.max_concurrent_trials:
                launch(pending.pop(0))
            while (searcher is not None
                   and self._restored_trials is None
                   and spawned < tc.num_samples
                   and len(running) < tc.max_concurrent_trials):
                tid = f"trial_{spawned:04d}"
                cfg = searcher.suggest(tid)
                if cfg is None:
                    break  # e.g. ConcurrencyLimiter: retry next tick
                trial = _Trial(trial_id=tid, config=cfg)
                trials.append(trial)
                spawned += 1
                try:
                    launch(trial)
                except Exception as e:  # noqa: BLE001
                    # The searcher must hear about the failure or its
                    # concurrency slot leaks for the whole experiment.
                    trial.state = "ERROR"
                    trial.error = repr(e)
                    searcher.on_trial_complete(tid, None)

        def more_to_spawn() -> bool:
            return (searcher is not None
                    and self._restored_trials is None
                    and spawned < tc.num_samples)

        def drain_scheduler_transitions() -> None:
            """Apply rung verdicts until none remain: stopping a trial
            can complete ANOTHER rung (on_trial_complete cascades), so a
            single pass could leave freshly-queued losers to be wrongly
            force-resumed."""
            if not hasattr(scheduler, "pending_transitions"):
                return
            while True:
                resume_ids, stop_ids = scheduler.pending_transitions()
                if not resume_ids and not stop_ids:
                    return
                by_id = {t.trial_id: t for t in trials}
                for tid in stop_ids:
                    trial = by_id.get(tid)
                    if trial is not None and trial.state == "PAUSED":
                        paused.remove(trial)
                        trial.state = "STOPPED"
                        scheduler.on_trial_complete(tid)
                        if searcher is not None:
                            # Also frees ConcurrencyLimiter slots.
                            searcher.on_trial_complete(
                                tid, trial.last_metrics)
                for tid in resume_ids:
                    trial = by_id.get(tid)
                    if trial is not None and trial.state == "PAUSED":
                        paused.remove(trial)
                        launch(trial)

        fill_slots()
        while pending or running or paused or more_to_spawn():
            fill_slots()
            if not (pending or running or paused):
                # Nothing live and fill_slots() could not spawn (budget
                # spent, or the searcher declined with nothing running —
                # an exhausted space): done.
                break
            if not running and not pending and paused:
                # Apply all queued rung verdicts first — force-resuming
                # a loser queued for STOP would let it run to max_t and
                # corrupt the rung accounting.
                drain_scheduler_transitions()
                # Anything STILL paused is genuinely stranded (e.g. a
                # rung that lost its stragglers to errors): resume it.
                for trial in list(paused):
                    paused.remove(trial)
                    launch(trial)
            polls = ray_tpu_torch.get(
                [t.actor.poll.remote() for t in running], timeout=120)
            done: List[_Trial] = []
            for trial, p in zip(list(running), polls):
                for item in p["results"]:
                    m = item["metrics"]
                    trial.iteration += 1
                    m.setdefault("training_iteration", trial.iteration)
                    trial.last_metrics = m
                    trial.history.append(m)
                    if item["checkpoint"]:
                        trial.checkpoint = item["checkpoint"]
                    if searcher is not None:
                        searcher.on_trial_result(trial.trial_id, m)
                    for cb in self.run_config.callbacks:
                        try:
                            cb.on_trial_result(trial.trial_id,
                                               trial.config, m)
                        except Exception:  # noqa: BLE001 logging must
                            self._warn_callback(cb)  # never kill the run
                    decision = scheduler.on_result(trial.trial_id, m)
                    if decision == STOP and trial.state == "RUNNING":
                        trial.state = "STOPPED"
                        done.append(trial)
                        break
                    if decision == PAUSE and trial.state == "RUNNING":
                        # Park the trial; the scheduler resumes or stops
                        # it via pending_transitions (sync HyperBand
                        # rungs, ref: hyperband.py PAUSE semantics).
                        trial.state = "PAUSED"
                        running.remove(trial)
                        paused.append(trial)
                        halt(trial)
                        break
                if trial.state == "RUNNING":
                    if p["error"]:
                        trial.state = "ERROR"
                        trial.error = p["error"]
                        done.append(trial)
                    elif p["finished"]:
                        trial.state = "TERMINATED"
                        done.append(trial)
            # Scheduler-driven pause transitions (sync HyperBand rungs).
            drain_scheduler_transitions()
            # PBT exploit/explore: restart bottom trials from a top trial.
            if isinstance(scheduler, PopulationBasedTraining):
                by_id = {t.trial_id: t for t in trials}
                for victim_id, src_id in list(scheduler.exploits.items()):
                    scheduler.exploits.pop(victim_id)
                    victim = by_id.get(victim_id)
                    src = by_id.get(src_id)
                    if (victim is None or src is None
                            or victim.state != "RUNNING"
                            or not src.checkpoint):
                        continue
                    halt(victim)
                    if victim in running:
                        running.remove(victim)
                    victim.config = scheduler.mutate(src.config)
                    victim.iteration = 0
                    launch(victim, checkpoint=src.checkpoint)
            for trial in done:
                if trial in running:
                    running.remove(trial)
                scheduler.on_trial_complete(trial.trial_id)
                if searcher is not None:
                    searcher.on_trial_complete(trial.trial_id,
                                               trial.last_metrics)
                for cb in self.run_config.callbacks:
                    try:
                        cb.on_trial_complete(trial.trial_id, trial.config,
                                             trial.last_metrics,
                                             trial.error)
                    except Exception:  # noqa: BLE001
                        self._warn_callback(cb)
                if trial.actor is not None and trial.state == "STOPPED":
                    halt(trial)
                elif trial.actor is not None:
                    try:
                        ray_tpu_torch.kill(trial.actor)
                    except Exception:  # noqa: BLE001
                        pass
            self._snapshot(exp_dir, trials, force=bool(done))
            if running and not done:
                time.sleep(0.05)

        # Stopped trials whose threads ran in this process (local mode)
        # end at their next report: wait for them.
        deadline = time.monotonic() + STOPPED_TRIAL_JOIN_S
        for token in stopped_tokens:
            thread = _stopped_threads.pop(token, None)
            if thread is not None:
                thread.join(max(0.0, deadline - time.monotonic()))
                if thread.is_alive():
                    logger.warning("a stopped trial's thread is still "
                                   "running after %.0f s",
                                   STOPPED_TRIAL_JOIN_S)
        results = []
        for t in trials:
            err = RuntimeError(t.error) if t.error else None
            ckpt = Checkpoint(t.checkpoint) if t.checkpoint else None
            metrics = dict(t.last_metrics)
            metrics["config"] = t.config   # kept for dict-style access
            results.append(Result(metrics=metrics, checkpoint=ckpt,
                                  error=err, metrics_history=t.history,
                                  config=dict(t.config)))
        grid = ResultGrid(results, trials)
        for cb in self.run_config.callbacks:
            try:
                cb.on_experiment_end(grid)
            except Exception:  # noqa: BLE001
                self._warn_callback(cb)
        return grid
