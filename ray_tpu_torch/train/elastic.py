"""Elastic gang supervisor: replace, shrink, grow — never just die.
Counterpart of `ray_tpu/train/elastic.py`.

The reaction half of the fault arc (the diagnosis plane shipped the
detection half): `DataParallelTrainer.fit` with
`FailureConfig(elastic=True)` delegates here instead of running the
blunt teardown-and-retry loop. The supervisor

1. drains per-rank, so one dead or straggling rank is a *verdict about
   that rank*, not an opaque whole-group failure;
2. on a verdict kills the flagged rank, keeps the placement group (and
   its surviving bundles) alive, and waits — capped exponential backoff
   with jitter — for the GCS to re-reserve the lost bundle;
3. when no replacement bundle materializes within
   RAY_TPU_ELASTIC_REPLACE_TIMEOUT_S, re-forms the gang at the largest
   feasible world size (>= ScalingConfig.min_workers) and resumes from
   the latest checkpoint;
4. grows back toward the target world size when capacity returns
   (checked every RAY_TPU_ELASTIC_GROW_CHECK_S).

Hang verdicts come from two mutually reinforcing sources: the rank's
own report() cadence (the session ships its last-progress timestamp
through poll(), and a worker that stops answering poll RPCs altogether
is tracked by unresponsiveness) and the node daemons' HangWatchdog
(whose flagged attempts surface through the GCS hung-task view and are
matched back to gang pids). Both use RAY_TPU_HANG_THRESHOLD_S, so the
daemon's verdicts and the supervisor's agree.
"""
from __future__ import annotations

import logging
import random
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.exceptions import (ActorDiedError, ActorUnavailableError,
                                GetTimeoutError)
from ray_tpu_torch.train import observability as train_obs
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import FailureConfig, Result
from ray_tpu_torch.train.worker_group import WorkerGroup
from ray_tpu_torch.util.metrics import Counter
from ray_tpu_torch.util.placement_group import (placement_group,
                                          remove_placement_group)

logger = logging.getLogger(__name__)

# Shared with the non-elastic restart loop in trainer.py: every gang
# restart lands here, tagged with what triggered it.
RESTARTS_TOTAL = Counter(
    "raytpu_train_restarts_total",
    "Train gang restarts by cause", tag_keys=("cause",))


def classify_failure(error: str) -> str:
    """death | preemption | error, from an exception/traceback string.

    A node death reads differently from a worker death in the actor
    death reason ("node <id> died" vs "worker process exited"), and the
    restart accounting keeps them apart: preemptions are expected churn,
    deaths are worth staring at."""
    s = (error or "").lower()
    if "node" in s and ("died" in s or "dead" in s):
        return "preemption"
    if ("actordied" in s or "actorunavailable" in s or "died" in s
            or "exited" in s or "unavailable" in s or "killed" in s):
        return "death"
    return "error"


class RestartBackoff:
    """Capped exponential backoff with +/-jitter between gang restarts
    (satellite of the fixed-sleep restart path; knobs
    RAY_TPU_ELASTIC_BACKOFF_* / FailureConfig overrides)."""

    def __init__(self, fc: Optional[FailureConfig] = None,
                 rng: Optional[random.Random] = None):
        cfg = get_config()

        def pick(field: str, knob: float) -> float:
            v = getattr(fc, field, None) if fc is not None else None
            return float(v) if v is not None else float(knob)

        self.initial = pick("backoff_initial_s", cfg.elastic_backoff_initial_s)
        self.maximum = pick("backoff_max_s", cfg.elastic_backoff_max_s)
        self.multiplier = pick("backoff_multiplier",
                               cfg.elastic_backoff_multiplier)
        self.jitter = pick("backoff_jitter", cfg.elastic_backoff_jitter)
        self._rng = rng or random.Random()
        self._next = self.initial

    def next_delay(self) -> float:
        d = self._next
        self._next = min(self.maximum, self._next * self.multiplier)
        if self.jitter:
            d *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, d)

    def reset(self) -> None:
        self._next = self.initial


class _RankFailure(Exception):
    def __init__(self, cause: str, rank: Optional[int], detail: str):
        super().__init__(f"rank {rank}: {cause}: {detail}")
        self.cause = cause          # death | hang | preemption | error
        self.rank = rank
        self.detail = detail
        self.history: List[dict] = []
        self.latest_checkpoint: Optional[str] = None
        self.last_metrics: Dict[str, Any] = {}

    def _with(self, history: List[dict], latest_checkpoint: Optional[str],
              last_metrics: Dict[str, Any]) -> "_RankFailure":
        """Attach the drain-so-far state so the restart resumes, not
        restarts-from-zero."""
        self.history = history
        self.latest_checkpoint = latest_checkpoint
        self.last_metrics = last_metrics
        return self


class ElasticSupervisor:
    """Drives one elastic fit() for a DataParallelTrainer."""

    def __init__(self, trainer):
        cfg = get_config()
        self.trainer = trainer
        self.scaling = trainer.scaling_config
        self.fc: FailureConfig = trainer.run_config.failure_config
        self.min_world, self.max_world = self.scaling.world_bounds()
        self.target = min(max(self.scaling.num_workers, self.min_world),
                          self.max_world)
        self.replace_timeout = (
            self.fc.replace_timeout_s
            if self.fc.replace_timeout_s is not None
            else cfg.elastic_replace_timeout_s)
        self.hang_timeout = (
            self.fc.hang_timeout_s if self.fc.hang_timeout_s is not None
            else cfg.hang_threshold_s)
        self.grow_check = (
            self.fc.grow_check_s if self.fc.grow_check_s is not None
            else cfg.elastic_grow_check_s)
        self.backoff = RestartBackoff(self.fc)
        self.stats: Dict[str, Any] = {
            "restarts": {"death": 0, "hang": 0, "preemption": 0,
                         "error": 0},
            "shrinks": 0, "grows": 0, "final_world": self.target,
        }

    # -- event/metrics plumbing ----------------------------------------
    def _emit(self, severity: str, message: str, **fields) -> None:
        try:
            from ray_tpu_torch.api import _global_worker

            _global_worker().gcs.call(
                "EventLog", "add_event", source="elastic",
                severity=severity, message=message, fields=fields or None,
                timeout=10)
        except Exception:  # noqa: BLE001 — events are best-effort
            pass

    # -- capacity probing ----------------------------------------------
    def _feasible_world(self, freed: int = 0) -> int:
        """Largest gang this cluster could host right now, by strategy.
        `freed` counts bundles the caller is about to release (grow
        probing: the current gang's bundles return to the pool before
        the bigger gang forms)."""
        import ray_tpu_torch

        res = self.scaling.worker_resources()
        try:
            nodes = [n for n in ray_tpu_torch.nodes() if n["Alive"]]
        except Exception:  # noqa: BLE001
            return 0

        def fits_count(avail: Dict[str, float]) -> int:
            count = 0
            while count < self.max_world + 1:
                if any(avail.get(k, 0.0) + 1e-9 < v * (count + 1)
                       for k, v in res.items()):
                    break
                count += 1
            return count

        strategy = self.scaling.placement_strategy
        per_node = [fits_count(dict(n["Available"])) for n in nodes]
        if strategy in ("SPREAD", "STRICT_SPREAD"):
            feasible = sum(1 for c in per_node if c >= 1)
        elif strategy == "STRICT_PACK":
            feasible = max(per_node, default=0)
        else:  # PACK
            feasible = sum(per_node)
        return min(self.max_world, feasible + freed)

    # -- gang formation -------------------------------------------------
    def _form_gang(self, world: int):
        """Reserve a PG for `world` ranks, shrinking while reservation
        times out, down to min_world. Returns (pg, world) or (None, 0)
        when even the minimum gang cannot form right now."""
        res = self.scaling.worker_resources()
        while world >= self.min_world:
            pg = placement_group([dict(res)] * world,
                                 strategy=self.scaling.placement_strategy)
            if pg.ready(timeout=self.replace_timeout):
                return pg, world
            remove_placement_group(pg)
            feasible = self._feasible_world()
            shrunk = min(world - 1, feasible)
            if shrunk < self.min_world:
                return None, 0
            self.stats["shrinks"] += 1
            self._emit("WARNING",
                       f"no capacity for world={world}; shrinking gang "
                       f"to {shrunk}", world=world, shrunk=shrunk)
            logger.warning("elastic: shrinking gang %d -> %d", world,
                           shrunk)
            world = shrunk
        return None, 0

    # -- main loop ------------------------------------------------------
    def fit(self) -> Result:
        t = self.trainer
        failures = 0
        world = self.target
        pg = None
        experiment = t.run_config.name or "train"
        run_id = train_obs.next_run_id(experiment)
        attempt = 0          # gang-restart index within this fit
        interrupt_ts: Optional[float] = None
        latest_ckpt: Optional[str] = (
            t._resume.path if t._resume else None)
        history: List[dict] = []
        last_metrics: Dict[str, Any] = {}

        def finish(error: Optional[BaseException]) -> Result:
            ckpt = Checkpoint(latest_ckpt) if latest_ckpt else None
            self.stats["final_world"] = world
            t.elastic_stats = self.stats
            return Result(metrics=last_metrics, checkpoint=ckpt,
                          error=error, metrics_history=history,
                          config=t._config, elastic=dict(self.stats))

        while True:
            if pg is None:
                pg, world = self._form_gang(world)
                if pg is None:
                    failures += 1
                    RESTARTS_TOTAL.inc(tags={"cause": "preemption"})
                    self.stats["restarts"]["preemption"] += 1
                    if 0 <= self.fc.max_failures < failures:
                        return finish(RuntimeError(
                            f"no capacity for even a {self.min_world}-rank "
                            f"gang"))
                    time.sleep(self.backoff.next_delay())
                    world = max(self.min_world,
                                min(self.target, self._feasible_world()))
                    continue
            try:
                group = WorkerGroup(
                    num_workers=world,
                    resources=self.scaling.worker_resources(),
                    strategy=self.scaling.placement_strategy,
                    backend_name=t._backend(),
                    trial_dir=t.run_config.resolve_storage(),
                    experiment_name=experiment,
                    pg=pg, ready_timeout=self.replace_timeout,
                    run_meta={
                        "run_id": run_id, "attempt": attempt,
                        "flops_per_step": self.scaling.flops_per_step})
            except Exception as e:  # noqa: BLE001 — PG demoted under us
                failures += 1
                attempt += 1
                interrupt_ts = time.time()
                self.stats["restarts"]["preemption"] += 1
                RESTARTS_TOTAL.inc(tags={"cause": "preemption"})
                if 0 <= self.fc.max_failures < failures:
                    remove_placement_group(pg)
                    return finish(e)
                time.sleep(self.backoff.next_delay())
                if not pg.ready(timeout=self.replace_timeout):
                    remove_placement_group(pg)
                    pg = None
                    world = max(self.min_world,
                                min(world - 1, self._feasible_world()))
                continue
            try:
                # Bounded: a gang forming on a node that is dying but
                # not yet declared dead must surface as a formation
                # failure, not block fit() until the health check.
                start_to = max(10.0, 2.0 * self.replace_timeout)
                master_env = t._backend().master_env(
                    *group.master_addr(timeout=start_to))
                group.start_all(t._fn, t._config, master_env,
                                latest_ckpt, t._shard_fn,
                                timeout=start_to)
                # Restart gap: failure detection -> new gang running,
                # charged to lost_restart by the GCS TrainRunState.
                gap = (time.time() - interrupt_ts) if interrupt_ts else 0.0
                interrupt_ts = None
                train_obs.emit_run_event(
                    experiment, run_id,
                    f"gang start (attempt {attempt}, world {world})",
                    attempt=attempt, world=world, gap_s=round(gap, 3))
                m, latest_ckpt, part = self._drain(group, world,
                                                   latest_ckpt)
                # A resumed gang that was already past its last step
                # reports nothing — keep the pre-restart metrics then.
                last_metrics = m or last_metrics
                history.extend(part)
                self.backoff.reset()
                if latest_ckpt is None and t._resume:
                    latest_ckpt = t._resume.path
                group.shutdown(remove_pg=True)
                pg = None
                return finish(None)
            except _GrowSignal as g:
                history.extend(g.history)
                if g.latest_checkpoint:
                    latest_ckpt = g.latest_checkpoint
                last_metrics = g.last_metrics or last_metrics
                attempt += 1
                interrupt_ts = time.time()
                self.stats["grows"] += 1
                RESTARTS_TOTAL.inc(tags={"cause": "grow"})
                self._emit("INFO",
                           f"capacity returned; growing gang {world} -> "
                           f"{g.new_world}", world=world,
                           new_world=g.new_world)
                logger.info("elastic: growing gang %d -> %d", world,
                            g.new_world)
                group.shutdown(remove_pg=True)
                pg = None
                world = g.new_world
                self.backoff.reset()
                continue
            except _RankFailure as f:
                history.extend(f.history)
                if f.latest_checkpoint:
                    latest_ckpt = f.latest_checkpoint
                last_metrics = f.last_metrics or last_metrics
                failures += 1
                attempt += 1
                interrupt_ts = time.time()
                self.stats["restarts"][f.cause] = (
                    self.stats["restarts"].get(f.cause, 0) + 1)
                RESTARTS_TOTAL.inc(tags={"cause": f.cause})
                self._emit("WARNING",
                           f"rank {f.rank} {f.cause}; gang restart "
                           f"(failure {failures})", rank=f.rank,
                           cause=f.cause, world=world)
                logger.warning(
                    "elastic: rank %s %s (%s); restarting from %s",
                    f.rank, f.cause, f.detail.splitlines()[-1][:200]
                    if f.detail else "", latest_ckpt)
                if 0 <= self.fc.max_failures < failures:
                    group.shutdown(remove_pg=True)
                    pg = None
                    return finish(RuntimeError(f.detail or f.cause))
                # Kill the flagged rank (SIGKILL lands even on a
                # SIGSTOPped straggler), keep the PG: surviving bundles
                # stay reserved while the GCS re-places only the holes.
                if f.rank is not None:
                    group.kill_rank(f.rank)
                group.shutdown(remove_pg=False)
                time.sleep(self.backoff.next_delay())
                # Replacement: the gang is whole again when the PG is
                # back to CREATED (bundle-granular re-reserve, or it
                # never left CREATED for a worker-only death).
                if pg.ready(timeout=self.replace_timeout):
                    continue
                # No replacement bundle: shrink.
                remove_placement_group(pg)
                pg = None
                feasible = self._feasible_world()
                world = max(self.min_world, min(world - 1, feasible,
                                                self.target))
                self.stats["shrinks"] += 1
                self._emit(
                    "WARNING",
                    f"no replacement bundle within "
                    f"{self.replace_timeout:.0f}s; resuming at "
                    f"world={world}", world=world)
                logger.warning(
                    "elastic: no replacement bundle; resuming at "
                    "world=%d", world)
            except Exception as e:  # noqa: BLE001 — gang formation died
                failures += 1
                attempt += 1
                interrupt_ts = time.time()
                cause = classify_failure(repr(e))
                self.stats["restarts"][cause] = (
                    self.stats["restarts"].get(cause, 0) + 1)
                RESTARTS_TOTAL.inc(tags={"cause": cause})
                group.shutdown(remove_pg=False)
                if 0 <= self.fc.max_failures < failures:
                    group.shutdown(remove_pg=True)
                    pg = None
                    return finish(e)
                time.sleep(self.backoff.next_delay())
                if not pg.ready(timeout=self.replace_timeout):
                    remove_placement_group(pg)
                    pg = None
                    world = max(self.min_world,
                                min(world - 1, self._feasible_world()))

    # -- drain with per-rank verdicts -----------------------------------
    def _drain(self, group: WorkerGroup, world: int,
               latest_ckpt: Optional[str]):
        """Poll each rank until all finish. Raises _RankFailure with a
        per-rank verdict (death/preemption from the actor plane, hang
        from progress timestamps + the daemons' HangWatchdog) or
        _GrowSignal when a shrunk gang can grow back."""
        history: List[dict] = []
        last_metrics: Dict[str, Any] = {}
        # rank -> first moment poll RPCs stopped answering.
        unresponsive_since: Dict[int, float] = {}
        last_watchdog = time.monotonic()
        next_grow = time.monotonic() + self.grow_check
        finished = [False] * world
        # Per-poll deadline scales with the hang threshold so a tiny
        # test threshold yields verdicts in seconds, not 2 x 5s RPCs.
        poll_timeout = (max(0.5, min(5.0, self.hang_timeout))
                        if self.hang_timeout > 0 else 5.0)

        def fail(cause, rank, detail):
            raise _RankFailure(cause, rank, detail) \
                ._with(history, latest_ckpt, last_metrics)

        while True:
            now = time.monotonic()
            for rank in range(world):
                if finished[rank]:
                    continue
                try:
                    p = group.poll_rank(rank, timeout=poll_timeout)
                except (GetTimeoutError, ActorUnavailableError):
                    # Unreachable is NOT authoritatively dead: a
                    # SIGSTOPped straggler and a killed worker look the
                    # same from here. Track it; the GCS's death verdict
                    # (ActorDiedError on a later poll) or the hang
                    # threshold decides which it was.
                    since = unresponsive_since.setdefault(rank, now)
                    if now - since >= self.hang_timeout:
                        fail("hang", rank,
                             f"rank {rank} unresponsive for "
                             f"{now - since:.0f}s")
                    continue
                except ActorDiedError as e:
                    cause = classify_failure(f"{type(e).__name__}: {e}")
                    fail("death" if cause == "error" else cause,
                         rank, str(e))
                except Exception as e:  # noqa: BLE001
                    fail(classify_failure(repr(e)), rank, repr(e))
                unresponsive_since.pop(rank, None)
                for item in p["results"]:
                    if item["checkpoint"]:
                        latest_ckpt = item["checkpoint"]
                    if rank == 0:
                        last_metrics = item["metrics"]
                        history.append(item["metrics"])
                if p["error"]:
                    fail("error", rank, p["error"])
                if p["finished"]:
                    finished[rank] = True
                    continue
                # A rank that answers polls but stopped reporting past
                # the hang threshold is a straggler (same knob as the
                # daemon watchdog, so both verdicts agree).
                lp = p.get("last_progress_ts")
                if (self.hang_timeout > 0 and lp is not None
                        and time.time() - lp >= self.hang_timeout):
                    fail("hang", rank,
                         f"rank {rank} made no progress for "
                         f"{time.time() - lp:.0f}s")
            if all(finished):
                return last_metrics, latest_ckpt, history
            # Daemon HangWatchdog verdicts (GCS hung-task view), matched
            # back to gang pids — catches a rank wedged in native code
            # whose poll RPCs still answer through another thread.
            if now - last_watchdog >= max(1.0, self.hang_timeout / 4):
                last_watchdog = now
                rank = self._watchdog_flagged_rank(group)
                if rank is not None and not finished[rank]:
                    fail("hang", rank,
                         f"rank {rank} flagged hung by node watchdog")
            if now >= next_grow:
                next_grow = now + self.grow_check
                if world < self.target:
                    feasible = self._feasible_world(freed=world)
                    new_world = min(self.target, feasible)
                    if new_world > world:
                        raise _GrowSignal(new_world, history,
                                          latest_ckpt, last_metrics)
            time.sleep(0.05)

    def _watchdog_flagged_rank(self, group: WorkerGroup) -> Optional[int]:
        try:
            from ray_tpu_torch.util.state import hung_tasks

            flagged = hung_tasks()
        except Exception:  # noqa: BLE001
            return None
        pids = {pid: rank for rank, pid in enumerate(group.pids)
                if pid is not None}
        for rec in flagged:
            rank = pids.get(rec.get("pid"))
            if rank is not None:
                return rank
        return None


class _GrowSignal(Exception):
    def __init__(self, new_world: int, history: List[dict],
                 latest_checkpoint: Optional[str],
                 last_metrics: Dict[str, Any]):
        super().__init__(f"grow to {new_world}")
        self.new_world = new_world
        self.history = history
        self.latest_checkpoint = latest_checkpoint
        self.last_metrics = last_metrics
