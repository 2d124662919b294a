"""Byte-budgeted streaming operator graph — the default Dataset path (a
copy of `ray_tpu/data/streaming/executor.py`; `_store_fraction` reads the
port's store).

Extends the operator-graph executor (data/execution.py, kept as the
``RAY_TPU_DATA_STREAM_ENABLED=0`` fallback) with the reference's
byte-based backpressure model (ref: python/ray/data/_internal/execution/
backpressure_policy/streaming_output_backpressure_policy.py): operator
tasks return ``(block, meta)`` with ``num_returns=2`` so the tiny meta
object (rows/bytes) is fetched at harvest without materializing the
block, and every operator is charged for the bytes it has produced that
no downstream consumer has picked up yet.

Backpressure composes four ways here:

- task budget + bounded queues, inherited from the legacy executor
  (shrunk under object-store pressure via ``_effective_window``);
- a per-operator in-flight byte cap (``data_stream_op_inflight_bytes``)
  — an operator over its cap stops submitting, and the seconds it sits
  byte-blocked are accounted per stage in ``Dataset.stats()``;
- a global bytes window (``data_stream_window_bytes``) across the whole
  graph;
- the consumer: the executor is a generator, so when the caller stops
  pulling, scheduling pauses — and yielding a block to the caller is
  what releases its producer's budget.

Liveness: when the graph is byte-wedged with nothing in flight (a
single block larger than the window), the downstream-most blocked
operator is allowed one over-budget submission — the *spill fallback*,
accounted as ``spilled_tasks`` — as long as the local object store is
below ``data_stream_spill_threshold`` (beyond that the store's own
disk spilling is already straining). With no spill headroom the
executor raises :class:`~ray_tpu_torch.exceptions.BackpressureTimeout` after
``data_stream_stall_timeout_s`` of zero forward progress instead of
deadlocking silently.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.data.block import concat, num_rows, size_bytes
from ray_tpu_torch.data.execution import (
    _default_window,
    _effective_window,
    _group_name,
    _Operator,
    _split_actor_stages,
)
from ray_tpu_torch.data.plan import AllToAllStage, MapStage, ReadTask, fuse_map_chain
from ray_tpu_torch.data.stats import DatasetStats
from ray_tpu_torch.exceptions import BackpressureTimeout

logger = logging.getLogger(__name__)


def streaming_enabled() -> bool:
    return get_config().data_stream_enabled


def _store_fraction() -> float:
    """Local object-store used/capacity; 0.0 when unknowable (spill
    fallback stays available rather than wedging a storeless test)."""
    try:
        from ray_tpu_torch.api import _global_worker

        store = _global_worker().store
        cap = getattr(store, "capacity", 0)
        if cap:
            return store.used / cap
    except Exception:  # noqa: BLE001
        pass
    return 0.0


def _meta(blk) -> dict:
    return {"rows": num_rows(blk), "bytes": size_bytes(blk)}


def _run_read_meta(read_fn, map_fn):
    blocks = [read_fn()]
    if map_fn is not None:
        out: List[Any] = []
        for b in blocks:
            out.extend(map_fn(b))
        blocks = out
    blk = concat(blocks) if len(blocks) != 1 else blocks[0]
    return blk, _meta(blk)


def _run_map_meta(block, map_fn):
    out = list(map_fn(block))
    blk = concat(out) if len(out) != 1 else out[0]
    return blk, _meta(blk)


class _ByteBudget:
    """Shared byte ledger for one graph: global window + per-op cap."""

    def __init__(self, window_bytes: int, op_cap: int):
        self.window = max(1, window_bytes)
        self.op_cap = max(1, op_cap)
        self.total = 0


class _StreamItem:
    """A block ref flowing between operators, charged to its producer
    until a downstream submission (or the sink consumer) picks it up."""

    __slots__ = ("ref", "nbytes", "rows", "producer")

    def __init__(self, ref, nbytes: int, rows: int, producer):
        self.ref = ref
        self.nbytes = nbytes
        self.rows = rows
        self.producer = producer

    def consume(self):
        """Release the producer's byte charge; returns the bare ref."""
        if self.producer is not None:
            self.producer.release(self.nbytes)
            self.producer = None
        return self.ref


def _consume(item):
    return item.consume() if isinstance(item, _StreamItem) else item


class _StreamOp(_Operator):
    """Operator with produced-but-unconsumed byte accounting."""

    def __init__(self, name, budget, stats, depth, bytebudget: _ByteBudget):
        super().__init__(name, budget, stats, depth)
        self.bytebudget = bytebudget
        self.unconsumed = 0

    # -- byte ledger ----------------------------------------------------
    def charge(self, nbytes: int) -> None:
        self.unconsumed += nbytes
        self.bytebudget.total += nbytes
        self.stats.on_inflight_bytes(self.unconsumed)

    def release(self, nbytes: int) -> None:
        self.unconsumed -= nbytes
        self.bytebudget.total -= nbytes

    # -- scheduling interface -------------------------------------------
    def byte_blocked(self) -> bool:
        return (self.unconsumed >= self.bytebudget.op_cap
                or self.bytebudget.total >= self.bytebudget.window)

    def task_runnable(self) -> bool:
        return super().runnable()

    def runnable(self) -> bool:
        return self.task_runnable() and not self.byte_blocked()

    def stalled(self) -> bool:
        """Has work and task headroom but is held back purely by bytes —
        the condition whose duration lands in ``stats.stall_s``."""
        return self.task_runnable() and self.byte_blocked()

    # -- completion harvest ---------------------------------------------
    def harvest(self) -> bool:
        progressed = False
        while self.in_flight:
            (block_ref, meta_ref), extra = self.in_flight[0]
            done, _ = ray_tpu_torch.wait([block_ref], num_returns=1, timeout=0)
            if not done:
                break
            self.in_flight.popleft()
            self._on_done(extra)
            try:
                m = ray_tpu_torch.get(meta_ref)
                rows, nbytes = int(m["rows"]), int(m["bytes"])
            except Exception:  # noqa: BLE001 — task failed: let the
                rows, nbytes = 0, 0   # error surface at the consumer's get
            self.charge(nbytes)
            self.outqueue.append(_StreamItem(block_ref, nbytes, rows, self))
            self.stats.on_output(rows, nbytes)
            progressed = True
        return progressed


class _StreamTaskMapOp(_StreamOp):
    def __init__(self, name, fused_fn, budget, stats, depth, bytebudget,
                 remote_fn=None, pack=None):
        super().__init__(name, budget, stats, depth, bytebudget)
        self._fn = fused_fn
        self._remote = (remote_fn
                        or ray_tpu_torch.remote(_run_map_meta)
                        ).options(num_returns=2)
        self._pack = pack or (lambda item, fn: (_consume(item), fn))

    def _launch(self, item):
        refs = self._remote.remote(*self._pack(item, self._fn))
        return tuple(refs), None


class _StreamActorPool:
    """Least-loaded actor pool whose UDF actors also report block meta
    (mirror of execution._ActorPool with ``num_returns=2`` methods)."""

    def __init__(self, fn_maker, size: int):
        @ray_tpu_torch.remote
        class _MapActor:
            def __init__(self, maker):
                self._fn = maker()

            def apply(self, block):
                out = list(self._fn(block))
                blk = concat(out) if len(out) != 1 else out[0]
                return blk, _meta(blk)

        self.actors = [_MapActor.remote(fn_maker) for _ in range(size)]
        self._apply = [a.apply.options(num_returns=2) for a in self.actors]
        self.load = [0] * size

    def submit(self, block_ref):
        i = min(range(len(self.actors)), key=lambda j: self.load[j])
        self.load[i] += 1
        refs = self._apply[i].remote(block_ref)
        return i, tuple(refs)

    def done(self, i):
        self.load[i] -= 1

    def shutdown(self):
        for a in self.actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                pass


class _StreamActorMapOp(_StreamOp):
    def __init__(self, name, stage: MapStage, stats, depth, bytebudget):
        self._stage = stage
        self._pool: Optional[_StreamActorPool] = None
        self._size = max(1, stage.num_actors)
        super().__init__(name, budget=2 * self._size, stats=stats,
                         depth=depth, bytebudget=bytebudget)

    def _launch(self, item):
        if self._pool is None:   # lazy: actors spawn on first block
            self._pool = _StreamActorPool(self._stage.actor_fn_maker,
                                          self._size)
        i, refs = self._pool.submit(_consume(item))
        return refs, i

    def _on_done(self, i) -> None:
        self._pool.done(i)

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


def _build_stream_graph(map_stages, max_in_flight, stats: DatasetStats,
                        bytebudget: _ByteBudget,
                        with_source: bool = False) -> List[_StreamOp]:
    """Linear streaming-operator graph for one barrier-free segment
    (same segmentation/fusion rules as execution._build_graph)."""
    ops: List[_StreamOp] = []
    groups = _split_actor_stages(map_stages)

    if with_source:
        head_fused = None
        head_name = "Read"
        if groups and isinstance(groups[0], list):
            head_fused = fuse_map_chain([s.block_fn for s in groups[0]])
            head_name = "Read+" + _group_name(groups[0])
            groups = groups[1:]
        ops.append(_StreamTaskMapOp(
            head_name, head_fused, budget=max_in_flight,
            stats=stats.new_stage(head_name), depth=0,
            bytebudget=bytebudget,
            remote_fn=ray_tpu_torch.remote(_run_read_meta),
            pack=lambda task, fn: (task.fn, fn)))

    for g in groups:
        depth = len(ops)
        name = _group_name(g)
        if isinstance(g, list):
            fused = fuse_map_chain([s.block_fn for s in g])
            ops.append(_StreamTaskMapOp(name, fused, budget=max_in_flight,
                                        stats=stats.new_stage(name),
                                        depth=depth, bytebudget=bytebudget))
        else:
            ops.append(_StreamActorMapOp(name, g,
                                         stats=stats.new_stage(name),
                                         depth=depth, bytebudget=bytebudget))
    return ops


def _run_stream_graph(ops: List[_StreamOp],
                      feed: Optional[Iterator[Any]] = None) -> Iterator[Any]:
    """Scheduling loop: harvest -> propagate -> yield sink -> submit the
    runnable op with the most headroom (ties downstream-most), exactly
    as execution._run_graph — plus stall accounting on byte-blocked
    operators, the spill fallback, and the stall deadline."""
    if not ops:
        if feed is not None:
            yield from (_consume(x) for x in feed)
        return
    cfg = get_config()
    stall_deadline = max(0.01, cfg.data_stream_stall_timeout_s)
    feed_done = feed is None
    last_progress = time.monotonic()
    prev_stalled: List[_StreamOp] = []
    prev_t = last_progress
    try:
        while True:
            now = time.monotonic()
            # Accrue the time since the last pass to every operator that
            # spent it byte-blocked (busy passes contribute ~0; blocking
            # waits below are where stall seconds actually come from).
            for op in prev_stalled:
                op.stats.on_stall(now - prev_t)
            prev_t = now

            progressed = False
            while (not feed_done
                   and len(ops[0].inqueue) < ops[0].max_queue):
                try:
                    ops[0].feed(next(feed))
                    progressed = True
                except StopIteration:
                    feed_done = True
                    ops[0].upstream_done = True
            for op in ops:
                progressed |= op.harvest()
            for up, down in zip(ops, ops[1:]):
                while (up.outqueue
                       and len(down.inqueue) < down.max_queue):
                    down.feed(up.outqueue.popleft())
                    progressed = True
                if up.finished and not down.upstream_done:
                    down.upstream_done = True
                    progressed = True
            while ops[-1].outqueue:
                # Yielding transfers the byte charge to the consumer.
                yield ops[-1].outqueue.popleft().consume()
                progressed = True
            runnable = [op for op in ops if op.runnable()]
            if runnable:
                best = max(runnable,
                           key=lambda op: (op.headroom(), op.depth))
                best.submit_one()
                progressed = True
            prev_stalled = [op for op in ops if op.stalled()]
            if progressed:
                last_progress = time.monotonic()
                continue
            if all(op.finished for op in ops) and feed_done:
                return
            waited = time.monotonic() - last_progress
            heads = [op.in_flight[0][0][0] for op in ops if op.in_flight]
            if heads:
                # Bounded wait so stall seconds keep accruing and the
                # deadline below stays live even if a task never lands.
                ray_tpu_torch.wait(heads, num_returns=1,
                             timeout=min(0.5, stall_deadline))
                if not prev_stalled:
                    # Plain slow tasks, not backpressure: don't let the
                    # stall deadline fire on them.
                    last_progress = time.monotonic()
                continue
            if prev_stalled:
                if waited > stall_deadline:
                    worst = max(prev_stalled, key=lambda op: op.stats.stall_s)
                    raise BackpressureTimeout(
                        operator=worst.name, waited_s=worst.stats.stall_s,
                        inflight_bytes=worst.bytebudget.total)
                if _store_fraction() < cfg.data_stream_spill_threshold:
                    # Spill fallback: one over-budget submission so the
                    # graph keeps moving; the store absorbs the overrun
                    # (spilling to disk past its own threshold).
                    best = max(prev_stalled, key=lambda op: op.depth)
                    best.submit_one()
                    best.stats.spilled_tasks += 1
                    last_progress = time.monotonic()
                    continue
                time.sleep(min(0.05, stall_deadline / 4))
                continue
            raise RuntimeError(
                "operator-graph deadlock: no progress, nothing in "
                "flight, not finished — "
                + ", ".join(
                    f"{op.name}(in={len(op.inqueue)} "
                    f"out={len(op.outqueue)} done={op.upstream_done})"
                    for op in ops))
    finally:
        for op in ops:
            op.shutdown()


def streaming_execute(read_tasks: List[ReadTask], stages: List[Any], *,
                      max_in_flight: Optional[int] = None,
                      stats: Optional[DatasetStats] = None) -> Iterator[Any]:
    """Yield block refs for the fully-applied plan through the
    byte-budgeted streaming graph (drop-in for execution.execute)."""
    cfg = get_config()
    if max_in_flight is None:
        max_in_flight = _default_window()
    if stats is None:
        stats = DatasetStats()
    bytebudget = _ByteBudget(cfg.data_stream_window_bytes,
                             cfg.data_stream_op_inflight_bytes)

    segments: List[List[Any]] = [[]]
    for st in stages:
        if isinstance(st, AllToAllStage):
            segments.append(st)
            segments.append([])
        else:
            segments[-1].append(st)

    stream: Iterator[Any] = _run_stream_graph(
        _build_stream_graph(segments[0], max_in_flight, stats, bytebudget,
                            with_source=True),
        feed=iter(read_tasks))
    i = 1
    while i < len(segments):
        barrier: AllToAllStage = segments[i]
        bstat = stats.new_stage(barrier.name)
        bstat.on_submit()
        refs = barrier.ref_fn(stream)
        bstat.on_output()
        ops = _build_stream_graph(segments[i + 1], max_in_flight, stats,
                                  bytebudget)
        stream = _run_stream_graph(ops, feed=iter(refs))
        i += 2
    yield from (_consume(x) for x in stream)
