"""Operator-graph streaming executor, a copy of `ray_tpu/data/execution.py`
(the legacy path behind `data_stream_enabled=0`).

The reference runs each dataset as a graph of concurrent operators with
per-operator resource budgets, a scheduling step that picks which
operator to advance, and pluggable backpressure
(ref: python/ray/data/_internal/execution/streaming_executor.py:55,
streaming_executor_state.py:494 `select_operator_to_run`,
backpressure_policy/). This module is the equivalent:

- Each map segment becomes a linear graph of operators (a read source,
  fused task-map operators, actor-pool operators). Every operator owns a
  BOUNDED input queue, an in-flight task budget, and a bounded output
  queue.
- A scheduling step harvests completions, propagates blocks between
  queues, then advances the RUNNABLE operator with the most headroom
  (free budget fraction; ties drain downstream-most first) — one task
  per step, so all operators genuinely overlap instead of running as
  chained sliding windows.
- Backpressure composes three ways: the in-flight budget (shrunk under
  object-store pressure, ref: concurrency_cap/streaming_output
  backpressure policies), the bounded inter-operator queues, and the
  consumer itself — the executor is a generator, so when the caller
  stops pulling, scheduling pauses.

Blocks stay ordered (completions are harvested in submission order per
operator), matching the reference's default preserve_order=False cost
model conservatively. All-to-all stages remain barriers between
segments, as in the reference's plan segmentation.
"""
from __future__ import annotations

import logging
from collections import deque
from typing import Any, Callable, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, concat
from ray_tpu_torch.data.plan import AllToAllStage, MapStage, ReadTask, fuse_map_chain
from ray_tpu_torch.data.stats import DatasetStats, StageStats

logger = logging.getLogger(__name__)

DEFAULT_MAX_IN_FLIGHT = 16


def _default_window() -> int:
    """Resource-aware per-operator budget (ref: backpressure_policy/
    concurrency_cap_backpressure_policy.py): enough in-flight tasks to
    cover the cluster's CPUs twice, bounded."""
    try:
        cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 4))
    except Exception:  # noqa: BLE001
        cpus = 4
    return max(4, min(2 * cpus, 64))


def _effective_window(base: int) -> int:
    """Shrink a budget under object-store pressure (ref:
    backpressure_policy/streaming_output_backpressure_policy.py — the
    executor must not outrun consumers into an overflowing store)."""
    try:
        from ray_tpu_torch.api import _global_worker

        store = _global_worker().store
        cap = getattr(store, "capacity", 0)
        if cap and store.used / cap > 0.85:
            return max(2, base // 4)
    except Exception:  # noqa: BLE001
        pass
    return base


def _run_read(read_fn, map_fn) -> Block:
    blocks = [read_fn()]
    if map_fn is not None:
        out: List[Block] = []
        for b in blocks:
            out.extend(map_fn(b))
        blocks = out
    return concat(blocks) if len(blocks) != 1 else blocks[0]


def _run_map(block: Block, map_fn) -> Block:
    out = list(map_fn(block))
    return concat(out) if len(out) != 1 else out[0]


class _ActorPool:
    """Small pool of UDF-holding actors with least-loaded dispatch
    (ref: execution/operators/actor_pool_map_operator.py)."""

    def __init__(self, fn_maker, size: int):
        @ray_tpu_torch.remote
        class _MapActor:
            def __init__(self, maker):
                self._fn = maker()

            def apply(self, block):
                out = list(self._fn(block))
                return concat(out) if len(out) != 1 else out[0]

        self.actors = [_MapActor.remote(fn_maker) for _ in range(size)]
        self.load = [0] * size

    def submit(self, block_ref):
        i = min(range(len(self.actors)), key=lambda j: self.load[j])
        self.load[i] += 1
        ref = self.actors[i].apply.remote(block_ref)
        return i, ref

    def done(self, i):
        self.load[i] -= 1

    def shutdown(self):
        for a in self.actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                pass


class _Operator:
    """One node of the operator graph: bounded inqueue -> budgeted
    in-flight remote tasks -> bounded outqueue (ref: execution/
    interfaces/physical_operator.py — an operator owns its task pool
    and exposes readiness to the scheduling loop)."""

    def __init__(self, name: str, budget: int, stats: StageStats,
                 depth: int):
        self.name = name
        self.budget = budget
        self.max_queue = 2 * budget   # inter-op queue bound
        self.stats = stats
        self.depth = depth
        self.inqueue: deque = deque()
        self.in_flight: deque = deque()   # (ref, extra) submission order
        self.outqueue: deque = deque()
        self.upstream_done = False

    # -- source feeding -------------------------------------------------
    def feed(self, item: Any) -> None:
        self.inqueue.append(item)
        self.stats.on_queue(len(self.inqueue))

    # -- scheduling interface -------------------------------------------
    def runnable(self) -> bool:
        return (bool(self.inqueue)
                and len(self.in_flight) < _effective_window(self.budget)
                and len(self.in_flight) + len(self.outqueue)
                < self.max_queue)

    def headroom(self) -> float:
        return 1.0 - len(self.in_flight) / max(1, self.budget)

    def submit_one(self) -> None:
        item = self.inqueue.popleft()
        ref, extra = self._launch(item)
        self.in_flight.append((ref, extra))
        self.stats.on_submit()
        self.stats.on_active(len(self.in_flight))

    def _launch(self, item):
        raise NotImplementedError

    def _on_done(self, extra) -> None:
        pass

    # -- completion harvest (in submission order) -----------------------
    def harvest(self) -> bool:
        progressed = False
        while self.in_flight:
            ref, extra = self.in_flight[0]
            done, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
            if not done:
                break
            self.in_flight.popleft()
            self._on_done(extra)
            self.outqueue.append(ref)
            self.stats.on_output()
            progressed = True
        return progressed

    @property
    def finished(self) -> bool:
        return (self.upstream_done and not self.inqueue
                and not self.in_flight and not self.outqueue)

    def shutdown(self) -> None:
        pass


class _TaskMapOp(_Operator):
    def __init__(self, name, fused_fn, budget, stats, depth,
                 remote_fn=None, pack=None):
        super().__init__(name, budget, stats, depth)
        self._fn = fused_fn
        self._remote = remote_fn or ray_tpu_torch.remote(_run_map)
        self._pack = pack or (lambda item, fn: (item, fn))

    def _launch(self, item):
        return self._remote.remote(*self._pack(item, self._fn)), None


class _ActorMapOp(_Operator):
    def __init__(self, name, stage: MapStage, stats, depth):
        self._stage = stage
        self._pool: Optional[_ActorPool] = None
        self._size = max(1, stage.num_actors)
        super().__init__(name, budget=2 * self._size, stats=stats,
                         depth=depth)

    def _launch(self, item):
        if self._pool is None:   # lazy: actors spawn on first block
            self._pool = _ActorPool(self._stage.actor_fn_maker,
                                    self._size)
        i, ref = self._pool.submit(item)
        return ref, i

    def _on_done(self, i) -> None:
        self._pool.done(i)

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


def _split_actor_stages(stages: List[MapStage]):
    """Group consecutive task-fusable stages; actor stages break fusion."""
    groups: List[Any] = []
    cur: List[MapStage] = []
    for st in stages:
        if st.actor_fn_maker is not None:
            if cur:
                groups.append(cur)
                cur = []
            groups.append(st)
        else:
            cur.append(st)
    if cur:
        groups.append(cur)
    return groups


def _group_name(group) -> str:
    if isinstance(group, list):
        return "+".join(s.name for s in group) or "Map"
    return group.name


def _build_graph(map_stages, max_in_flight, stats: DatasetStats,
                 with_source: bool = False) -> List[_Operator]:
    """Linear operator graph for one barrier-free segment. With
    `with_source`, the head operator executes ReadTasks (fed lazily by
    _run_graph through the same bounded inqueue as every other op, so
    its queue stats reflect real backpressure, not the parallelism)."""
    ops: List[_Operator] = []
    groups = _split_actor_stages(map_stages)

    if with_source:
        head_fused = None
        head_name = "Read"
        if groups and isinstance(groups[0], list):
            head_fused = fuse_map_chain([s.block_fn for s in groups[0]])
            head_name = "Read+" + _group_name(groups[0])
            groups = groups[1:]
        ops.append(_TaskMapOp(head_name, head_fused,
                              budget=max_in_flight,
                              stats=stats.new_stage(head_name), depth=0,
                              remote_fn=ray_tpu_torch.remote(_run_read),
                              pack=lambda task, fn: (task.fn, fn)))

    for g in groups:
        depth = len(ops)
        name = _group_name(g)
        if isinstance(g, list):
            fused = fuse_map_chain([s.block_fn for s in g])
            ops.append(_TaskMapOp(name, fused, budget=max_in_flight,
                                  stats=stats.new_stage(name),
                                  depth=depth))
        else:
            ops.append(_ActorMapOp(name, g, stats=stats.new_stage(name),
                                   depth=depth))
    return ops


def _run_graph(ops: List[_Operator],
               feed: Optional[Iterator[Any]] = None) -> Iterator[Any]:
    """The scheduling loop (ref: streaming_executor_state.py:494).

    Repeats: harvest completions -> propagate between bounded queues ->
    yield sink output -> advance the runnable operator with the most
    headroom. Blocks on the head in-flight refs only when no step can
    make progress. `feed` lazily supplies the first operator's input
    (refs from an upstream barrier)."""
    if not ops:
        if feed is not None:
            yield from feed
        return
    feed_done = feed is None
    try:
        while True:
            progressed = False
            # Pull upstream refs into the head inqueue (bounded).
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
                yield ops[-1].outqueue.popleft()
                progressed = True
            runnable = [op for op in ops if op.runnable()]
            if runnable:
                # THE scheduling step: most free budget wins; ties go
                # downstream-most so the pipeline drains.
                best = max(runnable,
                           key=lambda op: (op.headroom(), op.depth))
                best.submit_one()
                progressed = True
            if progressed:
                continue
            if all(op.finished for op in ops) and feed_done:
                return
            heads = [op.in_flight[0][0] for op in ops if op.in_flight]
            if not heads:
                # Unreachable by construction: an op with queued input
                # and zero in-flight is always runnable (the sink
                # outqueue is drained above). Fail loudly rather than
                # busy-spin if a future runnable() change breaks that.
                raise RuntimeError(
                    "operator-graph deadlock: no progress, nothing in "
                    "flight, not finished — "
                    + ", ".join(
                        f"{op.name}(in={len(op.inqueue)} "
                        f"out={len(op.outqueue)} done={op.upstream_done})"
                        for op in ops))
            ray_tpu_torch.wait(heads, num_returns=1, timeout=None)
    finally:
        for op in ops:
            op.shutdown()


def execute(read_tasks: List[ReadTask], stages: List[Any], *,
            max_in_flight: Optional[int] = None,
            stats: Optional[DatasetStats] = None) -> Iterator[Any]:
    """Yield block refs for the fully-applied plan, streaming."""
    if max_in_flight is None:
        max_in_flight = _default_window()
    if stats is None:
        stats = DatasetStats()
    # Split the stage list into segments separated by all-to-all barriers.
    segments: List[List[Any]] = [[]]
    for st in stages:
        if isinstance(st, AllToAllStage):
            segments.append(st)
            segments.append([])
        else:
            segments[-1].append(st)

    stream: Iterator[Any] = _run_graph(
        _build_graph(segments[0], max_in_flight, stats,
                     with_source=True),
        feed=iter(read_tasks))
    i = 1
    while i < len(segments):
        barrier: AllToAllStage = segments[i]
        bstat = stats.new_stage(barrier.name)
        bstat.on_submit()
        # ref_fn receives the (lazy) upstream ref iterator; most barriers
        # list() it, but streaming ones (Limit) can stop pulling early.
        refs = barrier.ref_fn(stream)
        bstat.on_output()
        ops = _build_graph(segments[i + 1], max_in_flight, stats)
        stream = _run_graph(ops, feed=iter(refs))
        i += 2
    yield from stream
