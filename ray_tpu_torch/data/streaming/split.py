"""Elastic streaming split: ack-based block handout that survives
world-size changes mid-epoch (a copy of `ray_tpu/data/streaming/split.py`).

The legacy ``_SplitCoordinator`` (data/dataset.py) hands refs out
fire-and-forget: a consumer that dies between delivery and processing
silently loses its block, and a resize has no way to redistribute
queued work. This coordinator tracks one *outstanding* (delivered but
not yet acknowledged) block per consumer — requesting block k+1
acknowledges block k, matching the iterator's consume-then-request
discipline — so on ``resplit(new_n)`` or ``mark_dead(idx)`` the
unacknowledged blocks are requeued for the surviving consumers:

- no epoch restart — the single streaming execution keeps going
  (``epoch_id`` never changes across a resize);
- no lost samples — every unacked block goes back on the pending queue;
- no duplicates — acked blocks were fully consumed and are never
  replayed (the elastic supervisor re-invokes the shard fn only after
  the dead/stopped workers' last step committed).

(ref: python/ray/data/_internal/execution/operators/output_splitter.py
OutputSplitter — plus the Train elastic ingest semantics the reference
leaves to the caller.)
"""
from __future__ import annotations

import logging
from collections import deque
from typing import Any, Dict, List, Optional

import ray_tpu_torch

logger = logging.getLogger(__name__)


@ray_tpu_torch.remote(num_cpus=0)
class StreamSplitCoordinator:
    """Hands one streaming execution's block refs to N consumers with
    per-consumer outstanding tracking and live re-splitting."""

    def __init__(self, dataset, n: int, equal: bool = False):
        self._n = n
        self._equal = equal
        self._dataset = dataset
        self._it = iter(dataset.to_block_refs())
        self._queues: List[deque] = [deque() for _ in range(n)]
        self._pending: deque = deque()   # requeued (resplit / death)
        self._outstanding: Dict[int, Any] = {}
        self._next_rr = 0
        self._done = False
        self._epoch_id = 0          # never bumped by resize: one epoch
        self._delivered = 0
        self._acked = 0
        self._resplits = 0

    # -- source -----------------------------------------------------------
    def _pull(self):
        if self._pending:
            return self._pending.popleft()
        if self._done:
            return None
        try:
            return next(self._it)
        except StopIteration:
            self._done = True
            return self._pending.popleft() if self._pending else None

    def _exhausted(self) -> bool:
        return (self._done and not self._pending
                and not any(self._queues))

    # -- consumer protocol ------------------------------------------------
    def next_block(self, consumer_idx: int):
        """Next block ref for this consumer, or None when exhausted.
        Implicitly acks the consumer's previous block: the iterator
        only asks for k+1 after fully consuming k."""
        if consumer_idx in self._outstanding:
            self._outstanding.pop(consumer_idx)
            self._acked += 1
        if consumer_idx >= self._n:
            # Stale consumer from before a shrink: nothing for it.
            return None
        ref = None
        if self._equal:
            q = self._queues[consumer_idx]
            while not q and not self._exhausted():
                nxt = self._pull()
                if nxt is None:
                    break
                self._queues[self._next_rr].append(nxt)
                self._next_rr = (self._next_rr + 1) % self._n
            if q:
                ref = q.popleft()
        else:
            ref = self._pull()
        if ref is not None:
            self._outstanding[consumer_idx] = ref
            self._delivered += 1
        return ref

    def ack(self, consumer_idx: int) -> None:
        """Explicit ack (e.g. the train loop commits a step boundary
        before checkpointing); the implicit next_block ack covers the
        normal path."""
        if consumer_idx in self._outstanding:
            self._outstanding.pop(consumer_idx)
            self._acked += 1

    # -- elastic ----------------------------------------------------------
    def mark_dead(self, consumer_idx: int) -> None:
        """Requeue a killed consumer's unacked block so survivors get
        it (SIGKILL path: the block was delivered but never consumed)."""
        ref = self._outstanding.pop(consumer_idx, None)
        if ref is not None:
            self._pending.append(ref)
            logger.info("split consumer %d died with 1 outstanding "
                        "block; requeued", consumer_idx)

    def resplit(self, new_n: int) -> int:
        """Live world-size change: requeue every unacked/queued block
        and continue the SAME epoch with new_n consumers. Returns the
        new world size (for the caller's sanity check)."""
        for idx in list(self._outstanding):
            self._pending.append(self._outstanding.pop(idx))
        for q in self._queues:
            while q:
                self._pending.append(q.popleft())
        self._n = new_n
        self._queues = [deque() for _ in range(new_n)]
        self._next_rr = 0
        self._resplits += 1
        return new_n

    # -- introspection ----------------------------------------------------
    def stats(self) -> str:
        """`Dataset.stats()` of the execution this coordinator hands out
        (it runs here, not in the process that built the dataset)."""
        return self._dataset.stats()

    def progress(self) -> Dict[str, Any]:
        return {
            "epoch_id": self._epoch_id,
            "world": self._n,
            "delivered": self._delivered,
            "acked": self._acked,
            "outstanding": len(self._outstanding),
            "pending": len(self._pending),
            "resplits": self._resplits,
            "exhausted": self._exhausted(),
        }


class StreamingIngest:
    """Elastic train ingest over ONE streaming execution.

    Pass ``{"train": StreamingIngest(ds)}`` as a Trainer dataset: the
    trainer's shard fn calls :meth:`shard` on every gang formation, and
    a world-size change triggers ``resplit`` on the shared coordinator
    instead of re-executing the dataset — mid-epoch progress survives
    grow and shrink.  Pickles cleanly once the coordinator exists
    (actor handle + bookkeeping)."""

    def __init__(self, dataset, *, equal: bool = False,
                 block_timeout_s: Optional[float] = None):
        self._dataset = dataset
        self._equal = equal
        self._block_timeout_s = block_timeout_s
        self._coord = None
        self._world: Optional[int] = None

    @property
    def coordinator(self):
        return self._coord

    def shard(self, rank: int, world: int):
        from ray_tpu_torch.data.dataset import StreamingSplitIterator

        if self._coord is None:
            self._coord = StreamSplitCoordinator.remote(
                self._dataset, world, self._equal)
            self._world = world
        elif world != self._world:
            ray_tpu_torch.get(self._coord.resplit.remote(world))
            self._world = world
        return StreamingSplitIterator(self._coord, rank,
                                      self._block_timeout_s)

    # Trainer._shard_fn duck-types on split(); StreamingIngest is
    # handled explicitly there instead (needs rank AND world).
