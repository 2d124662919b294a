"""Logical plan: read tasks + stages, with map-stage fusion (a copy of
`ray_tpu/data/plan.py`).

Reference shape: lazy logical→physical planning + streaming execution
(ref: python/ray/data/_internal/logical/, planner/, execution/
streaming_executor.py:55).  Simplified two-kind algebra: `MapStage`
(block→blocks, fused into its upstream producer task) and `AllToAllStage`
(needs the full upstream ref list: shuffle/sort/repartition/groupby).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, List, Optional

from ray_tpu_torch.data.block import Block


@dataclasses.dataclass
class ReadTask:
    """A deferred producer of one block (readers pre-split work into these)."""
    fn: Callable[[], Block]
    name: str = "read"


@dataclasses.dataclass
class MapStage:
    """block -> iterable[Block]; pure function of one block, fusable."""
    name: str
    block_fn: Callable[[Block], Iterable[Block]]
    # Stateful UDF support (ActorPool compute): when set, block_fn is
    # produced per-actor by calling make_fn(cls_args already bound).
    actor_fn_maker: Optional[Callable[[], Callable[[Block], Iterable[Block]]]] = None
    num_actors: int = 0


@dataclasses.dataclass
class AllToAllStage:
    """list[ref] -> list[ref]; materializes its input frontier."""
    name: str
    ref_fn: Callable[[List[Any]], List[Any]]  # refs in, refs out


Stage = Any  # MapStage | AllToAllStage


def fuse_map_chain(fns: List[Callable[[Block], Iterable[Block]]]
                   ) -> Callable[[Block], Iterable[Block]]:
    def fused(block: Block) -> Iterable[Block]:
        blocks = [block]
        for fn in fns:
            nxt: List[Block] = []
            for b in blocks:
                nxt.extend(fn(b))
            blocks = nxt
        return blocks

    return fused
