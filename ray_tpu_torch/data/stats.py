"""Per-execution dataset statistics (a copy of `ray_tpu/data/stats.py`).

Analogue of the reference's DatasetStats (ref: python/ray/data/
_internal/stats.py — per-operator wall time/task counts surfaced by
`ds.stats()` after an execution). Collected driver-side by the streaming
executor; consumption counters (rows/bytes) fill in as blocks are
actually fetched by the iterating caller.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class StageStats:
    name: str
    tasks: int = 0
    first_submit: Optional[float] = None
    last_output: Optional[float] = None
    peak_queue: int = 0       # max observed operator input-queue depth
    peak_in_flight: int = 0   # max concurrently running tasks
    # -- streaming-executor byte accounting (data/streaming) --
    rows_out: int = 0         # rows produced by this operator
    bytes_out: int = 0        # bytes produced (sealed block sizes)
    stall_s: float = 0.0      # seconds submission was byte-backpressured
    peak_inflight_bytes: int = 0  # max produced-but-unconsumed bytes
    spilled_tasks: int = 0    # over-budget submissions via spill fallback

    def on_submit(self) -> None:
        self.tasks += 1
        if self.first_submit is None:
            self.first_submit = time.monotonic()

    def on_output(self, rows: int = 0, nbytes: int = 0) -> None:
        self.last_output = time.monotonic()
        self.rows_out += rows
        self.bytes_out += nbytes

    def on_stall(self, seconds: float) -> None:
        self.stall_s += seconds

    def on_inflight_bytes(self, n: int) -> None:
        self.peak_inflight_bytes = max(self.peak_inflight_bytes, n)

    def on_queue(self, depth: int) -> None:
        self.peak_queue = max(self.peak_queue, depth)

    def on_active(self, n: int) -> None:
        self.peak_in_flight = max(self.peak_in_flight, n)

    @property
    def wall_s(self) -> float:
        if self.first_submit is None or self.last_output is None:
            return 0.0
        return self.last_output - self.first_submit

    def overlaps(self, other: "StageStats") -> bool:
        """True when the two stages' execution windows intersect —
        the observable signature of pipelined operators."""
        if None in (self.first_submit, self.last_output,
                    other.first_submit, other.last_output):
            return False
        return (self.first_submit < other.last_output
                and other.first_submit < self.last_output)


class DatasetStats:
    def __init__(self):
        self.stages: List[StageStats] = []
        self.consumed_rows = 0
        self.consumed_bytes = 0
        self.started = time.monotonic()

    def new_stage(self, name: str) -> StageStats:
        st = StageStats(name)
        self.stages.append(st)
        return st

    def summary(self) -> str:
        lines = ["Dataset execution stats:"]
        for st in self.stages:
            line = (
                f"  {st.name}: {st.tasks} tasks, {st.wall_s * 1000:.0f} ms"
                f" wall, peak in-flight {st.peak_in_flight}, "
                f"peak queue {st.peak_queue}")
            if st.bytes_out or st.stall_s or st.rows_out:
                line += (
                    f", {st.rows_out} rows / "
                    f"{st.bytes_out / 1e6:.2f} MB out, "
                    f"stalled {st.stall_s * 1000:.0f} ms")
                if st.spilled_tasks:
                    line += f", spilled {st.spilled_tasks} tasks"
            lines.append(line)
        lines.append(
            f"  consumed: {self.consumed_rows} rows, "
            f"{self.consumed_bytes / 1e6:.2f} MB")
        return "\n".join(lines)
