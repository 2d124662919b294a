"""Data-plane observability (a copy of `ray_tpu/data/streaming/metrics.py`,
over the port's `util/metrics.py`): per-operator gauges for the streaming
executor, federated over the existing report-gauges → syncer → GCS
path (the same ``report_metrics`` RPC the serve plane pushes through),
so they reach the GCS next to the transfer and serve metrics.

Gauges are process-local (registered once in whatever process runs the
executor — usually the driver) and pushed best-effort after each
execution plus whenever a prefetcher closes; a missing daemon (local
mode, unit tests) degrades to registry-only.
"""
from __future__ import annotations

from typing import Optional

from ray_tpu_torch.util.metrics import Counter, Gauge

_M: Optional[dict] = None


def _metrics() -> dict:
    global _M
    if _M is None:
        _M = {
            "blocks_inflight": Gauge(
                "data_op_blocks_in_flight",
                "Blocks produced by the operator awaiting consumption",
                ("dataset", "operator")),
            "bytes_inflight": Gauge(
                "data_op_bytes_in_flight",
                "Produced-but-unconsumed bytes charged to the operator",
                ("dataset", "operator")),
            "stall_seconds": Gauge(
                "data_op_stall_seconds",
                "Seconds the operator sat byte-backpressured",
                ("dataset", "operator")),
            "bytes_out": Counter(
                "data_op_bytes_out",
                "Total bytes produced by the operator",
                ("dataset", "operator")),
            "spilled_tasks": Counter(
                "data_op_spilled_tasks",
                "Over-budget submissions taken via the spill fallback",
                ("dataset", "operator")),
            "shuffle_gbps": Gauge(
                "data_shuffle_gbps",
                "Aggregate GB/s of the most recent all-to-all shuffle",
                ("dataset",)),
            "shuffle_bytes": Gauge(
                "data_shuffle_bytes",
                "Bundle bytes of the most recent all-to-all shuffle",
                ("dataset",)),
            "shuffle_seconds": Gauge(
                "data_shuffle_seconds",
                "Seconds of the most recent all-to-all shuffle, mappers to "
                "reducers",
                ("dataset",)),
            "prefetch_hits": Counter(
                "data_prefetch_hits",
                "Device batches already resident when the consumer asked",
                ("dataset",)),
            "prefetch_misses": Counter(
                "data_prefetch_misses",
                "Device-batch requests that had to wait on the pipeline",
                ("dataset",)),
        }
    return _M


def _push(origin: str = "data") -> None:
    from ray_tpu_torch.serve.observability import push_registry

    push_registry(origin)


def on_execution(dataset: str, stats) -> None:
    """Fold one finished (or abandoned) execution's DatasetStats into
    the gauges and push toward the federation path."""
    try:
        m = _metrics()
        for st in stats.stages:
            tags = {"dataset": dataset, "operator": st.name}
            m["bytes_inflight"].set(float(st.peak_inflight_bytes), tags)
            m["blocks_inflight"].set(float(st.peak_queue), tags)
            m["stall_seconds"].set(st.stall_s, tags)
            if st.bytes_out:
                m["bytes_out"].inc(float(st.bytes_out), tags)
            if st.spilled_tasks:
                m["spilled_tasks"].inc(float(st.spilled_tasks), tags)
        _push()
    except Exception:  # noqa: BLE001 — telemetry must never break the plane
        pass


def on_shuffle(dataset: str, nbytes: int, seconds: float) -> None:
    try:
        m, tags = _metrics(), {"dataset": dataset}
        m["shuffle_bytes"].set(float(nbytes), tags)
        m["shuffle_seconds"].set(seconds, tags)
        if seconds > 0:
            m["shuffle_gbps"].set(nbytes / seconds / 1e9, tags)
        _push()
    except Exception:  # noqa: BLE001
        pass


def on_prefetch(dataset: str, hits: int, misses: int) -> None:
    """One prefetcher lifetime's counts (recorded once, at close)."""
    try:
        m = _metrics()
        tags = {"dataset": dataset}
        if hits:
            m["prefetch_hits"].inc(float(hits), tags)
        if misses:
            m["prefetch_misses"].inc(float(misses), tags)
        _push()
    except Exception:  # noqa: BLE001
        pass
