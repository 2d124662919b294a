"""Metrics: Counter/Gauge/Histogram + process registry + Prometheus text.

The port's copy of `ray_tpu/util/metrics.py`,
importing `ray_tpu_torch` only.

User-facing API mirrors the reference (ref: python/ray/util/metrics.py:19
Counter, :137 Gauge/Histogram); the process-wide registry and text
exposition replace the reference's OpenCensus->metrics-agent->Prometheus
pipeline (ref: src/ray/stats/metric_defs.cc) with a single in-process
registry each daemon/worker exposes directly.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

_TagKey = Tuple[Tuple[str, str], ...]


def _tagkey(tags: Optional[Dict[str, str]]) -> _TagKey:
    return tuple(sorted((tags or {}).items()))


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        if not name.replace("_", "a").replace(":", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        get_registry().register(self)

    def _share_state(self, other: "Metric") -> None:
        """Alias this instance's sample storage onto `other`'s (registry
        name-collision adoption): both instances observe into ONE sample
        set while keeping their own default tags."""
        raise NotImplementedError

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags: Optional[Dict[str, str]]) -> _TagKey:
        if self._default_tags:
            merged = dict(self._default_tags)
            merged.update(tags or {})
            return _tagkey(merged)
        return _tagkey(tags)

    def key(self, tags: Optional[Dict[str, str]] = None) -> _TagKey:
        """Precompute a sample key for the *_key fast paths: hot sites
        (the RPC transport observes ~10 samples per round trip) resolve
        tags once per (service, method) instead of building + sorting a
        dict per observation."""
        return self._merged(tags)

    # exposition
    def kind(self) -> str:
        raise NotImplementedError

    def samples(self) -> List[Tuple[_TagKey, float]]:
        raise NotImplementedError


class Counter(Metric):
    """Monotonically increasing value (ref: util/metrics.py:19)."""

    def __init__(self, name, description="", tag_keys=()):
        self._values: Dict[_TagKey, float] = defaultdict(float)
        super().__init__(name, description, tag_keys)

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("Counter.inc() takes a non-negative value")
        with self._lock:
            self._values[self._merged(tags)] += value

    def inc_key(self, key: _TagKey, value: float = 1.0) -> None:
        with self._lock:
            self._values[key] += value

    def _share_state(self, other: "Counter") -> None:
        self._values = other._values
        self._lock = other._lock

    def kind(self) -> str:
        return "counter"

    def samples(self):
        with self._lock:
            return list(self._values.items())


class Gauge(Metric):
    """Last-set value (ref: util/metrics.py Gauge)."""

    def __init__(self, name, description="", tag_keys=()):
        self._values: Dict[_TagKey, float] = {}
        super().__init__(name, description, tag_keys)

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._merged(tags)] = float(value)

    def inc(self, value: float = 1.0, tags=None) -> None:
        with self._lock:
            k = self._merged(tags)
            self._values[k] = self._values.get(k, 0.0) + value

    def dec(self, value: float = 1.0, tags=None) -> None:
        self.inc(-value, tags)

    def inc_key(self, key: _TagKey, value: float = 1.0) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def track(self, value: float = 1.0, tags=None):
        """Context manager: add `value` for the duration of a block —
        the in-flight-bytes / in-flight-requests idiom (the transfer
        plane's windowed pulls account their outstanding chunk bytes
        this way, so the gauge can never leak on an exception path)."""
        return _GaugeTrack(self, value, tags)

    def remove(self, tags: Optional[Dict[str, str]] = None) -> None:
        """Drop one labelset's sample entirely (a gauge mirroring an
        external entity — e.g. a serve replica that aged out — must stop
        exporting it, not pin the last value forever)."""
        with self._lock:
            self._values.pop(self._merged(tags), None)

    def _share_state(self, other: "Gauge") -> None:
        self._values = other._values
        self._lock = other._lock

    def kind(self) -> str:
        return "gauge"

    def samples(self):
        with self._lock:
            return list(self._values.items())


class _GaugeTrack:
    __slots__ = ("_gauge", "_value", "_tags")

    def __init__(self, gauge: "Gauge", value: float, tags):
        self._gauge = gauge
        self._value = value
        self._tags = tags

    def __enter__(self):
        self._gauge.inc(self._value, self._tags)
        return self

    def __exit__(self, *exc):
        self._gauge.dec(self._value, self._tags)
        return False


class Histogram(Metric):
    """Bucketed observations (ref: util/metrics.py Histogram)."""

    # Sub-millisecond floor: the default consumer is RPC/event-loop
    # latency (a loopback unary round-trips in ~50µs), where the old
    # 1ms-floor default collapsed the entire control-plane fast path
    # into one bucket.
    DEFAULT_BOUNDARIES = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                          0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5,
                          10, 60)

    def __init__(self, name, description="", boundaries: Sequence[float] = (),
                 tag_keys=()):
        if not boundaries:
            boundaries = self.DEFAULT_BOUNDARIES
        self.boundaries = tuple(sorted(boundaries))
        self._counts: Dict[_TagKey, List[int]] = {}
        self._sums: Dict[_TagKey, float] = defaultdict(float)
        self._totals: Dict[_TagKey, int] = defaultdict(int)
        super().__init__(name, description, tag_keys)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        self.observe_key(self._merged(tags), value)

    def observe_key(self, key: _TagKey, value: float) -> None:
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.boundaries) + 1)
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def time(self, tags: Optional[Dict[str, str]] = None):
        """Context manager observing the block's wall duration in
        seconds — the idiom for every RPC/handler latency site:
        `with hist.time({"method": m}): ...` can't leak an observation
        on an exception path."""
        return _HistogramTimer(self, tags)

    def _share_state(self, other: "Histogram") -> None:
        self._counts = other._counts
        self._sums = other._sums
        self._totals = other._totals
        self._lock = other._lock

    def kind(self) -> str:
        return "histogram"

    def samples(self):
        # Flattened as cumulative-bucket samples in prometheus_text().
        with self._lock:
            return [(k, float(t)) for k, t in self._totals.items()]

    def snapshot(self):
        with self._lock:
            return ({k: list(v) for k, v in self._counts.items()},
                    dict(self._sums), dict(self._totals))


class _HistogramTimer:
    __slots__ = ("_hist", "_tags", "_t0")

    def __init__(self, hist: "Histogram", tags):
        self._hist = hist
        self._tags = tags

    def __enter__(self):
        import time as _time

        self._t0 = _time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time as _time

        self._hist.observe(_time.perf_counter() - self._t0, self._tags)
        return False


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> None:
        """Register, adopting on name collision: a second instance with
        the same name/kind/tag_keys (and boundaries, for histograms)
        shares the existing instance's sample storage instead of
        silently orphaning it — in-process daemon restarts (virtual_node
        tests, InProcDaemonCluster) re-create every metric, and the old
        replace-on-register dropped all prior samples from exposition.
        A shape mismatch is a bug and raises."""
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is None or existing is metric:
                self._metrics[metric.name] = metric
                return
            if (existing.kind() != metric.kind()
                    or existing.tag_keys != metric.tag_keys
                    or getattr(existing, "boundaries", None)
                    != getattr(metric, "boundaries", None)):
                raise ValueError(
                    f"metric {metric.name!r} re-registered with a "
                    f"different shape: {existing.kind()}"
                    f"{existing.tag_keys} vs {metric.kind()}"
                    f"{metric.tag_keys}")
            metric._share_state(existing)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def snapshot_meta(self) -> List[dict]:
        """Metadata of every registered metric (name/description/kind)
        — the input the Grafana dashboard factory renders panels from."""
        with self._lock:
            metrics = list(self._metrics.values())
        return [{"name": m.name, "description": m.description,
                 "kind": m.kind()} for m in metrics]

    def prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain; version 0.0.4)."""
        out: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            desc = m.description.replace("\\", "\\\\").replace("\n", "\\n")
            out.append(f"# HELP {m.name} {desc}")
            out.append(f"# TYPE {m.name} {m.kind()}")
            if isinstance(m, Histogram):
                counts, sums, totals = m.snapshot()
                for key, buckets in counts.items():
                    base = _fmt_tags(key)
                    cum = 0
                    for b, c in zip(m.boundaries, buckets):
                        cum += c
                        out.append(
                            f"{m.name}_bucket{_fmt_tags(key, le=b)} {cum}")
                    cum += buckets[-1]
                    out.append(
                        f"{m.name}_bucket{_fmt_tags(key, le='+Inf')} {cum}")
                    out.append(f"{m.name}_sum{base} {sums[key]}")
                    out.append(f"{m.name}_count{base} {totals[key]}")
            else:
                for key, value in m.samples():
                    out.append(f"{m.name}{_fmt_tags(key)} {value}")
        return "\n".join(out) + "\n"


def _esc(value: str) -> str:
    """Escape per the Prometheus exposition format: \\, \", newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_tags(key: _TagKey, le=None) -> str:
    parts = [f'{k}="{_esc(v)}"' for k, v in key]
    if le is not None:
        parts.append(f'le="{le}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an unsorted sequence (q in [0, 100]);
    0.0 for an empty input. Used by the task-summary resource rollups —
    small windows (<=10k per job) make exact sorting fine."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = min(len(s) - 1, max(0, round(q / 100.0 * (len(s) - 1))))
    return float(s[idx])


def registry_snapshot() -> List[dict]:
    return get_registry().snapshot_meta()


# ---------------------------------------------------------------------------
# Federation: structured per-process dumps the syncer ships to the GCS,
# merged there into one cluster-wide exposition (the analogue of
# Prometheus federation's instance-labelled scrape union).
# ---------------------------------------------------------------------------

def registry_dump() -> List[dict]:
    """Serializable snapshot of every metric WITH its samples (metadata
    + values; contrast snapshot_meta, which is metadata only). The shape
    survives the pickle RPC codec: plain dicts/lists/tuples."""
    reg = get_registry()
    with reg._lock:
        metrics = list(reg._metrics.values())
    out: List[dict] = []
    for m in metrics:
        rec = {"name": m.name, "description": m.description,
               "kind": m.kind()}
        if isinstance(m, Histogram):
            counts, sums, totals = m.snapshot()
            rec["boundaries"] = list(m.boundaries)
            rec["hist"] = [
                [list(key), list(buckets), sums[key], totals[key]]
                for key, buckets in counts.items()]
        else:
            rec["samples"] = [[list(key), value]
                              for key, value in m.samples()]
        out.append(rec)
    return out


def merge_dumps(dumps: Dict[str, List[dict]]) -> str:
    """Render {origin -> registry_dump()} as ONE Prometheus exposition.
    Every sample gains a `node="<origin>"` label (federation's
    instance label), so identical tag sets from different processes —
    e.g. raytpu_rpc_handler_seconds{service=...,method=...} on every
    daemon — stay distinguishable instead of colliding."""
    meta: Dict[str, tuple] = {}          # name -> (kind, description)
    lines_by_name: Dict[str, List[str]] = {}
    for origin, dump in sorted(dumps.items()):
        for rec in dump:
            name = rec["name"]
            meta.setdefault(name, (rec["kind"], rec["description"]))
            out = lines_by_name.setdefault(name, [])
            if rec["kind"] == "histogram":
                bounds = rec.get("boundaries", [])
                for key, buckets, hsum, total in rec.get("hist", []):
                    key = _with_node(key, origin)
                    base = _fmt_tags(key)
                    cum = 0
                    for b, c in zip(bounds, buckets):
                        cum += c
                        out.append(
                            f"{name}_bucket{_fmt_tags(key, le=b)} {cum}")
                    if buckets:
                        cum += buckets[-1]
                    out.append(
                        f"{name}_bucket{_fmt_tags(key, le='+Inf')} {cum}")
                    out.append(f"{name}_sum{base} {hsum}")
                    out.append(f"{name}_count{base} {total}")
            else:
                for key, value in rec.get("samples", []):
                    out.append(
                        f"{name}{_fmt_tags(_with_node(key, origin))} "
                        f"{value}")
    text: List[str] = []
    for name in sorted(meta):
        kind, desc = meta[name]
        desc = desc.replace("\\", "\\\\").replace("\n", "\\n")
        text.append(f"# HELP {name} {desc}")
        text.append(f"# TYPE {name} {kind}")
        text.extend(lines_by_name[name])
    return "\n".join(text) + "\n"


def _with_node(key, origin: str) -> _TagKey:
    items = [(str(k), str(v)) for k, v in key if k != "node"]
    items.append(("node", origin))
    return tuple(sorted(items))


def process_sample() -> Dict[str, float]:
    """Best-effort self-metrics for the calling process: RSS bytes,
    cumulative CPU seconds, open fds, live threads.  Linux /proc is the
    primary source; getrusage is the portable fallback (its ru_maxrss
    is a high-water mark, not current RSS — still the right order of
    magnitude for a leak alarm).  Used by the GCS audit loop so the
    control plane's own footprint shows up node-labelled in the
    federated exposition alongside every daemon it monitors."""
    import os
    import resource

    out: Dict[str, float] = {}
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out["cpu_seconds"] = ru.ru_utime + ru.ru_stime
    out["rss_bytes"] = float(ru.ru_maxrss) * 1024.0
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        out["rss_bytes"] = float(rss_pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        pass
    try:
        out["open_fds"] = float(len(os.listdir("/proc/self/fd")))
    except OSError:
        pass
    out["threads"] = float(threading.active_count())
    return out


_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricsRegistry()
        return _registry


def merge_dump_lists(dumps: Sequence[List[dict]]) -> List[dict]:
    """Merge several registry_dump() lists into ONE dump (the node
    daemon folds worker-pushed dumps — serve replicas, the HTTP proxy —
    into its own federation payload, so one node still ships one dump).
    Counters and histograms with identical (name, labelset) SUM (two
    replicas of one app on a node yield one per-app series); gauges are
    last-write-wins (distinguish them with labels — replica serve
    gauges carry app/replica tags).  Shape mismatches keep the first
    record seen."""
    merged: Dict[str, dict] = {}
    for dump in dumps:
        for rec in dump:
            name = rec.get("name")
            cur = merged.get(name)
            if cur is None:
                cur = {"name": name,
                       "description": rec.get("description", ""),
                       "kind": rec.get("kind")}
                if rec.get("kind") == "histogram":
                    cur["boundaries"] = list(rec.get("boundaries", []))
                    cur["hist"] = []
                else:
                    cur["samples"] = []
                merged[name] = cur
            if cur["kind"] != rec.get("kind"):
                continue
            if cur["kind"] == "histogram":
                if cur["boundaries"] != list(rec.get("boundaries", [])):
                    continue
                by_key = {tuple(map(tuple, h[0])): h for h in cur["hist"]}
                for key, buckets, hsum, total in rec.get("hist", []):
                    k = tuple(map(tuple, key))
                    have = by_key.get(k)
                    if have is None:
                        row = [list(key), list(buckets), hsum, total]
                        cur["hist"].append(row)
                        by_key[k] = row
                    else:
                        have[1] = [a + b for a, b in zip(have[1], buckets)]
                        have[2] += hsum
                        have[3] += total
            else:
                summing = cur["kind"] == "counter"
                by_key = {tuple(map(tuple, s[0])): s
                          for s in cur["samples"]}
                for key, value in rec.get("samples", []):
                    k = tuple(map(tuple, key))
                    have = by_key.get(k)
                    if have is None:
                        row = [list(key), value]
                        cur["samples"].append(row)
                        by_key[k] = row
                    elif summing:
                        have[1] += value
                    else:
                        have[1] = value
    return list(merged.values())
