"""On-demand CPU profiling + signal-safe diagnosis of live workers.

The port's copy of `ray_tpu/util/profiling.py`,
importing `ray_tpu_torch` only.

Two complementary capture paths, mirroring the reference dashboard's
profiling stack (ref: dashboard/modules/reporter/profile_manager.py:75
CpuProfilingManager — attaches py-spy to a worker PID on demand):

  * Sampling (`sample_stacks`/`profile_here`, the `profile` worker RPC):
    a sampler thread inside the worker walks sys._current_frames() —
    cheap, produces collapsed flamegraph lines, but needs the GIL, so a
    thread stuck in native code holding the GIL is invisible to it.
  * Signal-safe dumps (`register_stack_dump_handler` + SIGUSR1, the
    `ray-tpu stack` path): faulthandler's C-level handler writes every
    thread's traceback WITHOUT taking the GIL — the `ray stack`
    equivalent that still works when the process is wedged in a
    GIL-holding native call. The daemon signals, tails the per-pid dump
    file, and `parse_faulthandler_dump`/`summarize_stacks` turn the text
    into grouped cluster-wide answers ("412/512 workers blocked in
    all_reduce at collective.py:...").

Per-task resource attribution (`TaskUsageProbe`) lives here too: thread
CPU-time, RSS delta + peak, and opt-in CUDA device-memory stats wrapped
around each task attempt by the executor.
"""
from __future__ import annotations

import os
import re
import threading
import time
from collections import Counter
from typing import Dict, List, Optional

# Serializes tracemalloc windows: tracing state is process-global, so
# overlapping heap-profile requests must queue, not stop each other.
HEAP_TRACE_LOCK = threading.Lock()

# Threads currently sampling (module-global, GIL-guarded): a sampler
# must never appear in ANOTHER concurrent sampler's output — its busy
# loop would masquerade as application load.
_SAMPLER_TIDS: set = set()


def sample_stacks(duration_s: float = 2.0, interval_s: float = 0.01,
                  exclude_thread: Optional[int] = None) -> Dict[str, int]:
    """Sample all threads' stacks for `duration_s`; returns collapsed
    stack -> count (root;...;leaf, frames as module:function:line)."""
    counts: Counter = Counter()
    deadline = time.monotonic() + duration_s
    me = threading.get_ident()
    _SAMPLER_TIDS.add(me)
    try:
        import sys

        while time.monotonic() < deadline:
            for tid, frame in sys._current_frames().items():
                if (tid == me or tid == exclude_thread
                        or tid in _SAMPLER_TIDS):
                    continue
                parts: List[str] = []
                f = frame
                while f is not None:
                    code = f.f_code
                    parts.append(f"{code.co_filename.rsplit('/', 1)[-1]}:"
                                 f"{code.co_name}:{f.f_lineno}")
                    f = f.f_back
                counts[";".join(reversed(parts))] += 1
            time.sleep(interval_s)
    finally:
        _SAMPLER_TIDS.discard(me)
    return dict(counts)


def profile_here(duration_s: float = 2.0,
                 interval_s: float = 0.01) -> dict:
    """Sample from the CALLING thread (which excludes itself): no helper
    thread, or its join() would show up at ~100% of samples. A capture
    too short to take any sample (duration < interval on a loaded box)
    returns an honest empty report — samples=0, not a fabricated 1."""
    stacks = sample_stacks(duration_s, interval_s)
    total = sum(stacks.values())
    leaves: Counter = Counter()
    for stack, n in stacks.items():
        leaves[stack.rsplit(";", 1)[-1]] += n
    return {
        "samples": total,
        "stacks": stacks,                       # collapsed flamegraph
        "top": leaves.most_common(20),
        "duration_s": duration_s,
    }


def merge_reports(reports: List[dict]) -> dict:
    """Merge several `profile_here` reports (one per worker) into one
    cluster-wide report: identical code paths aggregate, so a hot frame
    on 50 workers shows up once at 50x weight."""
    stacks: Counter = Counter()
    total = 0
    dur = 0.0
    for r in reports:
        for s, n in (r.get("stacks") or {}).items():
            stacks[s] += n
        total += int(r.get("samples", 0))
        dur = max(dur, float(r.get("duration_s", 0.0)))
    leaves: Counter = Counter()
    for s, n in stacks.items():
        leaves[s.rsplit(";", 1)[-1]] += n
    return {"samples": total, "stacks": dict(stacks),
            "top": leaves.most_common(20), "duration_s": dur,
            "workers": len(reports)}


def render_report(report: dict) -> str:
    samples = int(report.get("samples", 0))
    header = f"{samples} samples over {report['duration_s']:.1f}s"
    if "workers" in report:
        header += f" across {report['workers']} workers"
    if not samples:
        return header + " (capture shorter than the sampling interval?)"
    lines = [header, "top frames (leaf, % of samples):"]
    for frame, n in report["top"]:
        lines.append(f"  {100.0 * n / samples:5.1f}%  {frame}")
    return "\n".join(lines)


def write_flamegraph_collapsed(report: dict, path: str) -> str:
    """Collapsed-stack file for flamegraph.pl / speedscope import."""
    with open(path, "w") as f:
        for stack, n in sorted(report["stacks"].items()):
            f.write(f"{stack} {n}\n")
    return path


# ---------------------------------------------------------------------------
# Signal-safe stack dumps (ref: `ray stack` / faulthandler). The worker
# registers at boot; the daemon owns signal + tail + parse.
# ---------------------------------------------------------------------------

# Files handed to faulthandler.register must stay open for the process's
# lifetime; rooted here so GC can never close them under the C handler.
_DUMP_FILES: List = []


def node_log_dir(node_id: str) -> str:
    """The node's log dir, computed identically by the daemon and its
    workers (env override or a node-id-derived default), so the dump
    file rendezvous needs no extra plumbing through the spawn paths."""
    import tempfile

    from ray_tpu_torch.core.config import get_config

    return get_config().log_dir or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch_logs", node_id[:12])


def stack_dump_path(log_dir: str, pid: int) -> str:
    return os.path.join(log_dir, f"stack-{pid}.dump")


def register_stack_dump_handler(dump_path: str) -> bool:
    """Register faulthandler on SIGUSR1 writing all-thread tracebacks to
    `dump_path` (append mode — O_APPEND keeps concurrent truncate-based
    rotation safe). faulthandler's handler runs at the C level and walks
    thread states WITHOUT the GIL, so this works even when a thread is
    wedged in GIL-holding native code — the exact case the in-process
    sampling RPC can never see."""
    import faulthandler
    import signal

    if not hasattr(faulthandler, "register"):  # Windows
        return False
    os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
    f = open(dump_path, "a")
    faulthandler.register(signal.SIGUSR1, file=f, all_threads=True,
                          chain=False)
    _DUMP_FILES.append(f)
    return True


_THREAD_RE = re.compile(r"^(Current thread|Thread) (0x[0-9a-fA-F]+)")
_FRAME_RE = re.compile(r'^  File "([^"]+)", line (\d+) in (.*)$')


def parse_faulthandler_dump(text: str) -> List[dict]:
    """Parse one faulthandler dump into per-thread frame lists (frames
    most-recent-first, as printed): [{"thread", "current", "frames":
    ["file.py:func:line", ...]}, ...]."""
    threads: List[dict] = []
    cur: Optional[dict] = None
    for line in text.splitlines():
        m = _THREAD_RE.match(line)
        if m:
            cur = {"thread": m.group(2),
                   "current": m.group(1).startswith("Current"),
                   "frames": []}
            threads.append(cur)
            continue
        m = _FRAME_RE.match(line)
        if m and cur is not None:
            path, lineno, func = m.groups()
            cur["frames"].append(
                f"{path.rsplit('/', 1)[-1]}:{func}:{lineno}")
    return threads


def summarize_stacks(node_results: List[dict]) -> List[dict]:
    """Group identical thread stacks across every worker of a cluster
    dump (`Diagnosis.dump_stacks` output): the one-line answer to "where
    is everyone?" — e.g. 412/512 workers sharing the exact all_reduce
    frame. Sorted most-common first."""
    groups: Dict[tuple, set] = {}
    total: set = set()
    for nres in node_results or ():
        for w in nres.get("workers", ()):
            wid = (nres.get("node_id"), w.get("pid"))
            if w.get("ok"):
                total.add(wid)
            for t in w.get("threads", ()):
                frames = tuple(t.get("frames") or ())
                if not frames:
                    continue
                groups.setdefault(frames, set()).add(wid)
    out = [{"workers": len(v), "total": len(total),
            "leaf": k[0], "frames": list(k)}
           for k, v in groups.items()]
    out.sort(key=lambda g: (-g["workers"], g["leaf"]))
    return out


# ---------------------------------------------------------------------------
# Per-task resource attribution (executor-side; rides the task-event
# record of each attempt).
# ---------------------------------------------------------------------------

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096
_tls = threading.local()


def _rss_bytes() -> Optional[int]:
    """Current process RSS via a per-thread cached /proc/self/statm fd
    (seek+read, no open per task — the probe runs on every attempt and
    must stay in the single-digit-microsecond range)."""
    f = getattr(_tls, "statm", None)
    if f is None:
        try:
            f = _tls.statm = open("/proc/self/statm", "rb", buffering=0)
        except OSError:
            _tls.statm = False
            return None
    if f is False:
        return None
    try:
        f.seek(0)
        return int(f.read(80).split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return None


def _peak_rss_bytes() -> Optional[int]:
    """Process high-water RSS (ru_maxrss — one cheap syscall; Linux
    reports KiB)."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # noqa: BLE001
        return None


_DEVICE_MEM_ENABLED: Optional[bool] = None


def _device_bytes() -> Optional[int]:
    """Summed allocated bytes across this process's CUDA devices — opt-in
    (RAY_TPU_TASK_EVENTS_DEVICE_MEM): memory_stats() is a device
    runtime call, not something to pay per noop task. The flag is
    resolved once per process (workers get it through their spawn
    env), keeping the disabled path to one global read per probe.

    Reads only a process that has already initialised CUDA: a probe must
    never be the call that initialises it (a zygote that did could not
    give CUDA to the workers it forks), so before that it reports None."""
    global _DEVICE_MEM_ENABLED
    if _DEVICE_MEM_ENABLED is None:
        from ray_tpu_torch.core.config import get_config

        _DEVICE_MEM_ENABLED = bool(get_config().task_events_device_mem)
    if not _DEVICE_MEM_ENABLED:
        return None
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    total = 0
    seen = False
    for i in range(torch.cuda.device_count()):
        try:
            st = torch.cuda.memory_stats(i)
        except Exception:  # noqa: BLE001 device without stats
            continue
        if st:
            total += int(st.get("allocated_bytes.all.current", 0))
            seen = True
    return total if seen else None


# Process-wide RSS snapshot refreshed at most every TTL: probe starts
# read the CACHED value (a dict lookup, no syscall) — the statm read
# happens once per TTL window across all executor threads.
_RSS_CACHE_TTL_S = 0.1
_RSS_CACHE = [0.0, None]  # [monotonic ts, rss bytes]


def _cached_rss() -> Optional[int]:
    now = time.monotonic()
    if _RSS_CACHE[1] is None or now - _RSS_CACHE[0] > _RSS_CACHE_TTL_S:
        _RSS_CACHE[1] = _rss_bytes()
        _RSS_CACHE[0] = now
    return _RSS_CACHE[1]


class TaskUsageProbe:
    """Start/finish pair wrapped around one task attempt by the
    executor: thread CPU-time (time.thread_time — this thread only, so
    concurrent attempts don't bleed into each other), RSS delta + peak,
    and opt-in device memory. finish() returns the fields that ride the
    attempt's task-event record.

    Cost discipline: micro tasks get CPU-time only — thread_time is a
    GIL-holding vdso-cheap read, while the statm/getrusage reads each
    release the GIL around a syscall, and on a contended host those
    releases amplify into thread switches (measured: ~25% of many_tasks
    noop throughput when probed per attempt). Memory detail is taken
    only for attempts that ran >= MIN_DETAIL_WALL_S, where it is both
    amortized and actually meaningful (a noop's RSS delta is allocator
    noise); the start baseline comes from a 100ms-TTL cached process
    RSS, accurate at the MB scales attribution answers for."""

    MIN_DETAIL_WALL_S = 0.01

    __slots__ = ("t0", "cpu0", "rss0", "dev0")

    def __init__(self):
        self.t0 = time.monotonic()
        self.cpu0 = time.thread_time()
        self.rss0 = _cached_rss()
        self.dev0 = _device_bytes()

    def finish(self) -> dict:
        out = {"cpu_time_s": round(time.thread_time() - self.cpu0, 6)}
        if time.monotonic() - self.t0 >= self.MIN_DETAIL_WALL_S:
            rss = _rss_bytes()
            if rss is not None:
                _RSS_CACHE[1] = rss
                _RSS_CACHE[0] = time.monotonic()
                if self.rss0 is not None:
                    out["rss_delta_bytes"] = rss - self.rss0
            peak = _peak_rss_bytes()
            if peak is not None:
                out["rss_peak_bytes"] = peak
        dev = _device_bytes()
        if dev is not None:
            out["device_mem_bytes"] = dev
            if self.dev0 is not None:
                out["device_mem_delta_bytes"] = dev - self.dev0
        return out
