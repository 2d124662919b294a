"""Per-node log monitor: tail worker log files, ship lines to the GCS.

The port's copy of `ray_tpu/core/distributed/log_monitor.py`,
importing `ray_tpu_torch` only.

Analogue of the reference's log monitor process
(ref: python/ray/_private/log_monitor.py:1 LogMonitor, spawned per node
at node.py:1042): worker stdout/stderr land in per-worker files under
the node's log dir; the monitor tails every file, batches new lines,
and ships them to the GCS LogManager, which fans them out over pubsub
to subscribed drivers (prefixed driver-side printing, like the
reference's ``log_to_driver``) and keeps a per-worker ring buffer so a
DEAD worker's last lines remain inspectable from the dashboard/CLI.

Runs inside the node daemon's event loop rather than as a separate
process: the tail sweep is a few stat/read syscalls per worker — not
worth a process boundary here.
"""
from __future__ import annotations

import asyncio
import logging
import os
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

MAX_LINE_BYTES = 16 * 1024          # longer lines are truncated
MAX_SWEEP_BYTES = 512 * 1024        # per sweep, per file (burst guard)
MAX_FILE_BYTES = 64 * 1024 * 1024   # live-file rotation threshold


class _Tail:
    """Incremental reader of one append-only log file."""

    def __init__(self, path: str):
        self.path = path
        self.pos = 0
        self.last_seen_size = -1
        self._partial = b""

    def read_new_lines(self) -> List[str]:
        """New complete lines since the last call. A burst larger than
        MAX_SWEEP_BYTES is read across SUCCESSIVE sweeps (pos only
        advances over bytes actually consumed) — never dropped."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size <= self.pos:
            return []
        try:
            with open(self.path, "rb") as f:
                f.seek(self.pos)
                data = f.read(min(size - self.pos, MAX_SWEEP_BYTES))
        except OSError:
            return []
        self.pos += len(data)
        data = self._partial + data
        *lines, self._partial = data.split(b"\n")
        if len(self._partial) > MAX_LINE_BYTES:  # runaway unterminated line
            lines.append(self._partial)
            self._partial = b""
        return [ln[:MAX_LINE_BYTES].decode("utf-8", "replace")
                for ln in lines]


class LogMonitor:
    """Tails ``worker-<id>.out|.err`` files in `log_dir` and ships new
    lines to the GCS LogManager in one RPC per sweep."""

    RETIRE_GRACE_S = 2.0

    def __init__(self, log_dir: str, node_id: str,
                 worker_info: Callable[[str], Dict[str, Any]],
                 period_s: float = 0.25):
        self.log_dir = log_dir
        self.node_id = node_id
        self.worker_info = worker_info  # worker_id -> {actor_id, job_id, pid}
        self.period_s = period_s
        self._tails: Dict[str, _Tail] = {}
        # worker_id -> retire deadline; without eviction a churny daemon
        # stats every log file ever created on each sweep and the log dir
        # grows without bound.
        self._retired: Dict[str, float] = {}

    def retire(self, worker_id: str) -> None:
        """Worker exited: after a grace period for trailing writes, its
        files are tailed one last time, unlinked, and forgotten (the GCS
        ring buffer keeps the last lines)."""
        import time

        self._retired.setdefault(worker_id,
                                 time.monotonic() + self.RETIRE_GRACE_S)

    def _maybe_rotate(self, tail: _Tail) -> None:
        """Copytruncate-style rotation for LIVE workers: once the tailer
        has shipped everything and the file is huge, truncate it to zero
        (the worker's fd is O_APPEND, so its next write lands at the new
        EOF) — a steadily-printing long-lived actor must not fill the
        node's disk (ref: the reference's rotated session log files).

        Rotation only fires when the file was QUIET for a whole sweep
        (size unchanged since last look AND fully shipped): the writer
        holds no lock we can take, so truncating a file that is being
        appended to mid-check would silently drop the racing lines —
        waiting for an idle sweep shrinks that window to the instant
        between the final getsize and the truncate."""
        try:
            size = os.path.getsize(tail.path)
        except OSError:
            return
        quiet = size == tail.last_seen_size
        tail.last_seen_size = size
        # A steady printer is never quiet, so past DOUBLE the threshold
        # rotation is forced anyway — losing the handful of racing lines
        # beats filling the node's disk. (A writer outpacing the tailer's
        # 512KB/sweep read rate would fill the disk regardless.)
        if tail.pos >= size and (
                (size > MAX_FILE_BYTES and quiet)
                or size > 2 * MAX_FILE_BYTES):
            try:
                os.truncate(tail.path, 0)
                tail.pos = 0
                tail.last_seen_size = 0
            except OSError:
                pass

    def _reap_retired(self) -> None:
        """Runs AFTER the sweep shipped any remaining lines: unlink only
        files the tail has fully caught up with (lines are never lost —
        a still-draining burst postpones the reap to the next sweep)."""
        import time

        now = time.monotonic()
        for worker_id, deadline in list(self._retired.items()):
            if now < deadline:
                continue
            done = True
            for suffix in (".out", ".err"):
                name = f"worker-{worker_id}{suffix}"
                path = os.path.join(self.log_dir, name)
                tail = self._tails.get(name)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    self._tails.pop(name, None)
                    continue
                if tail is not None and tail.pos < size:
                    done = False  # sweep hasn't shipped everything yet
                    continue
                self._tails.pop(name, None)
                try:
                    os.unlink(path)
                except OSError:
                    pass
            if done:
                self._retired.pop(worker_id, None)

    def sweep(self) -> List[dict]:
        """One pass over the log dir; returns the records to publish."""
        try:
            names = os.listdir(self.log_dir)
        except OSError:
            return []
        records: List[dict] = []
        for name in names:
            if not (name.startswith("worker-")
                    and (name.endswith(".out") or name.endswith(".err"))):
                continue
            tail = self._tails.get(name)
            if tail is None:
                tail = self._tails[name] = _Tail(
                    os.path.join(self.log_dir, name))
            lines = tail.read_new_lines()
            self._maybe_rotate(tail)
            if not lines:
                continue
            worker_id = name[len("worker-"):-4]
            info = self.worker_info(worker_id) or {}
            records.append({
                "node_id": self.node_id,
                "worker_id": worker_id,
                "stream": "stderr" if name.endswith(".err") else "stdout",
                "actor_id": info.get("actor_id"),
                "job_id": info.get("job_id"),
                "pid": info.get("pid"),
                "lines": lines,
            })
        self._reap_retired()
        return records

    async def run(self, gcs_client) -> None:
        """Sweep-and-ship loop; `gcs_client` is an AsyncRpcClient to the
        GCS. Errors are absorbed (a GCS blip must not kill the tailer —
        positions advance only on successful file reads, and unshipped
        records are retried next sweep by NOT advancing... they are
        already read, so on failure they are re-queued locally)."""
        pending: List[dict] = []
        while True:
            # Adaptive cadence: a sweep stats every tailed file, so with
            # a 1k-worker warm pool (2k files) the base 0.25 s period
            # alone costs ~8k syscalls/s of the daemon's loop. Scale the
            # period with the tail count (0.25 s small, up to 2 s at 2k+
            # files) — log latency trades against control-plane CPU.
            period = min(2.0, max(self.period_s,
                                  len(self._tails) / 1000.0))
            await asyncio.sleep(period)
            try:
                pending.extend(self.sweep())
                if not pending:
                    continue
                if len(pending) > 500:  # GCS outage backstop
                    del pending[:250]
                batch, pending = pending, []
                try:
                    await gcs_client.call("LogManager", "add_logs",
                                          records=batch, timeout=10)
                except Exception:  # noqa: BLE001 — retry next sweep
                    pending = batch + pending
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                logger.debug("log monitor sweep failed: %s", e)


def format_log_prefix(rec: dict) -> str:
    """Driver-side prefix, reference-style ``(pid=…, ip=…)`` adapted to
    ids: ``(worker=ab12cd34, node=ef56)`` or the actor id when known."""
    who = (f"actor={rec['actor_id'][:8]}" if rec.get("actor_id")
           else f"worker={rec['worker_id'][:8]}")
    pid = f" pid={rec['pid']}" if rec.get("pid") else ""
    return f"({who}{pid}, node={rec['node_id'][:8]})"
