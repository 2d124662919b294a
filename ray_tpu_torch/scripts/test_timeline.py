"""Where the test suite's wall clock goes, worker by worker.

    TEST_TIMELINE_DIR=out python -m pytest tests/ -n 6 --dist loadfile \
        -p ray_tpu_torch.scripts.test_timeline
    python3 -m ray_tpu_torch.scripts.test_timeline out

As a pytest plugin it appends, for each pytest-xdist worker (or the main
process), the wall time at which each test starts and ends and at which
the session finishes, to `$TEST_TIMELINE_DIR/<worker>.log`. Run as a
script it reads those logs and prints, per worker, when its last test
ended and its files in the order they ran (start and seconds, from the
first test of the run): the files that still run when the others have
finished hold the clock, and a worker whose last test started and never
ended is where a run that was cut waited.
"""
from __future__ import annotations

import os
import sys
import time

_log = None


def _write(event: str) -> None:
    global _log
    out = os.environ.get("TEST_TIMELINE_DIR")
    if not out:
        return
    if _log is None:
        os.makedirs(out, exist_ok=True)
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        _log = open(os.path.join(out, f"{worker}.log"), "a", buffering=1)
    _log.write(f"{time.time():.2f} {event}\n")


def pytest_runtest_logstart(nodeid, location):
    _write(f"START {nodeid}")


def pytest_runtest_logfinish(nodeid, location):
    _write(f"END {nodeid}")


def pytest_sessionfinish(session, exitstatus):
    _write("SESSIONFINISH")


def main(out: str) -> int:
    logs = {}
    for name in sorted(os.listdir(out)):
        if name.endswith(".log") and name != "main.log":
            with open(os.path.join(out, name)) as f:
                logs[name[:-4]] = [line.split(" ", 2) for line in f if line.strip()]
    t0 = min(float(rows[0][0]) for rows in logs.values() if rows)
    for worker, rows in logs.items():
        files: dict = {}
        for stamp, kind, *rest in rows:
            if kind in ("START", "END"):
                span = files.setdefault(rest[0].split("::")[0].strip(), [float(stamp)] * 2)
                span[1] = float(stamp)
        ends = [s for s, kind, *_ in rows if kind == "END"]
        last = max((float(s) for s in ends), default=t0) - t0
        open_test = rows[-1][2].strip() if rows[-1][1] == "START" else None
        print(f"{worker}: last test ended at {last:.1f} s"
              + (f"; still running: {open_test}" if open_test else ""))
        for name, (a, b) in files.items():
            print(f"    {a - t0:8.1f} s  {b - a:7.1f} s  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
