"""The operator CLI of ray_tpu_torch (`python -m ray_tpu_torch.scripts.cli`)
against ray_tpu's, through each package's `scripts.cli.main`, on the CPU.

One `cluster_utils.Cluster` per runtime for this file, never both at once
(a module fixture over the two runtimes, each started after both runtimes
are shut down): JAX's run records what it got, the port's run is held to
the record. The CLI's output carries ids, addresses, pids, clock times and
counts that differ from run to run, so the record holds it masked: an
address becomes `<addr>`, a hex id `<id>`, a clock time `<time>`, every
other number `#`, runs of spaces one space and a table's rule `---`. The
masked text must be equal; there is no numeric tolerance. Where the output
depends on timing (which GCS components took the most handler time, how
many task events have flushed), the record keeps the claim the JAX test
makes of it instead.

The cases are the CLI cases of JAX's suite: `status` and `stack`
(tests/test_diagnosis.py's `_run_cli`), `logs` and `logs --dead`
(tests/test_log_monitor.py),
`profile` (tests/test_profiling_hf.py), `list`, `events`, `doctor`,
`timeline`, `metrics --grafana-out`, and `job submit/status/logs/stop/list`.
Then two of the port's own: its driver's breadcrumb, which `status` reads
when given no address (the port's file, never JAX's), and `lint`, which
refuses and names the roadmap item that brings it.
"""
import importlib
import io
import json
import os
import re
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest

import ray_tpu
import ray_tpu_torch

RUNTIMES = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]
RECORD = {}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _agree(name, rt, got):
    """Record JAX's result; hold the port's to it."""
    if rt is ray_tpu:
        RECORD[name] = got
    elif name in RECORD:
        assert got == RECORD[name], (name, got, RECORD[name])
    return got


def _mask(text):
    text = re.sub(r"\d+\.\d+\.\d+\.\d+:\d+", "<addr>", text)
    text = re.sub(r"\b[0-9a-f]{8,}\b", "<id>", text)
    text = re.sub(r"\d\d:\d\d:\d\d", "<time>", text)
    text = re.sub(r"\d+(\.\d+)?", "#", text)
    text = re.sub(r"-{3,}", "---", text)
    return "\n".join(re.sub(r" {2,}", " ", ln).rstrip() for ln in text.splitlines())


@pytest.fixture(scope="module", params=RUNTIMES, ids=IDS)
def cli_cluster(request):
    rt = request.param
    for other in RUNTIMES:
        if other.is_initialized():
            other.shutdown()
    cluster = _mod(rt, "cluster_utils").Cluster(head_node_args={"num_cpus": 4})
    cluster.connect()
    cli = _mod(rt, "scripts.cli")

    def run(*argv, address=True):
        buf = io.StringIO()
        with redirect_stdout(buf):
            cli.main((["--address", cluster.address] if address else []) + list(argv))
        return buf.getvalue()

    try:
        yield rt, cluster, run
    finally:
        cluster.shutdown()


def test_cli_status_list_events_doctor(cli_cluster):
    rt, _, run = cli_cluster

    @rt.remote
    def f():
        return 1

    assert rt.get(f.remote(), timeout=60) == 1
    status = _mask(run("status")).splitlines()
    # Which components took the most GCS handler time, and how many task
    # events have flushed, depend on timing: keep those lines' heads.
    status = [ln.split(":")[0] if ln.startswith((" gcs load", " task events"))
              else ln for ln in status]
    got = {"status": status, "doctor": _mask(run("doctor")),
           "gcs top": _mask(run("gcs", "top")).splitlines()[:4],
           "serve": run("serve", "status"), "train": run("train", "status")}
    for kind in ("nodes", "workers", "jobs", "actors", "pgs"):
        got[kind] = _mask(run("list", kind))
    got["events"] = _mask(run("events", "--kind", "node"))
    rec = _agree("status", rt, got)
    assert rec["status"][:2] == ["cluster @ <addr>", " nodes: # alive / # total"]
    assert "healthy" in rec["doctor"]


def test_cli_stack_and_profile(cli_cluster, tmp_path):
    rt, _, run = cli_cluster

    @rt.remote
    def busy():
        import time

        t = time.time()
        while time.time() - t < 4:
            pass
        return 1

    ref = busy.remote()
    time.sleep(0.5)
    stack = run("stack")
    out = str(tmp_path / f"{rt.__name__}.collapsed")
    prof = run("profile", "-d", "1", "--out", out)
    with open(out) as f:
        flame = f.read()
    assert rt.get(ref, timeout=60) == 1
    got = ("== worker" in stack, ":busy:" in stack,
           _mask(prof).splitlines()[0], prof.rstrip().endswith(out),
           ";" in flame)
    assert _agree("stack", rt, got) == (
        True, True, "sampling # workers for #s...", True, True)


def _ring_lines(out):
    """The CLI's own dump (headers and indented ring lines), not the
    driver's live log stream, which prints to stdout too."""
    return [ln for ln in out.splitlines() if ln.startswith(("== ", "  "))]


def test_cli_logs(cli_cluster):
    """`logs` dumps the GCS ring buffers; `logs --dead` only those of
    workers no longer alive (tests/test_log_monitor.py's two cases)."""
    rt, _, run = cli_cluster

    @rt.remote
    def noisy():
        print("CLI_VISIBLE_LINE")
        return 0

    @rt.remote
    class Doomed:
        def last_words(self):
            print("POST_MORTEM_LINE", flush=True)
            return "ok"

        def die(self):
            import os

            os._exit(1)

    @rt.remote
    class Chatty:
        def say(self):
            print("STILL_ALIVE_LINE", flush=True)
            return 1

    rt.get(noisy.remote(), timeout=60)
    doomed, chatty = Doomed.remote(), Chatty.remote()
    assert rt.get(doomed.last_words.remote(), timeout=60) == "ok"
    assert rt.get(chatty.say.remote(), timeout=60) == 1
    time.sleep(1.0)  # the tailer ships the lines before the kill
    try:
        rt.get(doomed.die.remote(), timeout=30)
    except Exception:  # noqa: BLE001 the death surfaces as an error
        pass

    def poll(argv, want):
        deadline = time.monotonic() + 30
        while True:
            lines = _ring_lines(run(*argv))
            if any(want in ln for ln in lines) or time.monotonic() > deadline:
                return lines
            time.sleep(0.5)

    full = poll(["logs"], "POST_MORTEM_LINE")
    dead = poll(["logs", "--dead"], "POST_MORTEM_LINE")
    rt.kill(chatty)
    got = ([_mask(ln) for ln in full if "CLI_VISIBLE_LINE" in ln],
           any("worker=" in ln or "actor=" in ln for ln in full),
           [any(w in ln for ln in full) for w in ("STILL_ALIVE_LINE", "POST_MORTEM_LINE")],
           [any(w in ln for ln in dead) for w in ("STILL_ALIVE_LINE", "POST_MORTEM_LINE")])
    assert _agree("logs", rt, got)[1:] == (True, [True, True], [False, True])


def test_cli_timeline_and_grafana(cli_cluster, tmp_path):
    rt, _, run = cli_cluster
    path = str(tmp_path / "trace.json")
    timeline = _mask(run("timeline", "--out", path)).replace(_mask(path), "<out>")
    with open(path) as f:
        trace = json.load(f)
    out_dir = str(tmp_path / "grafana")
    files = sorted(os.path.basename(p) for p in run(
        "metrics", "--grafana-out", out_dir).split())
    metrics = run("metrics")
    got = (timeline, type(trace).__name__, files, metrics.startswith("# node "),
           "raytpu_workers" in metrics)
    assert "provisioning.yaml" in _agree("timeline_grafana", rt, got)[2]


def test_cli_jobs(cli_cluster):
    rt, _, run = cli_cluster
    code = "print(\"from a cli job\")"
    submitted = run("job", "submit", "--submission-id", "cli_job_one", "--wait",
                    "--", sys.executable, "-c", code)
    status = run("job", "status", "cli_job_one")
    logs = run("job", "logs", "cli_job_one")
    run("job", "submit", "--submission-id", "cli_job_two", "--",
        sys.executable, "-c", "import time; time.sleep(600)")
    js = _mod(rt, "job_submission").JobSubmissionClient()
    deadline = time.monotonic() + 60
    while js.get_job_status("cli_job_two") != "RUNNING":
        assert time.monotonic() < deadline
        time.sleep(0.2)
    stop = run("job", "stop", "cli_job_two")
    js.wait_until_finished("cli_job_two", timeout=60)
    listing = _mask(run("job", "list"))
    got = (submitted, status, logs, stop, listing, _mask(run("list", "jobs")))
    rec = _agree("jobs", rt, got)
    assert rec[0].endswith("job cli_job_one: SUCCEEDED \n") and rec[2] == "from a cli job\n"
    assert rec[3] == "stopped\n" and "cli_job_two STOPPED" in rec[4]


_BREADCRUMB = r"""
import io, json, os, sys
from contextlib import redirect_stdout
import ray_tpu_torch
from ray_tpu_torch.api import _global_worker
from ray_tpu_torch.core.distributed.driver import breadcrumb_path
from ray_tpu_torch.scripts import cli
ray_tpu_torch.init(num_cpus=1)
address = _global_worker().gcs_address
buf = io.StringIO()
with redirect_stdout(buf):
    cli.main(["status"])
first = buf.getvalue().splitlines()[0]
with open(breadcrumb_path()) as f:
    crumb = json.load(f)["gcs_address"]
ray_tpu_torch.shutdown()
print(json.dumps({"address": address, "status": first, "crumb": crumb,
                  "path": breadcrumb_path(),
                  "mode": oct(os.stat(os.path.dirname(breadcrumb_path())).st_mode & 0o777)}))
"""


def test_cli_status_reads_the_ports_breadcrumb(cli_cluster, tmp_path):
    """A port driver's init() writes the port's breadcrumb, under the
    temporary directory, and the CLI given no address reads it: the port's
    head, never the address JAX's drivers leave in /tmp/ray_tpu_<uid>/."""
    rt, _, _ = cli_cluster
    if rt is ray_tpu:
        return   # the claim is the port's
    env = {k: v for k, v in os.environ.items() if k != "RAY_TPU_ADDRESS"}
    env["TMPDIR"] = str(tmp_path)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _BREADCRUMB], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["status"] == f"cluster @ {out['address']}" and out["crumb"] == out["address"]
    assert out["path"] == str(tmp_path / f"ray_tpu_torch_{os.getuid()}" / "last_cluster.json")
    assert out["mode"] == "0o700"


def test_cli_lint_refuses(cli_cluster):
    rt, _, run = cli_cluster
    if rt is ray_tpu:
        return   # JAX's lint runs in tests/test_lint.py
    with pytest.raises(SystemExit) as e:
        run("lint", address=False)
    assert "10e-iii" in str(e.value) and "ray_tpu/devtools/" in str(e.value)
