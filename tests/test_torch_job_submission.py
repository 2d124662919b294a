"""Job submission in ray_tpu_torch against ray_tpu's, on each package's
`cluster_utils.Cluster`, on the CPU.

tests/test_job_submission.py's six cases run through both packages, one
cluster per runtime for this file, never both at once (a module fixture
over the two runtimes, each started after both runtimes are shut down):
JAX's run records what it got, the port's run is held to the record. A
record holds each job's terminal status and message, the order of the
statuses seen while polling (checked to run PENDING, RUNNING, then the
terminal one, since a poll may miss a short state), the whole log text, and
for the HTTP cases the status codes, content types and bodies the head
sent, with the random submission id masked as `<sid>`. Nothing is
numeric, so there is no tolerance: every compared field must be equal.

The HTTP cases go through each package's dashboard head: aiohttp in the
JAX package, the standard library's asyncio in the port. One more case,
the port's alone, runs its head in a subprocess that blocks `aiohttp`, and
checks that a job submitted over HTTP succeeds there with no `aiohttp`
module loaded.
"""
import importlib
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu
import ray_tpu_torch

RUNTIMES = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]
RECORD = {}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("PENDING", "RUNNING", "SUCCEEDED", "FAILED", "STOPPED")


def _mod(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _agree(name, rt, got):
    """Record JAX's result; hold the port's to it."""
    if rt is ray_tpu:
        RECORD[name] = got
    elif name in RECORD:
        assert got == RECORD[name], (name, got, RECORD[name])
    return got


def _shutdown_all():
    for other in RUNTIMES:
        if other.is_initialized():
            other.shutdown()


@pytest.fixture(scope="module", params=RUNTIMES, ids=IDS)
def job_cluster(request):
    rt = request.param
    _shutdown_all()
    cluster = _mod(rt, "cluster_utils").Cluster(head_node_args={"num_cpus": 4})
    cluster.connect()
    head, port = _mod(rt, "dashboard").start_dashboard(cluster.address)
    try:
        yield rt, cluster, port
    finally:
        cluster.shutdown()


def _follow(client, sid, timeout=180):
    """Poll to a terminal status; the statuses seen, in order, once each."""
    seen = []
    deadline = time.monotonic() + timeout
    while True:
        status = client.get_job_status(sid)
        if not seen or seen[-1] != status:
            seen.append(status)
        if status in ("SUCCEEDED", "FAILED", "STOPPED"):
            break
        assert time.monotonic() < deadline, seen
        time.sleep(0.1)
    ranks = [ORDER.index(s) for s in seen]
    assert ranks == sorted(ranks) and len(seen) == len(set(seen)), seen
    return seen[-1]


def _terminal(client, sid, timeout=180):
    info = client.wait_until_finished(sid, timeout=timeout)
    return info.status, info.message


def test_job_runs_to_success_with_logs(job_cluster):
    rt, _, _ = job_cluster
    js = _mod(rt, "job_submission")
    client = js.JobSubmissionClient()
    sid = client.submit_job(entrypoint=f"{sys.executable} -c \"print('hello from job')\"")
    final = _follow(client, sid)
    got = (final, _terminal(client, sid), client.get_job_logs(sid),
           any(j.submission_id == sid for j in client.list_jobs()))
    assert _agree("success", rt, got)[0] == js.JobStatus.SUCCEEDED


def test_job_entrypoint_joins_cluster(job_cluster):
    """The entrypoint's own init() lands on this cluster (RAY_TPU_ADDRESS)
    and runs a task there."""
    rt, cluster, _ = job_cluster
    js = _mod(rt, "job_submission")
    script = (f"import {rt.__name__} as rt, {rt.__name__}.api as api\n"
              "rt.init()\n"
              "@rt.remote\n"
              "def f(x):\n"
              "    return x * 2\n"
              'print("task result:", rt.get(f.remote(21)))\n'
              'print("same cluster:", api._global_worker().gcs_address == '
              f'"{cluster.address}")\n'
              "rt.shutdown()\n")
    client = js.JobSubmissionClient()
    sid = client.submit_job(entrypoint=f"{sys.executable} -c '{script}'")
    got = (_terminal(client, sid), client.get_job_logs(sid))
    assert _agree("joins", rt, got)[0][0] == "SUCCEEDED", got
    assert "task result: 42" in got[1], got


def test_job_failure_reported(job_cluster):
    rt, _, _ = job_cluster
    js = _mod(rt, "job_submission")
    client = js.JobSubmissionClient()
    sid = client.submit_job(entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
    got = (_follow(client, sid), _terminal(client, sid), client.get_job_logs(sid))
    assert _agree("failure", rt, got)[1] == ("FAILED", "entrypoint exited with code 3")


def test_job_stop(job_cluster):
    rt, _, _ = job_cluster
    js = _mod(rt, "job_submission")
    client = js.JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c 'import time; time.sleep(600)'")
    deadline = time.monotonic() + 60
    while (client.get_job_status(sid) == js.JobStatus.PENDING
           and time.monotonic() < deadline):
        time.sleep(0.2)
    stopped = client.stop_job(sid)
    terminal = _terminal(client, sid, timeout=60)
    again = client.stop_job(sid)
    deleted = client.delete_job(sid)
    with pytest.raises(RuntimeError) as e:
        client.get_job_info(sid)
    got = (stopped, terminal, again, deleted, str(e.value).replace(sid, "<sid>"))
    assert _agree("stop", rt, got)[:2] == (True, ("STOPPED", "stopped by user"))


def _http(port, method, path, body=None, raw=None):
    """(status, content type, body text) of one request to the head."""
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def test_job_http_submit_logs_stop(job_cluster):
    """Submit, status, logs and stop over the head's REST API only."""
    rt, _, port = job_cluster
    js = _mod(rt, "job_submission")
    client = js.JobSubmissionClient(f"http://127.0.0.1:{port}")
    sid = client.submit_job(entrypoint=f"{sys.executable} -c \"print('http job ran')\"")
    first = (_follow(client, sid), _terminal(client, sid), client.get_job_logs(sid),
             any(j.submission_id == sid for j in client.list_jobs()))
    info = _http(port, "GET", f"/api/jobs/{sid}")
    record = json.loads(info[2])
    keys = sorted(record)
    sid2 = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import time; time.sleep(600)\"")
    deadline = time.monotonic() + 120
    while client.get_job_status(sid2) != js.JobStatus.RUNNING:
        assert time.monotonic() < deadline, "job never started"
        time.sleep(0.2)
    stopped = client.stop_job(sid2)
    second = (stopped, _terminal(client, sid2, timeout=120),
              _http(port, "POST", f"/api/jobs/{sid2}/stop"))
    got = (first, info[:2], keys, record["status"], second)
    assert _agree("http_submit", rt, got)[0][0] == "SUCCEEDED"
    assert second[1][0] == "STOPPED"


def test_job_http_env_vars_and_errors(job_cluster):
    rt, _, port = job_cluster
    js = _mod(rt, "job_submission")
    client = js.JobSubmissionClient(f"http://127.0.0.1:{port}")
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import os; print('V=' + os.environ['MY_VAR'])\"",
        runtime_env={"env_vars": {"MY_VAR": "http-env"}})
    ran = (_terminal(client, sid), client.get_job_logs(sid))
    with pytest.raises(RuntimeError, match="already exists") as dup:
        client.submit_job(entrypoint="true", submission_id=sid)
    with pytest.raises(RuntimeError) as unknown:
        client.get_job_status("raytpu_job_nonexistent")

    def masked(resp):
        return tuple(x.replace(sid, "<sid>") if isinstance(x, str) else x for x in resp)

    errors = [masked(r) for r in (
        _http(port, "POST", "/api/jobs", {"entrypoint": "true", "submission_id": sid}),
        _http(port, "POST", "/api/jobs", raw=b"{not json"),
        _http(port, "POST", "/api/jobs", {"submission_id": "x"}),
        _http(port, "GET", "/api/jobs/raytpu_job_nonexistent"),
        _http(port, "GET", "/api/jobs/raytpu_job_nonexistent/logs"),
        _http(port, "POST", "/api/jobs/raytpu_job_nonexistent/stop"),
        _http(port, "GET", "/api/jobs/x/stop"),
        _http(port, "GET", "/api/no_such_route"),
        _http(port, "GET", "/api/tasks?limit=x"),
    )]
    got = (ran, str(dup.value).replace(sid, "<sid>"), str(unknown.value), errors)
    assert _agree("http_errors", rt, got)[0] == (("SUCCEEDED", ""), "V=http-env\n")
    assert [e[0] for e in errors] == [400, 400, 400, 404, 404, 404, 405, 404, 500]


_STDLIB_HEAD = r"""
import importlib.abc, json, sys, time
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "aiohttp":
            raise ImportError("aiohttp is blocked")
        return None
sys.meta_path.insert(0, Block())
from ray_tpu_torch.dashboard import start_dashboard
from ray_tpu_torch.job_submission import JobSubmissionClient
head, port = start_dashboard(sys.argv[1])
client = JobSubmissionClient(f"http://127.0.0.1:{port}")
sid = client.submit_job(entrypoint=sys.executable + " -c \"print('stdlib head')\"")
info = client.wait_until_finished(sid, timeout=120)
print(json.dumps({"status": info.status, "logs": client.get_job_logs(sid),
                  "aiohttp": sorted(m for m in sys.modules if m.startswith("aiohttp"))}))
"""


def test_the_port_head_runs_without_aiohttp(job_cluster):
    rt, cluster, _ = job_cluster
    if rt is ray_tpu:
        return   # the JAX head is aiohttp's; the claim is the port's
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _STDLIB_HEAD, cluster.address],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"status": "SUCCEEDED", "logs": "stdlib head\n", "aiohttp": []}, out
