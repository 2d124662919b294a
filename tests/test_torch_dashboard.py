"""The dashboard head and Grafana boards of ray_tpu_torch against ray_tpu's,
on the CPU.

tests/test_dashboard.py's three cases (routes; serve, logs and events; the
profile endpoint) run through both packages, one `cluster_utils.Cluster`
and one head per runtime for this file, never both at once (a module
fixture over the two runtimes, each started after both runtimes are shut
down): JAX's run records what it got, the port's run is held to the
record. Ids, addresses, pids, times and sample counts differ between runs,
so a record holds what does not: each route's status code and content
type, the keys of its JSON records (of an event, the keys the page
reads), the values the case set up (the named actor and its state, the
job kinds, the serve snapshot), and the index
page with its accelerator column (the port's "gpu"/`GPU`, JAX's
"tpu"/`TPU`) named alike. Nothing is numeric, so there is no tolerance.

Then Grafana generation (tests/test_observability.py's case): the same
boards from the same metric list, the same files from `KNOWN_METRICS`
(the provisioning path masked), the same metadata parsed from the same
Prometheus text; a live head daemon's exposition holds every
`KNOWN_METRICS` name, and this process's `registry_snapshot()` names all
carry the `raytpu_` prefix the "all" board selects, in both packages.
"""
import importlib
import json
import os
import urllib.request

import pytest

import ray_tpu
import ray_tpu_torch

RUNTIMES = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]
RECORD = {}


def _mod(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _agree(name, rt, got):
    """Record JAX's result; hold the port's to it."""
    if rt is ray_tpu:
        RECORD[name] = got
    elif name in RECORD:
        assert got == RECORD[name], (name, got, RECORD[name])
    return got


@pytest.fixture(scope="module", params=RUNTIMES, ids=IDS)
def dash_cluster(request):
    rt = request.param
    for other in RUNTIMES:
        if other.is_initialized():
            other.shutdown()
    cluster = _mod(rt, "cluster_utils").Cluster(head_node_args={"num_cpus": 2})
    cluster.connect()
    head, port = _mod(rt, "dashboard").start_dashboard(cluster.address)
    try:
        yield rt, cluster, port
    finally:
        cluster.shutdown()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def _keys(rows):
    return sorted({k for r in rows for k in r})


def test_dashboard_routes(dash_cluster):
    rt, _, port = dash_cluster

    @rt.remote
    def f(x):
        return x + 1

    @rt.remote
    class A:
        def ping(self):
            return "pong"

    a = A.options(name="dash_actor").remote()
    assert rt.get(a.ping.remote(), timeout=30) == "pong"
    assert rt.get(f.remote(1), timeout=30) == 2

    got = {}
    for path in ("/api/nodes", "/api/actors", "/api/cluster_status",
                 "/api/tasks?limit=50", "/api/jobs", "/api/pgs", "/api/timeline"):
        status, ctype, body = _get(port, path)
        got[path] = (status, ctype)
        payload = json.loads(body)
        if path == "/api/nodes":
            got["nodes"] = (_keys(payload), any(n["alive"] for n in payload))
        elif path == "/api/actors":
            got["actors"] = (_keys(payload), [(x["name"], x["state"], x["cls_name"])
                                              for x in payload if x.get("name")])
        elif path == "/api/cluster_status":
            got["cluster_status"] = sorted(payload)
        elif path == "/api/jobs":
            got["jobs"] = (_keys(payload), sorted({j["kind"] for j in payload}))
    status, ctype, body = _get(port, "/")
    page = body.decode()
    if rt is ray_tpu_torch:
        page = page.replace('"gpu"', '"tpu"').replace(".GPU", ".TPU")
    got["/"] = (status, ctype, page)
    status, ctype, body = _get(port, "/api/metrics")
    got["/api/metrics"] = (status, ctype, body.startswith(b"# node "))
    rec = _agree("routes", rt, got)
    assert rec["nodes"][1] and ("dash_actor", "ALIVE", "A") in rec["actors"][1]
    assert rec["jobs"][1] == ["driver"]


def test_dashboard_serve_logs_events(dash_cluster):
    """Serve status from the controller's KV snapshot, logs from the
    LogManager's ring buffers, events from the structured event log."""
    rt, _, port = dash_cluster
    got = {"serve_empty": _get(port, "/api/serve")}
    snap = {"myapp": {"target": 2, "running": 2, "ready": 1,
                      "version": 3, "replicas": ["a", "b"]}}
    _mod(rt, "api")._global_worker().kv_put("serve", b"status",
                                            json.dumps(snap).encode())
    got["serve"] = _get(port, "/api/serve")
    status, ctype, body = _get(port, "/api/events?limit=10")
    # Which events the log holds depends on timing (a slow handler under
    # load adds one with more keys): hold every event to the keys the
    # page reads.
    events = json.loads(body)
    got["events"] = (status, ctype, bool(events), all(
        {"ts", "severity", "source", "message"} <= set(e) for e in events))
    status, ctype, body = _get(port, "/api/logs?lines=5")
    streams = json.loads(body)
    got["logs"] = (status, ctype, all("lines" in s for s in streams),
                   all(len(s["lines"]) <= 5 for s in streams))
    rec = _agree("serve_logs_events", rt, got)
    assert json.loads(rec["serve"][2]) == snap and rec["logs"][2]


def test_dashboard_profile_endpoint(dash_cluster):
    """On-demand worker stack sampling over REST."""
    rt, _, port = dash_cluster

    @rt.remote
    def warm():
        return 1

    assert rt.get(warm.remote(), timeout=60) == 1
    status, ctype, body = _get(port, "/api/profile?duration=0.5")
    rep = json.loads(body)
    summary = (status, ctype, sorted(rep), rep["samples"] > 0, bool(rep["worker_id"]))
    status, ctype, body = _get(port, "/api/profile?duration=0.5&format=collapsed")
    got = (summary, (status, ctype, b";" in body))
    assert _agree("profile", rt, got) == (
        summary[:2] + (summary[2], True, True), (200, "text/plain; charset=utf-8", True))


def test_grafana_boards_match(dash_cluster, tmp_path):
    rt, _, port = dash_cluster
    grafana = _mod(rt, "dashboard.grafana")
    metrics = [
        {"name": "raytpu_tasks_submitted", "description": "t", "kind": "counter"},
        {"name": "raytpu_store_used_bytes", "description": "b", "kind": "gauge"},
        {"name": "raytpu_rpc_latency", "description": "l", "kind": "histogram"},
    ]
    board = grafana.generate_dashboard("test board", metrics=metrics)
    out = tmp_path / rt.__name__
    files = {}
    for path in grafana.write_dashboards(str(out), metrics=grafana.KNOWN_METRICS):
        with open(path) as f:
            files[os.path.basename(path)] = f.read().replace(str(out), "<dir>")
    text = ("# HELP raytpu_workers live workers\n"
            "# TYPE raytpu_workers gauge\n"
            "raytpu_workers 3\n"
            "# HELP raytpu_lease_grant_seconds lease grant latency\n"
            "# TYPE raytpu_lease_grant_seconds histogram\n")
    parsed = grafana.metrics_from_prometheus_text(text)
    # The head daemon's own exposition, through the dashboard's scrape.
    _, _, body = _get(port, "/api/metrics")
    live = {m["name"] for m in grafana.metrics_from_prometheus_text(body.decode())}
    absent = sorted(m["name"] for m in grafana.KNOWN_METRICS if m["name"] not in live)
    # This process's own registry: every name on the "all" board's prefix.
    own = _mod(rt, "util.metrics").registry_snapshot()
    got = (board, files, parsed, grafana.KNOWN_METRICS, grafana.DEFAULT_DASHBOARDS,
           absent, bool(own) and all(m["name"].startswith("raytpu_") for m in own))
    rec = _agree("grafana", rt, got)
    assert len(rec[0]["panels"]) == 3 and "provisioning.yaml" in rec[1]
    assert rec[5] == [] and rec[6]
    assert "raytpu_workers" in live
