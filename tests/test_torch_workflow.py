"""Durable workflows, the usage snapshot and the profiling plugin of
ray_tpu_torch against ray_tpu's, on the CPU.

The scenarios of tests/test_workflow.py and test_workflow_callbacks.py run
through both packages on `init(local_mode=True)`, one runtime after the
other: a run and its stored result, resume skipping completed steps,
inputs and `run_async`, continuations (fan-out, nested, resumed without
rerunning the generator), per-step retry then catch, events and their
timeout, and resume after the driver's death (a child driver SIGKILLed
mid-step). Each scenario returns its values, the step executions it
counted, and the storage tree (relative paths: the same step keys, e.g.
`steps/0000_flaky_base.pkl`, and the same layout); the two must be equal.

Then the usage snapshot that `shutdown()` writes (JAX's keys), the opt-in
`report_usage` against a stdlib HTTP server on 127.0.0.1, and the
`tpu_profiling` plugin: a cluster task under `jax_trace_dir` leaves a
torch.profiler trace of its worker once the cluster has shut down.
"""
import gc
import http.server
import importlib
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch

RUNTIMES = [ray_tpu, ray_tpu_torch]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _shutdown_all():
    for other in RUNTIMES:
        if other.is_initialized():
            other.shutdown()


def _tree(root):
    """Every file under `root`, relative, sorted (pid-suffixed temp files
    never survive a finished write)."""
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


def _counts(path):
    return open(path).read() if os.path.exists(path) else ""


def _run_local(scenario, tmp_path):
    got = []
    for rt in RUNTIMES:
        _shutdown_all()
        rt.init(local_mode=True)
        root = tmp_path / rt.__name__
        root.mkdir()
        try:
            got.append(scenario(rt, _mod(rt, "workflow"), str(root)))
        finally:
            rt.shutdown()
            # Collect the run's ref cycles now, with no engine lock held:
            # a collection inside JAX's local store lock that frees a ref
            # deadlocks its thread (ROADMAP C).
            gc.collect()
    return got


# -- scenarios (tests/test_workflow.py) ----------------------------------------

def w_run_and_store(rt, workflow, root):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def double(x):
        return 2 * x

    out = workflow.run(double.bind(add.bind(2, 3)), workflow_id="wf1", storage=root)
    return (out, workflow.get_status("wf1", storage=root),
            workflow.get_output("wf1", storage=root), workflow.list_all(storage=root),
            _tree(root))


def w_resume_skips_completed(rt, workflow, root):
    runs = os.path.join(root, "base_runs")

    @rt.remote
    def flaky_base():
        with open(runs, "a") as f:
            f.write("x")
        return 7

    @rt.remote
    def exploding(x):
        raise RuntimeError("mid-workflow crash")

    @rt.remote
    def triple(x):
        return 3 * x

    with pytest.raises(Exception, match="mid-workflow crash"):
        workflow.run(exploding.bind(flaky_base.bind()), workflow_id="wf2", storage=root)
    failed = workflow.get_status("wf2", storage=root)
    out = workflow.resume("wf2", triple.bind(flaky_base.bind()), storage=root)
    return failed, out, workflow.get_status("wf2", storage=root), _counts(runs), _tree(root)


def w_input_and_async(rt, workflow, root):
    @rt.remote
    def scale(x, k):
        return x * k

    with _mod(rt, "dag").InputNode() as inp:
        dag = scale.bind(inp, 5)
    fut = workflow.run_async(dag, 4, workflow_id="wf3", storage=root)
    return fut.result(timeout=120), _tree(root)


def w_continuations(rt, workflow, root):
    @rt.remote
    def leaf(i):
        return i * i

    @rt.remote
    def merge(*xs):
        return sum(xs)

    @rt.remote
    def plan(n):
        return workflow.continuation(merge.bind(*[leaf.bind(i) for i in range(n)]))

    @rt.remote
    def plus_one(x):
        return x + 1

    @rt.remote
    def base(x):
        return x + 100

    @rt.remote
    def inner(x):
        return workflow.continuation(base.bind(x))

    @rt.remote
    def outer():
        return workflow.continuation(inner.bind(5))

    fan = workflow.run(plus_one.bind(plan.bind(4)), workflow_id="wf-cont", storage=root)
    nested = workflow.run(outer.bind(), workflow_id="wf-nest", storage=root)
    return fan, nested, _tree(root)


def w_continuation_resume(rt, workflow, root):
    gen_runs, a_runs = os.path.join(root, "gen_runs"), os.path.join(root, "a_runs")
    fail_flag = os.path.join(root, "fail")

    @rt.remote
    def step_a():
        with open(a_runs, "a") as f:
            f.write("x")
        return 3

    @rt.remote
    def step_b(x, flag):
        if os.path.exists(flag):
            raise RuntimeError("sub-step failing this run")
        return x * 10

    @rt.remote
    def gen(flag):
        with open(gen_runs, "a") as f:
            f.write("x")
        return workflow.continuation(step_b.bind(step_a.bind(), flag))

    open(fail_flag, "w").close()
    dag = gen.bind(fail_flag)
    with pytest.raises(Exception, match="sub-step failing"):
        workflow.run(dag, workflow_id="wf-cres", storage=root)
    os.unlink(fail_flag)
    out = workflow.resume("wf-cres", dag, storage=root)
    return out, _counts(gen_runs), _counts(a_runs), _tree(root)


def w_retry_then_catch(rt, workflow, root):
    attempts = os.path.join(root, "attempts")

    @rt.remote(max_retries=0)
    def flaky():
        with open(attempts, "a") as f:
            f.write("x")
        if os.path.getsize(attempts) < 3:
            raise ValueError("not yet")
        return "ok"

    @rt.remote(max_retries=0)
    def always_fails():
        raise ValueError("permanent")

    @rt.remote
    def boom():
        raise ValueError("wf boom")

    @rt.remote
    def handle(pair):
        value, err = pair
        return f"recovered:{err is not None}"

    retried = workflow.run(workflow.retry(flaky.bind(), max_retries=5, backoff_s=0.01),
                           workflow_id="wf-retry", storage=root)
    val, err = workflow.run(
        workflow.catch(workflow.retry(always_fails.bind(), max_retries=2, backoff_s=0.01)),
        workflow_id="wf-rc", storage=root)
    caught = workflow.run(handle.bind(workflow.catch(boom.bind())), workflow_id="catch_wf",
                          storage=root)
    return retried, _counts(attempts), val, "permanent" in err, caught, _tree(root)


def w_events(rt, workflow, root):
    @rt.remote
    def combine(x, approval):
        return {"x": x, "approved": approval["ok"]}

    @rt.remote
    def use(e):
        return e

    with _mod(rt, "dag").InputNode() as inp:
        dag = combine.bind(inp, workflow.event("approval", timeout_s=60))

    def deliver():
        time.sleep(0.8)
        workflow.send_event("evt_wf", "approval", {"ok": True}, storage=root)

    threading.Thread(target=deliver, daemon=True).start()
    t0 = time.monotonic()
    out = workflow.run(dag, 5, workflow_id="evt_wf", storage=root)
    waited = time.monotonic() - t0 >= 0.7
    t0 = time.monotonic()
    again = workflow.resume("evt_wf", dag, 5, storage=root)
    no_rewait = time.monotonic() - t0 < 0.7
    with pytest.raises(TimeoutError):
        workflow.run(use.bind(workflow.event("never", timeout_s=0.5)), workflow_id="evt_to",
                     storage=root)
    with pytest.raises(ValueError, match="invalid event name"):
        workflow.event("../x")
    return out, waited, again, no_rewait, workflow.get_status("evt_to", storage=root), \
        _tree(root)


WORKFLOW_SCENARIOS = {
    "run_and_store": w_run_and_store, "resume_skips_completed": w_resume_skips_completed,
    "input_and_async": w_input_and_async, "continuations": w_continuations,
    "continuation_resume": w_continuation_resume, "retry_then_catch": w_retry_then_catch,
    "events": w_events}


@pytest.mark.parametrize("name", list(WORKFLOW_SCENARIOS))
def test_local_mode_workflow_matches_jax(name, tmp_path):
    got = _run_local(WORKFLOW_SCENARIOS[name], tmp_path)
    assert got[0] == got[1], got


def test_step_keys_match_jax():
    """`_step_key` and `_topo_order` number the same DAG the same way."""
    keys = []
    for rt in RUNTIMES:
        api = _mod(rt, "workflow.api")

        @rt.remote
        def a():
            return 1

        @rt.remote
        def b(x, y):
            return x + y

        with _mod(rt, "dag").InputNode() as inp:
            shared = a.bind()
            root = _mod(rt, "dag.dag_node").MultiOutputNode(
                [b.bind(shared, inp), b.bind(shared, api.event("go"))])
        order = api._topo_order(root)
        nodes = {}

        def walk(n):
            nodes[id(n)] = n
            for c in n._children():
                walk(c)

        walk(root)
        keys.append(sorted(api._step_key(nodes[i], k) for i, k in order.items()))
    assert keys[0] == keys[1]
    assert "0000_a" in keys[1] and any(k.endswith("event-go") for k in keys[1])


def test_resume_after_driver_death_matches_jax(tmp_path):
    """Kill a child driver mid-step; this process resumes the same DAG and
    only the unfinished steps run, in each package."""
    got = []
    for rt in RUNTIMES:
        _shutdown_all()
        root = tmp_path / rt.__name__
        root.mkdir()
        marker_a, marker_c = str(root / "a"), str(root / "c")
        script = textwrap.dedent(f"""
            import sys, time
            sys.path.insert(0, {REPO!r})
            import {rt.__name__} as rt
            from {rt.__name__} import workflow

            rt.init(local_mode=True)

            @rt.remote
            def a():
                with open({marker_a!r}, "a") as f:
                    f.write("x")
                return 1

            @rt.remote
            def b(x):
                time.sleep(600)   # the driver dies while this step runs
                return x

            @rt.remote
            def c(x):
                with open({marker_c!r}, "a") as f:
                    f.write("x")
                return x + 1

            workflow.run(c.bind(b.bind(a.bind())), workflow_id="wf-crash",
                         storage={str(root)!r})
        """)
        proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not os.path.exists(marker_a):
            time.sleep(0.1)
        assert os.path.exists(marker_a), "step a never ran in the child driver"
        time.sleep(1.0)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        status = _mod(rt, "workflow").get_status("wf-crash", storage=str(root))

        rt.init(local_mode=True)
        try:
            @rt.remote
            def a():
                with open(marker_a, "a") as f:
                    f.write("x")
                return 1

            @rt.remote
            def b(x):
                return x

            @rt.remote
            def c(x):
                with open(marker_c, "a") as f:
                    f.write("x")
                return x + 1

            out = _mod(rt, "workflow").resume("wf-crash", c.bind(b.bind(a.bind())),
                                              storage=str(root))
        finally:
            rt.shutdown()
            gc.collect()
        got.append((status, out, _counts(marker_a), _counts(marker_c), _tree(root)))
    assert got[0] == got[1] == [("RUNNING", 2, "x", "x", got[0][4])][0], got


# -- the usage snapshot and report ---------------------------------------------

def _with_config(rt, env: dict, fn):
    """fn() with RAY_TPU_* knobs set, the runtime's config singleton reset
    around it."""
    reset = _mod(rt, "core.config").reset_config
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    reset()
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset()


def test_shutdown_writes_the_usage_snapshot_as_jax(tmp_path):
    snaps = []
    for rt in RUNTIMES:
        _shutdown_all()
        path = str(tmp_path / f"{rt.__name__}.json")

        def session():
            rt.init(local_mode=True)
            _mod(rt, "tune")
            _mod(rt, "workflow")
            rt.shutdown()
            gc.collect()

        _with_config(rt, {"RAY_TPU_USAGE_STATS_PATH": path}, session)
        with open(path) as f:
            snaps.append(json.load(f))
    jax_snap, port_snap = snaps
    assert sorted(port_snap) == sorted(jax_snap)
    assert port_snap["schema_version"] == 1 and port_snap["ray_tpu_version"]
    assert {"tune", "workflow", "train"} <= set(port_snap["libraries_used"])
    assert port_snap["num_nodes"] == jax_snap["num_nodes"] == 1


class _Sink(http.server.BaseHTTPRequestHandler):
    bodies = []

    def do_POST(self):  # noqa: N802 — the stdlib's hook name
        n = int(self.headers["Content-Length"])
        _Sink.bodies.append(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


def test_report_usage_posts_only_when_enabled():
    server = http.server.HTTPServer(("127.0.0.1", 0), _Sink)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/usage"
    try:
        sent = []
        for rt in RUNTIMES:
            us = _mod(rt, "util.usage_stats")
            off = _with_config(rt, {"RAY_TPU_USAGE_STATS_URL": url,
                                    "RAY_TPU_USAGE_STATS_ENABLED": "0"}, us.report_usage)
            no_url = _with_config(rt, {"RAY_TPU_USAGE_STATS_URL": "",
                                       "RAY_TPU_USAGE_STATS_ENABLED": "1"}, us.report_usage)
            n = len(_Sink.bodies)
            on = _with_config(rt, {"RAY_TPU_USAGE_STATS_URL": url,
                                   "RAY_TPU_USAGE_STATS_ENABLED": "1"}, us.report_usage)
            sent.append((off, no_url, on, len(_Sink.bodies) - n))
        # A dead endpoint is swallowed: reporting never breaks a workload.
        dead = _with_config(ray_tpu_torch, {"RAY_TPU_USAGE_STATS_URL": "http://127.0.0.1:9/x",
                                            "RAY_TPU_USAGE_STATS_ENABLED": "1"},
                            lambda: _mod(ray_tpu_torch, "util.usage_stats").report_usage(
                                timeout_s=2.0))
    finally:
        server.shutdown()
    assert sent == [(False, False, True, 1)] * 2
    assert dead is False
    assert sorted(_Sink.bodies[-1]) == sorted(_Sink.bodies[-2])
    assert _Sink.bodies[-1]["schema_version"] == 1


# -- the profiling plugin ------------------------------------------------------

def test_profiling_plugin_leaves_a_trace_after_shutdown(tmp_path):
    """A task under `tpu_profiling: {jax_trace_dir: d}` runs in a worker
    that traces itself with torch.profiler; the cluster's shutdown
    SIGTERMs it, and it writes a Chrome trace into `d`."""
    _shutdown_all()
    trace_dir = str(tmp_path / "traces")
    rt = ray_tpu_torch
    rt.init(num_cpus=2)
    try:
        @rt.remote(runtime_env={"tpu_profiling": {"jax_trace_dir": trace_dir,
                                                  "xla_dump_to": "/d",
                                                  "log_compiles": True}})
        def probe():
            import os

            import torch

            x = torch.ones(64, 64)
            return (os.environ.get("RAY_TPU_JAX_TRACE_DIR"), os.environ.get("XLA_FLAGS"),
                    os.environ.get("JAX_LOG_COMPILES"), float((x @ x).sum()), os.getpid())

        got_dir, flags, log_compiles, total, pid = rt.get(probe.remote(), timeout=120)
    finally:
        rt.shutdown()
    assert got_dir == trace_dir and "--xla_dump_to=/d" in flags and log_compiles == "1"
    assert total == 64.0 ** 3
    path = os.path.join(trace_dir, f"worker_{pid}.json")
    deadline = time.monotonic() + 10
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.1)
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names, sorted(n for n in names if n)[:40]
