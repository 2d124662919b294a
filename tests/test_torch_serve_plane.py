"""The serve control plane of ray_tpu_torch against ray_tpu's, on the CPU.

Each runtime starts one single-host cluster for this file
(`init(num_cpus=4)`), never both at once, and ends with `serve.shutdown()`
and `shutdown()` in `finally`. Every scenario of tests/test_serve.py and
tests/test_serve_streaming.py, the HTTP contract (status codes, the echoed
`X-Request-Id`, bodies, JSONL lines; 404, 422, 500 and the 503 +
`Retry-After` shed past the proxy's `max_inflight`) and a stream resumed
exactly once after its replica is killed run through both runtimes and must
give the same values, error type names and masked messages: JAX's run
records what it got, the port's run is held to the record. Two faults both
runtimes have, fixed in the port (a redeploy routing to a retired replica, a
drained replica leaving what it owned in the store), run through both too,
each runtime held to its own contract. Besides, the port's proxy serves a
request in a process where aiohttp cannot be imported.
"""
import importlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu
import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = {}   # scenario -> what the JAX package's cluster gave


def _mask(text: str) -> str:
    return re.sub(r"[0-9a-f]{8,}", "<id>", str(text))


def _error(exc: BaseException) -> tuple:
    return type(exc).__name__, _mask(str(exc))


@pytest.fixture(scope="module", params=[ray_tpu, ray_tpu_torch],
                ids=["ray_tpu", "ray_tpu_torch"])
def cluster(request):
    rt = request.param
    for other in (ray_tpu, ray_tpu_torch):
        if other.is_initialized():
            importlib.import_module(f"{other.__name__}.serve").shutdown()
            other.shutdown()
    address = os.environ.pop("RAY_TPU_ADDRESS", None)
    serve = importlib.import_module(f"{rt.__name__}.serve")
    try:
        rt.init(num_cpus=4)
        yield rt, serve
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
            if address is not None:
                os.environ["RAY_TPU_ADDRESS"] = address


def _agree(name: str, rt, got):
    """Record JAX's result; hold the port's to it."""
    if rt is ray_tpu:
        RECORD[name] = got
    elif name in RECORD:
        assert got == RECORD[name], (name, got, RECORD[name])
    return got


def _http(port, path, body=None, headers=None, raw=None):
    """(status, echoed X-Request-Id, Retry-After, body bytes) of one
    request; error statuses too."""
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return (r.status, r.headers.get("X-Request-Id"),
                    r.headers.get("Retry-After"), r.read())
    except urllib.error.HTTPError as e:
        return (e.code, e.headers.get("X-Request-Id"),
                e.headers.get("Retry-After"), e.read())


def _wait_for(fn, timeout=30.0):
    deadline = time.time() + timeout
    while True:
        got = fn()
        if got or time.time() > deadline:
            return got
        time.sleep(0.2)


# -- the scenarios of test_serve.py ------------------------------------------

def s_function_deployment(rt, serve, tmp_path):
    @serve.deployment
    def hello(name="world"):
        return f"hello {name}"

    h = serve.run(hello.bind(), name="hello_app")
    out = [h.remote().result(timeout=30), h.remote("tpu").result(timeout=30)]
    serve.delete("hello_app")
    return out


def s_class_deployment_with_state_and_methods(rt, serve, tmp_path):
    @serve.deployment(num_replicas=1)
    class Model:
        def __init__(self, scale):
            self.scale = scale

        def __call__(self, x):
            return x * self.scale

        def describe(self):
            return {"scale": self.scale}

    h = serve.run(Model.bind(3), name="model_app")
    out = [h.remote(7).result(timeout=30),
           h.describe.remote().result(timeout=30)]
    serve.delete("model_app")
    return out


def s_multi_replica_routing(rt, serve, tmp_path):
    @serve.deployment(num_replicas=2)
    class WhoAmI:
        def __call__(self):
            return os.getpid()

    h = serve.run(WhoAmI.bind(), name="who_app")
    pids = {h.remote().result(timeout=30) for _ in range(20)}
    serve.delete("who_app")
    return len(pids)


def s_status_and_reconfigure_scale(rt, serve, tmp_path):
    @serve.deployment(num_replicas=1)
    def f():
        return 1

    serve.run(f.bind(), name="scale_app")
    first = serve.status()["scale_app"]["running"]
    serve.run(f.options(num_replicas=3).bind(), name="scale_app")
    running = _wait_for(
        lambda: serve.status()["scale_app"]["running"] == 3 and 3)
    worker = rt.api._global_worker()

    def snapshot():
        blob = worker.kv_get("serve", b"status")
        snap = json.loads(blob) if blob else {}
        return snap if snap.get("scale_app", {}).get("running") == 3 else {}

    snap = _wait_for(snapshot, 15)
    serve.delete("scale_app")
    return [first, running, snap["scale_app"]["target"],
            snap["scale_app"]["running"]]


def s_redeploy_replaces_old_replicas(rt, serve, tmp_path):
    @serve.deployment(num_replicas=1)
    class V:
        def __init__(self, v):
            self.v = v

        def __call__(self):
            return self.v

    h = serve.run(V.bind(1), name="redeploy_app")
    first = h.remote().result(timeout=30)
    serve.run(V.bind(2), name="redeploy_app")
    _wait_for(lambda: serve.get_app_handle("redeploy_app").remote().result(
        timeout=30) == 2)
    h2 = serve.get_app_handle("redeploy_app")
    out = [first] + [h2.remote().result(timeout=30) for _ in range(5)]
    serve.delete("redeploy_app")
    return out


def s_dynamic_batching(rt, serve, tmp_path):
    @serve.deployment
    class Batcher:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def __call__(self, items):
            return [x * 2 for x in items]

    h = serve.run(Batcher.bind(), name="batch_app")
    results = [None] * 8

    def call(i):
        results[i] = h.remote(i).result(timeout=30)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    serve.delete("batch_app")
    return results


def s_http_ingress(rt, serve, tmp_path):
    @serve.deployment
    def echo(payload=None):
        return {"got": payload}

    serve.run(echo.bind(), name="http_app", route_prefix="/echo", _http=True)
    port = serve.http_port()
    ok = _http(port, "/echo", {"a": 1}, {"Content-Type": "application/json",
                                         "X-Request-Id": "rid-echo"})
    missing = _http(port, "/nope", headers={"X-Request-Id": "rid-nope"})
    serve.delete("http_app")
    return [ok, missing]


def s_declarative_config_deploy(rt, serve, tmp_path):
    mod = f"_cfg_demo_app_{rt.__name__}"
    path = os.path.join(REPO, f"{mod}.py")
    with open(path, "w") as f:
        f.write(
            "class Upper:\n"
            "    def __init__(self, suffix='!'):\n"
            "        self.suffix = suffix\n"
            "    def __call__(self, text):\n"
            "        return text.upper() + self.suffix\n"
            "def build(suffix='?'):\n"
            f"    from {rt.__name__} import serve\n"
            "    return serve.deployment(Upper).bind(suffix)\n")
    try:
        cfg = {"applications": [
            {"name": "upper_cls", "import_path": f"{mod}.Upper",
             "args": {"suffix": "!!"},
             "deployment_config": {"num_replicas": 1}},
            {"name": "upper_built", "import_path": f"{mod}:build",
             "args": {"suffix": "??"}},
        ]}
        cfg_path = str(tmp_path / "serve_config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        handles = serve.deploy_config(cfg_path)
        out = [handles["upper_cls"].remote("hey").result(timeout=60),
               handles["upper_built"].remote("ho").result(timeout=60)]
        serve.delete("upper_cls")
        serve.delete("upper_built")
        return out
    finally:
        os.unlink(path)
        sys.modules.pop(mod, None)


def s_deployment_graph_two_stage(rt, serve, tmp_path):
    @serve.deployment
    class Preprocessor:
        def __call__(self, text):
            return text.strip().lower()

    @serve.deployment
    class Model:
        def __init__(self, preproc, suffix):
            self.preproc = preproc
            self.suffix = suffix

        def __call__(self, text):
            return self.preproc.remote(text).result(timeout=30) + self.suffix

    h = serve.run(Model.bind(Preprocessor.bind(), "!"), name="two_stage")
    out = h.remote("  HeLLo ").result(timeout=60)
    before = sorted(serve.status())
    serve.delete("two_stage")
    return [out, before, sorted(serve.status())]


def s_deployment_graph_shared_node_deploys_once(rt, serve, tmp_path):
    @serve.deployment
    class Shared:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Left:
        def __init__(self, shared):
            self.shared = shared

        def __call__(self, x):
            return self.shared.remote(x).result(timeout=30) * 10

    @serve.deployment
    class Ingress:
        def __init__(self, left, shared):
            self.left = left
            self.shared = shared

        def __call__(self, x):
            return (self.left.remote(x).result(timeout=30)
                    + self.shared.remote(x).result(timeout=30))

    shared = Shared.bind()
    h = serve.run(Ingress.bind(Left.bind(shared), shared), name="diamond")
    out = h.remote(4).result(timeout=60)
    shared_apps = [a for a in serve.status() if a.startswith("diamond#Shared")]
    serve.delete("diamond")
    return [out, len(shared_apps)]


def s_deployment_graph_cycle_rejected(rt, serve, tmp_path):
    @serve.deployment
    class A:
        def __init__(self, other=None):
            pass

    app_a = A.bind()
    app_a.init_args = (app_a,)
    with pytest.raises(ValueError) as ei:
        serve.run(app_a, name="cyclic")
    return _error(ei.value)


def s_config_deploy_supports_graphs(rt, serve, tmp_path):
    module = ("tests.serve_graph_app" if rt is ray_tpu
              else "tests.torch_serve_graph_app")
    p = tmp_path / "app.json"
    p.write_text(json.dumps({"applications": [{
        "name": "cfg_graph", "import_path": f"{module}:build"}]}))
    handles = serve.deploy_config(str(p))
    out = handles["cfg_graph"].remote(" ABC ").result(timeout=60)
    serve.delete("cfg_graph")
    return out


# -- the scenarios of test_serve_streaming.py --------------------------------

def s_streaming_handle(rt, serve, tmp_path):
    @serve.deployment
    class Tokens:
        def stream(self, n):
            for i in range(n):
                yield {"token": i}

        def __call__(self, n):
            return {"count": n}

    handle = serve.run(Tokens.bind(), name="tokens")
    unary = handle.remote(3).result(timeout=60)
    resp = handle.options(method_name="stream").remote_streaming(5)
    items = list(resp)
    serve.delete("tokens")
    return [unary, items, resp.rails_used]


def s_http_proxy_unary_and_streaming(rt, serve, tmp_path):
    @serve.deployment
    class Echo:
        def __call__(self, body):
            return {"echo": body}

        def stream(self, body):
            for i in range(int(body.get("n", 3))):
                yield {"i": i}

    serve.run(Echo.bind(), name="echo", _http=True, route_prefix="/echo")
    port = serve.http_port()
    unary = _http(port, "/echo", {"x": 1}, {"X-Request-Id": "rid-1"})
    stream = _http(port, "/echo?stream=1&method=stream", {"n": 4},
                   {"X-Request-Id": "rid-2"})
    missing = _http(port, "/nope", headers={"X-Request-Id": "rid-3"})
    serve.delete("echo")
    return [unary, stream, missing]


def s_http_streaming_chunks(rt, serve, tmp_path):
    @serve.deployment
    class Slow:
        def stream(self, body):
            for i in range(4):
                time.sleep(0.2)
                yield {"i": i}

        def __call__(self, body):
            return {}

    serve.run(Slow.bind(), name="slow", _http=True, route_prefix="/slow")
    port = serve.http_port()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/slow?stream=1&method=stream",
        data=json.dumps({"stream": True}).encode())
    t0 = time.monotonic()
    resp = urllib.request.urlopen(req, timeout=120)
    first_line = resp.readline()
    ttfb = time.monotonic() - t0
    rest = resp.read().decode().strip().splitlines()
    lines = [json.loads(first_line)] + [json.loads(x) for x in rest]
    serve.delete("slow")
    # Items stream as they are made: the first well before all four
    # 0.2 s sleeps are done.
    return [lines, resp.headers.get("Content-Type"), ttfb < 1.0]


def s_multiplexed_models(rt, serve, tmp_path):
    @serve.deployment
    class Multi:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            return {"id": model_id, "scale": int(model_id[-1])}

        def __call__(self, body):
            model = self.get_model(serve.get_multiplexed_model_id())
            return {"model": model["id"], "y": body["x"] * model["scale"]}

    handle = serve.run(Multi.bind(), name="multi", _http=True,
                       route_prefix="/multi")
    h1 = handle.options(multiplexed_model_id="m2")
    h3 = handle.options(multiplexed_model_id="m3")
    out = [h1.remote({"x": 10}).result(timeout=60),
           h3.remote({"x": 10}).result(timeout=60),
           h1.remote({"x": 5}).result(timeout=60)]
    out.append(_http(serve.http_port(), "/multi", {"x": 7},
                     {"X-Model-Id": "m3", "X-Request-Id": "rid-m"}))
    serve.delete("multi")
    return out


# -- the HTTP contract and a resumed stream (tests/test_serve_chaos.py) -------

def s_http_error_codes_and_request_id(rt, serve, tmp_path):
    @serve.deployment
    def boom(_req):
        raise ValueError("kaput")

    serve.run(boom.bind(), name="chaos_err", _http=True,
              route_prefix="/chaos_err")
    port = serve.http_port()
    bad_json = _http(port, "/chaos_err", raw=b"{not json",
                     headers={"X-Request-Id": "rid-zz"})
    status, rid, retry, body = _http(port, "/chaos_err", {},
                                     {"X-Request-Id": "rid-500"})
    error = json.loads(body)
    serve.delete("chaos_err")
    return [bad_json, status, rid, retry, error["request_id"],
            "kaput" in error["error"]]


def s_overload_sheds_with_retry_after(rt, serve, tmp_path):
    from_proxy = importlib.import_module(f"{rt.__name__}.serve.http_proxy")

    @serve.deployment(num_replicas=1, max_ongoing_requests=16)
    def slow(_req):
        time.sleep(0.8)
        return {"ok": True}

    serve.run(slow.bind(), name="chaos_shed")
    proxy = rt.remote(from_proxy.HTTPProxy).options(
        max_concurrency=32).remote("127.0.0.1", 0, max_inflight=1)
    try:
        rt.get(proxy.set_route.remote("/shed", "chaos_shed"), timeout=30)
        port = rt.get(proxy.port.remote(), timeout=30)
        statuses, lock = [], threading.Lock()

        def hit(i):
            got = _http(port, "/shed", {}, {"X-Request-Id": f"rid-{i}"})
            with lock:
                statuses.append(got)

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        shed = sorted((s, retry, json.loads(body)["error"])
                      for s, _rid, retry, body in statuses if s == 503)
        ok = [body for s, _rid, _retry, body in statuses if s == 200]
        stats = rt.get(proxy.proxy_stats.remote(), timeout=30)
        echoed = all(rid is not None for _s, rid, _r, _b in statuses)
        return [len(statuses), bool(shed), bool(ok), set(shed), set(ok),
                echoed, stats["shed_total"] == len(shed), stats["inflight"]]
    finally:
        rt.kill(proxy)
        serve.delete("chaos_shed")


def s_replica_kill_midstream_exactly_once(rt, serve, tmp_path):
    @serve.deployment(num_replicas=2)
    def ticker(request):
        for i in range(int(request["n"])):
            time.sleep(0.03)
            yield {"i": i, "pid": os.getpid()}

    h = serve.run(ticker.bind(), name="chaos_kill")
    try:
        resp = h.remote_streaming({"n": 30})
        got, killed = [], False
        for item in resp:
            got.append(item)
            if len(got) == 5 and not killed:
                killed = True
                os.kill(item["pid"], signal.SIGKILL)
        return [[x["i"] for x in got], len({x["pid"] for x in got}),
                resp.resumes >= 1]
    finally:
        serve.delete("chaos_kill")


def s_rpc_ingress(rt, serve, tmp_path):
    """The native-protocol ingress (tests/test_profiling_hf.py's
    scenario): unary calls of two methods over the runtime's own RPC."""
    rpc = importlib.import_module(f"{rt.__name__}.core.distributed.rpc")

    class Doubler:
        def __call__(self, x):
            return x * 2

        def describe(self, name):
            return f"doubler:{name}"

    serve.run(serve.deployment(Doubler).bind(), name="doubler",
              route_prefix=None)
    serve.start_rpc_ingress()
    port = serve.rpc_ingress_port()
    client = rpc.SyncRpcClient(f"127.0.0.1:{port}",
                               rt.api._global_worker().loop_thread)
    try:
        out = [client.call("ServeIngress", "invoke", app="doubler",
                           args=(21,), timeout=60),
               client.call("ServeIngress", "invoke", app="doubler",
                           target_method="describe", args=("x",),
                           timeout=60)]
    finally:
        client.close()
    serve.delete("doubler")
    return out


def s_redeploy_through_a_slow_replica_start(rt, serve, tmp_path):
    """A redeploy whose replicas take 2 s to construct, while two callers
    keep sending, each call through a fresh handle: (answers in order,
    error type names)."""
    @serve.deployment(num_replicas=1)
    class Slow:
        def __init__(self, v):
            time.sleep(2.0)
            self.v = v

        def __call__(self):
            return self.v

    serve.run(Slow.bind(1), name="slow_app")
    got, errors, stop = [], [], threading.Event()

    def caller():
        while not stop.is_set():
            try:
                got.append(serve.get_app_handle("slow_app").remote().result(
                    timeout=30))
            except Exception as e:  # noqa: BLE001 what the scenario counts
                errors.append(type(e).__name__)

    threads = [threading.Thread(target=caller) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        serve.run(Slow.bind(2), name="slow_app")
        _wait_for(lambda: got and got[-1] == 2, timeout=60)
        time.sleep(1.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        serve.delete("slow_app")
    return got, errors


def s_drained_replica_frees_what_it_owned(rt, serve, tmp_path):
    """A replica fetches an actor call's 1 MB return, which it then owns;
    the deployment is deleted: ((used bytes, objects) of the store before,
    with the replica, and after the delete)."""
    store = rt.api._global_worker().store

    @rt.remote
    class Maker:
        def make(self, n):
            import numpy as np

            return np.ones(n, np.uint8)

    maker = Maker.options(name="plane_maker", lifetime="detached").remote()
    try:
        rt.get(maker.make.remote(8), timeout=60)

        @serve.deployment
        class Fetcher:
            def __call__(self, n):
                made = rt.get(rt.get_actor("plane_maker").make.remote(n),
                              timeout=60)
                return int(made.sum())

        baseline = (store.used, store.num_objects)
        h = serve.run(Fetcher.bind(), name="fetch_app")
        assert h.remote(1_000_000).result(timeout=60) == 1_000_000
        held = (store.used, store.num_objects)
        serve.delete("fetch_app")
        # JAX's replica never sends them (its 30 s sweep aside): no wait.
        _wait_for(lambda: (store.used, store.num_objects) == baseline,
                  timeout=15 if rt is ray_tpu_torch else 0)
        return baseline, held, (store.used, store.num_objects)
    finally:
        rt.kill(maker)


SCENARIOS = [
    s_function_deployment, s_class_deployment_with_state_and_methods,
    s_multi_replica_routing, s_status_and_reconfigure_scale,
    s_redeploy_replaces_old_replicas, s_dynamic_batching, s_http_ingress,
    s_declarative_config_deploy, s_deployment_graph_two_stage,
    s_deployment_graph_shared_node_deploys_once,
    s_deployment_graph_cycle_rejected, s_config_deploy_supports_graphs,
    s_streaming_handle, s_http_proxy_unary_and_streaming,
    s_http_streaming_chunks, s_multiplexed_models,
    s_http_error_codes_and_request_id, s_overload_sheds_with_retry_after,
    s_replica_kill_midstream_exactly_once, s_rpc_ingress,
    s_redeploy_through_a_slow_replica_start,
    s_drained_replica_frees_what_it_owned,
]

# What each scenario must give (the values tests/test_serve*.py assert),
# beside agreeing with the other runtime.
EXPECTED = {
    "s_function_deployment": ["hello world", "hello tpu"],
    "s_class_deployment_with_state_and_methods": [21, {"scale": 3}],
    "s_multi_replica_routing": 2,
    "s_status_and_reconfigure_scale": [1, 3, 3, 3],
    "s_redeploy_replaces_old_replicas": [1, 2, 2, 2, 2, 2],
    "s_dynamic_batching": [i * 2 for i in range(8)],
    "s_declarative_config_deploy": ["HEY!!", "HO??"],
    "s_deployment_graph_shared_node_deploys_once": [55, 1],
    "s_config_deploy_supports_graphs": "abc?",
    "s_rpc_ingress": [42, "doubler:x"],
}




def _http_contract(got):
    """The HTTP exchanges themselves: echoed request ids, the JSON bodies,
    the JSONL lines of a stream, the 404 body."""
    unary, stream, missing = got
    assert unary == (200, "rid-1", None, b'{"echo": {"x": 1}}')
    assert stream == (200, "rid-2", None,
                      b'{"i": 0}\n{"i": 1}\n{"i": 2}\n{"i": 3}\n')
    assert missing == (404, "rid-3", None,
                       b'{"error": "no route", "request_id": "rid-3"}')


def _error_contract(got):
    bad_json, status, rid, retry, body_rid, kaput = got
    assert bad_json == (422, "rid-zz", None,
                        b'{"error": "invalid JSON", "request_id": "rid-zz"}')
    assert (status, rid, retry, body_rid, kaput) == (
        500, "rid-500", None, "rid-500", True)


def _shed_contract(got):
    n, shed, ok, shed_set, ok_set, echoed, counted, inflight = got
    assert (n, shed, ok, echoed, counted, inflight) == (
        4, True, True, True, True, 0)
    assert shed_set == {(503, "1", "overloaded")}
    assert ok_set == {b'{"ok": true}'}


def _resume_contract(got):
    order, pids, resumed = got
    assert (order, pids, resumed) == (list(range(30)), 2, True)


def _slow_redeploy_contract(rt, got):
    """Every answer is 1 until the first 2 (a call in flight at the
    switch, one a caller, may still answer 1). JAX's controller publishes
    the new routing only after probing the starting replica, so its
    callers can be sent the retired one past their retries (ROADMAP C);
    the port's keep the old replica routed until the new one is ready."""
    answers, errors = got
    assert answers and answers[-1] == 2 and set(answers) == {1, 2}, answers
    first_new = answers.index(2)
    assert set(answers[:first_new]) == {1}, answers
    assert answers[first_new:].count(1) <= 2, answers
    if rt is ray_tpu:
        assert set(errors) <= {"ActorUnavailableError", "ActorDiedError",
                               "ReplicaDrainingError"}, errors
    else:
        assert errors == [], errors


def _frees_contract(rt, got):
    """JAX's replica exits on drain without sending its batched frees, so
    the object it owned stays (ROADMAP C); the port's sends them first."""
    baseline, held, after = got
    assert held[0] >= baseline[0] + 1_000_000, got
    if rt is ray_tpu:   # unless its 30 s sweep happened to send them
        assert after in (held, baseline), got
    else:
        assert after == baseline, got


# Faults both runtimes share, fixed in the port (ROADMAP C): each runtime is
# held to its own contract instead of the port to JAX's record.
PORT_FIXED = {
    "s_redeploy_through_a_slow_replica_start": _slow_redeploy_contract,
    "s_drained_replica_frees_what_it_owned": _frees_contract,
}

CHECKS = {
    "s_http_proxy_unary_and_streaming": _http_contract,
    "s_http_error_codes_and_request_id": _error_contract,
    "s_overload_sheds_with_retry_after": _shed_contract,
    "s_replica_kill_midstream_exactly_once": _resume_contract,
}


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario(cluster, scenario, tmp_path):
    rt, serve = cluster
    if scenario.__name__ in PORT_FIXED:
        PORT_FIXED[scenario.__name__](rt, scenario(rt, serve, tmp_path))
        return
    got = _agree(scenario.__name__, rt, scenario(rt, serve, tmp_path))
    if scenario.__name__ in EXPECTED:
        assert got == EXPECTED[scenario.__name__], got
    if scenario.__name__ in CHECKS:
        CHECKS[scenario.__name__](got)


_NO_AIOHTTP = r"""
import json, sys, urllib.request
sys.modules["aiohttp"] = None          # `import aiohttp` raises ImportError
import ray_tpu_torch
from ray_tpu_torch import serve

ray_tpu_torch.init(local_mode=True)
try:
    @serve.deployment
    def echo(body):
        return {"echo": body}

    serve.run(echo.bind(), name="echo", _http=True, route_prefix="/echo")
    req = urllib.request.Request(
        f"http://127.0.0.1:{serve.http_port()}/echo",
        data=json.dumps({"x": 1}).encode(), headers={"X-Request-Id": "r1"})
    with urllib.request.urlopen(req, timeout=60) as r:
        print(r.status, r.headers.get("X-Request-Id"), r.read().decode())
    print("aiohttp loaded:", sys.modules.get("aiohttp") is not None)
finally:
    serve.shutdown()
    ray_tpu_torch.shutdown()
"""


def test_port_proxy_serves_without_aiohttp():
    env = {k: v for k, v in os.environ.items() if k != "RAY_TPU_ADDRESS"}
    proc = subprocess.run([sys.executable, "-c", _NO_AIOHTTP], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '200 r1 {"echo": {"x": 1}}' in proc.stdout, proc.stdout
    assert "aiohttp loaded: False" in proc.stdout
