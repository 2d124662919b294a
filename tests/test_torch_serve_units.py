"""Pieces of ray_tpu_torch's serve plane against ray_tpu's, with no cluster.

Each case runs the same inputs through both packages and holds the port to
what JAX's module gives: `@serve.batch`, `@serve.multiplexed`, deployment
options and the declarative config (with `serve.run` recorded instead of
run), the shared-memory channel ring (written by one package, read back
frame for frame by the other on the same file), the serve trace helpers,
usage stats, the serve metric set and its dump merge, the daemon's serve
gauge view and the GCS's merged one, request digests, and the proxy's
HTTP/1.1 request parser.
"""
import asyncio
import dataclasses
import importlib
import json
import os
import threading
import time
from types import SimpleNamespace

import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _both(fn):
    """fn(pkg) for each package; the port's result must equal JAX's."""
    ref, port = (fn(pkg) for pkg in PACKAGES)
    assert port == ref, (port, ref)
    return ref


# -- batching -----------------------------------------------------------------

def test_batch_results_and_sizes_match():
    def run(pkg):
        serve = _mod(pkg, "serve")
        sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.5)
        def double(items):
            sizes.append(len(items))
            return [x * 2 for x in items]

        out = [None] * 8
        barrier = threading.Barrier(8)

        def call(i):
            barrier.wait()
            out[i] = double(i)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        return out, sizes

    (ref, ref_sizes), (port, sizes) = (run(pkg) for pkg in PACKAGES)
    assert port == ref == [i * 2 for i in range(8)]
    assert sum(ref_sizes) == sum(sizes) == 8 and len(sizes) > 1
    # JAX's batches can exceed max_batch_size (the test below); the
    # port's never do.
    assert max(sizes) <= 4, sizes


def test_batch_never_exceeds_max_batch_size():
    """Callers that join a full queue before its flush takes it: JAX's
    flush takes them all, one batch of 8 at max_batch_size 4 (ROADMAP C);
    the port's takes 4 and leaves the rest to the next."""
    def run(pkg):
        batching = _mod(pkg, "serve.batching")
        sizes = []

        def double(items):
            sizes.append(len(items))
            return [x * 2 for x in items]

        q = batching._BatchQueue(double, 4, 30.0)
        gate, flush = threading.Event(), q._flush

        def gated():    # the first full flush waits until all 8 queued
            gate.wait(30)
            flush()

        q._flush = gated
        out = [None] * 8
        threads = []
        for i in range(8):
            def call(i=i):
                out[i] = q.submit(i)

            threads.append(threading.Thread(target=call))
            threads[-1].start()
            deadline = time.monotonic() + 30
            while len(q._queue) < i + 1 and time.monotonic() < deadline:
                time.sleep(0.001)
        gate.set()
        for t in threads:
            t.join(timeout=30)
        return out, sorted(sizes)

    (ref, ref_sizes), (port, sizes) = (run(pkg) for pkg in PACKAGES)
    assert port == ref == [i * 2 for i in range(8)]
    assert ref_sizes == [8]
    assert sizes == [4, 4]


def test_batch_method_and_error_match():
    def run(pkg):
        serve = _mod(pkg, "serve")

        class Model:
            def __init__(self):
                self.calls = 0

            @serve.batch(max_batch_size=1)
            def __call__(self, items):
                self.calls += 1
                return [x + 1 for x in items]

            @serve.batch(max_batch_size=1)
            def broken(self, items):
                return []

        m = Model()
        out = [m(1), m(2), m.calls]
        with pytest.raises(ValueError) as ei:
            m.broken(3)
        return out, type(ei.value).__name__, str(ei.value)

    _both(run)


# -- multiplexing -------------------------------------------------------------

def test_multiplexed_lru_and_unload_match():
    def run(pkg):
        serve = _mod(pkg, "serve")
        mux = _mod(pkg, "serve.multiplex")
        log = []

        class M:
            def __init__(self, mid):
                self.mid = mid

            def unload(self):
                log.append(("unload", self.mid))

        class Host:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get(self, model_id):
                log.append(("load", model_id))
                return M(model_id)

        h = Host()
        for mid in ["a", "b", "a", "c", "b", "a"]:
            h.get(mid)
        token = mux._model_id_ctx.set("m7")
        try:
            inside = serve.get_multiplexed_model_id()
        finally:
            mux._model_id_ctx.reset(token)
        return log, inside, serve.get_multiplexed_model_id()

    log, inside, outside = _both(run)
    assert inside == "m7" and outside == ""
    assert log[:3] == [("load", "a"), ("load", "b"), ("load", "c")]


# -- deployment options and the declarative config ----------------------------

def _deployment_view(app):
    dep = app.deployment
    return (dep.name, dataclasses.asdict(dep.config), app.init_args,
            app.init_kwargs)


def test_deployment_options_match():
    def run(pkg):
        serve = _mod(pkg, "serve")

        class Model:
            pass

        base = serve.deployment(Model, num_replicas=2,
                                ray_actor_options={"num_cpus": 1})
        scaled = base.options(
            name="m2", max_ongoing_requests=4,
            autoscaling_config={"min_replicas": 1, "max_replicas": 3})
        auto = serve.deployment(num_replicas="auto", autoscaling_config={
            "min_replicas": 2})(Model)
        return [_deployment_view(d.bind(1, k=2))
                for d in (base, scaled, auto)]

    views = _both(run)
    assert views[1][1]["autoscaling_config"]["max_replicas"] == 3
    assert views[2][1]["num_replicas"] == 2


_CONFIG_MODULE = '''
class Upper:
    def __init__(self, suffix="!"):
        self.suffix = suffix

def build(suffix="?"):
    from {pkg} import serve
    return serve.deployment(Upper, name="built").bind(suffix)
'''


def test_config_deploy_resolves_the_same_apps(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(str(tmp_path))

    def run(pkg):
        serve = _mod(pkg, "serve")
        mod = f"cfg_units_{pkg}"
        (tmp_path / f"{mod}.py").write_text(_CONFIG_MODULE.format(pkg=pkg))
        runs = []
        monkeypatch.setattr(serve, "run", lambda app, **kw: runs.append(
            (_deployment_view(app), kw)) or kw["name"])
        cfg = {"applications": [
            {"name": "cls", "import_path": f"{mod}.Upper",
             "args": {"suffix": "!!"}, "route_prefix": "/up",
             "deployment_config": {"num_replicas": 2,
                                   "max_ongoing_requests": 3}},
            {"name": "built", "import_path": f"{mod}:build",
             "args": {"suffix": "??"},
             "deployment_config": {"num_replicas": 3}},
        ]}
        path = tmp_path / f"{pkg}.json"
        path.write_text(json.dumps(cfg))
        handles = serve.deploy_config(str(path))
        with pytest.raises(ValueError) as ei:
            serve.deploy_config({"applications": []})
        return runs, handles, str(ei.value)

    runs, handles, err = _both(run)
    assert handles == {"cls": "cls", "built": "built"}
    assert runs[0][1] == {"name": "cls", "route_prefix": "/up", "_http": True}


# -- the shared-memory channel ring ------------------------------------------

@pytest.mark.parametrize("writer,reader", [PACKAGES, PACKAGES[::-1]],
                         ids=["jax_writes", "port_writes"])
def test_channel_ring_crosses_packages(tmp_path, writer, reader):
    w_ch = _mod(writer, "experimental.channel")
    r_ch = _mod(reader, "experimental.channel")
    ring = w_ch.Channel.create(1, capacity=4096, n_slots=4,
                               directory=str(tmp_path))
    try:
        frames = [{"o": i, "items": [i, i + 1], "done": i == 9}
                  for i in range(10)]
        peer = r_ch.Channel(ring.path, ring.capacity, ring.n_readers,
                            ring.n_slots)
        got = []

        def read_all():
            for _ in frames:
                got.append(peer.read(timeout=30))

        t = threading.Thread(target=read_all)
        t.start()
        for f in frames:          # 10 frames through 4 slots: backpressure
            ring.write(f, timeout=30)
        t.join(timeout=60)
        assert got == frames
        assert peer.version() == ring.version() == 10
        with pytest.raises(ValueError) as ei:
            ring.write_bytes(b"x" * 5000)
        assert "exceeds channel slot capacity" in str(ei.value)
        ring.close()
        with pytest.raises(r_ch.ChannelClosedError):
            peer.read(timeout=5)
        with pytest.raises(r_ch.ChannelTimeoutError):
            r_ch.Channel.create(1, capacity=64, directory=str(tmp_path)).read(
                timeout=0.05)
    finally:
        ring.unlink()


# -- serve trace helpers ------------------------------------------------------

def _spans(tracing, *trace_ids):
    return [r for r in tracing.drain() if r["trace_id"] in trace_ids]


def test_serve_ctx_and_spans_match():
    def run(pkg):
        tracing = _mod(pkg, "util.tracing")
        tracing.drain()
        ctx = tracing.serve_ctx("rid-u1")
        resumed = tracing.serve_ctx("rid-u2", "p0", resumed=1)
        with tracing.serve_span(ctx, "serve.test.root", k=1) as s:
            child = tracing.child_ctx(ctx, s)
        with tracing.serve_span(child, "serve.test.child") as c:
            pass
        with tracing.serve_span(None, "serve.test.none") as none:
            pass
        tracing.record_serve_span(resumed, "serve.test.recorded", 100.0,
                                  101.5, items=3)
        recs = _spans(tracing, "rid-u1", "rid-u2")
        ids = {s.span_id: "root", c.span_id: "child", None: None, "p0": "p0"}
        view = sorted((r["name"], ids.get(r["parent_id"], "?"), r["attrs"],
                       r["kind"]) for r in recs)
        rec = [r for r in recs if r["name"] == "serve.test.recorded"][0]
        return (ctx, resumed, {k: v for k, v in child.items()
                               if k != "span_id"},
                child["span_id"] == s.span_id, none, view,
                (rec["start_ts"], rec["end_ts"]))

    ctx, resumed, *_ = _both(run)
    assert ctx == {"trace_id": "rid-u1", "span_id": None}
    assert resumed == {"trace_id": "rid-u2", "span_id": "p0", "resumed": 1}


def test_serve_trace_kill_switch_matches(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SERVE_TRACE_ENABLED", "0")

    def run(pkg):
        cfg = _mod(pkg, "core.config")
        tracing = _mod(pkg, "util.tracing")
        cfg.reset_config()
        try:
            with tracing.serve_span({"trace_id": "rid-off"}, "x") as s:
                pass
            tracing.record_serve_span({"trace_id": "rid-off"}, "y", 1.0)
            return (tracing.serve_enabled(), tracing.serve_ctx("rid-off"), s,
                    _spans(tracing, "rid-off"))
        finally:
            monkeypatch.delenv("RAY_TPU_SERVE_TRACE_ENABLED")
            cfg.reset_config()
            monkeypatch.setenv("RAY_TPU_SERVE_TRACE_ENABLED", "0")

    assert _both(run) == (False, None, None, [])


# -- usage stats --------------------------------------------------------------

def test_record_library_usage_matches(tmp_path):
    def run(pkg):
        usage = _mod(pkg, "util.usage_stats")
        usage.record_library_usage("serve")
        usage.record_library_usage("units-test")
        usage.record_extra_usage_tag("slice", 14)
        snap = usage.collect_usage_snapshot()
        path = usage.write_usage_snapshot(str(tmp_path / pkg / "usage.json"))
        written = json.loads(open(path).read())
        keys = sorted(set(snap) - {"ray_tpu_version", "uptime_s"})
        # The process-wide record also holds what other tests imported.
        ours = {"serve", "units-test"}
        return (ours & set(usage.get_library_usages()),
                snap["extra_tags"]["slice"], ours & set(snap["libraries_used"]),
                keys, usage.usage_stats_enabled(),
                ours & set(written["libraries_used"]), os.listdir(tmp_path / pkg))

    libs, tag, *_ = _both(run)
    assert libs == {"serve", "units-test"} and tag == "14"


# -- serve metrics ------------------------------------------------------------

def test_serve_metric_set_matches():
    def run(pkg):
        obs = _mod(pkg, "serve.observability")
        return sorted((key, type(m).__name__, m.name, tuple(m.tag_keys),
                       tuple(getattr(m, "boundaries", ())))
                      for key, m in obs.metrics().items())

    assert len(_both(run)) == 13


def test_mirror_engine_matches():
    """The engine mirror folds the same cumulative stats into the same
    counters and gauges (by delta, not by total)."""
    stats = [{"tokens_generated": 5, "requests": 2, "completed": 1,
              "reuse_hits": 1, "prefill_chunks": 2, "disagg_prefills": 1,
              "blocks_total": 8, "blocks_free": 5, "blocks_cached": 1,
              "blocks_active": 2, "occupancy": 0.25},
             {"tokens_generated": 9, "requests": 3, "completed": 3,
              "reuse_hits": 1, "prefill_chunks": 5, "disagg_prefills": 2,
              "blocks_total": 8, "blocks_free": 8, "blocks_cached": 0,
              "blocks_active": 0, "occupancy": 0.0}]

    def run(pkg):
        obs = _mod(pkg, "serve.observability")
        metrics = _mod(pkg, "util.metrics")
        app = f"units-{pkg}"
        eng = SimpleNamespace(engine_stats=lambda: dict(stats[eng.i]), i=0)
        obs.mirror_engine(eng, app)
        eng.i = 1
        obs.mirror_engine(eng, app)
        out = []
        for rec in metrics.registry_dump():
            if not rec["name"].startswith("raytpu_serve_"):
                continue
            for key, value in rec.get("samples", []):
                tags = dict(map(tuple, key))
                if tags.get("app") != app or rec["name"].endswith("per_s"):
                    continue
                tags.pop("eng", None)
                tags["app"] = "-"
                out.append((rec["name"], sorted(tags.items()), value))
        return sorted(out)

    got = _both(run)
    assert ("raytpu_serve_tokens_total", [("app", "-")], 9.0) in got
    assert ("raytpu_serve_kv_events_total",
            [("app", "-"), ("event", "disagg_prefill")], 2.0) in got


def test_merge_dump_lists_matches():
    def run(pkg):
        metrics = _mod(pkg, "util.metrics")
        a = [{"name": "c", "kind": "counter", "description": "",
              "samples": [[[["app", "x"]], 2.0]]},
             {"name": "h", "kind": "histogram", "description": "",
              "boundaries": [1.0], "hist": [[[["app", "x"]], [1, 0], 0.5, 1]]},
             {"name": "g", "kind": "gauge", "description": "",
              "samples": [[[["app", "x"]], 1.0]]}]
        b = [{"name": "c", "kind": "counter", "description": "",
              "samples": [[[["app", "x"]], 3.0], [[["app", "y"]], 1.0]]},
             {"name": "h", "kind": "histogram", "description": "",
              "boundaries": [1.0], "hist": [[[["app", "x"]], [0, 1], 2.0, 1]]},
             {"name": "g", "kind": "gauge", "description": "",
              "samples": [[[["app", "x"]], 7.0]]}]
        return metrics.merge_dump_lists([a, b])

    merged = {r["name"]: r for r in _both(run)}
    assert merged["c"]["samples"][0][1] == 5.0
    assert merged["g"]["samples"][0][1] == 7.0


# -- the daemon's serve gauge view and the GCS's merged one ------------------

def test_daemon_serve_state_and_gcs_merge_match():
    def run(pkg):
        nd = _mod(pkg, "core.distributed.node_daemon")
        gs = _mod(pkg, "core.distributed.gcs_server")
        daemon = nd.NodeDaemon.__new__(nd.NodeDaemon)
        daemon._serve_gauges = {}
        daemon._worker_metric_dumps = {}
        daemon.syncer = None
        removed = []
        daemon._m_serve_gauge = SimpleNamespace(
            set=lambda *a: None, remove=lambda tags: removed.append(tags))
        loop = asyncio.new_event_loop()
        try:
            for app, rep, g, st in [
                    ("a", "r1", {"ongoing": 1, "queue_depth": 2},
                     {"role": "decode", "prefixes": ["d1"]}),
                    ("a", "r2", {"ongoing": 3, "queue_depth": 0.5}, None),
                    ("b", "r3", {"ongoing": 1, "bad": "x"}, None)]:
                loop.run_until_complete(daemon.report_serve_gauges(
                    app=app, replica=rep, gauges=g, state=st))
            loop.run_until_complete(daemon.report_metrics(
                origin="proxy:1", dump=[]))
        finally:
            loop.close()
        # r3 stopped pushing long ago: the TTL sweep drops it.
        daemon._serve_gauges[("b", "r3")]["ts"] -= 3600
        state = daemon._serve_state()
        node = SimpleNamespace(serve=state)
        gcs = SimpleNamespace(
            nodes=SimpleNamespace(view=SimpleNamespace(
                alive_nodes=lambda: [node, node])),
            metrics=SimpleNamespace(_node_dumps={}))
        merged = gs.ServeGauges(gcs).merged()
        return state, merged, removed, sorted(daemon._worker_metric_dumps)

    state, merged, removed, origins = _both(run)
    assert state["a"]["replicas"] == 2.0 and "b" not in state
    assert merged["a"]["queue_depth"] == 5.0
    assert merged["a"]["_replicas"]["r1"]["role"] == "decode"


# -- request digests ----------------------------------------------------------

def test_request_digests_match():
    toks = list(range(7, 80))

    def run(pkg):
        disagg = _mod(pkg, "serve.disagg")
        return [disagg.request_digests(toks, bs, max_bounds=mb)
                for bs in (4, 16) for mb in (1, 8)]

    got = _both(run)
    assert got[1][0][0] == 72 and len(got[1]) == 8


# -- the proxy's HTTP/1.1 parser ----------------------------------------------

def _parse(raw: bytes):
    from ray_tpu_torch.serve import http_proxy

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        out = []
        while True:
            try:
                req = await http_proxy._read_request(reader)
            except http_proxy._BadRequest as e:
                out.append(("bad", e.status))
                break
            if req is None:
                break
            out.append((req.method, req.path, req.query,
                        req.headers.get("X-Request-Id"), req.body,
                        req.keep_alive))
        return out

    return asyncio.run(go())


def test_proxy_parses_requests():
    body = b'{"x": 1}'
    got = _parse(
        b"POST /llm%2Fa?stream=1&method=stream&stream=0 HTTP/1.1\r\n"
        b"X-Request-Id: r1\r\nContent-Length: 8\r\n\r\n" + body +
        b"POST /c HTTP/1.1\r\nTransfer-Encoding: chunked\r\n"
        b"Connection: close\r\n\r\n4\r\n{\"a\"\r\n3\r\n: 1\r\n1\r\n}\r\n0\r\n\r\n"
        b"GET / HTTP/1.0\r\n\r\n")
    assert got == [
        ("POST", "/llm/a", {"stream": "1", "method": "stream"}, "r1", body,
         True),
        ("POST", "/c", {}, None, b'{"a": 1}', False),
        ("GET", "/", {}, None, b"", False)]
    assert _parse(b"NONSENSE\r\n\r\n") == [("bad", 400)]
    assert _parse(b"POST / HTTP/1.1\r\nContent-Length: 2000000\r\n\r\n") == [
        ("bad", 413)]


def test_proxy_answers_expect_continue():
    """A client that waits for `100 Continue` before its body (curl past
    1 KiB) is told to go on, as aiohttp tells it."""
    from ray_tpu_torch.serve import http_proxy

    class Writer:
        out = b""

        def write(self, data):
            Writer.out += data

        async def drain(self):
            pass

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(b"POST /x HTTP/1.1\r\nExpect: 100-continue\r\n"
                         b"Content-Length: 2\r\n\r\n{}")
        reader.feed_eof()
        req = await http_proxy._read_request(reader, Writer())
        return Writer.out, req.body

    assert asyncio.run(go()) == (b"HTTP/1.1 100 Continue\r\n\r\n", b"{}")
