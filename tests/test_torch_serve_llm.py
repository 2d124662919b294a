"""`LLMDeployment` of ray_tpu_torch against ray_tpu's, served on the CPU.

Each runtime starts one single-host cluster for this file
(`init(num_cpus=4)`), never both at once, and ends with `serve.shutdown()`
and `shutdown()` in `finally`. Both deploy TINY at fp32 compute with the
same weights (JAX's `init_params` from a seed, carried to the port by
`jax_bridge`, handed to each replica through `params_loader`); JAX's run
records what it got and the port's is held to the record:

- greedy tokens, unary through the handle, streamed through the handle and
  streamed over HTTP as JSONL;
- the serve metric names and label sets the cluster's federated metrics
  show after the same requests;
- the store arena's bytes; the port's store is back at its baseline after
  the deployment goes (the JAX replica exits without stopping its engine
  and leaves the arena in the store).

Held within the port (`PORT_ONLY`): a replica killed mid-stream, whose
stream resumes once on the survivor with the unbroken stream's tokens;
and disaggregated prefill, where a `disagg=True` deployment offloads a
long prompt's prefill and gives the tokens of the unified deployment built
from the same seed (prefill actors draw their weights from the seed, so
disagg is held port against port, as JAX's tests hold JAX's).
"""
import dataclasses
import importlib
import json
import os
import re
import signal
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import configs as jax_configs
from ray_tpu.models import init_params as jax_init
from ray_tpu_torch.models import configs
from ray_tpu_torch.models.jax_bridge import params_from_jax

RECORD = {}   # scenario -> what the JAX package's cluster gave
# Runs only in the port's cluster (the module's second half).
PORT_ONLY = pytest.mark.parametrize("cluster", [ray_tpu_torch],
                                    ids=["ray_tpu_torch"], indirect=True)
PROMPTS = [list(range(1, 40)), list(range(5, 75)), [7, 8, 9] * 6]
DISAGG_PROMPT = list(range(3, 83))       # past the 64-token offload bar


def _models():
    jcfg = dataclasses.replace(jax_configs.get("tiny"),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get("tiny"),
                               compute_dtype=torch.float32)
    jp = jax.tree.map(np.asarray, jax_init(jax.random.key(0), jcfg))
    return jcfg, jp, tcfg, params_from_jax(jp, tcfg, device="cpu")


def _jax_deployment():
    """JAX's LLMDeployment whose engine reads a private copy of every host
    array it hands the device (as `tests/test_torch_serve.py`'s `engines`
    fixture makes it), so the reference engine is deterministic on the
    CPU backend."""
    from ray_tpu.serve.llm import LLMDeployment

    class DeterministicLLMDeployment(LLMDeployment):
        def __init__(self, *args, **kwargs):
            import jax.numpy as jnp
            import numpy as np

            asarray = jnp.asarray
            jnp.asarray = lambda a, *r, **kw: asarray(
                np.array(a) if isinstance(a, np.ndarray) else a, *r, **kw)
            super().__init__(*args, **kwargs)

    return DeterministicLLMDeployment


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
    jcfg, jp, tcfg, tp = _models()
    if rt is ray_tpu:
        cls, cfg, params, kw = _jax_deployment(), jcfg, jp, {}
    else:
        from ray_tpu_torch.serve import LLMDeployment

        cls, cfg, params, kw = LLMDeployment, tcfg, tp, {"device": "cpu"}
    try:
        rt.init(num_cpus=4)
        deployment = serve.deployment(cls).bind(
            cfg, num_slots=4, max_len=128, params_loader=lambda: params,
            **kw)
        serve.run(deployment, name="llm", _http=True, route_prefix="/llm")
        yield SimpleCluster(rt, serve, cls, cfg, kw)
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
            if address is not None:
                os.environ["RAY_TPU_ADDRESS"] = address


@dataclasses.dataclass
class SimpleCluster:
    rt: object
    serve: object
    cls: type
    cfg: object
    kw: dict


def _agree(name: str, rt, got):
    if rt is ray_tpu:
        RECORD[name] = got
    elif name in RECORD:
        assert got == RECORD[name], (name, got, RECORD[name])
    return got


def _wait_for(fn, timeout=30.0, every=0.3):
    deadline = time.time() + timeout
    while True:
        got = fn()
        if got or time.time() > deadline:
            return got
        time.sleep(every)


def _http_stream(port, body, rid):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/llm?stream=1&method=stream",
        data=json.dumps(body).encode(), headers={"X-Request-Id": rid})
    with urllib.request.urlopen(req, timeout=120) as r:
        return (r.status, r.headers.get("X-Request-Id"),
                [json.loads(line) for line in r.read().splitlines()])


def test_greedy_tokens_unary_streamed_and_http(cluster):
    rt, serve = cluster.rt, cluster.serve
    h = serve.get_app_handle("llm")
    out = []
    for i, prompt in enumerate(PROMPTS):
        body = {"tokens": prompt, "max_tokens": 8}
        unary = h.remote(body).result(timeout=120)["tokens"]
        resp = h.options(method_name="stream").remote_streaming(body)
        streamed = [item["token"] for item in resp]
        status, rid, lines = _http_stream(serve.http_port(), body, f"r{i}")
        assert unary == streamed == [item["token"] for item in lines]
        out.append((unary, resp.rails_used, status, rid, lines))
    _agree("greedy", rt, out)


_LINE = re.compile(r"^(raytpu_serve_\w+?)(_bucket|_sum|_count)?\{(.*)\} ")
_KEEP = ("app", "phase", "event", "state", "status", "gauge")


def _serve_series(rt):
    """{metric name: sorted label keys and the values of the labels that
    name what is counted} of the cluster's federated serve metrics."""
    text = rt.api._global_worker().gcs.call("Metrics", "federated_text",
                                            timeout=30)
    out = set()
    for line in text.splitlines():
        m = _LINE.match(line)
        if not m:
            continue
        labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(3)))
        labels.pop("le", None)
        labels.pop("node", None)
        # Other apps' series (llm2's killed replica) linger until the
        # daemon's TTL; a handle counts remote_prefix_hit/miss only once
        # its routing holds the replicas' prefix registry, which arrives
        # on the gauge push's clock.
        if (labels.get("app", "llm") != "llm"
                or labels.get("event", "").startswith("remote_prefix")):
            continue
        out.add((m.group(1), tuple(sorted(labels)),
                 tuple(sorted((k, v) for k, v in labels.items()
                              if k in _KEEP))))
    return out


def test_serve_metric_names_and_labels(cluster):
    rt = cluster.rt
    want = {"raytpu_serve_ttft_seconds", "raytpu_serve_itl_seconds",
            "raytpu_serve_tokens_total", "raytpu_serve_kv_events_total",
            "raytpu_serve_requests_total", "raytpu_serve_tokens_per_s"}
    state = {"last": None}

    def settled():
        now = _serve_series(rt)
        names = {name for name, _k, _v in now}
        done = want <= names and now == state["last"]
        state["last"] = now
        return done

    assert _wait_for(settled, timeout=40, every=1.5), sorted(
        {name for name, _k, _v in state["last"] or ()})
    got = sorted(state["last"])
    if rt is ray_tpu_torch and "metrics" in RECORD:
        ref = set(RECORD["metrics"])
        assert set(got) == ref, (sorted(set(got) - ref), sorted(ref - set(got)))
    _agree("metrics", rt, got)


def test_request_digests_match_jax(cluster):
    disagg = importlib.import_module(f"{cluster.rt.__name__}.serve.disagg")
    _agree("digests", cluster.rt, [disagg.request_digests(p, 16)
                                   for p in PROMPTS + [DISAGG_PROMPT]])


def test_arena_in_store_and_back_at_baseline(cluster):
    """The deployment's pool is one object of `arena_bytes` in the node's
    store; once the deployment goes, the store is back where it was
    without it (a SIGKILLed replica's arena, which no process is left to
    give back, may be there already: `PORT_ONLY` runs first)."""
    rt, serve = cluster.rt, cluster.serve
    store = rt.api._global_worker().store
    h = serve.get_app_handle("llm")
    stats = h.options(method_name="stats").remote().result(timeout=60)
    held = (store.used, store.num_objects)
    assert stats["arena_bytes"] > 0 and held[0] >= stats["arena_bytes"]
    serve.delete("llm")
    if rt is ray_tpu_torch:     # the JAX replica leaves its arena behind
        want = (held[0] - stats["arena_bytes"], held[1] - 1)
        assert _wait_for(lambda: (store.used, store.num_objects) == want,
                         timeout=30), ((store.used, store.num_objects), want)
    _agree("arena", rt, stats["arena_bytes"])


@PORT_ONLY
def test_replica_killed_midstream_resumes_once(cluster):
    """Two replicas; the stream's replica is SIGKILLed after its first
    batch reached the caller. RPC pulls (rails off in this caller) carry
    at most 32 tokens a batch, so 48 tokens need a second pull, which the
    kill breaks: the handle resumes on the survivor with the 32 tokens it
    holds, and the survivor recomputes their KV and goes on."""
    rt, serve = cluster.rt, cluster.serve
    cfg_mod = importlib.import_module(f"{rt.__name__}.core.config")
    body = {"tokens": PROMPTS[1], "max_tokens": 48}
    serve.run(serve.deployment(cluster.cls, num_replicas=2).bind(
        cluster.cfg, num_slots=4, max_len=128, seed=0, **cluster.kw),
        name="llm2")
    h = serve.get_app_handle("llm2")
    try:
        whole = h.remote(body).result(timeout=120)["tokens"]
        knobs = cfg_mod.get_config()
        rails, knobs.serve_rails_enabled = knobs.serve_rails_enabled, False
        try:
            resp = h.options(method_name="stream").remote_streaming(body)
            got = []
            for item in resp:
                got.append(item["token"])
                if len(got) == 1:
                    pid = rt.get(resp._replica.getpid.remote(), timeout=30)
                    os.kill(pid, signal.SIGKILL)
        finally:
            knobs.serve_rails_enabled = rails
        assert got == whole and len(got) == 48
        assert resp.resumes == 1 and not resp.rails_used
    finally:
        serve.delete("llm2")


@PORT_ONLY
def test_disagg_offloads_and_gives_the_unified_tokens(cluster):
    rt, serve = cluster.rt, cluster.serve
    body = {"tokens": DISAGG_PROMPT, "max_tokens": 8}
    out = {}
    for name, disagg in (("unified", False), ("disagg", True)):
        serve.run(serve.deployment(cluster.cls).bind(
            cluster.cfg, num_slots=4, max_len=128, seed=0, disagg=disagg,
            **cluster.kw), name=name)
        h = serve.get_app_handle(name)
        out[name] = h.remote(body).result(timeout=300)["tokens"]
        stats = h.options(method_name="stats").remote().result(timeout=60)
        out[f"{name}_offloaded"] = stats["disagg_prefills"]
        serve.delete(name)
    assert out["disagg"] == out["unified"]
    assert out["disagg_offloaded"] == 1 and out["unified_offloaded"] == 0
