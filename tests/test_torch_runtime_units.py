"""Units of the port's multi-process runtime against the JAX package's, with
no process started.

- The wire: `PROTOCOL_VERSION`, the typed and raw codecs, the RPC frame
  header and task-spec messages whose fields are plain values (no pickled
  classes) are byte-equal between the packages, so the two runtimes speak
  one protocol (and a driver asks which runtime a head serves).
- The scheduler: seeded cluster views and demands (the placements that
  test_schedule_fuzz.py's clusters make, drawn directly) give the same
  nodes through both `pick_node`, `pick_feasible_node` and `place_bundles`.
- The syncer: the GCS side's versioned apply (full, delta, duplicate, gap,
  unknown node) and the node side's reports against a fake transport give
  the same verdicts, views and pushes.
- Runtime envs: the driver-side validation (`normalize`, `RuntimeEnv`) of
  env_vars, working_dir and py_modules specs gives the same specs, packed
  archives and errors, and `env_hash` (taken on every lease) the same keys;
  pip, conda and container specs are refused naming their ROADMAP item.
"""
import asyncio
import random

import numpy as np
import pytest

import ray_tpu.runtime_env as jenv
import ray_tpu_torch.runtime_env as tenv
from ray_tpu.core import serialization as jser
from ray_tpu.core.distributed import protocol as jproto
from ray_tpu.core.distributed import rpc as jrpc
from ray_tpu.core.distributed import scheduler as jsched
from ray_tpu.core.distributed import syncer as jsync
from ray_tpu.core.distributed import wire as jwire
from ray_tpu_torch.core import serialization as tser
from ray_tpu_torch.core.distributed import protocol as tproto
from ray_tpu_torch.core.distributed import rpc as trpc
from ray_tpu_torch.core.distributed import scheduler as tsched
from ray_tpu_torch.core.distributed import syncer as tsync
from ray_tpu_torch.core.distributed import wire as twire


def _values(seed: int) -> list:
    """Seeded plain values: what the typed codec carries."""
    rng = np.random.default_rng(seed)

    def one(depth):
        kind = int(rng.integers(9 if depth < 3 else 7))
        if kind == 0:
            return None
        if kind == 1:
            return bool(rng.integers(2))
        if kind == 2:
            return int(rng.integers(-2**62, 2**62))
        if kind == 3:
            return float(rng.standard_normal())
        if kind == 4:
            return rng.bytes(int(rng.integers(40)))
        if kind == 5:
            return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, int(rng.integers(12))))
        if kind == 6:
            return int(rng.integers(256))
        if kind == 7:
            return [one(depth + 1) for _ in range(int(rng.integers(5)))]
        return {f"k{i}": one(depth + 1) for i in range(int(rng.integers(5)))}

    return [one(0) for _ in range(40)]


def test_protocol_version_and_codecs_are_byte_equal():
    assert tproto.RUNTIME == "ray_tpu_torch"
    assert twire.PROTOCOL_VERSION == jwire.PROTOCOL_VERSION
    assert (twire.CODEC_PICKLE, twire.CODEC_TYPED, twire.CODEC_RAW) == (
        jwire.CODEC_PICKLE, jwire.CODEC_TYPED, jwire.CODEC_RAW)
    for seed in range(3):
        for value in _values(seed):
            blob = twire.typed_dumps(value)
            assert blob == jwire.typed_dumps(value)
            assert twire.typed_loads(blob) == jwire.typed_loads(blob) == value
    payload = {"oid": b"\x01" * 20, "offset": 7, "data": twire.Raw(b"x" * 4096)}
    head, body = twire.raw_dumps(payload)
    jhead, jbody = jwire.raw_dumps(
        {"oid": b"\x01" * 20, "offset": 7, "data": jwire.Raw(b"x" * 4096)})
    assert head == jhead and bytes(body) == bytes(jbody)


@pytest.mark.parametrize("codec", ["pickle", "typed"])
def test_rpc_frames_are_byte_equal(codec):
    code = {"pickle": twire.CODEC_PICKLE, "typed": twire.CODEC_TYPED}[codec]
    for i, value in enumerate(_values(7)):
        request = {"service": "NodeInfo", "method": "list_nodes",
                   "kwargs": {"value": value}}
        t_payload = trpc._ser(request, code)
        j_payload = jrpc._ser(request, code)
        assert t_payload == j_payload
        assert trpc._frame(1, i, t_payload) == jrpc._frame(1, i, j_payload)


def test_task_spec_messages_are_byte_equal():
    args = [1, 2.5, "three", [4, {"five": b"6"}], None]
    kwargs = {"k": (1, 2), "flag": True}
    t_blob, t_deps = tproto.pack_args(args, kwargs, promote=None)
    j_blob, j_deps = jproto.pack_args(args, kwargs, promote=None)
    assert t_blob == j_blob and t_deps == j_deps == []
    assert tproto.pack_args([], {}, None) == jproto.pack_args([], {}, None)
    fields = dict(task_id=b"\x07" * 24, fn_key=b"\x09" * 20, args_blob=t_blob,
                  num_returns=2, caller_address="127.0.0.1:1234", job_id="ab12",
                  options={"num_cpus": 1.0, "max_retries": 3}, seq=4, attempt=1)
    spec = tproto.make_task_spec(**fields)
    assert spec == jproto.make_task_spec(**fields)
    assert tser.dumps(spec) == jser.dumps(spec)
    assert trpc._ser(spec, twire.CODEC_PICKLE) == jrpc._ser(spec, jwire.CODEC_PICKLE)


# -- the scheduler -----------------------------------------------------------

def _view(sched, rng: np.random.Generator, n_nodes: int):
    view = sched.ClusterView()
    for i in range(n_nodes):
        total = {"CPU": float(rng.integers(1, 9)), "memory": 8e9}
        if rng.random() < 0.5:
            total["GPU"] = float(rng.integers(1, 5))
        used = {k: float(rng.integers(0, int(v) + 1)) if k != "memory" else 0.0
                for k, v in total.items()}
        view.nodes[f"n{i}"] = sched.NodeView(
            node_id=f"n{i}", address=f"virtual:n{i}", total=total,
            available={k: total[k] - used[k] for k in total},
            alive=bool(rng.random() > 0.1),
            labels={"zone": "a" if rng.random() < 0.5 else "b"},
            queued=[{"CPU": 1.0}] * int(rng.integers(3)),
            idle_workers=int(rng.integers(4)))
    return view


def _demand(rng):
    demand = {"CPU": float(rng.integers(0, 4)) or 0.5}
    if rng.random() < 0.4:
        demand["GPU"] = float(rng.choice([0.5, 1.0, 2.0]))
    return demand


def _placements(sched, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for trial in range(60):
        view = _view(sched, rng, int(rng.integers(1, 8)))
        demand = _demand(rng)
        strategy = str(rng.choice(["hybrid", "spread", "node_affinity"]))
        picked = sched.pick_node(
            view, demand, strategy=strategy,
            local_node_id=f"n{int(rng.integers(8))}",
            affinity_node_id=f"n{int(rng.integers(8))}",
            affinity_soft=bool(rng.integers(2)),
            spread_threshold=float(rng.random()),
            rng=random.Random(seed * 1000 + trial))
        feasible = sched.pick_feasible_node(view, demand,
                                            exclude=f"n{int(rng.integers(8))}")
        bundles = [_demand(rng) for _ in range(int(rng.integers(1, 5)))]
        labels = [{"zone": "a"} if rng.random() < 0.3 else None for _ in bundles]
        placed = sched.place_bundles(
            view, bundles, str(rng.choice(["PACK", "SPREAD", "STRICT_PACK",
                                           "STRICT_SPREAD"])),
            bundle_labels=labels)
        out.append((picked.node_id if picked else None,
                    feasible.node_id if feasible else None, placed))
    return out


@pytest.mark.parametrize("seed", [1, 7])
def test_seeded_placements_match_jax(seed):
    got, want = _placements(tsched, seed), _placements(jsched, seed)
    assert got == want
    assert any(p[0] for p in want) and any(p[2] for p in want)
    assert any(p[0] is None for p in want) and any(p[2] is None for p in want)


# -- the syncer --------------------------------------------------------------

def _cluster_syncer_run(gcs_server_module) -> list:
    gcs = gcs_server_module.GcsServer()
    gcs.nodes.register_node("n1", "virtual:n1", {"CPU": 4.0, "GPU": 1.0}, "")
    syn = gcs.syncer
    steps = [
        dict(version=1, base_version=0, state={"available": {"CPU": 3.0}}),
        dict(version=1, base_version=0, full=True,
             state={"available": {"CPU": 3.0}, "workers": 2}),
        dict(version=2, base_version=1, state={"available": {"CPU": 1.0}}),
        dict(version=2, base_version=1, state={"available": {"CPU": 9.0}}),
        dict(version=5, base_version=4, state={"store_used": 77}),
        dict(version=3, base_version=2, state={"idle_workers": 1,
                                               "queued": [{"CPU": 1.0}]}),
    ]
    out = []
    for kw in steps:
        out.append(syn.push_update("n1", **kw))
        n = gcs.nodes.view.nodes["n1"]
        out.append((n.available, n.workers, n.store_used, n.idle_workers, n.queued))
    out.append(syn.push_update("ghost", version=1, base_version=0, full=True,
                               state={"available": {}}))
    gcs.nodes.view.nodes["n1"].alive = False
    out.append(syn.push_update("n1", version=4, base_version=3,
                               state={"workers": 3}))
    return out


def test_cluster_syncer_verdicts_and_views_match_jax():
    from ray_tpu.core.distributed import gcs_server as jgcs
    from ray_tpu_torch.core.distributed import gcs_server as tgcs

    want = _cluster_syncer_run(jgcs)
    assert _cluster_syncer_run(tgcs) == want
    assert want[0].get("resync") and want[2]["ok"]


class _FakeGcs:
    """The GCS's Syncer service: acks every push but those `replies` names
    by call number."""

    def __init__(self, replies):
        self.calls = []
        self.replies = replies

    async def call(self, service, method, timeout=None, **kw):
        self.calls.append((service, method, kw))
        return self.replies.get(len(self.calls) - 1,
                                {"ok": True, "applied": kw.get("version")})


def _node_syncer_run(sync_module) -> list:
    async def run():
        state = {"available": {"CPU": 4.0}, "workers": 0, "store_used": 0}
        fake = _FakeGcs({2: {"ok": False, "resync": True}})
        syn = sync_module.NodeSyncer(
            gcs=fake, node_id="n1",
            collect=lambda: {k: (dict(v) if isinstance(v, dict) else v)
                             for k, v in state.items()},
            report_interval_s=0.01, keepalive_s=60.0)
        results = [await syn.sync_once()]          # first contact: full
        results.append(await syn.sync_once())      # nothing changed
        state["available"] = {"CPU": 1.0}
        results.append(await syn.sync_once())      # one key: a delta
        state["workers"] = 3
        state["store_used"] = 10
        results.append(await syn.sync_once())      # the GCS asks to resync
        results.append(await syn.sync_once())      # so a full snapshot
        state["available"] = {"CPU": 2.0}
        results.append(await syn.sync_once())
        return results, fake.calls, dict(syn.stats)

    return asyncio.run(run())


def test_node_syncer_reports_match_jax():
    got, want = _node_syncer_run(tsync), _node_syncer_run(jsync)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == want[2]
    assert want[0][0] == "full" and "suppressed" in want[0] and "delta" in want[0]


# -- runtime envs -------------------------------------------------------------

def _env_tree(root):
    """A seeded working_dir and a module file beside it."""
    rng = np.random.default_rng(5)
    wd = root / "wd"
    (wd / "pkg" / "__pycache__").mkdir(parents=True)
    (wd / "main.py").write_text("VALUE = %d\n" % int(rng.integers(1000)))
    (wd / "pkg" / "__init__.py").write_text("")
    (wd / "pkg" / "data.bin").write_bytes(rng.bytes(300))
    (wd / "pkg" / "__pycache__" / "skip.pyc").write_bytes(b"x")
    (root / "mod.py").write_text("X = 1\n")
    return str(wd), str(root / "mod.py")


ENV_SPECS = {
    "empty": lambda wd, mod: {},
    "env_vars": lambda wd, mod: {"env_vars": {"A": "1", "B": "two"}},
    "working_dir": lambda wd, mod: {"working_dir": wd},
    "py_modules": lambda wd, mod: {"py_modules": [mod, wd]},
    "all_three": lambda wd, mod: {"env_vars": {"Z": "0"}, "working_dir": wd,
                                  "py_modules": [mod]},
    "normalized_again": lambda wd, mod: {"working_dir": "pkg://" + "0" * 32},
    "unknown_field": lambda wd, mod: {"env_vars": {"A": "1"}, "nope": 1},
    "missing_dir": lambda wd, mod: {"working_dir": wd + "-missing"},
    "missing_module": lambda wd, mod: {"py_modules": [mod + ".gone"]},
    "bad_env_vars": lambda wd, mod: {"env_vars": {"A": 1}},
}


def _normalized(module, spec):
    """What `normalize` and `RuntimeEnv` make of a spec: the spec, the
    archives put in the KV, its hash, or the error (type and message)."""
    kv = {}
    out = {}
    try:
        norm = module.normalize(spec, lambda ns, k, v: kv.__setitem__((ns, k), v))
        out["normalize"] = (norm, sorted(kv.items()), module.env_hash(norm))
    except Exception as e:  # noqa: BLE001 the error is the result
        out["normalize"] = (type(e).__name__, str(e))
    try:
        env = module.RuntimeEnv(**spec)
        out["RuntimeEnv"] = (dict(env), module.env_hash(dict(env)))
    except Exception as e:  # noqa: BLE001
        out["RuntimeEnv"] = (type(e).__name__, str(e))
    return out


@pytest.mark.parametrize("name", list(ENV_SPECS))
def test_runtime_env_validation_and_hash_match_jax(tmp_path, name):
    wd, mod = _env_tree(tmp_path)
    spec = ENV_SPECS[name](wd, mod)
    got, want = _normalized(tenv, spec), _normalized(jenv, spec)
    assert got == want
    if name == "working_dir":
        # The archive is content-addressed: the same tree gives the same
        # URI, and __pycache__ stays out of it.
        norm, kv, _ = got["normalize"]
        assert norm["working_dir"].startswith("pkg://")
        assert b"skip.pyc" not in kv[0][1]


@pytest.mark.parametrize("field,value", [
    ("pip", ["numpy"]), ("conda", "base"), ("container", {"image": "x"}),
    ("conda", {"name": "e", "dependencies": ["python"]}),
    ("container", {"image": "x", "run_options": ["--ipc=host"]})])
def test_unported_runtime_env_fields_name_their_item(tmp_path, field, value):
    """pip, conda and container envs are ported: a spec normalizes and
    validates as JAX's does (their builds: tests/test_torch_runtime_envs.py).
    No field is left unported: tpu_profiling normalizes as JAX's too (its
    cases: test_profiling_env_matches_jax)."""
    assert (tenv.normalize({field: value}, lambda *a: None)
            == jenv.normalize({field: value}, lambda *a: None))
    assert tenv.RuntimeEnv(**{field: value}) == jenv.RuntimeEnv(**{field: value})
    for env in (tenv, jenv):
        with pytest.raises(ValueError, match="conda"):
            env.normalize({"pip": ["x"], "conda": "envname"}, lambda *a: None)
        with pytest.raises(ValueError, match="container"):
            env.normalize({"container": {"run_options": []}}, lambda *a: None)
    spec = {field: value, "tpu_profiling": {"jax_trace_dir": "x"}}
    if field == "conda":
        assert (tenv.normalize(spec, lambda *a: None)
                == jenv.normalize(spec, lambda *a: None))
    assert tenv.RuntimeEnv(**spec) == jenv.RuntimeEnv(**spec)


PROFILING_SPECS = {
    "trace_dir": {"jax_trace_dir": "/t"},
    "dump": {"xla_dump_to": "/d"},
    "all": {"xla_dump_to": "/d", "jax_trace_dir": "/t", "log_compiles": True},
    "falsy": {"xla_dump_to": "", "log_compiles": False},
}


@pytest.mark.parametrize("name", list(PROFILING_SPECS))
def test_profiling_env_matches_jax(name):
    """The tpu_profiling plugin: the same worker variables as JAX's, the
    same normalized spec and hash."""
    spec = PROFILING_SPECS[name]
    assert tenv.profiling_env_vars(spec) == jenv.profiling_env_vars(spec)
    env = {"tpu_profiling": spec, "env_vars": {"A": "1"}}
    assert (tenv.normalize(env, lambda *a: None)
            == jenv.normalize(env, lambda *a: None))
    assert tenv.env_hash(tenv.normalize(env, lambda *a: None)) == jenv.env_hash(
        jenv.normalize(env, lambda *a: None))
    assert tenv.RuntimeEnv(**env) == jenv.RuntimeEnv(**env)


@pytest.mark.parametrize("spec", [{"nsys": True}, {"jax_trace_dir": "/t", "ncu": 1},
                                  "not-a-dict"])
def test_profiling_env_rejects_what_jax_rejects(spec):
    errors = []
    for env in (tenv, jenv):
        with pytest.raises(ValueError) as e:
            env.normalize({"tpu_profiling": spec}, lambda *a: None)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("inherited,own,want", [
    (None, None, "--xla_dump_to=/d"),
    ("--xla_cpu_x=1", None, "--xla_cpu_x=1 --xla_dump_to=/d"),
    ("--xla_cpu_x=1", "--user=1", "--user=1 --xla_dump_to=/d")])
def test_profiling_xla_flags_are_appended_as_jax(tmp_path, monkeypatch, inherited, own,
                                                 want):
    """The agent appends the plugin's dump flag to the env's own XLA_FLAGS,
    else to the node's, as JAX's agent does (torch reads none of them)."""
    import asyncio

    from ray_tpu.core.distributed import runtime_env_agent as jagent
    from ray_tpu_torch.core.distributed import runtime_env_agent as tagent

    if inherited:
        monkeypatch.setenv("XLA_FLAGS", inherited)
    else:
        monkeypatch.delenv("XLA_FLAGS", raising=False)
    env = {"env_vars": {"XLA_FLAGS": own} if own else {"B": "2"},
           "tpu_profiling": {"xla_dump_to": "/d", "jax_trace_dir": "/t"}}
    built = []
    for mod, sub in ((tagent, "t"), (jagent, "j")):
        builder = mod.RuntimeEnvBuilder(None, str(tmp_path / sub))
        built.append(asyncio.run(builder._build("k", env)).env_vars)
    assert built[0] == built[1]
    assert built[0]["XLA_FLAGS"] == want
    assert built[0]["RAY_TPU_JAX_TRACE_DIR"] == "/t"
