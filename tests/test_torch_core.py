"""The task/actor core of ray_tpu_torch against ray_tpu's, on the CPU.

Each scenario is one program, run through `ray_tpu` and through
`ray_tpu_torch`, each in local mode (`init(local_mode=True)`), and must give
the same result: values, the order of actor calls, error type names and
messages (ids, pids and file paths masked), timeouts and `wait` splits. The
scenarios are those of tests/test_core_api_local.py and
tests/test_streaming_local.py, then placement groups, ActorPool and Queue.
Around them: every exception class pickles as JAX's does, `TaskOptions`
asks for "GPU" where JAX asks for "TPU", `resources.py`'s set math and
detection (probe stubbed) match JAX's under the override knobs, a tensor
comes back from the store as it went in, a task runs under its caller's
grad and inference mode, `register_cross_lang` and `.bind()` work as
JAX's do, and `init()` starts a multi-process cluster that an address joins.

Every run shuts its runtime down in `finally`, and a runtime left up by an
earlier test file is shut down first: a leaked `init` poisons the xdist
worker for the files after it.
"""
import asyncio
import importlib
import pickle
import re
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import exceptions as jexc
from ray_tpu.core import ids as jids
from ray_tpu.core import serialization as jser
from ray_tpu.core.distributed import resources as jres
from ray_tpu.core.task_spec import TaskOptions as JaxTaskOptions
from ray_tpu_torch import exceptions as texc
from ray_tpu_torch.core import ids as tids
from ray_tpu_torch.core.config import reset_config
from ray_tpu_torch.core import serialization as tser
from ray_tpu_torch.core.distributed import accelerators as tacc
from ray_tpu_torch.core.distributed import resources as tres
from ray_tpu_torch.core.task_spec import TaskOptions

RUNTIMES = (ray_tpu, ray_tpu_torch)


def _mask(text: str) -> str:
    """A message with ids, pids and addresses masked."""
    text = re.sub(r"[0-9a-f]{8,}", "<id>", str(text))
    return re.sub(r"pid=\d+", "pid=<pid>", text)


def _error(exc: BaseException) -> tuple:
    """What a caller sees of an error: its type name and masked message (a
    TaskError by its function and the traceback's last line, whose file
    paths differ between the packages)."""
    if isinstance(exc, (jexc.TaskError, texc.TaskError)):
        last = exc.traceback_str.strip().splitlines()[-1]
        return type(exc).__name__, exc.function_name, _mask(last)
    return type(exc).__name__, _mask(str(exc))


def _raises(fn) -> tuple:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the scenario reports it
        return _error(e)
    raise AssertionError("no error raised")


def _in_local_mode(rt, scenario):
    """`scenario(rt)` on `rt`'s local engine, shut down whatever happens."""
    for runtime in RUNTIMES:
        if runtime.is_initialized():
            runtime.shutdown()
    rt.init(local_mode=True)
    try:
        return scenario(rt)
    finally:
        rt.shutdown()


# -- the scenarios of test_core_api_local.py and test_streaming_local.py ----

def s_put_get_roundtrip(rt):
    out = rt.get(rt.put({"a": np.arange(10), "b": [1, 2, 3], "c": "hello"}))
    return out["a"].tolist(), out["b"], out["c"]


def s_task_submit_and_get(rt):
    @rt.remote
    def add(a, b):
        return a + b

    return rt.get(add.remote(1, 2))


def s_task_with_object_ref_args(rt):
    @rt.remote
    def add(a, b):
        return a + b

    y = add.remote(rt.put(10), 5)
    return rt.get(add.remote(y, y))


def s_nested_tasks(rt):
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 1

    return rt.get(outer.remote(5))


def s_num_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    @rt.remote(num_returns=2)
    def wrong():
        return 1

    return rt.get(list(three.remote())), _raises(lambda: rt.get(wrong.remote()[0]))


def s_task_error_propagates(rt):
    @rt.remote
    def boom():
        raise ValueError("bad")

    return _raises(lambda: rt.get(boom.remote()))


def s_get_timeout(rt):
    @rt.remote
    def slow():
        time.sleep(0.5)
        return 1

    ref = slow.remote()
    t0 = time.monotonic()
    err = _raises(lambda: rt.get(ref, timeout=0.1))
    waited = time.monotonic() - t0
    return err, 0.1 <= waited < 0.4, rt.get(ref, timeout=5)


def s_wait(rt):
    @rt.remote
    def sleepy(t):
        time.sleep(t)
        return t

    fast, slow = sleepy.remote(0.01), sleepy.remote(0.6)
    ready, pending = rt.wait([fast, slow], num_returns=1, timeout=1.0)
    first = ([r == fast for r in ready], [r == slow for r in pending])
    ready, pending = rt.wait([fast, slow], num_returns=2, timeout=0.05)
    second = ([r == fast for r in ready], [r == slow for r in pending])
    bad = _raises(lambda: rt.wait([fast, fast]))
    return first, second, bad


def s_actor_basic(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def incr(self, by=1):
            self.n += by
            return self.n

    c = Counter.remote(10)
    return rt.get(c.incr.remote()), rt.get(c.incr.remote(5))


def s_actor_ordering(rt):
    @rt.remote
    class Appender:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)

        def get_items(self):
            return self.items

    a = Appender.remote()
    for i in range(50):
        a.add.remote(i)
    return rt.get(a.get_items.remote())


def s_named_actor(rt):
    @rt.remote
    class Svc:
        def ping(self):
            return "pong"

    Svc.options(name="svc1").remote()
    return (rt.get(rt.get_actor("svc1").ping.remote()),
            _raises(lambda: Svc.options(name="svc1").remote()),
            _raises(lambda: rt.get_actor("missing")))


def s_actor_method_error(rt):
    @rt.remote
    class Bad:
        def boom(self):
            raise RuntimeError("actor bad")

    return _raises(lambda: rt.get(Bad.remote().boom.remote()))


def s_kill_actor(rt):
    @rt.remote
    class A:
        def ping(self):
            return 1

    a = A.remote()
    first = rt.get(a.ping.remote())
    rt.kill(a)
    return first, _raises(lambda: rt.get(a.ping.remote(), timeout=5))


def s_async_actor(rt):
    @rt.remote
    class AsyncActor:
        async def work(self, x):
            await asyncio.sleep(0.01)
            return x * 2

    a = AsyncActor.remote()
    return rt.get([a.work.remote(i) for i in range(10)])


def s_actor_handle_in_task(rt):
    @rt.remote
    class Store:
        def __init__(self):
            self.v = 0

        def set(self, v):
            self.v = v

        def get_v(self):
            return self.v

    @rt.remote
    def use(handle):
        rt.get(handle.set.remote(42))
        return rt.get(handle.get_v.remote())

    return rt.get(use.remote(Store.remote()))


def s_options_override(rt):
    @rt.remote
    def f():
        return 1

    return (rt.get(f.options(num_cpus=2).remote()),
            _raises(lambda: f.options(num_cpuz=2)),
            _raises(lambda: f()))


def s_large_numpy_roundtrip(rt):
    x = np.random.default_rng(0).random((1000, 1000))
    out = rt.get(rt.put(x))
    return bool(np.array_equal(out, x)), out.dtype.str, out.flags.writeable


def s_cluster_resources(rt):
    return rt.cluster_resources(), rt.available_resources(), rt.nodes()


def s_stream(rt):
    @rt.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i + 100

    @rt.remote(num_returns="streaming")
    def bad():
        return 1

    return ([rt.get(r, timeout=30) for r in gen.remote(3)],
            _raises(lambda: next(bad.remote())))


# -- placement groups, ActorPool, Queue ---------------------------------------

def s_placement_group_records(rt):
    """The engine's records (the JAX package's public `placement_group`
    passes `bundle_labels`, which its local engine does not take)."""
    from ray_tpu_torch.api import _global_worker as tworker

    worker = tworker() if rt is ray_tpu_torch else ray_tpu.api._global_worker()
    pg_id = importlib.import_module(f"{rt.__name__}.core.ids").PlacementGroupID.generate()
    worker.create_placement_group(pg_id, [{"CPU": 1}, {"CPU": 2}], "SPREAD")
    made = dict(worker.get_placement_group(pg_id))
    worker.remove_placement_group(pg_id)
    table = [dict(pg, pg_id="<id>") for pg in worker.list_placement_groups()]
    return dict(made, pg_id="<id>"), table


def s_actor_pool(rt):
    ActorPool = importlib.import_module(f"{rt.__name__}.util.actor_pool").ActorPool

    @rt.remote
    class Doubler:
        def double(self, x):
            time.sleep(0.01 * (x % 3))
            return 2 * x

    pool = ActorPool([Doubler.remote() for _ in range(2)])
    ordered = list(pool.map(lambda a, v: a.double.remote(v), range(6)))
    unordered = sorted(pool.map_unordered(lambda a, v: a.double.remote(v), range(6)))
    pool.submit(lambda a, v: a.double.remote(v), 7)
    pool.submit(lambda a, v: a.double.remote(v), 8)
    busy = _raises(lambda: pool.submit(lambda a, v: a.double.remote(v), 9))
    nxt = pool.get_next(), pool.get_next_unordered()
    return ordered, unordered, busy, nxt, pool.has_next(), pool.has_free()


def s_queue(rt):
    qmod = importlib.import_module(f"{rt.__name__}.util.queue")
    q = qmod.Queue(maxsize=2)
    try:
        q.put(1)
        q.put_nowait(2)
        full = q.full(), _raises(lambda: q.put_nowait(3)), q.qsize()
        got = q.get(), q.get_nowait()
        t0 = time.monotonic()
        empty = q.empty(), _raises(lambda: q.get(timeout=0.05))
        return full, got, empty, time.monotonic() - t0 >= 0.05
    finally:
        q.shutdown()


SCENARIOS = {name[2:]: fn for name, fn in globals().items() if name.startswith("s_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    want = _in_local_mode(ray_tpu, SCENARIOS[name])
    got = _in_local_mode(ray_tpu_torch, SCENARIOS[name])
    assert got == want


def test_public_placement_group_api():
    """The port serves the public API on its local engine (the JAX
    package's raises there: its engine takes no bundle_labels)."""
    tpg = importlib.import_module("ray_tpu_torch.util.placement_group")
    from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

    def program(rt):
        pg = tpg.placement_group([{"CPU": 1}, {"GPU": 1}], strategy="STRICT_PACK")

        @rt.remote
        def where():
            return "ran"

        strategy = PlacementGroupSchedulingStrategy(pg, placement_group_bundle_index=1)
        ran = rt.get(where.options(scheduling_strategy=strategy).remote())
        ready = pg.ready(timeout=1), pg.wait(1), pg.bundle_count
        copy = pickle.loads(pickle.dumps(pg))
        tpg.remove_placement_group(pg)
        states = [r["state"] for r in tpg.placement_group_table()]
        return ran, ready, copy.id == pg.id, states, _raises(
            lambda: tpg.placement_group([{"CPU": 1}], strategy="NOPE"))

    assert _in_local_mode(ray_tpu_torch, program) == (
        "ran", (True, True, 2), True, ["REMOVED"],
        ("ValueError", "strategy must be one of ('PACK', 'SPREAD', "
                       "'STRICT_PACK', 'STRICT_SPREAD')"))
    jpg = importlib.import_module("ray_tpu.util.placement_group")

    assert _in_local_mode(ray_tpu, lambda rt: _raises(
        lambda: jpg.placement_group([{"CPU": 1}])))[0] == "TypeError"


# -- exceptions, ids, options, serialization ---------------------------------

_EXC_ARGS = {
    "TaskError": ("f", "Traceback...\nValueError: x", None, 7, "node0123456789"),
    "ActorError": ("A.m", "tb", None, 8, "n"),
    "ActorDiedError": ("abcdef0123456789", "killed"),
    "ReplicaDrainingError": ("r1",),
    "KVMigrationError": ("req", "stale ticket"),
    "ObjectLostError": ("0123456789abcdef", ""),
    "ObjectReconstructionFailedError": ("0123456789abcdef", "gone"),
    "OwnerDiedError": ("0123456789abcdef", ""),
    "DataPlaneError": ("", "map"),
    "BackpressureTimeout": ("", "map", 2.5, 1024),
    "StreamQueueFullError": ("behind", 1024),
}


def _exception_classes(module):
    return sorted((name, cls) for name, cls in vars(module).items()
                  if isinstance(cls, type) and issubclass(cls, Exception)
                  and cls.__module__ == module.__name__)


def test_every_exception_pickles_as_jax():
    jax_classes, port_classes = _exception_classes(jexc), _exception_classes(texc)
    assert [n for n, _ in port_classes] == [n for n, _ in jax_classes]
    assert len(port_classes) == 24
    for (name, jcls), (_, tcls) in zip(jax_classes, port_classes):
        args = _EXC_ARGS.get(name, ("boom",))
        seen = []
        for cls in (jcls, tcls):
            e = pickle.loads(pickle.dumps(cls(*args)))
            assert type(e) is cls
            seen.append((str(e), e.args, {k: v for k, v in vars(e).items()},
                         [c.__name__ for c in cls.__mro__]))
        assert seen[1] == seen[0], name


def test_ids_match_jax():
    task = bytes(range(16))
    for pkg in (jids, tids):
        assert pkg.ObjectID.for_task_return(pkg.TaskID(task), 3).binary() == \
            jids.ObjectID.for_task_return(jids.TaskID(task), 3).binary()
        assert pkg.TaskID.for_actor_creation(pkg.ActorID(task)).binary() == \
            jids.TaskID.for_actor_creation(jids.ActorID(task)).binary()
    with pytest.raises(ValueError, match="must be 16 bytes"):
        tids.TaskID(b"short")


@pytest.mark.parametrize("options", [
    {}, {"num_cpus": 2}, {"num_gpus": 1}, {"num_tpus": 2},
    {"num_gpus": 0.5, "num_tpus": 4, "memory": 1 << 20, "accelerator_type": "H100",
     "resources": {"custom": 2.0}},
    {"num_cpus": 0, "num_gpus": 0},
])
def test_resource_demand_asks_for_gpu_where_jax_asks_for_tpu(options):
    """The port's num_gpus is JAX's num_tpus and its num_tpus the parity
    alias (JAX's num_gpus): where both are given, each package's own wins."""
    swap = {"num_gpus": "num_tpus", "num_tpus": "num_gpus"}
    want = JaxTaskOptions(**{swap.get(k, k): v for k, v in options.items()}
                          ).resource_demand(1.0)
    got = TaskOptions(**options).resource_demand(1.0)
    assert got == {("GPU" if k == "TPU" else k): v for k, v in want.items()}


def test_serialization_matches_jax_and_carries_tensors():
    obj = {"a": np.arange(1000, dtype=np.float32), "b": [1, "x", 2.5], "c": None}
    assert tser.dumps(obj) == jser.dumps(obj)
    back = tser.deserialize(jser.dumps(obj))
    assert back["b"] == obj["b"] and np.array_equal(back["a"], obj["a"])
    meta, bufs = tser.serialize(obj)
    out = bytearray(tser.serialized_size(meta, bufs))
    tser.write_to(memoryview(out), meta, bufs)
    assert bytes(out) == tser.concat(meta, bufs) == b"".join(tser.iov_parts(meta, bufs))

    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g),
               "bf16": torch.randn(4, generator=g).to(torch.bfloat16),
               "scalar": torch.tensor(2.5, dtype=torch.float64),
               "empty": torch.empty(0, 7),
               "strided": torch.arange(12).view(3, 4).t(),
               "bool": torch.tensor([True, False]),
               "leaf": torch.ones(2).requires_grad_(),
               "param": torch.nn.Parameter(torch.ones(2, 2))}
    meta, bufs = tser.serialize(tensors)
    assert len(bufs) == len(tensors)  # every tensor out of band
    back = tser.deserialize(tser.dumps(tensors))
    for k, t in tensors.items():
        b = back[k]
        assert (type(b), b.dtype, b.shape, b.device, b.requires_grad) == \
            (type(t), t.dtype, t.shape, t.device, t.requires_grad), k
        assert torch.equal(b.detach(), t.detach()), k
    back["f32"][0, 0] = 7.0  # a copy, writable, not a view of the payload
    assert tensors["f32"][0, 0] != 7.0
    with pytest.raises(RuntimeError, match="non-leaf"):
        tser.dumps(tensors["leaf"] * 2)
    with pytest.raises(ValueError, match="bad"):
        tser.deserialize(tser.dumps(ValueError("bad"), is_error=True))


# -- resources.py against JAX's ----------------------------------------------

def test_resource_set_math_matches_jax():
    rng = np.random.default_rng(0)
    keys = ["CPU", "GPU", "memory", "x"]
    for _ in range(50):
        total = {k: float(rng.integers(0, 4)) for k in keys if rng.random() < 0.8}
        avail = {k: v - float(rng.integers(0, 2)) * (v > 0) for k, v in total.items()}
        demand = {k: float(rng.choice([0, 0.5, 1, 2])) for k in keys if rng.random() < 0.6}
        for fn in ("fits", "feasible"):
            assert getattr(tres, fn)(avail, demand) == getattr(jres, fn)(avail, demand)
        assert tres.utilization(total, avail, demand) == jres.utilization(total, avail, demand)
        assert tres.utilization(total, avail) == jres.utilization(total, avail)
        for fn in ("subtract", "add"):
            a, b = dict(avail), dict(avail)
            getattr(tres, fn)(a, demand)
            getattr(jres, fn)(b, demand)
            assert a == b


def _as_gpu(res: dict) -> dict:
    return {("GPU" if k == "TPU" else k): v for k, v in res.items()}


def test_detection_under_the_override_knobs_matches_jax(monkeypatch):
    for var in ("TPU_ACCELERATOR_TYPE", "TPU_NAME", "TPU_WORKER_ID", "RAY_TPU_NUM_TPUS",
                "RAY_TPU_NUM_GPUS", "RAY_TPU_DISABLE_TPU_DETECTION",
                "RAY_TPU_DISABLE_GPU_DETECTION", "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    kw = dict(num_cpus=8, memory=1 << 30, custom={"rack": 1.0})

    def both(**gpus):
        return (_as_gpu(jres.detect_node_resources(**kw)),
                tres.detect_node_resources(**kw, **gpus))

    # Forced counts: the operator's number, no probe, no model known.
    monkeypatch.setenv("RAY_TPU_NUM_TPUS", "4")
    monkeypatch.setenv("RAY_TPU_NUM_GPUS", "4")
    want, got = both()
    assert got == want and got["GPU"] == 4.0
    monkeypatch.delenv("RAY_TPU_NUM_TPUS")
    monkeypatch.delenv("RAY_TPU_NUM_GPUS")
    # Detection disabled.
    monkeypatch.setenv("RAY_TPU_DISABLE_TPU_DETECTION", "1")
    monkeypatch.setenv("RAY_TPU_DISABLE_GPU_DETECTION", "1")
    want, got = both()
    assert got == want and "GPU" not in got
    monkeypatch.delenv("RAY_TPU_DISABLE_TPU_DETECTION")
    monkeypatch.delenv("RAY_TPU_DISABLE_GPU_DETECTION")
    # An explicit count wins over the probe.
    assert tres.detect_node_resources(num_gpus=2, **kw) == _as_gpu(
        jres.detect_node_resources(num_tpus=2, **kw))
    # The probe, stubbed, run once and cached (JAX_PLATFORMS=cpu and an
    # empty CUDA_VISIBLE_DEVICES are the test-mode zeros).
    calls = []
    monkeypatch.delenv("JAX_PLATFORMS")
    monkeypatch.setattr(jres, "_tpu_probe_cache", None)
    monkeypatch.setattr(tres, "_gpu_probe_cache", None)
    monkeypatch.setattr(jres, "run_tpu_probe", lambda t, compute=False: (2, "TPUCOUNT=2"))
    monkeypatch.setattr(tres, "run_gpu_probe", lambda t: calls.append(t) or (
        2, "NVIDIA H100 80GB HBM3", "GPUCOUNT=2"))
    want, got = both()
    assert got == {**want, "accelerator_type:H100": 1.0}
    assert tres.probe_gpu_count() == jres.probe_tpu_count() == 2 and len(calls) == 1
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert tres.probe_gpu_count() == jres.probe_tpu_count() == 0


def test_gpu_accelerator_rules():
    assert tacc.accelerator_type("NVIDIA H100 80GB HBM3") == "H100"
    assert tacc.accelerator_type("Tesla V100-SXM2-16GB") == "V100"
    assert tacc.accelerator_type("") is None
    assert tacc.gpu_extra_resources("NVIDIA A100-SXM4-80GB") == {"accelerator_type:A100": 1.0}
    assert tacc.gpu_extra_resources(None) == {}
    assert [tacc.validate_chip_request(q)[0] for q in (0.25, 1, 2, 8, 0, 1.5, -1)] == \
        [True, True, True, True, False, False, False]
    assert tacc.visible_chip_env([0, 2]) == {"CUDA_VISIBLE_DEVICES": "0,2"}
    # A probe that outlives its time box answers 0, never blocks.
    count, name, why = tres.run_gpu_probe(0.001)
    assert (count, name) == (0, "") and "timed out" in why


# -- the port's own rules ---------------------------------------------------

def test_tasks_run_under_the_callers_grad_and_inference_mode():
    def program(rt):
        @rt.remote
        def modes(x):
            y = x * 2
            state = (torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
                     y.requires_grad)
            torch.set_grad_enabled(False)  # left on the pooled thread
            return state

        @rt.remote
        class Modes:
            def modes(self):
                return torch.is_grad_enabled(), torch.is_inference_mode_enabled()

        x, actor = torch.ones(2, requires_grad=True), Modes.remote()
        out = {"default": rt.get([modes.remote(x) for _ in range(8)])}
        with torch.no_grad():
            out["no_grad"] = rt.get(modes.remote(x)), rt.get(actor.modes.remote())
        with torch.inference_mode():
            out["inference"] = rt.get(modes.remote(x)), rt.get(actor.modes.remote())
        out["after"] = rt.get([modes.remote(x) for _ in range(8)])
        return out

    out = _in_local_mode(ray_tpu_torch, program)
    assert out["default"] == out["after"] == [(True, False, True)] * 8
    assert out["no_grad"] == ((False, False, False), (False, False))
    assert out["inference"] == ((False, True, False), (False, True))


def test_a_ref_inside_a_stored_object_keeps_its_object():
    """A stored object pins the objects of the refs inside it until it is
    freed itself. The JAX package's local engine pins none, so there a task
    that returns `put(5)` hands back a ref whose object is gone."""
    import gc

    def program(rt):
        worker = rt.api._worker

        @rt.remote
        def make():
            return rt.put(5)

        inner = rt.get(make.remote())
        gc.collect()
        if rt is ray_tpu:
            return _raises(lambda: rt.get(inner, timeout=0.2))[0]
        got = [rt.get(inner, timeout=5)]
        oid = inner.id()
        del inner
        gc.collect()
        got.append(worker._store.contains(oid))
        outer = rt.put({"r": rt.put(7)})
        gc.collect()
        got.append(rt.get(rt.get(outer)["r"], timeout=5))
        del outer
        gc.collect()
        return got, dict(worker._refcounts), worker._contained

    assert _in_local_mode(ray_tpu, program) == "GetTimeoutError"
    assert _in_local_mode(ray_tpu_torch, program) == ([5, False, 7], {}, {})


def test_a_ref_dropped_inside_the_store_lock_does_not_deadlock():
    """A collection can run ObjectRef.__del__ at any allocation, also one
    inside the local store's lock. Dropping the last ref there frees the
    object on the same thread; and while another thread holds the engine's
    lock and waits for the store's, the drop returns at once and the
    lock's next holder frees the object. The JAX package's local store
    deadlocks in the first case (its lock is not reentrant), so it is not
    run here."""
    import threading

    def on_thread(fn, timeout=10.0):
        done = []
        t = threading.Thread(target=lambda: done.append(fn()), daemon=True)
        t.start()
        t.join(timeout)
        assert not t.is_alive(), "deadlocked"
        return done[0]

    def program(rt):
        worker = rt.api._worker
        store = worker._store

        def same_thread():
            ref = rt.put(np.arange(4))
            oid = ref.id()
            with store._lock:
                del ref
            return store.contains(oid)

        freed_same = not on_thread(same_thread)

        ref = rt.put(np.arange(4))
        oid = ref.id()
        holding_store = threading.Event()
        waiting = threading.Event()

        def engine_side():
            with worker._lock:
                holding_store.wait(10)
                waiting.set()
                store.contains(oid)      # waits for the store's lock

        def store_side():
            nonlocal ref
            with store._lock:
                holding_store.set()
                waiting.wait(10)
                time.sleep(0.2)          # the other thread is now blocked
                del ref
            return True

        b = threading.Thread(target=engine_side, daemon=True)
        b.start()
        returned = on_thread(store_side)
        b.join(10)
        assert not b.is_alive(), "deadlocked"
        rt.put(0)                        # the lock's next holder
        return freed_same, returned, store.contains(oid)

    assert _in_local_mode(ray_tpu_torch, program) == (True, True, False)


def _xlang_and_bind(rt):
    """`register_cross_lang` writes the function's key under b"xlang", and
    `.bind()` on a remote function, an actor class and an actor method
    builds the DAG node that `execute`s to the call's value."""
    worker = rt.api._global_worker()
    proto = importlib.import_module(f"{rt.__name__}.core.distributed.protocol")

    def add(a, b):
        return a + b

    rt.register_cross_lang("add", add)
    xlang = worker.kv_get(b"xlang", b"add") == proto.function_key(add)[0]
    f = rt.remote(add)

    @rt.remote
    class A:
        def __init__(self, base=0):
            self.base = base

        def m(self, x=1):
            return self.base + x

    nodes = (f.bind(1, 2), A.bind(10), A.remote(5).m.bind(3))
    kinds = [type(n).__name__ for n in nodes]
    fn_value = rt.get(nodes[0].execute())
    actor = nodes[1].execute()
    method_value = rt.get(nodes[2].execute())
    return xlang, kinds, fn_value, rt.get(actor.m.remote(4)), method_value


def test_what_needs_the_multiprocess_runtime_raises(monkeypatch):
    """What PRs before the DAG layer left raising now runs in both packages:
    `register_cross_lang` writes its b"xlang" key and `.bind()` builds DAG
    nodes that execute to JAX's values; a serve deployment's `bind` stays
    serve's own. A ray-tpu:// address, given to `init` or
    through RAY_TPU_ADDRESS, connects through a client proxy (a proxy
    process that hosts its own cluster's driver). `init()` and an implicit
    init start a cluster instead
    (`test_init_starts_a_cluster_and_an_address_joins_it`)."""
    import subprocess
    import sys

    from ray_tpu_torch.core.distributed.driver import _read_handshake, child_env
    from ray_tpu_torch.util.client import ClientWorker

    for runtime in RUNTIMES:
        if runtime.is_initialized():
            runtime.shutdown()
    proxy = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.util.client.server",
         "--port", "0"], stdout=subprocess.PIPE, env=child_env())
    try:
        port = _read_handshake(proxy, r"CLIENT_PROXY_PORT=(?P<port>\d+)",
                               "client proxy")["port"]
        address = f"ray-tpu://127.0.0.1:{port}"
        assert isinstance(ray_tpu_torch.init(address), ClientWorker)
        assert ray_tpu_torch.get(ray_tpu_torch.remote(lambda: 6 * 7).remote(),
                                 timeout=60) == 42
        ray_tpu_torch.shutdown()
        monkeypatch.setenv("RAY_TPU_ADDRESS", address)
        reset_config()
        assert isinstance(ray_tpu_torch.init(), ClientWorker)
        assert ray_tpu_torch.get(ray_tpu_torch.put("through the proxy"),
                                 timeout=30) == "through the proxy"
        ray_tpu_torch.shutdown()
        monkeypatch.delenv("RAY_TPU_ADDRESS")
        reset_config()
        assert not ray_tpu_torch.is_initialized()

        ray_tpu_torch.init(local_mode=True)
        with pytest.raises(RuntimeError, match="already been called"):
            ray_tpu_torch.init(local_mode=True)
        assert ray_tpu_torch.init(local_mode=True, ignore_reinit_error=True) is not None
        got = _xlang_and_bind(ray_tpu_torch)
        assert got == (True, ["FunctionNode", "ActorClassNode", "ActorMethodNode"],
                       3, 14, 8), got
        ray_tpu_torch.shutdown()
        assert _in_local_mode(ray_tpu, _xlang_and_bind) == got
        ray_tpu_torch.init(local_mode=True)

        @ray_tpu_torch.remote
        class A:
            def m(self):
                return 1

        # A deployment's bind is serve's own: it builds the application.
        from ray_tpu_torch import serve

        app = serve.deployment(A).bind(1, k=2)
        assert (app.deployment.name, app.init_args, app.init_kwargs) == (
            "A", (1,), {"k": 2})
        assert ray_tpu_torch.get_runtime_context().get_node_id() == "local"
    finally:
        ray_tpu_torch.shutdown()
        reset_config()
        proxy.terminate()
        proxy.wait(timeout=30)


_JOIN_BY_ENV = (
    "import sys; sys.path.insert(0, %r); import ray_tpu_torch as rt; "
    "rt.init(); print('JOINED', rt.get(rt.remote(lambda: 6 * 7).remote()), "
    "len(rt.nodes())); rt.shutdown()")


def test_init_starts_a_cluster_and_an_address_joins_it():
    """`init()` starts a single-host cluster (no local-mode fallback), as an
    implicit init does; a process with RAY_TPU_ADDRESS set joins it, and
    `init` with an address that no ray_tpu_torch head answers raises."""
    import os
    import subprocess
    import sys

    from ray_tpu_torch.core.distributed.core_worker import DistributedCoreWorker

    for runtime in RUNTIMES:
        if runtime.is_initialized():
            runtime.shutdown()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        with pytest.raises(RuntimeError, match="is not a ray_tpu_torch head"):
            ray_tpu_torch.init("127.0.0.1:1")
        assert not ray_tpu_torch.is_initialized()

        @ray_tpu_torch.remote
        def f():
            return 1

        assert ray_tpu_torch.get(f.remote()) == 1   # an implicit init
        assert isinstance(ray_tpu_torch.api._worker, DistributedCoreWorker)
        ray_tpu_torch.shutdown()

        worker = ray_tpu_torch.init(num_cpus=2, num_gpus=1)
        assert isinstance(worker, DistributedCoreWorker)
        assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0
        assert ray_tpu_torch.get_runtime_context().get_node_id() != "local"
        with pytest.raises(RuntimeError, match="already been called"):
            ray_tpu_torch.init()
        env = dict(os.environ, RAY_TPU_ADDRESS=worker.gcs_address)
        joined = subprocess.run([sys.executable, "-c", _JOIN_BY_ENV % repo],
                                capture_output=True, text=True, timeout=120,
                                env=env, cwd=repo)
        assert joined.returncode == 0, joined.stdout + joined.stderr
        assert "JOINED 42 1" in joined.stdout
    finally:
        ray_tpu_torch.shutdown()
        reset_config()
