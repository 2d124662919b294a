"""The DAG layer of ray_tpu_torch against ray_tpu's, on the CPU.

The scenarios of tests/test_dag.py run through both packages in local mode,
one after the other in one test. The channel primitive's cases of
tests/test_compiled_dag.py and the cross-host channel endpoints of
tests/test_cross_host_channels.py (a two-daemon `InProcDaemonCluster` per
case) run for each package. The compiled-DAG cases of test_compiled_dag.py
and test_cross_host_dag.py run on one two-node `cluster_utils.Cluster` per
runtime for this file (a head with the custom resource "alpha", a second
node with "beta"), never both at once: JAX's run records what it got, the
port's run is held to the record (values, error types and messages, which
stage ran on which node). The slice as a whole: TINY's train step in an
actor stage of a compiled DAG, fed by a FunctionNode batch stage on the
other node, JAX's step through JAX's DAG and the port's through the port's,
from the same weights (carried by `models/jax_bridge.py`) and the same
numpy batches; fp32 losses within 1e-5 over 3 steps.

Classes and functions sent to workers are nested in the test's helpers
(cloudpickle sends them by value; the test module does not import in a
worker).
"""
import asyncio
import dataclasses
import gc
import importlib
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import configs as jax_configs
from ray_tpu.models.training import make_train_step as jax_make_train_step
from ray_tpu.parallel import MeshConfig, build_mesh

RUNTIMES = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]
RECORD = {}
LOSS_REL = 1e-5
WAIT_S = 120


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


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the scenario reports it
        return type(e).__name__, str(e)
    raise AssertionError("no error raised")


def _outcome(fn):
    """("ok", value) or the error's (type name, message)."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the scenario reports it
        return type(e).__name__, str(e)


# -- tests/test_dag.py, in local mode ------------------------------------------

def s_function_dag(rt):
    InputNode = _mod(rt, "dag").InputNode

    @rt.remote
    def a(x):
        return x + 1

    @rt.remote
    def b(x, y):
        return x * y

    with InputNode() as inp:
        dag = b.bind(a.bind(inp), a.bind(inp))
    return rt.get(dag.execute(3))


def s_shared_subgraph_executes_once(rt):
    InputNode = _mod(rt, "dag").InputNode

    @rt.remote
    class Tracker:
        def __init__(self):
            self.count = 0

        def tick(self):
            self.count += 1
            return self.count

    @rt.remote
    def consume(a, b):
        return (a, b)

    t = Tracker.remote()
    with InputNode():
        shared = t.tick.bind()
        dag = consume.bind(shared, shared)
    return rt.get(dag.execute())


def s_multi_output(rt):
    dag_mod = _mod(rt, "dag")

    @rt.remote
    def f(x):
        return x * 2

    with dag_mod.InputNode() as inp:
        dag = dag_mod.MultiOutputNode([f.bind(inp), f.bind(inp)])
    return rt.get(dag.execute(5))


def s_compiled_dag_reuses_actors(rt):
    InputNode = _mod(rt, "dag").InputNode

    @rt.remote
    class Stage:
        def __init__(self):
            self.calls = 0

        def step(self, x):
            self.calls += 1
            return x + self.calls

    with InputNode() as inp:
        node = Stage.bind()
        dag = node.step.bind(inp)
    compiled = dag.experimental_compile()
    try:
        return [compiled.execute(0).get(), compiled.execute(0).get()]
    finally:
        compiled.teardown()


def s_lane_stages_need_the_cluster(rt):
    InputNode = _mod(rt, "dag").InputNode

    @rt.remote
    def f(x):
        return x

    with InputNode() as inp:
        dag = f.bind(inp)
    return _error(dag.experimental_compile)


LOCAL = {"function_dag": (s_function_dag, 16),
         "shared_subgraph_executes_once": (s_shared_subgraph_executes_once, (1, 1)),
         "multi_output": (s_multi_output, [10, 10]),
         "compiled_dag_reuses_actors": (s_compiled_dag_reuses_actors, [1, 2]),
         "lane_stages_need_the_cluster": (s_lane_stages_need_the_cluster, None)}


@pytest.mark.parametrize("name", list(LOCAL))
def test_local_mode_dag_matches_jax(name):
    scenario, want = LOCAL[name]
    got = []
    for rt in RUNTIMES:
        _shutdown_all()
        rt.init(local_mode=True)
        try:
            got.append(scenario(rt))
        finally:
            rt.shutdown()
            # Collect the run's ref cycles now, with no engine lock held:
            # a collection inside JAX's local store lock that frees a ref
            # deadlocks its thread (ROADMAP C).
            gc.collect()
    assert got[0] == got[1], got
    if want is not None:
        assert got[1] == want


# -- the channel primitive (tests/test_compiled_dag.py) ------------------------

def _channel(rt):
    return _mod(rt, "experimental.channel")


def c_roundtrip_and_versions(chm):
    ch = chm.Channel.create(n_readers=1, capacity=1 << 16)
    try:
        ch.write({"a": 1})
        first = ch.read(timeout=5)
        ch.write([1, 2, 3])
        return first, ch.read(timeout=5)
    finally:
        ch.close()
        ch.unlink()


def c_backpressure_blocks_writer(chm):
    ch = chm.Channel.create(n_readers=1, capacity=1 << 16, n_slots=1)
    try:
        ch.write("v1")
        with pytest.raises(chm.ChannelTimeoutError):
            ch.write("v2", timeout=0.2)
        reader = chm.Channel(ch.path, ch.capacity, ch.n_readers, ch.n_slots)
        first = reader.read(timeout=5)
        ch.write("v2", timeout=5)
        return first, reader.read(timeout=5)
    finally:
        ch.close()
        ch.unlink()


def c_ring_pipelines_n_slots(chm):
    ch = chm.Channel.create(n_readers=1, capacity=1 << 16, n_slots=4)
    try:
        for i in range(4):
            ch.write(i, timeout=1)
        with pytest.raises(chm.ChannelTimeoutError):
            ch.write(4, timeout=0.2)
        reader = chm.Channel(ch.path, ch.capacity, ch.n_readers, ch.n_slots)
        got = [reader.read(timeout=5) for _ in range(4)]
        ch.write(4, timeout=5)
        return got + [reader.read(timeout=5)]
    finally:
        ch.close()
        ch.unlink()


def c_two_readers_both_consume(chm):
    ch = chm.Channel.create(n_readers=2, capacity=1 << 16)
    readers = [chm.Channel(ch.path, ch.capacity, ch.n_readers) for _ in range(2)]
    got = {}

    def consume(rd, idx):
        got[idx] = [rd.read(timeout=10, reader_idx=idx) for _ in range(3)]

    threads = [threading.Thread(target=consume, args=(r, i))
               for i, r in enumerate(readers)]
    for t in threads:
        t.start()
    for v in ("x", "y", "z"):
        ch.write(v, timeout=10)
    for t in threads:
        t.join(timeout=20)
    ch.close()
    ch.unlink()
    return got


def c_close_unblocks(chm):
    ch = chm.Channel.create(n_readers=1, capacity=1 << 16)
    err = []

    def read():
        try:
            ch.read(timeout=30)
        except chm.ChannelClosedError as e:
            err.append(type(e).__name__)

    t = threading.Thread(target=read)
    t.start()
    time.sleep(0.1)
    ch.close()
    t.join(timeout=10)
    ch.unlink()
    return err


def c_reader_reattach_recovers_ack(chm):
    ch = chm.Channel.create(n_readers=1, capacity=1 << 16, n_slots=2)
    try:
        reader = chm.Channel(ch.path, ch.capacity, ch.n_readers, ch.n_slots)
        got = []
        for i in range(5):
            ch.write(i, timeout=5)
            got.append(reader.read(timeout=5))
        reattached = chm.Channel(ch.path, ch.capacity, ch.n_readers, ch.n_slots)
        ready = reattached.peek_ready()
        ch.write("after", timeout=5)
        return got, ready, reattached.read(timeout=5)
    finally:
        ch.close()
        ch.unlink()


def c_capacity_error(chm):
    ch = chm.Channel.create(n_readers=1, capacity=1024)
    try:
        return _error(lambda: ch.write(b"x" * 4096))
    finally:
        ch.close()
        ch.unlink()


CHANNEL = {"roundtrip_and_versions": c_roundtrip_and_versions,
           "backpressure_blocks_writer": c_backpressure_blocks_writer,
           "ring_pipelines_n_slots": c_ring_pipelines_n_slots,
           "two_readers_both_consume": c_two_readers_both_consume,
           "close_unblocks": c_close_unblocks,
           "reader_reattach_recovers_ack": c_reader_reattach_recovers_ack,
           "capacity_error": c_capacity_error}


@pytest.mark.parametrize("name", list(CHANNEL))
def test_channel_matches_jax(name):
    got = [CHANNEL[name](_channel(rt)) for rt in RUNTIMES]
    assert got[0] == got[1], got


# -- cross-host channel endpoints (tests/test_cross_host_channels.py) ----------

def x_remote_push_lands_in_reader_local_ring(rt, addrs, make_ring):
    chm = _channel(rt)
    ring = make_ring(addrs[0], n_slots=2)
    writer = chm.RemoteChannelWriter(addrs[0], ring["path"], ring["capacity"],
                                     ring["n_readers"], ring["n_slots"])
    reader = chm.Channel(ring["path"], ring["capacity"], ring["n_readers"],
                         ring["n_slots"])
    try:
        got = []
        for i in range(5):
            writer.write({"i": i}, timeout=10)
            got.append(reader.read(timeout=10))
        return got
    finally:
        writer.close()
        writer.unlink()


def x_backpressure_crosses_rpc_hop(rt, addrs, make_ring):
    chm = _channel(rt)
    ring = make_ring(addrs[0], n_slots=1)
    writer = chm.RemoteChannelWriter(addrs[0], ring["path"], ring["capacity"],
                                     ring["n_readers"], ring["n_slots"])
    reader = chm.Channel(ring["path"], ring["capacity"], ring["n_readers"],
                         ring["n_slots"])
    try:
        writer.write("a", timeout=10)
        blocked = _error(lambda: writer.write("b", timeout=0.4))[0]
        first = reader.read(timeout=10)
        writer.write("b", timeout=10)
        return blocked, first, reader.read(timeout=10)
    finally:
        writer.close()
        writer.unlink()


def x_readers_consume_out_of_order(rt, addrs, make_ring):
    chm = _channel(rt)
    ring = make_ring(addrs[1], n_readers=2, n_slots=2)
    writer = chm.RemoteChannelWriter(addrs[1], ring["path"], ring["capacity"],
                                     ring["n_readers"], ring["n_slots"])
    fast, slow = (chm.Channel(ring["path"], ring["capacity"], ring["n_readers"],
                              ring["n_slots"]) for _ in range(2))
    try:
        writer.write("v0", timeout=10)
        writer.write("v1", timeout=10)
        got = [fast.read(timeout=10, reader_idx=0), fast.read(timeout=10, reader_idx=0)]
        got.append(_error(lambda: writer.write("v2", timeout=0.4))[0])
        got.append(slow.read(timeout=10, reader_idx=1))
        writer.write("v2", timeout=10)
        got += [slow.read(timeout=10, reader_idx=1), slow.read(timeout=10, reader_idx=1),
                fast.read(timeout=10, reader_idx=0)]
        return got
    finally:
        writer.close()
        writer.unlink()


def x_reader_death_unblocks_remote_writer(rt, addrs, make_ring):
    chm = _channel(rt)
    ring = make_ring(addrs[0], n_slots=1)
    writer = chm.RemoteChannelWriter(addrs[0], ring["path"], ring["capacity"],
                                     ring["n_readers"], ring["n_slots"])
    reader = chm.Channel(ring["path"], ring["capacity"], ring["n_readers"],
                         ring["n_slots"])
    writer.write("x", timeout=10)
    errs = []

    def blocked_write():
        try:
            writer.write("y", timeout=30)
        except chm.ChannelClosedError as e:
            errs.append(type(e).__name__)

    t = threading.Thread(target=blocked_write)
    t.start()
    time.sleep(0.4)
    reader.close()
    t.join(timeout=20)
    writer.unlink()
    return errs


def x_push_version_dedupe_makes_retries_safe(rt, addrs, make_ring):
    import cloudpickle

    chm = _channel(rt)
    rpc = _mod(rt, "core.distributed.rpc")
    wire = _mod(rt, "core.distributed.wire")
    ring = make_ring(addrs[0], n_slots=4)
    writer = chm.RemoteChannelWriter(addrs[0], ring["path"], ring["capacity"],
                                     ring["n_readers"], ring["n_slots"])
    reader = chm.Channel(ring["path"], ring["capacity"], ring["n_readers"],
                         ring["n_slots"])
    client = rpc.SyncRpcClient(addrs[0])
    try:
        writer.write("only-once", timeout=10)
        rep = client.call("NodeDaemon", "channel_push", path=ring["path"],
                          capacity=ring["capacity"], n_readers=ring["n_readers"],
                          n_slots=ring["n_slots"], version=1, push_timeout=5.0,
                          data=wire.Raw(cloudpickle.dumps("only-once")), timeout=30)
        writer.write("second", timeout=10)
        return (bool(rep.get("deduped")), reader.read(timeout=10),
                reader.read(timeout=10), reader.peek_ready())
    finally:
        client.close()
        writer.close()
        writer.unlink()


def x_version_close_unlink(rt, addrs, make_ring):
    """The daemon's bookkeeping endpoints: a ring's published version, its
    closed flag, and an unlink that refuses a path that is no ring."""
    chm = _channel(rt)
    rpc = _mod(rt, "core.distributed.rpc")
    ring = make_ring(addrs[1], n_slots=2)
    writer = chm.RemoteChannelWriter(addrs[1], ring["path"], ring["capacity"],
                                     ring["n_readers"], ring["n_slots"])
    client = rpc.SyncRpcClient(addrs[1])
    try:
        writer.write("a", timeout=10)
        v1 = client.call("NodeDaemon", "channel_version", path=ring["path"], timeout=30)
        closed = client.call("NodeDaemon", "channel_close", path=ring["path"], timeout=30)
        v2 = client.call("NodeDaemon", "channel_version", path=ring["path"], timeout=30)
        after = _outcome(lambda: writer.write("b", timeout=5))[0]
        refused = client.call("NodeDaemon", "channel_unlink", path="/tmp/not_a_ring",
                              timeout=30)
        gone = client.call("NodeDaemon", "channel_unlink", path=ring["path"], timeout=30)
        v3 = client.call("NodeDaemon", "channel_version", path=ring["path"], timeout=30)
        return v1, closed, v2, after, refused, gone, v3
    finally:
        client.close()


CROSS = {"remote_push_lands_in_reader_local_ring": x_remote_push_lands_in_reader_local_ring,
         "backpressure_crosses_rpc_hop": x_backpressure_crosses_rpc_hop,
         "readers_consume_out_of_order": x_readers_consume_out_of_order,
         "reader_death_unblocks_remote_writer": x_reader_death_unblocks_remote_writer,
         "push_version_dedupe_makes_retries_safe": x_push_version_dedupe_makes_retries_safe,
         "version_close_unlink": x_version_close_unlink}


def _with_daemons(rt, scenario):
    """`scenario` against a two-daemon InProcDaemonCluster of `rt`, whose
    loop runs on a thread so the blocking writers run from here."""
    vn = _mod(rt, "core.distributed.virtual_node")
    rpc = _mod(rt, "core.distributed.rpc")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    cl = vn.InProcDaemonCluster(2, store_capacity=64 << 20)
    asyncio.run_coroutine_threadsafe(cl.start(), loop).result(60)

    def make_ring(addr, *, n_readers=1, capacity=1 << 16, n_slots=2):
        client = rpc.SyncRpcClient(addr)
        try:
            return client.call("NodeDaemon", "channel_create", n_readers=n_readers,
                               capacity=capacity, n_slots=n_slots, timeout=30)
        finally:
            client.close()

    try:
        return scenario(rt, cl.addresses, make_ring)
    finally:
        asyncio.run_coroutine_threadsafe(cl.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)


@pytest.mark.parametrize("name", list(CROSS))
def test_cross_host_channel_matches_jax(name):
    got = [_with_daemons(rt, CROSS[name]) for rt in RUNTIMES]
    assert got[0] == got[1], got


def _poke_a_file_that_is_no_ring(rt, addrs, victim):
    """Each path-taking endpoint of one daemon called on `victim`, a plain
    file, and on a ``rtpu_chan_`` link to it in the rings' directory:
    the replies, and whether the file's bytes changed."""
    import cloudpickle

    rpc = _mod(rt, "core.distributed.rpc")
    wire = _mod(rt, "core.distributed.wire")
    before = victim.read_bytes()
    link = f"/dev/shm/rtpu_chan_link_{rt.__name__}_{time.monotonic_ns()}"
    os.symlink(victim, link)
    client = rpc.SyncRpcClient(addrs[0])
    try:
        replies = {}
        for label, path in (("file", str(victim)), ("link", link)):
            replies[label] = [
                client.call("NodeDaemon", "channel_version", path=path, timeout=30),
                client.call("NodeDaemon", "channel_push", path=path, capacity=64,
                            n_readers=1, n_slots=1, version=1, push_timeout=1.0,
                            data=wire.Raw(cloudpickle.dumps("x")), timeout=30),
                client.call("NodeDaemon", "channel_close", path=path, timeout=30)]
        return replies, victim.read_bytes() != before
    finally:
        client.close()
        os.unlink(link)


def test_channel_endpoints_refuse_a_path_that_is_no_ring(tmp_path):
    """JAX's daemon reads, writes and at its stop deletes any file an RPC
    caller names (`channel_version`, `channel_close`, `channel_push`); the
    port's serves only ring files of its store or of the rings' default
    directory, and leaves any other file as it was."""
    got = {}
    for rt in RUNTIMES:
        victim = tmp_path / f"victim_{rt.__name__}"
        victim.write_bytes(bytes(range(256)) * 4)
        replies, changed = _with_daemons(
            rt, lambda rt, addrs, make_ring: _poke_a_file_that_is_no_ring(rt, addrs, victim))
        got[rt.__name__] = replies, changed, victim.exists()
    refused = {"error": "not a channel path"}
    assert got["ray_tpu_torch"] == ({
        label: [{"version": 0, "closed": True, **refused}, refused, {"ok": False, **refused}]
        for label in ("file", "link")}, False, True), got
    # The reference's fault (ROADMAP C): channel_close wrote into the file,
    # and the daemon's stop unlinked it, as it unlinks every ring it pushed to.
    assert got["ray_tpu"][1:] == (True, False), got


# -- compiled DAGs on a two-node cluster ---------------------------------------

@pytest.fixture(scope="module", params=RUNTIMES, ids=IDS)
def cluster(request):
    rt = request.param
    _shutdown_all()
    c = _mod(rt, "cluster_utils").Cluster(
        head_node_args={"num_cpus": 4, "resources": {"alpha": 4}})
    try:
        second = c.add_node(num_cpus=4, resources={"beta": 4})
        c.connect()
        c.wait_for_nodes(2)
        yield rt, c, second
    finally:
        c.shutdown()


def _adder(rt):
    @rt.remote
    class Adder:
        def __init__(self, inc):
            self.inc = inc
            self.calls = 0

        def add(self, x):
            self.calls += 1
            return x + self.inc

        def add2(self, x, y):
            return x + y

        def boom(self, x):
            raise ValueError(f"boom on {x}")

        def get_calls(self):
            return self.calls

    return Adder


def _compiled(dag, body):
    compiled = dag.experimental_compile()
    try:
        return body(compiled)
    finally:
        compiled.teardown()


def d_chain_pipelines(rt, c, second):
    Adder, InputNode = _adder(rt), _mod(rt, "dag").InputNode
    a, b = Adder.remote(1), Adder.remote(10)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    got = _compiled(dag, lambda cd: [r.get(timeout=WAIT_S)
                                     for r in [cd.execute(i) for i in range(5)]])
    # Same instance across iterations; read after teardown, once the actor
    # is back in normal call service.
    return got, rt.get(a.get_calls.remote(), timeout=WAIT_S)


def d_fan_out_fan_in(rt, c, second):
    Adder, InputNode = _adder(rt), _mod(rt, "dag").InputNode
    a, b, z = Adder.remote(1), Adder.remote(2), Adder.remote(0)
    with InputNode() as inp:
        dag = z.add2.bind(a.add.bind(inp), b.add.bind(inp))
    return _compiled(dag, lambda cd: [cd.execute(10).get(timeout=WAIT_S),
                                      cd.execute(0).get(timeout=WAIT_S)])


def d_multi_output(rt, c, second):
    Adder, dag_mod = _adder(rt), _mod(rt, "dag")
    a, b = Adder.remote(1), Adder.remote(2)
    with dag_mod.InputNode() as inp:
        dag = dag_mod.MultiOutputNode([a.add.bind(inp), b.add.bind(inp)])
    return _compiled(dag, lambda cd: cd.execute(5).get(timeout=WAIT_S))


def d_exception_propagates_and_dag_survives(rt, c, second):
    Adder, InputNode = _adder(rt), _mod(rt, "dag").InputNode
    a, b = Adder.remote(1), Adder.remote(0)
    with InputNode() as inp:
        dag = b.add.bind(a.boom.bind(inp))
    return _compiled(dag, lambda cd: [_error(lambda: cd.execute(3).get(timeout=WAIT_S)),
                                      _error(lambda: cd.execute(4).get(timeout=WAIT_S))])


def d_actor_usable_after_teardown(rt, c, second):
    Adder, InputNode = _adder(rt), _mod(rt, "dag").InputNode
    a = Adder.remote(1)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    first = _compiled(dag, lambda cd: cd.execute(1).get(timeout=WAIT_S))
    return first, rt.get(a.add.remote(5), timeout=WAIT_S)


def d_out_of_order_get(rt, c, second):
    Adder, InputNode = _adder(rt), _mod(rt, "dag").InputNode
    a = Adder.remote(1)
    with InputNode() as inp:
        dag = a.add.bind(inp)

    def body(cd):
        r0, r1 = cd.execute(0), cd.execute(1)
        later = r1.get(timeout=WAIT_S)
        return later, r0.get(timeout=WAIT_S), _error(lambda: r0.get(timeout=WAIT_S))

    return _compiled(dag, body)


def d_function_node_chain(rt, c, second):
    InputNode = _mod(rt, "dag").InputNode

    @rt.remote
    def double(x):
        return x * 2

    @rt.remote
    def inc(x):
        return x + 1

    with InputNode() as inp:
        dag = inc.bind(double.bind(inp))
    return _compiled(dag, lambda cd: [r.get(timeout=WAIT_S)
                                      for r in [cd.execute(i) for i in range(5)]])


def d_mixed_actor_and_function_stages(rt, c, second):
    Adder, InputNode = _adder(rt), _mod(rt, "dag").InputNode
    a = Adder.remote(10)

    @rt.remote
    def halve(x):
        return x // 2

    with InputNode() as inp:
        dag = halve.bind(a.add.bind(inp))
    return _compiled(dag, lambda cd: [cd.execute(4).get(timeout=WAIT_S),
                                      cd.execute(0).get(timeout=WAIT_S)])


def d_function_stage_exception_propagates(rt, c, second):
    InputNode = _mod(rt, "dag").InputNode

    @rt.remote
    def kaboom(x):
        if x < 0:
            raise RuntimeError(f"kaboom {x}")
        return x

    with InputNode() as inp:
        dag = kaboom.bind(inp)

    def body(cd):
        err = _error(lambda: cd.execute(-3).get(timeout=WAIT_S))
        # A TaskError-wrapped failure: its type and the message's last line.
        return (cd.execute(1).get(timeout=WAIT_S), err[0],
                err[1].strip().splitlines()[-1], cd.execute(2).get(timeout=WAIT_S))

    return _compiled(dag, body)


def d_teardown_timeout_surfaces_stragglers(rt, c, second):
    InputNode = _mod(rt, "dag").InputNode
    cfg = _mod(rt, "core.config").get_config()

    @rt.remote
    class Sleeper:
        def slow(self, x):
            time.sleep(3)
            return x

    s = Sleeper.remote()
    with InputNode() as inp:
        dag = s.slow.bind(inp)
    compiled = dag.experimental_compile()
    compiled.execute(1)
    time.sleep(0.5)               # the loop is inside slow() now
    old = cfg.dag_teardown_timeout_s
    cfg.dag_teardown_timeout_s = 0.2
    try:
        return _error(compiled.teardown)
    finally:
        cfg.dag_teardown_timeout_s = old


def d_rejects_two_methods_of_same_actor(rt, c, second):
    Adder, InputNode = _adder(rt), _mod(rt, "dag").InputNode
    a = Adder.remote(1)
    with InputNode() as inp:
        dag = a.add.bind(a.add.bind(inp))
    kind, msg = _error(dag.experimental_compile)
    return kind, msg.split(" on ")[0]


def d_spans_two_nodes(rt, c, second):
    InputNode = _mod(rt, "dag").InputNode

    @rt.remote(resources={"beta": 1})
    def double(x):                      # pinned to the second node
        return x * 2

    @rt.remote(resources={"alpha": 1})
    def inc(x):                         # pinned to the driver's node
        return x + 1

    with InputNode() as inp:
        dag = inc.bind(double.bind(inp))

    def body(cd):
        nodes = {name.rsplit(".", 1)[-1]: lane.node_id == second.node_id
                 for name, lane in cd._stage_lanes}
        remote_ring = any(r["daemon"] is not None for r in cd._rings)
        got = [r.get(timeout=WAIT_S) for r in [cd.execute(i) for i in range(6)]]
        r0, r1 = cd.execute(10), cd.execute(11)
        return nodes, remote_ring, got, r1.get(timeout=WAIT_S), r0.get(timeout=WAIT_S)

    return _compiled(dag, body)


def d_cross_node_lane_stage_death_is_clean(rt, c, second):
    InputNode = _mod(rt, "dag").InputNode

    @rt.remote(resources={"beta": 1})
    def fragile(x):
        import os
        if x == "die":
            os._exit(1)
        return x

    with InputNode() as inp:
        dag = fragile.bind(inp)
    compiled = dag.experimental_compile()
    try:
        ok = compiled.execute("ok").get(timeout=WAIT_S)
        ref = compiled.execute("die")
        died = _error(lambda: ref.get(timeout=60)) is not None
    finally:
        compiled.teardown()

    @rt.remote(resources={"beta": 1})
    def ping():
        return "pong"

    return ok, died, rt.get(ping.remote(), timeout=WAIT_S)


COMPILED = {"chain_pipelines": d_chain_pipelines,
            "fan_out_fan_in": d_fan_out_fan_in,
            "multi_output": d_multi_output,
            "exception_propagates_and_dag_survives": d_exception_propagates_and_dag_survives,
            "actor_usable_after_teardown": d_actor_usable_after_teardown,
            "out_of_order_get": d_out_of_order_get,
            "function_node_chain": d_function_node_chain,
            "mixed_actor_and_function_stages": d_mixed_actor_and_function_stages,
            "function_stage_exception_propagates": d_function_stage_exception_propagates,
            "teardown_timeout_surfaces_stragglers": d_teardown_timeout_surfaces_stragglers,
            "rejects_two_methods_of_same_actor": d_rejects_two_methods_of_same_actor,
            "spans_two_nodes": d_spans_two_nodes,
            "cross_node_lane_stage_death_is_clean": d_cross_node_lane_stage_death_is_clean}

WANT = {"chain_pipelines": ([11, 12, 13, 14, 15], 5),
        "fan_out_fan_in": [23, 3],
        "multi_output": [6, 7],
        "exception_propagates_and_dag_survives": [("ValueError", "boom on 3"),
                                                  ("ValueError", "boom on 4")],
        "actor_usable_after_teardown": (2, 6),
        "out_of_order_get": (2, 1, ("ValueError", "CompiledDAGRef.get() already consumed")),
        "function_node_chain": [1, 3, 5, 7, 9],
        "mixed_actor_and_function_stages": [7, 5],
        "function_stage_exception_propagates": (1, "RuntimeError", "kaboom -3", 2),
        "teardown_timeout_surfaces_stragglers": (
            "RuntimeError", "compiled DAG teardown: 1 stage loop(s) still running after "
            "0.2s (slow); raise RAY_TPU_DAG_TEARDOWN_TIMEOUT_S to wait longer"),
        "rejects_two_methods_of_same_actor": (
            "ValueError", "compiled DAG binds two methods of the same actor ('add' and 'add'"),
        "spans_two_nodes": ({"double": True, "inc": False}, True,
                            [1, 3, 5, 7, 9, 11], 23, 21),
        "cross_node_lane_stage_death_is_clean": ("ok", True, "pong")}


@pytest.mark.parametrize("name", list(COMPILED))
def test_compiled_dag_matches_jax(cluster, name):
    rt, c, second = cluster
    got = COMPILED[name](rt, c, second)
    assert got == WANT[name], got
    _agree(name, rt, got)


# -- the slice as a whole -------------------------------------------------------

def _slice_inputs():
    cfg = dataclasses.replace(jax_configs.TINY, compute_dtype=jnp.float32)
    mesh = build_mesh(MeshConfig(fsdp=-1), devices=jax.devices()[:1])
    params = jax_make_train_step(cfg, mesh)[0](jax.random.key(0)).params
    return jax.tree.map(np.asarray, params)


def _jax_trainer(rt):
    @rt.remote(resources={"alpha": 1})
    class Trainer:
        """TINY's JAX train step on weights given as host arrays."""

        def __init__(self, params):
            import dataclasses

            import jax
            import jax.numpy as jnp

            from ray_tpu.models import configs
            from ray_tpu.models.training import default_optimizer, make_train_step
            from ray_tpu.parallel import MeshConfig, build_mesh

            cfg = dataclasses.replace(configs.TINY, compute_dtype=jnp.float32)
            mesh = build_mesh(MeshConfig(fsdp=-1), devices=jax.devices()[:1])
            init_fn, self._step = make_train_step(
                cfg, mesh, optimizer=default_optimizer(1e-2, warmup=2, total_steps=10))
            state = init_fn(jax.random.key(0))
            self.state = dataclasses.replace(state, params=jax.tree.map(
                lambda p, w: jnp.asarray(w, p.dtype), state.params, params))

        def step(self, tokens):
            import jax.numpy as jnp

            self.state, m = self._step(self.state, {"tokens": jnp.asarray(tokens)})
            return float(m["loss"])

    return Trainer


def _port_trainer(rt):
    @rt.remote(resources={"alpha": 1})
    class Trainer:
        """The port's TINY train step on the CPU, the weights carried by
        `jax_bridge`; the kernel wrappers run their plain versions."""

        def __init__(self, params):
            import dataclasses

            import torch

            from ray_tpu_torch.models import configs
            from ray_tpu_torch.models.jax_bridge import params_from_jax
            from ray_tpu_torch.models.training import default_optimizer, make_train_step

            cfg = dataclasses.replace(configs.TINY, compute_dtype=torch.float32)
            init_fn, self._step = make_train_step(
                cfg, device="cpu",
                optimizer=default_optimizer(1e-2, warmup=2, total_steps=10))
            self.state = init_fn(params=params_from_jax(params, cfg, device="cpu"))

        def step(self, tokens):
            self.state, m = self._step(self.state, {"tokens": tokens})
            return float(m["loss"])

    return Trainer


def test_tiny_train_step_through_a_compiled_dag_matches_jax(cluster):
    """InputNode (a batch index) -> a FunctionNode on the second node that
    makes the batch with numpy -> TINY's step in an actor on the head ->
    the loss, 3 steps; JAX's through JAX's DAG, the port's through the
    port's, fp32 losses within 1e-5."""
    rt, c, second = cluster
    InputNode = _mod(rt, "dag").InputNode
    vocab = jax_configs.TINY.vocab_size

    @rt.remote(resources={"beta": 1})
    def make_batch(i):
        import numpy as np

        return np.random.default_rng([0, i]).integers(0, vocab, (4, 33), dtype=np.int32)

    trainer = (_jax_trainer if rt is ray_tpu else _port_trainer)(rt).remote(_slice_inputs())
    with InputNode() as inp:
        dag = trainer.step.bind(make_batch.bind(inp))
    losses = _compiled(dag, lambda cd: [cd.execute(i).get(timeout=300) for i in range(3)])
    assert all(np.isfinite(losses)), losses
    if rt is ray_tpu:
        RECORD["tiny"] = losses
    else:
        assert "tiny" in RECORD, "JAX's case records the losses first"
        assert losses == pytest.approx(RECORD["tiny"], rel=LOSS_REL)
    rt.kill(trainer)
