"""Several nodes on one host: ray_tpu_torch's `cluster_utils.Cluster` against
ray_tpu's, on the CPU.

Each runtime starts one cluster for this file (a head with 2 CPUs and a
second node with 4 CPUs, a custom resource and 4 faked accelerators: GPUs
for the port, TPUs for JAX), never both at once, with short health-check
knobs so a killed node is declared dead within seconds. The scenarios of
tests/test_multi_node.py, test_lineage.py:104-167 and
test_gang_atomicity.py:174 run through both and must agree where their
outcomes compare: where a task lands (by resource), the bytes that cross
nodes, `cluster_resources()` and `available_resources()` sums, the error
class after a node dies, reconstructed values. JAX's run records what it
got, the port's run is held to the record.

The port's own contract rides along: a GPU lease is granted card ids (two
concurrent leases never share one, a 2-GPU lease sees two, ids come back
after a kill, a pooled worker never changes the cards it sees), and a
removed node leaves no process behind. The in-process harnesses of
`virtual_node.py` (the transfer plane across real daemons, the syncer
across a virtual cluster) run for both packages.
"""
import asyncio
import importlib
import os
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

RUNTIMES = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]
# Each runtime's accelerator: the add_node keyword and the resource.
ACCEL = {ray_tpu: ("num_tpus", "TPU"), ray_tpu_torch: ("num_gpus", "GPU")}
RECORD = {}
FAST_HEALTH = {"RAY_TPU_HEALTH_CHECK_PERIOD_MS": "500",
               "RAY_TPU_HEALTH_CHECK_FAILURE_THRESHOLD": "3"}


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
    # A JAX runtime left initialised by an earlier module of this worker
    # (ROADMAP C's init() leak) is shut down before this file starts one.
    for other in RUNTIMES:
        if other.is_initialized():
            other.shutdown()


@pytest.fixture(scope="module", params=RUNTIMES, ids=IDS)
def cluster(request):
    rt = request.param
    _shutdown_all()
    saved = {k: os.environ.get(k) for k in FAST_HEALTH}
    os.environ.update(FAST_HEALTH)
    kw, _ = ACCEL[rt]
    c = _mod(rt, "cluster_utils").Cluster(head_node_args={"num_cpus": 2})
    try:
        second = c.add_node(num_cpus=4, resources={"side": 1.0}, **{kw: 4})
        c.connect()
        c.wait_for_nodes(2)
        yield rt, c, second
    finally:
        c.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _alive(rt):
    return sorted(n["NodeID"] for n in rt.nodes() if n["Alive"])


def _wait_alive(rt, count, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(_alive(rt)) == count:
            return True
        time.sleep(0.2)
    return False


def _affinity(rt, node_id, soft=False):
    strategies = _mod(rt, "util.scheduling_strategies")
    return strategies.NodeAffinitySchedulingStrategy(node_id, soft=soft)


# -- test_multi_node.py -------------------------------------------------------

def test_cluster_sees_both_nodes(cluster):
    rt, _, _ = cluster
    res = rt.cluster_resources()
    accel = ACCEL[rt][1]
    _agree("resources", rt, (res["CPU"], res.get("side"), res.get(accel)))
    assert res["CPU"] == 6.0 and res.get(accel) == 4.0


def test_task_runs_on_custom_resource_node(cluster):
    rt, _, second = cluster

    @rt.remote(resources={"side": 0.5})
    def where():
        return rt.get_runtime_context().get_node_id()

    assert _agree("custom", rt, rt.get(where.remote(), timeout=120)
                  == second.node_id)


def test_cross_node_object_transfer(cluster):
    rt, c, second = cluster
    payload = np.arange(2_000_000, dtype=np.float64)  # 16 MB, chunked pull

    @rt.remote(resources={"side": 0.5})
    def produce():
        return np.arange(2_000_000, dtype=np.float64)

    @rt.remote(num_cpus=1, scheduling_strategy=_affinity(rt, c.head.node_id))
    def consume(arr):
        return float(arr.sum()), arr.nbytes

    ref = produce.remote()
    # The driver pulls from the second node's store over the chunk stream,
    # then a task on the head reads the same object.
    arr = rt.get(ref, timeout=120)
    np.testing.assert_array_equal(arr, payload)
    got = rt.get(consume.remote(ref), timeout=120)
    assert _agree("transfer", rt, got) == (float(payload.sum()), 16_000_000)


def test_spread_placement_group_across_nodes(cluster):
    rt, _, _ = cluster
    pgmod = _mod(rt, "util.placement_group")
    strategies = _mod(rt, "util.scheduling_strategies")
    pg = pgmod.placement_group([{"CPU": 1}, {"CPU": 1}],
                               strategy="STRICT_SPREAD")
    assert pg.ready(timeout=60)

    @rt.remote(num_cpus=1)
    def where():
        return rt.get_runtime_context().get_node_id()

    nodes = rt.get([
        where.options(
            scheduling_strategy=strategies.PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=i)
        ).remote()
        for i in range(2)
    ], timeout=180)
    _agree("spread", rt, len(set(nodes)))
    assert len(set(nodes)) == 2
    pgmod.remove_placement_group(pg)


# -- a card per lease (the port's contract; placement compared with JAX) -----

def test_accelerator_leases_get_their_own_cards(cluster):
    """Two concurrent 1-accelerator actors, then a 2-accelerator one, all on
    the second node; available accelerators fall to 0 and come back after a
    kill. The port's workers see distinct CUDA_VISIBLE_DEVICES ids, the
    2-GPU one two of them, and a new actor gets the killed one's id."""
    rt, _, second = cluster
    kw, accel = ACCEL[rt]

    def make(n):
        @rt.remote(**{kw: n})
        class Holder:
            def where(self):
                ids = (rt.get_runtime_context().get_gpu_ids()
                       if rt is ray_tpu_torch else None)
                return (rt.get_runtime_context().get_node_id(),
                        os.environ.get("CUDA_VISIBLE_DEVICES"), ids)
        return Holder

    one, two = make(1), make(2)
    a, b, c2 = one.remote(), one.remote(), two.remote()
    seen = rt.get([a.where.remote(), b.where.remote(), c2.where.remote()],
                  timeout=120)
    deadline = time.monotonic() + 10
    while (rt.available_resources().get(accel, 0.0) > 0
           and time.monotonic() < deadline):
        time.sleep(0.1)
    left = rt.available_resources().get(accel, 0.0)
    rt.kill(a)
    deadline = time.monotonic() + 30
    while (rt.available_resources().get(accel, 0.0) < 1
           and time.monotonic() < deadline):
        time.sleep(0.1)
    back = rt.available_resources().get(accel, 0.0)
    d = one.remote()
    after = rt.get(d.where.remote(), timeout=120)
    _agree("leases", rt, ([s[0] == second.node_id for s in seen + [after]],
                          left, back))
    assert left == 0.0 and back == 1.0
    if rt is ray_tpu_torch:
        ids = [s[1] for s in seen]
        singles = sorted(ids[:2])
        pair = ids[2].split(",")
        assert len(pair) == 2 and len(set(singles + pair)) == 4, ids
        assert sorted(singles + pair) == ["0", "1", "2", "3"], ids
        assert after[1] == seen[0][1], (after, seen)   # a's card, returned
        assert all(s[2] == [int(i) for i in s[1].split(",")]
                   for s in seen + [after]), seen
    for h in (b, c2, d):
        rt.kill(h)


def test_a_pooled_worker_never_changes_its_cards(cluster):
    """Tasks of one and of no GPU in turns on the second node: each worker
    process serves only one visible set (the pool is keyed by it), and a
    task without GPUs sees the node's own view."""
    rt, _, second = cluster
    kw, _ = ACCEL[rt]
    on_second = _affinity(rt, second.node_id)

    @rt.remote(num_cpus=0, scheduling_strategy=on_second)
    def probe():
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    with_card = probe.options(**{kw: 1})
    refs = []
    for _ in range(4):
        refs += [with_card.remote(), with_card.remote(), probe.remote()]
    got = rt.get(refs, timeout=120)
    _agree("pool", rt, len(got))
    if rt is ray_tpu_torch:
        by_pid = {}
        for pid, visible in got:
            by_pid.setdefault(pid, set()).add(visible)
        assert all(len(v) == 1 for v in by_pid.values()), by_pid
        carded = [v for i, (_, v) in enumerate(got) if i % 3 != 2]
        plain = [v for i, (_, v) in enumerate(got) if i % 3 == 2]
        assert all(v in ("0", "1", "2", "3") for v in carded), got
        assert set(plain) == {None}, got


def test_a_scoped_node_grants_the_cards_it_sees(cluster):
    """A node started with CUDA_VISIBLE_DEVICES "2,3" and 2 accelerators:
    its leases' ids index those cards, so a 1-accelerator actor sees host
    card 2 or 3, never 0 or 1."""
    rt, c, _ = cluster
    kw, accel = ACCEL[rt]
    scoped = c.add_node(num_cpus=1, resources={"scoped": 1.0},
                        env={"CUDA_VISIBLE_DEVICES": "2,3"}, **{kw: 2})
    c.wait_for_nodes(3)

    @rt.remote(resources={"scoped": 0.5}, **{kw: 1})
    class OnScoped:
        def where(self):
            return (rt.get_runtime_context().get_node_id(),
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

    a, b = OnScoped.remote(), OnScoped.remote()
    got = rt.get([a.where.remote(), b.where.remote()], timeout=120)
    _agree("scoped", rt, [g[0] == scoped.node_id for g in got])
    assert all(g[0] == scoped.node_id for g in got)
    if rt is ray_tpu_torch:
        assert sorted(g[1] for g in got) == ["2", "3"], got
    for h in (a, b):
        rt.kill(h)
    c.remove_node(scoped)
    assert _wait_alive(rt, 2)


# -- node loss ----------------------------------------------------------------

def _node_pids(rt, node):
    """The port's daemon's worker and zygote pids."""
    rpc = _mod(rt, "core.distributed.rpc")
    w = rt.api._global_worker()
    client = rpc.SyncRpcClient(node.address, w.loop_thread)
    try:
        workers = client.call("NodeDaemon", "list_workers", timeout=10)
        zyg = client.call("NodeDaemon", "zygote_state", timeout=10)
    finally:
        client.close()
    return ([x["pid"] for x in workers if x["alive"]]
            + [z["pid"] for z in zyg["zygotes"] if z["alive"]])


def _gone(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except OSError:
        return True


def test_node_failure_detected_and_leaves_no_process(cluster):
    rt, c, _ = cluster
    third = c.add_node(num_cpus=1, resources={"doomed": 1.0})
    c.wait_for_nodes(3)

    @rt.remote(resources={"doomed": 1.0})
    def pid():
        return os.getpid()

    worker = rt.get(pid.remote(), timeout=120)
    pids = ({worker} | set(_node_pids(rt, third))
            if rt is ray_tpu_torch else set())
    c.remove_node(third)  # SIGKILL
    assert _agree("node_death", rt, _wait_alive(rt, 2))
    if rt is ray_tpu_torch:
        # Its zygote and workers fate-share with the killed daemon.
        deadline = time.monotonic() + 30
        while (not all(_gone(p) for p in pids)
               and time.monotonic() < deadline):
            time.sleep(0.2)
        assert all(_gone(p) for p in pids), [p for p in pids
                                             if not _gone(p)]


def test_lost_objects_are_reconstructed(cluster):
    """test_lineage.py:104-167: an object whose only copy died with its
    node is recomputed by get(), and so is one whose lost dependency must
    be recomputed first."""
    rt, c, _ = cluster
    doomed = c.add_node(num_cpus=1, resources={"recon": 1.0})
    c.wait_for_nodes(3)
    on_doomed = _affinity(rt, doomed.node_id, soft=True)

    @rt.remote(num_cpus=1, scheduling_strategy=on_doomed)
    def produce():
        # > max_inline_object_size (100 KiB): lives only in its store.
        return np.full(300_000, 7.0)

    @rt.remote(num_cpus=1, scheduling_strategy=on_doomed)
    def base():
        return np.arange(200_000, dtype=np.float64)

    @rt.remote(num_cpus=1, scheduling_strategy=on_doomed)
    def double(arr):
        return arr * 2.0

    @rt.remote(num_cpus=1, scheduling_strategy=on_doomed)
    def peek(arr):
        return float(arr[1])

    ref = produce.remote()
    d = double.remote(base.remote())
    # Read on the doomed node itself so the driver caches no copy.
    assert rt.get([peek.remote(ref), peek.remote(d)], timeout=120) == [7.0,
                                                                       2.0]
    c.remove_node(doomed)
    assert _wait_alive(rt, 2)
    arr = rt.get(ref, timeout=120)
    out = rt.get(d, timeout=120)
    np.testing.assert_array_equal(arr, np.full(300_000, 7.0))
    np.testing.assert_array_equal(out, np.arange(200_000) * 2.0)
    _agree("lineage", rt, (float(arr.sum()), float(out.sum())))


def test_actor_on_a_dead_node_raises_actor_died(cluster):
    rt, c, _ = cluster
    doomed = c.add_node(num_cpus=1, resources={"host": 1.0})
    c.wait_for_nodes(3)

    @rt.remote(resources={"host": 1.0}, max_restarts=0)
    class Pinned:
        def ping(self):
            return "pong"

    a = Pinned.remote()
    assert rt.get(a.ping.remote(), timeout=120) == "pong"
    c.remove_node(doomed)
    assert _wait_alive(rt, 2)
    deadline = time.monotonic() + 60
    err = None
    while time.monotonic() < deadline:
        try:
            rt.get(a.ping.remote(), timeout=10)
        except rt.exceptions.ActorDiedError as e:
            err = e
            break
        except (rt.exceptions.ActorUnavailableError,
                rt.exceptions.GetTimeoutError):
            time.sleep(0.2)
    _agree("actor_died", rt, type(err).__name__)
    assert err is not None


def _pg_info(rt, pg):
    return rt.api._global_worker().get_placement_group(pg.id)


def test_node_death_punches_hole_and_repairs(cluster):
    """test_gang_atomicity.py:174: losing one node of a CREATED
    STRICT_SPREAD gang demotes it to PENDING with the survivor bundle still
    placed, and a replacement node restores CREATED around the survivor."""
    rt, c, _ = cluster
    pgmod = _mod(rt, "util.placement_group")
    doomed = c.add_node(num_cpus=1, resources={"gang": 1.0})
    spare = c.add_node(num_cpus=1, resources={"gang": 1.0})
    c.wait_for_nodes(4)
    pg = pgmod.placement_group([{"gang": 1.0}] * 2, strategy="STRICT_SPREAD")
    assert pg.ready(timeout=60)
    assert sorted(_pg_info(rt, pg)["nodes"]) == sorted(
        [doomed.node_id, spare.node_id])
    c.remove_node(doomed)  # SIGKILL
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        info = _pg_info(rt, pg)
        if info["state"] == "PENDING":
            break
        time.sleep(0.25)
    holes = (info["state"], info["placed"],
             [n for n in info["nodes"] if n is not None] == [spare.node_id])
    replacement = c.add_node(num_cpus=1, resources={"gang": 1.0})
    assert pg.ready(timeout=60)
    info = _pg_info(rt, pg)
    repaired = (info["placed"], sorted(info["nodes"]) == sorted(
        [spare.node_id, replacement.node_id]))
    _agree("gang", rt, (holes, repaired))
    assert holes == ("PENDING", 1, True) and repaired == (2, True)
    pgmod.remove_placement_group(pg)
    for node in (spare, replacement):
        c.remove_node(node)


# -- the in-process harnesses of virtual_node.py (both packages) --------------

def _run_inproc(coro_fn, timeout=120):
    return asyncio.run(asyncio.wait_for(coro_fn(), timeout))


@pytest.mark.parametrize("rt", RUNTIMES, ids=IDS)
def test_broadcast_tree_reaches_all_and_bounds_owner_uplink(rt):
    """1->8 broadcast over the relay tree between real daemons: every one
    seals an identical copy, the owner serves only its fanout of 2, and
    every receiver takes in exactly one copy."""
    _shutdown_all()
    vn = _mod(rt, "core.distributed.virtual_node")
    AsyncRpcClient = _mod(rt, "core.distributed.rpc").AsyncRpcClient
    ObjectID = _mod(rt, "core.ids").ObjectID

    async def scenario():
        vc = vn.InProcDaemonCluster(9, store_capacity=64 << 20)
        await vc.start()
        try:
            owner, *rest = vc.daemons
            obj = os.urandom(8 * 1024 * 1024)
            oid = ObjectID(os.urandom(20))
            owner.store.put_raw(oid, obj)

            def node_bytes(metric, d):
                nid = ("node_id", d.node_id[:12])
                return sum(v for key, v in metric.samples() if nid in key)

            out_before = node_bytes(owner._m_xfer_out, owner)
            client = AsyncRpcClient(owner.server.address)
            try:
                rep = await client.call(
                    "NodeDaemon", "broadcast_object",
                    object_id=oid.binary(),
                    targets=[d.server.address for d in rest], timeout=120)
            finally:
                await client.close()
            assert rep["ok"] and rep["nodes"] == 8, rep
            for d in rest:
                buf = d.store.get_buffer(oid)
                assert bytes(buf.view) == obj
                buf.release()
                assert not d._recv_partials
            sent = node_bytes(owner._m_xfer_out, owner) - out_before
            total_in = sum(node_bytes(d._m_xfer_in, d) for d in rest)
            return sent <= 2 * len(obj) * 1.05, total_in == 8 * len(obj)
        finally:
            await vc.stop()

    assert _agree("broadcast", rt, _run_inproc(scenario)) == (True, True)
    cfg = _mod(rt, "core.config").get_config()
    assert cfg.zygote_enabled and cfg.worker_prestart_enabled  # restored


@pytest.mark.parametrize("rt", RUNTIMES, ids=IDS)
def test_replica_kill_mid_striped_pull_completes(rt):
    """A striped pull across two daemons that hold the object: one is
    stopped mid-transfer and the pull finishes from the other, bytes
    identical."""
    _shutdown_all()
    vn = _mod(rt, "core.distributed.virtual_node")
    transfer = _mod(rt, "core.distributed.transfer")
    AsyncRpcClient = _mod(rt, "core.distributed.rpc").AsyncRpcClient
    ObjectID = _mod(rt, "core.ids").ObjectID
    ObjectStore = _mod(rt, "core.object_store").ObjectStore
    cfg = _mod(rt, "core.config").get_config()

    async def scenario():
        import tempfile

        vc = vn.InProcDaemonCluster(2, store_capacity=128 << 20)
        await vc.start()
        path = tempfile.mkdtemp(prefix="xferstore_", dir="/dev/shm")
        store = ObjectStore(path, capacity=128 << 20)
        clients = {}
        try:
            d0, d1 = vc.daemons
            obj = os.urandom(12 * 1024 * 1024)
            oid = ObjectID(os.urandom(20))
            d0.store.put_raw(oid, obj)
            d1.store.put_raw(oid, obj)
            fetched = {"count": 0}

            async def fetch(addr, oid_b, off, ln, dest=None):
                if addr not in clients:
                    clients[addr] = AsyncRpcClient(addr)
                rep = await clients[addr].call(
                    "NodeDaemon", "get_object_chunk", object_id=oid_b,
                    offset=off, length=ln, timeout=10)
                if rep.get("missing"):
                    return None
                fetched["count"] += 1
                if fetched["count"] == 3:
                    await d0.server.stop(grace=0.1)
                return rep["total_size"], rep["data"]

            def open_sink(oid_b, total):
                return transfer.ChunkSink(
                    store.create_for_receive(ObjectID(oid_b), total), total)

            total, _ = await transfer.striped_pull(
                oid.binary(),
                [("n0", d0.server.address), ("n1", d1.server.address)],
                fetch, open_sink, chunk_bytes=1024 * 1024,
                window_bytes=cfg.transfer_window_bytes, per_source=2)
            buf = store.get_buffer(oid)
            same = bytes(buf.view) == obj
            buf.release()
            return total, same
        finally:
            for cl in clients.values():
                await cl.close()
            store.disconnect()
            ObjectStore.destroy(path)
            await vc.stop()

    assert _agree("striped", rt, _run_inproc(scenario)) == (12 << 20, True)


@pytest.mark.parametrize("rt", RUNTIMES, ids=IDS)
def test_virtual_cluster_delta_dominant_ratio(rt):
    """test_syncer.py's VirtualCluster case at 30 nodes: under churn the
    sync path stays delta-dominant, and the subscribers assemble the whole
    cluster from the fan-out."""
    _shutdown_all()
    vn = _mod(rt, "core.distributed.virtual_node")
    GcsServer = _mod(rt, "core.distributed.gcs_server").GcsServer

    async def run():
        gcs = GcsServer()
        port = await gcs.start()
        vc = vn.VirtualCluster(f"127.0.0.1:{port}", n_nodes=30,
                               num_clients=4, report_interval_s=0.05,
                               keepalive_s=1.0, subscribers=2, seed=3)
        await vc.start()
        try:
            for _ in range(4):
                vc.churn(0.5)
                await asyncio.sleep(0.1)
            deadline = time.monotonic() + 20
            while (gcs.syncer.stats()["applied_deltas"] < 4
                   and time.monotonic() < deadline):
                await asyncio.sleep(0.05)
            await asyncio.sleep(0.3)
            alive = sum(1 for n in gcs.nodes.view.nodes.values() if n.alive)
            stats = gcs.syncer.stats()
            agg = vc.aggregate_stats()
            delta_like = stats["applied_deltas"] + agg["suppressed"]
            return (alive, agg["errors"],
                    delta_like >= 2 * stats["applied_full"],
                    len(vc.nodes[0].view.nodes))
        finally:
            await vc.stop()
            await gcs.stop()

    assert _agree("virtual", rt, _run_inproc(run)) == (30, 0, True, 30)
