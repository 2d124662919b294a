"""The GPU host gang of ray_tpu_torch against ray_tpu's TPU slice gang, on the
CPU.

`util.placement_group.gpu_host_placement_group` is the counterpart of
`tpu_slice_placement_group`: one bundle per host, STRICT_SPREAD, ordered by
`ici_snake_order` through soft per-bundle labels (``GPU_WORKER_ID`` there,
``TPU_WORKER_ID`` in the JAX package, each set by the node daemon from its
environment). Each runtime starts one cluster for this file (a head without
accelerators and two hosts of 2 faked accelerators each, whose worker ids
are given through `add_node(env=...)`, as tests/test_tpu_topology.py
does), never both at once: JAX's run records what it got, the port's is
held to the record. The `util/gpu.py` helpers are held to the node view.
"""
import importlib
import os

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.core.distributed import accelerators

# Modules by name: each package's `util` exports a function of this name.
jax_pg = importlib.import_module("ray_tpu.util.placement_group")
port_pg = importlib.import_module("ray_tpu_torch.util.placement_group")

RUNTIMES = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]
RECORD = {}
# Host worker ids, in the order the hosts join: not the join order.
WORKER_IDS = (1, 0)
WAIT_S = 120


def _mod(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _agree(name, rt, got):
    if rt is ray_tpu:
        RECORD[name] = got
    elif name in RECORD:
        assert got == RECORD[name], (name, got, RECORD[name])
    return got


# -- no cluster ---------------------------------------------------------------

GRIDS = [(n, t) for n in (1, 2, 3, 4, 6, 8, 9, 16) for t in
         (None, "", "8", "1x1", "2x2", "4x2", "2x4", "4x4", "3x3", "4x", "axb", "0x4")]


@pytest.mark.parametrize("num_hosts", sorted({n for n, _ in GRIDS}))
def test_ici_snake_order_matches_jax(num_hosts):
    for n, topology in GRIDS:
        if n == num_hosts:
            got = _outcome(lambda: port_pg.ici_snake_order(n, topology))
            assert got == _outcome(lambda: jax_pg.ici_snake_order(n, topology)), \
                (n, topology)


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the case reports it
        return type(e).__name__, str(e)


@pytest.mark.parametrize("order", [[0, 0], [1, 2], [0], [2, 1, 0]])
def test_bundle_order_errors_match_jax(order):
    got = _outcome(lambda: port_pg.gpu_host_placement_group(
        2, bundle_order=lambda n, t: list(order)))
    want = _outcome(lambda: jax_pg.tpu_slice_placement_group(
        2, bundle_order=lambda n, t: list(order)))
    assert got == want and got[0] == "ValueError", (got, want)


@pytest.mark.parametrize("env,want", [({}, None), ({"GPU_WORKER_ID": "3"}, 3),
                                      ({"NODE_RANK": "2"}, None),
                                      ({"GPU_WORKER_ID": " 1 ", "NODE_RANK": "5"}, 1),
                                      ({"GPU_WORKER_ID": "x"}, None)])
def test_the_gpu_worker_id_comes_from_the_environment(monkeypatch, env, want):
    monkeypatch.delenv("GPU_WORKER_ID", raising=False)
    monkeypatch.delenv("NODE_RANK", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert accelerators.get_worker_id() == want


# -- on a cluster ---------------------------------------------------------------

def _host_args(rt, wid):
    if rt is ray_tpu:
        return {"num_tpus": 2, "env": {"TPU_WORKER_ID": str(wid),
                                       "RAY_TPU_DISABLE_TPU_DETECTION": "1"}}
    return {"num_gpus": 2, "resources": {"accelerator_type:H100": 1.0},
            "env": {"GPU_WORKER_ID": str(wid)}}


@pytest.fixture(scope="module", params=RUNTIMES, ids=IDS)
def cluster(request):
    rt = request.param
    for other in RUNTIMES:
        if other.is_initialized():
            other.shutdown()
    c = _mod(rt, "cluster_utils").Cluster(head_node_args={"num_cpus": 2})
    try:
        hosts = {c.add_node(num_cpus=2, **_host_args(rt, wid)).node_id: wid
                 for wid in WORKER_IDS}
        c.connect()
        c.wait_for_nodes(3)
        yield rt, c, hosts
    finally:
        c.shutdown()


def _gang(rt, per_host=2, **kw):
    pg = _mod(rt, "util.placement_group")
    if rt is ray_tpu:
        return pg.tpu_slice_placement_group(2, chips_per_host=per_host, **kw)
    return pg.gpu_host_placement_group(2, gpus_per_host=per_host, **kw)


def _bundle_nodes(rt, pg):
    return rt.api._global_worker().get_placement_group(pg.id)["nodes"]


@pytest.mark.parametrize("order", [None, [1, 0]])
def test_gang_lands_one_bundle_per_host_and_holds_them(cluster, order):
    """Bundle i on the host whose worker id is order[i]; a second gang stays
    pending until the first is removed."""
    rt, c, hosts = cluster
    remove = _mod(rt, "util.placement_group").remove_placement_group
    kw = {} if order is None else {"bundle_order": lambda n, t: list(order)}
    first = _gang(rt, **kw)
    assert first.ready(timeout=WAIT_S)
    placed = [hosts.get(n) for n in _bundle_nodes(rt, first)]
    second = _gang(rt, **kw)
    pending = not second.ready(timeout=2)
    remove(first)
    after = second.ready(timeout=WAIT_S)
    remove(second)
    got = _agree(f"gang {order}", rt, (placed, pending, after))
    assert got == ([0, 1] if order is None else order, True, True), got


def test_gangs_of_part_of_a_host_share_it(cluster):
    """STRICT_SPREAD keeps only one gang's bundles apart: two gangs of one
    card a host are both placed at once on the two 2-card hosts."""
    rt, c, hosts = cluster
    remove = _mod(rt, "util.placement_group").remove_placement_group
    gangs = [_gang(rt, per_host=1) for _ in range(2)]
    ready = [g.ready(timeout=WAIT_S) for g in gangs]
    placed = [sorted(hosts.get(n) for n in _bundle_nodes(rt, g)) for g in gangs]
    for g in gangs:
        remove(g)
    got = _agree("gangs of one card a host", rt, (ready, placed))
    assert got == ([True, True], [[0, 1], [0, 1]]), got


def test_one_card_bundles_give_distinct_devices(cluster):
    """Two one-card bundles packed on one host: the port's actors see one
    card each, never the same one."""
    rt, c, hosts = cluster
    pgmod = _mod(rt, "util.placement_group")
    strategies = _mod(rt, "util.scheduling_strategies")
    accel, var = (("TPU", "TPU_VISIBLE_CHIPS") if rt is ray_tpu
                  else ("GPU", "CUDA_VISIBLE_DEVICES"))
    pg = pgmod.placement_group([{"CPU": 1, accel: 1}] * 2, strategy="STRICT_PACK")
    assert pg.ready(timeout=WAIT_S)

    @rt.remote(num_cpus=1, resources={accel: 1})
    class Where:
        def env(self, name):
            import os

            return rt.get_runtime_context().get_node_id(), os.environ.get(name)

    actors = [Where.options(scheduling_strategy=strategies.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=i)).remote() for i in range(2)]
    seen = rt.get([a.env.remote(var) for a in actors], timeout=WAIT_S)
    for a in actors:
        rt.kill(a)
    pgmod.remove_placement_group(pg)
    nodes = {n for n, _ in seen}
    assert _agree("packed on one host", rt, len(nodes)) == 1
    assert nodes <= set(hosts)
    # The port's daemon grants each GPU lease card ids from its
    # ChipAllocator, bundles included; JAX's fake TPUs set no variable.
    if rt is ray_tpu_torch:
        assert sorted(v for _, v in seen) == ["0", "1"], seen


def test_gpu_helpers_read_the_node_view(cluster):
    """Each host's accelerator count, read in a task there, as JAX's
    `get_num_tpu_chips_on_node` reads it; then the port's other helpers:
    the hosts, their card model and worker id, and a host reservation."""
    rt, c, hosts = cluster
    strategies = _mod(rt, "util.scheduling_strategies")

    def jax_introspect():
        from ray_tpu.util import tpu

        return tpu.get_num_tpu_chips_on_node(), None, None

    def port_introspect():
        from ray_tpu_torch.util import gpu

        return (gpu.get_num_gpus_on_node(), gpu.get_current_accelerator_type(),
                gpu.get_current_worker_id())

    introspect = rt.remote(num_cpus=0)(jax_introspect if rt is ray_tpu else port_introspect)

    seen = {wid: rt.get(introspect.options(
        scheduling_strategy=strategies.NodeAffinitySchedulingStrategy(node_id, soft=False)
    ).remote(), timeout=WAIT_S) for node_id, wid in hosts.items()}
    _agree("accelerators on each host", rt, {wid: got[0] for wid, got in seen.items()})
    if rt is ray_tpu:
        return
    assert seen == {wid: (2, "H100", wid) for wid in WORKER_IDS}, seen
    from ray_tpu_torch.util import gpu

    found = gpu.list_hosts()
    assert sorted(h.node_id for h in found) == sorted(hosts)
    assert {(h.accelerator_type, h.num_gpus) for h in found} == {("H100", 2.0)}
    assert gpu.list_hosts("A100") == []

    gang = gpu.reserve_hosts(2, gpus_per_host=2, accelerator_type="H100",
                             topology="2x1", timeout=WAIT_S)
    try:
        assert [hosts[h.node_id] for h in gang.hosts] == [0, 1]
        with pytest.raises(TimeoutError):
            gpu.reserve_hosts(1, gpus_per_host=2, timeout=3)
        with pytest.raises(TimeoutError):
            gpu.reserve_hosts(1, gpus_per_host=1, accelerator_type="A100", timeout=3)
    finally:
        gang.release()
    again = gpu.reserve_hosts(1, gpus_per_host=2, timeout=WAIT_S)
    assert again.hosts[0].node_id in hosts
    again.release()
