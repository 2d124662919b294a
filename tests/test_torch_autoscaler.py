"""The autoscaler of ray_tpu_torch against ray_tpu's on live clusters, on the
CPU: `AutoscalingCluster` over `FakeMultiNodeProvider` (real node daemons
launched and terminated on demand) and the cluster launcher.

Each scenario runs on one runtime's cluster, then on the other's, never
both at once (both runtimes are shut down before each cluster starts):
JAX's run records what it got, the port's run is held to the record. The
scenarios are tests/test_autoscaler.py's three: a STRICT_SPREAD gang scales
1 -> 4 -> 1 nodes; `request_resources` scales without load and holds its
floor past the idle timeout; the monitor replaces a worker killed behind
the provider's back. A record holds the launch and terminate decisions
(the node types the provider was asked to create, the number it
terminated) and the node counts the scenario waits for, which are the same
in both runs whatever the timing. Nothing is numeric beyond counts, so
there is no tolerance. tests/test_torch_autoscaler_launcher.py holds an
accelerator demand and the cluster launcher to JAX's the same way.
"""
import importlib
import time

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


def _shutdown_all():
    for other in RUNTIMES:
        if other.is_initialized():
            other.shutdown()


class _Decisions:
    """The provider's create/terminate calls, in order."""

    def __init__(self, provider):
        self.created, self.terminated = [], 0
        create, terminate = provider.create_node, provider.terminate_node

        def create_node(node_type, node_config):
            self.created.append(node_type)
            return create(node_type, node_config)

        def terminate_node(instance_id):
            if instance_id in provider.non_terminated_nodes():
                self.terminated += 1
            return terminate(instance_id)

        provider.create_node, provider.terminate_node = create_node, terminate_node


def _cluster(rt, worker_types, **kw):
    _shutdown_all()
    cluster = _mod(rt, "autoscaler").AutoscalingCluster(
        head_resources={"CPU": 1}, worker_node_types=worker_types, **kw)
    decisions = _Decisions(cluster.provider)
    cluster.connect()
    return cluster, decisions


def _wait_alive(rt, count, timeout=90, cond=None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        alive = [n for n in rt.nodes() if n["Alive"] and (cond is None or cond(n))]
        if len(alive) == count:
            return count
        time.sleep(0.5)
    return len(alive)


@pytest.mark.parametrize("rt", RUNTIMES, ids=IDS)
def test_autoscaling_cluster_scales_up_and_down(rt):
    pg_mod = _mod(rt, "util.placement_group")
    strategies = _mod(rt, "util.scheduling_strategies")
    cluster, decisions = _cluster(
        rt, {"worker": {"resources": {"CPU": 2}, "min_workers": 0, "max_workers": 3}},
        idle_timeout_s=3.0, update_interval_s=0.5)
    try:
        pg = pg_mod.placement_group([{"CPU": 2}] * 3, strategy="STRICT_SPREAD")
        formed = pg.wait(timeout_seconds=90)
        up = len([n for n in rt.nodes() if n["Alive"]])

        @rt.remote(num_cpus=2)
        def who():
            return rt.get_runtime_context().get_node_id()

        ids = rt.get([who.options(scheduling_strategy=strategies.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=i)).remote()
            for i in range(3)], timeout=60)
        pg_mod.remove_placement_group(pg)
        down = _wait_alive(rt, 1, timeout=60)
        got = (formed, up, len(set(ids)), down, decisions.created, decisions.terminated)
    finally:
        cluster.shutdown()
    assert _agree("scale", rt, got) == (True, 4, 3, 1, ["worker"] * 3, 3)


@pytest.mark.parametrize("rt", RUNTIMES, ids=IDS)
def test_request_resources_scales_without_load(rt):
    sdk = _mod(rt, "autoscaler.sdk")
    cluster, decisions = _cluster(
        rt, {"worker": {"resources": {"CPU": 2}, "min_workers": 0, "max_workers": 2}},
        idle_timeout_s=2.0, update_interval_s=0.5)
    try:
        sdk.request_resources(bundles=[{"CPU": 2}, {"CPU": 2}])
        up = _wait_alive(rt, 3, timeout=60)
        time.sleep(4)    # past the idle timeout: the request's floor holds
        held = len([n for n in rt.nodes() if n["Alive"]])
        sdk.request_resources(bundles=[])
        down = _wait_alive(rt, 1, timeout=60)
        got = (up, held, down, decisions.created, decisions.terminated)
    finally:
        cluster.shutdown()
    assert _agree("request_resources", rt, got) == (3, 3, 1, ["worker"] * 2, 2)


@pytest.mark.parametrize("rt", RUNTIMES, ids=IDS)
def test_monitor_relaunches_a_preempted_node(rt):
    sdk = _mod(rt, "autoscaler.sdk")
    cluster, decisions = _cluster(
        rt, {"worker": {"resources": {"CPU": 2}, "min_workers": 0, "max_workers": 3}},
        idle_timeout_s=300.0, update_interval_s=0.5, launch_timeout_s=8.0)

    def workers(n):
        return n["Resources"].get("CPU") == 2.0

    try:
        sdk.request_resources(bundles=[{"CPU": 2.0}, {"CPU": 2.0}])
        floor = _wait_alive(rt, 2, cond=workers)
        victim = next(iter(cluster.provider.non_terminated_nodes()))
        cluster.provider._procs[victim].kill()
        dead_seen = False
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            nodes = rt.nodes()
            dead_seen = dead_seen or any(not n["Alive"] for n in nodes)
            live = [n for n in nodes if n["Alive"] and workers(n)]
            if (dead_seen and len(live) >= 2
                    and victim not in cluster.provider.non_terminated_nodes()):
                break
            time.sleep(0.5)
        got = (floor, dead_seen, victim in cluster.provider.non_terminated_nodes(),
               len(live) >= 2, decisions.created, decisions.terminated)
    finally:
        try:
            sdk.request_resources(bundles=[])
        except Exception:  # noqa: BLE001
            pass
        cluster.shutdown()
    assert _agree("preempted", rt, got) == (2, True, False, True, ["worker"] * 3, 1)
