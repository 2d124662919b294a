"""The ray-tpu:// client, node chaos and a GCS restart: ray_tpu_torch against
ray_tpu on one cluster of each, on the CPU.

Each runtime starts one two-node `cluster_utils.Cluster` for this file (a
durable GCS, short health-check knobs), never both at once, and a client
proxy process (`python -m <package>.util.client.server`) that hosts a
driver on it. The scenarios of tests/test_client.py, a GCS kill and restart
(test_gcs_fault_tolerance.py's first case) and the node-level chaos
injectors of `util/chaos.py` run through both and must agree: JAX's run
records what it got, the port's run is held to the record.
"""
import importlib
import os
import subprocess
import sys
import time

import pytest

import ray_tpu
import ray_tpu_torch

RUNTIMES = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]
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


@pytest.fixture(scope="module", params=RUNTIMES, ids=IDS)
def cluster(request, tmp_path_factory):
    rt = request.param
    # A JAX runtime left initialised by an earlier module of this worker
    # (ROADMAP C's init() leak) is shut down before this file starts one.
    for other in RUNTIMES:
        if other.is_initialized():
            other.shutdown()
    saved = {k: os.environ.get(k) for k in FAST_HEALTH}
    os.environ.update(FAST_HEALTH)
    driver = _mod(rt, "core.distributed.driver")
    c = _mod(rt, "cluster_utils").Cluster(
        head_node_args={"num_cpus": 4},
        gcs_storage_dir=str(tmp_path_factory.mktemp("gcs")))
    proxy = None
    try:
        second = c.add_node(num_cpus=2, resources={"side": 1.0})
        proxy = subprocess.Popen(
            [sys.executable, "-m", f"{rt.__name__}.util.client.server",
             "--address", c.address, "--port", "0"],
            stdout=subprocess.PIPE, env=driver.child_env())
        info = driver._read_handshake(
            proxy, r"CLIENT_PROXY_PORT=(?P<port>\d+)", "client proxy")
        yield rt, c, second, f"ray-tpu://127.0.0.1:{info['port']}"
    finally:
        if proxy is not None:
            proxy.terminate()
            proxy.wait(timeout=10)
        c.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_client_allowlist_equals_jax():
    jax_server = importlib.import_module("ray_tpu.util.client.server")
    port_server = importlib.import_module("ray_tpu_torch.util.client.server")
    assert port_server.ALLOWED == jax_server.ALLOWED


def test_client_tasks_actors_objects(cluster):
    """test_client.py's scenario through `init("ray-tpu://...")`."""
    rt, _, second, address = cluster
    worker = rt.init(address=address)
    got = []
    try:
        assert type(worker).__name__ == "ClientWorker"

        @rt.remote
        def double(x):
            return x * 2

        got.append(rt.get(double.remote(21), timeout=60))
        # objects round-trip by value; refs stay owned by the proxy
        ref = rt.put({"a": [1, 2, 3]})
        got.append(rt.get(ref, timeout=30))
        # chained refs resolve server-side
        got.append(rt.get(double.remote(rt.put(10)), timeout=30))

        @rt.remote(resources={"side": 0.5})
        def where():
            return rt.get_runtime_context().get_node_id()

        got.append(rt.get(where.remote(), timeout=60) == second.node_id)

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        c = Counter.options(name="client_counter").remote()
        got += [rt.get(c.incr.remote(), timeout=60) for _ in range(2)]
        # named-actor lookup through the client
        got.append(rt.get(rt.get_actor("client_counter").incr.remote(),
                          timeout=60))
        # cluster introspection
        got.append(rt.cluster_resources().get("CPU"))
        got.append(sum(n["Alive"] for n in rt.nodes()))
        rt.kill(c)

        # A streaming submission cannot cross the proxy: refused before
        # it is submitted, as JAX's client refuses it.
        @rt.remote(num_returns="streaming")
        def stream():
            yield 1

        with pytest.raises(NotImplementedError, match="streaming"):
            stream.remote()
    finally:
        rt.shutdown()
    _agree("client", rt, got)
    assert got == [42, {"a": [1, 2, 3]}, 20, True, 1, 2, 3, 6.0, 2]


def test_client_through_the_address_variable(cluster, monkeypatch):
    rt, _, _, address = cluster
    monkeypatch.setenv("RAY_TPU_ADDRESS", address)
    config = _mod(rt, "core.config")
    config.reset_config()
    try:
        worker = rt.init()
        value = rt.get(rt.put(b"x" * 300_000), timeout=60)
        got = (type(worker).__name__, len(value))
    finally:
        rt.shutdown()
        monkeypatch.delenv("RAY_TPU_ADDRESS")
        config.reset_config()
    assert _agree("client_env", rt, got) == ("ClientWorker", 300_000)


def test_gcs_restart_preserves_state_and_serves(cluster):
    """test_gcs_fault_tolerance.py's first case: a KV entry and a detached
    actor's state survive a GCS kill and restart, and new work runs."""
    rt, c, _, _ = cluster
    c.connect()
    w = rt.api._global_worker()
    w.kv_put(b"app", b"cfg", b"v1")

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    counter = Counter.options(name="ft_counter", lifetime="detached").remote()
    got = [rt.get(counter.incr.remote(), timeout=60)]
    c.kill_gcs()
    time.sleep(1.0)
    c.restart_gcs()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            if sum(n["Alive"] for n in rt.nodes()) == 2:
                break
        except Exception:  # noqa: BLE001 reconnecting
            pass
        time.sleep(0.5)
    got.append(sum(n["Alive"] for n in rt.nodes()))
    got.append(w.kv_get(b"app", b"cfg"))
    got.append(rt.get(rt.get_actor("ft_counter").incr.remote(), timeout=60))

    @rt.remote
    def f(x):
        return x * 3

    got.append(rt.get(f.remote(7), timeout=60))
    rt.kill(counter)
    assert _agree("gcs_restart", rt, got) == [1, 2, b"v1", 2, 21]


def _alive_ids(rt):
    return {n["NodeID"] for n in rt.nodes() if n["Alive"]}


def _wait(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def test_delayed_partition_silences_a_node_until_healed(cluster):
    """DelayedPartition SIGSTOPs the second node's daemon: the GCS declares
    it dead within the short health-check window, and heal() resumes the
    process (which the dead verdict does not bring back)."""
    rt, c, second, _ = cluster
    chaos = _mod(rt, "util.chaos")
    part = chaos.DelayedPartition(second, delay_s=0.2).start()
    assert part.partitioned.wait(10)
    dead = _wait(lambda: second.node_id not in _alive_ids(rt), 30)
    part.stop()
    resumed = _wait(lambda: open(f"/proc/{second.proc.pid}/stat").read()
                    .rsplit(")", 1)[1].split()[0] in "SR", 10)
    assert _agree("partition", rt, (dead, resumed)) == (True, True)
    c.remove_node(second)


def test_node_killer_kills_non_head_nodes_only(cluster):
    rt, c, _, _ = cluster
    chaos = _mod(rt, "util.chaos")
    extra = [c.add_node(num_cpus=1) for _ in range(2)]
    c.wait_for_nodes(3)
    killer = chaos.NodeKiller(c, interval_s=0.1, seed=3, max_kills=2).start()
    assert _wait(lambda: len(killer.kills) == 2, 30)
    kills = killer.stop()
    dead = _wait(lambda: not (set(kills) & _alive_ids(rt)), 30)
    got = (len(kills), sorted(kills) == sorted(n.node_id for n in extra),
           c.head.node_id in _alive_ids(rt), dead, len(c.nodes))
    assert _agree("node_killer", rt, got) == (2, True, True, True, 1)
