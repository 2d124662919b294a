"""An accelerator demand and the cluster launcher of ray_tpu_torch against
ray_tpu's, on the CPU, in the manner of tests/test_torch_autoscaler.py
(whose helpers this file uses: each scenario on one runtime's cluster, then
on the other's, JAX's run recorded and the port's held to the record).

The accelerator scenario: a `num_gpus=1` actor waits on a head without
accelerators until the autoscaler launches a one-card node for it, and that
node idles away once the actor is gone (JAX's `num_gpus` maps to its TPU
resource, the port's to a GPU; the port's node fakes one card, and the
actor's lease gets card 0). The record holds the head's accelerator count,
whether the actor left the head, the node count it ends at, and the
provider's create and terminate decisions.

Then the launcher: `load_cluster_config`'s validation errors
(tests/test_gcp_provider.py's test_launcher_config_validation), and a
`fake`-provider cluster brought up and down in process (`cluster_up` then
`down`) and detached (`spawn_detached_launcher` then `cluster_down`),
through both packages, with the messages and state files compared. The
port refuses `sim-gcp` and `gcp`, which drive GCP TPU VMs: that refusal is
tested on its own, before any process starts. Nothing is numeric beyond
counts, so there is no tolerance.
"""
import os
import subprocess
import time

import pytest

import ray_tpu
import ray_tpu_torch
from tests.test_torch_autoscaler import (IDS, RUNTIMES, _agree, _cluster, _mod,
                                         _shutdown_all, _wait_alive)

ACCEL = {ray_tpu: "TPU", ray_tpu_torch: "GPU"}


@pytest.mark.parametrize("rt", RUNTIMES, ids=IDS)
def test_an_accelerator_actor_gets_a_launched_node(rt):
    acc = ACCEL[rt]
    cluster, decisions = _cluster(
        rt, {"cpu_worker": {"resources": {"CPU": 2}, "max_workers": 1},
             "acc_worker": {"resources": {"CPU": 1, acc: 1}, "max_workers": 1}},
        idle_timeout_s=2.0, update_interval_s=0.5)
    try:
        head_acc = rt.cluster_resources().get(acc, 0)

        @rt.remote(num_gpus=1)
        class Holder:
            def where(self):
                import os

                return (rt.get_runtime_context().get_node_id(),
                        os.environ.get("CUDA_VISIBLE_DEVICES"))

        holder = Holder.remote()
        node_id, visible = rt.get(holder.where.remote(), timeout=120)
        placed = node_id != cluster.head_info["node_id"]
        rt.kill(holder)
        down = _wait_alive(rt, 1, timeout=60)
        got = (head_acc, placed, down, decisions.created, decisions.terminated)
    finally:
        cluster.shutdown()
    assert _agree("accelerator", rt, got) == (0, True, 1, ["acc_worker"], 1)
    if rt is ray_tpu_torch:
        assert visible == "0", visible


# -- the cluster launcher -------------------------------------------------------

def _launcher(rt):
    return _mod(rt, "autoscaler.launcher")


def test_launcher_config_validation(tmp_path):
    got = []
    for rt in RUNTIMES:
        bad = tmp_path / "bad.yaml"
        bad.write_text("cluster_name: x\nprovider: {type: aws}\navailable_node_types: {}\n")
        missing = tmp_path / "missing.yaml"
        missing.write_text("cluster_name: x\n")
        errors = []
        for path in (bad, missing):
            with pytest.raises(ValueError) as e:
                _launcher(rt).load_cluster_config(str(path))
            errors.append(str(e.value))
        got.append(errors)
    assert got[0] == got[1], got
    assert "provider type" in got[1][0] and "missing required" in got[1][1]


def test_the_port_refuses_gcp_providers(tmp_path):
    launcher = _launcher(ray_tpu_torch)
    for ptype in ("sim-gcp", "gcp"):
        cfg = tmp_path / f"{ptype}.yaml"
        cfg.write_text(f"cluster_name: refused\nprovider: {{type: {ptype}}}\n"
                       "available_node_types: {head: {resources: {CPU: 1}}}\n")
        loaded = launcher.load_cluster_config(str(cfg))
        with pytest.raises(ValueError, match="out of ray_tpu_torch's scope"):
            launcher.build_provider(loaded, "")
        cl = launcher.ClusterLauncher(loaded)
        with pytest.raises(ValueError, match=ptype):
            cl.up()
        assert cl.gcs_proc is None and cl.head_proc is None
        assert not os.path.exists(launcher._state_path("refused"))


FAKE_YAML = """
cluster_name: {name}
provider: {{type: fake}}
head_node_type: head
idle_timeout_minutes: 0.05
update_interval_s: 0.5
available_node_types:
  head: {{resources: {{CPU: 1}}}}
  worker: {{resources: {{CPU: 2}}, min_workers: 0, max_workers: 1}}
"""


@pytest.mark.parametrize("rt", RUNTIMES, ids=IDS)
def test_fake_cluster_up_and_down(rt, tmp_path, capsys):
    launcher_mod = _launcher(rt)
    name = f"fake-{rt.__name__.replace('_', '-')}"
    cfg = tmp_path / "c.yaml"
    cfg.write_text(FAKE_YAML.format(name=name))
    _shutdown_all()
    launcher = launcher_mod.cluster_up(str(cfg), block=False)
    try:
        state_there = os.path.exists(launcher_mod._state_path(name))
        rt.init(address=launcher.gcs_address)

        @rt.remote(num_cpus=2)
        def on_worker():
            return rt.get_runtime_context().get_node_id()

        ran = bool(rt.get(on_worker.remote(), timeout=120))
        launched = len(launcher.provider.non_terminated_nodes())
        rt.shutdown()
    finally:
        launcher.down()
    gone = not os.path.exists(launcher_mod._state_path(name))
    printed = capsys.readouterr().out.replace(launcher.gcs_address, "<addr>")
    printed = printed.replace(rt.__name__, "<rt>").replace(name, "<name>")
    got = (state_there, ran, launched, gone, printed)
    assert _agree("up_down", rt, got)[:4] == (True, True, 1, True)


@pytest.mark.parametrize("rt", RUNTIMES, ids=IDS)
def test_detached_up_then_down(rt, tmp_path, capsys):
    """`up --no-block`: the cluster outlives its caller in a detached
    launcher, and `down` reaps the whole tree."""
    launcher_mod = _launcher(rt)
    name = f"detached-{rt.__name__.replace('_', '-')}"
    cfg = tmp_path / "c.yaml"
    cfg.write_text(FAKE_YAML.format(name=name))
    _shutdown_all()
    address = launcher_mod.spawn_detached_launcher(str(cfg))
    try:
        rt.init(address=address)

        @rt.remote
        def ping():
            return "pong"

        pong = rt.get(ping.remote(), timeout=60)
        rt.shutdown()
    finally:
        launcher_mod.cluster_down(name)
    pattern = f"{rt.__name__}\\.autoscaler\\.launcher {cfg}"
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        left = subprocess.run(["pgrep", "-f", pattern], capture_output=True,
                              text=True).stdout.strip()
        if not left:
            break
        time.sleep(0.5)
    printed = capsys.readouterr().out.replace(name, "<name>")
    got = (pong, left, printed, os.path.exists(launcher_mod._state_path(name)))
    assert _agree("detached", rt, got) == ("pong", "", "cluster <name> down\n", False)


def test_a_node_under_a_live_actor_is_not_drained():
    """The port's claim alone: a node whose accelerator an actor holds is
    busy for as long as the actor lives, past the idle timeout, and is
    drained only once the actor is gone. JAX's GCS takes a node for idle
    when no report has come from it for the idle timeout, and its syncer
    reports changes only, so JAX drains the node under the actor (the
    actor dies with it): there is no JAX result to hold the port to."""
    rt = ray_tpu_torch
    cluster, decisions = _cluster(
        rt, {"gpu_worker": {"resources": {"CPU": 1, "GPU": 1}, "max_workers": 1}},
        idle_timeout_s=1.0, update_interval_s=0.25)
    try:
        @rt.remote(num_gpus=1)
        class Holder:
            def ping(self):
                return "pong"

        holder = Holder.remote()
        assert rt.get(holder.ping.remote(), timeout=120) == "pong"
        time.sleep(4.0)   # four idle timeouts with the card held
        assert rt.get(holder.ping.remote(), timeout=30) == "pong"
        held = (len(cluster.provider.non_terminated_nodes()), decisions.terminated)
        rt.kill(holder)
        down = _wait_alive(rt, 1, timeout=60)
    finally:
        cluster.shutdown()
    assert held == (1, 0) and down == 1 and decisions.terminated == 1, (held, down)
