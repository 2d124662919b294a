"""Cluster launcher: `ray-tpu up/down <cluster.yaml>`. The port's copy of
`ray_tpu/autoscaler/launcher.py`: provider `fake` (local node daemons)
works; `gcp` and `sim-gcp`, which drive GCP TPU VMs, are out of the
port's scope and refused. The head's accelerator is "GPU" (none: no
probe, as `cluster_utils` starts a node without cards). State lives under
the port's own ``~/.ray_tpu_torch/clusters``, so `down` never reaps a
cluster the JAX package launched.

Analogue of the reference cluster launcher
(ref: python/ray/autoscaler/_private/commands.py create_or_update_cluster
/ teardown_cluster, schema autoscaler/ray-schema.json). A cluster YAML:

    cluster_name: demo
    provider:
      type: fake           # local node daemons
    max_workers: 8
    idle_timeout_minutes: 1
    head_node_type: head
    available_node_types:
      head:
        resources: {"CPU": 4}
        min_workers: 0
        max_workers: 0
      gpu_host:
        resources: {"CPU": 4, "GPU": 1}
        min_workers: 0
        max_workers: 4

`up` starts the head (GCS + head node daemon) on THIS machine, builds the
provider, and runs the autoscaler monitor; `down` terminates provider
instances and the head. State (addresses, pids) lands in
``~/.ray_tpu_torch/clusters/<name>.json`` so `down`/`status` find the cluster
without re-parsing flags (ref: cluster state under ~/.ray in the
reference).
"""
from __future__ import annotations

import json
import logging
import os
import signal
import time
from typing import Dict, Optional

from ray_tpu_torch.autoscaler.autoscaler import NodeTypeConfig, StandardAutoscaler
from ray_tpu_torch.autoscaler.monitor import AutoscalerMonitor

logger = logging.getLogger(__name__)

STATE_DIR = os.path.expanduser("~/.ray_tpu_torch/clusters")


def load_cluster_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    for key in ("cluster_name", "provider", "available_node_types"):
        if key not in cfg:
            raise ValueError(f"cluster config missing required key {key!r}")
    if cfg["provider"].get("type") not in ("gcp", "sim-gcp", "fake"):
        raise ValueError(
            f"unknown provider type {cfg['provider'].get('type')!r} "
            "(expected gcp | sim-gcp | fake)")
    head_type = cfg.get("head_node_type")
    if head_type and head_type not in cfg["available_node_types"]:
        raise ValueError(f"head_node_type {head_type!r} not in "
                         "available_node_types")
    return cfg


GCP_REFUSAL = ("provider type {!r} launches GCP TPU VMs, which are out of "
               "ray_tpu_torch's scope: use provider type 'fake' (local "
               "GPU node daemons)")


def build_provider(cfg: dict, gcs_address: str):
    ptype = cfg["provider"]["type"]
    if ptype == "fake":
        from ray_tpu_torch.autoscaler.node_provider import FakeMultiNodeProvider

        return FakeMultiNodeProvider(gcs_address)
    raise ValueError(GCP_REFUSAL.format(ptype))


def _node_types(cfg: dict) -> Dict[str, NodeTypeConfig]:
    head_type = cfg.get("head_node_type")
    out = {}
    for name, spec in cfg["available_node_types"].items():
        if name == head_type:
            continue  # the head is launcher-managed, never autoscaled
        out[name] = NodeTypeConfig(
            resources=dict(spec.get("resources", {})),
            min_workers=int(spec.get("min_workers", 0)),
            max_workers=int(spec.get("max_workers",
                                     cfg.get("max_workers", 0))),
            node_config=dict(spec.get("node_config", {})))
    return out


class ClusterLauncher:
    """In-process cluster lifecycle — the engine under `ray-tpu up/down`,
    used directly by tests (no detached processes to leak)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.gcs_proc = None
        self.head_proc = None
        self.gcs_address: Optional[str] = None
        self.provider = None
        self.monitor: Optional[AutoscalerMonitor] = None

    def up(self) -> str:
        from ray_tpu_torch.core.distributed.driver import (
            start_gcs_process,
            start_node_daemon_process,
        )

        head_type = self.cfg.get("head_node_type")
        head_spec = (self.cfg["available_node_types"].get(head_type, {})
                     if head_type else {})
        head_res = dict(head_spec.get("resources", {"CPU": 2}))
        # Refuse an out-of-scope provider before any process starts.
        if self.cfg["provider"]["type"] != "fake":
            build_provider(self.cfg, "")
        self.gcs_proc, self.gcs_address = start_gcs_process()
        num_gpus = head_res.pop("GPU", 0)
        self.head_proc, _ = start_node_daemon_process(
            self.gcs_address,
            num_cpus=head_res.pop("CPU", 2),
            num_gpus=num_gpus,
            resources=head_res or None,
            extra_env=None if num_gpus else {"CUDA_VISIBLE_DEVICES": ""})
        self.provider = build_provider(self.cfg, self.gcs_address)
        autoscaler = StandardAutoscaler(
            self.gcs_address, self.provider, _node_types(self.cfg),
            idle_timeout_s=60.0 * float(
                self.cfg.get("idle_timeout_minutes", 1)))
        self.monitor = AutoscalerMonitor(
            autoscaler,
            interval_s=float(self.cfg.get("update_interval_s", 2.0)))
        self.monitor.start()
        self._save_state()
        logger.info("cluster %s up at %s", self.cfg["cluster_name"],
                    self.gcs_address)
        return self.gcs_address

    def down(self) -> None:
        if self.monitor is not None:
            self.monitor.stop()
            self.monitor = None
        if self.provider is not None:
            try:
                self.provider.shutdown()
            except Exception:  # noqa: BLE001
                pass
            self.provider = None
        for proc in (self.head_proc, self.gcs_proc):
            if proc is None:
                continue
            try:
                proc.terminate()
                proc.wait(timeout=5)
            except Exception:  # noqa: BLE001
                try:
                    proc.kill()
                except Exception:  # noqa: BLE001
                    pass
        self.head_proc = self.gcs_proc = None
        _remove_state(self.cfg["cluster_name"])

    # -- state file -----------------------------------------------------
    def _save_state(self) -> None:
        os.makedirs(STATE_DIR, mode=0o700, exist_ok=True)
        with open(_state_path(self.cfg["cluster_name"]), "w") as f:
            json.dump({
                "cluster_name": self.cfg["cluster_name"],
                "gcs_address": self.gcs_address,
                "gcs_pid": self.gcs_proc.pid if self.gcs_proc else None,
                "head_pid": self.head_proc.pid if self.head_proc else None,
                "launcher_pid": os.getpid(),
                "config": self.cfg,
                "ts": time.time(),
            }, f, indent=2)


def _state_path(name: str) -> str:
    return os.path.join(STATE_DIR, f"{name}.json")


def _remove_state(name: str) -> None:
    try:
        os.unlink(_state_path(name))
    except OSError:
        pass


def cluster_up(config_path: str, block: bool = True) -> ClusterLauncher:
    """`ray-tpu up`: start head + autoscaler. With block=True (the CLI)
    the launcher keeps running — the monitor thread IS the autoscaler —
    until SIGINT/SIGTERM, then tears the cluster down."""
    launcher = ClusterLauncher(load_cluster_config(config_path))
    address = launcher.up()
    print(f"cluster {launcher.cfg['cluster_name']} up; "
          f"connect with ray_tpu_torch.init(address={address!r})")
    if not block:
        return launcher
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    print("shutting down cluster...")
    launcher.down()
    return launcher


def spawn_detached_launcher(config_path: str, wait_s: float = 60.0) -> str:
    """`ray-tpu up --no-block`: run the blocking launcher in a detached
    child process (its own session — it must survive the CLI exiting;
    the GCS/head it spawns carry PDEATHSIG tied to IT, so `down` or
    killing the launcher still reaps the whole cluster). Returns the GCS
    address once the state file appears."""
    import subprocess
    import sys

    cfg = load_cluster_config(config_path)
    path = _state_path(cfg["cluster_name"])
    # A SIGKILL'd previous launcher leaves its state file behind; without
    # this the poll below would return the DEAD cluster's address. But a
    # LIVE launcher with the same name must not be silently orphaned —
    # deleting its state would put it beyond `ray-tpu down`'s reach.
    try:
        with open(path) as f:
            prev = json.load(f)
        prev_pid = prev.get("launcher_pid")
        if prev_pid:
            try:
                os.kill(prev_pid, 0)
                alive = True
            except ProcessLookupError:
                alive = False
            except PermissionError:
                alive = True  # pid exists, owned by another user
            if alive:
                raise RuntimeError(
                    f"cluster {cfg['cluster_name']!r} is already up "
                    f"(launcher pid {prev_pid}); run `ray-tpu down` "
                    "first")
    except (OSError, ValueError, KeyError):
        pass  # no state file / unreadable stale state
    _remove_state(cfg["cluster_name"])
    from ray_tpu_torch.core.distributed.driver import child_env

    os.makedirs(STATE_DIR, mode=0o700, exist_ok=True)
    log_path = os.path.join(STATE_DIR,
                            f"{cfg['cluster_name']}.launcher.log")
    spawned_at = time.time()
    with open(log_path, "ab") as logf:
        subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.autoscaler.launcher",
             config_path],
            start_new_session=True, env=child_env(),
            stdout=logf, stderr=logf)
    deadline = spawned_at + wait_s
    while time.time() < deadline:
        try:
            with open(path) as f:
                state = json.load(f)
            if state.get("ts", 0) >= spawned_at:
                return state["gcs_address"]
        except (OSError, ValueError, KeyError):
            pass
        time.sleep(0.25)
    raise RuntimeError(
        f"detached launcher produced no state file at {path} in "
        f"{wait_s}s; see {log_path}")


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.autoscaler.launcher",
        description="blocking cluster launcher (used detached by "
                    "`ray-tpu up --no-block`)")
    p.add_argument("config")
    args = p.parse_args(argv)
    cluster_up(args.config, block=True)


def cluster_down(config_path_or_name: str) -> None:
    """`ray-tpu down`: tear down instances + head recorded in the state
    file (works from a different process than `up`)."""
    name = config_path_or_name
    if os.path.exists(name):
        name = load_cluster_config(name)["cluster_name"]
    path = _state_path(name)
    if not os.path.exists(path):
        print(f"no state for cluster {name!r} under {STATE_DIR}")
        return
    with open(path) as f:
        state = json.load(f)
    # Only `fake` clusters come up in the port: their node daemons die
    # with the launcher that started them.
    for pid_key in ("launcher_pid", "head_pid", "gcs_pid"):
        pid = state.get(pid_key)
        if pid and pid != os.getpid():
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
    _remove_state(name)
    print(f"cluster {name} down")


if __name__ == "__main__":
    main()
