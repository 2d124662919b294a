"""Node providers: the cloud abstraction under the autoscaler. The port's
copy of `ray_tpu/autoscaler/node_provider.py`: a fake node's accelerator
is `num_gpus`, passed to the port's `start_node_daemon_process`, and each
GPU lease on it gets its own card. As in the port's `cluster_utils`, a
node with no `num_gpus` runs no GPU probe and starts with
`CUDA_VISIBLE_DEVICES=""`, so it never opens a context on a card that a
GPU node of the same host holds.

Analogue of the reference `NodeProvider` plugin interface
(ref: python/ray/autoscaler/node_provider.py:13) and its fake multi-node
test provider (ref: autoscaler/_private/fake_multi_node/node_provider.py),
which the reference uses to exercise real autoscaling logic without a
cloud. Ours does the same: `FakeMultiNodeProvider` launches genuine node
daemons as local processes, so scale-up actually adds schedulable capacity.
"""
from __future__ import annotations

import abc
import threading
import time
import uuid
from typing import Dict, Optional


class Instance:
    """One provider-managed VM/host."""

    def __init__(self, instance_id: str, node_type: str):
        self.instance_id = instance_id
        self.node_type = node_type
        self.ray_node_id: Optional[str] = None   # set once the daemon is up
        self.launched_at = time.monotonic()

    def as_dict(self) -> dict:
        return {
            "instance_id": self.instance_id,
            "node_type": self.node_type,
            "ray_node_id": self.ray_node_id,
            "launched_at": self.launched_at,
        }


class NodeProvider(abc.ABC):
    """Minimal provider surface the autoscaler needs. Real deployments
    implement this against a cloud's GPU instance pools; tests use
    FakeMultiNodeProvider."""

    @abc.abstractmethod
    def create_node(self, node_type: str, node_config: dict) -> str:
        """Launch one instance; returns an instance id immediately (the
        instance may still be booting)."""

    @abc.abstractmethod
    def terminate_node(self, instance_id: str) -> None:
        ...

    @abc.abstractmethod
    def non_terminated_nodes(self) -> Dict[str, Instance]:
        """instance_id -> Instance for every live/booting instance."""


class FakeMultiNodeProvider(NodeProvider):
    """Launches real node-daemon processes on this host (one per fake
    instance). `node_config` keys: num_cpus, num_gpus, resources, env,
    object_store_memory — same knobs as Cluster.add_node."""

    def __init__(self, gcs_address: str):
        self.gcs_address = gcs_address
        self._lock = threading.Lock()
        self._instances: Dict[str, Instance] = {}
        self._procs: Dict[str, object] = {}

    def create_node(self, node_type: str, node_config: dict) -> str:
        from ray_tpu_torch.core.distributed.driver import start_node_daemon_process

        instance_id = f"fake-{uuid.uuid4().hex[:12]}"
        inst = Instance(instance_id, node_type)
        num_gpus = node_config.get("num_gpus") or 0
        env = dict(node_config.get("env") or {})
        if not num_gpus:
            env.setdefault("CUDA_VISIBLE_DEVICES", "")
        proc, info = start_node_daemon_process(
            self.gcs_address,
            num_cpus=node_config.get("num_cpus"),
            num_gpus=num_gpus,
            resources=node_config.get("resources"),
            object_store_memory=node_config.get("object_store_memory", 0),
            extra_env=env)
        inst.ray_node_id = info["node_id"]
        with self._lock:
            self._instances[instance_id] = inst
            self._procs[instance_id] = proc
        return instance_id

    def terminate_node(self, instance_id: str) -> None:
        with self._lock:
            inst = self._instances.pop(instance_id, None)
            proc = self._procs.pop(instance_id, None)
        if inst is None:
            return
        try:
            proc.terminate()
            proc.wait(timeout=5)
        except Exception:  # noqa: BLE001
            try:
                proc.kill()
            except Exception:  # noqa: BLE001
                pass

    def non_terminated_nodes(self) -> Dict[str, Instance]:
        with self._lock:
            return dict(self._instances)

    def shutdown(self) -> None:
        for iid in list(self.non_terminated_nodes()):
            self.terminate_node(iid)
