"""Multi-node-on-one-host test cluster, counterpart of
`ray_tpu/cluster_utils.py` with GPUs in place of TPUs.

Analogue of the reference's `ray.cluster_utils.Cluster`
(ref: python/ray/cluster_utils.py:135 — add_node :201, remove_node :274):
N node daemons as separate processes on one machine, so multi-node
scheduling, transfer, and failure handling are testable without real hosts
(SURVEY §4's "single-host multi-raylet fake cluster"). Each daemon keeps its
own shared-memory store, log directory and runtime-env cache (all keyed by
its node id).

A node added with ``num_gpus=0`` (the default) runs no GPU probe and is
started with ``CUDA_VISIBLE_DEVICES=""``: it reports no GPU, and neither it
nor its workers can open a context on a card another node of the host
holds. A node with ``num_gpus=N`` grants ids 0..N-1 of the cards the host
shows it (its ``env`` may scope them) to its leases.
"""
from __future__ import annotations

import signal
import subprocess
import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.distributed.driver import (
    start_gcs_process,
    start_node_daemon_process,
)


class NodeHandle:
    def __init__(self, proc: subprocess.Popen, info: dict):
        self.proc = proc
        self.node_id = info["node_id"]
        self.address = info["address"]
        self.store_dir = info["store_dir"]


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None,
                 gcs_storage_dir: Optional[str] = None):
        self.gcs_storage_dir = gcs_storage_dir
        self.gcs_proc, self.gcs_address = start_gcs_process(
            storage_dir=gcs_storage_dir)
        self.nodes: List[NodeHandle] = []
        self.head: Optional[NodeHandle] = None
        if initialize_head:
            self.head = self.add_node(**(head_node_args or {}))

    def kill_gcs(self) -> None:
        """Hard-kill the GCS (fault-injection); restart_gcs() brings it
        back on the SAME port (ref: GCS fault-tolerance tests,
        test_gcs_fault_tolerance.py)."""
        self.gcs_proc.kill()
        self.gcs_proc.wait(timeout=10)

    def restart_gcs(self) -> None:
        host, port = self.gcs_address.rsplit(":", 1)
        self.gcs_proc, address = start_gcs_process(
            host=host, port=int(port),
            storage_dir=self.gcs_storage_dir)
        assert address == self.gcs_address

    @property
    def address(self) -> str:
        return self.gcs_address

    def add_node(self, *, num_cpus: float = 1, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: int = 256 * 1024 * 1024,
                 env: Optional[Dict[str, str]] = None) -> NodeHandle:
        """`env` seeds the daemon's environment (e.g. CUDA_VISIBLE_DEVICES
        to give this node a subset of the host's cards)."""
        env = dict(env or {})
        if not num_gpus:
            env.setdefault("CUDA_VISIBLE_DEVICES", "")
        proc, info = start_node_daemon_process(
            self.gcs_address, num_cpus=num_cpus,
            num_gpus=num_gpus if num_gpus else 0,
            resources=resources,
            object_store_memory=object_store_memory,
            extra_env=env)
        handle = NodeHandle(proc, info)
        self.nodes.append(handle)
        return handle

    def remove_node(self, node: NodeHandle,
                    allow_graceful: bool = False) -> None:
        """Kill a node daemon (SIGKILL unless graceful) — its workers detect
        the loss and fate-share; the GCS health check marks the node dead."""
        if allow_graceful:
            node.proc.send_signal(signal.SIGTERM)
        else:
            node.proc.kill()
        node.proc.wait(timeout=10)
        self.nodes.remove(node)

    def wait_for_nodes(self, count: Optional[int] = None,
                       timeout: float = 30.0) -> None:
        import ray_tpu_torch

        expect = count if count is not None else len(self.nodes)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = [n for n in ray_tpu_torch.nodes() if n["Alive"]]
            if len(alive) >= expect:
                return
            time.sleep(0.2)
        raise TimeoutError(f"cluster did not reach {expect} nodes")

    def connect(self, **kwargs):
        import ray_tpu_torch

        return ray_tpu_torch.init(address=self.gcs_address, **kwargs)

    def shutdown(self) -> None:
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        for node in list(self.nodes):
            try:
                node.proc.terminate()
            except Exception:  # noqa: BLE001
                pass
        for node in list(self.nodes):
            try:
                node.proc.wait(timeout=5)
            except Exception:  # noqa: BLE001
                node.proc.kill()
        try:
            self.gcs_proc.terminate()
            self.gcs_proc.wait(timeout=5)
        except Exception:  # noqa: BLE001
            self.gcs_proc.kill()
