"""Autoscaler monitor loop + local autoscaling test cluster. The port's
copy of `ray_tpu/autoscaler/monitor.py`: the head's and the node types'
accelerator is "GPU", passed to the daemons as `num_gpus`; a head with
no "GPU" is started as `cluster_utils` starts a node without cards (no
probe, `CUDA_VISIBLE_DEVICES=""`).

Analogue of the reference monitor process (ref: python/ray/autoscaler/
_private/monitor.py — periodically drives StandardAutoscaler.update) and
of `ray.cluster_utils.AutoscalingCluster` (ref: cluster_utils.py:26 —
real autoscaler against the fake node provider, so scaling logic is
testable on one machine).
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from ray_tpu_torch.autoscaler.autoscaler import NodeTypeConfig, StandardAutoscaler
from ray_tpu_torch.autoscaler.node_provider import (
    FakeMultiNodeProvider,
    NodeProvider,
)

logger = logging.getLogger(__name__)


class AutoscalerMonitor:
    """Background thread calling autoscaler.update() every interval."""

    def __init__(self, autoscaler: StandardAutoscaler,
                 interval_s: float = 5.0):
        self.autoscaler = autoscaler
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="autoscaler-monitor")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.autoscaler.update()
            except Exception as e:  # noqa: BLE001
                logger.warning("autoscaler update failed: %s", e)
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.autoscaler.close()


class AutoscalingCluster:
    """A local cluster whose worker nodes appear/disappear on demand:
    GCS + head daemon + StandardAutoscaler over FakeMultiNodeProvider.

    worker_node_types: name -> {"resources": {...}, "node_config": {...},
    "min_workers": int, "max_workers": int}.
    """

    def __init__(
        self,
        head_resources: Optional[Dict[str, float]] = None,
        worker_node_types: Optional[Dict[str, dict]] = None,
        *,
        idle_timeout_s: float = 30.0,
        update_interval_s: float = 2.0,
        launch_timeout_s: float = 120.0,
    ):
        from ray_tpu_torch.core.distributed.driver import (
            start_gcs_process,
            start_node_daemon_process,
        )

        head_resources = head_resources or {"CPU": 1}
        self.gcs_proc, self.gcs_address = start_gcs_process()
        num_cpus = head_resources.pop("CPU", 1)
        num_gpus = head_resources.pop("GPU", 0)
        self.head_proc, self.head_info = start_node_daemon_process(
            self.gcs_address, num_cpus=num_cpus, num_gpus=num_gpus,
            resources=head_resources or None,
            extra_env=None if num_gpus else {"CUDA_VISIBLE_DEVICES": ""})

        self.provider = FakeMultiNodeProvider(self.gcs_address)
        node_types = {}
        for name, spec in (worker_node_types or {}).items():
            res = dict(spec.get("resources", {}))
            node_config = dict(spec.get("node_config", {}))
            node_config.setdefault("num_cpus", res.get("CPU", 1))
            if "GPU" in res:
                node_config.setdefault("num_gpus", res["GPU"])
            custom = {k: v for k, v in res.items()
                      if k not in ("CPU", "GPU", "memory")}
            if custom:
                node_config.setdefault("resources", custom)
            node_types[name] = NodeTypeConfig(
                resources=res,
                min_workers=spec.get("min_workers", 0),
                max_workers=spec.get("max_workers", 0),
                node_config=node_config)
        self.autoscaler = StandardAutoscaler(
            self.gcs_address, self.provider, node_types,
            idle_timeout_s=idle_timeout_s,
            launch_timeout_s=launch_timeout_s)
        self.monitor = AutoscalerMonitor(self.autoscaler,
                                         interval_s=update_interval_s)
        self.monitor.start()

    @property
    def address(self) -> str:
        return self.gcs_address

    def connect(self, **kwargs):
        import ray_tpu_torch

        return ray_tpu_torch.init(address=self.gcs_address, **kwargs)

    def shutdown(self) -> None:
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        self.monitor.stop()
        self.provider.shutdown()
        for proc in (self.head_proc, self.gcs_proc):
            try:
                proc.terminate()
                proc.wait(timeout=5)
            except Exception:  # noqa: BLE001
                try:
                    proc.kill()
                except Exception:  # noqa: BLE001
                    pass
