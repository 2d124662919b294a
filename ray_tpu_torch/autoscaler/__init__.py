"""Autoscaler: demand-driven cluster scaling. The port's copy of
`ray_tpu/autoscaler/`, without its GCP TPU-VM provider (`gcp.py`): the
port launches GPU nodes through `FakeMultiNodeProvider` (local node
daemons), and its launcher refuses the `gcp` and `sim-gcp` providers.

Analogue of the reference autoscaler v2
(ref: python/ray/autoscaler/v2/ — instance_manager/, scheduler.py — driven
by the GCS AutoscalerStateService, src/ray/protobuf/autoscaler.proto:315).
Design split:

  NodeProvider        — cloud abstraction: create/terminate/list instances
                        (ref: autoscaler/node_provider.py:13)
  plan_scaling        — pure bin-packing of pending demand onto existing +
                        to-be-launched capacity (ref: v2/scheduler.py)
  StandardAutoscaler  — one reconciliation pass: read GCS autoscaler state,
                        launch what's missing, retire idle nodes
                        (ref: _private/autoscaler.py:172 StandardAutoscaler)
  AutoscalerMonitor   — the background loop (ref: _private/monitor.py)
  AutoscalingCluster  — local test harness over FakeMultiNodeProvider
                        (ref: cluster_utils.AutoscalingCluster:26)

A node type models one GPU host (`{"CPU": n, "GPU": k}`); gang demand
(STRICT_PACK placement groups, such as `util.gpu`'s host gang) scales
whole hosts at once.
"""
from ray_tpu_torch.autoscaler.autoscaler import (  # noqa: F401
    NodeTypeConfig,
    StandardAutoscaler,
)
from ray_tpu_torch.autoscaler.binpack import plan_scaling  # noqa: F401
from ray_tpu_torch.autoscaler.monitor import (  # noqa: F401
    AutoscalerMonitor,
    AutoscalingCluster,
)
from ray_tpu_torch.autoscaler.node_provider import (  # noqa: F401
    FakeMultiNodeProvider,
    NodeProvider,
)
from ray_tpu_torch.autoscaler.sdk import request_resources  # noqa: F401
from ray_tpu_torch.autoscaler.v2 import (  # noqa: F401
    AutoscalerV2,
    InstanceManager,
    InstanceRecord,
)
