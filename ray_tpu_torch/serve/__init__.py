"""ray_tpu_torch.serve: online inference (counterpart of `ray_tpu.serve`;
reference: ray.serve).

Controller-reconciled replica sets as named detached actors, power-of-two
request routing, dynamic batching, HTTP ingress (a standard-library
asyncio server) and a native RPC ingress, request autoscaling, streaming
with exactly-once resume and shared-memory rails, serve observability,
and the disaggregated-serving plane (prefill actors, prefix registry, live
KV migration). Beside them, the fixed-slot and paged serving engines, the
block allocator with its object-store arena, and `LLMDeployment`, which
wraps an engine as a deployment. A deployment's `bind` is serve's own; the
task and actor DAGs are `ray_tpu_torch.dag`.
"""
from ray_tpu_torch.serve.api import (delete, get_app_handle,
                                     get_deployment_handle, http_port,
                                     rpc_ingress_port, run, shutdown,
                                     start_http_proxy, start_rpc_ingress,
                                     status)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config_deploy import deploy_config
from ray_tpu_torch.serve.deployment import (Application, AutoscalingConfig,
                                            Deployment, deployment)
from ray_tpu_torch.serve.handle import (DeploymentHandle, DeploymentResponse,
                                        StreamingResponse)
from ray_tpu_torch.exceptions import StreamQueueFullError
from ray_tpu_torch.serve.kv_cache import KVBlockAllocator, prefix_digest
from ray_tpu_torch.serve.multiplex import (get_multiplexed_model_id,
                                           multiplexed)

# The engines import torch: they load on first touch, so the control
# plane's processes (controller, proxy, replicas of plain callables)
# start without it.
_ENGINES = ("LLMDeployment", "LLMEngine", "PagedLLMEngine")


def __getattr__(name):
    if name in _ENGINES:
        from ray_tpu_torch.serve import llm

        return getattr(llm, name)
    raise AttributeError(
        f"module 'ray_tpu_torch.serve' has no attribute {name!r}")


__all__ = [
    "deployment", "Deployment", "Application", "AutoscalingConfig",
    "run", "shutdown", "status", "delete",
    "get_deployment_handle", "get_app_handle",
    "start_http_proxy", "http_port", "start_rpc_ingress",
    "rpc_ingress_port", "deploy_config",
    "DeploymentHandle", "DeploymentResponse", "StreamingResponse",
    "multiplexed", "get_multiplexed_model_id",
    "batch",
    "KVBlockAllocator", "LLMDeployment", "LLMEngine", "PagedLLMEngine",
    "StreamQueueFullError", "prefix_digest",
]

# Usage tagging (ref: usage_lib.record_library_usage; local-only,
# see ray_tpu_torch/util/usage_stats.py)
from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu

_rlu("serve")
del _rlu
