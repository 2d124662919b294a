"""Ray-Client equivalent: drive a remote cluster from a thin client;
counterpart of `ray_tpu/util/client/`.

Analogue of the reference Ray Client (ref: python/ray/util/client/ —
ARCHITECTURE.md: "the server runs ray.init() and proxies"; server/
server.py:96 RayletServicer). The proxy server process holds ONE real
driver connection to the cluster; thin clients forward every driver-API
call to it over the same RPC framing the rest of the stack uses.
`ray_tpu_torch.init(address="ray-tpu://host:port")` selects this mode.
"""
from ray_tpu_torch.util.client.client import ClientWorker  # noqa: F401
from ray_tpu_torch.util.client.server import ClientProxyServer  # noqa: F401
