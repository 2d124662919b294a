"""Thin client worker: the driver API forwarded to a ClientProxyServer;
counterpart of `ray_tpu/util/client/client.py`.

Analogue of the reference client-side worker (ref: util/client/worker.py
— Worker class proxying ray.* over gRPC). Implements the same duck type
as DistributedCoreWorker/LocalCoreWorker, so `ray_tpu_torch.remote/get/put/...`
work unchanged; every method is one `invoke` RPC. ObjectRefs and
ActorHandles travel by value (their ids), ownership stays with the proxy
server's driver.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

import cloudpickle


class _GcsShim:
    """worker.gcs.call(...) forwarded through the proxy (library
    internals — collectives, autoscaler sdk — use it directly)."""

    def __init__(self, client: "ClientWorker"):
        self._client = client

    def call(self, service: str, method: str,
             timeout: Optional[float] = None, **kwargs) -> Any:
        kwargs["timeout"] = timeout
        blob = self._client._rpc.call(
            "RayClient", "relay_gcs", svc=service, meth=method,
            kwargs_blob=cloudpickle.dumps(kwargs),
            timeout=None if timeout is None else timeout + 10)
        return pickle.loads(blob)


class ClientWorker:
    """Connected via ray_tpu_torch.init(address="ray-tpu://host:port")."""

    def __init__(self, address: str):
        from ray_tpu_torch.core.distributed.rpc import EventLoopThread, SyncRpcClient

        assert address.startswith("ray-tpu://")
        self.proxy_address = address[len("ray-tpu://"):]
        self.loop_thread = EventLoopThread("client")
        self._rpc = SyncRpcClient(self.proxy_address, self.loop_thread)
        info = self._invoke_raw("server_info")
        self.job_id = info["job_id"]
        self.gcs_address = info["gcs_address"]
        self.node_id = info["node_id"]
        self.address = f"client://{self.proxy_address}"
        self.gcs = _GcsShim(self)

    def _invoke_raw(self, method: str) -> dict:
        return self._rpc.call("RayClient", method, timeout=30)

    def _invoke(self, method: str, *args,
                _timeout: Optional[float] = 300.0, **kwargs) -> Any:
        blob = self._rpc.call(
            "RayClient", "invoke", target=method,
            args_blob=cloudpickle.dumps((args, kwargs)),
            timeout=_timeout)
        return pickle.loads(blob)

    # -- driver API (duck type of DistributedCoreWorker) ----------------
    @staticmethod
    def _reject_streaming(options) -> None:
        # An ObjectRefGenerator holds the server driver's live runtime
        # (locks, sockets) and cannot cross the proxy; fail BEFORE
        # submission, not with a pickling error after side effects ran.
        if getattr(options, "num_returns", 1) == "streaming":
            raise NotImplementedError(
                "num_returns='streaming' is not supported through the "
                "ray-tpu:// client proxy (run the driver in-cluster)")

    def submit_task(self, func, args, kwargs, options):
        self._reject_streaming(options)
        return self._invoke("submit_task", func, args, kwargs, options)

    def submit_streaming_task(self, func, args, kwargs, options):
        self._reject_streaming(options)

    def submit_actor_task(self, actor_id, method_name, args, kwargs,
                          options):
        self._reject_streaming(options)
        return self._invoke("submit_actor_task", actor_id, method_name,
                            args, kwargs, options)

    def create_actor(self, cls, args, kwargs, options):
        return self._invoke("create_actor", cls, args, kwargs, options)

    def get(self, refs, timeout=None):
        return self._invoke("get", refs, timeout,
                            _timeout=None if timeout is None
                            else timeout + 30)

    def put(self, value):
        return self._invoke("put", value)

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        return self._invoke("wait", refs, num_returns, timeout,
                            fetch_local,
                            _timeout=None if timeout is None
                            else timeout + 30)

    def get_actor(self, name, namespace=None):
        return self._invoke("get_actor", name, namespace)

    def kill_actor(self, actor_id, no_restart=True):
        return self._invoke("kill_actor", actor_id, no_restart)

    def cancel(self, ref, force=False, recursive=True):
        return self._invoke("cancel", ref, force, recursive)

    def actor_state(self, actor_id):
        return self._invoke("actor_state", actor_id)

    def create_placement_group(self, pg_id, bundles, strategy,
                               name=None, detached=False):
        return self._invoke("create_placement_group", pg_id, bundles,
                            strategy, name=name, detached=detached)

    def get_placement_group(self, pg_id):
        return self._invoke("get_placement_group", pg_id)

    def remove_placement_group(self, pg_id):
        return self._invoke("remove_placement_group", pg_id)

    def list_placement_groups(self):
        return self._invoke("list_placement_groups")

    def kv_put(self, namespace, key, value, overwrite=True):
        return self._invoke("kv_put", namespace, key, value, overwrite)

    def kv_get(self, namespace, key):
        return self._invoke("kv_get", namespace, key)

    def kv_del(self, namespace, key):
        return self._invoke("kv_del", namespace, key)

    def kv_keys(self, namespace, prefix=b""):
        return self._invoke("kv_keys", namespace, prefix)

    def cluster_resources(self) -> Dict[str, float]:
        return self._invoke("cluster_resources")

    def available_resources(self) -> Dict[str, float]:
        return self._invoke("available_resources")

    def nodes(self) -> List[dict]:
        return self._invoke("nodes")

    def shutdown(self) -> None:
        """Disconnect the client; the proxy's driver (and everything it
        owns) stays up for other clients."""
        try:
            self._rpc.close()
        finally:
            self.loop_thread.stop()
