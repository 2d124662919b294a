"""Client proxy server: hosts a real driver, serves thin clients;
counterpart of `ray_tpu/util/client/server.py`.

Analogue of the reference client server (ref: util/client/server/
server.py:96 — a gRPC servicer that executes driver-side operations on
behalf of remote clients). One service, two methods:

    invoke(method, args_blob)          -> run a DistributedCoreWorker
                                          method, return pickled result
    relay_gcs(service, method, blob)   -> forward a raw GCS RPC (library
                                          internals use worker.gcs.call)

The server process IS the driver: objects put by clients are owned here,
so they outlive any individual client connection (the reference's client
server owns references the same way).
"""
from __future__ import annotations

import asyncio
import logging
import pickle
from typing import Optional

import cloudpickle

logger = logging.getLogger(__name__)

# Driver-API methods clients may proxy. An allowlist, not getattr on
# anything the wire names: the payloads are pickles (trusted cluster
# perimeter, same as the reference client), but method dispatch should
# still be a closed set.
ALLOWED = frozenset({
    "submit_task", "submit_actor_task", "create_actor", "get", "put",
    "wait", "get_actor", "kill_actor", "cancel", "actor_state",
    "create_placement_group", "get_placement_group",
    "remove_placement_group", "list_placement_groups",
    "kv_put", "kv_get", "kv_del", "kv_keys",
    "cluster_resources", "available_resources", "nodes",
})


class _ClientService:
    def __init__(self, worker):
        self._worker = worker
        loop = asyncio.get_event_loop()
        self._loop = loop

    async def invoke(self, target: str, args_blob: bytes) -> bytes:
        if target not in ALLOWED:
            raise ValueError(f"client may not invoke {target!r}")
        args, kwargs = pickle.loads(args_blob)
        fn = getattr(self._worker, target)
        # Worker methods block (get/wait): keep the proxy loop free.
        result = await asyncio.get_running_loop().run_in_executor(
            None, lambda: fn(*args, **kwargs))
        return cloudpickle.dumps(result)

    async def relay_gcs(self, svc: str, meth: str,
                        kwargs_blob: bytes) -> bytes:
        kwargs = pickle.loads(kwargs_blob)
        timeout = kwargs.pop("timeout", 30)
        result = await asyncio.get_running_loop().run_in_executor(
            None, lambda: self._worker.gcs.call(svc, meth,
                                                timeout=timeout, **kwargs))
        return cloudpickle.dumps(result)

    def server_info(self) -> dict:
        return {
            "job_id": self._worker.job_id,
            "gcs_address": self._worker.gcs_address,
            "node_id": self._worker.node_id,
        }


class ClientProxyServer:
    def __init__(self, gcs_address: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 10001):
        import ray_tpu_torch
        from ray_tpu_torch.api import _global_worker

        ray_tpu_torch.init(address=gcs_address, ignore_reinit_error=True)
        self._worker = _global_worker()
        self.host = host
        self.port = port
        self._server = None

    async def start(self) -> int:
        from ray_tpu_torch.core.distributed.rpc import RpcServer

        self._server = RpcServer(self.host, self.port)
        self._server.add_service("RayClient", _ClientService(self._worker))
        self.port = await self._server.start()
        logger.info("client proxy on %s:%d", self.host, self.port)
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop()


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--address", default=None,
                        help="GCS address (default: start a local cluster)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=10001)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO, format="[client-proxy] %(message)s")

    async def run():
        srv = ClientProxyServer(args.address, args.host, args.port)
        port = await srv.start()
        print(f"CLIENT_PROXY_PORT={port}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
