"""Native RPC ingress for Serve: the gRPC-ingress analogue.

The port's copy of `ray_tpu/serve/rpc_ingress.py`, importing `ray_tpu_torch`
only.

Analogue of the reference gRPC proxy (ref: serve/_private/proxy.py:533
gRPCProxy — a second, binary ingress next to HTTP for low-overhead
service-to-service calls). The TPU-native equivalent speaks the
framework's own length-prefixed frame protocol, so any client that
already talks to the cluster (Python drivers, the C++ client, other
services) can invoke deployments without HTTP overhead:

    service "ServeIngress":
      invoke(app, method, args, kwargs) -> deployment result
      stream_invoke(app, method, args, kwargs) -> streamed items

Runs inside an actor like the HTTP proxy, with its own RpcServer.
"""
from __future__ import annotations

import asyncio
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional


class RpcIngress:
    """Actor: native-protocol ingress routing to deployment handles."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 executor_threads: int = 32):
        self._handles: Dict[str, object] = {}
        self._executor = ThreadPoolExecutor(max_workers=executor_threads,
                                            thread_name_prefix="ingress")
        # Streams park a thread in next() for their whole lifetime: a
        # separate pool keeps slow streams from starving unary invokes
        # (same split as http_proxy's _stream_executor).
        self._stream_executor = ThreadPoolExecutor(
            max_workers=executor_threads,
            thread_name_prefix="ingress-stream")
        self._host = host
        self._want_port = port
        self._port: Optional[int] = None
        self._started = threading.Event()
        threading.Thread(target=self._serve_thread, daemon=True).start()
        if not self._started.wait(30):
            raise RuntimeError("RPC ingress failed to start")

    def _serve_thread(self) -> None:
        from ray_tpu_torch.core.distributed.rpc import RpcServer

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        server = RpcServer(self._host, self._want_port)
        server.add_service("ServeIngress", _IngressService(self))

        async def start():
            self._port = await server.start()
            self._started.set()

        loop.run_until_complete(start())
        loop.run_forever()

    def _handle_for(self, app: str):
        handle = self._handles.get(app)
        if handle is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle

            handle = DeploymentHandle(app)
            self._handles[app] = handle
        return handle

    def port(self) -> int:
        return self._port

    def stop(self) -> bool:
        return True


class _IngressService:
    def __init__(self, ingress: RpcIngress):
        self._ingress = ingress

    async def invoke(self, app: str, target_method: str = "__call__",
                     args: tuple = (), kwargs: Optional[dict] = None):
        """Unary deployment call; blocks on the handle in the executor
        pool (handle calls ride the runtime and may wait on replicas)."""
        handle = self._ingress._handle_for(app)
        if target_method != "__call__":
            handle = handle.options(method_name=target_method)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._ingress._executor,
            lambda: handle.remote(*args, **(kwargs or {})).result())

    async def stream_invoke(self, app: str,
                            target_method: str = "__call__",
                            args: tuple = (),
                            kwargs: Optional[dict] = None):
        """Server-streaming deployment call (generator methods)."""
        handle = self._ingress._handle_for(app)
        if target_method != "__call__":
            handle = handle.options(method_name=target_method)
        loop = asyncio.get_running_loop()
        stream = await loop.run_in_executor(
            self._ingress._stream_executor,
            lambda: handle.remote_streaming(*args, **(kwargs or {})))
        it = iter(stream)
        try:
            while True:
                item = await loop.run_in_executor(
                    self._ingress._stream_executor,
                    lambda: next(it, _SENTINEL))
                if item is _SENTINEL:
                    return
                yield item
        finally:
            # Client disconnect/CANCEL closes this generator: free the
            # replica-side stream + the handle's outstanding counter
            # (same discipline as http_proxy.py).
            stream.cancel()


_SENTINEL = object()
