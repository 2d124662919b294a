"""serve.run / shutdown / handles (ref: python/ray/serve/api.py:537 run).

The port's copy of `ray_tpu/serve/api.py`, importing `ray_tpu_torch`
only.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.controller import (CONTROLLER_NAME,
                                            get_or_create_controller)
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.handle import DeploymentHandle

_proxy_handle = None
_proxy_port: Optional[int] = None


def _update_persisted_routes(mutate) -> None:
    """Read-modify-write the durable route table ("serve"/"routes" in
    the GCS KV): a restarted HTTP proxy — or one started after a
    controller/GCS restart — re-installs routes from here instead of
    coming back empty.  Best-effort: local mode has no KV."""
    import json as _json

    try:
        from ray_tpu_torch.api import _global_worker, is_initialized

        if not is_initialized():
            return
        w = _global_worker()
        blob = w.kv_get("serve", b"routes")
        routes = _json.loads(blob.decode()) if blob else {}
        mutate(routes)
        w.kv_put("serve", b"routes",
                 _json.dumps(routes, sort_keys=True).encode())
    except Exception:  # noqa: BLE001
        pass


def _deploy_one(controller, name: str, dep: Deployment, init_args,
                init_kwargs) -> None:
    cfg = {
        "num_replicas": dep.config.num_replicas,
        "max_ongoing_requests": dep.config.max_ongoing_requests,
        "ray_actor_options": dep.config.ray_actor_options,
        "autoscaling_config": (
            vars(dep.config.autoscaling_config)
            if dep.config.autoscaling_config else None),
    }
    ray_tpu_torch.get(controller.deploy.remote(
        name, dep.func_or_class, init_args, init_kwargs, cfg),
        timeout=60)


def _deploy_graph(controller, app: Application, name: str) -> None:
    """Deployment-graph composition (ref: serve/_private/
    deployment_graph_build.py:1, serve/dag.py): an Application whose
    init args contain OTHER bound Applications is a DAG with `app` as
    the ingress node. Children deploy first (post-order) under
    '{name}#{deployment}' and each graph edge is replaced by a
    DeploymentHandle, so a request to the ingress flows through the
    whole graph via ordinary handle calls."""
    deployed = {}          # id(Application) -> deployed app name
    on_stack = set()       # cycle detection
    used_names = {name}

    def child_name(dep_name: str) -> str:
        base = f"{name}#{dep_name}"
        cand, k = base, 2
        while cand in used_names:
            cand = f"{base}~{k}"
            k += 1
        used_names.add(cand)
        return cand

    def contains_node(v) -> bool:
        if isinstance(v, (Application, Deployment)):
            return True
        if isinstance(v, (list, tuple, set, frozenset)):
            return any(contains_node(x) for x in v)
        if isinstance(v, dict):
            return any(contains_node(x)
                       for kv in v.items() for x in kv)
        return False

    def convert(v):
        # Values with NO graph nodes pass through UNTOUCHED — plain
        # apps (the common path) must not have their defaultdicts/
        # OrderedDicts/custom containers quietly rebuilt as plain types.
        if not contains_node(v):
            return v
        if isinstance(v, Application):
            return DeploymentHandle(deploy_node(v))
        if isinstance(v, Deployment):
            raise TypeError(
                f"deployment {v.name!r} passed unbound into a graph — "
                f"pass {v.name}.bind(...) nodes, not bare Deployments")
        if type(v) in (list, tuple) or hasattr(v, "_fields"):
            vals = [convert(x) for x in v]
            if hasattr(v, "_fields"):       # namedtuple: positional ctor
                return type(v)(*vals)
            return type(v)(vals)
        if type(v) in (set, frozenset):
            return type(v)(convert(x) for x in v)
        if type(v) is dict:
            return {convert(k): convert(x) for k, x in v.items()}
        raise TypeError(
            f"graph nodes inside a {type(v).__name__} init arg are not "
            f"supported — pass bound deployments in plain "
            f"list/tuple/dict/set containers")

    def deploy_node(node: Application) -> str:
        if id(node) in deployed:
            return deployed[id(node)]       # shared node: deploy once
        if id(node) in on_stack:
            raise ValueError("cycle in the deployment graph")
        on_stack.add(id(node))
        try:
            args = tuple(convert(a) for a in node.init_args)
            kwargs = {k: convert(v) for k, v in node.init_kwargs.items()}
        finally:
            on_stack.discard(id(node))
        node_name = (name if node is app
                     else child_name(node.deployment.name))
        _deploy_one(controller, node_name, node.deployment, args, kwargs)
        deployed[id(node)] = node_name
        return node_name

    deploy_node(app)
    # Declarative reconcile: children from a PREVIOUS graph under this
    # name that the new graph no longer contains must not leak replicas.
    try:
        live = ray_tpu_torch.get(controller.list_applications.remote(),
                                 timeout=30)
    except Exception:  # noqa: BLE001
        live = []
    for a in live:
        if a.startswith(name + "#") and a not in used_names:
            ray_tpu_torch.get(controller.delete_app.remote(a), timeout=30)


def run(app: Application | Deployment, *, name: str = "default",
        route_prefix: Optional[str] = "/", blocking: bool = False,
        _http: bool = False) -> DeploymentHandle:
    """Deploy an application (possibly a graph of bound deployments —
    see _deploy_graph); returns a handle (ref: serve/api.py:537)."""
    if "#" in name:
        raise ValueError(
            f"app name {name!r} may not contain '#' (reserved for "
            f"deployment-graph child namespacing)")
    if isinstance(app, Deployment):
        app = app.bind()
    controller = get_or_create_controller()
    _deploy_graph(controller, app, name)
    # wait for at least one replica
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        st = ray_tpu_torch.get(controller.app_status.remote(name), timeout=30)
        if st["running"] >= min(1, st["target"]):
            break
        time.sleep(0.1)
    if _http and route_prefix:
        _update_persisted_routes(lambda r: r.__setitem__(route_prefix,
                                                         name))
        # Await route installation: a request racing a fire-and-forget
        # set_route would 404.
        ray_tpu_torch.get(
            start_http_proxy().set_route.remote(route_prefix, name),
            timeout=30)
    handle = DeploymentHandle(name)
    if blocking:  # pragma: no cover
        while True:
            time.sleep(1)
    return handle


def _get_or_start_ingress(cached_handle, actor_cls_path: str,
                          actor_name: str, host: str, port: int):
    """Validate a cached detached ingress actor or start a fresh one
    (shared by the HTTP proxy and the native RPC ingress). The cached
    handle may belong to a previous cluster — a driver that shut down
    without serve.shutdown() — so it is pinged before reuse. Returns
    (handle, bound_port)."""
    if cached_handle is not None:
        try:
            return cached_handle, ray_tpu_torch.get(
                cached_handle.port.remote(), timeout=5)
        except Exception:  # noqa: BLE001
            pass
    import importlib

    module, cls_name = actor_cls_path.rsplit(".", 1)
    cls = getattr(importlib.import_module(module), cls_name)
    handle = ray_tpu_torch.remote(cls).options(
        name=actor_name, lifetime="detached",
        max_concurrency=32).remote(host, port)
    return handle, ray_tpu_torch.get(handle.port.remote(), timeout=30)


def start_http_proxy(host: str = "127.0.0.1", port: int = 0):
    """Start (or return) the node's HTTP proxy actor."""
    global _proxy_handle, _proxy_port
    _proxy_handle, _proxy_port = _get_or_start_ingress(
        _proxy_handle, "ray_tpu_torch.serve.http_proxy.HTTPProxy",
        "serve:http_proxy", host, port)
    return _proxy_handle


def http_port() -> Optional[int]:
    return _proxy_port


_rpc_ingress_handle = None
_rpc_ingress_port = None


def start_rpc_ingress(host: str = "127.0.0.1", port: int = 0):
    """Start (or return) the native-protocol ingress actor (ref: the
    gRPC proxy, serve/_private/proxy.py:533 — a binary ingress next to
    HTTP for service-to-service calls)."""
    global _rpc_ingress_handle, _rpc_ingress_port
    _rpc_ingress_handle, _rpc_ingress_port = _get_or_start_ingress(
        _rpc_ingress_handle, "ray_tpu_torch.serve.rpc_ingress.RpcIngress",
        "serve:rpc_ingress", host, port)
    return _rpc_ingress_handle


def rpc_ingress_port() -> Optional[int]:
    return _rpc_ingress_port


def get_deployment_handle(app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(app_name)


def get_app_handle(app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(app_name)


def status() -> Dict[str, dict]:
    controller = get_or_create_controller()
    apps = ray_tpu_torch.get(controller.list_applications.remote(), timeout=30)
    return {a: ray_tpu_torch.get(controller.app_status.remote(a), timeout=30)
            for a in apps}


def delete(app_name: str) -> None:
    """Delete an app AND its deployment-graph children (named
    '{app}#...')."""
    controller = get_or_create_controller()
    apps = ray_tpu_torch.get(controller.list_applications.remote(), timeout=30)
    doomed = [a for a in apps
              if a == app_name or a.startswith(app_name + "#")]
    # Ingress first: once it is gone no request can route into the
    # children, so their teardown never strands an in-flight call.
    doomed.sort(key=lambda a: (a != app_name, a))
    _update_persisted_routes(
        lambda r: [r.pop(p) for p, a in list(r.items()) if a in doomed])
    if _proxy_handle is not None:
        for a in doomed:
            try:
                ray_tpu_torch.get(
                    _proxy_handle.remove_routes_for.remote(a), timeout=10)
            except Exception:  # noqa: BLE001
                pass
    for a in doomed:
        ray_tpu_torch.get(controller.delete_app.remote(a), timeout=30)


def shutdown() -> None:
    global _proxy_handle, _proxy_port
    global _rpc_ingress_handle, _rpc_ingress_port
    if _proxy_handle is not None:
        try:
            ray_tpu_torch.get(_proxy_handle.stop.remote(), timeout=10)
            ray_tpu_torch.kill(_proxy_handle)
        except Exception:  # noqa: BLE001
            pass
        _proxy_handle = None
        _proxy_port = None
    if _rpc_ingress_handle is not None:
        try:
            ray_tpu_torch.get(_rpc_ingress_handle.stop.remote(), timeout=10)
            ray_tpu_torch.kill(_rpc_ingress_handle)
        except Exception:  # noqa: BLE001
            pass
        _rpc_ingress_handle = None
        _rpc_ingress_port = None
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
    except Exception:  # noqa: BLE001
        pass
