"""Declarative Serve deployment from a config dict / YAML file.

The port's copy of `ray_tpu/serve/config_deploy.py`, importing `ray_tpu_torch`
only.

Analogue of the reference's config-driven deploys (ref: serve/schema.py
ServeDeploySchema + `serve deploy config.yaml` and the REST config the
dashboard serve module accepts). Schema (one app per entry):

    applications:
      - name: summarizer
        import_path: mypkg.app:build        # callable returning an
                                            # Application/Deployment, or
                                            # a Deployment/class itself
        route_prefix: /summarize            # optional (HTTP route)
        args: {...}                         # kwargs for a builder fn
        deployment_config:
          num_replicas: 2
          max_ongoing_requests: 16
          ray_actor_options: {num_cpus: 1}

`deploy_config(path_or_dict)` deploys/updates every listed app (existing
apps reconcile to the new target, reference-style declarative update).
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional, Union


def _resolve_import(path: str) -> Any:
    module_name, _, attr = path.partition(":")
    if not attr:
        module_name, _, attr = path.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def _load(source: Union[str, dict]) -> dict:
    if isinstance(source, dict):
        return source
    with open(source) as f:
        text = f.read()
    try:
        import yaml  # type: ignore

        return yaml.safe_load(text)
    except ImportError:
        import json

        return json.loads(text)


def deploy_config(source: Union[str, dict]) -> Dict[str, Any]:
    """Deploy every application in the config; returns {app: handle}.
    Apps with a route_prefix are installed on the HTTP proxy (started on
    demand)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.deployment import Application, Deployment

    config = _load(source)
    apps: List[dict] = config.get("applications", [])
    if not apps:
        raise ValueError("config has no 'applications' list")
    handles: Dict[str, Any] = {}
    for app_cfg in apps:
        name = app_cfg["name"]
        target = _resolve_import(app_cfg["import_path"])
        args = app_cfg.get("args") or {}
        dep_cfg = app_cfg.get("deployment_config") or {}

        if isinstance(target, (Application, Deployment)):
            obj = target
        elif isinstance(target, type):
            # A plain class: wrap it; `args` become constructor kwargs.
            obj = serve.deployment(target)
        else:
            obj = target(**args)  # builder function
        if isinstance(obj, Deployment) and not isinstance(target, type) \
                and args:
            raise ValueError(
                f"app {name!r}: 'args' are constructor kwargs and only "
                "apply when import_path is a class or a builder "
                "function — pre-bound Deployment/Application targets "
                "already carry their init args")
        if isinstance(obj, Deployment):
            if dep_cfg:
                obj = obj.options(**dep_cfg)
            app = obj.bind(**(args if isinstance(target, type) else {}))
        elif isinstance(obj, Application):
            if dep_cfg:
                app = obj.deployment.options(**dep_cfg).bind(
                    *obj.init_args, **obj.init_kwargs)
            else:
                app = obj
        else:
            raise TypeError(
                f"import_path {app_cfg['import_path']!r} resolved to "
                f"{type(obj).__name__}; expected a Deployment, an "
                f"Application, a class, or a builder returning one")
        route = app_cfg.get("route_prefix")
        handles[name] = serve.run(
            app, name=name, route_prefix=route,
            _http=route is not None)
    return handles
