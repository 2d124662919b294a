"""Deployment definition + application graph node.

The port's copy of `ray_tpu/serve/deployment.py`, importing `ray_tpu_torch`
only.

Reference surface: `@serve.deployment` (ref: python/ray/serve/api.py:244),
`Deployment.bind/options` and the app node passed to `serve.run`
(ref: serve/deployment.py, _private/deployment_graph_build.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    ray_actor_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 2.0
    graceful_shutdown_timeout_s: float = 5.0


class Application:
    """A bound deployment (callable + init args), ready for serve.run
    (ref: serve's Application from Deployment.bind)."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs


class Deployment:
    def __init__(self, target: Callable, name: str, config: DeploymentConfig):
        self._target = target
        self.name = name
        self.config = config

    @property
    def func_or_class(self):
        return self._target

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_ongoing_requests: Optional[int] = None,
                ray_actor_options: Optional[dict] = None,
                autoscaling_config: Optional[AutoscalingConfig | dict] = None,
                **_ignored) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        return Deployment(self._target, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)


def deployment(_target=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 16,
               ray_actor_options: Optional[dict] = None,
               autoscaling_config: Optional[AutoscalingConfig | dict] = None,
               **_ignored):
    """@serve.deployment decorator (ref: serve/api.py:244)."""
    def wrap(target):
        if isinstance(autoscaling_config, dict):
            asc = AutoscalingConfig(**autoscaling_config)
        else:
            asc = autoscaling_config
        nrep = num_replicas
        if nrep == "auto":
            nrep = (asc.min_replicas if asc else 1)
        cfg = DeploymentConfig(
            num_replicas=nrep,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=ray_actor_options or {},
            autoscaling_config=asc)
        return Deployment(target, name or target.__name__, cfg)

    return wrap if _target is None else wrap(_target)
