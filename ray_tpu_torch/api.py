"""Top-level API: init/shutdown/remote/get/put/wait and friends,
counterpart of `ray_tpu/api.py`.

`init(local_mode=True)` builds the in-process `LocalCoreWorker`; `init()`
starts a single-host cluster (GCS, node daemon, zygote workers, shared-memory
store) through `core/distributed/driver.py`, and `init(address=...)` or
`RAY_TPU_ADDRESS` joins a running ray_tpu_torch cluster, and
`init("ray-tpu://host:port")` drives one through its client proxy
(`util/client`). `register_cross_lang` names a Python function for the C++
worker API (`cpp/`, `util/cross_lang.py`). `shutdown` writes the session's usage
snapshot (`util/usage_stats.py`) and reports it only on opt-in.

Analogue of the reference driver API (ref: python/ray/_private/worker.py —
init :1217, get :2574, put :2686, wait :2751, remote :3144, shutdown :1795).
"""
from __future__ import annotations

import inspect
import threading
from typing import Any, List, Optional, Sequence, Union

from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import TaskOptions
from ray_tpu_torch.remote_function import RemoteFunction, _merge_options

_worker = None
_worker_lock = threading.RLock()


def _global_worker():
    global _worker
    if _worker is None:
        with _worker_lock:
            if _worker is None:
                init()
    return _worker


def is_initialized() -> bool:
    return _worker is not None


def _set_global_worker(worker) -> None:
    global _worker
    _worker = worker


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    local_mode: bool = False,
    namespace: Optional[str] = None,
    resources: Optional[dict] = None,
    object_store_memory: Optional[int] = None,
    ignore_reinit_error: bool = False,
    runtime_env: Optional[dict] = None,
    log_to_driver: bool = True,
    _node_name: Optional[str] = None,
    **kwargs,
):
    """Connect to or start a cluster.

    - ``address=None``: start a new local cluster (head + node daemon +
      workers) and connect to it.
    - ``address="host:port"``: connect to an existing ray_tpu_torch head.
    - ``local_mode=True``: run everything in-process (debugging).
    - ``address="ray-tpu://host:port"``: thin-client mode, every driver
      call forwarded to the cluster's client proxy
      (``python -m ray_tpu_torch.util.client.server``).
    """
    global _worker
    if address is None:
        # Submitted jobs / child drivers join the ambient cluster, like
        # the reference's RAY_ADDRESS.
        from ray_tpu_torch.core.config import get_config

        address = get_config().address or None
    with _worker_lock:
        if _worker is not None:
            if ignore_reinit_error:
                return _worker
            raise RuntimeError(
                "ray_tpu_torch.init() has already been called. Pass "
                "ignore_reinit_error=True to ignore.")
        if address is not None and address.startswith("ray-tpu://"):
            # Thin-client mode: drive a remote cluster through its client
            # proxy (ref: ray.init("ray://host:port") → Ray Client).
            from ray_tpu_torch.util.client import ClientWorker

            _worker = ClientWorker(address)
        elif local_mode:
            from ray_tpu_torch.core.local_engine import LocalCoreWorker

            _worker = LocalCoreWorker(num_cpus=num_cpus)
        else:
            from ray_tpu_torch.core.distributed.driver import (
                connect_or_start_cluster as connect_or_start,
            )

            _worker = connect_or_start(
                address=address,
                num_cpus=num_cpus,
                num_gpus=num_gpus,
                resources=resources,
                namespace=namespace,
                object_store_memory=object_store_memory,
                log_to_driver=log_to_driver,
            )
        if runtime_env and hasattr(_worker, "job_runtime_env"):
            # Job-level default env: tasks/actors without an explicit
            # runtime_env inherit it (ref: job-level runtime_env in
            # ray.init; per-call specs override wholesale).
            _worker.job_runtime_env = dict(runtime_env)
        return _worker


def shutdown() -> None:
    global _worker
    with _worker_lock:
        if _worker is not None:
            # Persist the usage snapshot for this driver session (ref:
            # usage_lib writes usage_stats.json at session end; local
            # file only — report_usage() is a no-op unless the user
            # explicitly opted in).
            try:
                import os as _os
                import tempfile as _tf

                from ray_tpu_torch.core.config import get_config as _get_config
                from ray_tpu_torch.util import usage_stats as _us

                path = _get_config().usage_stats_path or _os.path.join(
                    _tf.gettempdir(),
                    f"ray_tpu_torch_usage_{_os.getpid()}.json")
                _us.write_usage_snapshot(path)
                _us.report_usage()
            except Exception:  # noqa: BLE001 — never block shutdown
                pass
            _worker.shutdown()
            _worker = None


def remote(*args, **kwargs):
    """Decorator turning a function into a RemoteFunction or a class into an
    ActorClass. Usable bare (`@remote`) or with options
    (`@remote(num_cpus=2)`)."""

    def decorate(obj, options: Optional[TaskOptions] = None):
        if inspect.isclass(obj):
            return ActorClass(obj, options)
        if callable(obj):
            return RemoteFunction(obj, options)
        raise TypeError(f"@remote cannot be applied to {type(obj)}")

    if len(args) == 1 and not kwargs and (callable(args[0])):
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    options = _merge_options(TaskOptions(), **kwargs)

    def wrapper(obj):
        return decorate(obj, options)

    return wrapper


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    worker = _global_worker()
    if isinstance(refs, ObjectRef):
        return worker.get([refs], timeout)[0]
    if isinstance(refs, (list, tuple)):
        bad = [r for r in refs if not isinstance(r, ObjectRef)]
        if bad:
            raise TypeError(f"get() expects ObjectRefs, got {type(bad[0])}")
        return worker.get(list(refs), timeout)
    raise TypeError(f"get() expects an ObjectRef or list, got {type(refs)}")


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed.")
    return _global_worker().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs.")
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs.")
    if num_returns <= 0 or num_returns > len(refs):
        raise ValueError(
            f"num_returns must be in [1, {len(refs)}], got {num_returns}")
    return _global_worker().wait(refs, num_returns, timeout, fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    _global_worker().kill_actor(actor._actor_id, no_restart)


def cancel(ref, *, force: bool = False, recursive: bool = True) -> None:
    """Cancel the task producing `ref` — an ObjectRef or an
    ObjectRefGenerator (cancelling a stream interrupts the running
    generator; consumed item refs stay valid)."""
    _global_worker().cancel(ref, force, recursive)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    worker = _global_worker()
    actor_id = worker.get_actor(name, namespace)
    return ActorHandle(actor_id, name, TaskOptions(), [])


def register_cross_lang(name: str, func) -> None:
    """Expose a Python function to non-Python clients by name (ref: the
    reference's cross-language function registry used by the C++/Java
    worker APIs). The C++ client resolves `name` via the GCS KV and
    submits tasks running `func` on Python workers."""
    worker = _global_worker()
    if hasattr(worker, "_export_function"):
        # Canonical export path: dedup cache + overwrite=False.
        key = worker._export_function(func)
    else:  # local mode / thin client: direct KV export
        from ray_tpu_torch.core.distributed import protocol

        key, blob = protocol.function_key(func)
        worker.kv_put(b"fn", key, blob)
    worker.kv_put(b"xlang", name.encode(), key)


def cluster_resources() -> dict:
    return _global_worker().cluster_resources()


def available_resources() -> dict:
    return _global_worker().available_resources()


def nodes() -> list:
    return _global_worker().nodes()
