"""Top-level API: init/shutdown/remote/get/put/wait and friends,
counterpart of `ray_tpu/api.py`.

Only the in-process engine is ported: `init(local_mode=True)` builds the
port's `LocalCoreWorker`. Connecting to or starting a cluster (an address,
`RAY_TPU_ADDRESS`, or none) and the `ray-tpu://` client raise: they are
ROADMAP item 10a-ii, and never fall back to local mode. `shutdown` writes
no usage snapshot yet (item 10d, with `util/usage_stats`).

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


_NOT_PORTED = ("the multi-process runtime of ray_tpu_torch is not ported yet "
               "(ROADMAP queue A, item 10a-ii)")


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

    - ``local_mode=True``: run everything in-process.
    - ``address=None``: start a new local cluster (head + node daemon +
      workers) and connect to it; ``address="host:port"`` connects to an
      existing head; ``address="ray-tpu://..."`` drives one through its
      client proxy. These raise NotImplementedError: ROADMAP item 10a-ii.
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
            raise NotImplementedError(
                f"init({address!r}): the ray-tpu:// client drives a cluster, "
                f"and {_NOT_PORTED}")
        if not local_mode:
            what = ("would start a cluster" if address is None
                    else f"would connect to {address!r}")
            raise NotImplementedError(
                f"init() {what}: {_NOT_PORTED}; run in-process with "
                f"init(local_mode=True)")
        from ray_tpu_torch.core.local_engine import LocalCoreWorker

        _worker = LocalCoreWorker(num_cpus=num_cpus)
        return _worker


def shutdown() -> None:
    global _worker
    with _worker_lock:
        if _worker is not None:
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
    reference's cross-language function registry). Raises: the registry
    lives in the control plane's KV of the multi-process runtime."""
    raise NotImplementedError(
        f"register_cross_lang({name!r}): the registry lives in the control "
        f"plane's KV, and {_NOT_PORTED}")


def cluster_resources() -> dict:
    return _global_worker().cluster_resources()


def available_resources() -> dict:
    return _global_worker().available_resources()


def nodes() -> list:
    return _global_worker().nodes()
