"""Model multiplexing: many models time-share one replica pool.

The port's copy of `ray_tpu/serve/multiplex.py`, importing `ray_tpu_torch`
only.

Reference: `serve.multiplexed` + `serve.get_multiplexed_model_id`
(ref: python/ray/serve/multiplex.py, api.py multiplexed decorator).
A replica keeps an LRU cache of loaded models; the router prefers the
replica that already holds the requested model (affinity lives in the
handle's routing table — the reference keeps it in the replica scheduler,
pow_2_scheduler.py multiplexed locality).

    class MultiModel:
        @serve.multiplexed(max_num_models_per_replica=3)
        def get_model(self, model_id: str):
            return load_weights(model_id)

        def __call__(self, request):
            model = self.get_model(serve.get_multiplexed_model_id())
            return model(request)

    handle.options(multiplexed_model_id="m1").remote(...)
"""
from __future__ import annotations

import contextvars
import functools
import threading
from collections import OrderedDict
from typing import Callable, Optional

_model_id_ctx: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("raytpu_multiplexed_model_id", default=None)


def get_multiplexed_model_id() -> str:
    """The model id of the request being handled (ref: serve/api.py
    get_multiplexed_model_id)."""
    return _model_id_ctx.get() or ""


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorate a model-loader method: calls are LRU-cached per replica by
    model id; evicted models call their `__del__`/`unload` if present."""

    def deco(load_fn: Callable):
        # Per-process state is reached through the module-level accessor
        # (pickled by reference): a lock captured in this closure would
        # make the decorated class unpicklable when the deployment ships
        # to its replica actor.
        import uuid

        state_key = uuid.uuid4().hex

        @functools.wraps(load_fn)
        def wrapper(*args, **kwargs):
            st = _state_for(state_key)
            cache, lock, loading = st["cache"], st["lock"], st["loading"]
            # Supports methods (self, model_id) and functions (model_id,),
            # positionally or as model_id=... .
            model_id = kwargs.get("model_id", args[-1] if args else "")
            while True:
                with lock:
                    if model_id in cache:
                        cache.move_to_end(model_id)
                        return cache[model_id]
                    ev = loading.get(model_id)
                    if ev is None:
                        loading[model_id] = ev = threading.Event()
                        break  # this thread loads
                # Another request is loading this model: wait, re-check.
                ev.wait(timeout=600)
            try:
                model = load_fn(*args, **kwargs)
                with lock:
                    cache[model_id] = model
                    while len(cache) > max_num_models_per_replica:
                        _, evicted = cache.popitem(last=False)
                        unload = getattr(evicted, "unload", None)
                        if callable(unload):
                            try:
                                unload()
                            except Exception:  # noqa: BLE001
                                pass
                return model
            finally:
                with lock:
                    loading.pop(model_id, None)
                ev.set()

        wrapper._is_multiplexed = True
        return wrapper

    return deco


_states: dict = {}
_states_lock = threading.Lock()


def _state_for(key: str) -> dict:
    with _states_lock:
        st = _states.get(key)
        if st is None:
            st = _states[key] = {"cache": OrderedDict(),
                                 "lock": threading.Lock(),
                                 "loading": {}}
        return st
