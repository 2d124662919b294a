"""Workflow execution + storage; the port's copy of
`ray_tpu/workflow/api.py` over `ray_tpu_torch.dag` (the same step keys
and storage layout).

ref: python/ray/workflow/workflow_executor.py (driver loop),
workflow_storage.py (durable step results), api.py (run/resume surface).
Step identity is structural: the DAG's deterministic topological position
plus the step's function name — a resumed run must rebuild the same DAG
(the reference has the same contract for workflows built from DAGs).
"""
from __future__ import annotations

import json
import os
import pickle
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from ray_tpu_torch.dag.dag_node import (
    DAGNode,
    FunctionNode,
    InputNode,
    MultiOutputNode,
)

def _default_storage() -> str:
    from ray_tpu_torch.core.config import get_config

    return get_config().workflow_storage


def _wf_dir(workflow_id: str, storage: Optional[str]) -> str:
    return os.path.join(storage or _default_storage(), workflow_id)


def _step_key(node: DAGNode, topo_index: int) -> str:
    name = "node"
    if isinstance(node, FunctionNode):
        fn = getattr(node._rf, "_function", None)
        name = getattr(fn, "__name__", "fn")
    elif isinstance(node, InputNode):
        name = "input"
    elif isinstance(node, MultiOutputNode):
        name = "output"
    elif isinstance(node, EventNode):
        name = f"event-{node.event_name}"
    return f"{topo_index:04d}_{name}"


def _topo_order(root: DAGNode) -> Dict[int, int]:
    """Deterministic post-order numbering of the DAG by structure."""
    order: Dict[int, int] = {}

    def visit(node: DAGNode) -> None:
        if id(node) in order:
            return
        for child in node._children():
            visit(child)
        order[id(node)] = len(order)

    visit(root)
    return order


class _WorkflowRun:
    def __init__(self, dag: DAGNode, workflow_id: str, storage: str):
        self.dag = dag
        self.workflow_id = workflow_id
        self.dir = storage
        self.steps_dir = os.path.join(storage, "steps")
        os.makedirs(self.steps_dir, exist_ok=True)
        self.order = _topo_order(dag)

    # -- storage -----------------------------------------------------------
    def _step_path(self, node: DAGNode) -> str:
        return os.path.join(self.steps_dir,
                            _step_key(node, self.order[id(node)]) + ".pkl")

    def _load_step(self, node: DAGNode):
        path = self._step_path(node)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    def _save_step(self, node: DAGNode, value: Any) -> None:
        path = self._step_path(node)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.rename(tmp, path)

    def _set_status(self, status: str, error: Optional[str] = None) -> None:
        with open(os.path.join(self.dir, "status.json"), "w") as f:
            json.dump({"workflow_id": self.workflow_id, "status": status,
                       "error": error, "ts": time.time()}, f)

    # -- steps -------------------------------------------------------------
    def _run_step(self, node: FunctionNode, args, kwargs) -> Any:
        """Submit one step with per-step retries + backoff (ref:
        workflow step options max_retries; the reference retries the
        WHOLE step — distinct from task-level max_retries, which only
        covers worker death). `catch` composes after retries exhaust."""
        import ray_tpu_torch

        retries = max(0, getattr(node, "_wf_max_retries", 0))
        backoff = getattr(node, "_wf_backoff_s", 0.5)
        attempt = 0
        while True:
            try:
                return_val = ray_tpu_torch.get(node._rf.remote(*args, **kwargs))
                if isinstance(return_val, Continuation):
                    # Continuations splice regardless of catch (the
                    # sub-workflow's own steps can use catch).
                    return return_val
                if getattr(node, "_wf_catch", False):
                    # catch_exceptions semantics: failures are data, not
                    # workflow aborts. Exception only: KeyboardInterrupt/
                    # SystemExit must still abort, not become a durable
                    # step value.
                    return (return_val, None)
                return return_val
            except Exception as e:  # noqa: BLE001
                if attempt >= retries:
                    if getattr(node, "_wf_catch", False):
                        return (None, repr(e))
                    raise
                attempt += 1
                time.sleep(backoff * attempt)

    # -- continuations -----------------------------------------------------
    def _cont_path(self, node: DAGNode) -> str:
        return os.path.join(
            self.steps_dir,
            _step_key(node, self.order[id(node)]) + ".cont.pkl")

    def _save_continuation(self, node: DAGNode, dag: DAGNode) -> None:
        import cloudpickle

        path = self._cont_path(node)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            cloudpickle.dump(dag, f)
        os.rename(tmp, path)

    def _load_continuation(self, node: DAGNode) -> Optional[DAGNode]:
        path = self._cont_path(node)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    def _finish_continuation(self, node: DAGNode, dag: DAGNode) -> Any:
        """Run a step's continuation honoring the step's `catch` mark:
        the catch contract ((value, None) | (None, error)) holds for
        continuation-returning steps too — a sub-workflow failure
        becomes data instead of aborting the workflow."""
        if getattr(node, "_wf_catch", False):
            try:
                return (self._run_continuation(node, dag), None)
            except Exception as e:  # noqa: BLE001
                return (None, repr(e))
        return self._run_continuation(node, dag)

    def _run_continuation(self, node: DAGNode, dag: DAGNode) -> Any:
        """Execute a step-returned sub-DAG in a namespaced sub-workflow:
        its steps are durable under `sub/<step_key>/`, so nested resumes
        skip completed sub-steps (arbitrary recursion depth — a sub-step
        may itself return a continuation)."""
        sub_dir = os.path.join(
            self.dir, "sub", _step_key(node, self.order[id(node)]))
        sub = _WorkflowRun(
            dag, f"{self.workflow_id}#{os.path.basename(sub_dir)}",
            sub_dir)
        value = sub.execute()
        if isinstance(value, Continuation):
            raise TypeError("a continuation DAG's root resolved to "
                            "another bare Continuation object")
        return value

    # -- execution ---------------------------------------------------------
    def _wait_event(self, node: "EventNode") -> Any:
        path = os.path.join(self.dir, "events", f"{node.event_name}.pkl")
        deadline = (None if node.timeout_s is None
                    else time.monotonic() + node.timeout_s)
        while not os.path.exists(path):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"workflow event {node.event_name!r} not delivered "
                    f"within {node.timeout_s}s")
            time.sleep(node.poll_s)
        with open(path, "rb") as f:
            return pickle.load(f)

    def execute(self, *input_args, **input_kwargs) -> Any:
        import ray_tpu_torch

        self._set_status("RUNNING")
        cache: Dict[int, Any] = {}

        def run_node(node: DAGNode) -> Any:
            key = id(node)
            if key in cache:
                return cache[key]
            if isinstance(node, InputNode):
                value = input_args[node._index]
            elif isinstance(node, MultiOutputNode):
                value = [run_node(c) for c in node._bound_args]
            else:
                stored = self._load_step(node)
                if stored is not None:
                    value = stored["value"]
                else:
                    if isinstance(node, EventNode):
                        value = self._wait_event(node)
                        self._save_step(node, {"value": value})
                        cache[key] = value
                        return value
                    # A continuation checkpoint from a prior run: the
                    # generating step already ran — resume its sub-DAG
                    # without re-running the step body.
                    cont_dag = self._load_continuation(node)
                    if cont_dag is not None:
                        value = self._finish_continuation(node, cont_dag)
                        self._save_step(node, {"value": value})
                        cache[key] = value
                        return value
                    args = [run_node(a) if isinstance(a, DAGNode) else a
                            for a in node._bound_args]
                    kwargs = {k: (run_node(v) if isinstance(v, DAGNode)
                                  else v)
                              for k, v in node._bound_kwargs.items()}
                    if isinstance(node, FunctionNode):
                        value = self._run_step(node, args, kwargs)
                        if isinstance(value, Continuation):
                            # Dynamic workflow (ref: workflow
                            # continuation): checkpoint the returned
                            # DAG so a resumed run re-enters the
                            # sub-workflow WITHOUT re-running this
                            # step, then splice it in.
                            self._save_continuation(node, value.dag)
                            value = self._finish_continuation(
                                node, value.dag)
                    else:
                        raise TypeError(
                            f"workflows support function DAGs; got "
                            f"{type(node).__name__} (actor steps need "
                            f"virtual-actor support)")
                    self._save_step(node, {"value": value})
            cache[key] = value
            return value

        try:
            result = run_node(self.dag)
        except BaseException as e:  # noqa: BLE001
            self._set_status("FAILED", error=repr(e))
            raise
        with open(os.path.join(self.dir, "result.pkl"), "wb") as f:
            pickle.dump(result, f)
        self._set_status("SUCCESSFUL")
        return result


_live_runs: Dict[str, Future] = {}
_lock = threading.Lock()


class EventNode(DAGNode):
    """Durable external-event wait (ref: workflow/event_listener.py +
    http_event_provider.py): execution blocks at this node until
    `send_event(workflow_id, name, payload)` delivers; the payload is
    checkpointed like any step, so a resumed run does not re-wait."""

    def __init__(self, name: str, timeout_s: Optional[float] = None,
                 poll_s: float = 0.2):
        super().__init__((), {})
        self.event_name = name
        self.timeout_s = timeout_s
        self.poll_s = poll_s

    def _execute_impl(self, cache, input_args, input_kwargs):
        raise TypeError("EventNode only executes inside workflow.run()")


def _check_event_name(name: str) -> str:
    if not name or any(c in name for c in "/\\\0") or name.startswith("."):
        raise ValueError(
            f"invalid event name {name!r}: names are file-path components")
    return name


def event(name: str, timeout_s: Optional[float] = None) -> EventNode:
    """A DAG node that waits for a named external event."""
    return EventNode(_check_event_name(name), timeout_s)


def send_event(workflow_id: str, name: str, payload: Any = None,
               storage: Optional[str] = None) -> None:
    """Deliver an event to a (possibly running) workflow: cross-process
    via the workflow's durable storage dir."""
    _check_event_name(name)
    d = os.path.join(_wf_dir(workflow_id, storage), "events")
    os.makedirs(d, exist_ok=True)
    # pid-suffixed tmp: concurrent senders must not interleave into one
    # tmp file (same discipline as _save_step).
    tmp = os.path.join(d, f".{name}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, os.path.join(d, f"{name}.pkl"))


class Continuation:
    """Wrapper a STEP returns to splice a dynamically-built DAG into the
    workflow (ref: python/ray/workflow/common.py `workflow.continuation`
    + workflow_state_from_dag.py): the sub-DAG executes as a durable
    sub-workflow and its result becomes this step's result. The DAG is
    checkpointed when the generating step completes, so a resumed run
    re-enters the sub-workflow without re-running the generator."""

    def __init__(self, dag: DAGNode):
        if not isinstance(dag, DAGNode):
            raise TypeError(
                f"continuation() takes a DAG node (fn.bind(...)), got "
                f"{type(dag).__name__}")
        self.dag = dag


def continuation(dag: DAGNode) -> Continuation:
    """Return from inside a workflow step to continue with `dag`."""
    return Continuation(dag)


def retry(node: DAGNode, max_retries: int = 3,
          backoff_s: float = 0.5) -> DAGNode:
    """Per-step retry budget (ref: workflow step `max_retries`): the
    whole step re-submits on ANY exception, with linear backoff —
    distinct from task-level `max_retries`, which only re-runs on worker
    death. Composes with `catch` (failure becomes data only after the
    budget is spent)."""
    node._wf_max_retries = int(max_retries)  # type: ignore[attr-defined]
    node._wf_backoff_s = float(backoff_s)    # type: ignore[attr-defined]
    return node


def catch(node: DAGNode) -> DAGNode:
    """Mark a step so failures become values: downstream receives
    (result, None) on success or (None, error_repr) on failure (ref:
    workflow step option catch_exceptions)."""
    node._wf_catch = True  # type: ignore[attr-defined]
    return node


def run(dag: DAGNode, *args, workflow_id: Optional[str] = None,
        storage: Optional[str] = None, **kwargs) -> Any:
    """Execute a DAG durably; completed steps are checkpointed so a crashed
    run resumes where it stopped (ref: workflow/api.py run)."""
    workflow_id = workflow_id or f"workflow-{int(time.time() * 1000)}"
    wf = _WorkflowRun(dag, workflow_id, _wf_dir(workflow_id, storage))
    return wf.execute(*args, **kwargs)


def run_async(dag: DAGNode, *args, workflow_id: Optional[str] = None,
              storage: Optional[str] = None, **kwargs) -> Future:
    workflow_id = workflow_id or f"workflow-{int(time.time() * 1000)}"
    fut: Future = Future()

    def runner():
        try:
            fut.set_result(run(dag, *args, workflow_id=workflow_id,
                               storage=storage, **kwargs))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    with _lock:
        _live_runs[workflow_id] = fut
    threading.Thread(target=runner, daemon=True).start()
    return fut


def resume(workflow_id: str, dag: DAGNode, *args,
           storage: Optional[str] = None, **kwargs) -> Any:
    """Re-run `workflow_id` with the same DAG: durable steps are loaded,
    only missing ones execute (ref: workflow resume semantics)."""
    wf = _WorkflowRun(dag, workflow_id, _wf_dir(workflow_id, storage))
    return wf.execute(*args, **kwargs)


def get_status(workflow_id: str, storage: Optional[str] = None
               ) -> Optional[str]:
    path = os.path.join(_wf_dir(workflow_id, storage), "status.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["status"]


def get_output(workflow_id: str, storage: Optional[str] = None) -> Any:
    path = os.path.join(_wf_dir(workflow_id, storage), "result.pkl")
    if not os.path.exists(path):
        raise ValueError(f"workflow {workflow_id!r} has no stored result")
    with open(path, "rb") as f:
        return pickle.load(f)


def list_all(storage: Optional[str] = None) -> List[Dict[str, Any]]:
    root = storage or _default_storage()
    out = []
    if not os.path.isdir(root):
        return out
    for wid in sorted(os.listdir(root)):
        status = get_status(wid, storage=root)
        if status is not None:
            out.append({"workflow_id": wid, "status": status})
    return out
