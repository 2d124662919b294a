"""Durable workflows: DAG execution with storage-backed step memoization.

Analogue of the reference workflow library (ref: python/ray/workflow/ —
workflow_executor.py drives a DAG, workflow_storage.py persists each
step's output so a crashed/resumed run skips completed steps). Scope-
minimal but real: `run()` executes a ray_tpu_torch DAG checkpointing every
node's result under `<storage>/<workflow_id>/`; `resume()` re-runs the
same DAG and loads any step whose result is already durable, re-executing
only the missing suffix.
"""
from ray_tpu_torch.workflow.api import (
    catch,
    continuation,
    event,
    get_output,
    get_status,
    list_all,
    resume,
    retry,
    run,
    run_async,
    send_event,
)

__all__ = ["run", "run_async", "resume", "get_output", "get_status",
           "list_all", "event", "send_event", "catch", "continuation",
           "retry"]

# Usage tagging (ref: usage_lib.record_library_usage; local-only,
# see ray_tpu_torch/util/usage_stats.py)
from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu

_rlu("workflow")
del _rlu
