"""Usage stats: what a cluster runs, recorded locally.

The port's copy of `ray_tpu/util/usage_stats.py`, importing
`ray_tpu_torch` only.

ref: python/ray/_private/usage/usage_lib.py — the reference collects
cluster metadata + library-usage tags and (opt-out) reports them.
Divergences here: collection is in-memory + local-file only, and
REPORTING IS OPT-IN (RAY_TPU_USAGE_STATS_ENABLED=1 AND an explicit
report URL): silent egress from a GPU cluster is a bug, not a default.
`shutdown()` writes the session snapshot (`usage_stats_path`, else a
file in the temp dir).
"""
from __future__ import annotations

import json
import os
import platform
import threading
import time
from typing import Any, Dict, List, Optional

_lock = threading.Lock()
_library_usages: set = set()
_extra_tags: Dict[str, str] = {}
_start_time = time.time()


def usage_stats_enabled() -> bool:
    from ray_tpu_torch.core.config import get_config

    return bool(get_config().usage_stats_enabled)


def record_library_usage(library: str) -> None:
    """Tag that a library (data/train/tune/serve/rllib/...) was used
    in this process (ref: usage_lib.record_library_usage)."""
    with _lock:
        _library_usages.add(library)


def record_extra_usage_tag(key: str, value: str) -> None:
    with _lock:
        _extra_tags[str(key)] = str(value)


def get_library_usages() -> List[str]:
    with _lock:
        return sorted(_library_usages)


def _get_extra_tags() -> Dict[str, str]:
    with _lock:
        return dict(_extra_tags)


def collect_usage_snapshot() -> Dict[str, Any]:
    """Everything a report would contain — inspectable by the user
    BEFORE anything leaves the machine."""
    from ray_tpu_torch import __version__

    snap: Dict[str, Any] = {
        "schema_version": 1,
        # JAX's key name, so a reader of either package's snapshot finds it.
        "ray_tpu_version": __version__,
        "python_version": platform.python_version(),
        "os": platform.system().lower(),
        "uptime_s": round(time.time() - _start_time, 1),
        "libraries_used": get_library_usages(),
        "extra_tags": _get_extra_tags(),
    }
    try:
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            # Dead nodes keep their last-known resources in nodes();
            # counting them would double-book capacity.
            nodes = [n for n in ray_tpu_torch.nodes() if n.get("Alive")]
            snap["num_nodes"] = len(nodes)
            total: Dict[str, float] = {}
            for n in nodes:
                for k, v in (n.get("Resources") or {}).items():
                    total[k] = total.get(k, 0.0) + float(v)
            snap["cluster_resources"] = {
                k: v for k, v in sorted(total.items())
                if not k.startswith("node:")}
    except Exception:  # noqa: BLE001 — snapshot must never fail
        pass
    return snap


def write_usage_snapshot(path: str) -> str:
    """Persist the snapshot to `path` (the reference writes
    usage_stats.json into the session dir; the caller names the file,
    nothing is written anywhere else)."""
    snap = collect_usage_snapshot()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snap, f, indent=2)
    os.replace(tmp, path)
    return path


def report_usage(url: Optional[str] = None,
                 timeout_s: float = 10.0) -> bool:
    """POST the snapshot to `url` (or RAY_TPU_USAGE_STATS_URL) —
    ONLY when usage stats are explicitly enabled. Returns whether a
    report was sent; failures are swallowed (reporting must never
    break a workload, same rule as the reference)."""
    if not usage_stats_enabled():
        return False
    from ray_tpu_torch.core.config import get_config

    url = url or get_config().usage_stats_url or None
    if not url:
        return False
    try:
        import urllib.request

        body = json.dumps(collect_usage_snapshot()).encode()
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout_s):
            pass
        return True
    except Exception:  # noqa: BLE001
        return False
