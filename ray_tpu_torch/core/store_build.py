"""Build the native shared-memory store (g++ → .so), caching by source
mtime; counterpart of `ray_tpu/native/build.py`.

`csrc/object_store.cc` (the port's copy of the store) compiles as one
translation unit into `_build/libray_tpu_torch_store.so` at first use. The
`store_lib` knob (`RAY_TPU_STORE_LIB`) names a prebuilt library instead.
"""
from __future__ import annotations

import os
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "object_store.cc")
_OUT_DIR = os.path.join(_PKG_DIR, "_build")
_LIB = os.path.join(_OUT_DIR, "libray_tpu_torch_store.so")
_lock = threading.Lock()


def library_path() -> str:
    """Return the path to the built library, building if stale/missing.

    Cross-process safe: concurrent workers serialize on an flock and use
    per-pid temp names so a half-written .so is never published."""
    from ray_tpu_torch.core.config import get_config

    override = get_config().store_lib
    if override:
        return override
    with _lock:
        if (os.path.exists(_LIB)
                and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
            return _LIB
        os.makedirs(_OUT_DIR, exist_ok=True)
        import fcntl

        with open(os.path.join(_OUT_DIR, ".store_build.lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                # Re-check under the lock: another process may have built it.
                if (not os.path.exists(_LIB)
                        or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                    tmp = f"{_LIB}.tmp.{os.getpid()}"
                    cmd = [
                        "g++", "-O2", "-g", "-std=c++17", "-shared", "-fPIC",
                        "-Wall", "-o", tmp, _SRC, "-lpthread",
                    ]
                    subprocess.run(cmd, check=True, capture_output=True,
                                   text=True)
                    os.replace(tmp, _LIB)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
    return _LIB
