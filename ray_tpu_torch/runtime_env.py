"""Runtime environments: per-task/actor/job execution environments; the
port's copy of `ray_tpu/runtime_env.py`.

Reference: python/ray/runtime_env/ARCHITECTURE.md + _private/runtime_env/
(plugins pip.py, conda.py, container.py, working_dir.py, py_modules.py;
URI cache uri_cache.py).
Same split here: the DRIVER normalizes the spec (packs local dirs into
content-addressed archives in the GCS KV), each NODE DAEMON builds envs
on demand into a local cache keyed by the spec hash, and workers are
spawned inside the built env (env vars, cwd, sys.path, venv python).

Supported fields:
    env_vars:    {"NAME": "value"}                  (applied at spawn)
    working_dir: "/local/dir"  -> packed, extracted as the worker's cwd
                 (also first on sys.path)
    py_modules:  ["/local/pkg_dir_or_file.py", ...] -> packed, on sys.path
    pip:         ["requests==...", "/local/pkg"]    -> venv with
                 --system-site-packages (and the parent's site dirs in a
                 .pth, so torch and ray_tpu_torch still import) + pip
                 install (offline-capable only for local paths in a
                 zero-egress cluster)
    conda:       "existing-env-name" or {yaml spec dict} -> workers run
                 on that conda env's python (ref: runtime_env/conda.py);
                 not together with pip
    container:   {"image": ..., "run_options": [...]} -> the worker
                 command is wrapped in podman/docker run
                 (ref: runtime_env/container.py)
    tpu_profiling: {"jax_trace_dir": d, "xla_dump_to": d2,
                 "log_compiles": bool} -> worker env vars
                 (`profiling_env_vars`; JAX's field and variable names):
                 `jax_trace_dir` makes `worker_main` trace the whole
                 worker with torch.profiler into a Chrome trace per pid
                 in `d`; `xla_dump_to` (XLA_FLAGS) and `log_compiles`
                 (JAX_LOG_COMPILES) are set as in JAX and read by
                 nothing in torch
    plugins:     {"pkg.module:PluginClass": config} -> custom plugin
                 classes loaded BY THE NODE DAEMON and run at build
                 time (ref: _private/runtime_env/plugin.py — dynamic
                 plugin classes resolved from a class path)
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from typing import Any, Dict, List, Optional

_SUPPORTED = ("env_vars", "working_dir", "py_modules", "pip", "conda",
              "container", "tpu_profiling", "plugins")
PKG_NAMESPACE = "pkg"


class RuntimeEnvPlugin:
    """Custom runtime-env plugin interface (ref:
    _private/runtime_env/plugin.py RuntimeEnvPlugin). Subclass it in an
    importable module and reference it as "pkg.module:ClassName" under
    the env's `plugins` field; the NODE DAEMON imports the class and
    calls `build` while materializing the env.

    `build(value, root)` receives the plugin's config value and the
    env's build directory; it returns a dict that may contain
    "env_vars" (merged into the worker environment). Raise ValueError
    from `validate` to reject bad specs driver-side."""

    @staticmethod
    def validate(value: Any) -> Any:
        return value

    def build(self, value: Any, root: str) -> Dict[str, Any]:
        raise NotImplementedError


def load_plugin(path: str) -> RuntimeEnvPlugin:
    """Resolve "pkg.module:ClassName" to a plugin instance."""
    import importlib

    mod_name, _, cls_name = path.partition(":")
    if not cls_name:
        raise ValueError(
            f"plugin path {path!r} must be 'pkg.module:ClassName'")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    if not (isinstance(cls, type) and issubclass(cls, RuntimeEnvPlugin)):
        raise ValueError(f"{path} is not a RuntimeEnvPlugin subclass")
    return cls()


def profiling_env_vars(spec: Dict[str, Any]) -> Dict[str, str]:
    """tpu_profiling spec -> worker env vars (shared by the agent and
    tests so the mapping cannot drift). The names are JAX's: the trace
    directory feeds `worker_main`'s torch.profiler hook; XLA_FLAGS and
    JAX_LOG_COMPILES are set for parity and do nothing in torch."""
    out: Dict[str, str] = {}
    flags = []
    if spec.get("xla_dump_to"):
        flags.append(f"--xla_dump_to={spec['xla_dump_to']}")
    if flags:
        out["XLA_FLAGS"] = " ".join(flags)
    if spec.get("jax_trace_dir"):
        # Consumed by worker_main: it starts a whole-process torch.profiler
        # trace into this directory (exported at exit or SIGTERM).
        out["RAY_TPU_JAX_TRACE_DIR"] = str(spec["jax_trace_dir"])
    if spec.get("log_compiles"):
        out["JAX_LOG_COMPILES"] = "1"
    return out


class RuntimeEnv(dict):
    """Validated runtime-env spec (ref: runtime_env/runtime_env.py)."""

    def __init__(self, *, env_vars: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None,
                 py_modules: Optional[List[str]] = None,
                 pip: Optional[List[str]] = None,
                 conda: Optional[Any] = None,
                 container: Optional[Dict[str, Any]] = None,
                 tpu_profiling: Optional[Dict[str, Any]] = None,
                 plugins: Optional[Dict[str, Any]] = None, **extra):
        unknown = set(extra) - set(_SUPPORTED)
        if unknown:
            raise ValueError(f"unsupported runtime_env fields: {unknown}")
        super().__init__()
        if env_vars:
            if not all(isinstance(k, str) and isinstance(v, str)
                       for k, v in env_vars.items()):
                raise TypeError("env_vars must be Dict[str, str]")
            self["env_vars"] = dict(env_vars)
        if working_dir:
            self["working_dir"] = working_dir
        if py_modules:
            self["py_modules"] = list(py_modules)
        if pip:
            self["pip"] = list(pip)
        if conda:
            self["conda"] = conda
        if container:
            self["container"] = dict(container)
        if tpu_profiling:
            self["tpu_profiling"] = dict(tpu_profiling)
        if plugins:
            self["plugins"] = dict(plugins)


def _zip_path(path: str) -> bytes:
    """Deterministic zip of a file or directory tree: fixed timestamps so
    the sha256 digest depends on CONTENT only (a fresh checkout or a
    `touch` must not defeat the content-addressed cache)."""
    buf = io.BytesIO()

    def add(z: zipfile.ZipFile, full: str, arcname: str) -> None:
        zi = zipfile.ZipInfo(arcname, date_time=(1980, 1, 1, 0, 0, 0))
        zi.compress_type = zipfile.ZIP_DEFLATED
        zi.external_attr = (os.stat(full).st_mode & 0o777) << 16
        with open(full, "rb") as f:
            z.writestr(zi, f.read())

    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        if os.path.isfile(path):
            add(z, path, os.path.basename(path))
        else:
            base = os.path.abspath(path)
            for root, dirs, files in os.walk(base):
                dirs.sort()
                if "__pycache__" in dirs:
                    dirs.remove("__pycache__")
                for f in sorted(files):
                    full = os.path.join(root, f)
                    add(z, full, os.path.relpath(full, base))
    return buf.getvalue()


def _upload_pkg(kv_put, data: bytes) -> str:
    digest = hashlib.sha256(data).hexdigest()[:32]
    uri = f"pkg://{digest}"
    kv_put(PKG_NAMESPACE.encode(), uri.encode(), data)
    return uri


def normalize(env: Optional[Dict[str, Any]], kv_put) -> Optional[dict]:
    """Driver-side: validate + replace local paths with content-addressed
    pkg:// URIs stored in the GCS KV (ref: working_dir upload to GCS,
    _private/runtime_env/packaging.py). Idempotent on normalized specs."""
    if not env:
        return None
    unknown = set(env) - set(_SUPPORTED)
    if unknown:
        raise ValueError(
            f"unsupported runtime_env fields: {sorted(unknown)} "
            f"(supported: {_SUPPORTED})")
    out: dict = {}
    if env.get("env_vars"):
        out["env_vars"] = dict(env["env_vars"])
    wd = env.get("working_dir")
    if wd:
        if wd.startswith("pkg://"):
            out["working_dir"] = wd
        else:
            if not os.path.isdir(wd):
                raise ValueError(f"working_dir {wd!r} is not a directory")
            out["working_dir"] = _upload_pkg(kv_put, _zip_path(wd))
    mods = env.get("py_modules")
    if mods:
        uris = []
        for m in mods:
            if m.startswith("pkg://"):
                uris.append(m)
            else:
                if not os.path.exists(m):
                    raise ValueError(f"py_module {m!r} does not exist")
                uris.append(_upload_pkg(kv_put, _zip_path(m)))
        out["py_modules"] = uris
    if env.get("pip"):
        out["pip"] = [str(r) for r in env["pip"]]
    conda = env.get("conda")
    if conda:
        if env.get("pip"):
            # Same rule as the reference: pip deps belong INSIDE the
            # conda spec (dependencies: [pip: [...]]), not alongside it.
            raise ValueError("runtime_env cannot set both 'conda' and "
                             "'pip'; add pip deps to the conda spec")
        if not isinstance(conda, (str, dict)):
            raise ValueError("conda must be an env name or a spec dict")
        out["conda"] = conda
    container = env.get("container")
    if container:
        if not isinstance(container, dict) or not container.get("image"):
            raise ValueError("container must be {'image': ..., "
                             "'run_options': [...]}")
        out["container"] = {
            "image": str(container["image"]),
            "run_options": [str(o) for o in
                            container.get("run_options") or ()],
        }
    prof = env.get("tpu_profiling")
    if prof:
        if not isinstance(prof, dict):
            raise ValueError("tpu_profiling must be a dict")
        known = {"xla_dump_to", "jax_trace_dir", "log_compiles"}
        bad = set(prof) - known
        if bad:
            raise ValueError(
                f"tpu_profiling fields {sorted(bad)} not in {sorted(known)}")
        out["tpu_profiling"] = dict(prof)
    plugins = env.get("plugins")
    if plugins:
        if not isinstance(plugins, dict):
            raise ValueError(
                "plugins must map 'pkg.module:ClassName' -> config")
        for path, value in plugins.items():
            # Import driver-side too: a typo'd class path should fail
            # at submission, not on every node daemon.
            load_plugin(path).validate(value)
        out["plugins"] = dict(plugins)
    return out or None


def env_hash(env: Optional[dict]) -> str:
    """Stable identity of a normalized spec (daemon cache key)."""
    if not env:
        return ""
    blob = json.dumps(env, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
