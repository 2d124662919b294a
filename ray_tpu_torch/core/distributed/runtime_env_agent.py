"""Node-side runtime-env builder (the runtime-env agent's job in the
reference, which fate-shares with the raylet — here it lives inside the
node daemon; ref: python/ray/runtime_env/ARCHITECTURE.md,
_private/runtime_env/{pip.py,working_dir.py,uri_cache.py}).

The port's copy of `ray_tpu/core/distributed/runtime_env_agent.py`,
importing `ray_tpu_torch` only. Each node builds into its own cache
directory (`node_env_dir`), so two daemons on one host never share a
build and the JAX package's cross-daemon lock is not needed.

Builds are cached by spec hash under the node's `<base>/<hash>/`:
    pkg/<uri-digest>/  extracted working_dir / py_modules archives
    venv/              --system-site-packages venv when pip reqs exist
    READY              marker: the venv build completed
    conda/, CONDA_READY  a conda env created from a spec dict
    plugins/<path>/    each plugin's build directory

`ensure_env` returns everything `_spawn_worker` needs: env vars, the
python executable, sys.path prepends, the worker cwd, and the container
that wraps the worker command.
"""
from __future__ import annotations

import asyncio
import io
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import zipfile
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.runtime_env import PKG_NAMESPACE, env_hash

logger = logging.getLogger(__name__)


def node_env_dir(node_id: str) -> str:
    """The node's runtime-env cache: under the configured log dir, else
    the temp dir, one directory per node."""
    from ray_tpu_torch.core.config import get_config

    return os.path.join(get_config().log_dir or tempfile.gettempdir(),
                        "ray_tpu_torch_runtime_envs", node_id[:12])


class RuntimeEnvBuildError(Exception):
    """Definitive build failure (bad pip spec, missing package, a failing
    plugin): callers must fail fast, not retry-rebuild."""


class BuiltEnv:
    def __init__(self, env_vars: Dict[str, str], python: str,
                 pythonpath: List[str], cwd: Optional[str],
                 container: Optional[Tuple[str, List[str], str]] = None):
        self.env_vars = env_vars
        self.python = python
        self.pythonpath = pythonpath
        self.cwd = cwd
        # Container plugin: (runtime, run_options, image).
        self.container = container

    def wrap_command(self, cmd: List[str], env: Dict[str, str],
                     name: Optional[str] = None) -> List[str]:
        """Wrap the worker argv in `podman/docker run`. env/cwd given to
        Popen only reach the container CLIENT process — everything the
        worker needs must ride -e/-w/-v flags (ref: container.py's
        podman command assembly). `name` makes the container killable by
        the daemon (`podman kill <name>`) — signalling the client process
        does NOT stop the container."""
        if not self.container:
            return cmd
        runtime, run_options, image = self.container
        flags: List[str] = []
        if name:
            flags += ["--name", name]
        # The package checkout must exist at the same path inside.
        import ray_tpu_torch as _rt

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(_rt.__file__)))
        flags += ["-v", f"{pkg_root}:{pkg_root}"]
        # Every framework knob resolves from RAY_TPU_* env (config.py);
        # non-container workers inherit ALL of os.environ — forward the
        # same configuration surface, not a hand-picked subset (the
        # lease's CUDA_VISIBLE_DEVICES included).
        for key, val in env.items():
            if key.startswith("RAY_TPU_") or key in (
                    "PYTHONPATH", "CUDA_VISIBLE_DEVICES"):
                flags += ["-e", f"{key}={val}"]
        for k, v in self.env_vars.items():
            flags += ["-e", f"{k}={v}"]
        if self.cwd:
            flags += ["-v", f"{self.cwd}:{self.cwd}", "-w", self.cwd]
        return [runtime, "run", "--rm", "--network=host",
                "-v", "/dev/shm:/dev/shm", "-v", "/tmp:/tmp",
                *flags, *run_options, image] + cmd


class RuntimeEnvBuilder:
    FAILURE_TTL_S = 120.0

    def __init__(self, gcs_client, base_dir: str):
        self._gcs = gcs_client
        self._base = base_dir
        self._built: Dict[str, BuiltEnv] = {}
        self._building: Dict[str, asyncio.Future] = {}
        # Negative cache: a failed build is not retried for FAILURE_TTL_S
        # (each attempt can cost a GCS fetch and an extraction).
        self._failed: Dict[str, Tuple[float, str]] = {}

    async def ensure_env(self, env: Optional[dict]) -> Optional[BuiltEnv]:
        import time

        if not env:
            return None
        key = env_hash(env)
        cached = self._built.get(key)
        if cached is not None:
            return cached
        failed = self._failed.get(key)
        if failed is not None:
            ts, msg = failed
            if time.monotonic() - ts < self.FAILURE_TTL_S:
                raise RuntimeEnvBuildError(msg)
            del self._failed[key]
        fut = self._building.get(key)
        if fut is not None:
            return await fut  # someone else is building it
        fut = asyncio.get_running_loop().create_future()
        self._building[key] = fut
        try:
            built = await self._build(key, env)
            self._built[key] = built
            fut.set_result(built)
            return built
        except asyncio.CancelledError:
            # RPC deadline/cancellation mid-build is NOT a build verdict:
            # don't poison the negative cache for a valid (just slow) env.
            fut.cancel()
            raise
        except Exception as e:  # noqa: BLE001
            msg = f"runtime_env build failed: {e}"
            self._failed[key] = (time.monotonic(), msg)
            err = RuntimeEnvBuildError(msg)
            fut.set_exception(err)
            # Consume the exception for waiters that never came.
            fut.exception()
            raise err from e
        finally:
            del self._building[key]

    # -- build steps ---------------------------------------------------
    async def _fetch_pkg(self, uri: str, dest: str) -> str:
        """Extract pkg://<digest> from the GCS KV into dest (cached)."""
        target = os.path.join(dest, uri.split("://", 1)[1])
        if os.path.isdir(target):
            return target
        blob = await self._gcs.call("KV", "get",
                                    namespace=PKG_NAMESPACE,
                                    key=uri.encode(), timeout=60)
        if blob is None:
            raise RuntimeError(f"runtime_env package {uri} not found in GCS")
        def extract():
            # Off-loop: a large archive would otherwise stall heartbeats
            # and lease granting for the whole decompression.
            tmp = target + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            with zipfile.ZipFile(io.BytesIO(blob)) as z:
                z.extractall(tmp)
            os.rename(tmp, target)

        await asyncio.get_running_loop().run_in_executor(None, extract)
        return target

    async def _build(self, key: str, env: dict) -> BuiltEnv:
        root = os.path.join(self._base, key)
        os.makedirs(root, exist_ok=True)
        env_vars = dict(env.get("env_vars") or {})
        pythonpath: List[str] = []
        cwd: Optional[str] = None
        python = sys.executable

        pkg_dir = os.path.join(root, "pkg")
        os.makedirs(pkg_dir, exist_ok=True)
        wd = env.get("working_dir")
        if wd:
            cwd = await self._fetch_pkg(wd, pkg_dir)
            pythonpath.append(cwd)
        for uri in env.get("py_modules") or ():
            mod_dir = await self._fetch_pkg(uri, pkg_dir)
            pythonpath.append(mod_dir)
        reqs = env.get("pip")
        if reqs:
            python = await self._build_venv(root, reqs)
        conda = env.get("conda")
        if conda:
            python = await self._build_conda(root, conda)

        def merge_env(add: Dict[str, str]) -> None:
            # XLA_FLAGS accumulate (node-process flags + user flags +
            # profiling dump + plugin flags must coexist — the built
            # value OVERWRITES the inherited one at spawn, so the
            # inherited flags must be folded in here); everything else
            # overwrites. torch reads none of them: the names are JAX's.
            if "XLA_FLAGS" in add:
                base = (env_vars.get("XLA_FLAGS")
                        or os.environ.get("XLA_FLAGS"))
                if base:
                    add = dict(add)
                    add["XLA_FLAGS"] = base + " " + add["XLA_FLAGS"]
            env_vars.update(add)

        prof = env.get("tpu_profiling")
        if prof:
            from ray_tpu_torch.runtime_env import profiling_env_vars

            merge_env(profiling_env_vars(prof))
        for path, value in (env.get("plugins") or {}).items():
            from ray_tpu_torch.runtime_env import load_plugin

            # Per-plugin directory: two plugins writing a same-named
            # artifact must not overwrite each other.
            plugin_root = os.path.join(
                root, "plugins", path.replace(":", "_").replace("/", "_"))
            os.makedirs(plugin_root, exist_ok=True)

            def run_plugin(p=path, v=value, r=plugin_root):
                return load_plugin(p).build(v, r)

            try:
                # Off-loop like the extraction: a slow plugin build
                # must not stall heartbeats and lease granting.
                built = await asyncio.get_running_loop().run_in_executor(
                    None, run_plugin)
                # Inside the try: a malformed result (env_vars: None,
                # non-dict) must carry the plugin's name, not surface
                # as an anonymous AttributeError.
                add = {str(k): str(v)
                       for k, v in ((built or {}).get("env_vars")
                                    or {}).items()}
            except Exception as e:  # noqa: BLE001
                raise RuntimeEnvBuildError(
                    f"runtime_env plugin {path} failed: {e}") from e
            merge_env(add)
        spec = None
        container = env.get("container")
        if container:
            spec = self._container_spec(container)
        return BuiltEnv(env_vars, python, pythonpath, cwd, container=spec)

    # -- conda plugin (ref: _private/runtime_env/conda.py) -------------
    def _conda_exe(self) -> str:
        # lint: allow-knob -- host toolchain discovery in the agent daemon, not a cluster knob
        exe = os.environ.get("RAY_TPU_CONDA_EXE") or shutil.which("conda")
        if not exe:
            raise RuntimeEnvBuildError(
                "runtime_env requests conda but no conda executable is "
                "available (set RAY_TPU_CONDA_EXE or install conda)")
        return exe

    async def _build_conda(self, root: str, conda) -> str:
        """Named env: resolve its python. Dict spec: create (cached by
        the env hash, READY marker like the pip venv)."""
        exe = self._conda_exe()
        loop = asyncio.get_running_loop()
        if isinstance(conda, str):
            def resolve():
                out = subprocess.run(
                    [exe, "run", "-n", conda, "python", "-c",
                     "import sys; print(sys.executable)"],
                    capture_output=True, text=True, timeout=120)
                lines = out.stdout.strip().splitlines()
                if out.returncode != 0 or not lines:
                    # Some conda versions swallow child stdout on rc=0 —
                    # either way a clear build error, not an IndexError.
                    raise RuntimeError(
                        f"conda env {conda!r} unusable (rc="
                        f"{out.returncode}): {out.stderr[-800:]}")
                return lines[-1]

            return await loop.run_in_executor(None, resolve)

        env_dir = os.path.join(root, "conda")
        python = os.path.join(env_dir, "bin", "python")
        ready = os.path.join(root, "CONDA_READY")
        if os.path.exists(ready) and os.path.exists(python):
            return python

        def create():
            import json as _json

            shutil.rmtree(env_dir, ignore_errors=True)
            spec_path = os.path.join(root, "environment.json")
            with open(spec_path, "w") as f:
                _json.dump(conda, f)
            out = subprocess.run(
                [exe, "env", "create", "-p", env_dir, "-f", spec_path],
                capture_output=True, text=True, timeout=1800)
            if out.returncode != 0:
                raise RuntimeError(
                    f"conda env create failed: {out.stderr[-2000:]}")
            with open(ready, "w") as f:
                f.write("ok")

        await loop.run_in_executor(None, create)
        return python

    # -- container plugin (ref: _private/runtime_env/container.py) -----
    def _container_spec(self, container: dict
                        ) -> Tuple[str, List[str], str]:
        image = container.get("image")
        if not image:
            raise RuntimeEnvBuildError("container runtime_env needs "
                                       "an 'image'")
        # lint: allow-knob -- host toolchain discovery in the agent daemon, not a cluster knob
        runtime = (os.environ.get("RAY_TPU_CONTAINER_RUNTIME")
                   or shutil.which("podman") or shutil.which("docker"))
        if not runtime:
            raise RuntimeEnvBuildError(
                "runtime_env requests a container but neither podman nor "
                "docker is available (set RAY_TPU_CONTAINER_RUNTIME)")
        return (runtime, [str(o) for o in container.get("run_options",
                                                        ())], str(image))

    async def _build_venv(self, root: str, reqs: List[str]) -> str:
        """--system-site-packages venv + pip install (ref: pip.py builds
        a virtualenv per requirements hash). Runs in a thread; serialized
        per env by ensure_env's in-flight future."""
        venv_dir = os.path.join(root, "venv")
        python = os.path.join(venv_dir, "bin", "python")
        ready = os.path.join(root, "READY")
        if os.path.exists(ready) and os.path.exists(python):
            return python

        def build():
            shutil.rmtree(venv_dir, ignore_errors=True)
            subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages",
                 venv_dir],
                check=True, capture_output=True, timeout=300)
            # When this process itself runs inside a venv,
            # --system-site-packages exposes the BASE python's packages,
            # not ours (torch may live in the parent venv). A .pth makes
            # the parent's site-packages visible too; venv-local installs
            # still take precedence on sys.path.
            import site

            parent_sites = [p for p in site.getsitepackages()
                            if os.path.isdir(p)]
            vsite = os.path.join(
                venv_dir, "lib",
                f"python{sys.version_info.major}.{sys.version_info.minor}",
                "site-packages")
            with open(os.path.join(vsite, "_raytpu_parent.pth"), "w") as f:
                f.write("\n".join(parent_sites) + "\n")
            out = subprocess.run(
                [python, "-m", "pip", "install", "--no-input",
                 "--disable-pip-version-check", "--no-build-isolation",
                 *reqs],
                capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                raise RuntimeError(
                    f"pip install failed: {out.stderr[-2000:]}")
            with open(ready, "w") as f:
                f.write("ok")

        await asyncio.get_running_loop().run_in_executor(None, build)
        return python
