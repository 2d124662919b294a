"""Node-side runtime-env builder (the runtime-env agent's job in the
reference, which fate-shares with the raylet — here it lives inside the
node daemon; ref: python/ray/runtime_env/ARCHITECTURE.md,
_private/runtime_env/{working_dir.py,uri_cache.py}).

The port's copy of `ray_tpu/core/distributed/runtime_env_agent.py`,
importing `ray_tpu_torch` only. It builds env_vars, working_dir,
py_modules and plugin envs; pip, conda and container envs are refused
by `ray_tpu_torch.runtime_env.normalize` (ROADMAP queue A, item 10a-iii).

Builds are cached by spec hash under the node's `<base>/<hash>/`:
    pkg/<uri-digest>/  extracted working_dir / py_modules archives
    plugins/<path>/    each plugin's build directory

`ensure_env` returns everything `_spawn_worker` needs: env vars,
sys.path prepends, and the worker cwd.
"""
from __future__ import annotations

import asyncio
import io
import logging
import os
import shutil
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
    """Definitive build failure (a missing package, a failing plugin):
    callers must fail fast, not retry-rebuild."""


class BuiltEnv:
    def __init__(self, env_vars: Dict[str, str], pythonpath: List[str],
                 cwd: Optional[str]):
        self.env_vars = env_vars
        self.pythonpath = pythonpath
        self.cwd = cwd


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

        pkg_dir = os.path.join(root, "pkg")
        os.makedirs(pkg_dir, exist_ok=True)
        wd = env.get("working_dir")
        if wd:
            cwd = await self._fetch_pkg(wd, pkg_dir)
            pythonpath.append(cwd)
        for uri in env.get("py_modules") or ():
            mod_dir = await self._fetch_pkg(uri, pkg_dir)
            pythonpath.append(mod_dir)

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
            env_vars.update(add)
        return BuiltEnv(env_vars, pythonpath, cwd)
