"""Driver bootstrap: start a local cluster (head) or connect to one.

The port's copy of `ray_tpu/core/distributed/driver.py`,
importing `ray_tpu_torch` only.

Analogue of the reference node bootstrap (ref: python/ray/_private/node.py
start_head_processes :1315 — GCS server then raylet then auxiliaries;
driver connect worker.py:2176).
"""
from __future__ import annotations

import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, List, Optional

from ray_tpu_torch.core.distributed.core_worker import DistributedCoreWorker
from ray_tpu_torch.core.distributed.protocol import RUNTIME

logger = logging.getLogger(__name__)

_HANDSHAKE_TIMEOUT = 60


def breadcrumb_path() -> str:
    """The file naming the last cluster a driver on this host joined or
    started, read by the CLI when it is given no address (the reference's
    /tmp/ray/ray_current_cluster). The port's own, beside JAX's
    `/tmp/ray_tpu_<uid>/`, so its CLI never finds a JAX head."""
    return os.path.join(tempfile.gettempdir(),
                        f"ray_tpu_torch_{os.getuid()}", "last_cluster.json")


def write_breadcrumb(gcs_address: str) -> None:
    """Per-uid dir with 0700, so another local user can't plant an
    address the CLI would trust."""
    path = breadcrumb_path()
    try:
        os.makedirs(os.path.dirname(path), mode=0o700, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"gcs_address": gcs_address, "ts": time.time()}, f)
    except OSError:
        pass


def child_env() -> Dict[str, str]:
    """Environment for spawned runtime processes: ensures the package root is
    importable even when ray_tpu_torch runs from a source checkout."""
    import ray_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(ray_tpu_torch.__file__)))
    env = dict(os.environ)
    parts = [pkg_root] + [p for p in env.get("PYTHONPATH", "").split(":")
                          if p]
    env["PYTHONPATH"] = ":".join(dict.fromkeys(parts))
    # Never inherit a parent-watch aimed at some OTHER process: a child
    # whose getppid() doesn't match would exit at its first poll.
    env.pop("RAY_TPU_WATCH_PPID", None)
    return env


def _read_handshake(proc: subprocess.Popen, pattern: str,
                    what: str) -> Dict[str, str]:
    """Read `KEY=VALUE ...` handshake line from a child's stdout.

    Non-blocking so the deadline holds even if the child is alive but
    silent (a blocking readline() would wait forever)."""
    deadline = time.monotonic() + _HANDSHAKE_TIMEOUT
    rx = re.compile(pattern)
    fd = proc.stdout.fileno()
    os.set_blocking(fd, False)
    buf = b""
    while time.monotonic() < deadline:
        try:
            chunk = os.read(fd, 4096)
        except BlockingIOError:
            chunk = None
        if chunk:
            buf += chunk
            m = rx.search(buf.decode(errors="replace"))
            if m:
                os.set_blocking(fd, True)
                return m.groupdict()
        elif proc.poll() is not None:
            raise RuntimeError(
                f"{what} exited with code {proc.returncode} during startup")
        else:
            time.sleep(0.01)
    raise RuntimeError(f"{what} did not hand-shake within "
                       f"{_HANDSHAKE_TIMEOUT}s")


# Pre-bound at import: preexec_fn runs between fork and exec in the
# child of a (usually multithreaded) parent, where taking the import or
# allocator lock can deadlock — the body must be one pre-resolved C call.
try:
    import ctypes as _ctypes
    import signal as _signal

    _PRCTL = _ctypes.CDLL("libc.so.6", use_errno=True).prctl
    _PDEATHSIG_ARGS = (1, int(_signal.SIGTERM), 0, 0, 0)  # PR_SET_PDEATHSIG
except Exception:  # noqa: BLE001 non-Linux / no libc
    _PRCTL = None


def pdeathsig_preexec():
    """preexec_fn: deliver SIGTERM to the child when its parent dies.

    A SIGKILL'd driver (OOM, `kill -9` on a test run) cannot run its
    atexit cleanup, and without this every GCS/daemon/worker it spawned
    lives on forever — leaked heartbeating clusters that interfere with
    the next run (the reference gets the same effect from raylet's
    parent-death monitoring). Linux-only; harmless no-op elsewhere."""
    if _PRCTL is not None:
        _PRCTL(*_PDEATHSIG_ARGS)


def _die_with_parent_env(env: Dict[str, str]) -> Dict[str, str]:
    """Mark a child to exit when THIS process dies (see watch_parent in
    this module). PR_SET_PDEATHSIG is unusable here: it fires when the
    forking THREAD exits, and the autoscaler launches nodes from
    short-lived threads — daemons got SIGTERM'd moments after boot."""
    env = dict(env)
    env["RAY_TPU_WATCH_PPID"] = str(os.getpid())
    return env


def start_watch_parent_thread() -> None:
    """Child side of die_with_parent: poll until the spawning parent is
    gone (we got reparented), then exit — a SIGKILL'd driver must not
    leave heartbeating clusters behind (ref: raylet parent-death
    monitoring). No-op unless RAY_TPU_WATCH_PPID is set."""
    import threading

    # lint: allow-knob -- spawn-time lifecycle handshake between parent and child, pre-config
    want = os.environ.get("RAY_TPU_WATCH_PPID")
    if not want:
        return
    want_pid = int(want)

    def watch():
        while True:
            time.sleep(1.0)
            if os.getppid() != want_pid:
                os._exit(0)

    threading.Thread(target=watch, daemon=True,
                     name="parent-watch").start()


def start_gcs_process(host: str = "127.0.0.1", port: int = 0,
                      storage_dir: Optional[str] = None,
                      die_with_parent: bool = True) -> tuple:
    cmd = [sys.executable, "-m", "ray_tpu_torch.core.distributed.gcs_server",
           "--host", host, "--port", str(port)]
    if storage_dir:
        cmd += ["--storage-dir", storage_dir]
    env = child_env()
    if die_with_parent:
        env = _die_with_parent_env(env)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=None,
                            env=env)
    info = _read_handshake(proc, r"GCS_PORT=(?P<port>\d+)", "GCS server")
    return proc, f"{host}:{info['port']}"


def start_node_daemon_process(
    gcs_address: str,
    *,
    host: str = "127.0.0.1",
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[dict] = None,
    store_dir: Optional[str] = None,
    object_store_memory: int = 0,
    node_id: Optional[str] = None,
    extra_env: Optional[dict] = None,
    die_with_parent: bool = True,
) -> tuple:
    cmd = [sys.executable, "-m", "ray_tpu_torch.core.distributed.node_daemon",
           "--gcs-address", gcs_address, "--host", host,
           "--resources", json.dumps(resources or {})]
    if num_cpus is not None:
        cmd += ["--num-cpus", str(num_cpus)]
    if num_gpus is not None:
        cmd += ["--num-gpus", str(num_gpus)]
    if store_dir:
        cmd += ["--store-dir", store_dir]
    if object_store_memory:
        cmd += ["--object-store-memory", str(object_store_memory)]
    if node_id:
        cmd += ["--node-id", node_id]
    env = child_env()
    if extra_env:
        env.update({k: str(v) for k, v in extra_env.items()})
    if die_with_parent:
        env = _die_with_parent_env(env)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=None,
                            env=env)
    info = _read_handshake(
        proc,
        r"DAEMON_PORT=(?P<port>\d+) NODE_ID=(?P<node_id>\w+) "
        r"STORE_DIR=(?P<store_dir>\S+)",
        "node daemon")
    return proc, {
        "address": f"{host}:{info['port']}",
        "node_id": info["node_id"],
        "store_dir": info["store_dir"],
    }


def connect_or_start_cluster(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[dict] = None,
    namespace: Optional[str] = None,
    object_store_memory: Optional[int] = None,
    log_to_driver: bool = True,
) -> DistributedCoreWorker:
    spawned: List[subprocess.Popen] = []
    if address is None:
        gcs_proc, gcs_address = start_gcs_process()
        spawned.append(gcs_proc)
        daemon_proc, node_info = start_node_daemon_process(
            gcs_address, num_cpus=num_cpus, num_gpus=num_gpus,
            resources=resources,
            object_store_memory=object_store_memory or 0)
        spawned.append(daemon_proc)
    else:
        gcs_address = address
        # Find this host's daemon via the GCS node table.
        from ray_tpu_torch.core.distributed.rpc import EventLoopThread, SyncRpcClient

        loop = EventLoopThread("bootstrap")
        gcs = SyncRpcClient(gcs_address, loop)
        try:
            runtime = gcs.call("NodeInfo", "runtime", timeout=10)
        except Exception:  # noqa: BLE001 the JAX package's head has no such call
            runtime = None
        if runtime != RUNTIME:
            gcs.close()
            loop.stop()
            raise RuntimeError(
                f"{address} is not a {RUNTIME} head: a {RUNTIME} driver "
                f"joins only its own runtime's clusters")
        node_info = None
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            nodes = [n for n in gcs.call("NodeInfo", "list_nodes",
                                         timeout=10) if n["alive"]]
            if nodes:
                # Prefer a daemon whose store dir exists locally (same host).
                local = [n for n in nodes
                         if os.path.isdir(n["store_dir"])]
                chosen = (local or nodes)[0]
                node_info = {"address": chosen["address"],
                             "node_id": chosen["node_id"],
                             "store_dir": chosen["store_dir"]}
                break
            time.sleep(0.2)
        gcs.close()
        loop.stop()
        if node_info is None:
            raise RuntimeError(f"no alive nodes behind GCS at {address}")

    job_id = uuid.uuid4().hex[:8]
    worker = DistributedCoreWorker(
        gcs_address=gcs_address,
        node_id=node_info["node_id"],
        daemon_address=node_info["address"],
        store_dir=node_info["store_dir"],
        job_id=job_id,
        is_driver=True,
        log_to_driver=log_to_driver,
    )
    worker._spawned_processes = spawned
    write_breadcrumb(gcs_address)
    worker.gcs.call("JobManager", "register_job", job_id=job_id,
                    driver_address=worker.address, runtime=RUNTIME,
                    timeout=30)
    return worker
