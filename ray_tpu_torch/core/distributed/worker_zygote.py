"""Worker zygote: forkserver-style warm worker template process.

The port's copy of `ray_tpu/core/distributed/worker_zygote.py`,
importing `ray_tpu_torch` only.

Analogue of the reference worker pool's prestart machinery
(ref: src/ray/raylet/worker_pool.h:347 PrestartWorkers + the idle pool),
taken one step further in the direction CPython itself went with
`multiprocessing`'s forkserver: instead of paying a full interpreter
boot + `import ray_tpu_torch` + RPC-stack import for EVERY worker/actor, the
node daemon launches ONE zygote per runtime-env key. The zygote
pre-imports `worker_main` up to (but not including) any connection or
event-loop setup, then sits single-threaded on a unix socket; each
lease/actor start becomes one `os.fork()` (~ms) whose child completes
only the per-worker setup — worker_id, log redirection, env deltas,
registration with the daemon.

Fork-safety contract: the zygote never creates threads, event loops, or
sockets-to-the-control-plane before forking (the listener socket is
closed in the child). Preloaded modules must be import-side-effect
clean; `threading.active_count() > 1` after preload logs a loud warning
and the daemon's spawn path falls back to cold `subprocess.Popen` when a
fork request fails for any reason. Platforms where fork is unsafe or
unavailable (non-Linux) and containerized/foreign-python runtime envs
never reach this module — `NodeDaemon._zygote_compatible` gates them to
the cold path.

Wire protocol (newline-delimited JSON over a unix stream socket):

    -> {"op": "fork", "worker_id": .., "out": .., "err": .., "env": {..}}
    <- {"ok": true, "pid": 1234}
    -> {"op": "ping"}
    <- {"ok": true, "pid": .., "forks": N, "threads": 1,
        "torch_loaded": true, "cuda_initialized": false,
        "cuda_driver_initialized": false}

A forked child sets the `env` it is sent (a lease's
``CUDA_VISIBLE_DEVICES``) before anything in it touches CUDA; that holds
only while the zygote has initialised neither torch's CUDA state nor the
driver itself, and has never asked torch for a device count (torch caches
it), which is what `ping` reports.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import select
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_FORK_SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGCHLD)


class ZygoteError(Exception):
    """A zygote request failed; the caller should cold-spawn instead."""


class ZygoteBooting(ZygoteError):
    """The zygote is alive but not listening yet; the caller should
    cold-spawn this worker and keep the zygote."""


# ----------------------------------------------------------------------
# server side (the zygote process itself)
# ----------------------------------------------------------------------
def _preload(modules: List[str]) -> None:
    import importlib

    for mod in modules:
        if not mod:
            continue
        try:
            importlib.import_module(mod)
        except Exception as e:  # noqa: BLE001 preload is best-effort
            logger.warning("zygote preload of %s failed: %s", mod, e)


def _child_main(req: dict, args) -> None:
    """Forked child: per-worker setup only, then the normal worker body.
    Must never return into the zygote's serve loop."""
    try:
        # Inherited zygote fds must not outlive the fork: a child keeping
        # the listener open would hold the socket file hostage after a
        # zygote crash.
        os.closerange(3, 256)
        for sig in _FORK_SIGNALS:
            signal.signal(sig, signal.SIG_DFL)
        # PDEATHSIG is cleared by fork: re-arm so workers fate-share with
        # the zygote (which itself fate-shares with the daemon) — a
        # SIGKILL'd daemon must not leak a forked worker tree.
        from ray_tpu_torch.core.distributed.driver import pdeathsig_preexec

        pdeathsig_preexec()
        # Per-worker log files, same layout the cold path gives Popen —
        # the LogMonitor tails them identically.
        out_fd = os.open(req["out"],
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        err_fd = os.open(req["err"],
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.dup2(out_fd, 1)
        os.dup2(err_fd, 2)
        os.close(out_fd)
        os.close(err_fd)
        os.environ.update(req.get("env") or {})
        os.environ["RAY_TPU_WORKER_ID"] = req["worker_id"]
        # The parent's PRNG state is shared by every fork sibling.
        import random

        random.seed()
        import types

        from ray_tpu_torch.core.distributed import worker_main

        ns = types.SimpleNamespace(
            gcs_address=args.gcs_address,
            daemon_address=args.daemon_address,
            node_id=args.node_id,
            store_dir=args.store_dir,
            worker_id=req["worker_id"],
        )
        worker_main.STARTED_BY = "zygote"
        worker_main.boot_worker(ns)
        os._exit(0)
    except SystemExit as e:
        os._exit(int(e.code or 0))
    except BaseException:  # noqa: BLE001
        import traceback

        traceback.print_exc(file=sys.stderr)
        sys.stderr.flush()
        os._exit(1)


def cuda_driver_initialized() -> bool:
    """Whether this process has initialised the CUDA driver (cuInit),
    found without initialising it: before cuInit, cuDeviceGetCount
    answers CUDA_ERROR_NOT_INITIALIZED (3). A process that has not even
    mapped libcuda has not."""
    try:
        with open("/proc/self/maps") as f:
            if "libcuda.so" not in f.read():
                return False
        import ctypes

        lib = ctypes.CDLL("libcuda.so.1",
                          mode=os.RTLD_NOLOAD | os.RTLD_LAZY)
        count = ctypes.c_int()
        return lib.cuDeviceGetCount(ctypes.byref(count)) != 3
    except (OSError, AttributeError):
        return False


def _reap_children() -> None:
    """Collect exited fork children so liveness checks in the daemon
    (which reads /proc, not waitpid — it is not the parent) see them
    disappear instead of lingering as zombies."""
    while True:
        try:
            pid, _status = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def serve(args) -> None:
    import threading

    # Everything a forked child would otherwise import lazily during its
    # boot — paid once here instead of per worker (a cold child burned
    # ~17ms on `import psutil` + the store dlopen alone, the bulk of its
    # core-worker init). All fork-safe: pure module defs, no threads.
    # torch too: its import touches no CUDA, so a forked worker
    # initialises CUDA itself on first use (a process that had
    # initialised it could not fork workers that use the cards; `ping`
    # reports `cuda_initialized` so tests hold the zygote to that).
    modules = [
        "ray_tpu_torch", "ray_tpu_torch.core.distributed.worker_main",
        "ray_tpu_torch.api", "ray_tpu_torch.core.object_store",
        "ray_tpu_torch.core.distributed.pull_manager",
        "ray_tpu_torch.core.distributed.driver", "psutil", "torch",
    ]
    modules += [m.strip() for m in (args.preload or "").split(",")]
    _preload(modules)
    try:
        # dlopen the native store lib in the template (the mapping is
        # inherited over fork; rts_connect still happens per child).
        from ray_tpu_torch.core.object_store import get_lib

        get_lib()
    except Exception as e:  # noqa: BLE001 children fall back to own dlopen
        logger.warning("zygote store-lib preload failed: %s", e)
    if threading.active_count() > 1:
        logger.warning(
            "zygote has %d threads after preload (%s) — forked children "
            "may inherit locked state; consider trimming "
            "RAY_TPU_ZYGOTE_PRELOAD",
            threading.active_count(),
            [t.name for t in threading.enumerate()])

    try:
        os.unlink(args.socket_path)
    except FileNotFoundError:
        pass
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(args.socket_path)
    listener.listen(16)
    logger.info("zygote %d serving on %s (preloaded %d modules)",
                os.getpid(), args.socket_path, len(modules))

    conns: Dict[socket.socket, bytes] = {}
    forks = 0
    while True:
        ready, _, _ = select.select([listener] + list(conns), [], [], 0.25)
        _reap_children()
        for sock in ready:
            if sock is listener:
                conn, _addr = listener.accept()
                conns[conn] = b""
                continue
            try:
                chunk = sock.recv(65536)
            except OSError:
                chunk = b""
            if not chunk:
                sock.close()
                conns.pop(sock, None)
                continue
            conns[sock] = buf = conns[sock] + chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                conns[sock] = buf
                try:
                    req = json.loads(line)
                except ValueError:
                    _reply(sock, {"ok": False, "error": "bad json"})
                    continue
                op = req.get("op")
                if op == "ping":
                    torch = sys.modules.get("torch")
                    _reply(sock, {"ok": True, "pid": os.getpid(),
                                  "forks": forks,
                                  "threads": threading.active_count(),
                                  "torch_loaded": torch is not None,
                                  "cuda_initialized": bool(
                                      torch is not None
                                      and torch.cuda.is_initialized()),
                                  "cuda_driver_initialized":
                                      cuda_driver_initialized()})
                elif op == "shutdown":
                    _reply(sock, {"ok": True})
                    os._exit(0)
                elif op == "fork":
                    sys.stdout.flush()
                    sys.stderr.flush()
                    pid = os.fork()
                    if pid == 0:
                        listener.close()
                        for c in conns:
                            c.close()
                        _child_main(req, args)
                        os._exit(1)  # unreachable
                    forks += 1
                    # The child's pid CANNOT be reaped before this
                    # single-threaded loop reaches waitpid, so the
                    # starttime read here is authoritative — it is the
                    # daemon's proof of pid incarnation (pid_max is
                    # 32768 on small hosts; a 1k-worker pool cycles the
                    # pid space in minutes, and signalling a reused raw
                    # pid kills an innocent process).
                    _reply(sock, {"ok": True, "pid": pid,
                                  "starttime": _proc_starttime(pid)})
                else:
                    _reply(sock, {"ok": False,
                                  "error": f"unknown op {op!r}"})


def _reply(sock: socket.socket, obj: dict) -> None:
    try:
        sock.sendall(json.dumps(obj).encode() + b"\n")
    except OSError:
        pass


def _proc_starttime(pid: int) -> int:
    """Kernel starttime (jiffies since boot, /proc/<pid>/stat field 22)
    of this pid's CURRENT incarnation; 0 if unreadable. (pid, starttime)
    uniquely names a process for the life of the boot — the identity
    check that makes signalling raw non-child pids safe under reuse."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            return int(f.read().rsplit(b")", 1)[1].split()[19])
    except (OSError, IndexError, ValueError):
        return 0


# ----------------------------------------------------------------------
# client side (lives in the node daemon)
# ----------------------------------------------------------------------
class ZygoteHandle:
    """Daemon-side handle: the zygote Popen plus its control socket.

    Requests are serialized (the daemon's event loop is single-threaded
    and fork replies arrive in ~ms); every socket error closes the
    connection and raises ZygoteError so the caller can retire this
    zygote and cold-spawn."""

    def __init__(self, proc: subprocess.Popen, socket_path: str,
                 env_key: str = ""):
        self.proc = proc
        self.socket_path = socket_path
        self.env_key = env_key
        self.started_at = time.monotonic()
        self.forks = 0
        self._sock: Optional[socket.socket] = None
        self._rbuf = b""

    def alive(self) -> bool:
        return self.proc.poll() is None

    # -- plumbing -------------------------------------------------------
    def try_connect(self) -> bool:
        """One non-blocking attempt: True once the control socket is
        connected, False while the zygote is still booting; raises
        ZygoteError if it exited."""
        if self._sock is not None:
            return True
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.settimeout(2.0)
            s.connect(self.socket_path)
        except OSError as e:
            s.close()
            if not self.alive():
                raise ZygoteError(
                    f"zygote exited with code {self.proc.returncode}"
                ) from e
            return False
        self._sock = s
        self._rbuf = b""
        return True

    def _connect(self, boot_wait: float) -> None:
        deadline = time.monotonic() + boot_wait
        while not self.try_connect():
            if time.monotonic() >= deadline:
                raise ZygoteBooting(
                    f"zygote socket not ready within {boot_wait:.1f}s")
            time.sleep(0.02)

    def request(self, obj: dict, timeout: float = 5.0,
                boot_wait: float = 5.0) -> dict:
        self._connect(boot_wait)
        sock = self._sock
        try:
            sock.settimeout(timeout)
            sock.sendall(json.dumps(obj).encode() + b"\n")
            while b"\n" not in self._rbuf:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ZygoteError("zygote closed the control socket")
                self._rbuf += chunk
            line, self._rbuf = self._rbuf.split(b"\n", 1)
            return json.loads(line)
        except ZygoteError:
            self._close_sock()
            raise
        except (OSError, ValueError) as e:
            self._close_sock()
            raise ZygoteError(f"zygote request failed: {e!r}") from e

    def _close_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._rbuf = b""

    # -- operations -----------------------------------------------------
    def fork_worker(self, worker_id: str, out_path: str, err_path: str,
                    env: Optional[Dict[str, str]] = None,
                    boot_wait: float = 5.0) -> "ForkedProc":
        reply = self.request(
            {"op": "fork", "worker_id": worker_id, "out": out_path,
             "err": err_path, "env": env or {}}, boot_wait=boot_wait)
        if not reply.get("ok"):
            raise ZygoteError(f"fork refused: {reply.get('error')}")
        self.forks += 1
        return ForkedProc(int(reply["pid"]),
                          int(reply.get("starttime") or 0))

    def ping(self, boot_wait: float = 5.0) -> dict:
        return self.request({"op": "ping"}, boot_wait=boot_wait)

    def kill(self) -> None:
        self._close_sock()
        try:
            self.proc.kill()
        except Exception:  # noqa: BLE001
            pass
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass


class ForkedProc:
    """Popen-shaped shim for a zygote-forked worker.

    The daemon is NOT the parent of a forked worker (the zygote is, and
    reaps it), so Popen semantics are emulated: liveness comes from
    /proc/<pid>/stat — a Z/X state or a missing entry means dead. The
    exact exit code is not observable from here; -1 stands in (only
    log/reporting paths read it).

    Every check and signal verifies the pid's INCARNATION against the
    starttime the zygote captured at fork. Popen never needs this (the
    kernel holds a child's pid until the parent reaps it), but this
    shim holds raw non-child pids: with pid_max=32768 a 1k-worker pool
    cycles the pid space in minutes, and an unverified kill() here once
    SIGTERM'd the zygote itself through a recycled pid."""

    def __init__(self, pid: int, starttime: int = 0):
        self.pid = pid
        self.starttime = starttime
        self.returncode: Optional[int] = None
        self._last_stat = 0.0

    def _stat(self) -> Optional[Tuple[bytes, int]]:
        """(state_char, starttime) of whatever owns this pid NOW, or
        None if the pid is free."""
        try:
            with open(f"/proc/{self.pid}/stat", "rb") as f:
                # fields after the ")" that closes comm (comm may itself
                # contain spaces/parens): [0]=state, [19]=starttime.
                fields = f.read().rsplit(b")", 1)[1].split()
            return fields[0], int(fields[19])
        except (OSError, IndexError, ValueError):
            return None

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        # Fast path: one signal-0 syscall. The daemon polls every worker
        # a few times a second — with a 1k-worker warm pool, opening
        # /proc/<pid>/stat each time is a measurable bite of a small
        # host's CPU, while kill(pid, 0) is ~1µs.
        try:
            os.kill(self.pid, 0)
        except ProcessLookupError:
            self.returncode = -1
            return self.returncode
        except OSError:
            pass  # EPERM: someone else's pid (reuse); confirm below
        # kill(0) cannot see a ZOMBIE (dead, but unreaped by the zygote
        # for up to one reap cycle, ~0.25s) or a recycled pid: confirm
        # state + incarnation via /proc at most every 5s — at a
        # 1k-worker pool a 2x/s cadence alone cost ~5% of a small
        # host's core in /proc opens.
        now = time.monotonic()
        if now - self._last_stat < 5.0:
            return None
        self._last_stat = now
        st = self._stat()
        if (st is None or st[0] in (b"Z", b"X", b"x")
                or (self.starttime and st[1] != self.starttime)):
            self.returncode = -1
        return self.returncode

    def poll_now(self) -> Optional[int]:
        """`poll` with the /proc confirmation forced: a worker that exited
        moments ago is a zombie until the zygote reaps it (up to one reap
        cycle), and kill(pid, 0) still succeeds on a zombie. Handing out
        or pooling a worker must not trust that: a task whose process
        died returns its lease at once, and without this check the
        zombie went back to the idle pool and the next actor creation
        was granted to it and failed to connect."""
        self._last_stat = 0.0
        return self.poll()

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)

    def _signal(self, sig: int) -> None:
        if self.returncode is not None:
            return
        st = self._stat()
        if st is None or (self.starttime and st[1] != self.starttime):
            # Worker already gone; whoever holds the pid now (if anyone)
            # is an innocent bystander — never signal it.
            self.returncode = -1
            return
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            self.returncode = -1


def start_zygote(*, gcs_address: str, daemon_address: str, node_id: str,
                 store_dir: str, socket_path: str, log_path: str,
                 env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None,
                 preload: str = "") -> subprocess.Popen:
    """Spawn a zygote process (non-blocking — connect happens lazily on
    the first fork request)."""
    from ray_tpu_torch.core.distributed.driver import (child_env,
                                                 pdeathsig_preexec)

    cmd = [
        sys.executable, "-m", "ray_tpu_torch.core.distributed.worker_zygote",
        "--gcs-address", gcs_address,
        "--daemon-address", daemon_address,
        "--node-id", node_id,
        "--store-dir", store_dir,
        "--socket-path", socket_path,
    ]
    if preload:
        cmd += ["--preload", preload]
    penv = child_env()
    if env:
        penv.update({k: str(v) for k, v in env.items()})
    log_f = open(log_path, "ab")
    try:
        proc = subprocess.Popen(cmd, env=penv, cwd=cwd, stdout=log_f,
                                stderr=log_f,
                                preexec_fn=pdeathsig_preexec)
    finally:
        log_f.close()
    return proc


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--daemon-address", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--store-dir", required=True)
    parser.add_argument("--socket-path", required=True)
    parser.add_argument("--preload", default="")
    args = parser.parse_args()
    logging.basicConfig(
        level=logging.INFO,
        format="[zygote] %(asctime)s %(levelname)s %(message)s")
    try:
        serve(args)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
