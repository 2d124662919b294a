"""JobSupervisor: the detached actor that owns one submitted job. The
port's copy of `ray_tpu/job_submission/supervisor.py`; its log file is
named `ray_tpu_torch_job_<id>.log`.

The entrypoint runs with the supervisor worker's own environment. The
daemon scopes `CUDA_VISIBLE_DEVICES` only for GPU leases, so a job's
driver sees the node's cards: it should leave CUDA alone and send its
GPU work to `num_gpus` tasks or actors.

Analogue of the reference `JobSupervisor`
(ref: dashboard/modules/job/job_manager.py:140 — a detached actor that
runs the entrypoint as a subprocess, polls it, and publishes terminal
status). Status + log tail live in GCS KV (namespace "job") so they
survive the supervisor itself.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import threading
import time

JOB_KV_NAMESPACE = b"job"
LOG_TAIL_BYTES = 1 << 20  # keep at most 1 MiB of trailing output in KV


class JobSupervisor:
    """One instance per submitted job, named `_job_supervisor_<id>`."""

    def __init__(self, submission_id: str, entrypoint: str,
                 metadata: dict, gcs_address: str,
                 env_vars: dict | None = None):
        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self.metadata = metadata or {}
        self.gcs_address = gcs_address
        self.env_vars = env_vars or {}
        self._proc: subprocess.Popen | None = None
        self._log_path = os.path.join(
            tempfile.gettempdir(), f"ray_tpu_torch_job_{submission_id}.log")
        self._stopped = False
        self._start_time = time.time()
        self._write_status("PENDING", "")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- kv state -------------------------------------------------------
    def _kv(self):
        from ray_tpu_torch.api import _global_worker

        return _global_worker()

    def _write_status(self, status: str, message: str) -> None:
        info = {
            "submission_id": self.submission_id,
            "entrypoint": self.entrypoint,
            "status": status,
            "message": message,
            "metadata": self.metadata,
            "start_time": self._start_time,
            "end_time": (time.time()
                         if status in ("SUCCEEDED", "FAILED", "STOPPED")
                         else None),
        }
        self._kv().kv_put(JOB_KV_NAMESPACE,
                          self.submission_id.encode(),
                          json.dumps(info).encode())

    def _flush_logs(self) -> None:
        try:
            with open(self._log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - LOG_TAIL_BYTES))
                tail = f.read()
        except OSError:
            tail = b""
        self._kv().kv_put(JOB_KV_NAMESPACE,
                          f"{self.submission_id}:logs".encode(), tail)

    # -- lifecycle ------------------------------------------------------
    def _run(self) -> None:
        env = dict(os.environ)
        env.update({k: str(v) for k, v in self.env_vars.items()})
        # The entrypoint's own ray_tpu_torch.init() should join THIS cluster
        # (the reference sets RAY_ADDRESS the same way).
        env["RAY_TPU_ADDRESS"] = self.gcs_address
        env["RAY_TPU_JOB_SUBMISSION_ID"] = self.submission_id
        with open(self._log_path, "wb") as logf:
            self._proc = subprocess.Popen(
                self.entrypoint, shell=True, env=env,
                stdout=logf, stderr=subprocess.STDOUT,
                start_new_session=True)
            self._write_status("RUNNING", "")
            while self._proc.poll() is None:
                time.sleep(0.5)
                self._flush_logs()
                # KV stop flag: lets HTTP-only clients (dashboard REST)
                # stop the job without an actor-call path into this
                # supervisor (ref: job_head.py stop → JobManager).
                if not self._stopped:
                    try:
                        flag = self._kv().kv_get(
                            JOB_KV_NAMESPACE,
                            f"{self.submission_id}:stop".encode())
                    except Exception:  # noqa: BLE001 GCS blip
                        flag = None
                    if flag:
                        # Consume the flag: a leftover would instantly
                        # kill a future job resubmitted under this id.
                        try:
                            self._kv().kv_del(
                                JOB_KV_NAMESPACE,
                                f"{self.submission_id}:stop".encode())
                        except Exception:  # noqa: BLE001
                            pass
                        self.stop()
        self._flush_logs()
        rc = self._proc.returncode
        if self._stopped:
            self._write_status("STOPPED", "stopped by user")
        elif rc == 0:
            self._write_status("SUCCEEDED", "")
        else:
            self._write_status(
                "FAILED", f"entrypoint exited with code {rc}")

    def ping(self) -> bool:
        return True

    def stop(self) -> bool:
        """SIGTERM the entrypoint's process group; SIGKILL after 3s."""
        if self._proc is None or self._proc.poll() is not None:
            return False
        self._stopped = True
        import signal

        try:
            os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass

        def hard_kill():
            time.sleep(3)
            if self._proc.poll() is None:
                try:
                    os.killpg(os.getpgid(self._proc.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass

        threading.Thread(target=hard_kill, daemon=True).start()
        return True

    def logs(self) -> bytes:
        try:
            with open(self._log_path, "rb") as f:
                return f.read()[-LOG_TAIL_BYTES:]
        except OSError:
            return b""
