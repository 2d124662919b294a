"""JobSubmissionClient: the user-facing job SDK. The port's copy of
`ray_tpu/job_submission/client.py`.

Analogue of the reference client (ref: dashboard/modules/job/sdk.py:39
JobSubmissionClient — submit_job/get_job_status/get_job_logs/stop_job/
list_jobs/delete_job). The reference round-trips through the dashboard
REST API; ours supports BOTH transports: `address="http://host:port"`
speaks the dashboard REST API (submit/status/logs/stop/list — a
non-Python client needs nothing but HTTP, ref: job_head.py routes),
while a GCS address (or None) joins the cluster directly as a driver
and drives the detached JobSupervisor actor + GCS KV records.
"""
from __future__ import annotations

import dataclasses
import json
import time
import uuid
from typing import Dict, List, Optional

from ray_tpu_torch.job_submission.supervisor import JOB_KV_NAMESPACE, JobSupervisor


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclasses.dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str
    message: str = ""
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)
    start_time: Optional[float] = None
    end_time: Optional[float] = None


def parse_job_records(items: Dict[bytes, Optional[bytes]]) -> List[JobInfo]:
    """Decode raw KV entries from the "job" namespace into JobInfo rows.

    The single owner of the KV layout (sub-keys carry a ':' — e.g.
    '<id>:logs' — and are not job records); the CLI, dashboard, and
    client all list jobs through this."""
    out = []
    for key, raw in items.items():
        if b":" in key or raw is None:
            continue
        out.append(JobInfo(**json.loads(raw.decode())))
    return sorted(out, key=lambda j: j.start_time or 0)


class JobSubmissionClient:
    """Submit shell entrypoints to a cluster and track them.

    `address` is the GCS address ("host:port"); None uses/starts the
    ambient cluster via ray_tpu_torch.init().
    """

    def __init__(self, address: Optional[str] = None):
        self._http: Optional[str] = None
        if address is not None and address.startswith(("http://",
                                                       "https://")):
            self._http = address.rstrip("/")
            self._worker = None
            return
        import ray_tpu_torch

        if address is not None and not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address, ignore_reinit_error=True)
        else:
            ray_tpu_torch.init(ignore_reinit_error=True)
        from ray_tpu_torch.api import _global_worker

        self._worker = _global_worker()
        if address is not None and self._worker.gcs_address != address:
            raise RuntimeError(
                f"this process is already connected to cluster "
                f"{self._worker.gcs_address}; cannot submit to {address} "
                f"(one cluster per process)")

    # -- http transport -------------------------------------------------
    def _http_req(self, method: str, path: str, body: Optional[dict] = None,
                  raw: bool = False):
        import urllib.error
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            f"{self._http}{path}", data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            if e.code == 404:
                raise RuntimeError(detail) from None
            raise RuntimeError(
                f"HTTP {e.code} from {path}: {detail}") from None
        if raw:
            return payload.decode(errors="replace")
        return json.loads(payload)

    # -- submission -----------------------------------------------------
    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[Dict[str, str]] = None,
        entrypoint_num_cpus: float = 0,
    ) -> str:
        if self._http is not None:
            out = self._http_req("POST", "/api/jobs", {
                "entrypoint": entrypoint,
                "submission_id": submission_id,
                "runtime_env": runtime_env,
                "metadata": metadata,
                "entrypoint_num_cpus": entrypoint_num_cpus,
            })
            return out["submission_id"]
        import ray_tpu_torch

        submission_id = submission_id or f"raytpu_job_{uuid.uuid4().hex[:10]}"
        existing = self._get_info(submission_id)
        if existing is not None:
            raise ValueError(f"job {submission_id!r} already exists")
        env_vars = {}
        if runtime_env and runtime_env.get("env_vars"):
            env_vars = dict(runtime_env["env_vars"])
            runtime_env = {k: v for k, v in runtime_env.items()
                           if k != "env_vars"}
        supervisor_cls = ray_tpu_torch.remote(JobSupervisor)
        opts = {
            "name": f"_job_supervisor_{submission_id}",
            "namespace": "_job",
            "lifetime": "detached",
            "num_cpus": entrypoint_num_cpus,
        }
        if runtime_env:
            opts["runtime_env"] = runtime_env
        handle = supervisor_cls.options(**opts).remote(
            submission_id, entrypoint, metadata or {},
            self._worker.gcs_address, env_vars)
        # Surface constructor errors synchronously (bad runtime_env etc.).
        ray_tpu_torch.get(handle.ping.remote(), timeout=120)
        return submission_id

    # -- state ----------------------------------------------------------
    def _get_info(self, submission_id: str) -> Optional[JobInfo]:
        if self._http is not None:
            try:
                d = self._http_req("GET", f"/api/jobs/{submission_id}")
            except RuntimeError:
                return None
            return JobInfo(**{k: d.get(k) for k in (
                "submission_id", "entrypoint", "status", "message",
                "metadata", "start_time", "end_time")})
        raw = self._worker.kv_get(JOB_KV_NAMESPACE, submission_id.encode())
        if raw is None:
            return None
        d = json.loads(raw.decode())
        return JobInfo(**d)

    def get_job_info(self, submission_id: str) -> JobInfo:
        info = self._get_info(submission_id)
        if info is None:
            raise RuntimeError(f"job {submission_id!r} does not exist")
        return info

    def get_job_status(self, submission_id: str) -> str:
        return self.get_job_info(submission_id).status

    def get_job_logs(self, submission_id: str) -> str:
        if self._http is not None:
            return self._http_req(
                "GET", f"/api/jobs/{submission_id}/logs", raw=True)
        import ray_tpu_torch

        # Prefer the live supervisor (full log file); fall back to the KV
        # tail it flushed.
        try:
            actor = ray_tpu_torch.get_actor(
                f"_job_supervisor_{submission_id}", namespace="_job")
            return ray_tpu_torch.get(actor.logs.remote(),
                               timeout=30).decode(errors="replace")
        except Exception:  # noqa: BLE001
            raw = self._worker.kv_get(
                JOB_KV_NAMESPACE, f"{submission_id}:logs".encode())
            if raw is None:
                self.get_job_info(submission_id)  # raise if unknown job
                return ""
            return raw.decode(errors="replace")

    def list_jobs(self) -> List[JobInfo]:
        if self._http is not None:
            out = []
            for row in self._http_req("GET", "/api/jobs"):
                if row.get("kind") != "submission":
                    continue
                info = self._get_info(row["id"])
                if info is not None:
                    out.append(info)
            return out
        items = {key: self._worker.kv_get(JOB_KV_NAMESPACE, key)
                 for key in self._worker.kv_keys(JOB_KV_NAMESPACE, b"")}
        return parse_job_records(items)

    # -- control --------------------------------------------------------
    def stop_job(self, submission_id: str) -> bool:
        if self._http is not None:
            out = self._http_req(
                "POST", f"/api/jobs/{submission_id}/stop")
            return bool(out.get("stopped"))
        import ray_tpu_torch

        self.get_job_info(submission_id)
        try:
            actor = ray_tpu_torch.get_actor(
                f"_job_supervisor_{submission_id}", namespace="_job")
            return ray_tpu_torch.get(actor.stop.remote(), timeout=30)
        except Exception:  # noqa: BLE001
            return False

    def delete_job(self, submission_id: str) -> bool:
        if self._http is not None:
            raise NotImplementedError(
                "delete_job needs a cluster connection (use the GCS "
                "address form of JobSubmissionClient)")
        info = self.get_job_info(submission_id)
        if info.status not in JobStatus.TERMINAL:
            raise RuntimeError(
                f"job {submission_id!r} is {info.status}; stop it first")
        self._worker.kv_del(JOB_KV_NAMESPACE, submission_id.encode())
        self._worker.kv_del(JOB_KV_NAMESPACE,
                            f"{submission_id}:logs".encode())
        self._worker.kv_del(JOB_KV_NAMESPACE,
                            f"{submission_id}:stop".encode())
        # Reap the (now idle) detached supervisor.
        import ray_tpu_torch

        try:
            actor = ray_tpu_torch.get_actor(
                f"_job_supervisor_{submission_id}", namespace="_job")
            ray_tpu_torch.kill(actor)
        except Exception:  # noqa: BLE001
            pass
        return True

    def wait_until_finished(self, submission_id: str,
                            timeout: float = 300.0) -> JobInfo:
        deadline = time.monotonic() + timeout
        while True:
            info = self.get_job_info(submission_id)
            if info.status in JobStatus.TERMINAL:
                return info
            if time.monotonic() >= deadline:
                raise TimeoutError(f"job {submission_id!r} still "
                                   f"{info.status} after {timeout}s")
            time.sleep(0.25)
