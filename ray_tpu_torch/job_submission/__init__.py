"""Job submission: run an entrypoint command on the cluster, detached
from the submitting client. The port's copy of `ray_tpu/job_submission/`.

Analogue of the reference job-submission stack (ref: dashboard/modules/
job/job_manager.py — JobManager :525 spawning a detached JobSupervisor
actor :140 that subprocess-runs the entrypoint; client SDK
dashboard/modules/job/sdk.py:39 JobSubmissionClient). Ours skips the
REST hop: the client talks straight to the cluster (GCS KV for state, a
detached supervisor actor for execution), and the dashboard reads the
same KV records.
"""
from ray_tpu_torch.job_submission.client import (  # noqa: F401
    JobInfo,
    JobStatus,
    JobSubmissionClient,
    parse_job_records,
)
