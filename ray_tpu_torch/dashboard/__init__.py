"""Dashboard: REST head + single-file web UI over the GCS state surface.
The port's copy of `ray_tpu/dashboard/`, its head on the standard library.

Analogue of the reference dashboard head (ref: dashboard/head.py —
aiohttp REST backed by GCS; modules under dashboard/modules/). The React
client is replaced by one self-contained HTML page (zero-egress images
can't fetch JS bundles); the REST surface mirrors the state API the
reference's `ray list ...` and UI consume.
"""
from ray_tpu_torch.dashboard.head import DashboardHead, start_dashboard  # noqa: F401
