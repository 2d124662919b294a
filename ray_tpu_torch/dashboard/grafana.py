"""Grafana dashboard generation from the metrics registry. The port's copy
of `ray_tpu/dashboard/grafana.py`: the port's daemons register the JAX
package's `raytpu_*` metric names, so the boards, their titles and
`KNOWN_METRICS` are the same.

ref: dashboard/modules/metrics/grafana_dashboard_factory.py — the
reference ships factory functions that render its default Grafana
dashboards (core/serve/data) as JSON against the Prometheus datasource.
Equivalent here: `generate_dashboard()` renders one panel per
registered metric (or per metric in a chosen set), targeting the
Prometheus endpoint `util/metrics.py` already exposes, and
`write_dashboards()` drops ready-to-import JSON files + a provisioning
config so `grafana-server` with that provisioning dir shows the
cluster out of the box.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

DATASOURCE = "${datasource}"

# Curated default dashboards: metric-name prefixes -> dashboard.
# Prefixes MUST track what node_daemon.py actually registers — an
# unmatched prefix renders an empty board.
DEFAULT_DASHBOARDS = {
    "core": ("ray_tpu core",
             ["raytpu_leases", "raytpu_lease", "raytpu_workers",
              "raytpu_oom"]),
    "store": ("ray_tpu object store", ["raytpu_object_store"]),
    "all": ("ray_tpu all metrics", ["raytpu_"]),
}

# Fallback metadata when no cluster is reachable and the local registry
# is empty: the daemon's stable metric set (node_daemon.py).
KNOWN_METRICS = [
    {"name": "raytpu_leases_granted_total",
     "description": "worker leases granted", "kind": "counter"},
    {"name": "raytpu_workers_spawned_total",
     "description": "workers spawned", "kind": "counter"},
    {"name": "raytpu_workers", "description": "live workers",
     "kind": "gauge"},
    {"name": "raytpu_workers_busy", "description": "busy workers",
     "kind": "gauge"},
    {"name": "raytpu_lease_waiters",
     "description": "queued lease requests", "kind": "gauge"},
    {"name": "raytpu_lease_grant_seconds",
     "description": "lease grant latency", "kind": "histogram"},
    {"name": "raytpu_object_store_used_bytes",
     "description": "store bytes used", "kind": "gauge"},
    {"name": "raytpu_object_store_objects",
     "description": "objects in store", "kind": "gauge"},
    {"name": "raytpu_object_store_spilled_bytes",
     "description": "bytes spilled", "kind": "gauge"},
    {"name": "raytpu_oom_worker_kills_total",
     "description": "workers killed by memory monitor",
     "kind": "counter"},
]


def metrics_from_prometheus_text(text: str) -> List[dict]:
    """Parse `# HELP` / `# TYPE` metadata out of a Prometheus
    exposition dump (what `NodeDaemon.get_metrics` returns) into the
    metadata list the dashboard factory consumes."""
    helps: Dict[str, str] = {}
    kinds: Dict[str, str] = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, desc = rest.partition(" ")
            helps[name] = desc
        elif line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            kinds[name] = kind.strip()
    return [{"name": n, "description": helps.get(n, ""),
             "kind": kinds[n]} for n in sorted(kinds)]


def _panel(metric_name: str, description: str, kind: str,
           panel_id: int, x: int, y: int) -> dict:
    """One timeseries panel; histograms get a p50/p95 quantile query."""
    if kind == "histogram":
        targets = [
            {"expr": f"histogram_quantile(0.5, sum(rate("
                     f"{metric_name}_bucket[1m])) by (le))",
             "legendFormat": "p50", "refId": "A"},
            {"expr": f"histogram_quantile(0.95, sum(rate("
                     f"{metric_name}_bucket[1m])) by (le))",
             "legendFormat": "p95", "refId": "B"},
        ]
    elif kind == "counter":
        targets = [{"expr": f"sum(rate({metric_name}[1m]))",
                    "legendFormat": metric_name, "refId": "A"}]
    else:
        targets = [{"expr": f"sum({metric_name})",
                    "legendFormat": metric_name, "refId": "A"}]
    return {
        "id": panel_id,
        "title": metric_name,
        "description": description,
        "type": "timeseries",
        "datasource": DATASOURCE,
        "gridPos": {"h": 8, "w": 12, "x": x, "y": y},
        "targets": targets,
        "fieldConfig": {"defaults": {"unit": "short"}, "overrides": []},
    }


def generate_dashboard(title: str,
                       metrics: Optional[List[dict]] = None,
                       prefixes: Optional[List[str]] = None,
                       uid: Optional[str] = None) -> dict:
    """Render a Grafana dashboard dict.

    metrics: [{"name", "description", "kind"}]; defaults to every
    metric currently in the process registry. `prefixes` filters by
    metric-name prefix (the DEFAULT_DASHBOARDS groupings).
    """
    if metrics is None:
        from ray_tpu_torch.util.metrics import registry_snapshot

        metrics = registry_snapshot() or KNOWN_METRICS
    if prefixes:
        metrics = [m for m in metrics
                   if any(m["name"].startswith(p) for p in prefixes)]
    panels = []
    for i, m in enumerate(metrics):
        panels.append(_panel(m["name"], m.get("description", ""),
                             m.get("kind", "gauge"), i + 1,
                             x=(i % 2) * 12, y=(i // 2) * 8))
    return {
        "uid": uid or title.replace(" ", "-"),
        "title": title,
        "tags": ["ray-tpu", "generated"],
        "timezone": "browser",
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "templating": {"list": [{
            "name": "datasource", "type": "datasource",
            "query": "prometheus", "label": "Datasource",
        }]},
        "panels": panels,
    }


def write_dashboards(out_dir: str,
                     metrics: Optional[List[dict]] = None) -> List[str]:
    """Write the default dashboard set + a Grafana provisioning config
    (point `grafana-server` at out_dir via dashboards provisioning —
    the same drop-in layout the reference generates)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for slug, (title, prefixes) in DEFAULT_DASHBOARDS.items():
        dash = generate_dashboard(title, metrics=metrics,
                                  prefixes=prefixes,
                                  uid=f"raytpu-{slug}")
        if not dash["panels"]:
            continue        # nothing registered for this group
        path = os.path.join(out_dir, f"raytpu_{slug}.json")
        with open(path, "w") as f:
            json.dump(dash, f, indent=2)
        written.append(path)
    prov = {
        "apiVersion": 1,
        "providers": [{
            "name": "ray-tpu",
            "folder": "ray-tpu",
            "type": "file",
            "options": {"path": os.path.abspath(out_dir)},
        }],
    }
    prov_path = os.path.join(out_dir, "provisioning.yaml")
    with open(prov_path, "w") as f:
        # YAML subset via JSON (valid YAML 1.2); no yaml dep needed.
        json.dump(prov, f, indent=2)
    written.append(prov_path)
    return written
