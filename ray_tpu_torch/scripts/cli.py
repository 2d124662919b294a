"""`ray-tpu` operator CLI for ray_tpu_torch clusters, the port's copy of
`ray_tpu/scripts/cli.py`. It runs as `python -m ray_tpu_torch.scripts.cli`
(the `ray-tpu` console script is the JAX package's). Port differences:
`start --num-gpus` in place of `--num-tpus`; the breadcrumb is the port's
own (`<tmp>/ray_tpu_torch_<uid>/last_cluster.json`, written by the port's
driver), so it never reads a JAX head's address; `up`/`down` keep state
under `~/.ray_tpu_torch/clusters` and launch `fake` providers only; and
`lint` refuses until the invariant lint is ported.

ref: python/ray/scripts/scripts.py (click group :59 — ray start/status/
timeline/...) + the state CLI (python/ray/util/state/state_cli.py —
`ray list tasks|actors|nodes`). Subcommands talk straight to the GCS over
the pickle-codec RPC; the address comes from --address, RAY_TPU_ADDRESS,
or the breadcrumb the last local driver wrote.

Usage:
    python -m ray_tpu_torch.scripts.cli status
    python -m ray_tpu_torch.scripts.cli list nodes|actors|tasks|jobs|pgs|workers
    python -m ray_tpu_torch.scripts.cli timeline --out trace.json
    python -m ray_tpu_torch.scripts.cli metrics [--node <id-prefix>]
    python -m ray_tpu_torch.scripts.cli stack [--node ID] [--worker PID] \
        [--task ID]        # signal-safe all-thread dumps (GIL-proof)
    python -m ray_tpu_torch.scripts.cli top [--per-node]   # cpu/rss per task
    python -m ray_tpu_torch.scripts.cli profile -d 5 [--task N|--actor A]
    python -m ray_tpu_torch.scripts.cli logs [--dead [WORKER]]
    python -m ray_tpu_torch.scripts.cli serve status
    python -m ray_tpu_torch.scripts.cli serve trace <request-id> [-o out.json]
    python -m ray_tpu_torch.scripts.cli train status
    python -m ray_tpu_torch.scripts.cli train trace <run> [-o out.json]
    python -m ray_tpu_torch.scripts.cli gcs top   # control-plane load shares
    python -m ray_tpu_torch.scripts.cli events [--kind node] [--node ID]
    python -m ray_tpu_torch.scripts.cli doctor    # ranked health findings
    python -m ray_tpu_torch.scripts.cli start --head [--num-cpus N ...]
    python -m ray_tpu_torch.scripts.cli start --address <gcs> [--num-cpus N]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

LINT_REFUSAL = ("error: `lint` is not ported to ray_tpu_torch yet: it "
                "comes with ROADMAP A's item 10e-iii (the util trio and "
                "the invariant lint, ray_tpu/devtools/)")


def _resolve_address(args) -> str:
    if args.address:
        return args.address
    from ray_tpu_torch.core.config import get_config

    if get_config().address:
        return get_config().address
    from ray_tpu_torch.core.distributed.driver import breadcrumb_path

    try:
        with open(breadcrumb_path()) as f:
            return json.load(f)["gcs_address"]
    except (OSError, KeyError, ValueError):
        pass
    sys.exit("error: no cluster address (use --address, RAY_TPU_ADDRESS, "
             "or run a driver on this host first)")


class _Gcs:
    def __init__(self, address: str):
        from ray_tpu_torch.core.distributed.rpc import (
            EventLoopThread,
            SyncRpcClient,
        )

        self._loop = EventLoopThread("cli")
        self.client = SyncRpcClient(address, self._loop)
        self.address = address

    def call(self, service, method, timeout=15, **kw):
        return self.client.call(service, method, timeout=timeout, **kw)

    def daemon(self, address: str):
        from ray_tpu_torch.core.distributed.rpc import SyncRpcClient

        return SyncRpcClient(address, self._loop)


def _fmt_table(rows: List[List[str]], headers: List[str]) -> str:
    widths = [len(h) for h in headers]
    for r in rows:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(str(c)))
    line = "  ".join(h.ljust(w) for h, w in zip(headers, widths))
    out = [line, "-" * len(line)]
    for r in rows:
        out.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    return "\n".join(out)


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def cmd_status(gcs: _Gcs, args) -> None:
    nodes = gcs.call("NodeInfo", "list_nodes")
    alive = [n for n in nodes if n["alive"]]
    total: dict = {}
    avail: dict = {}
    for n in alive:
        for k, v in n["total"].items():
            total[k] = total.get(k, 0) + v
        for k, v in n["available"].items():
            avail[k] = avail.get(k, 0) + v
    actors = gcs.call("ActorManager", "list_actors")
    jobs = gcs.call("JobManager", "list_jobs")
    pgs = gcs.call("PlacementGroups", "list_pgs")
    print(f"cluster @ {gcs.address}")
    print(f"  nodes: {len(alive)} alive / {len(nodes)} total")
    for k in sorted(total):
        if k == "memory":
            print(f"  memory: {avail.get(k, 0) / 1e9:.1f}/"
                  f"{total[k] / 1e9:.1f} GB free")
        else:
            print(f"  {k}: {avail.get(k, 0):g}/{total[k]:g} free")
    states = {}
    for a in actors:
        states[a["state"]] = states.get(a["state"], 0) + 1
    print(f"  actors: {len(actors)} "
          f"({', '.join(f'{k}={v}' for k, v in sorted(states.items()))})"
          if actors else "  actors: 0")
    if pgs:
        by_state: dict = {}
        for pg in pgs:
            by_state[pg["state"]] = by_state.get(pg["state"], 0) + 1
        detail = ", ".join(f"{k}={v}" for k, v in sorted(by_state.items()))
        print(f"  placement groups: {len(pgs)} ({detail})")
        # A gang mid-repair: some bundles placed, some holes being
        # re-reserved — worth a line while it lasts.
        for pg in pgs:
            placed = pg.get("placed", 0)
            total_b = pg.get("bundle_count", 0)
            if pg["state"] == "PENDING" and 0 < placed < total_b:
                print(f"    {pg['pg_id'][:12]} repairing: "
                      f"{placed}/{total_b} bundles placed")
    else:
        print("  placement groups: 0")
    running = [j for j in jobs if not j.get("finished")]
    print(f"  jobs: {len(running)} running / {len(jobs)} total")
    # Observability rollup: task-event completeness + federation health.
    try:
        obs = gcs.call("Metrics", "cluster_summary")
    except Exception:  # noqa: BLE001 — pre-federation GCS
        return
    te = obs.get("task_events", {})
    dropped = (te.get("worker_dropped_status", 0)
               + te.get("worker_dropped_profile", 0))
    print(f"  task events: {te.get('stored', 0)} stored "
          f"({te.get('evicted', 0)} evicted, {dropped} dropped, "
          f"{te.get('gc_events', 0)} gc'd)")
    m = obs.get("metrics", {})
    staleness = m.get("staleness_s", {})
    worst = max(staleness.values(), default=0.0)
    print(f"  metrics federation: {m.get('nodes_reporting', 0)} nodes "
          f"reporting (worst staleness {worst:.1f}s)")
    # GCS load attribution: who is spending the control plane's time.
    gload = (obs.get("gcs") or {}).get("load") or {}
    shares = gload.get("component_handler_share") or {}
    if shares:
        top3 = ", ".join(f"{c} {s:.0%}" for c, s in list(shares.items())[:3])
        slow = (gload.get("slow_handlers") or {}).get("total", 0)
        slow_note = f", {slow} slow handler(s)" if slow else ""
        print(f"  gcs load: {top3} of handler time{slow_note} "
              f"(`ray-tpu gcs top`)")
    hung = obs.get("hung_tasks") or []
    if hung:
        names = ", ".join(
            f"{h.get('name') or 'task'}@{(h.get('node_id') or '?')[:8]}"
            for h in hung[:5])
        more = f" (+{len(hung) - 5} more)" if len(hung) > 5 else ""
        print(f"  HUNG tasks: {len(hung)} — {names}{more}  "
              f"(`ray-tpu stack --task <id>` for stacks)")
    # Active train runs: world size, step rate, goodput — the one-line
    # version of `ray-tpu train status`.
    for run, s in ((obs.get("train") or {}).get("runs") or {}).items():
        if not s.get("active"):
            continue
        line = (f"  train run '{run}': world={s.get('world', 0)} "
                f"steps={s.get('steps', 0)} "
                f"rate={s.get('step_rate', 0.0):.2f}/s")
        if s.get("goodput") is not None:
            line += f" goodput={s['goodput']:.0%}"
        skew = s.get("skew") or {}
        if skew.get("stale_ranks"):
            line += f" STALE ranks {skew['stale_ranks']}"
        print(line + "  (`ray-tpu train status`)")
    # Elastic training plane: recent gang restarts / shrinks / grows.
    try:
        ev = gcs.call("EventLog", "list_events", source="elastic", limit=5)
    except Exception:  # noqa: BLE001 — pre-elastic GCS
        return
    if ev:
        print(f"  elastic events (latest {len(ev)}):")
        for e in ev:
            print(f"    [{e.get('severity', '?')}] {e.get('message', '')}")


def cmd_gcs(gcs: _Gcs, args) -> None:
    """GCS control-plane self-observability (`ray-tpu gcs top`): the
    per-service x per-caller-component load shares the attribution
    sink accumulates, the event-loop audit, and the slow-handler ring
    — the measure-then-shard evidence for the GCS sharding arc."""
    blob = gcs.call("Metrics", "gcs_load")
    load = blob.get("load", {})
    total = load.get("total", {})
    print(f"GCS @ {gcs.address} (id {blob.get('node_id', '?')[:12]}) — "
          f"window {load.get('window_s', 0):.0f}s")
    print(f"  {total.get('requests', 0)} requests / "
          f"{total.get('bytes', 0) / 1e6:.2f} MB in / "
          f"{total.get('handler_s', 0):.3f}s handler time")
    rows = [[r["service"], r["component"], r["requests"],
             f"{r['requests_share']:.1%}", r["bytes"],
             f"{r['handler_s']:.4f}", f"{r['handler_share']:.1%}"]
            for r in load.get("rows", [])[:args.limit]]
    if rows:
        print(_fmt_table(rows, ["SERVICE", "COMPONENT", "REQS", "REQ%",
                                "BYTES", "HANDLER_S", "TIME%"]))
    shares = load.get("component_handler_share") or {}
    if shares:
        print("  by component: "
              + ", ".join(f"{c} {s:.1%}" for c, s in shares.items()))
    loop = blob.get("loop", {})
    print(f"  loop audit: lag last/max "
          f"{loop.get('lag_last_s', 0) * 1000:.1f}/"
          f"{loop.get('lag_max_s', 0) * 1000:.1f} ms, "
          f"backlog {loop.get('backlog', 0)}, "
          f"{loop.get('samples', 0)} samples")
    slow = load.get("slow_handlers", {})
    if slow.get("total"):
        print(f"  slow handlers: {slow['total']} over "
              f"{slow.get('budget_ms', 0):.0f}ms budget")
        for e in slow.get("recent", [])[-3:]:
            who = e.get("caller")
            who_s = f"{who[1]}@{who[0][:8]}" if who else "unknown"
            print(f"    {e['service']}.{e['method']} "
                  f"{e['wall_ms']:.0f}ms caller={who_s} [{e['args']}]")
    flight = blob.get("flight", {})
    print(f"  flight recorder: {flight.get('events', 0)} entries "
          f"({'durable' if flight.get('durable') else 'memory-only'}, "
          f"seq {flight.get('seq', 0)})")


def cmd_events(gcs: _Gcs, args) -> None:
    """Cluster flight recorder (`ray-tpu events`): durable state-
    transition journal, filterable by kind prefix / node / age."""
    import datetime

    since = time.time() - args.since_s if args.since_s else None
    ev = gcs.call("FlightRecorder", "list_events", kind=args.kind,
                  node_id=args.node, since=since, limit=args.limit)
    if not ev:
        print("no matching flight-recorder entries")
        return
    rows = []
    for e in ev:
        ts = datetime.datetime.fromtimestamp(e["ts"]).strftime("%H:%M:%S")
        rows.append([ts, e["kind"], e.get("severity", "INFO"),
                     (e.get("node_id") or "-")[:12], e["message"]])
    print(_fmt_table(rows, ["TIME", "KIND", "SEV", "NODE", "MESSAGE"]))


def cmd_doctor(gcs: _Gcs, args) -> None:
    """Fused health report (`ray-tpu doctor`): ranked findings over
    federated metrics, hung tasks, task-event loss, GCS load shares,
    loop lag, and recent flight-recorder entries."""
    rep = gcs.call("Metrics", "doctor", timeout=60)
    findings = rep.get("findings", [])
    if not findings:
        print(f"cluster @ {gcs.address} healthy — "
              f"{len(rep.get('checks', []))} checks passed")
        return
    print(f"cluster @ {gcs.address} — {len(findings)} finding(s):")
    for i, f in enumerate(findings, 1):
        print(f"{i:3d}. [{f['severity'].upper()} {f['score']:.0f}] "
              f"{f['kind']}: {f['message']}")
        print(f"      hint: {f['hint']}")


def cmd_list(gcs: _Gcs, args) -> None:
    kind = args.kind
    if kind == "nodes":
        rows = [[n["node_id"][:12], "ALIVE" if n["alive"] else "DEAD",
                 n["address"],
                 " ".join(f"{k}={v:g}" for k, v in sorted(
                     n["total"].items()) if k != "memory")]
                for n in gcs.call("NodeInfo", "list_nodes")]
        print(_fmt_table(rows, ["NODE_ID", "STATE", "ADDRESS", "RESOURCES"]))
    elif kind == "actors":
        rows = [[a["actor_id"][:12], a.get("cls_name", ""), a["state"],
                 a.get("name") or "", (a.get("node_id") or "")[:12]]
                for a in gcs.call("ActorManager", "list_actors")]
        print(_fmt_table(rows, ["ACTOR_ID", "CLASS", "STATE", "NAME",
                                "NODE"]))
    elif kind == "tasks":
        events = gcs.call("TaskEvents", "list_events", limit=args.limit)
        rows = [[e["task_id"][:12], e.get("name", ""), e.get("state", ""),
                 f"{(e.get('end_ts', 0) - e.get('start_ts', 0)) * 1000:.1f}",
                 (e.get("node_id") or "")[:12], e.get("error") or ""]
                for e in events]
        print(_fmt_table(rows, ["TASK_ID", "NAME", "STATE", "MS", "NODE",
                                "ERROR"]))
    elif kind == "jobs":
        rows = [[j["job_id"], "FINISHED" if j.get("finished") else "RUNNING",
                 time.strftime("%H:%M:%S",
                               time.localtime(j.get("start_time", 0)))]
                for j in gcs.call("JobManager", "list_jobs")]
        print(_fmt_table(rows, ["JOB_ID", "STATE", "STARTED"]))
    elif kind == "pgs":
        rows = [[p["pg_id"][:12], p["state"], p["strategy"],
                 str(len(p.get("bundles", [])))]
                for p in gcs.call("PlacementGroups", "list_pgs")]
        print(_fmt_table(rows, ["PG_ID", "STATE", "STRATEGY", "BUNDLES"]))
    elif kind == "events":
        import datetime

        rows = [[datetime.datetime.fromtimestamp(e["ts"]).strftime(
                     "%H:%M:%S"),
                 e["source"], e["severity"], e["message"]]
                for e in gcs.call("EventLog", "list_events",
                                  limit=args.limit)]
        print(_fmt_table(rows, ["TIME", "SOURCE", "SEVERITY", "MESSAGE"]))
    elif kind == "workers":
        rows = []
        for n in gcs.call("NodeInfo", "list_nodes"):
            if not n["alive"]:
                continue
            try:
                for w in gcs.daemon(n["address"]).call(
                        "NodeDaemon", "list_workers", timeout=10):
                    rows.append([n["node_id"][:12], w["worker_id"][:12],
                                 w["pid"],
                                 "actor" if w["actor_id"] else "task",
                                 "busy" if w["busy"] else "idle"])
            except Exception as e:  # noqa: BLE001
                rows.append([n["node_id"][:12], f"<unreachable: {e}>",
                             "", "", ""])
        print(_fmt_table(rows, ["NODE", "WORKER_ID", "PID", "KIND",
                                "STATE"]))


def cmd_timeline(gcs: _Gcs, args) -> None:
    from ray_tpu_torch.util.timeline import chrome_trace

    events = gcs.call("TaskEvents", "list_events", limit=args.limit)
    with open(args.out, "w") as f:
        json.dump(chrome_trace(events), f)
    print(f"wrote {len(events)} events to {args.out} "
          f"(open in chrome://tracing)")


def cmd_grafana_out(args) -> None:
    """Generate importable Grafana dashboards + provisioning config
    (ref: grafana_dashboard_factory.py). Metric metadata comes from a
    live node's Prometheus dump when a cluster is reachable, else from
    the known daemon metric set — so this works air-gapped."""
    from ray_tpu_torch.dashboard.grafana import (
        metrics_from_prometheus_text,
        write_dashboards,
    )

    metrics = None
    try:
        gcs = _Gcs(_resolve_address(args))
        for n in gcs.call("NodeInfo", "list_nodes"):
            if not n["alive"]:
                continue
            text = gcs.daemon(n["address"]).call(
                "NodeDaemon", "get_metrics", timeout=10)
            metrics = metrics_from_prometheus_text(text)
            break
    except Exception:  # noqa: BLE001 — no cluster: static fallback
        pass
    for path in write_dashboards(args.grafana_out, metrics=metrics):
        print(path)


def cmd_metrics(gcs: _Gcs, args) -> None:
    if getattr(args, "federated", False):
        # One exposition for the whole cluster, node-labelled, straight
        # from the GCS's syncer-fed federation cache — no per-daemon
        # scrape fan-out.
        print(gcs.call("Metrics", "federated_text"))
        return
    for n in gcs.call("NodeInfo", "list_nodes"):
        if not n["alive"]:
            continue
        if args.node and not n["node_id"].startswith(args.node):
            continue
        print(f"# node {n['node_id'][:12]} @ {n['address']}")
        try:
            print(gcs.daemon(n["address"]).call("NodeDaemon", "get_metrics",
                                                timeout=10))
        except Exception as e:  # noqa: BLE001
            print(f"# unreachable: {e}")


def cmd_serve(gcs: _Gcs, args) -> None:
    """Serving-plane observability (`ray-tpu serve status|trace`):
    status renders the GCS rollup (per-app autoscaling gauges + the
    TTFT/ITL/phase means and counter totals mined from the federated
    serve metrics); trace dumps ONE request's end-to-end span track
    (proxy -> handle -> replica -> engine, resumed hops on their own
    rows) as a perfetto/chrome trace."""
    if args.serve_cmd == "trace":
        from ray_tpu_torch.util.timeline import request_chrome_trace

        spans = gcs.call("TaskEvents", "list_spans",
                         trace_id=args.request_id, limit=10000,
                         timeout=30)
        if not spans:
            sys.exit(f"no spans for request {args.request_id!r} "
                     f"(RAY_TPU_SERVE_TRACE_ENABLED=0, or the span "
                     f"buffer has not flushed yet?)")
        out = args.out or f"trace-{args.request_id[:12]}.json"
        with open(out, "w") as f:
            json.dump(request_chrome_trace(spans), f)
        print(f"wrote {len(spans)} spans to {out} "
              f"(open in https://ui.perfetto.dev)")
        return
    try:
        summary = gcs.call("Metrics", "cluster_summary").get("serve", {})
    except Exception as e:  # noqa: BLE001 — pre-observability GCS
        sys.exit(f"no serve summary from GCS: {e}")
    apps = summary.get("apps") or {}
    latency = summary.get("latency") or {}
    counters = summary.get("counters") or {}
    names = sorted(set(apps) | set(latency) | set(counters))
    if not names:
        print("no serve apps reporting")
        return
    print(f"serve @ {gcs.address}")
    for app in names:
        print(f"  app {app}:")
        gauges = apps.get(app) or {}
        # Per-replica disagg state rides the gauge payload under the
        # non-numeric `_replicas` key: render it as its own section.
        replicas = gauges.get("_replicas") or {}
        numeric = {k: v for k, v in gauges.items()
                   if isinstance(v, (int, float))}
        if numeric:
            print("    gauges: " + "  ".join(
                f"{k}={v:g}" for k, v in sorted(numeric.items())))
        for rid in sorted(replicas):
            ent = replicas[rid] or {}
            parts = [f"role={ent.get('role', 'unified')}"]
            if "prefixes" in ent:
                parts.append(f"prefixes={len(ent['prefixes'] or ())}")
            rails = ent.get("rails")
            if rails:
                parts.append(
                    f"rails={rails.get('mode', 'off')}"
                    f"({rails.get('active', 0)}/{rails.get('width', 0)} "
                    f"active, {rails.get('spilled_total', 0)} spilled)")
            if ent.get("spec_accept_rate") is not None:
                parts.append(
                    f"spec_accept={100 * ent['spec_accept_rate']:.0f}%")
            print(f"    replica {rid}: " + "  ".join(parts))
        lat = latency.get(app) or {}
        line = []
        if "ttft_mean_s" in lat:
            line.append(f"ttft_mean={lat['ttft_mean_s'] * 1e3:.1f}ms")
        if "itl_mean_s" in lat:
            line.append(f"itl_mean={lat['itl_mean_s'] * 1e3:.1f}ms")
        if line:
            print("    latency: " + "  ".join(line))
        phases = lat.get("phase_mean_s") or {}
        if phases:
            print("    phases: " + "  ".join(
                f"{p}={v * 1e3:.1f}ms" for p, v in sorted(phases.items())))
        cts = counters.get(app) or {}
        if cts:
            print("    counters: " + "  ".join(
                f"{k}={v:g}" for k, v in sorted(cts.items())))


def cmd_train(gcs: _Gcs, args) -> None:
    """Train-plane goodput observability (`ray-tpu train ...`):
    status renders the GCS TrainRunState rollup (per-run goodput
    split, step rate, cross-rank skew + blame rank, restart
    accounting, MFU when hinted); trace dumps ONE run's per-rank
    step/phase span tracks as a perfetto/chrome trace."""
    if args.train_cmd == "trace":
        from ray_tpu_torch.util.timeline import train_chrome_trace

        spans = gcs.call("TaskEvents", "list_spans",
                         trace_id=args.run_id, limit=10000, timeout=30)
        if not spans and "#" not in args.run_id:
            spans = [s for s in gcs.call("TaskEvents", "list_spans",
                                         limit=10000, timeout=30)
                     if (s.get("trace_id") or "").startswith(
                         f"{args.run_id}#")]
        if not spans:
            sys.exit(f"no spans for train run {args.run_id!r} "
                     f"(RAY_TPU_TRAIN_OBS_ENABLED=0, or the span "
                     f"buffer has not flushed yet?)")
        out = args.out or f"train-trace-{args.run_id.replace('#', '_')}.json"
        with open(out, "w") as f:
            json.dump(train_chrome_trace(spans), f)
        print(f"wrote {len(spans)} spans to {out} "
              f"(open in https://ui.perfetto.dev)")
        return
    try:
        runs = gcs.call("Train", "summary", timeout=30).get("runs", {})
    except Exception as e:  # noqa: BLE001 — pre-observability GCS
        sys.exit(f"no train summary from GCS: {e}")
    if not runs:
        print("no train runs reporting")
        return
    print(f"train @ {gcs.address}")
    for run in sorted(runs):
        s = runs[run]
        state = "active" if s.get("active") else \
            f"idle {s.get('last_seen_age_s', 0):.0f}s"
        print(f"  run '{run}' ({s.get('run_id')}, attempt "
              f"{s.get('attempt', 0)}, {state}):")
        line = (f"    world={s.get('world', 0)}  steps={s.get('steps', 0)}"
                f"  rate={s.get('step_rate', 0.0):.2f}/s")
        if s.get("restarts"):
            line += (f"  restarts={s['restarts']} "
                     f"(lost {s.get('lost_restart_s', 0):.1f}s)")
        print(line)
        split = s.get("split") or {}
        if split:
            print(f"    goodput: {s.get('goodput', 0):.1%}  ("
                  + "  ".join(f"{k}={v:.1%}" for k, v in split.items())
                  + ")")
        skew = s.get("skew") or {}
        if skew:
            line = (f"    skew: p50={skew.get('p50_step_s', 0) * 1e3:.1f}ms"
                    f"  p99={skew.get('p99_step_s', 0) * 1e3:.1f}ms"
                    f"  p99/p50={skew.get('ratio', 0):.2f}")
            if skew.get("blame_rank") is not None:
                line += f"  blame=rank {skew['blame_rank']}"
            if skew.get("stale_ranks"):
                line += f"  STALE={skew['stale_ranks']}"
            print(line)
        if s.get("achieved_flops"):
            line = f"    flops: {s['achieved_flops']:.3g}/s achieved"
            if s.get("mfu") is not None:
                line += f"  mfu={s['mfu']:.1%}"
            print(line)


def cmd_job(args) -> None:
    """Job submission commands (ref: `ray job submit/status/logs/stop/list`,
    dashboard/modules/job/cli.py). Uses the direct-to-cluster client."""
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient(_resolve_address(args))
    if args.job_cmd == "submit":
        import shlex

        words = args.entrypoint
        if words and words[0] == "--":
            words = words[1:]
        # shlex.join keeps argument boundaries (a bare " ".join would let
        # the shell re-split/interpret `-c "print(1)"`).
        sid = client.submit_job(entrypoint=shlex.join(words),
                                submission_id=args.submission_id)
        print(f"submitted job {sid}")
        if args.wait:
            info = client.wait_until_finished(sid, timeout=args.timeout)
            print(client.get_job_logs(sid), end="")
            print(f"job {sid}: {info.status} {info.message}")
            if info.status != "SUCCEEDED":
                sys.exit(1)
    elif args.job_cmd == "status":
        info = client.get_job_info(args.submission_id)
        print(f"{info.submission_id}: {info.status} {info.message}")
    elif args.job_cmd == "logs":
        print(client.get_job_logs(args.submission_id), end="")
    elif args.job_cmd == "stop":
        ok = client.stop_job(args.submission_id)
        print("stopped" if ok else "not running")
    elif args.job_cmd == "list":
        rows = [[j.submission_id, j.status,
                 time.strftime("%H:%M:%S",
                               time.localtime(j.start_time or 0)),
                 j.entrypoint[:60]]
                for j in client.list_jobs()]
        print(_fmt_table(rows, ["SUBMISSION_ID", "STATUS", "STARTED",
                                "ENTRYPOINT"]))


def cmd_stack(gcs: _Gcs, args) -> None:
    """Signal-safe all-thread stack dumps from every (matching) live
    worker (ref: `ray stack`): the GCS Diagnosis service fans SIGUSR1/
    faulthandler captures out over all daemons — this works even when a
    worker is wedged in a GIL-holding native call, the case in-process
    sampling (`ray-tpu profile`) can never see. `--task` matches
    RUNNING attempts by task-id/name substring and dumps only their
    workers; identical stacks are grouped across workers at the end."""
    from ray_tpu_torch.util.profiling import summarize_stacks

    worker_id = None
    pids = None
    if args.worker:
        if args.worker.isdigit():
            pids = [int(args.worker)]
        else:
            worker_id = args.worker
    if args.task:
        rows = gcs.call("TaskEvents", "list_events", limit=10000)
        pids = sorted({
            r["pid"] for r in rows
            if r.get("pid") and r.get("state") == "RUNNING"
            and r.get("kind") not in ("span", "profile")
            and (args.task in (r.get("task_id") or "")
                 or args.task in (r.get("name") or ""))})
        if not pids:
            print(f"no RUNNING task matches {args.task!r} "
                  f"(try `ray-tpu list tasks`)")
            return
    results = gcs.call("Diagnosis", "dump_stacks", node_id=args.node,
                       worker_id=worker_id, pids=pids, timeout=90)
    n_ok = 0
    for nres in results:
        if nres.get("error"):
            print(f"== node {nres['node_id'][:12]}: <{nres['error']}>")
            continue
        for w in nres.get("workers", []):
            head = (f"== worker {w['worker_id'][:12]} pid={w['pid']} "
                    f"node={nres['node_id'][:12]}")
            if w.get("actor_id"):
                head += f" actor={w['actor_id'][:12]}"
            print(head)
            if not w.get("ok"):
                print(f"  <dump failed: {w.get('error')}>")
                continue
            n_ok += 1
            if args.raw:
                print(w.get("raw", ""))
                continue
            for t in w.get("threads", []):
                kind = "current thread" if t.get("current") else "thread"
                print(f"  {kind} {t['thread']} (most recent first):")
                for fr in t["frames"]:
                    print(f"    {fr}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"raw dumps -> {args.out}")
    groups = summarize_stacks(results)
    if groups and n_ok > 1:
        print("-- identical stacks across workers --")
        for g in groups[:10]:
            print(f"  {g['workers']}/{g['total']} workers at {g['leaf']}")


def cmd_top(gcs: _Gcs, args) -> None:
    """Per-task-name resource usage view (`ray-tpu top`): attempts,
    running/hung counts, summed + max thread CPU-time, RSS deltas and
    peaks — from the per-attempt attribution the executor ships on
    every task-event record; p50/p99 rollups come from the GCS-side
    task summary."""
    rows = gcs.call("TaskEvents", "list_events", limit=args.limit)
    agg: dict = {}
    for r in rows:
        if r.get("kind") in ("span", "profile"):
            continue
        if args.node and not (r.get("node_id") or "").startswith(
                args.node):
            continue
        key = (r.get("name") or "task",
               (r.get("node_id") or "")[:12] if args.per_node else "*")
        a = agg.setdefault(key, {"n": 0, "running": 0, "hung": 0,
                                 "cpu": 0.0, "cpu_max": 0.0,
                                 "rss": 0, "rss_peak": 0})
        a["n"] += 1
        if r.get("state") == "RUNNING":
            a["running"] += 1
        if r.get("hung"):
            a["hung"] += 1
        c = r.get("cpu_time_s") or 0.0
        a["cpu"] += c
        a["cpu_max"] = max(a["cpu_max"], c)
        a["rss"] += r.get("rss_delta_bytes") or 0
        a["rss_peak"] = max(a["rss_peak"], r.get("rss_peak_bytes") or 0)
    if not agg:
        print("no task attempts with attribution in the stored window")
        return
    table = []
    for (name, node), a in sorted(agg.items(),
                                  key=lambda kv: -kv[1]["cpu"]):
        table.append([
            name, node, a["n"], a["running"], a["hung"],
            f"{a['cpu']:.3f}", f"{a['cpu_max']:.3f}",
            f"{a['rss'] / 1e6:.1f}", f"{a['rss_peak'] / 1e6:.1f}"])
    print(_fmt_table(table, ["NAME", "NODE", "ATTEMPTS", "RUN", "HUNG",
                             "CPU_S", "CPU_MAX_S", "RSS_D_MB",
                             "RSS_PEAK_MB"]))
    try:
        summ = gcs.call("TaskEvents", "summarize")
    except Exception:  # noqa: BLE001 — pre-diagnosis GCS
        return
    usage = summ.get("usage") or {}
    if usage:
        print("-- per-name rollups (GCS window) --")
        rows2 = [[name, u["n"], f"{u['cpu_time_s']['p50']:.4f}",
                  f"{u['cpu_time_s']['p99']:.4f}",
                  f"{u['rss_delta_bytes']['p50'] / 1e6:.1f}",
                  f"{u['rss_delta_bytes']['p99'] / 1e6:.1f}"]
                 for name, u in sorted(usage.items())]
        print(_fmt_table(rows2, ["NAME", "N", "CPU_P50_S", "CPU_P99_S",
                                 "RSS_P50_MB", "RSS_P99_MB"]))


def cmd_profile(gcs: _Gcs, args) -> None:
    """Cluster flamegraph (`ray-tpu profile`): fan the sampling
    `profile` RPC out to the matching workers CONCURRENTLY (the capture
    windows overlap, so one wall-clock duration samples the whole
    target set), merge the collapsed stacks into one flamegraph file,
    and annotate the perfetto timeline with the capture window."""
    import asyncio

    from ray_tpu_torch.core.distributed.rpc import AsyncRpcClient
    from ray_tpu_torch.util.profiling import (
        merge_reports, render_report, write_flamegraph_collapsed)

    targets = []
    running_pids = None
    if args.task:
        rows = gcs.call("TaskEvents", "list_events", limit=10000)
        running_pids = {
            (r.get("node_id"), r.get("pid")) for r in rows
            if r.get("pid") and r.get("state") == "RUNNING"
            and r.get("kind") not in ("span", "profile")
            and (args.task in (r.get("task_id") or "")
                 or args.task in (r.get("name") or ""))}
    actor_addrs = None
    if args.actor:
        actor_addrs = {
            a.get("worker_address")
            for a in gcs.call("ActorManager", "list_actors")
            if a and a["actor_id"].startswith(args.actor)
            and a.get("worker_address")}
    for n in gcs.call("NodeInfo", "list_nodes"):
        if not n["alive"]:
            continue
        if args.node and not n["node_id"].startswith(args.node):
            continue
        try:
            workers = gcs.daemon(n["address"]).call(
                "NodeDaemon", "list_workers", timeout=10)
        except Exception:  # noqa: BLE001
            continue
        for w in workers:
            if not w.get("address") or not w.get("alive", True):
                continue
            if args.worker and not (
                    w["worker_id"].startswith(args.worker)
                    or str(w["pid"]) == args.worker):
                continue
            if (running_pids is not None
                    and (n["node_id"], w["pid"]) not in running_pids):
                continue
            if (actor_addrs is not None
                    and w["address"] not in actor_addrs):
                continue
            targets.append({"node_id": n["node_id"], **w})
    if not targets:
        print("no matching live workers to profile")
        return
    print(f"sampling {len(targets)} workers for {args.duration:.1f}s...")

    async def sample():
        clients = [AsyncRpcClient(t["address"]) for t in targets]
        try:
            return await asyncio.gather(
                *(c.call("Worker", "profile", duration_s=args.duration,
                         interval_s=args.interval,
                         timeout=args.duration + 30) for c in clients),
                return_exceptions=True)
        finally:
            for c in clients:
                await c.close()

    t_start = time.time()
    reps = gcs._loop.run(sample(), timeout=args.duration + 60)
    t_end = time.time()
    ok = [(t, r) for t, r in zip(targets, reps) if isinstance(r, dict)]
    for t, r in zip(targets, reps):
        if not isinstance(r, dict):
            print(f"  worker {t['worker_id'][:12]}: <{r!r}>")
    merged = merge_reports([r for _, r in ok])
    print(render_report(merged))
    write_flamegraph_collapsed(merged, args.out)
    print(f"cluster flamegraph (collapsed stacks) -> {args.out}")
    try:
        # Counter-track annotations: the capture windows land on the
        # perfetto timeline next to the tasks they sampled.
        gcs.call("TaskEvents", "add_task_events", profile=[
            {"kind": "profile", "category": "cpu_profile",
             "name": f"cpu_profile:{t['worker_id'][:8]}",
             "start_ts": t_start, "end_ts": t_end,
             "node_id": t["node_id"], "pid": t["pid"],
             "samples": r.get("samples", 0)} for t, r in ok])
    except Exception:  # noqa: BLE001 annotation is best-effort
        pass


def cmd_logs(gcs: _Gcs, args) -> None:
    """Worker log access (ref: `ray logs` CLI, log_monitor tailing):
    dumps the GCS ring buffers (works for DEAD workers too), or streams
    the live pubsub channel with --follow."""
    if args.follow:
        import asyncio

        from ray_tpu_torch.core.distributed.log_monitor import format_log_prefix
        from ray_tpu_torch.core.distributed.rpc import AsyncRpcClient

        async def follow():
            client = AsyncRpcClient(gcs.address)
            try:
                async for rec in client.stream(
                        "Pubsub", "stream_subscribe", channel="logs"):
                    if args.node and not rec["node_id"].startswith(
                            args.node):
                        continue
                    if args.worker and not rec["worker_id"].startswith(
                            args.worker):
                        continue
                    if args.actor and not (rec.get("actor_id")
                                           or "").startswith(args.actor):
                        continue
                    if args.job and rec.get("job_id") != args.job:
                        continue
                    prefix = format_log_prefix(rec)
                    for line in rec["lines"]:
                        print(f"{prefix} {line}", flush=True)
            finally:
                await client.close()

        try:
            asyncio.run(follow())
        except KeyboardInterrupt:
            pass
        return
    worker = args.worker
    if args.dead is not None and args.dead:
        worker = args.dead
    records = gcs.call("LogManager", "tail_logs", node_id=args.node,
                       worker_id=worker, actor_id=args.actor,
                       job_id=args.job, num_lines=args.lines)
    if args.dead is not None:
        # Post-mortem view: only workers NO LONGER alive anywhere (the
        # GCS ring buffers retain their last lines precisely for this).
        alive = set()
        for n in gcs.call("NodeInfo", "list_nodes"):
            if not n["alive"]:
                continue
            try:
                for w in gcs.daemon(n["address"]).call(
                        "NodeDaemon", "list_workers", timeout=10):
                    if w.get("alive", True):
                        alive.add(w["worker_id"])
            except Exception:  # noqa: BLE001 node mid-restart
                continue
        records = [r for r in records if r["worker_id"] not in alive]
        if not records:
            print("no retained logs for dead workers match")
            return
    for rec in sorted(records, key=lambda r: (r["node_id"],
                                              r["worker_id"])):
        who = (f"actor={rec['actor_id'][:12]}" if rec.get("actor_id")
               else f"worker={rec['worker_id'][:12]}")
        print(f"== {who} node={rec['node_id'][:12]} [{rec['stream']}]")
        for line in rec["lines"]:
            print(f"  {line}")


def cmd_dashboard(args) -> None:
    """Serve the web dashboard for a running cluster (ref: `ray
    dashboard`, dashboard/head.py)."""
    import asyncio

    from ray_tpu_torch.dashboard.head import DashboardHead

    address = _resolve_address(args)

    async def run():
        head = DashboardHead(address, args.host, args.port)
        port = await head.start()
        print(f"dashboard at http://{args.host}:{port} (Ctrl-C to stop)")
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


def cmd_start(args) -> None:
    """Start a head (GCS + daemon) or join a worker daemon to a cluster
    (ref: `ray start --head` / `ray start --address=...`)."""
    from ray_tpu_torch.core.distributed.driver import (
        start_gcs_process,
        start_node_daemon_process,
        write_breadcrumb,
    )

    if args.head:
        gcs_proc, gcs_address = start_gcs_process(die_with_parent=False)
        print(f"GCS started at {gcs_address}")
        write_breadcrumb(gcs_address)
    else:
        if not args.address:
            sys.exit("error: worker start needs --address <gcs>")
        gcs_address = args.address
    proc, info = start_node_daemon_process(
        gcs_address, num_cpus=args.num_cpus, num_gpus=args.num_gpus,
        die_with_parent=False)
    print(f"node daemon {info['node_id'][:12]} at {info['address']} "
          f"(store {info['store_dir']})")
    print(f"join more nodes with: ray-tpu start --address {gcs_address}")
    print("processes run until killed (Ctrl-C detaches, does not stop them)")


def cmd_up(args) -> None:
    """Launch a cluster from a YAML config (ref: `ray up`,
    autoscaler/_private/commands.py create_or_update_cluster)."""
    if args.no_block:
        # The autoscaler must outlive this CLI process: run the blocking
        # launcher detached (its own session; `ray-tpu down` reaps it).
        from ray_tpu_torch.autoscaler.launcher import spawn_detached_launcher

        address = spawn_detached_launcher(args.config)
        print(f"cluster up (detached launcher); connect with "
              f"ray_tpu_torch.init(address={address!r})")
        return
    from ray_tpu_torch.autoscaler.launcher import cluster_up

    cluster_up(args.config, block=True)


def cmd_down(args) -> None:
    """Tear down a launched cluster (ref: `ray down`)."""
    from ray_tpu_torch.autoscaler.launcher import cluster_down

    cluster_down(args.config)


def cmd_lint(args) -> None:
    """The invariant lint suite is not ported yet: refuse, naming the
    item that brings it."""
    sys.exit(LINT_REFUSAL)


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="ray-tpu")
    p.add_argument("--address", help="GCS address host:port")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status")
    lp = sub.add_parser("list")
    lp.add_argument("kind", choices=["nodes", "actors", "tasks", "jobs",
                                     "pgs", "workers", "events"])
    lp.add_argument("--limit", type=int, default=200)
    tp = sub.add_parser("timeline")
    tp.add_argument("--out", default="timeline.json")
    tp.add_argument("--limit", type=int, default=10000)
    mp = sub.add_parser("metrics")
    mp.add_argument("--grafana-out", default=None,
                    help="write generated Grafana dashboards + "
                         "provisioning config to this dir and exit")
    mp.add_argument("--node", help="node id prefix filter")
    mp.add_argument("--federated", action="store_true",
                    help="print the GCS's merged, node-labelled "
                         "cluster exposition instead of per-daemon "
                         "scrapes")
    sp = sub.add_parser("start")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None)
    jp = sub.add_parser("job")
    jsub = jp.add_subparsers(dest="job_cmd", required=True)
    jps = jsub.add_parser("submit")
    jps.add_argument("entrypoint", nargs=argparse.REMAINDER)
    jps.add_argument("--submission-id", default=None)
    jps.add_argument("--wait", action="store_true")
    jps.add_argument("--timeout", type=float, default=600.0)
    for name in ("status", "logs", "stop"):
        jpx = jsub.add_parser(name)
        jpx.add_argument("submission_id")
    jsub.add_parser("list")
    svp = sub.add_parser(
        "serve", help="serving-plane observability: per-app latency/"
                      "KV rollup (status) and per-request span traces "
                      "(trace <request-id>)")
    ssub = svp.add_subparsers(dest="serve_cmd", required=True)
    ssub.add_parser("status")
    stp = ssub.add_parser("trace")
    stp.add_argument("request_id", help="request id (== trace id; the "
                                        "X-Request-Id header value)")
    stp.add_argument("-o", "--out", default=None,
                     help="output path (default trace-<id>.json)")
    tvp = sub.add_parser(
        "train", help="train-plane goodput observability: per-run "
                      "goodput split / step rate / cross-rank skew "
                      "(status) and per-rank step-phase span traces "
                      "(trace <run>)")
    tsub = tvp.add_subparsers(dest="train_cmd", required=True)
    tsub.add_parser("status")
    ttp = tsub.add_parser("trace")
    ttp.add_argument("run_id", help="run id (experiment name + fit "
                                    "attempt, e.g. 'mnist#0'; a bare "
                                    "experiment name matches every "
                                    "attempt)")
    ttp.add_argument("-o", "--out", default=None,
                     help="output path (default train-trace-<run>.json)")
    gcp = sub.add_parser(
        "gcs", help="GCS control-plane self-observability: per-service "
                    "x per-caller-component load shares, the event-loop "
                    "audit, and the slow-handler ring (gcs top)")
    gsub = gcp.add_subparsers(dest="gcs_cmd", required=True)
    gtp = gsub.add_parser("top")
    gtp.add_argument("--limit", type=int, default=20,
                     help="max (service, component) rows to print")
    ep = sub.add_parser(
        "events", help="cluster flight recorder: the durable journal of "
                       "state transitions (node join/death, failover, "
                       "drain + KV migration, resizes, PG repair)")
    ep.add_argument("--kind", help="kind prefix filter (e.g. 'node', "
                                   "'serve', 'pg.repair')")
    ep.add_argument("--node", help="exact node id filter")
    ep.add_argument("--since-s", type=float, default=None, dest="since_s",
                    help="only entries younger than this many seconds")
    ep.add_argument("--limit", type=int, default=50)
    sub.add_parser(
        "doctor", help="fused cluster health report: ranked findings "
                       "over federated metrics, hung tasks, event loss, "
                       "GCS load shares, loop lag, and the flight "
                       "recorder")
    dp = sub.add_parser("dashboard")
    dp.add_argument("--host", default="127.0.0.1")
    dp.add_argument("--port", type=int, default=8265)
    kp = sub.add_parser(
        "stack",
        help="signal-safe all-thread stack dumps from live workers "
             "(works on GIL-wedged workers; ref: `ray stack`)")
    kp.add_argument("--node", help="node id prefix filter")
    kp.add_argument("--worker", help="worker id prefix or exact pid")
    kp.add_argument("--task",
                    help="task id/name substring: dump only workers "
                         "running matching RUNNING attempts")
    kp.add_argument("--raw", action="store_true",
                    help="print raw faulthandler text instead of "
                         "parsed frames")
    kp.add_argument("--out", help="write the full dump JSON here")
    tp2 = sub.add_parser(
        "top", help="per-task resource usage (cpu/rss attribution "
                    "from task events)")
    tp2.add_argument("--node", help="node id prefix filter")
    tp2.add_argument("--per-node", action="store_true",
                     help="break rows out per node instead of "
                          "cluster-wide per name")
    tp2.add_argument("--limit", type=int, default=10000)
    pp = sub.add_parser(
        "profile",
        help="sampling cluster flamegraph: fan the profile RPC out to "
             "matching workers, merge collapsed stacks")
    pp.add_argument("--node", help="node id prefix filter")
    pp.add_argument("--worker", help="worker id prefix or exact pid")
    pp.add_argument("--task",
                    help="task id/name substring: profile only workers "
                         "running matching RUNNING attempts")
    pp.add_argument("--actor", help="actor id prefix filter")
    pp.add_argument("-d", "--duration", type=float, default=5.0)
    pp.add_argument("--interval", type=float, default=0.01)
    pp.add_argument("--out", default="cluster_flame.collapsed",
                    help="merged collapsed-stack output file")
    up = sub.add_parser("up")
    up.add_argument("config", help="cluster YAML path")
    up.add_argument("--no-block", action="store_true",
                    help="return after startup; the autoscaler runs in a "
                         "detached launcher process (`ray-tpu down` "
                         "stops it)")
    dn = sub.add_parser("down")
    dn.add_argument("config", help="cluster YAML path or cluster name")
    ln = sub.add_parser(
        "lint",
        help="run the AST invariant lint suite (knob registry, wire-typed "
             "errors, protocol fingerprint, async hot paths, lock order, "
             "reserved kwargs) over the source tree")
    ln.add_argument("--rule", action="append", dest="rules", metavar="NAME",
                    help="run only this rule (repeatable)")
    ln.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ln.add_argument("--root", default=None,
                    help="tree to lint (default: the installed package's "
                         "repo root)")
    ln.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    ln.add_argument("--update-fingerprint", action="store_true",
                    help="record the current frame-layout hash for the "
                         "current PROTOCOL_VERSION and exit")
    ln.add_argument("--knob-table", action="store_true",
                    help="print the README knob table generated from the "
                         "config registry and exit")
    gp = sub.add_parser("logs")
    gp.add_argument("--node", help="node id prefix filter")
    gp.add_argument("--worker", help="worker id prefix filter")
    gp.add_argument("--actor", help="actor id prefix filter")
    gp.add_argument("--job", help="exact job id filter")
    gp.add_argument("--lines", type=int, default=100)
    gp.add_argument("--follow", action="store_true",
                    help="stream live lines instead of dumping buffers")
    gp.add_argument("--dead", nargs="?", const="", default=None,
                    metavar="WORKER",
                    help="post-mortem: only workers no longer alive "
                         "(optionally a worker id prefix) — their last "
                         "lines are retained GCS-side")
    args = p.parse_args(argv)

    if args.cmd == "lint":
        cmd_lint(args)
        return
    if args.cmd == "up":
        cmd_up(args)
        return
    if args.cmd == "down":
        cmd_down(args)
        return
    if args.cmd == "start":
        cmd_start(args)
        return
    if args.cmd == "job":
        cmd_job(args)
        return
    if args.cmd == "dashboard":
        cmd_dashboard(args)
        return
    if args.cmd == "metrics" and args.grafana_out:
        # Pure file generation — must work with NO cluster (falls back
        # to the known daemon metric set); uses live cluster metadata
        # when one is reachable.
        cmd_grafana_out(args)
        return
    gcs = _Gcs(_resolve_address(args))
    {"status": cmd_status, "list": cmd_list, "timeline": cmd_timeline,
     "metrics": cmd_metrics, "stack": cmd_stack, "top": cmd_top,
     "profile": cmd_profile, "logs": cmd_logs,
     "serve": cmd_serve, "train": cmd_train, "gcs": cmd_gcs,
     "events": cmd_events, "doctor": cmd_doctor}[args.cmd](gcs, args)


if __name__ == "__main__":
    main()
