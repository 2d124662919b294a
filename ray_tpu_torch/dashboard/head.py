"""Dashboard head: REST API + embedded HTML UI.

The port's copy of `ray_tpu/dashboard/head.py`, on the standard library:
the JAX package serves through aiohttp, which this one never imports. The
head runs on `asyncio.start_server` and reads requests and writes
responses with the port's serve proxy's HTTP/1.1 helpers
(`serve/http_proxy.py`); routes, status codes, content types and bodies
are the ones the JAX package's aiohttp head sends, its 404/405/500 pages
included. The UI's accelerator column counts GPUs.

Analogue of the reference `DashboardHead` (ref: dashboard/head.py, REST
routes in dashboard/modules/{node,actor,job,state,metrics}/*). One
asyncio process: every /api/* route is a thin view over GCS RPCs, so the
dashboard holds no state of its own and can restart freely.

    GET /api/nodes            node table (+ per-node resource totals)
    GET /api/actors           actor table
    GET /api/tasks?limit=N    recent task events
    GET /api/jobs             driver jobs + submitted jobs
    GET /api/pgs              placement groups
    GET /api/cluster_status   autoscaler view (demand, idle, requests)
    GET /api/metrics          per-node daemon metrics (Prometheus text)
    GET /api/timeline         chrome://tracing JSON of task events
    POST /api/jobs            submit a job; GET /api/jobs/<id>[/logs],
                              POST /api/jobs/<id>/stop
    GET /api/events|logs|profile|serve
    GET /                     embedded HTML UI polling the above
"""
from __future__ import annotations

import asyncio
import json
import logging
import re
from typing import Optional

from ray_tpu_torch.core.distributed.rpc import AsyncRpcClient
from ray_tpu_torch.serve.http_proxy import (
    _BadRequest,
    _json_response,
    _read_request,
    _Response,
)

logger = logging.getLogger(__name__)

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray-tpu dashboard</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f6f7f9;color:#1a1d21}
 header{background:#1a1d21;color:#fff;padding:10px 18px;font-size:15px}
 header span{opacity:.65;margin-left:10px;font-size:12px}
 main{padding:14px 18px;display:grid;gap:14px}
 section{background:#fff;border:1px solid #e3e6ea;border-radius:8px;padding:10px 14px}
 h2{font-size:13px;text-transform:uppercase;letter-spacing:.06em;color:#5a6472;margin:2px 0 8px}
 table{border-collapse:collapse;width:100%;font-size:12.5px}
 th,td{text-align:left;padding:3px 10px 3px 0;border-bottom:1px solid #eef0f3;font-variant-numeric:tabular-nums}
 th{color:#8a93a0;font-weight:600}
 .ok{color:#0a7d33}.bad{color:#b3261e}.muted{color:#8a93a0}
</style></head><body>
<header>ray-tpu dashboard<span id="addr"></span><span id="ts"></span></header>
<main>
 <section><h2>Nodes</h2><table id="nodes"></table></section>
 <section><h2>Resources</h2><table id="resources"></table></section>
 <section><h2>Actors</h2><table id="actors"></table></section>
 <section><h2>Jobs</h2><table id="jobs"></table></section>
 <section><h2>Placement groups</h2><table id="pgs"></table></section>
 <section><h2>Serve</h2><table id="serve"></table></section>
 <section><h2>Recent tasks</h2><table id="tasks"></table></section>
 <section><h2>Cluster events</h2><table id="events"></table></section>
 <section><h2>Logs
  <input id="logq" placeholder="actor/worker/job id (blank: all)"
         style="font-size:12px;margin-left:8px;padding:2px 6px">
  <button id="logb" style="font-size:12px">tail</button>
  <button id="profb" style="font-size:12px">profile worker</button></h2>
  <pre id="logs" style="font-size:11.5px;max-height:260px;overflow:auto;
    background:#14161a;color:#d7dce2;padding:8px;border-radius:6px;
    margin:0"></pre></section>
</main>
<script>
const esc=s=>String(s??"").replace(/[&<>]/g,c=>({"&":"&amp;","<":"&lt;",">":"&gt;"}[c]));
const row=(cells,h)=> "<tr>"+cells.map(c=>`<${h?"th":"td"}>${c}</${h?"th":"td"}>`).join("")+"</tr>";
async function j(u){const r=await fetch(u);return r.json()}
async function tick(){
 try{
  const [nodes,actors,jobs,pgs,tasks,status,serve,events]=await Promise.all([
    j("/api/nodes"),j("/api/actors"),j("/api/jobs"),j("/api/pgs"),
    j("/api/tasks?limit=25"),j("/api/cluster_status"),
    j("/api/serve"),j("/api/events?limit=15")]);
  document.getElementById("ts").textContent="updated "+new Date().toLocaleTimeString();
  document.getElementById("nodes").innerHTML=row(["node","state","address","cpu","gpu","idle s"],1)+
   status.nodes.map(n=>row([esc(n.node_id.slice(0,12)),
     n.alive?'<span class="ok">ALIVE</span>':'<span class="bad">DEAD</span>',
     esc((nodes.find(x=>x.node_id==n.node_id)||{}).address||""),
     `${(n.total.CPU??0)-(n.available.CPU??0)}/${n.total.CPU??0}`,
     `${(n.total.GPU??0)-(n.available.GPU??0)}/${n.total.GPU??0}`,
     n.alive?n.idle_s.toFixed(0):""])).join("");
  const tot={},av={};
  for(const n of status.nodes){ if(!n.alive)continue;
    for(const k in n.total){tot[k]=(tot[k]??0)+n.total[k];}
    for(const k in n.available){av[k]=(av[k]??0)+n.available[k];}}
  document.getElementById("resources").innerHTML=row(["resource","used","total"],1)+
   Object.keys(tot).sort().map(k=>row([esc(k),
     k=="memory"?((tot[k]-(av[k]??0))/1e9).toFixed(1)+" GB":(tot[k]-(av[k]??0)).toFixed(1),
     k=="memory"?(tot[k]/1e9).toFixed(1)+" GB":tot[k]])).join("");
  document.getElementById("actors").innerHTML=row(["actor","class","state","name","node"],1)+
   actors.map(a=>row([esc(a.actor_id.slice(0,12)),esc(a.cls_name),
     a.state=="ALIVE"?'<span class="ok">ALIVE</span>':esc(a.state),
     esc(a.name||""),esc((a.node_id||"").slice(0,12))])).join("");
  document.getElementById("jobs").innerHTML=row(["job","kind","state","entrypoint"],1)+
   jobs.map(x=>row([esc(x.id),esc(x.kind),esc(x.state),
     `<span class="muted">${esc(x.entrypoint||"")}</span>`])).join("");
  document.getElementById("pgs").innerHTML=row(["pg","state","strategy","bundles"],1)+
   pgs.map(p=>row([esc(p.pg_id.slice(0,12)),esc(p.state),esc(p.strategy),
     (p.bundles||[]).length])).join("");
  document.getElementById("tasks").innerHTML=row(["task","name","state","ms","node"],1)+
   tasks.map(t=>row([esc((t.task_id||"").slice(0,12)),esc(t.name),
     t.state=="FINISHED"?'<span class="ok">FINISHED</span>':esc(t.state),
     ((t.end_ts-t.start_ts)*1000).toFixed(1),
     esc((t.node_id||"").slice(0,12))])).join("");
  document.getElementById("serve").innerHTML=row(["app","ready","running","target","version"],1)+
   Object.entries(serve).map(([app,s])=>row([esc(app),
     s.ready>=s.target?`<span class="ok">${esc(s.ready)}</span>`:`<span class="bad">${esc(s.ready)}</span>`,
     esc(s.running),esc(s.target),esc(s.version)])).join("");
  document.getElementById("events").innerHTML=row(["time","severity","source","message"],1)+
   events.map(e=>row([new Date(e.ts*1000).toLocaleTimeString(),
     e.severity=="ERROR"?'<span class="bad">ERROR</span>':esc(e.severity),
     esc(e.source),esc((e.message||"").slice(0,160))])).join("");
 }catch(e){document.getElementById("ts").textContent="error: "+e}
}
async function tailLogs(){
 const q=document.getElementById("logq").value.trim();
 const p=q?(q.length>20?`worker_id=${q}`:`actor_id=${q}`):"";
 try{
  const streams=await j(`/api/logs?lines=200&`+p);
  document.getElementById("logs").textContent=streams.flatMap(s=>
    s.lines.map(l=>`[${(s.worker_id||"").slice(0,6)}/${s.stream}] ${l}`)
  ).join("\n")||"(no matching worker logs)";
 }catch(e){document.getElementById("logs").textContent="error: "+e}
}
document.getElementById("logb").onclick=tailLogs;
document.getElementById("profb").onclick=async()=>{
 const q=document.getElementById("logq").value.trim();
 const el=document.getElementById("logs");
 el.textContent="sampling 2s...";
 try{
  const r=await fetch(`/api/profile?duration=2&worker_id=${q}`);
  if(!r.ok){el.textContent=await r.text();return}
  const p=await r.json();
  el.textContent=`worker ${p.worker_id.slice(0,12)} pid ${p.pid} — ${p.samples} samples\n`+
   p.top.map(([f,n])=>`${(100*n/p.samples).toFixed(1).padStart(5)}%  ${f}`).join("\n");
 }catch(e){el.textContent="error: "+e}
};
document.getElementById("addr").textContent=location.host;
tick();setInterval(tick,2000);
</script></body></html>"""


def _text(text: str, status: int = 200,
          content_type: str = "text/plain") -> _Response:
    """aiohttp's `web.Response(text=...)`: utf-8 with its charset named."""
    return _Response(text.encode(), status,
                     content_type=f"{content_type}; charset=utf-8")


class _Routed:
    """A request with its route's path parameters (aiohttp's
    `request.match_info`)."""

    __slots__ = ("method", "path", "query", "headers", "body", "match_info")

    def __init__(self, request, match_info: dict):
        self.method = request.method
        self.path = request.path
        self.query = request.query
        self.headers = request.headers
        self.body = request.body
        self.match_info = match_info


class DashboardHead:
    def __init__(self, gcs_address: str, host: str = "127.0.0.1",
                 port: int = 8265):
        self.gcs_address = gcs_address
        self.host = host
        self.port = port
        self._gcs: Optional[AsyncRpcClient] = None
        self._server: Optional[asyncio.AbstractServer] = None
        # (method, path pattern, handler), in the JAX head's order; a
        # `{sid}` segment matches one path segment.
        self._routes = []
        for method, path, handler in (
                ("GET", "/", self._index),
                ("GET", "/api/nodes", self._nodes),
                ("GET", "/api/actors", self._actors),
                ("GET", "/api/tasks", self._tasks),
                ("GET", "/api/jobs", self._jobs),
                ("POST", "/api/jobs", self._submit_job),
                ("GET", "/api/jobs/{sid}", self._job_info),
                ("GET", "/api/jobs/{sid}/logs", self._job_logs),
                ("POST", "/api/jobs/{sid}/stop", self._stop_job),
                ("GET", "/api/pgs", self._pgs),
                ("GET", "/api/events", self._events),
                ("GET", "/api/cluster_status", self._cluster_status),
                ("GET", "/api/metrics", self._metrics),
                ("GET", "/api/timeline", self._timeline),
                ("GET", "/api/logs", self._logs),
                ("GET", "/api/profile", self._profile_worker),
                ("GET", "/api/serve", self._serve)):
            pattern = re.compile(
                "^" + re.escape(path).replace(r"\{sid\}", "(?P<sid>[^{}/]+)")
                + "$")
            self._routes.append((method, pattern, handler))

    async def _call(self, service: str, method: str, **kw):
        if self._gcs is None:
            self._gcs = AsyncRpcClient(self.gcs_address)
        return await self._gcs.call(service, method, timeout=15, **kw)

    # -- handlers -------------------------------------------------------
    async def _index(self, request):
        return _text(_PAGE, content_type="text/html")

    def _json(self, payload):
        return _text(json.dumps(payload), content_type="application/json")

    async def _nodes(self, request):
        return self._json(await self._call("NodeInfo", "list_nodes"))

    async def _actors(self, request):
        return self._json(await self._call("ActorManager", "list_actors"))

    async def _tasks(self, request):
        limit = int(request.query.get("limit", "200"))
        return self._json(await self._call("TaskEvents", "list_events",
                                           limit=limit))

    async def _jobs(self, request):
        from ray_tpu_torch.job_submission import parse_job_records

        out = []
        for job in await self._call("JobManager", "list_jobs"):
            out.append({
                "id": job["job_id"], "kind": "driver",
                "state": "FINISHED" if job.get("finished") else "RUNNING",
                "entrypoint": "",
            })
        # Submitted jobs live in the KV under the "job" namespace; the
        # record layout is owned by job_submission.parse_job_records.
        keys = [k for k in await self._call("KV", "keys", namespace="job",
                                            prefix=b"")
                if b":" not in k]
        raws = await asyncio.gather(*[
            self._call("KV", "get", namespace="job", key=k)
            for k in keys])
        items = dict(zip(keys, raws))
        for info in parse_job_records(items):
            out.append({
                "id": info.submission_id, "kind": "submission",
                "state": info.status,
                "entrypoint": info.entrypoint,
            })
        return self._json(out)

    # -- job submission over REST (ref: dashboard/modules/job/
    # job_head.py submit/stop/logs; a non-Python client needs nothing
    # but HTTP) ---------------------------------------------------------
    async def _submit_job(self, request):
        try:
            body = json.loads(request.body)
        except Exception:  # noqa: BLE001
            return _text(status=400, text="invalid JSON body")
        entrypoint = body.get("entrypoint")
        if not entrypoint or not isinstance(entrypoint, str):
            return _text(status=400, text="'entrypoint' (string) is required")
        import uuid as _uuid

        submission_id = (body.get("submission_id")
                         or f"raytpu_job_{_uuid.uuid4().hex[:10]}")
        existing = await self._call("KV", "get", namespace="job",
                                    key=submission_id.encode())
        if existing is not None:
            return _text(status=400, text=f"job {submission_id!r} already exists")
        runtime_env = dict(body.get("runtime_env") or {})
        env_vars = runtime_env.pop("env_vars", {}) or {}
        metadata = body.get("metadata") or {}

        # The supervisor is created straight through the GCS actor
        # manager — the dashboard is not a driver, so it exports the
        # class blob + builds the actor record itself (the same record
        # core_worker.create_actor writes).
        from ray_tpu_torch.core.distributed import protocol
        from ray_tpu_torch.core.ids import ActorID
        from ray_tpu_torch.job_submission.supervisor import JobSupervisor

        key, blob = protocol.function_key(JobSupervisor)
        await self._call("KV", "put", namespace="fn", key=key,
                         value=blob, overwrite=False)
        args_blob, _ = protocol.pack_args(
            [submission_id, entrypoint, metadata, self.gcs_address,
             env_vars], {}, lambda r: None)
        normalized = None
        if runtime_env:
            from ray_tpu_torch.core.distributed.rpc import SyncRpcClient
            from ray_tpu_torch.runtime_env import normalize

            def _normalize():
                sc = SyncRpcClient(self.gcs_address)
                try:
                    def kv_put(namespace, key, value):
                        if isinstance(namespace, bytes):
                            namespace = namespace.decode()
                        sc.call("KV", "put", namespace=namespace,
                                key=key, value=value, overwrite=True,
                                timeout=60)

                    return normalize(runtime_env, kv_put)
                finally:
                    sc.close()

            try:
                loop = asyncio.get_running_loop()
                normalized = await loop.run_in_executor(None, _normalize)
            except ValueError as e:
                return _text(status=400, text=f"bad runtime_env: {e}")
        record = {
            "actor_id": ActorID.generate().hex(),
            "cls_blob_key": key,
            "cls_name": "JobSupervisor",
            "args_blob": args_blob,
            "demand": {"CPU": float(body.get("entrypoint_num_cpus", 0))},
            "max_restarts": 0,
            "name": f"_job_supervisor_{submission_id}",
            "namespace": "_job",
            "detached": True,
            "owner_job": "",
            "max_concurrency": 1,
            "runtime_env": normalized,
        }
        # Initial PENDING record BEFORE the supervisor exists, so
        # status polls right after submit see the job (the supervisor
        # overwrites it when it starts); overwrite=False also closes
        # the race of two concurrent submits with the same id.
        import time as _time

        info = {"submission_id": submission_id, "entrypoint": entrypoint,
                "status": "PENDING", "message": "supervisor starting",
                "metadata": metadata, "start_time": _time.time(),
                "end_time": None}
        fresh = await self._call(
            "KV", "put", namespace="job", key=submission_id.encode(),
            value=json.dumps(info).encode(), overwrite=False)
        if not fresh:
            return _text(status=400, text=f"job {submission_id!r} already exists")
        try:
            await self._call("ActorManager", "create_actor",
                             record=record)
        except Exception as e:  # noqa: BLE001
            await self._call("KV", "delete", namespace="job",
                             key=submission_id.encode())
            return _text(status=500, text=f"supervisor creation failed: {e}")
        return self._json({"submission_id": submission_id})

    async def _job_info(self, request):
        sid = request.match_info["sid"]
        raw = await self._call("KV", "get", namespace="job",
                               key=sid.encode())
        if raw is None:
            return _text(status=404, text=f"no job {sid!r}")
        return self._json(json.loads(raw.decode()))

    async def _job_logs(self, request):
        sid = request.match_info["sid"]
        raw = await self._call("KV", "get", namespace="job",
                               key=f"{sid}:logs".encode())
        if raw is None:
            info = await self._call("KV", "get", namespace="job",
                                    key=sid.encode())
            if info is None:
                return _text(status=404, text=f"no job {sid!r}")
            raw = b""
        return _text(raw.decode(errors="replace"))

    async def _stop_job(self, request):
        sid = request.match_info["sid"]
        raw = await self._call("KV", "get", namespace="job",
                               key=sid.encode())
        if raw is None:
            return _text(status=404, text=f"no job {sid!r}")
        # Terminal jobs aren't stoppable — mirror the native client's
        # False (and don't leave a stop flag that would kill a future
        # job resubmitted under this id).
        if json.loads(raw.decode()).get("status") in (
                "SUCCEEDED", "FAILED", "STOPPED"):
            return self._json({"stopped": False})
        # Durable stop flag: the supervisor's poll loop consumes it
        # within one tick (works even while the actor path is busy).
        await self._call("KV", "put", namespace="job",
                         key=f"{sid}:stop".encode(), value=b"1",
                         overwrite=True)
        return self._json({"stopped": True})

    async def _profile_worker(self, request):
        """On-demand stack sampling of a live worker, from the UI/REST
        (ref: dashboard/modules/reporter/profile_manager.py attaching
        py-spy from the dashboard). `?worker_id=<prefix>` picks the
        worker; `&duration=2` seconds; `&format=collapsed` returns
        flamegraph-collapsed lines instead of the summary."""
        prefix = request.query.get("worker_id", "")
        duration = min(30.0, float(request.query.get("duration", "2")))
        fmt = request.query.get("format", "summary")
        for n in await self._call("NodeInfo", "list_nodes"):
            if not n["alive"]:
                continue
            daemon = AsyncRpcClient(n["address"])
            try:
                workers = await daemon.call("NodeDaemon", "list_workers",
                                            timeout=10)
            except Exception:  # noqa: BLE001
                continue
            finally:
                await daemon.close()
            for w in workers:
                if not w.get("address") or not w.get("alive", True):
                    continue
                if prefix and not w["worker_id"].startswith(prefix):
                    continue
                client = AsyncRpcClient(w["address"])
                try:
                    report = await client.call(
                        "Worker", "profile", duration_s=duration,
                        timeout=duration + 30)
                except Exception:  # noqa: BLE001 worker churned away
                    continue       # between list and call: try the next
                finally:
                    await client.close()
                if fmt == "collapsed":
                    lines = [f"{stack} {cnt}" for stack, cnt in
                             report["stacks"].items()]
                    return _text("\n".join(lines))
                return self._json({
                    "worker_id": w["worker_id"], "pid": w.get("pid"),
                    "node_id": n["node_id"],
                    "samples": report["samples"],
                    "duration_s": report["duration_s"],
                    "top": report["top"],
                })
        return _text(status=404, text=f"no live worker matches "
                                 f"{prefix!r}")

    async def _events(self, request):
        limit = int(request.query.get("limit", "500"))
        return self._json(await self._call("EventLog", "list_events",
                                           limit=limit))

    async def _pgs(self, request):
        return self._json(await self._call("PlacementGroups", "list_pgs"))

    async def _cluster_status(self, request):
        return self._json(await self._call("AutoscalerState",
                                           "get_cluster_status"))

    async def _metrics(self, request):
        """Aggregate per-node Prometheus text (ref: dashboard metrics
        module scraping each node's metrics agent)."""
        async def scrape(n):
            client = AsyncRpcClient(n["address"])
            try:
                text = await client.call("NodeDaemon", "get_metrics",
                                         timeout=5)
                return f"# node {n['node_id'][:12]}\n{text}"
            except Exception as e:  # noqa: BLE001
                return f"# node {n['node_id'][:12]} unreachable: {e}"
            finally:
                await client.close()

        alive = [n for n in await self._call("NodeInfo", "list_nodes")
                 if n["alive"]]
        # One slow node bounds the scrape, not the sum over nodes.
        chunks = await asyncio.gather(*[scrape(n) for n in alive])
        return _text("\n".join(chunks))

    async def _serve(self, request):
        """Serve app health from the controller's KV snapshot (ref:
        dashboard/modules/serve reading controller snapshots) — no
        actor call into the controller needed."""
        blob = await self._call("KV", "get", namespace="serve",
                                key=b"status")
        return self._json(json.loads(blob) if blob else {})

    async def _timeline(self, request):
        from ray_tpu_torch.util.timeline import chrome_trace

        limit = int(request.query.get("limit", "10000"))
        events = await self._call("TaskEvents", "list_events", limit=limit)
        return self._json(chrome_trace(events))

    async def _logs(self, request):
        """Ring-buffered worker logs from the GCS LogManager — includes
        DEAD workers' last lines (ref: dashboard log viewer over the
        log monitor's files)."""
        q = request.query
        return self._json(await self._call(
            "LogManager", "tail_logs",
            node_id=q.get("node_id"), worker_id=q.get("worker_id"),
            actor_id=q.get("actor_id"), job_id=q.get("job_id"),
            num_lines=int(q.get("lines", "100"))))

    # -- lifecycle ------------------------------------------------------
    async def _handle(self, request) -> _Response:
        path_known = False
        for method, pattern, handler in self._routes:
            m = pattern.match(request.path)
            if m is None:
                continue
            if method != request.method and not (
                    method == "GET" and request.method == "HEAD"):
                path_known = True
                continue
            try:
                return await handler(_Routed(request, m.groupdict()))
            except Exception:  # noqa: BLE001 aiohttp's catch-all page
                logger.exception("dashboard handler %s failed",
                                 request.path)
                return _text("500 Internal Server Error\n\n"
                             "Server got itself in trouble", 500)
        # aiohttp's own pages for an unmatched method or route.
        if path_known:
            return _text("405: Method Not Allowed", 405)
        return _text("404: Not Found", 404)

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    request = await _read_request(reader, writer)
                except _BadRequest as e:
                    await _json_response({"error": str(e)},
                                         status=e.status).send(
                                             writer, keep_alive=False)
                    return
                if request is None:
                    return
                resp = await self._handle(request)
                if request.method == "HEAD":
                    resp.body = b""
                await resp.send(writer, request.keep_alive)
                if not request.keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass     # the client went away mid-request or mid-response
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("dashboard at http://%s:%d", self.host, self.port)
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._gcs is not None:
            await self._gcs.close()


def start_dashboard(gcs_address: str, host: str = "127.0.0.1",
                    port: int = 0):
    """In-process helper: run the dashboard on a daemon thread; returns
    (DashboardHead, bound_port)."""
    import threading

    head = DashboardHead(gcs_address, host, port)
    started = threading.Event()
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(head.start())
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True,
                     name="dashboard-head").start()
    if not started.wait(30):
        raise RuntimeError("dashboard failed to start")
    return head, head.port


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8265)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="[dashboard] %(message)s")

    async def run():
        head = DashboardHead(args.gcs_address, args.host, args.port)
        port = await head.start()
        print(f"DASHBOARD_PORT={port}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
