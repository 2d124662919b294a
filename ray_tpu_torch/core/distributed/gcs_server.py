"""GCS: the cluster control plane.

The port's copy of `ray_tpu/core/distributed/gcs_server.py`,
importing `ray_tpu_torch` only.

Analogue of the reference GCS server (ref: src/ray/gcs/gcs_server/
gcs_server.cc:182 DoStart — node manager, resource manager, health check,
job manager, PG manager, actor manager, worker manager, task manager; storage
tables gcs_table_storage.h). One asyncio process hosting:

  NodeInfo         — node registry + heartbeats + health checks
  KV               — cluster KV store (also the function table)
  ActorManager     — actor scheduling, restarts, named actors
  ObjectDirectory  — object locations + distributed free
  PlacementGroups  — bundle reservation across nodes
  JobManager       — driver/job registry
  TaskEvents       — task event sink powering the state API
  Pubsub           — long-poll pub/sub (ref: src/ray/pubsub/)
  LogManager       — worker log hub: ring buffers + driver streaming

State lives in memory (the reference's default, ray_config_def.h:402
gcs_storage="memory"); a Redis-equivalent durable backend can be slotted in
at the _Store seam.
"""
from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from collections import OrderedDict, defaultdict, deque
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.distributed import resources as rs
from ray_tpu_torch.core.distributed.rpc import AsyncRpcClient, RpcServer
from ray_tpu_torch.core.distributed.protocol import RUNTIME
from ray_tpu_torch.core.distributed.scheduler import (
    ClusterView,
    NodeView,
    pick_node,
    place_bundles,
)

logger = logging.getLogger(__name__)


class Pubsub:
    """Channelized pub/sub over server-streaming RPCs (ref: src/ray/pubsub/
    publisher.h — long-poll batched delivery)."""

    def __init__(self):
        self._subs: Dict[str, List[asyncio.Queue]] = defaultdict(list)

    def publish(self, channel: str, message: Any) -> int:
        for q in list(self._subs.get(channel, [])):
            q.put_nowait(message)
        return len(self._subs.get(channel, []))

    async def stream_subscribe(self, channel: str):
        q: asyncio.Queue = asyncio.Queue()
        self._subs[channel].append(q)
        try:
            while True:
                yield await q.get()
        finally:
            self._subs[channel].remove(q)


class KV:
    """Namespaced key-value store (ref: gcs InternalKV — used for the
    function table, runtime env URIs, cluster metadata). Durable when
    the GCS runs with a storage dir (the function table must survive a
    GCS restart or restarted actors cannot fetch their classes)."""

    def __init__(self, store=None):
        from ray_tpu_torch.core.distributed.gcs_storage import NullStore

        self._store = store or NullStore()
        self._data: Dict[Tuple[str, bytes], bytes] = dict(
            self._store.all("kv"))
        self.flight: Optional["FlightRecorder"] = None  # set by GcsServer

    def put(self, namespace: str, key: bytes, value: bytes,
            overwrite: bool = True) -> bool:
        k = (namespace, key)
        if not overwrite and k in self._data:
            return False
        self._data[k] = value
        self._store.put("kv", k, value)
        if (self.flight is not None and namespace == "serve"
                and key.startswith(b"migrate:")):
            # Live KV-migration tickets (serve drain) transit this KV:
            # journal the publish leg so `ray-tpu events` shows the
            # drain's migration hops next to the drain itself.
            self.flight.record(
                "serve.kv_migrate",
                "migration ticket published: "
                + key[len(b"migrate:"):].decode("utf-8", "replace"),
                fields={"nbytes": len(value)})
        return True

    def get(self, namespace: str, key: bytes) -> Optional[bytes]:
        return self._data.get((namespace, key))

    def delete(self, namespace: str, key: bytes) -> bool:
        self._store.delete("kv", (namespace, key))
        return self._data.pop((namespace, key), None) is not None

    def keys(self, namespace: str, prefix: bytes = b"") -> List[bytes]:
        return [k for (ns, k) in self._data if ns == namespace
                and k.startswith(prefix)]


class NodeInfo:
    """Node registry + heartbeat-driven health checking (ref:
    gcs_node_manager.h:44, gcs_health_check_manager.h:39)."""

    def __init__(self, gcs: "GcsServer"):
        self._gcs = gcs
        self.view = ClusterView()

    def runtime(self) -> str:
        return RUNTIME

    def register_node(self, node_id: str, address: str,
                      resources: Dict[str, float], store_dir: str,
                      labels: Optional[Dict[str, str]] = None) -> dict:
        prior = self.view.nodes.get(node_id)
        self.view.nodes[node_id] = NodeView(
            node_id=node_id, address=address, total=dict(resources),
            available=dict(resources), store_dir=store_dir,
            labels=labels or {})
        if prior is not None and not prior.alive:
            # An explicit resurrection, not silent flapping: the daemon
            # was told "stale node" and chose to re-register as a fresh
            # incarnation (its actors/objects were already failed over).
            logger.warning("dead node %s re-registered at %s", node_id[:8],
                           address)
            self._gcs.event_log.emit(
                "node", "WARNING",
                f"node {node_id[:8]} re-registered after being marked "
                f"dead", node_id=node_id, address=address)
            self._gcs.flight.record(
                "node.rejoin",
                f"node {node_id[:8]} re-registered after being marked "
                f"dead", node_id=node_id, severity="WARNING",
                fields={"address": address})
        else:
            logger.info("node %s registered at %s resources=%s",
                        node_id[:8], address, resources)
            self._gcs.event_log.emit("node", "INFO",
                                     f"node {node_id[:8]} registered",
                                     node_id=node_id, address=address)
            self._gcs.flight.record(
                "node.join", f"node {node_id[:8]} registered",
                node_id=node_id,
                fields={"address": address, "resources": dict(resources)})
        self._gcs.syncer.on_node_registered(node_id)
        self._gcs.pubsub.publish(
            "node", {"event": "added", "node_id": node_id,
                     "address": address, "resources": resources,
                     "store_dir": store_dir})
        return {"node_id": node_id}

    def heartbeat(self, node_id: str, available: Dict[str, float],
                  queued_demand: Optional[List[Dict[str, float]]] = None
                  ) -> dict:
        n = self.view.nodes.get(node_id)
        if n is None:
            return {"registered": False}  # ask the node to re-register
        if not n.alive:
            # Explicit stale-node verdict: updates from a node already
            # marked dead must not flap its entry back to life — the
            # daemon re-registers deliberately (a fresh incarnation) and
            # full-resyncs its state through the syncer.
            return {"registered": False, "stale": True,
                    "reason": f"node {node_id[:8]} is marked dead"}
        self.view.update(node_id, available, queued=queued_demand)
        self._gcs.syncer.on_node_heartbeat(node_id)
        return {"registered": True}

    def list_nodes(self) -> List[dict]:
        return [
            {
                "node_id": n.node_id,
                "address": n.address,
                "alive": n.alive,
                "total": n.total,
                "available": n.available,
                "store_dir": n.store_dir,
                "labels": n.labels,
            }
            for n in self.view.nodes.values()
        ]

    def drain_node(self, node_id: str) -> dict:
        return self.mark_dead(node_id, reason="drained")

    def mark_dead(self, node_id: str, reason: str = "health check failed"
                  ) -> dict:
        n = self.view.nodes.get(node_id)
        if n is None or not n.alive:
            return {"ok": False}
        n.alive = False
        logger.warning("node %s marked dead: %s", node_id[:8], reason)
        self._gcs.event_log.emit("node", "WARNING",
                                 f"node {node_id[:8]} dead: {reason}",
                                 node_id=node_id, reason=reason)
        self._gcs.flight.record(
            "node.drain" if reason == "drained" else "node.death",
            f"node {node_id[:8]} dead: {reason}", node_id=node_id,
            severity="WARNING", fields={"reason": reason})
        self._gcs.syncer.on_node_dead(node_id)
        self._gcs.pubsub.publish(
            "node", {"event": "dead", "node_id": node_id, "reason": reason})
        self._gcs.actors.on_node_dead(node_id)
        self._gcs.objects.on_node_dead(node_id)
        self._gcs.placement_groups.on_node_dead(node_id)
        self._gcs.metrics.on_node_dead(node_id)
        return {"ok": True}

    async def health_check_loop(self):
        cfg = get_config()
        period = cfg.health_check_period_ms / 1000
        threshold = cfg.health_check_failure_threshold
        await asyncio.sleep(cfg.health_check_initial_delay_ms / 1000)
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            for n in list(self.view.nodes.values()):
                if n.alive and now - n.last_heartbeat > period * threshold:
                    self.mark_dead(n.node_id)


ACTOR_PENDING = "PENDING_CREATION"
ACTOR_ALIVE = "ALIVE"
ACTOR_RESTARTING = "RESTARTING"
ACTOR_DEAD = "DEAD"


@dataclasses.dataclass
class ActorRecord:
    actor_id: str
    cls_blob_key: bytes            # function-table key for the pickled class
    cls_name: str
    args_blob: bytes               # serialized (args, kwargs)
    demand: Dict[str, float]
    max_restarts: int
    restarts_used: int = 0
    name: Optional[str] = None
    namespace: str = "default"
    detached: bool = False
    owner_job: str = ""
    state: str = ACTOR_PENDING
    node_id: str = ""
    worker_address: str = ""
    death_reason: str = ""
    max_concurrency: int = 1
    placement: Optional[Tuple[str, int]] = None  # (pg_id, bundle_idx)
    runtime_env: Optional[dict] = None           # normalized spec
    # name -> max concurrent executions (ref: concurrency groups,
    # concurrency_group_manager.h)
    concurrency_groups: Dict[str, int] = dataclasses.field(
        default_factory=dict)


class ActorManager:
    """Actor scheduling + fault handling (ref: gcs_actor_manager.h:281,
    gcs_actor_scheduler.h). Creation flow: pick node → ask its daemon to
    start a dedicated worker → push the creation task → publish address."""

    def __init__(self, gcs: "GcsServer", store=None):
        from ray_tpu_torch.core.distributed.gcs_storage import NullStore

        self._gcs = gcs
        self._store = store or NullStore()
        self.actors: Dict[str, ActorRecord] = {}
        self.named: Dict[Tuple[str, str], str] = {}
        self._pending: asyncio.Queue = asyncio.Queue()
        # wait_actor long-poll parkers, woken by _publish: actor_id ->
        # futures of callers waiting for the NEXT state transition.
        self._state_waiters: Dict[str, List[asyncio.Future]] = {}
        # Recovery (ref: GcsActorManager::Initialize reloading from
        # storage): reload records; queued/restarting actors reschedule,
        # ALIVE ones are revalidated once daemons re-register.
        for rec_dict in self._store.all("actor").values():
            rec = ActorRecord(**rec_dict)
            self.actors[rec.actor_id] = rec
            if rec.name and rec.state != ACTOR_DEAD:
                self.named[(rec.namespace, rec.name)] = rec.actor_id

    def requeue_loaded(self) -> None:
        """Called once the event loop runs: resume scheduling of loaded
        non-terminal actors and validate loaded ALIVE ones."""
        for rec in self.actors.values():
            if rec.state in (ACTOR_PENDING, ACTOR_RESTARTING):
                self._pending.put_nowait(rec.actor_id)
        alive = [r.actor_id for r in self.actors.values()
                 if r.state == ACTOR_ALIVE]
        if alive:
            asyncio.ensure_future(self._validate_loaded(alive))

    async def _validate_loaded(self, actor_ids: List[str]) -> None:
        # Let daemons re-register first (their workers may be fine).
        await asyncio.sleep(get_config().health_check_period_ms / 1000 * 2)
        for aid in actor_ids:
            rec = self.actors.get(aid)
            if rec is None or rec.state != ACTOR_ALIVE:
                continue
            ok = False
            try:
                client = AsyncRpcClient(rec.worker_address)
                try:
                    reply = await client.call("Worker", "ping", timeout=5)
                    ok = reply.get("actor_id") == rec.actor_id
                finally:
                    await client.close()
            except Exception:  # noqa: BLE001
                ok = False
            if not ok:
                self._handle_failure(rec, "worker lost while GCS was down")

    def _persist(self, rec: ActorRecord) -> None:
        self._store.put("actor", rec.actor_id, dataclasses.asdict(rec))

    # -- RPC surface ----------------------------------------------------
    async def create_actor(self, record: dict) -> dict:
        rec = ActorRecord(**record)
        if rec.name:
            key = (rec.namespace, rec.name)
            if key in self.named:
                raise ValueError(
                    f"Actor name '{rec.name}' already taken in namespace "
                    f"'{rec.namespace}'")
            self.named[key] = rec.actor_id
        self.actors[rec.actor_id] = rec
        self._persist(rec)
        await self._pending.put(rec.actor_id)
        return {"actor_id": rec.actor_id}

    def get_actor(self, actor_id: Optional[str] = None,
                  name: Optional[str] = None,
                  namespace: str = "default") -> Optional[dict]:
        if actor_id is None and name is not None:
            actor_id = self.named.get((namespace, name))
        rec = self.actors.get(actor_id) if actor_id else None
        if rec is None:
            return None
        return {
            "actor_id": rec.actor_id, "state": rec.state,
            "worker_address": rec.worker_address, "node_id": rec.node_id,
            "cls_name": rec.cls_name, "name": rec.name,
            "death_reason": rec.death_reason,
            "max_concurrency": rec.max_concurrency,
        }

    def list_actors(self) -> List[dict]:
        return [self.get_actor(a) for a in self.actors]

    async def kill_actor(self, actor_id: str, no_restart: bool = True) -> dict:
        rec = self.actors.get(actor_id)
        if rec is None:
            return {"ok": False}
        if no_restart:
            rec.max_restarts = 0
        if rec.worker_address:
            try:
                client = self._gcs.daemon_client(rec.node_id)
                if client is not None:
                    await client.call("NodeDaemon", "kill_worker",
                                      worker_address=rec.worker_address,
                                      timeout=5)
            except Exception as e:  # noqa: BLE001
                logger.warning("kill_actor RPC failed: %s", e)
        self._mark_dead(rec, "killed via kill()")
        return {"ok": True}

    def report_actor_failure(self, actor_id: str, reason: str) -> dict:
        """Called by daemons when an actor's worker process exits."""
        rec = self.actors.get(actor_id)
        # RESTARTING means this incarnation's failure was already handled
        # (e.g. node-death path); a second report must not burn another
        # restart or double-enqueue the actor.
        if rec is None or rec.state in (ACTOR_DEAD, ACTOR_RESTARTING):
            return {"ok": False}
        self._handle_failure(rec, reason)
        return {"ok": True}

    # -- internals ------------------------------------------------------
    def _mark_dead(self, rec: ActorRecord, reason: str) -> None:
        self._gcs.event_log.emit(
            "actor", "WARNING",
            f"actor {rec.actor_id[:8]} ({rec.cls_name}) dead: {reason}",
            actor_id=rec.actor_id, reason=reason)
        if rec.detached or (rec.name or "").startswith("serve:"):
            # Journal-worthy deaths only: detached/serve actors are
            # cluster infrastructure (controllers, proxies, prefill
            # workers) — per-job actor churn stays out of the journal.
            self._gcs.flight.record(
                "actor.death",
                f"actor {rec.name or rec.actor_id[:8]} "
                f"({rec.cls_name}) dead: {reason}",
                node_id=rec.node_id or None, severity="WARNING",
                fields={"actor_id": rec.actor_id, "name": rec.name})
        rec.state = ACTOR_DEAD
        rec.death_reason = reason
        rec.worker_address = ""
        if rec.name:
            self.named.pop((rec.namespace, rec.name), None)
        self._publish(rec)

    def _publish(self, rec: ActorRecord) -> None:
        # Every state transition flows through here: one persistence
        # point keeps the durable record in lockstep.
        self._persist(rec)
        self._gcs.pubsub.publish("actor", {
            "actor_id": rec.actor_id, "state": rec.state,
            "worker_address": rec.worker_address,
            "death_reason": rec.death_reason,
        })
        for fut in self._state_waiters.pop(rec.actor_id, ()):
            if not fut.done():
                fut.set_result(None)

    async def wait_actor(self, actor_id: str, known_state: str = "",
                         timeout: float = 2.0) -> Optional[dict]:
        """Long-poll get_actor: return when the actor's state differs
        from `known_state` (immediately if it already does), or after
        `timeout`. Owners resolving a pending actor park HERE instead of
        hammering get_actor on a fixed cadence — at a 1k-actor creation
        storm the 20ms polling loops alone were a double-digit share of
        the control plane's core (ref: the reference's pubsub-driven
        actor state notifications, gcs_actor_manager.h:281)."""
        rec = self.actors.get(actor_id)
        if rec is None or rec.state != known_state:
            return self.get_actor(actor_id=actor_id)
        fut = asyncio.get_running_loop().create_future()
        self._state_waiters.setdefault(actor_id, []).append(fut)
        try:
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            waiters = self._state_waiters.get(actor_id)
            if waiters is not None:
                try:
                    waiters.remove(fut)
                except ValueError:
                    pass
                if not waiters:
                    self._state_waiters.pop(actor_id, None)
        return self.get_actor(actor_id=actor_id)

    def _handle_failure(self, rec: ActorRecord, reason: str) -> None:
        if rec.state == ACTOR_RESTARTING:
            return  # already queued for rescheduling
        if rec.restarts_used < rec.max_restarts or rec.max_restarts < 0:
            rec.restarts_used += 1
            rec.state = ACTOR_RESTARTING
            rec.worker_address = ""
            self._publish(rec)
            self._pending.put_nowait(rec.actor_id)
            logger.info("actor %s restarting (%d/%s)", rec.actor_id[:8],
                        rec.restarts_used, rec.max_restarts)
            self._gcs.event_log.emit(
                "actor", "WARNING",
                f"actor {rec.actor_id[:8]} restarting "
                f"({rec.restarts_used}/{rec.max_restarts}): {reason}",
                actor_id=rec.actor_id)
            # Serve controller/proxy failover is a cluster transition
            # worth a durable record; plain actor restarts journal only
            # when the actor is detached infrastructure.
            name = rec.name or ""
            if rec.detached or name.startswith("serve:"):
                self._gcs.flight.record(
                    "serve.failover" if name.startswith("serve:")
                    else "actor.failover",
                    f"actor {name or rec.actor_id[:8]} restarting "
                    f"({rec.restarts_used}/{rec.max_restarts}): {reason}",
                    node_id=rec.node_id or None, severity="WARNING",
                    fields={"actor_id": rec.actor_id, "name": rec.name})
        else:
            self._mark_dead(rec, reason)

    def on_node_dead(self, node_id: str) -> None:
        for rec in self.actors.values():
            if rec.node_id == node_id and rec.state in (ACTOR_ALIVE,
                                                        ACTOR_PENDING):
                self._handle_failure(rec, f"node {node_id[:8]} died")

    def on_job_finished(self, job_id: str) -> None:
        for rec in list(self.actors.values()):
            if (not rec.detached and rec.owner_job == job_id
                    and rec.state != ACTOR_DEAD):
                asyncio.ensure_future(self.kill_actor(rec.actor_id))

    async def scheduling_loop(self):
        # Bounded-concurrency scheduling (ref: gcs_actor_scheduler.h —
        # the reference leases workers for many actors in flight at
        # once): a serial loop would cap cluster-wide actor creation at
        # 1/start_actor-latency (~15/s on a small host), no matter how
        # fast the node plane forks. The window is bounded so a burst of
        # creations cannot flood daemons with more concurrent
        # fork+register pipelines than the host can boot at once.
        sem = asyncio.Semaphore(
            max(1, get_config().actor_schedule_concurrency))

        async def requeue(actor_id: str) -> None:
            # Re-queue with a delay (resources may free up) WITHOUT
            # holding a scheduling slot — parked retries must not
            # starve schedulable actors of the window.
            await asyncio.sleep(0.5)
            await self._pending.put(actor_id)

        async def gated(actor_id: str) -> None:
            try:
                rec = self.actors.get(actor_id)
                # Only PENDING/RESTARTING actors may be scheduled; ALIVE
                # means a duplicate queue entry (a second worker would
                # leak), DEAD means the actor was killed while queued.
                if rec is None or rec.state not in (ACTOR_PENDING,
                                                    ACTOR_RESTARTING):
                    return
                try:
                    ok = await self._try_schedule(rec)
                except Exception as e:  # noqa: BLE001
                    logger.exception("actor scheduling error: %s", e)
                    ok = False
                if not ok and rec.state != ACTOR_DEAD:
                    asyncio.ensure_future(requeue(actor_id))
            finally:
                sem.release()

        while True:
            actor_id = await self._pending.get()
            await sem.acquire()
            asyncio.ensure_future(gated(actor_id))

    async def _try_schedule(self, rec: ActorRecord) -> bool:
        view = self._gcs.nodes.view
        node = None
        if rec.placement is not None:
            pg_id, bundle_idx = rec.placement
            node_id = self._gcs.placement_groups.bundle_node(pg_id,
                                                             bundle_idx)
            if node_id is not None:
                node = view.nodes.get(node_id)
        else:
            node = pick_node(view, rec.demand)
        if node is None or not node.alive:
            return False
        client = self._gcs.daemon_client(node.node_id)
        if client is None:
            return False
        try:
            reply = await client.call(
                "NodeDaemon", "start_actor",
                actor_id=rec.actor_id,
                cls_blob_key=rec.cls_blob_key,
                args_blob=rec.args_blob,
                demand=rec.demand,
                runtime_env=rec.runtime_env,
                max_concurrency=rec.max_concurrency,
                concurrency_groups=rec.concurrency_groups,
                placement=rec.placement,
                owner_job=rec.owner_job or "",
                timeout=get_config().actor_creation_timeout_s)
        except Exception as e:  # noqa: BLE001
            logger.warning("start_actor on %s failed: %s", node.node_id[:8],
                           e)
            return False
        if not reply.get("ok"):
            err = reply.get("error", "unknown")
            if reply.get("creation_error"):
                # The user constructor raised — do not retry elsewhere.
                self._mark_dead(rec, f"creation failed: {err}")
                return True
            return False
        if rec.state == ACTOR_DEAD:
            # Killed while the start_actor RPC was in flight: tear down the
            # worker we just started instead of resurrecting the actor.
            try:
                await client.call("NodeDaemon", "kill_worker",
                                  worker_address=reply["worker_address"],
                                  timeout=5)
            except Exception:  # noqa: BLE001
                logger.warning("cleanup kill of %s failed", rec.actor_id[:8])
            return True
        rec.node_id = node.node_id
        rec.worker_address = reply["worker_address"]
        rec.state = ACTOR_ALIVE
        self._publish(rec)
        logger.info("actor %s alive on %s", rec.actor_id[:8],
                    rec.worker_address)
        return True


class ObjectDirectory:
    """Object location registry + distributed free (the centralized stand-in
    for the reference's owner-based directory,
    ref: ownership_based_object_directory.h — centralization trades peak
    scalability for simplicity; the owner remains the refcount authority)."""

    # Dead owners remembered for borrowers' OwnerDiedError verdicts.
    DEAD_OWNERS_CAP = 4096

    def __init__(self, gcs: "GcsServer"):
        self._gcs = gcs
        self.locations: Dict[bytes, Set[str]] = defaultdict(set)
        self.sizes: Dict[bytes, int] = {}
        # Ownership, learned from the location batches: object -> owner
        # address and owner -> objects, so a daemon that sees a worker
        # die can free everything it owned (`free_owned`).
        self.owners: Dict[bytes, str] = {}
        self.owned: Dict[str, Set[bytes]] = defaultdict(set)
        self.dead_owners: "OrderedDict[str, float]" = OrderedDict()

    def _record_owner(self, object_id: bytes, owner: Optional[str]) -> None:
        if owner and object_id not in self.owners:
            self.owners[object_id] = owner
            self.owned[owner].add(object_id)

    def add_location(self, object_id: bytes, node_id: str,
                     size: int = 0, owner: Optional[str] = None) -> dict:
        self.locations[object_id].add(node_id)
        if size:
            self.sizes[object_id] = size
        self._record_owner(object_id, owner)
        return {"ok": True}

    def add_locations(self, entries: List[tuple]) -> dict:
        """Batched registration — one RPC for a burst of task results
        (the hot path batches like the reference's location pubsub).
        Entries are (object, node, size, owner address)."""
        for object_id, node_id, size, owner in entries:
            self.locations[object_id].add(node_id)
            if size:
                self.sizes[object_id] = size
            self._record_owner(object_id, owner)
        return {"ok": True}

    def remove_location(self, object_id: bytes, node_id: str) -> dict:
        self.locations[object_id].discard(node_id)
        return {"ok": True}

    def get_locations(self, object_id: bytes) -> dict:
        nodes = []
        for nid in self.locations.get(object_id, ()):  # only alive nodes
            n = self._gcs.nodes.view.nodes.get(nid)
            if n is not None and n.alive:
                nodes.append({"node_id": nid, "address": n.address,
                              "store_dir": n.store_dir})
        return {"nodes": nodes, "size": self.sizes.get(object_id, 0)}

    async def free_objects(self, object_ids: List[bytes]) -> dict:
        by_node: Dict[str, List[bytes]] = defaultdict(list)
        for oid in object_ids:
            for nid in self.locations.pop(oid, ()):  # consume
                by_node[nid].append(oid)
            self.sizes.pop(oid, None)
            owner = self.owners.pop(oid, None)
            if owner is not None:
                mine = self.owned.get(owner)
                if mine is not None:
                    mine.discard(oid)
                    if not mine:
                        del self.owned[owner]
        for nid, oids in by_node.items():
            client = self._gcs.daemon_client(nid)
            if client is None:
                continue
            try:
                await client.call("NodeDaemon", "delete_objects",
                                  object_ids=oids, timeout=10)
            except Exception as e:  # noqa: BLE001
                logger.debug("free on %s failed: %s", nid[:8], e)
        return {"ok": True}

    async def free_owned(self, owner: str) -> dict:
        """A daemon saw the worker at `owner` die: free every object it
        owned (its puts and the returns of tasks it submitted) on every
        node that holds a copy, and remember the death so a borrower's
        `get` raises OwnerDiedError instead of polling forever."""
        self.dead_owners[owner] = time.time()
        self.dead_owners.move_to_end(owner)
        while len(self.dead_owners) > self.DEAD_OWNERS_CAP:
            self.dead_owners.popitem(last=False)
        oids = list(self.owned.pop(owner, ()))
        if oids:
            await self.free_objects(oids)
        return {"ok": True, "freed": len(oids)}

    def owner_died(self, owner: str) -> bool:
        return owner in self.dead_owners

    def on_node_dead(self, node_id: str) -> None:
        for oid in list(self.locations):
            self.locations[oid].discard(node_id)


PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_REMOVED = "REMOVED"


@dataclasses.dataclass
class PgRecord:
    pg_id: str
    bundles: List[Dict[str, float]]
    strategy: str
    name: Optional[str] = None
    state: str = PG_PENDING
    # One entry per bundle once any placement happened; None marks a
    # hole (bundle-granular gang repair re-places only the holes while
    # surviving bundles stay reserved on their nodes).
    nodes: List[Optional[str]] = dataclasses.field(default_factory=list)
    owner_job: str = ""
    detached: bool = False
    # Soft per-bundle node-label preferences (ICI-topology ordering
    # hint from tpu_slice_placement_group).
    bundle_labels: Optional[List[Optional[Dict[str, str]]]] = None


class PlacementGroupManager:
    """Gang resource reservation (ref: gcs_placement_group_manager.h:230,
    gcs_placement_group_scheduler.h:274 — prepare/commit two-phase). On TPU
    the flagship use is slice-atomic gangs: one bundle per host of a slice,
    STRICT_PACK within an ICI domain."""

    def __init__(self, gcs: "GcsServer", store=None):
        from ray_tpu_torch.core.distributed.gcs_storage import NullStore

        self._gcs = gcs
        self._store = store or NullStore()
        self.groups: Dict[str, PgRecord] = {}
        self._pending: asyncio.Queue = asyncio.Queue()
        # Long-poll wait_pg futures, woken on any state transition.
        self._state_waiters: Dict[str, List[asyncio.Future]] = {}
        for rec_dict in self._store.all("pg").values():
            rec = PgRecord(**rec_dict)
            self.groups[rec.pg_id] = rec

    def requeue_loaded(self) -> None:
        for rec in self.groups.values():
            if rec.state == PG_PENDING:
                self._pending.put_nowait(rec.pg_id)
        created = [r.pg_id for r in self.groups.values()
                   if r.state == PG_CREATED]
        if created:
            asyncio.ensure_future(self._validate_loaded(created))

    async def _validate_loaded(self, pg_ids: List[str]) -> None:
        """A loaded CREATED gang whose host died during the GCS outage
        must re-form: the node never re-registers, so on_node_dead would
        never fire for it (the PG analogue of actor revalidation)."""
        await asyncio.sleep(get_config().health_check_period_ms / 1000
                            * get_config().health_check_failure_threshold)
        view = self._gcs.nodes.view
        for pg_id in pg_ids:
            rec = self.groups.get(pg_id)
            if rec is None or rec.state != PG_CREATED:
                continue
            missing = [nid for nid in rec.nodes
                       if nid is not None
                       and (nid not in view.nodes
                            or not view.nodes[nid].alive)]
            if missing:
                logger.warning(
                    "pg %s lost node(s) %s during GCS outage; "
                    "re-reserving the lost bundles", pg_id[:8],
                    [m[:8] for m in missing])
                rec.nodes = [None if nid in missing else nid
                             for nid in rec.nodes]
                rec.state = PG_PENDING
                self._persist(rec)
                self._wake_waiters(pg_id)
                self._pending.put_nowait(pg_id)

    def _persist(self, rec: PgRecord) -> None:
        self._store.put("pg", rec.pg_id, dataclasses.asdict(rec))

    def _wake_waiters(self, pg_id: str) -> None:
        for fut in self._state_waiters.pop(pg_id, ()):
            if not fut.done():
                fut.set_result(None)

    async def create_pg(self, pg_id: str, bundles: List[Dict[str, float]],
                        strategy: str, name: Optional[str] = None,
                        owner_job: str = "", detached: bool = False,
                        bundle_labels: Optional[List[Optional[Dict[
                            str, str]]]] = None) -> dict:
        rec = PgRecord(pg_id=pg_id, bundles=bundles, strategy=strategy,
                       name=name, owner_job=owner_job, detached=detached,
                       bundle_labels=bundle_labels)
        self.groups[pg_id] = rec
        self._persist(rec)
        await self._pending.put(pg_id)
        return {"pg_id": pg_id}

    def get_pg(self, pg_id: str) -> Optional[dict]:
        rec = self.groups.get(pg_id)
        if rec is None:
            return None
        return {"pg_id": rec.pg_id, "state": rec.state, "nodes": rec.nodes,
                "bundles": rec.bundles, "strategy": rec.strategy,
                "placed": sum(1 for n in rec.nodes if n is not None),
                "bundle_count": len(rec.bundles)}

    async def wait_pg(self, pg_id: str, known_state: str = "",
                      park_s: float = 2.0) -> Optional[dict]:
        """Long-poll get_pg (same pattern as ActorManager.wait_actor):
        return when the gang's state differs from `known_state`
        (immediately if it already does), or after `timeout`. Drivers
        blocking in PlacementGroup.ready() park here instead of
        polling get_pg on a 50ms cadence."""
        rec = self.groups.get(pg_id)
        if rec is None or rec.state != known_state:
            return self.get_pg(pg_id)
        fut = asyncio.get_running_loop().create_future()
        self._state_waiters.setdefault(pg_id, []).append(fut)
        try:
            await asyncio.wait_for(fut, park_s)
        except asyncio.TimeoutError:
            waiters = self._state_waiters.get(pg_id)
            if waiters is not None:
                try:
                    waiters.remove(fut)
                except ValueError:
                    pass
                if not waiters:
                    self._state_waiters.pop(pg_id, None)
        return self.get_pg(pg_id)

    def list_pgs(self) -> List[dict]:
        return [self.get_pg(pid) for pid in self.groups]

    def bundle_node(self, pg_id: str, bundle_idx: int) -> Optional[str]:
        rec = self.groups.get(pg_id)
        if rec is None or rec.state != PG_CREATED:
            return None
        if bundle_idx < 0:
            return rec.nodes[0] if rec.nodes else None
        if bundle_idx >= len(rec.nodes):
            return None
        return rec.nodes[bundle_idx]

    async def remove_pg(self, pg_id: str) -> dict:
        rec = self.groups.get(pg_id)
        if rec is None or rec.state == PG_REMOVED:
            return {"ok": False}
        for idx, nid in enumerate(rec.nodes):
            if nid is None:
                continue
            client = self._gcs.daemon_client(nid)
            if client is None:
                continue
            try:
                await client.call("NodeDaemon", "return_pg_bundle",
                                  pg_id=pg_id, bundle_idx=idx, timeout=10)
            except Exception:  # noqa: BLE001
                pass
        rec.state = PG_REMOVED
        rec.nodes = []
        self._persist(rec)
        self._wake_waiters(pg_id)
        return {"ok": True}

    def on_node_dead(self, node_id: str) -> None:
        for rec in self.groups.values():
            if rec.state == PG_REMOVED or node_id not in rec.nodes:
                continue
            # Bundle-granular recovery: only the dead node's bundles
            # become holes; surviving bundles stay reserved on their
            # nodes while the scheduler re-places the holes (the
            # elastic supervisor meanwhile keeps ranks on the
            # survivors warm for the gang restart).
            rec.nodes = [None if nid == node_id else nid
                         for nid in rec.nodes]
            was_created = rec.state == PG_CREATED
            rec.state = PG_PENDING
            self._persist(rec)
            self._gcs.event_log.emit(
                "placement_group", "WARNING",
                f"pg {rec.pg_id[:8]} gang lost node "
                f"{node_id[:8]}; re-reserving "
                f"{sum(1 for n in rec.nodes if n is None)} bundle(s)",
                pg_id=rec.pg_id)
            self._gcs.flight.record(
                "pg.repair",
                f"pg {rec.pg_id[:8]} gang lost node {node_id[:8]}; "
                f"re-reserving "
                f"{sum(1 for n in rec.nodes if n is None)} bundle(s)",
                node_id=node_id, severity="WARNING",
                fields={"pg_id": rec.pg_id})
            if was_created:
                self._wake_waiters(rec.pg_id)
            self._pending.put_nowait(rec.pg_id)

    def on_job_finished(self, job_id: str) -> None:
        for rec in list(self.groups.values()):
            if (not rec.detached and rec.owner_job == job_id
                    and rec.state != PG_REMOVED):
                asyncio.ensure_future(self.remove_pg(rec.pg_id))

    async def scheduling_loop(self):
        while True:
            pg_id = await self._pending.get()
            rec = self.groups.get(pg_id)
            if rec is None or rec.state != PG_PENDING:
                continue
            ok = await self._try_reserve(rec)
            if not ok and rec.state == PG_PENDING:
                async def requeue(pid=pg_id):
                    await asyncio.sleep(0.5)
                    await self._pending.put(pid)

                asyncio.ensure_future(requeue())

    async def _return_bundles(self, pg_id: str,
                              reserved: List[Tuple[str, int]]) -> None:
        for rnid, ridx in reserved:
            rclient = self._gcs.daemon_client(rnid)
            if rclient is not None:
                try:
                    await rclient.call("NodeDaemon", "return_pg_bundle",
                                       pg_id=pg_id, bundle_idx=ridx,
                                       timeout=10)
                except Exception:  # noqa: BLE001
                    pass

    async def _call_bundle(self, nid: str, method: str, **kwargs) -> bool:
        client = self._gcs.daemon_client(nid)
        if client is None:
            return False
        try:
            reply = await client.call("NodeDaemon", method,
                                      timeout=10, **kwargs)
            return bool(reply.get("ok", False))
        except Exception:  # noqa: BLE001
            return False

    async def _try_reserve(self, rec: PgRecord) -> bool:
        """Two-phase atomic gang reserve (ref:
        gcs_placement_group_scheduler.h:274 PREPARE then COMMIT).

        All missing bundles are PREPAREd concurrently; any failure rolls
        back every bundle prepared this round, so a half-placed gang
        never leaks (daemon-side prepare TTLs backstop a GCS crash
        between phases). Only after every prepare lands does COMMIT make
        the bundles usable — and trigger the per-bundle worker prewarm.
        Bundles already placed from a previous round (`rec.nodes`
        non-None entries — gang repair after a node death) are kept, not
        re-reserved."""
        nodes_snapshot = list(rec.nodes)
        preplaced: List[Optional[str]] = (
            list(rec.nodes) if len(rec.nodes) == len(rec.bundles)
            else [None] * len(rec.bundles))
        placement = place_bundles(self._gcs.nodes.view, rec.bundles,
                                  rec.strategy, preplaced=preplaced,
                                  bundle_labels=rec.bundle_labels)
        if placement is None:
            return False
        new_idxs = [i for i, pre in enumerate(preplaced) if pre is None]
        if new_idxs:
            prepared = await asyncio.gather(*[
                self._call_bundle(placement[i], "reserve_pg_bundle",
                                  pg_id=rec.pg_id, bundle_idx=i,
                                  resources=rec.bundles[i])
                for i in new_idxs])
            this_round = [(placement[i], i)
                          for i, ok in zip(new_idxs, prepared) if ok]
            if not all(prepared):
                await self._return_bundles(rec.pg_id, this_round)
                return False
            committed = await asyncio.gather(*[
                self._call_bundle(placement[i], "commit_pg_bundle",
                                  pg_id=rec.pg_id, bundle_idx=i)
                for i in new_idxs])
            if not all(committed):
                # A daemon died (or expired the prepare) between the
                # phases: the gang is not whole — release this round
                # and retry from the survivors.
                await self._return_bundles(rec.pg_id, this_round)
                return False
        if rec.state == PG_REMOVED:
            # remove_pg ran while we were reserving: it returned the
            # bundles it knew of (rec.nodes at the time), not this
            # round's — release those here.
            await self._return_bundles(
                rec.pg_id, [(placement[i], i) for i in new_idxs])
            return True
        if list(rec.nodes) != nodes_snapshot:
            # on_node_dead punched holes mid-reserve: committing
            # `placement` would resurrect a dead node's bundle. Release
            # this round and re-place against the updated holes.
            await self._return_bundles(
                rec.pg_id, [(placement[i], i) for i in new_idxs])
            return False
        rec.nodes = placement
        rec.state = PG_CREATED
        self._persist(rec)
        self._gcs.event_log.emit(
            "placement_group", "INFO",
            f"pg {rec.pg_id[:8]} gang committed "
            f"({len(new_idxs)}/{len(rec.bundles)} bundles new)",
            pg_id=rec.pg_id)
        if new_idxs:
            self._gcs.flight.record(
                "pg.commit",
                f"pg {rec.pg_id[:8]} gang committed "
                f"({len(new_idxs)}/{len(rec.bundles)} bundles new)",
                fields={"pg_id": rec.pg_id, "nodes": list(placement)})
        self._gcs.pubsub.publish("pg", {"pg_id": rec.pg_id,
                                        "state": PG_CREATED,
                                        "nodes": placement})
        self._wake_waiters(rec.pg_id)
        return True


class JobManager:
    """Driver/job registry (ref: gcs_job_manager.h)."""

    def __init__(self, gcs: "GcsServer", store=None):
        from ray_tpu_torch.core.distributed.gcs_storage import NullStore

        self._gcs = gcs
        self._store = store or NullStore()
        self.jobs: Dict[str, dict] = dict(self._store.all("job"))

    def register_job(self, job_id: str, driver_address: str,
                     metadata: Optional[dict] = None,
                     runtime: Optional[str] = None) -> dict:
        if runtime != RUNTIME:
            raise RuntimeError(
                f"this head runs {RUNTIME}: a driver of another runtime "
                f"cannot join it")
        self.jobs[job_id] = {
            "job_id": job_id, "driver_address": driver_address,
            "start_time": time.time(), "finished": False,
            "metadata": metadata or {},
        }
        self._store.put("job", job_id, self.jobs[job_id])
        return {"ok": True}

    def finish_job(self, job_id: str) -> dict:
        job = self.jobs.get(job_id)
        if job is not None:
            job["finished"] = True
            job["end_time"] = time.time()
            self._store.put("job", job_id, job)
        self._gcs.actors.on_job_finished(job_id)
        self._gcs.placement_groups.on_job_finished(job_id)
        self._gcs.task_events.on_job_finished(job_id)
        return {"ok": True}

    def list_jobs(self) -> List[dict]:
        return list(self.jobs.values())


class EventLog:
    """Structured cluster event log (ref: src/ray/util/event.h RAY_EVENT
    macros + the dashboard event module): node/actor/PG lifecycle events
    with severity, queryable via `ray-tpu list events` and the dashboard.
    """

    # Decision sources whose events arrive over RPC (the elastic
    # supervisor's resize decisions, autoscaler verdicts) and must also
    # land in the durable flight recorder — their direct emitters live
    # outside the GCS process, so the mirror is the one hook point.
    MIRRORED_SOURCES = ("elastic", "autoscaler")

    def __init__(self, max_events: int = 20000):
        self.events: deque = deque(maxlen=max_events)
        self.flight: Optional["FlightRecorder"] = None  # set by GcsServer

    def emit(self, source: str, severity: str, message: str,
             **fields) -> dict:
        self.events.append({
            "ts": time.time(), "source": source,
            "severity": severity, "message": message, **fields,
        })
        if self.flight is not None and source in self.MIRRORED_SOURCES:
            self.flight.record(source, message, severity=severity,
                               fields=fields or None)
        return {"ok": True}

    def add_event(self, source: str, severity: str, message: str,
                  fields: Optional[dict] = None) -> dict:
        # Reserved keys would collide with emit()'s own parameters (a
        # caller 'message'/'ts' must not TypeError or clobber the
        # timestamp); namespace them.
        clean = {(f"field_{k}" if k in ("source", "severity", "message",
                                        "ts", "self") else k): v
                 for k, v in (fields or {}).items()}
        return self.emit(source, severity, message, **clean)

    def list_events(self, source: Optional[str] = None,
                    severity: Optional[str] = None,
                    limit: int = 1000) -> List[dict]:
        out = []
        for e in reversed(self.events):
            if source is not None and e["source"] != source:
                continue
            if severity is not None and e["severity"] != severity:
                continue
            out.append(e)
            if len(out) >= limit:
                break
        return out


class FlightRecorder:
    """Cluster flight recorder: a bounded, PersistentStore-durable
    journal of state transitions that previously vanished into logs —
    node join/death/re-registration, controller/proxy failover, drain +
    KV migration, autoscale and elastic resize decisions, PG repair.
    Queryable by time/kind/node via `state.cluster_events()` /
    `ray-tpu events`, and it survives a GCS restart: entries are
    persisted to the same store that backs KV/actors/PGs, so the
    post-recovery journal still explains how the cluster got here.

    The on-loop cost of ``record()`` is a deque append plus an executor
    handoff; the fsyncing store write always runs OFF the GCS loop
    (pinned by the lint suite's `no-blocking-in-loop` journal registry).
    """

    _RESERVED = ("seq", "ts", "kind", "severity", "message", "node_id",
                 "self")

    def __init__(self, gcs: "GcsServer", store=None):
        from ray_tpu_torch.core.distributed.gcs_storage import NullStore

        cfg = get_config()
        self._gcs = gcs
        self._store = store or NullStore()
        self._enabled = cfg.gcs_flight_recorder_enabled
        self._max = max(16, cfg.gcs_flight_max_events)
        self.events: deque = deque()
        self._seq = 0
        # Boot-load the journal the last GCS incarnation left behind
        # (constructor runs before the server accepts RPCs, so blocking
        # store reads are fine here — same as the KV table load).
        for seq, entry in sorted(self._store.all("flight").items()):
            self.events.append(entry)
            try:
                self._seq = max(self._seq, int(seq))
            except (TypeError, ValueError):
                pass
        while len(self.events) > self._max:
            evicted = self.events.popleft()
            self._store.delete("flight", evicted.get("seq"))

    def record(self, kind: str, message: str,
               node_id: Optional[str] = None, severity: str = "INFO",
               fields: Optional[dict] = None) -> dict:
        """Journal one state transition (also the RPC entry point, so
        out-of-process components can journal through the GCS)."""
        if not self._enabled:
            return {"ok": False, "disabled": True}
        clean = {(f"field_{k}" if k in self._RESERVED else k): v
                 for k, v in (fields or {}).items()}
        self._seq += 1
        entry = {"seq": self._seq, "ts": time.time(), "kind": kind,
                 "severity": severity, "message": message,
                 "node_id": node_id, **clean}
        self.events.append(entry)
        evict = self.events.popleft() if len(self.events) > self._max \
            else None
        self._schedule_persist(entry, evict)
        return {"ok": True, "seq": self._seq}

    def _schedule_persist(self, entry: dict, evict: Optional[dict]
                          ) -> None:
        # The store write fsyncs under a lock — never on the GCS loop.
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # No running loop (unit tests, boot): synchronous is safe.
            self._persist(entry, evict)
            return
        loop.run_in_executor(None, self._persist, entry, evict)

    def _persist(self, entry: dict, evict: Optional[dict]) -> None:
        try:
            self._store.put("flight", entry["seq"], entry)
            if evict is not None:
                self._store.delete("flight", evict.get("seq"))
        except Exception:  # noqa: BLE001 — journal is best-effort
            pass

    def list_events(self, kind: Optional[str] = None,
                    node_id: Optional[str] = None,
                    since: Optional[float] = None,
                    until: Optional[float] = None,
                    limit: int = 200) -> List[dict]:
        """Newest-first scan with time/kind/node filters; the result is
        returned oldest-first (a readable timeline)."""
        out: List[dict] = []
        for e in reversed(self.events):
            if since is not None and e["ts"] < since:
                break  # deque is time-ordered; the rest is older still
            if until is not None and e["ts"] > until:
                continue
            if kind is not None and not e["kind"].startswith(kind):
                continue
            if node_id is not None and e.get("node_id") != node_id:
                continue
            out.append(e)
            if len(out) >= limit:
                break
        out.reverse()
        return out

    def kinds(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for e in self.events:
            counts[e["kind"]] = counts.get(e["kind"], 0) + 1
        return counts

    def stats(self) -> dict:
        return {"enabled": self._enabled, "events": len(self.events),
                "seq": self._seq, "max_events": self._max,
                "kinds": self.kinds(),
                "durable": type(self._store).__name__ != "NullStore"}


def _arg_digest(value: Any) -> str:
    """Compact, bounded description of one handler argument for the
    slow-handler audit — sizes for payloads, truncated reprs for the
    rest (never the full value: a 10 MB blob must not become a 10 MB
    log line)."""
    if isinstance(value, (bytes, bytearray, memoryview)):
        return f"bytes[{len(value)}]"
    if isinstance(value, (list, tuple, set)):
        return f"{type(value).__name__}[{len(value)}]"
    if isinstance(value, dict):
        return f"dict[{len(value)}]"
    text = repr(value)
    return text if len(text) <= 48 else text[:45] + "..."


class GcsLoadAttribution:
    """GCS load attribution (tentpole of the measure-then-shard arc):
    every handled RPC is accounted per (service, caller component) —
    requests, bytes in, handler wall time — via the RpcServer
    attribution sink, with caller identity riding the reserved
    `_caller` kwarg rpc.py injects client-side. `shares()` turns the
    raw accumulators into the per-service x per-component load shares
    `ray-tpu gcs top` renders and the sharding PR will cite.

    Also the slow-handler audit: any handler exceeding
    RAY_TPU_GCS_SLOW_HANDLER_MS is logged with method + caller + a
    bounded args digest (built lazily — fast handlers never pay for
    repr) and kept in a small recent-ring for `ray-tpu doctor`."""

    SLOW_KEEP = 32

    def __init__(self, gcs: "GcsServer"):
        cfg = get_config()
        self._gcs = gcs
        self._t0 = time.time()
        # (service, component) -> [requests, bytes, handler_seconds]
        self._by: Dict[Tuple[str, str], List[float]] = {}
        self._slow_budget_s = max(0.0, cfg.gcs_slow_handler_ms) / 1000.0
        self.slow_total = 0
        self._slow_recent: deque = deque(maxlen=self.SLOW_KEEP)

    def sink(self, attr: tuple, seconds: float, kwargs: dict,
             stream: bool = False) -> None:
        """Installed as RpcServer.attribution_sink — one dict upsert
        per handled RPC is the entire on-loop cost of attribution.
        A stream's `seconds` is its open lifetime (await-time, not
        loop occupancy): count the request and bytes, skip the time
        accumulators and the slow-handler audit."""
        service, method, caller, nbytes = attr
        component = caller[1] if caller else "unknown"
        slot = self._by.get((service, component))
        if slot is None:
            slot = self._by[(service, component)] = [0, 0, 0.0]
        slot[0] += 1
        slot[1] += nbytes
        if stream:
            return
        slot[2] += seconds
        if self._slow_budget_s and seconds >= self._slow_budget_s:
            self._record_slow(service, method, caller, seconds, kwargs)

    def _record_slow(self, service: str, method: str,
                     caller: Optional[tuple], seconds: float,
                     kwargs: dict) -> None:
        digest = ", ".join(f"{k}={_arg_digest(v)}"
                           for k, v in list(kwargs.items())[:8])
        who = f"{caller[1]}@{caller[0][:8]}" if caller else "unknown"
        entry = {"ts": time.time(), "service": service, "method": method,
                 "caller": list(caller) if caller else None,
                 "wall_ms": round(seconds * 1000.0, 3), "args": digest}
        self.slow_total += 1
        self._slow_recent.append(entry)
        logger.warning(
            "slow GCS handler %s.%s: %.1fms (budget %.0fms) caller=%s "
            "args=[%s]", service, method, seconds * 1000.0,
            self._slow_budget_s * 1000.0, who, digest)
        self._gcs.event_log.emit(
            "gcs", "WARNING",
            f"slow handler {service}.{method}: "
            f"{seconds * 1000.0:.1f}ms (caller {who})",
            service=service, method=method, wall_ms=entry["wall_ms"])

    def shares(self) -> dict:
        """Per-service x per-component request/bytes/handler-time load
        shares since GCS boot, plus the per-component handler-time
        rollup the doctor's top finding quotes."""
        total_req, total_bytes, total_s = 0, 0, 0.0
        for reqs, nbytes, secs in self._by.values():
            total_req += reqs
            total_bytes += nbytes
            total_s += secs
        rows = []
        for (service, component), (reqs, nbytes, secs) in sorted(
                self._by.items(), key=lambda kv: -kv[1][2]):
            rows.append({
                "service": service, "component": component,
                "requests": reqs, "bytes": nbytes,
                "handler_s": round(secs, 6),
                "requests_share": round(reqs / total_req, 4)
                if total_req else 0.0,
                "bytes_share": round(nbytes / total_bytes, 4)
                if total_bytes else 0.0,
                "handler_share": round(secs / total_s, 4)
                if total_s else 0.0,
            })
        by_comp: Dict[str, float] = {}
        for (_service, component), (_r, _b, secs) in self._by.items():
            by_comp[component] = by_comp.get(component, 0.0) + secs
        comp_shares = {c: (round(s / total_s, 4) if total_s else 0.0)
                       for c, s in sorted(by_comp.items(),
                                          key=lambda kv: -kv[1])}
        return {
            "window_s": round(time.time() - self._t0, 1),
            "total": {"requests": total_req, "bytes": total_bytes,
                      "handler_s": round(total_s, 6)},
            "rows": rows,
            "component_handler_share": comp_shares,
            "slow_handlers": {
                "total": self.slow_total,
                "budget_ms": round(self._slow_budget_s * 1000.0, 1),
                "recent": list(self._slow_recent),
            },
        }


class MetricsFederation:
    """Cluster-wide metrics view (the analogue of Prometheus federation
    over the reference's per-node metrics agents): nodes piggyback
    registry snapshots on their syncer pushes; this manager merges them
    — each sample gaining a `node` label — into one exposition served
    over RPC (`Metrics.federated_text`) and, with
    RAY_TPU_METRICS_GCS_EXPORT_PORT set, over HTTP on the GCS."""

    def __init__(self, gcs: "GcsServer"):
        self._gcs = gcs
        # node_id -> {"ts": wall time received, "dump": registry_dump()}
        self._node_dumps: Dict[str, dict] = {}

    def ingest(self, node_id: str, dump: List[dict]) -> None:
        self._node_dumps[node_id] = {"ts": time.time(), "dump": dump}

    def on_node_dead(self, node_id: str) -> None:
        self._node_dumps.pop(node_id, None)

    def federated_text(self) -> str:
        from ray_tpu_torch.util.metrics import merge_dumps, registry_dump

        dumps = {nid[:12]: rec["dump"]
                 for nid, rec in self._node_dumps.items()}
        # The GCS's own process metrics (RPC handler histograms,
        # event-loop lag/backlog, KV + flight-journal sizes) ride the
        # same exposition, labelled with the GCS's node identity so
        # multi-cluster scrapes stay distinguishable.
        dumps[f"gcs:{self._gcs.node_id[:12]}"] = registry_dump()
        return merge_dumps(dumps)

    def stats(self) -> dict:
        now = time.time()
        return {
            "nodes_reporting": len(self._node_dumps),
            "staleness_s": {nid[:12]: round(now - rec["ts"], 3)
                            for nid, rec in self._node_dumps.items()},
        }

    def cluster_summary(self) -> dict:
        """One-RPC observability rollup for `ray-tpu status` /
        state.cluster_status callers: federation freshness, task-event
        completeness accounting, and the watchdog's live hung-task
        list."""
        return {
            "metrics": self.stats(),
            "task_events": self._gcs.task_events.stats(),
            "hung_tasks": self._gcs.task_events.hung_tasks(),
            "serve": self._gcs.serve_gauges.summary(),
            "train": self._gcs.train_runs.summary(),
            "gcs": self.gcs_load(),
        }

    def gcs_load(self) -> dict:
        """Control-plane self-observability blob: attribution shares,
        the event-loop audit, and flight-journal stats — served both
        standalone (`ray-tpu gcs top`) and inside cluster_summary."""
        return {
            "node_id": self._gcs.node_id,
            "load": self._gcs.attribution.shares(),
            "loop": dict(self._gcs.loop_audit),
            "flight": self._gcs.flight.stats(),
        }

    # -- doctor ---------------------------------------------------------
    #
    # Heuristic thresholds (share of GCS handler time worth flagging,
    # loop lag, recent-death window) — tuned to flag real saturation
    # without firing on an idle two-node cluster.
    DOCTOR_SHARE_WARN = 0.35
    DOCTOR_MIN_HANDLER_S = 0.05
    DOCTOR_LAG_WARN_S = 0.25
    DOCTOR_DEATH_WINDOW_S = 600.0
    # Train-plane findings: share of attributed step time spent waiting
    # on input before a run is called input-bound, the p99/p50 step-time
    # ratio that flags a straggler rank, the goodput floor under restart
    # churn, and how recently a run must have reported to be examined.
    DOCTOR_TRAIN_INPUT_SHARE = 0.25
    DOCTOR_TRAIN_SKEW = 1.5
    DOCTOR_TRAIN_GOODPUT = 0.5
    DOCTOR_TRAIN_WINDOW_S = 600.0
    DOCTOR_TRAIN_MIN_ATTRIBUTED_S = 0.5

    _SHARE_HINTS = {
        "syncer": "raise RAY_TPU_METRICS_SYNC_INTERVAL_MS",
        "task-events": "raise RAY_TPU_TASK_EVENTS_FLUSH_MS or lower "
                       "RAY_TPU_TASK_EVENTS_MAX_BUFFER",
        "scheduler": "check heartbeat cadence / lease churn "
                     "(RAY_TPU_HEALTH_CHECK_PERIOD_MS)",
        "client": "batch driver-side GCS reads",
    }

    def doctor(self) -> dict:
        """One fused health report: federated metrics freshness, hung
        tasks, task-event drop/eviction counters, GCS load shares, the
        event-loop audit, and recent flight-recorder entries — ranked
        findings, highest score first, each with an actionable hint."""
        gcs = self._gcs
        now = time.time()
        findings: List[dict] = []

        def add(kind: str, severity: str, score: float, message: str,
                hint: str, **extra) -> None:
            findings.append({"kind": kind, "severity": severity,
                             "score": round(score, 1),
                             "message": message, "hint": hint, **extra})

        load = gcs.attribution.shares()
        total_s = load["total"]["handler_s"]
        for comp, share in load["component_handler_share"].items():
            if (comp != "unknown" and share >= self.DOCTOR_SHARE_WARN
                    and total_s >= self.DOCTOR_MIN_HANDLER_S):
                add("gcs-load", "warning", 40 + share * 55,
                    f"component '{comp}' is {share:.0%} of GCS handler "
                    f"time ({total_s:.2f}s total)",
                    self._SHARE_HINTS.get(
                        comp, "profile this component's GCS call sites"),
                    component=comp, share=share)
        slow = load["slow_handlers"]
        if slow["total"]:
            worst = max(slow["recent"], key=lambda e: e["wall_ms"],
                        default=None)
            add("gcs-slow-handler", "warning",
                45 + min(20.0, slow["total"]),
                f"{slow['total']} GCS handler(s) exceeded the "
                f"{slow['budget_ms']:.0f}ms budget"
                + (f" (worst: {worst['service']}.{worst['method']} "
                   f"{worst['wall_ms']:.0f}ms)" if worst else ""),
                "inspect the slow-handler log lines; raise "
                "RAY_TPU_GCS_SLOW_HANDLER_MS only if expected",
                recent=slow["recent"][-3:])
        lag = gcs.loop_audit.get("lag_max_s", 0.0)
        if lag >= self.DOCTOR_LAG_WARN_S:
            add("gcs-loop-lag",
                "critical" if lag >= 4 * self.DOCTOR_LAG_WARN_S
                else "warning", 60 + min(30.0, lag * 10),
                f"GCS event loop lagged up to {lag * 1000:.0f}ms",
                "a handler or import is blocking the loop; check the "
                "slow-handler audit and gcs-load shares", lag_s=lag)
        hung = gcs.task_events.hung_tasks(limit=10)
        if hung:
            oldest = min(h.get("hung_ts") or now for h in hung)
            add("hung-tasks", "critical", 85 + min(10.0, len(hung)),
                f"{len(hung)} task(s) flagged hung "
                f"(oldest {now - oldest:.0f}s ago)",
                "`ray-tpu stack <node>` for live tracebacks; see "
                "attached auto-captured dumps", tasks=hung[:5])
        te = gcs.task_events.stats()
        dropped = (te.get("worker_dropped_status", 0)
                   + te.get("worker_dropped_profile", 0))
        evicted = te.get("evicted", 0)
        if dropped or evicted:
            add("task-event-loss", "info",
                20 + min(20.0, (dropped + evicted) / 1000),
                f"task-event telemetry is incomplete: {dropped} dropped "
                f"worker-side, {evicted} evicted by the GCS cap",
                "raise RAY_TPU_TASK_EVENTS_MAX_BUFFER / "
                "RAY_TPU_TASK_EVENTS_MAX_PER_JOB if completeness "
                "matters", dropped=dropped, evicted=evicted)
        deaths = [e for e in gcs.flight.list_events(kind="node.death",
                                                    limit=50)
                  if now - e["ts"] <= self.DOCTOR_DEATH_WINDOW_S]
        if deaths:
            add("node-churn", "warning", 70 + min(15.0, len(deaths) * 3),
                f"{len(deaths)} node death(s) in the last "
                f"{self.DOCTOR_DEATH_WINDOW_S / 60:.0f}min "
                f"(latest: {deaths[-1]['message']})",
                "`ray-tpu events --kind node` for the timeline; check "
                "host health / preemptions",
                nodes=[e.get("node_id") for e in deaths[-5:]])
        cfg = get_config()
        stale_after = max(3 * cfg.metrics_sync_interval_ms / 1000.0, 10.0)
        stale = {nid: s for nid, s in self.stats()["staleness_s"].items()
                 if s > stale_after}
        if stale:
            add("stale-metrics", "warning", 55 + min(15.0, len(stale) * 3),
                f"{len(stale)} node(s) have not shipped metrics for "
                f">{stale_after:.0f}s: {sorted(stale)[:5]}",
                "their syncer pushes are stalling — check daemon health",
                nodes=stale)
        for run, s in gcs.train_runs.summary()["runs"].items():
            if s["last_seen_age_s"] > self.DOCTOR_TRAIN_WINDOW_S:
                continue
            attributed = sum(v for k, v in s["attributed_s"].items()
                             if k != "step_s")
            split, skew = s["split"], s["skew"]
            if (split and attributed >= self.DOCTOR_TRAIN_MIN_ATTRIBUTED_S
                    and split["data_wait"] >= self.DOCTOR_TRAIN_INPUT_SHARE):
                add("train-input-bound", "warning",
                    50 + split["data_wait"] * 40,
                    f"train run '{run}' is input-bound: "
                    f"{split['data_wait']:.0%} of step time waiting on "
                    f"the input pipeline",
                    "raise the ingest prefetch depth "
                    "(RAY_TPU_DATA_STREAM_PREFETCH_DEPTH) or dataset "
                    "read parallelism; `ray-tpu train trace` shows the "
                    "per-step data_wait slices", run=run,
                    data_wait_share=split["data_wait"])
            stale = skew.get("stale_ranks")
            # Straggler verdicts only make sense while the run is live:
            # a finished run's ranks all go quiet, which is not a
            # straggler — the other findings describe cumulative facts
            # and stay useful for the whole recency window.
            if s["active"] and (stale or skew.get("ratio", 0.0)
                                >= self.DOCTOR_TRAIN_SKEW):
                blame = skew.get("blame_rank")
                why = (f"rank(s) {stale} stopped reporting "
                       f"(SIGSTOP/livelock?)" if stale else
                       f"p99/p50 step time = {skew['ratio']:.2f}")
                add("train-straggler",
                    "critical" if stale else "warning",
                    65 + (20 if stale else min(15.0, skew.get("ratio", 0))),
                    f"train run '{run}' has a persistent straggler: "
                    f"rank {blame} ({why})",
                    "`ray-tpu stack <node>` the blamed rank's host; a "
                    "stopped rank is replaced by the elastic supervisor "
                    "once RAY_TPU_HANG_THRESHOLD_S expires",
                    run=run, blame_rank=blame, skew=skew)
            if (s["restarts"] >= 1 and s["goodput"] is not None
                    and s["goodput"] < self.DOCTOR_TRAIN_GOODPUT):
                add("train-churn-goodput", "warning",
                    55 + min(25.0, s["restarts"] * 5),
                    f"train run '{run}' goodput is {s['goodput']:.0%} "
                    f"after {s['restarts']} restart(s) "
                    f"({s['lost_restart_s']:.0f}s lost to restart gaps)",
                    "check `ray-tpu list events --source elastic` for "
                    "the causes; longer-lived checkpoints shrink the "
                    "replay, RAY_TPU_ELASTIC_BACKOFF_* shrinks the gap",
                    run=run, goodput=s["goodput"],
                    restarts=s["restarts"])
        findings.sort(key=lambda f: -f["score"])
        return {"ts": now, "healthy": not findings,
                "findings": findings,
                "checks": ["gcs-load", "gcs-slow-handler", "gcs-loop-lag",
                           "hung-tasks", "task-event-loss", "node-churn",
                           "stale-metrics", "train-input-bound",
                           "train-straggler", "train-churn-goodput"]}


class ServeGauges:
    """Cluster-merged serve replica gauges (the autoscaling read side of
    the syncer plane): replicas push gauges to their node daemon, the
    daemon's `serve` state key rides its syncer delta here, and the
    serve controller reads ONE merged per-app view per reconcile tick —
    no per-decision replica polling."""

    def __init__(self, gcs: "GcsServer"):
        self._gcs = gcs

    def merged(self) -> Dict[str, dict]:
        """Fold every alive node's per-app aggregate into a cluster-wide
        per-app aggregate (sums of replicas / queue_depth / active;
        occupancy stays a sum too — the controller divides by replicas
        for a mean)."""
        out: Dict[str, Dict[str, Any]] = {}
        for n in self._gcs.nodes.view.alive_nodes():
            for app, agg in (getattr(n, "serve", None) or {}).items():
                dst = out.setdefault(app, {})
                for name, val in agg.items():
                    # Per-replica disagg state (role + prefix digests)
                    # is a union across nodes, not a sum.
                    if name == "_replicas" and isinstance(val, dict):
                        dst.setdefault("_replicas", {}).update(val)
                        continue
                    try:
                        dst[name] = round(dst.get(name, 0.0) + float(val),
                                          3)
                    except (TypeError, ValueError):
                        continue
        return out

    def summary(self) -> dict:
        """`ray-tpu serve status` / cluster_status()["observability"]
        ["serve"] payload: the merged autoscaling gauges plus a
        latency/counter rollup mined from the federated serve metrics —
        per-app TTFT/ITL means, per-phase means (queue_wait / prefill /
        decode_step / stream_transport), and the serve counter totals
        (tokens, requests by status, KV events, sheds, resumes)."""
        lat: Dict[str, dict] = {}
        counters: Dict[str, Dict[str, float]] = {}
        for holder in self._gcs.metrics._node_dumps.values():
            for rec in holder["dump"]:
                name = rec.get("name", "")
                if not name.startswith("raytpu_serve_"):
                    continue
                short = name[len("raytpu_serve_"):]
                if rec.get("kind") == "histogram":
                    for key, _buckets, hsum, total in rec.get("hist", []):
                        tags = dict(map(tuple, key))
                        ent = lat.setdefault(tags.get("app", "-"), {})
                        if name == "raytpu_serve_phase_seconds":
                            slot = ent.setdefault("phases", {}).setdefault(
                                tags.get("phase", "?"), [0.0, 0])
                        elif name == "raytpu_serve_ttft_seconds":
                            slot = ent.setdefault("ttft", [0.0, 0])
                        elif name == "raytpu_serve_itl_seconds":
                            slot = ent.setdefault("itl", [0.0, 0])
                        else:
                            continue
                        slot[0] += hsum
                        slot[1] += total
                elif rec.get("kind") == "counter":
                    for key, value in rec.get("samples", []):
                        tags = dict(map(tuple, key))
                        dst = counters.setdefault(tags.get("app", "-"), {})
                        sub = tags.get("event") or tags.get("status")
                        k = f"{short}.{sub}" if sub else short
                        dst[k] = round(dst.get(k, 0.0) + float(value), 3)
        latency: Dict[str, dict] = {}
        for app, ent in lat.items():
            row: Dict[str, Any] = {}
            for field, label in (("ttft", "ttft_mean_s"),
                                 ("itl", "itl_mean_s")):
                s, c = ent.get(field, (0.0, 0))
                if c:
                    row[label] = round(s / c, 6)
            phases = {p: round(s / c, 6)
                      for p, (s, c) in ent.get("phases", {}).items() if c}
            if phases:
                row["phase_mean_s"] = phases
            if row:
                latency[app] = row
        return {"apps": self.merged(), "latency": latency,
                "counters": counters}


class TrainRunState:
    """Train-plane goodput aggregator (the read side of the train gauge
    federation): ranks push cumulative step/phase counters to their
    node daemons, the daemons' `train` state key rides syncer deltas
    here, and this manager folds them — per run — into a goodput split
    (productive compute vs data-stall vs sync-stall vs checkpoint vs
    lost-to-restart), a cross-rank skew window (p99/p50 step time,
    blame-rank attribution), and an optional MFU estimate from
    `ScalingConfig.flops_per_step`.

    Unlike ServeGauges this view is RETAINED: daemon-side gauges are
    TTL-swept, but a gang restart must not erase the dead attempt's
    accounting and a SIGSTOPped rank must stay attributable after it
    goes quiet — so every (rank, attempt) entry the syncer ever showed
    us is kept until the run itself is pruned."""

    # A rank whose last daemon push is older than this is stale: it
    # stopped making progress without dying (SIGSTOP, livelock) and
    # becomes the skew blame rank regardless of its last step window.
    STALE_RANK_S = 5.0
    # A run with no gauge traffic for this long is no longer "active"
    # (status lines, doctor); it stays queryable until pruned.
    ACTIVE_WINDOW_S = 15.0
    MAX_RUNS = 64

    def __init__(self, gcs: "GcsServer"):
        self._gcs = gcs
        # run -> {"ranks": {"rank@attempt": {"g": gauges, "seen_ts"}},
        #         "first_seen", "last_seen"}
        self._runs: Dict[str, dict] = {}

    # -- ingest ----------------------------------------------------------

    def refresh(self) -> None:
        """Fold every alive node's synced `train` state into the
        retained per-run view (latest push per (rank, attempt) wins —
        steps are cumulative, so the bigger counter is newer)."""
        now = time.time()
        for n in self._gcs.nodes.view.alive_nodes():
            for run, ranks in (getattr(n, "train", None) or {}).items():
                ent = self._runs.setdefault(
                    run, {"ranks": {}, "first_seen": now, "last_seen": now})
                for key, g in (ranks or {}).items():
                    prev = ent["ranks"].get(key)
                    if (prev is not None
                            and g.get("steps", 0) < prev["g"].get("steps", 0)):
                        continue
                    seen = now - float(g.get("ts_age_s", 0.0) or 0.0)
                    ent["ranks"][key] = {"g": dict(g), "seen_ts": seen}
                    ent["last_seen"] = max(ent["last_seen"], seen)
        if len(self._runs) > self.MAX_RUNS:
            for run, _ in sorted(self._runs.items(),
                                 key=lambda kv: kv[1]["last_seen"])[
                                     :len(self._runs) - self.MAX_RUNS]:
                del self._runs[run]

    def _restart_events(self, run: str) -> List[dict]:
        return [e for e in self._gcs.event_log.list_events(source="train")
                if e.get("run") == run]

    # -- derivation ------------------------------------------------------

    def _summarize(self, run: str, ent: dict) -> dict:
        from ray_tpu_torch.util.metrics import percentile

        now = time.time()
        ranks = ent["ranks"]
        # Cumulative attribution across every attempt ever seen.
        tot = {k: 0.0 for k in ("step_s", "data_wait_s", "compute_s",
                                "sync_s", "checkpoint_s", "other_s")}
        latest_attempt = max((r["g"].get("attempt", 0)
                              for r in ranks.values()), default=0)
        cur: Dict[int, dict] = {}
        for r in ranks.values():
            g = r["g"]
            for k in tot:
                tot[k] += float(g.get(k, 0.0) or 0.0)
            if g.get("attempt", 0) == latest_attempt:
                cur[int(g.get("rank", 0))] = r
        # Restart accounting: each gang-start event's gap stalled the
        # WHOLE gang, so the lost wall is gap * world — comparable to
        # the per-rank attributed sums it joins in the denominator.
        events = self._restart_events(run)
        restarts = sum(1 for e in events if e.get("gap_s", 0.0) > 0.0)
        lost_s = sum(float(e.get("gap_s", 0.0) or 0.0)
                     * max(1, int(e.get("world", 1) or 1)) for e in events)
        attributed = sum(tot.values()) - tot["step_s"]  # phases only
        denom = attributed + lost_s
        productive = tot["compute_s"] + tot["other_s"]
        split = {}
        goodput = None
        if denom > 0:
            split = {
                "compute": round(productive / denom, 4),
                "data_wait": round(tot["data_wait_s"] / denom, 4),
                "sync": round(tot["sync_s"] / denom, 4),
                "checkpoint": round(tot["checkpoint_s"] / denom, 4),
                "lost_restart": round(lost_s / denom, 4),
            }
            goodput = split["compute"]
        # Current-attempt step rate + cross-rank skew over the recent
        # step window. Lockstep data-parallel runs move at the slowest
        # rank's pace, so the run rate is the min across ranks.
        rates, window_means, stale_ranks = [], {}, []
        world = steps = 0
        run_id = None
        for rank, r in sorted(cur.items()):
            g = r["g"]
            run_id = g.get("run_id") or run_id
            world = max(world, int(g.get("world", 0) or 0))
            steps = max(steps, int(g.get("steps", 0) or 0))
            ws, wt = g.get("window_steps", 0), g.get("window_step_s", 0.0)
            if ws and wt:
                rates.append(ws / wt)
                window_means[rank] = wt / ws
            # A rank whose loop returned went quiet by design (its last
            # push says so): not a straggler.
            if now - r["seen_ts"] > self.STALE_RANK_S and not g.get("finished"):
                stale_ranks.append(rank)
        step_rate = round(min(rates), 4) if rates else 0.0
        skew: Dict[str, Any] = {}
        if window_means:
            vals = list(window_means.values())
            p50 = percentile(vals, 50)
            p99 = percentile(vals, 99)
            blame = max(window_means, key=window_means.get)
            skew = {"p50_step_s": round(p50, 6),
                    "p99_step_s": round(p99, 6),
                    "ratio": round(p99 / p50, 3) if p50 > 0 else 0.0,
                    "blame_rank": blame}
        if stale_ranks:
            # A stopped rank cannot report a slow window — staleness IS
            # the straggler signal, and the stalest rank takes the blame.
            skew["stale_ranks"] = sorted(stale_ranks)
            skew["blame_rank"] = min(
                ((rank, cur[rank]["seen_ts"]) for rank in stale_ranks),
                key=lambda kv: kv[1])[0]
        out = {
            "run": run, "run_id": run_id, "attempt": latest_attempt,
            "world": world, "steps": steps,
            "active": (now - ent["last_seen"]) <= self.ACTIVE_WINDOW_S,
            "last_seen_age_s": round(now - ent["last_seen"], 1),
            "step_rate": step_rate,
            "restarts": restarts,
            "lost_restart_s": round(lost_s, 3),
            "attributed_s": {k: round(v, 3) for k, v in tot.items()},
            "split": split, "goodput": goodput, "skew": skew,
        }
        flops = next((r["g"].get("flops_per_step")
                      for r in cur.values()
                      if r["g"].get("flops_per_step")), None)
        if flops and step_rate:
            out["achieved_flops"] = flops * step_rate
            peak = get_config().train_obs_peak_flops
            if peak > 0:
                out["mfu"] = round(out["achieved_flops"] / peak, 4)
        return out

    # -- RPC surface (service "Train") -----------------------------------

    def summary(self) -> dict:
        """`ray-tpu train status` / cluster_status()["observability"]
        ["train"] payload: every retained run's goodput split, step
        rate, skew window and restart accounting."""
        self.refresh()
        return {"runs": {run: self._summarize(run, ent)
                         for run, ent in self._runs.items()}}

    def run_status(self, run: str) -> Optional[dict]:
        self.refresh()
        ent = self._runs.get(run)
        return self._summarize(run, ent) if ent else None


class DiagnosisManager:
    """Cluster-wide diagnosis fan-out (ref: the
    dashboard's per-node `ray stack`/CpuProfilingManager surfaces): one
    RPC here signals every matching daemon's workers for signal-safe
    all-thread stack dumps and returns the merged, parsed results —
    the `ray-tpu stack` backend."""

    def __init__(self, gcs: "GcsServer"):
        self._gcs = gcs

    async def dump_stacks(self, node_id: Optional[str] = None,
                          worker_id: Optional[str] = None,
                          pids: Optional[List[int]] = None) -> List[dict]:
        """Fan `NodeDaemon.dump_worker_stacks` out over every alive
        (matching) daemon; a node that fails mid-dump reports its error
        instead of poisoning the rest."""
        nodes = [n for n in self._gcs.nodes.view.nodes.values()
                 if n.alive
                 and (not node_id or n.node_id.startswith(node_id))]

        async def one(n) -> dict:
            client = self._gcs.daemon_client(n.node_id)
            if client is None:
                return {"node_id": n.node_id, "workers": [],
                        "error": "daemon unreachable"}
            try:
                return await client.call(
                    "NodeDaemon", "dump_worker_stacks",
                    worker_id=worker_id, pids=pids, timeout=30)
            except Exception as e:  # noqa: BLE001
                return {"node_id": n.node_id, "workers": [],
                        "error": repr(e)}

        return list(await asyncio.gather(*(one(n) for n in nodes)))

    async def summarize_stacks(self, node_id: Optional[str] = None
                               ) -> dict:
        """dump_stacks + cross-worker grouping of identical stacks —
        the "412/512 workers blocked in all_reduce" answer in one RPC."""
        from ray_tpu_torch.util.profiling import summarize_stacks

        results = await self.dump_stacks(node_id=node_id)
        return {"groups": summarize_stacks(results), "nodes": results}


class AutoscalerStateManager:
    """Autoscaler-facing cluster state (ref: GcsAutoscalerStateManager,
    src/ray/gcs/gcs_server/gcs_autoscaler_state_manager.h + the
    AutoscalerStateService in src/ray/protobuf/autoscaler.proto:315).

    Aggregates everything the autoscaler needs into one RPC:
      - per-node capacity / availability / queued task demand / idle time,
      - pending (unschedulable) actors and placement groups,
      - explicit `request_resources` targets (sdk parity).
    """

    def __init__(self, gcs: "GcsServer"):
        self._gcs = gcs
        self._resource_requests: List[Dict[str, float]] = []

    def request_resources(self, bundles: List[Dict[str, float]]) -> dict:
        """Set (replace) the explicit min-capacity target, like
        ray.autoscaler.sdk.request_resources — the cluster should scale so
        these bundles *could* be placed; [] clears the request."""
        self._resource_requests = [dict(b) for b in bundles]
        return {"ok": True}

    def get_cluster_status(self) -> dict:
        now = time.monotonic()
        nodes = []
        for n in self._gcs.nodes.view.nodes.values():
            # A node is busy while its view shows queued demand or held
            # resources, whether or not a report came since: the syncer
            # sends changes only, so an actor holding a card for minutes
            # sends none, and `last_busy` alone would call its node idle
            # (and the autoscaler would drain it under the actor).
            if n.alive and (n.queued or rs.utilization(
                    n.total, n.available) > rs.EPS):
                n.last_busy = now
            nodes.append({
                "node_id": n.node_id,
                "alive": n.alive,
                "total": dict(n.total),
                "available": dict(n.available),
                "queued_demand": [dict(d) for d in n.queued],
                "idle_s": max(0.0, now - n.last_busy) if n.alive else 0.0,
                "labels": dict(n.labels),
                # Synced through the delta channel (syncer.py): pool
                # depth + store pressure, for scale-down safety checks.
                "worker_pool": {"workers": n.workers,
                                "idle": n.idle_workers,
                                "busy": n.busy_workers},
                "store": {"used": n.store_used,
                          "objects": n.store_objects,
                          "spilled": n.spilled_bytes},
            })
        pending_actors = [
            dict(rec.demand) for rec in self._gcs.actors.actors.values()
            if rec.state in (ACTOR_PENDING, ACTOR_RESTARTING)
        ]
        pending_pgs = [
            {"bundles": [dict(b) for b in rec.bundles],
             "strategy": rec.strategy}
            for rec in self._gcs.placement_groups.groups.values()
            if rec.state == PG_PENDING
        ]
        return {
            "nodes": nodes,
            "pending_actors": pending_actors,
            "pending_pgs": pending_pgs,
            "resource_requests": [dict(b) for b in self._resource_requests],
        }


class LogManager:
    """Cluster log hub (ref: the log monitor → GCS pubsub → driver path,
    python/ray/_private/log_monitor.py + worker.py print_logs): node
    daemons ship tailed worker lines here; drivers subscribe to the
    ``logs`` pubsub channel; a per-worker ring buffer keeps the last
    lines of DEAD workers inspectable (dashboard/CLI `ray-tpu logs`)."""

    RING_LINES = 400

    def __init__(self, gcs: "GcsServer"):
        self._gcs = gcs
        # (node_id, worker_id, stream) -> deque[str]; insertion-ordered.
        self._rings: Dict[tuple, deque] = {}
        self._meta: Dict[tuple, dict] = {}

    def add_logs(self, records: List[dict]) -> int:
        for rec in records:
            key = (rec["node_id"], rec["worker_id"], rec["stream"])
            ring = self._rings.get(key)
            if ring is None:
                if len(self._rings) > 4000:  # oldest-worker eviction
                    old = next(iter(self._rings))
                    self._rings.pop(old, None)
                    self._meta.pop(old, None)
                ring = self._rings[key] = deque(maxlen=self.RING_LINES)
            ring.extend(rec["lines"])
            self._meta[key] = {"actor_id": rec.get("actor_id"),
                               "job_id": rec.get("job_id"),
                               "pid": rec.get("pid")}
            self._gcs.pubsub.publish("logs", rec)
        return len(records)

    def tail_logs(self, node_id: Optional[str] = None,
                  worker_id: Optional[str] = None,
                  actor_id: Optional[str] = None,
                  job_id: Optional[str] = None,
                  num_lines: int = 100) -> List[dict]:
        """Recent lines per matching worker stream (dead or alive)."""
        out = []
        for (nid, wid, stream), ring in self._rings.items():
            meta = self._meta.get((nid, wid, stream), {})
            if node_id and not nid.startswith(node_id):
                continue
            if worker_id and not wid.startswith(worker_id):
                continue
            if actor_id and not (meta.get("actor_id") or "").startswith(
                    actor_id):
                continue
            if job_id and meta.get("job_id") != job_id:
                continue
            out.append({"node_id": nid, "worker_id": wid, "stream": stream,
                        **meta, "lines": list(ring)[-num_lines:]})
        return out


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 storage_dir: Optional[str] = None):
        from ray_tpu_torch.core.distributed.gcs_storage import open_store

        # Durable backend (ref: gcs_storage knob, ray_config_def.h:402):
        # with a storage dir, KV/actors/PGs/jobs survive a GCS restart —
        # daemons re-register via heartbeats and detached actors keep
        # their names (the Redis-backed fault-tolerance story).
        from ray_tpu_torch.core.distributed.syncer import ClusterSyncer

        self.store = open_store(storage_dir)
        # The GCS's own node identity: labels its process metrics in the
        # federated exposition and survives restarts when durable (the
        # journal a recovered GCS serves should carry the same label).
        import uuid

        meta = self.store.all("meta")
        self.node_id = meta.get("gcs_id") or uuid.uuid4().hex
        if meta.get("gcs_id") != self.node_id:
            self.store.put("meta", "gcs_id", self.node_id)
        self.pubsub = Pubsub()
        self.kv = KV(self.store)
        self.nodes = NodeInfo(self)
        # Versioned delta sync (syncer.py): merges per-node state pushes
        # into self.nodes.view and fans the coalesced cluster view back
        # out to daemons. Constructed right after NodeInfo — every other
        # manager reads the view it maintains.
        self.syncer = ClusterSyncer(self)
        self.actors = ActorManager(self, self.store)
        self.objects = ObjectDirectory(self)
        self.placement_groups = PlacementGroupManager(self, self.store)
        self.jobs = JobManager(self, self.store)
        # Bounded per-job task-event store (task_events.py GcsTaskManager;
        # replaces the old unbounded deque sink).
        from ray_tpu_torch.core.distributed.task_events import GcsTaskManager

        self.task_events = GcsTaskManager()
        self.metrics = MetricsFederation(self)
        self.serve_gauges = ServeGauges(self)
        self.train_runs = TrainRunState(self)
        self.diagnosis = DiagnosisManager(self)
        self.event_log = EventLog()
        self.flight = FlightRecorder(self, self.store)
        self.event_log.flight = self.flight
        self.kv.flight = self.flight
        self.attribution = GcsLoadAttribution(self)
        # Event-loop audit state (filled by _audit_loop; read by
        # gcs_load()/doctor even when the audit is disabled).
        self.loop_audit: Dict[str, Any] = {
            "samples": 0, "lag_last_s": 0.0, "lag_max_s": 0.0,
            "backlog": 0}
        self.autoscaler_state = AutoscalerStateManager(self)
        self.logs = LogManager(self)
        self.server = RpcServer(host, port)
        if get_config().gcs_attribution_enabled:
            self.server.attribution_sink = self.attribution.sink
        self._daemon_clients: Dict[str, AsyncRpcClient] = {}
        self._tasks: List[asyncio.Task] = []

    def daemon_client(self, node_id: str) -> Optional[AsyncRpcClient]:
        n = self.nodes.view.nodes.get(node_id)
        if n is None or not n.alive:
            return None
        client = self._daemon_clients.get(node_id)
        if client is None or client.address != n.address:
            client = AsyncRpcClient(n.address)
            self._daemon_clients[node_id] = client
        return client

    async def start(self) -> int:
        for name, svc in [
            ("NodeInfo", self.nodes), ("KV", self.kv),
            ("ActorManager", self.actors), ("ObjectDirectory", self.objects),
            ("PlacementGroups", self.placement_groups),
            ("JobManager", self.jobs), ("TaskEvents", self.task_events),
            ("EventLog", self.event_log),
            ("AutoscalerState", self.autoscaler_state),
            ("Pubsub", self.pubsub),
            ("LogManager", self.logs),
            ("Syncer", self.syncer),
            ("Metrics", self.metrics),
            ("Serve", self.serve_gauges),
            ("Train", self.train_runs),
            ("Diagnosis", self.diagnosis),
            ("FlightRecorder", self.flight),
        ]:
            self.server.add_service(name, svc)
        port = await self.server.start()
        self._start_metrics_http()
        self._tasks = [
            asyncio.ensure_future(self.nodes.health_check_loop()),
            asyncio.ensure_future(self.actors.scheduling_loop()),
            asyncio.ensure_future(self.placement_groups.scheduling_loop()),
            asyncio.ensure_future(self.syncer.broadcast_loop()),
            asyncio.ensure_future(self._audit_loop()),
        ]
        self.flight.record("gcs.start", "GCS serving",
                           node_id=self.node_id,
                           fields={"address": self.server.address})
        # Resume scheduling of state loaded from durable storage.
        self.actors.requeue_loaded()
        self.placement_groups.requeue_loaded()
        logger.info("GCS listening on %s", self.server.address)
        return port

    async def _audit_loop(self) -> None:
        """GCS event-loop audit. The GCS runs on a plain asyncio.run
        loop (not an EventLoopThread), so it has no lag probe of its
        own: a timed sleep measures its overshoot — lag means some
        handler or import blocked the loop — and each tick also samples
        the asyncio task backlog and KV/journal sizes into gcs-labelled
        gauges that ride the federated exposition."""
        from ray_tpu_torch.util.metrics import Gauge, process_sample

        interval = get_config().gcs_loop_audit_ms / 1000.0
        if interval <= 0:
            return
        g_lag = Gauge("raytpu_gcs_loop_lag_seconds",
                      "GCS event-loop lag (audit sleep overshoot)")
        g_backlog = Gauge("raytpu_gcs_loop_backlog",
                          "asyncio tasks pending on the GCS loop")
        g_kv = Gauge("raytpu_gcs_kv_keys",
                     "keys in the GCS KV store")
        g_flight = Gauge("raytpu_gcs_flight_events",
                         "entries in the cluster flight recorder")
        # The GCS's own process footprint, in the same registry the
        # federation labels with this GCS's node id: the control plane
        # monitors itself with the machinery it runs for everyone else.
        g_proc = {
            "rss_bytes": Gauge("raytpu_gcs_process_rss_bytes",
                               "GCS process resident set size"),
            "cpu_seconds": Gauge("raytpu_gcs_process_cpu_seconds",
                                 "GCS process cumulative CPU time"),
            "open_fds": Gauge("raytpu_gcs_process_open_fds",
                              "GCS process open file descriptors"),
            "threads": Gauge("raytpu_gcs_process_threads",
                             "GCS process live threads"),
        }
        audit = self.loop_audit
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(interval)
            lag = max(0.0, time.monotonic() - t0 - interval)
            audit["samples"] += 1
            audit["lag_last_s"] = round(lag, 6)
            audit["lag_max_s"] = max(audit["lag_max_s"], round(lag, 6))
            audit["backlog"] = sum(1 for t in asyncio.all_tasks()
                                   if not t.done())
            g_lag.set(lag)
            g_backlog.set(audit["backlog"])
            g_kv.set(len(self.kv._data))
            g_flight.set(len(self.flight.events))
            for name, value in process_sample().items():
                g = g_proc.get(name)
                if g is not None:
                    g.set(value)

    def _start_metrics_http(self) -> None:
        """Federated /metrics on the GCS (ref: the dashboard's
        prometheus scrape target): one exposition covering every node's
        last syncer-shipped snapshot, node-labelled."""
        port = get_config().metrics_gcs_export_port
        if not port:
            return
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        gcs = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = gcs.metrics.federated_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        try:
            srv = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        except OSError as e:
            logger.warning("GCS metrics port %d unavailable: %s", port, e)
            return
        self._metrics_http = srv
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        logger.info("federated metrics on :%d/metrics",
                    srv.server_address[1])

    async def stop(self):
        srv = getattr(self, "_metrics_http", None)
        if srv is not None:
            srv.shutdown()
        for t in self._tasks:
            t.cancel()
        await self.server.stop()
        self.store.close()


def main():
    import argparse
    import sys

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--storage-dir", default=None,
                        help="durable state dir (GCS fault tolerance)")
    args = parser.parse_args()

    logging.basicConfig(
        level=logging.INFO,
        format="[gcs] %(asctime)s %(levelname)s %(message)s")
    from ray_tpu_torch.core.distributed.driver import start_watch_parent_thread

    start_watch_parent_thread()

    async def run():
        gcs = GcsServer(args.host, args.port, storage_dir=args.storage_dir)
        port = await gcs.start()
        # Handshake: parent reads the bound port from stdout.
        print(f"GCS_PORT={port}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        sys.exit(0)


if __name__ == "__main__":
    main()
