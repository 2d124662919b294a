"""Virtual-daemon harness: thousands of node-daemon stand-ins in one process;
counterpart of `ray_tpu/core/distributed/virtual_node.py`.

The scale envelope of the control plane (how many nodes can the GCS sync?)
is a different question from the scale envelope of one host (how many
worker processes fit?). The reference answers the first with its
many-nodes release tests against real clusters; on a single VM we answer
it the same way the reference's `fake_cluster` + syncer benchmarks do —
each virtual node runs the REAL registration RPC and the REAL NodeSyncer
protocol (versioned deltas, keepalives, resync), but owns no RpcServer, no
object store, and no worker processes. Many virtual nodes multiplex over a
few shared AsyncRpcClients, so 1000 nodes cost 1000 asyncio tasks + a
handful of sockets, not 1000 processes.

The port's syncer and transfer tests drive it (`tests/test_torch_multi_node.py`).
"""
from __future__ import annotations

import asyncio
import random
from typing import Dict, List, Optional

from ray_tpu_torch.core.distributed.rpc import AsyncRpcClient
from ray_tpu_torch.core.distributed.scheduler import ClusterView
from ray_tpu_torch.core.distributed.syncer import NodeSyncer


class VirtualNode:
    """One in-process node: a real NodeSyncer over synthetic local state."""

    def __init__(self, *, client: AsyncRpcClient, node_id: str,
                 num_cpus: float = 4.0, seed: int = 0,
                 report_interval_s: float = 0.5,
                 keepalive_s: float = 2.0, subscribe: bool = False):
        self.client = client
        self.node_id = node_id
        self.num_cpus = float(num_cpus)
        self.subscribe = subscribe
        self._rng = random.Random(seed)
        self.state: Dict = {
            "available": {"CPU": self.num_cpus},
            "queued": [],
            "store_used": 0, "store_objects": 0, "spilled_bytes": 0,
            "workers": 0, "idle_workers": 0, "busy_workers": 0,
        }
        self.view = ClusterView()       # fan-out lands here if subscribed
        self.syncer = NodeSyncer(
            gcs=client, node_id=node_id,
            collect=lambda: {k: (dict(v) if isinstance(v, dict)
                                 else list(v) if isinstance(v, list) else v)
                             for k, v in self.state.items()},
            on_reregister=self._register,
            report_interval_s=report_interval_s, keepalive_s=keepalive_s)
        self._tasks: List[asyncio.Task] = []

    async def _register(self) -> None:
        await self.client.call(
            "NodeInfo", "register_node", node_id=self.node_id,
            address=f"virtual:{self.node_id[:8]}",
            resources={"CPU": self.num_cpus}, store_dir="",
            labels={"virtual": "1"}, timeout=30)
        self.syncer.force_full_resync()

    async def start(self) -> None:
        await self._register()
        self._tasks = [asyncio.ensure_future(self.syncer.report_loop())]
        if self.subscribe:
            self._tasks.append(
                asyncio.ensure_future(self.syncer.subscribe_loop(self.view)))

    def churn(self) -> None:
        """One synthetic load change: some CPUs become busy/free, the
        worker pool and store wiggle — exactly the fields a real daemon
        reports. The next report tick ships it as one delta."""
        busy = self._rng.randint(0, int(self.num_cpus))
        self.state["available"] = {"CPU": self.num_cpus - busy}
        self.state["busy_workers"] = busy
        self.state["workers"] = busy + self.state["idle_workers"]
        self.state["store_used"] = self._rng.randrange(0, 1 << 24)
        self.syncer.mark_dirty()

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._tasks = []


class VirtualCluster:
    """N virtual nodes multiplexed over `num_clients` RPC connections."""

    def __init__(self, gcs_address: str, *, n_nodes: int,
                 num_clients: int = 8, num_cpus: float = 4.0,
                 report_interval_s: float = 0.5, keepalive_s: float = 2.0,
                 subscribers: int = 4, seed: int = 0):
        self.gcs_address = gcs_address
        self.clients = [AsyncRpcClient(gcs_address)
                        for _ in range(max(1, num_clients))]
        self.nodes: List[VirtualNode] = []
        rng = random.Random(seed)
        for i in range(n_nodes):
            self.nodes.append(VirtualNode(
                client=self.clients[i % len(self.clients)],
                node_id=f"virt{i:05d}" + "%08x" % rng.getrandbits(32),
                num_cpus=num_cpus, seed=rng.getrandbits(32),
                report_interval_s=report_interval_s,
                keepalive_s=keepalive_s,
                # Only a sample subscribes to the fan-out: every real
                # daemon would, but N subscribers x N nodes of broadcast
                # is O(N^2) loopback bytes that measure the bench host,
                # not the sync path.
                subscribe=i < subscribers))

    async def start(self, registration_concurrency: int = 64) -> None:
        sem = asyncio.Semaphore(registration_concurrency)

        async def boot(node: VirtualNode) -> None:
            async with sem:
                await node.start()

        await asyncio.gather(*(boot(n) for n in self.nodes))

    def churn(self, fraction: float = 0.2,
              rng: Optional[random.Random] = None) -> int:
        rng = rng or random
        k = max(1, int(len(self.nodes) * fraction))
        for node in rng.sample(self.nodes, k):
            node.churn()
        return k

    def aggregate_stats(self) -> Dict[str, float]:
        agg: Dict[str, float] = {}
        for node in self.nodes:
            for k, v in node.syncer.stats.items():
                agg[k] = agg.get(k, 0) + v
        agg["nodes"] = len(self.nodes)
        return agg

    async def stop(self) -> None:
        await asyncio.gather(*(n.stop() for n in self.nodes))
        for c in self.clients:
            await c.close()


class InProcDaemonCluster:
    """N REAL NodeDaemons + one GcsServer on one event loop — the
    object-plane sibling of VirtualCluster: real RPC servers, real shm
    object stores, the real transfer plane (raw frames, create-then-
    fill, striped pulls, broadcast relays), but no worker processes
    (zygote/prestart forced off for the process, restored by stop()).
    The port's transfer tests drive it.
    """

    def __init__(self, n_nodes: int, *, store_capacity: int = 512 << 20,
                 num_cpus: float = 1.0):
        self.n_nodes = n_nodes
        self.store_capacity = store_capacity
        self.num_cpus = num_cpus
        self.gcs = None
        self.daemons: List = []

    async def start(self) -> None:
        import uuid

        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.core.distributed.gcs_server import GcsServer
        from ray_tpu_torch.core.distributed.node_daemon import NodeDaemon

        cfg = get_config()
        # Daemons in THIS process must not fork zygotes or prestart
        # worker processes — the harness exercises the object plane.
        # Saved + restored on stop(): the config singleton is process-
        # wide and later tests may exercise the zygote path.
        self._saved_cfg = (cfg.zygote_enabled, cfg.worker_prestart_enabled)
        cfg.zygote_enabled = False
        cfg.worker_prestart_enabled = False
        self.gcs = GcsServer()
        port = await self.gcs.start()
        for i in range(self.n_nodes):
            daemon = NodeDaemon(
                gcs_address=f"127.0.0.1:{port}",
                node_id=f"inproc{i:03d}" + uuid.uuid4().hex[:10],
                num_cpus=self.num_cpus,
                store_dir=f"/dev/shm/raytpu_inproc_{uuid.uuid4().hex[:12]}",
                object_store_memory=self.store_capacity)
            await daemon.start()
            self.daemons.append(daemon)

    @property
    def addresses(self) -> List[str]:
        return [d.server.address for d in self.daemons]

    async def stop(self) -> None:
        for d in self.daemons:
            try:
                await d.stop()
            except Exception:  # noqa: BLE001
                pass
        self.daemons = []
        if self.gcs is not None:
            await self.gcs.stop()
            self.gcs = None
        saved = getattr(self, "_saved_cfg", None)
        if saved is not None:
            from ray_tpu_torch.core.config import get_config

            cfg = get_config()
            cfg.zygote_enabled, cfg.worker_prestart_enabled = saved
