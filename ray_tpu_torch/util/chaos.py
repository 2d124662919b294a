"""Chaos harness: random worker/node killers for fault-injection tests.
Counterpart of `ray_tpu/util/chaos.py`. The node-level injectors
(`NodeKiller`, `DelayedPartition`) act on a `ray_tpu_torch.cluster_utils`
cluster and its nodes.

ref: python/ray/_private/test_utils.py:1429-1640 (ResourceKillerActor /
WorkerKillerActor / NodeKillerActor + get_and_run_resource_killer).
Runs on the driver as a background thread issuing kill RPCs to node
daemons — the workload under test must complete correctly anyway.
"""
from __future__ import annotations

import random
import signal
import threading
import time
from typing import List, Optional


class WorkerKiller:
    """Periodically SIGKILLs a random task worker somewhere in the cluster.

    Usage::

        killer = WorkerKiller(interval_s=0.4)
        killer.start()
        ... run workload ...
        kills = killer.stop()
    """

    def __init__(self, interval_s: float = 0.5, seed: int = 0,
                 include_actor_workers: bool = False):
        self.interval_s = interval_s
        self.include_actor_workers = include_actor_workers
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.kills: List[dict] = []

    # -- plumbing -----------------------------------------------------------
    def _daemon_addresses(self) -> List[str]:
        import ray_tpu_torch

        return [n["Address"] for n in ray_tpu_torch.nodes() if n["Alive"]]

    def _kill_one(self) -> Optional[dict]:
        from ray_tpu_torch.api import _global_worker
        from ray_tpu_torch.core.distributed.rpc import SyncRpcClient

        w = _global_worker()
        addrs = self._daemon_addresses()
        self._rng.shuffle(addrs)
        for addr in addrs:
            try:
                client = SyncRpcClient(addr, w.loop_thread)
                reply = client.call(
                    "NodeDaemon", "kill_random_worker",
                    include_actor_workers=self.include_actor_workers,
                    seed=self._rng.randrange(1 << 30), timeout=10)
                client.close()
            except Exception:  # noqa: BLE001 — daemon itself may be dying
                continue
            if reply.get("ok"):
                return reply
        return None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            hit = self._kill_one()
            if hit:
                self.kills.append(hit)

    # -- public -------------------------------------------------------------
    def start(self) -> "WorkerKiller":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> List[dict]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        return self.kills


class NodeKiller:
    """Kills whole (non-head) nodes of a cluster_utils.Cluster — gang /
    lineage recovery must absorb it (ref: NodeKillerActor,
    test_utils.py:1497)."""

    def __init__(self, cluster, interval_s: float = 2.0, seed: int = 0,
                 max_kills: int = 1):
        self.cluster = cluster
        self.interval_s = interval_s
        self.max_kills = max_kills
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.kills: List[str] = []

    def _loop(self) -> None:
        while (not self._stop.wait(self.interval_s)
               and len(self.kills) < self.max_kills):
            victims = [n for n in self.cluster.nodes
                       if n is not self.cluster.head]
            if not victims:
                continue
            node = self._rng.choice(victims)
            try:
                self.cluster.remove_node(node)
                self.kills.append(node.node_id)
            except Exception:  # noqa: BLE001
                pass

    def start(self) -> "NodeKiller":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> List[str]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        return self.kills


# ---- deterministic gang-targeted injectors ----------------------------
#
# The random killers above answer "does the cluster survive churn?"; the
# elastic-training tests need the sharper question "does the gang survive
# THIS rank failing THIS way?". These target one rank by its worker pid
# (WorkerGroup.pids) and fan the signal across every node daemon — only
# the daemon owning the pid acts on it.

def _signal_pid(pid: int, sig: int) -> bool:
    from ray_tpu_torch.api import _global_worker
    from ray_tpu_torch.core.distributed.rpc import SyncRpcClient

    import ray_tpu_torch

    w = _global_worker()
    for n in ray_tpu_torch.nodes():
        if not n["Alive"]:
            continue
        try:
            client = SyncRpcClient(n["Address"], w.loop_thread)
            try:
                reply = client.call("NodeDaemon", "signal_worker",
                                    sig=int(sig), pid=pid, timeout=10)
            finally:
                client.close()
        except Exception:  # noqa: BLE001 — that daemon may be dying
            continue
        if reply.get("ok"):
            return True
    return False


def kill_rank(group, rank: int) -> bool:
    """SIGKILL one rank's worker process mid-step (death injection)."""
    pid = group.pids[rank]
    return pid is not None and _signal_pid(pid, signal.SIGKILL)


def sigstop_rank(group, rank: int) -> bool:
    """Freeze one rank (SIGSTOP): a deterministic straggler that still
    holds its lease — exactly what the hang watchdog must catch."""
    pid = group.pids[rank]
    return pid is not None and _signal_pid(pid, signal.SIGSTOP)


def sigcont_rank(group, rank: int) -> bool:
    """Thaw a SIGSTOPped rank."""
    pid = group.pids[rank]
    return pid is not None and _signal_pid(pid, signal.SIGCONT)


class DelayedPartition:
    """SIGSTOPs one cluster_utils node's DAEMON process after a delay —
    the node falls silent (misses heartbeats, drops RPCs) without its
    workers dying: a network partition as the control plane sees one.
    heal() SIGCONTs it; stop() heals and joins."""

    def __init__(self, node, delay_s: float = 1.0):
        self.node = node
        self.delay_s = delay_s
        self._timer: Optional[threading.Timer] = None
        self.partitioned = threading.Event()

    def start(self) -> "DelayedPartition":
        self._timer = threading.Timer(self.delay_s, self._partition)
        self._timer.daemon = True
        self._timer.start()
        return self

    def _partition(self) -> None:
        try:
            self.node.proc.send_signal(signal.SIGSTOP)
            self.partitioned.set()
        except Exception:  # noqa: BLE001 — node already gone
            pass

    def heal(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
        if self.partitioned.is_set():
            try:
                self.node.proc.send_signal(signal.SIGCONT)
            except Exception:  # noqa: BLE001
                pass
            self.partitioned.clear()

    def stop(self) -> None:
        self.heal()
