"""Compiled (accelerated) DAG execution over mutable shm channels.

The port's copy of `ray_tpu/dag/compiled_dag.py`, importing
`ray_tpu_torch` only.

Analogue of the reference CompiledDAG (ref: python/ray/dag/
compiled_dag_node.py:174 — execute :532, async :561) and its channel
substrate (python/ray/experimental/channel.py:50): the graph is resolved
ONCE into per-stage execution loops connected by mutable shared-memory
channels, so each `execute()` is a channel write + read — no per-call
task submission (lease RPC, arg upload, result store) at all.

Compilation model (mirrors the reference's aDAG constraints, with the
same-host-only restriction lifted):
  * one InputNode; actor-method nodes AND stateless FunctionNodes both
    compile. A FunctionNode stage gets an EXCLUSIVE pre-leased task
    lane: a worker leased once, pinned (zero resources held, actor
    semantics) and dedicated to the stage loop for the DAG's life;
  * per-edge transport selection: readers always consume a shm ring on
    THEIR OWN node. A same-node producer mmaps the ring directly; a
    cross-node producer pushes versioned raw frames (wire codec 2) to
    the reader node's daemon, which lands them in the ring
    (`RemoteChannelWriter`); a producer with consumer groups on several
    nodes serializes once and fans out (`FanoutWriter`);
  * every actor stage runs `_compiled_node_loop` via the worker's
    `__raytpu_apply__` hook, dedicating itself to the DAG (the
    reference pins the actor's executor the same way); lane stages run
    `_compiled_fn_loop` shipped through `lane_apply`;
  * exceptions are wrapped and forwarded through downstream channels, so
    a failed stage surfaces at `ref.get()` without wedging the pipeline;
  * `teardown()` closes the channels; loops drain (bounded by
    `RAY_TPU_DAG_TEARDOWN_TIMEOUT_S`), lanes unpin their workers, and
    the actors return to normal call service.

Values on the channels are host values. The rings carry serialized
payloads, and `core/serialization.py` rebuilds a CUDA tensor on the device
it was saved from, which a reader that sees no card (a driver or a lane
worker started with ``CUDA_VISIBLE_DEVICES=""``) does not have. So a stage
whose output crosses to such a reader returns host values (a float, a
numpy array, a CPU tensor), as the JAX package's stages return host
arrays. No channel keeps a value on the device.

Stages pipeline naturally: the input channel accepts iteration N+1 as
soon as stage 1 consumed iteration N (write blocks only on un-acked
readers), which is the GPipe-style overlap the reference gets from its
buffered channels.
"""
from __future__ import annotations

import functools
import pickle
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.dag.dag_node import (
    ActorClassNode,
    ActorMethodNode,
    DAGNode,
    FunctionNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.experimental.channel import (
    Channel,
    ChannelClosedError,
    ChannelTimeoutError,
    FanoutWriter,
    RemoteChannelWriter,
)


class _ExecError:
    """A stage failure in transit: forwarded through downstream channels
    and re-raised at ref.get() (ref: the reference wraps exceptions into
    the channel the same way)."""

    def __init__(self, exc: BaseException):
        try:
            self.blob = pickle.dumps(exc)
        except Exception:  # noqa: BLE001
            self.blob = pickle.dumps(RuntimeError(repr(exc)))

    def raise_(self) -> None:
        raise pickle.loads(self.blob)


def _loop_body(call, arg_template, kwarg_template, in_channels,
               out_channel) -> str:
    """Shared stage loop: read inputs, apply, write the output; repeat
    until a channel closes (teardown or a dead peer)."""
    while True:
        try:
            values = [ch.read(timeout=None, reader_idx=idx)
                      for ch, idx in in_channels]
        except ChannelClosedError:
            return "closed"
        failed = next((v for v in values if isinstance(v, _ExecError)),
                      None)
        if failed is None:
            args = [values[src] if kind == "chan" else src
                    for kind, src in arg_template]
            kwargs = {k: (values[src] if kind == "chan" else src)
                      for k, (kind, src) in kwarg_template.items()}
            try:
                result = call(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001
                result = _ExecError(e)
        else:
            result = failed  # propagate upstream failure unchanged
        try:
            out_channel.write(result, timeout=None)
        except ChannelClosedError:
            return "closed"


def _compiled_node_loop(instance, method_name: str,
                        arg_template: List[Tuple[str, Any]],
                        kwarg_template: Dict[str, Tuple[str, Any]],
                        in_channels: List[Tuple[Channel, int]],
                        out_channel) -> str:
    """Runs inside a DAG actor (via __raytpu_apply__)."""
    return _loop_body(getattr(instance, method_name), arg_template,
                      kwarg_template, in_channels, out_channel)


def _compiled_fn_loop(fn, arg_template: List[Tuple[str, Any]],
                      kwarg_template: Dict[str, Tuple[str, Any]],
                      in_channels: List[Tuple[Channel, int]],
                      out_channel) -> str:
    """Runs inside a lane-pinned worker (via lane_apply): the stateless
    FunctionNode analogue of `_compiled_node_loop`."""
    return _loop_body(fn, arg_template, kwarg_template, in_channels,
                      out_channel)


class CompiledDAGRef:
    """Handle for one execute()'s result (ref: CompiledDAGRef in
    compiled_dag_node.py). `get()` may be called once, in any order
    across refs — results are buffered per execution index."""

    def __init__(self, dag: "CompiledDAG", idx: int):
        self._dag = dag
        self._idx = idx
        self._taken = False

    def get(self, timeout: Optional[float] = None):
        if self._taken:
            raise ValueError("CompiledDAGRef.get() already consumed")
        self._taken = True
        return self._dag._get_result(self._idx, timeout)


class CompiledDAG:
    MAX_BUFFERED_RESULTS = 1000

    def __init__(self, root: DAGNode, *,
                 buffer_size_bytes: int = 4 << 20,
                 submit_timeout: float = 30.0):
        self._root = root
        self._buffer_size = buffer_size_bytes
        self._submit_timeout = submit_timeout
        self._core = None
        self._actor_cache: Dict[int, Any] = {}
        # Rings: every shm ring this DAG created, with the daemon that
        # owns it (None = the driver's own node, managed directly).
        self._rings: List[dict] = []
        self._daemon_clients: Dict[str, Any] = {}
        self._actor_loops: List[Tuple[str, Any]] = []
        self._lane_loops: List[Tuple[str, Any]] = []   # (name, Future)
        self._stage_lanes: List[Tuple[str, Any]] = []  # (name, lane)
        self._exec_idx = 0
        self._next_read_idx = 0
        self._result_buffer: Dict[int, Any] = {}
        self._torn_down = False
        try:
            self._compile()
        except BaseException:
            # Partial compiles hold real resources (materialized actors,
            # pinned lane workers, rings on remote daemons): release
            # them before surfacing the error.
            try:
                self.teardown()
            except Exception:  # noqa: BLE001
                pass
            raise

    # -- compilation ----------------------------------------------------
    def _topo_nodes(self) -> List[DAGNode]:
        order: List[DAGNode] = []
        seen: Dict[int, bool] = {}

        def visit(n: DAGNode) -> None:
            if id(n) in seen:
                return
            seen[id(n)] = True
            for c in n._children():
                visit(c)
            order.append(n)

        visit(self._root)
        return order

    def _materialize_actor(self, node: DAGNode):
        """ActorClassNode targets instantiate once for the DAG's life."""
        if id(node) not in self._actor_cache:
            if node._children():
                raise ValueError(
                    "compiled DAG actor constructors cannot depend on "
                    "other DAG nodes")
            self._actor_cache[id(node)] = node.execute()
        return self._actor_cache[id(node)]

    # -- transport planning ---------------------------------------------
    def _daemon(self, address: str):
        """Cached sync client to a node daemon (ring lifecycle RPCs)."""
        client = self._daemon_clients.get(address)
        if client is None:
            from ray_tpu_torch.core.distributed.rpc import SyncRpcClient

            client = SyncRpcClient(address)
            self._daemon_clients[address] = client
        return client

    def _cluster_layout(self) -> Tuple[Optional[str], Dict[str, str]]:
        """(driver node id, node id -> daemon address). Empty/None when
        the runtime has no cluster view (local mode): every edge then
        degrades to the same-host shm path."""
        core = self._core
        drv_node = getattr(core, "node_id", None)
        daemon_of: Dict[str, str] = {}
        gcs = getattr(core, "gcs", None)
        if gcs is not None:
            try:
                for rec in gcs.call("NodeInfo", "list_nodes", timeout=30):
                    if rec.get("alive"):
                        daemon_of[rec["node_id"]] = rec["address"]
            except Exception:  # noqa: BLE001 — plan same-host
                pass
        if drv_node is not None \
                and getattr(core, "daemon_address", None):
            daemon_of[drv_node] = core.daemon_address
        return drv_node, daemon_of

    def _actor_node(self, actor_id_hex: str) -> Optional[str]:
        """Where does this actor live? Long-polls the GCS until the
        actor is ALIVE (it may still be scheduling at compile time)."""
        import time

        gcs = getattr(self._core, "gcs", None)
        if gcs is None:
            return None
        deadline = time.monotonic() + max(self._submit_timeout, 30.0)
        known = ""
        while True:
            try:
                rec = gcs.call("ActorManager", "wait_actor",
                               actor_id=actor_id_hex, known_state=known,
                               timeout=30)
            except Exception:  # noqa: BLE001
                return None
            if rec is None:
                return None
            if rec["state"] == "ALIVE":
                return rec.get("node_id")
            if rec["state"] == "DEAD":
                raise ValueError(
                    f"compiled DAG actor {actor_id_hex[:8]} is dead: "
                    f"{rec.get('death_reason', '')}")
            if time.monotonic() > deadline:
                return None
            known = rec["state"]

    def _make_rings(self, prod: DAGNode, cons: List[DAGNode],
                    driver_reads: bool, node_of: Dict[int, Optional[str]],
                    drv_node: Optional[str],
                    daemon_of: Dict[str, str]) -> List[dict]:
        """One ring per (producer, consumer-node) group, created ON the
        consumers' node so reads are always a local mmap poll. Fills the
        reader bindings (stage and driver slots)."""
        groups: Dict[Optional[str], List[Optional[DAGNode]]] = {}
        order: List[Optional[str]] = []
        for c in cons:
            gnode = node_of[id(c)]
            if gnode not in groups:
                groups[gnode] = []
                order.append(gnode)
            groups[gnode].append(c)
        if driver_reads:
            # Driver slot is appended LAST within its group.
            if drv_node not in groups:
                groups[drv_node] = []
                order.append(drv_node)
            groups[drv_node].append(None)
        rings = []
        for gnode in order:
            readers = groups[gnode]
            if gnode == drv_node or gnode not in daemon_of:
                ch = Channel.create(len(readers),
                                    capacity=self._buffer_size)
                daemon = None
            else:
                rep = self._daemon(daemon_of[gnode]).call(
                    "NodeDaemon", "channel_create",
                    n_readers=len(readers), capacity=self._buffer_size,
                    timeout=30)
                ch = Channel(rep["path"], rep["capacity"],
                             rep["n_readers"], rep["n_slots"])
                daemon = daemon_of[gnode]
            ring = {"node": gnode, "ch": ch, "daemon": daemon}
            self._rings.append(ring)
            rings.append(ring)
            for slot, r in enumerate(readers):
                if r is None:
                    self._driver_binding[id(prod)] = (ch, slot)
                else:
                    self._reader_binding[(id(prod), id(r))] = (ch, slot)
        return rings

    def _writer_endpoint(self, rings: List[dict],
                         prod_node: Optional[str],
                         daemon_of: Dict[str, str]):
        """Per-edge transport selection: same-node ring -> direct mmap
        writer; cross-node ring -> raw-frame push through the reader
        node's daemon; several groups -> serialize once, fan out."""
        eps: List[Any] = []
        for ring in rings:
            ch = ring["ch"]
            addr = ring["daemon"] or daemon_of.get(ring["node"])
            if ring["node"] == prod_node or addr is None:
                eps.append(ch)
            else:
                eps.append(RemoteChannelWriter(addr, ch.path, ch.capacity,
                                               ch.n_readers, ch.n_slots))
        return eps[0] if len(eps) == 1 else FanoutWriter(eps)

    def _compile(self) -> None:
        from ray_tpu_torch.api import _global_worker

        self._core = _global_worker()
        nodes = self._topo_nodes()
        stage_nodes = [n for n in nodes
                       if isinstance(n, (ActorMethodNode, FunctionNode))]
        inputs = [n for n in nodes if isinstance(n, InputNode)]
        if len(inputs) != 1:
            raise ValueError("compiled DAGs need exactly one InputNode "
                             "(the execution trigger)")
        if not stage_nodes:
            raise ValueError("compiled DAG has no task or actor-method "
                             "nodes")
        self._input_node = inputs[0]

        if isinstance(self._root, MultiOutputNode):
            output_nodes = list(self._root._bound_args)
        else:
            output_nodes = [self._root]
        if not all(isinstance(o, (ActorMethodNode, FunctionNode))
                   for o in output_nodes):
            raise ValueError(
                "compiled DAG outputs must be task or actor-method nodes")

        drv_node, daemon_of = self._cluster_layout()

        # Pass 1 — resolve every stage to a host: materialize actors and
        # locate them; lease + pin an exclusive lane per FunctionNode.
        from ray_tpu_torch.actor import ActorHandle, ActorMethod

        seen_actors: Dict[Any, str] = {}
        stage_info: Dict[int, dict] = {}
        for n in stage_nodes:
            if isinstance(n, ActorMethodNode):
                target = n._target
                if isinstance(target, ActorClassNode):
                    target = self._materialize_actor(target)
                if not isinstance(target, ActorHandle):
                    raise ValueError(
                        f"compiled DAG method target must be an actor, "
                        f"got {type(target).__name__}")
                # Each node runs an infinite __raytpu_apply__ loop on its
                # actor; with the default max_concurrency=1 a second node
                # on the SAME actor would queue behind the first forever,
                # and every execute() would die with an opaque submit
                # timeout.
                if target._actor_id in seen_actors:
                    raise ValueError(
                        f"compiled DAG binds two methods of the same "
                        f"actor ({seen_actors[target._actor_id]!r} and "
                        f"{n._method_name!r} on {target}); each actor "
                        "may appear in at most one node — use a second "
                        "actor, or fold the methods into one")
                seen_actors[target._actor_id] = n._method_name
                node = self._actor_node(target._actor_id.hex())
                stage_info[id(n)] = {
                    "kind": "actor", "target": target,
                    "name": n._method_name,
                    "node": node if node is not None else drv_node}
            else:
                if not hasattr(self._core, "open_exclusive_lane"):
                    raise ValueError(
                        "compiled DAG task (FunctionNode) stages need "
                        "the distributed runtime's pre-leased task "
                        "lanes; in local mode keep the per-call path "
                        "(use .execute())")
                rf = n._rf
                fn = rf._function
                opts = rf._options
                name = getattr(fn, "__qualname__",
                               getattr(fn, "__name__", "task"))
                lane = self._core.open_exclusive_lane(
                    fn,
                    num_cpus=(opts.num_cpus
                              if opts.num_cpus is not None else 1.0),
                    resources=dict(opts.resources) or None)
                self._stage_lanes.append((name, lane))
                stage_info[id(n)] = {
                    "kind": "lane", "lane": lane, "fn": fn, "name": name,
                    "node": (lane.node_id if lane.node_id is not None
                             else drv_node)}

        node_of = {sid: info["node"] for sid, info in stage_info.items()}

        # Producer -> consumer wiring. A producer gets one ring PER
        # CONSUMER NODE (+ one for the driver if it is a DAG output),
        # each with a reader slot per consumer on that node.
        consumers: Dict[int, List[DAGNode]] = {}
        for n in stage_nodes:
            # Dedupe: a node reading the same producer for two arg slots
            # still consumes ONE version per iteration (a duplicate
            # reader slot would never ack and wedge the writer).
            deps = {id(d): d for d in n._children()}.values()
            for dep in deps:
                if isinstance(dep, (InputNode, ActorMethodNode,
                                    FunctionNode)):
                    consumers.setdefault(id(dep), []).append(n)

        # Pass 2 — rings + per-edge write endpoints.
        self._reader_binding: Dict[Tuple[int, int], Tuple[Channel, int]] \
            = {}
        self._driver_binding: Dict[int, Tuple[Channel, int]] = {}
        endpoint_of: Dict[int, Any] = {}
        for prod in [self._input_node] + stage_nodes:
            cons = consumers.get(id(prod), [])
            driver_reads = prod in output_nodes
            if not cons and not driver_reads:
                raise ValueError("dangling DAG node with no consumers")
            rings = self._make_rings(prod, cons, driver_reads, node_of,
                                     drv_node, daemon_of)
            prod_node = (drv_node if prod is self._input_node
                         else stage_info[id(prod)]["node"])
            endpoint_of[id(prod)] = self._writer_endpoint(
                rings, prod_node, daemon_of)
        self._input_chan = endpoint_of[id(self._input_node)]

        # Pass 3 — launch one loop per stage.
        for n in stage_nodes:
            info = stage_info[id(n)]
            in_channels: List[Tuple[Channel, int]] = []
            chan_index: Dict[int, int] = {}

            def slot_for(dep: DAGNode) -> int:
                if id(dep) not in chan_index:
                    in_channels.append(
                        self._reader_binding[(id(dep), id(n))])
                    chan_index[id(dep)] = len(in_channels) - 1
                return chan_index[id(dep)]

            def encode(v):
                if isinstance(v, (InputNode, ActorMethodNode,
                                  FunctionNode)):
                    return ("chan", slot_for(v))
                if isinstance(v, DAGNode):
                    raise ValueError(
                        f"unsupported arg node {type(v).__name__} in "
                        "compiled DAG")
                return ("const", v)

            arg_template = [encode(a) for a in n._bound_args]
            kwarg_template = {k: encode(v)
                              for k, v in n._bound_kwargs.items()}
            if not in_channels:
                raise ValueError(
                    f"compiled DAG node {info['name']!r} has no channel "
                    "inputs — every node must (transitively) depend on "
                    "the InputNode so executions drive it")
            if info["kind"] == "actor":
                ref = ActorMethod(info["target"],
                                  "__raytpu_apply__").remote(
                    _compiled_node_loop, n._method_name, arg_template,
                    kwarg_template, in_channels, endpoint_of[id(n)])
                self._actor_loops.append((info["name"], ref))
            else:
                from ray_tpu_torch.core import serialization

                body = functools.partial(
                    _compiled_fn_loop, info["fn"], arg_template,
                    kwarg_template, in_channels, endpoint_of[id(n)])
                fut = self._core.lane_apply(
                    info["lane"], serialization.cloudpickle.dumps(body),
                    name=info["name"])
                self._lane_loops.append((info["name"], fut))

        # Driver-side output readers (the driver's slot is the LAST one
        # of its group's ring).
        self._output_readers: List[Tuple[Channel, int]] = [
            self._driver_binding[id(o)] for o in output_nodes]
        self._multi_output = isinstance(self._root, MultiOutputNode)

    # -- execution ------------------------------------------------------
    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        if self._torn_down:
            raise ValueError("compiled DAG was torn down")
        if kwargs:
            raise ValueError("compiled DAGs take positional input only")
        if self._exec_idx - self._next_read_idx >= self.MAX_BUFFERED_RESULTS:
            raise ValueError(
                f"{self.MAX_BUFFERED_RESULTS} un-consumed results; call "
                "get() on earlier CompiledDAGRefs first")
        value = args[0] if len(args) == 1 else args
        # The channel rings bound in-flight executions; when they fill,
        # drain finished outputs into the result buffer so deep
        # submit-then-get patterns keep flowing (the reference buffers
        # results the same way, compiled_dag_node max_buffered_results).
        import time

        deadline = time.monotonic() + self._submit_timeout
        while True:
            self._drain_ready()
            try:
                self._input_chan.write(value, timeout=0.05)
                break
            except ChannelTimeoutError:
                if time.monotonic() >= deadline:
                    self._check_loops()  # dead DAG stage is the likely cause
                    raise ChannelTimeoutError(
                        f"execute() blocked >{self._submit_timeout}s: "
                        "pipeline full and no output consumed")
        ref = CompiledDAGRef(self, self._exec_idx)
        self._exec_idx += 1
        return ref

    def _drain_ready(self) -> None:
        """Move already-published outputs into the result buffer
        (non-blocking), releasing ring backpressure."""
        while (self._next_read_idx < self._exec_idx
               and len(self._result_buffer) < self.MAX_BUFFERED_RESULTS):
            if not all(ch.peek_ready(slot)
                       for ch, slot in self._output_readers):
                return
            outs = [ch.read(timeout=1.0, reader_idx=slot)
                    for ch, slot in self._output_readers]
            self._result_buffer[self._next_read_idx] = (
                outs if self._multi_output else outs[0])
            self._next_read_idx += 1

    async def execute_async(self, *args, **kwargs) -> CompiledDAGRef:
        import asyncio

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: self.execute(*args, **kwargs))

    def _check_loops(self) -> None:
        """Surface a dead DAG stage as an error instead of a hang."""
        import ray_tpu_torch

        refs = [r for _, r in self._actor_loops]
        if refs:
            done, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=0)
            if done:
                ray_tpu_torch.get(done[0])  # raises if the loop/actor died
                raise RuntimeError(
                    "a compiled DAG actor exited its execution loop; "
                    "tear down and recompile")
        for name, fut in self._lane_loops:
            if fut.done():
                rep = fut.result()  # raises if the lane worker died
                err = rep.get("error") if isinstance(rep, dict) else None
                if isinstance(err, BaseException):
                    raise err
                if err:
                    raise RuntimeError(str(err))
                raise RuntimeError(
                    f"compiled DAG stage {name!r} exited its execution "
                    "loop; tear down and recompile")

    def _read_iteration(self, deadline: Optional[float]) -> list:
        """All-or-nothing read of one iteration's outputs: wait until
        EVERY output channel has the next version published, then consume
        them together. A partial read (one channel consumed, another
        timed out) would misalign every later iteration. Waits in 1s
        slices so a dead stage surfaces as an error, not a hang."""
        import time

        next_liveness = time.monotonic() + 1.0
        backoff = 1e-6
        while True:
            if all(ch.peek_ready(slot)
                   for ch, slot in self._output_readers):
                return [ch.read(timeout=5.0, reader_idx=slot)
                        for ch, slot in self._output_readers]
            now = time.monotonic()
            if now >= next_liveness:
                self._check_loops()
                next_liveness = now + 1.0
            if deadline is not None and now >= deadline:
                raise ChannelTimeoutError(
                    "compiled DAG result not ready before timeout")
            time.sleep(backoff)
            backoff = min(backoff * 2, 2e-4)

    def _get_result(self, idx: int, timeout: Optional[float]):
        import time

        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while self._next_read_idx <= idx:
            outs = self._read_iteration(deadline)
            self._result_buffer[self._next_read_idx] = (
                outs if self._multi_output else outs[0])
            self._next_read_idx += 1
        result = self._result_buffer.pop(idx)
        if isinstance(result, _ExecError):
            result.raise_()
        if isinstance(result, list):
            for r in result:
                if isinstance(r, _ExecError):
                    r.raise_()
        return result

    # -- teardown -------------------------------------------------------
    def _ring_close(self, ring: dict) -> None:
        if ring["daemon"] is None:
            ring["ch"].close()
        else:
            try:
                self._daemon(ring["daemon"]).call(
                    "NodeDaemon", "channel_close", path=ring["ch"].path,
                    timeout=10)
            except Exception:  # noqa: BLE001 — daemon may be gone
                pass

    def _ring_unlink(self, ring: dict) -> None:
        if ring["daemon"] is None:
            ring["ch"].unlink()
        else:
            try:
                self._daemon(ring["daemon"]).call(
                    "NodeDaemon", "channel_unlink", path=ring["ch"].path,
                    timeout=10)
            except Exception:  # noqa: BLE001
                pass

    def teardown(self, kill_actors: bool = False) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        import time

        from ray_tpu_torch.core.config import get_config

        timeout = get_config().dag_teardown_timeout_s
        # Closing every ring wakes every stage loop: blocked reads and
        # writes raise ChannelClosedError and the loops drain.
        for ring in self._rings:
            self._ring_close(ring)
        import ray_tpu_torch

        deadline = time.monotonic() + timeout
        stragglers: List[str] = []
        refs = [r for _, r in self._actor_loops]
        if refs:
            try:
                _, not_done = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                           timeout=timeout)
                stragglers += [name for name, r in self._actor_loops
                               if r in not_done]
            except Exception:  # noqa: BLE001
                pass
        if self._lane_loops:
            import concurrent.futures as cf

            _, not_done = cf.wait(
                [f for _, f in self._lane_loops],
                timeout=max(0.0, deadline - time.monotonic()))
            stragglers += [name for name, f in self._lane_loops
                           if f in not_done]
        for _, lane in self._stage_lanes:
            try:
                self._core.close_exclusive_lane(lane)
            except Exception:  # noqa: BLE001
                pass
        for ring in self._rings:
            self._ring_unlink(ring)
        for client in self._daemon_clients.values():
            try:
                client.close()
            except Exception:  # noqa: BLE001
                pass
        self._daemon_clients = {}
        if kill_actors:
            for handle in self._actor_cache.values():
                try:
                    ray_tpu_torch.kill(handle)
                except Exception:  # noqa: BLE001
                    pass
        if stragglers:
            raise RuntimeError(
                f"compiled DAG teardown: {len(stragglers)} stage "
                f"loop(s) still running after {timeout:.1f}s "
                f"({', '.join(sorted(stragglers))}); raise "
                "RAY_TPU_DAG_TEARDOWN_TIMEOUT_S to wait longer")

    def __del__(self):
        try:
            self.teardown()
        except Exception:  # noqa: BLE001
            pass
