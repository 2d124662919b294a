"""The train plane's pieces in ray_tpu_torch against ray_tpu's, on the CPU,
with no cluster.

Each case gives the JAX package's module and the port's the same inputs
and compares what comes out: the config dataclasses, `Checkpoint`, the
checkpoint payload (Orbax there, torch.distributed.checkpoint here: round
trips bit-exact, TINY's train state carried from JAX after two steps and
stepped on after a save and a load, a DTensor state on a world-1 gloo
mesh), `StepPhaseRecorder` on a shared fake clock, the GCS's
`TrainRunState` summary and `doctor`'s train findings on the same
gauges, `classify_failure`, `RestartBackoff` on one seed, the chaos
injectors' signals on a child process, and the HF report callback.
"""
import dataclasses
import importlib
import os
import signal
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import ray_tpu
import ray_tpu_torch
from ray_tpu.core.config import reset_config as jax_reset_config
from ray_tpu.core.distributed import gcs_server as jax_gcs
from ray_tpu.models import configs as jax_configs
from ray_tpu.models.training import default_optimizer as jax_default_optimizer
from ray_tpu.models.training import make_train_step as jax_make_train_step
from ray_tpu.parallel import MeshConfig as JaxMeshConfig
from ray_tpu.parallel import build_mesh as jax_build_mesh
from ray_tpu.train import checkpoint as jax_ckpt
from ray_tpu.train import config as jax_config
from ray_tpu.train import elastic as jax_elastic
from ray_tpu.train import observability as jax_obs
from ray_tpu.util import chaos as jax_chaos
from ray_tpu_torch.core.config import reset_config as port_reset_config
from ray_tpu_torch.core.distributed import gcs_server as port_gcs
from ray_tpu_torch.models import configs
from ray_tpu_torch.models.jax_bridge import adam_state_from_jax, params_from_jax
from ray_tpu_torch.models.training import (
    default_optimizer, make_train_step, train_state_tree)
from ray_tpu_torch.train import checkpoint as port_ckpt
from ray_tpu_torch.train import config as port_config
from ray_tpu_torch.train import elastic as port_elastic
from ray_tpu_torch.train import observability as port_obs
from ray_tpu_torch.util import chaos as port_chaos

# TINY's losses through both steps: the tolerance of the port's train step
# against JAX's.
LOSS_REL = 1e-5
OPT = dict(lr=1e-2, warmup=2, total_steps=10)
JCFG = dataclasses.replace(jax_configs.TINY, compute_dtype=jnp.float32)
TCFG = dataclasses.replace(configs.TINY, compute_dtype=torch.float32)


# -- configs -----------------------------------------------------------------

SCALINGS = [dict(), dict(num_workers=4), dict(num_workers=4, min_workers=2),
            dict(num_workers=2, max_workers=6, min_workers=0),
            dict(resources_per_worker={"CPU": 2.0, "GPU": 1.0})]


@pytest.mark.parametrize("kw", SCALINGS)
@pytest.mark.parametrize("accel", [False, True])
def test_scaling_config_matches_jax(kw, accel):
    j = jax_config.ScalingConfig(use_tpu=accel, **kw)
    p = port_config.ScalingConfig(use_gpu=accel, **kw)
    assert p.world_bounds() == j.world_bounds()
    want = {("GPU" if k == "TPU" else k): v
            for k, v in j.worker_resources().items()}
    assert p.worker_resources() == want


def test_config_dataclasses_match_jax():
    """Same fields and defaults, but for the accelerator switch: the port's
    `use_gpu` defaults to True (its entry points run on the card)."""
    for name in ("ScalingConfig", "FailureConfig", "CheckpointConfig",
                 "RunConfig", "Result"):
        jf = {f.name: f for f in dataclasses.fields(getattr(jax_config, name))}
        pf = {f.name: f for f in dataclasses.fields(getattr(port_config, name))}
        if name == "ScalingConfig":
            assert jf.pop("use_tpu").default is False
            assert pf.pop("use_gpu").default is True
        assert list(pf) == list(jf), name
        for n in jf:
            assert pf[n].default == jf[n].default, (name, n)
    assert port_config.RunConfig(name="x", storage_path="/s").resolve_storage() \
        == jax_config.RunConfig(name="x", storage_path="/s").resolve_storage()
    assert (port_config.FailureConfig().max_failures
            == jax_config.FailureConfig().max_failures)


def test_checkpoint_handle_matches_jax(tmp_path):
    out = {}
    for name, mod in (("jax", jax_ckpt), ("port", port_ckpt)):
        src = tmp_path / name / "src"
        src.mkdir(parents=True)
        (src / "state.json").write_text('{"step": 3}')
        ck = mod.Checkpoint.from_directory(str(src))
        before = ck.get_metadata()
        ck.update_metadata({"step": 3, "who": "x"})
        dest = ck.to_directory(str(tmp_path / name / "dest"))
        with ck.as_directory() as d:
            same = d == ck.path
        out[name] = (before, ck.get_metadata(), sorted(os.listdir(dest)),
                     same, repr(ck).replace(str(tmp_path / name), "<dir>"))
    assert out["port"] == out["jax"]


# -- the checkpoint payload --------------------------------------------------

def test_nested_dict_round_trip_is_bit_exact(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((8, 4)).astype(np.float32),
              "b": {"x": rng.standard_normal(5).astype(np.float32),
                    "y": np.arange(6, dtype=np.int32).reshape(2, 3)}}
    jtree = jax.tree.map(jnp.asarray, arrays)
    jck = jax_ckpt.save_pytree(jtree, str(tmp_path / "jax"), step=7)
    jback = jax.tree.map(np.asarray, jax_ckpt.load_pytree(jck, target=jtree))
    ttree = {"w": torch.from_numpy(arrays["w"]),
             "b": {"x": torch.from_numpy(arrays["b"]["x"]),
                   "y": torch.from_numpy(arrays["b"]["y"])}}
    tck = port_ckpt.save_pytree(ttree, str(tmp_path / "port"), step=7)
    assert tck.get_metadata() == jck.get_metadata() == {"step": 7}
    whole = port_ckpt.load_pytree(tck)
    target = {"w": torch.zeros(8, 4), "b": {"x": torch.zeros(5),
                                            "y": torch.zeros(2, 3, dtype=torch.int32)}}
    inplace = port_ckpt.load_pytree(tck, target=target)
    assert inplace is target
    for got in (whole, inplace):
        for path, want in (("w",), arrays["w"]), (("b", "x"), arrays["b"]["x"]), \
                (("b", "y"), arrays["b"]["y"]):
            t = got
            for k in path:
                t = t[k]
            assert t.device.type == "cpu" and t.dtype == torch.from_numpy(want).dtype
            assert np.array_equal(t.numpy(), want)
            j = jback
            for k in path:
                j = j[k]
            assert np.array_equal(t.numpy(), j)


def _jax_steps(batches):
    """JAX's TINY run: the state after two steps (params, Adam moments,
    count) as numpy, and every step's loss."""
    mesh = jax_build_mesh(JaxMeshConfig(fsdp=-1), devices=jax.devices()[:1])
    init_fn, step_fn = jax_make_train_step(
        JCFG, mesh, optimizer=jax_default_optimizer(**OPT))
    state = init_fn(jax.random.key(0))
    losses, carried = [], None
    for i, tokens in enumerate(batches):
        if i == 2:
            adam = next(s for s in jax.tree.leaves(
                state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState))
            carried = (jax.tree.map(np.asarray, state.params),
                       jax.tree.map(np.asarray, adam.mu),
                       jax.tree.map(np.asarray, adam.nu), int(adam.count))
        state, m = step_fn(state, {"tokens": jnp.asarray(tokens)})
        losses.append(float(m["loss"]))
    return carried, losses


def test_tiny_train_state_saved_loaded_and_stepped_matches_jax(tmp_path):
    """TINY's state after two JAX steps, carried by `jax_bridge`, saved by
    the port and loaded into a fresh state bit for bit: the next two steps'
    losses are JAX's third and fourth at 1e-5."""
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, TCFG.vocab_size, (4, 33), dtype=np.int32)
               for _ in range(4)]
    (params, mu, nu, count), want = _jax_steps(batches)
    init_fn, step_fn = make_train_step(TCFG, device="cpu", optimizer=default_optimizer(
        OPT["lr"], warmup=OPT["warmup"], total_steps=OPT["total_steps"]))
    carried = init_fn(params=params_from_jax(params, TCFG, device="cpu"))
    adam_state_from_jax(carried, mu, nu, count)
    saved = train_state_tree(carried)
    ck = port_ckpt.save_pytree(saved, str(tmp_path / "state"), step=count)
    fresh = init_fn(torch.Generator().manual_seed(1))
    tree = port_ckpt.load_pytree(ck, target=train_state_tree(fresh))
    fresh.step = int(tree["step"])
    assert fresh.step == count == 2 and ck.get_metadata() == {"step": 2}
    flat_saved = _flatten(saved)
    flat_back = _flatten(train_state_tree(fresh))
    assert flat_saved.keys() == flat_back.keys() and len(flat_saved) > 3 * 12
    for k, v in flat_saved.items():
        assert torch.equal(flat_back[k], v), k
    for i in (2, 3):
        fresh, m = step_fn(fresh, {"tokens": batches[i]})
        assert float(m["loss"]) == pytest.approx(want[i], rel=LOSS_REL)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach() if isinstance(v, torch.Tensor) else v
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dtensor_state_round_trip_on_a_world_one_mesh(tmp_path):
    """A TINY train state on a world-1 gloo mesh (params and moments as
    DTensors) saved and loaded in place into a fresh one, bit for bit;
    without a target every tensor comes back whole on the CPU."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel import MeshConfig, build_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = build_mesh(MeshConfig(fsdp=-1), device_type="cpu")
        init_fn, step_fn = make_train_step(TCFG, mesh, optimizer=default_optimizer(
            OPT["lr"], warmup=OPT["warmup"], total_steps=OPT["total_steps"]))
        state = init_fn(torch.Generator().manual_seed(0))
        tokens = np.random.default_rng(0).integers(0, TCFG.vocab_size, (2, 17),
                                                   dtype=np.int32)
        state, _ = step_fn(state, {"tokens": tokens})
        saved = train_state_tree(state)
        assert isinstance(saved["opt"]["0"]["exp_avg"], DTensor)
        ck = port_ckpt.save_pytree(saved, str(tmp_path / "dt"), step=1)
        fresh = init_fn(torch.Generator().manual_seed(5))
        tree = port_ckpt.load_pytree(ck, target=train_state_tree(fresh))
        fresh.step = int(tree["step"])
        whole = _flatten(port_ckpt.load_pytree(ck))
        for k, v in _flatten(saved).items():
            back = _flatten(train_state_tree(fresh))[k]
            full = v.full_tensor() if isinstance(v, DTensor) else v
            assert isinstance(back, DTensor) == isinstance(v, DTensor), k
            assert torch.equal(back.full_tensor() if isinstance(back, DTensor)
                               else back, full), k
            assert not isinstance(whole[k], DTensor) and torch.equal(whole[k], full), k
        a, ma = step_fn(state, {"tokens": tokens})
        b, mb = step_fn(fresh, {"tokens": tokens})
        assert float(ma["loss"]) == float(mb["loss"])
    finally:
        dist.destroy_process_group()


# -- observability -----------------------------------------------------------

class _Clock:
    """One fake clock for `time.perf_counter`, `time.time` and `time.sleep`
    in a module, so both packages see the same timings."""

    def __init__(self):
        self.t = 1000.0

    def now(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _case_phase_math(obs, rec, clock):
    for _ in range(3):
        with obs.step(rec):
            with rec.phase("compute"):
                clock.sleep(0.02)
            with rec.phase("sync"):
                clock.sleep(0.005)
            clock.sleep(0.001)


def _case_implicit_step(obs, rec, clock):
    with rec.phase("compute"):
        clock.sleep(0.01)
    rec.on_report()
    rec.step_start(explicit=True)
    with rec.phase("compute"):
        clock.sleep(0.005)
    rec.on_report()
    rec.step_end()


def _case_persist(obs, rec, clock):
    with obs.step(rec):
        with rec.phase("compute"):
            clock.sleep(0.005)
        rec.observe_persist(0.25)
    rec.observe_persist(0.1)
    rec.on_report()


def _case_phased_iterator(obs, rec, clock):
    def slow():
        for i in range(3):
            clock.sleep(0.01)
            yield i

    assert list(obs.PhasedIterator(slow(), rec)) == [0, 1, 2]
    rec.step_end()


def _case_kill_switch(obs, rec, clock):
    with obs.step(rec):
        with rec.phase("compute"):
            clock.sleep(0.01)
    rec.on_report()
    rec.observe_persist(1.0)
    assert list(obs.PhasedIterator(iter([1, 2]), rec)) == [1, 2]


OBS_CASES = {"phase_math": _case_phase_math, "implicit_step": _case_implicit_step,
             "persist": _case_persist, "phased_iterator": _case_phased_iterator,
             "kill_switch": _case_kill_switch}


@pytest.mark.parametrize("case", list(OBS_CASES))
def test_step_phase_recorder_matches_jax(case, monkeypatch):
    """The recorder cases of test_train_observability.py on injected
    timings: both packages' snapshots are equal."""
    if case == "kill_switch":
        monkeypatch.setenv("RAY_TPU_TRAIN_OBS_ENABLED", "0")
    got = {}
    try:
        for name, obs, reset in (("jax", jax_obs, jax_reset_config),
                                 ("port", port_obs, port_reset_config)):
            reset()
            clock = _Clock()
            monkeypatch.setattr(obs, "time", SimpleNamespace(
                perf_counter=clock.now, time=clock.now, sleep=clock.sleep))
            rec = obs.StepPhaseRecorder(run="t", run_id="t#0", rank=0,
                                        world_size=1)
            rec._trace_steps = 0
            OBS_CASES[case](obs, rec, clock)
            got[name] = (rec.enabled, rec.snapshot())
    finally:
        monkeypatch.delenv("RAY_TPU_TRAIN_OBS_ENABLED", raising=False)
        jax_reset_config()
        port_reset_config()
    assert got["port"] == got["jax"]
    if case == "kill_switch":
        assert got["port"][0] is False and got["port"][1]["steps"] == 0
    else:
        assert got["port"][1]["steps"] >= 1


def _stub_gcs(mod, events):
    gcs = SimpleNamespace(
        event_log=SimpleNamespace(list_events=lambda **kw: events),
        nodes=SimpleNamespace(view=SimpleNamespace(alive_nodes=lambda: [])),
        attribution=SimpleNamespace(shares=lambda: {
            "total": {"handler_s": 0.0}, "component_handler_share": {},
            "slow_handlers": {"total": 0, "recent": [], "budget_ms": 100.0}}),
        loop_audit={},
        task_events=SimpleNamespace(hung_tasks=lambda limit=None: [],
                                    stats=lambda: {}),
        flight=SimpleNamespace(list_events=lambda **kw: []))
    gcs.train_runs = mod.TrainRunState(gcs)
    gcs.metrics = mod.MetricsFederation(gcs)
    return gcs


def _gauge(rank, attempt, *, steps, compute, data_wait=0.0, sync=0.0,
           checkpoint=0.0, other=0.0, window=None, flops=None):
    g = {"rank": rank, "world": 2, "attempt": attempt, "run_id": "exp#0",
         "steps": steps, "compute_s": compute, "data_wait_s": data_wait,
         "sync_s": sync, "checkpoint_s": checkpoint, "other_s": other,
         "step_s": compute + data_wait + sync + checkpoint + other}
    if window:
        g["window_steps"], g["window_step_s"] = window
    if flops:
        g["flops_per_step"] = flops
    return g


def _runs(now):
    """The gauges of test_goodput_split_joins_restart_gaps ("exp"), of
    test_dead_attempt_retained_and_stale_rank_blamed ("dead"), and an
    input-bound run with an MFU hint ("input")."""
    return {
        "exp": {"first_seen": now, "last_seen": now, "ranks": {
            "0@0": {"seen_ts": now, "g": _gauge(
                0, 0, steps=10, compute=6.0, data_wait=2.0, sync=1.0,
                checkpoint=1.0, window=(10, 1.0))},
            "1@0": {"seen_ts": now, "g": _gauge(
                1, 0, steps=10, compute=6.0, data_wait=2.0, sync=1.0,
                checkpoint=1.0, window=(10, 2.0))}}},
        "dead": {"first_seen": now, "last_seen": now, "ranks": {
            "0@0": {"seen_ts": now - 120, "g": _gauge(0, 0, steps=5, compute=5.0)},
            "0@1": {"seen_ts": now, "g": _gauge(
                0, 1, steps=8, compute=8.0, window=(8, 1.0))},
            "1@1": {"seen_ts": now - 30, "g": _gauge(
                1, 1, steps=3, compute=3.0, window=(3, 0.4))}}},
        "input": {"first_seen": now, "last_seen": now, "ranks": {
            "0@0": {"seen_ts": now, "g": _gauge(
                0, 0, steps=4, compute=1.0, data_wait=3.0, window=(4, 4.0),
                flops=2e12)}}},
    }


EVENTS = [{"run": "exp", "gap_s": 2.5, "world": 2},
          {"run": "exp", "gap_s": 0.0, "world": 2},
          {"run": "dead", "gap_s": 40.0, "world": 2},
          {"run": "other", "gap_s": 9.0, "world": 8}]


def test_train_run_summaries_and_doctor_findings_match_jax(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRAIN_OBS_PEAK_FLOPS", "1e13")
    jax_reset_config()
    port_reset_config()
    try:
        now = time.time()
        got = {}
        for name, mod in (("jax", jax_gcs), ("port", port_gcs)):
            gcs = _stub_gcs(mod, EVENTS)
            gcs.train_runs._runs = _runs(now)
            summaries = {run: gcs.train_runs._summarize(run, ent)
                         for run, ent in gcs.train_runs._runs.items()}
            report = gcs.metrics.doctor()
            got[name] = (summaries, [(f["kind"], f["severity"], f.get("run"))
                                     for f in report["findings"]],
                         report["checks"])
    finally:
        monkeypatch.delenv("RAY_TPU_TRAIN_OBS_PEAK_FLOPS")
        jax_reset_config()
        port_reset_config()
    assert got["port"] == got["jax"]
    summaries, findings, _ = got["port"]
    assert summaries["exp"]["restarts"] == 1
    assert summaries["dead"]["skew"]["stale_ranks"] == [1]
    assert summaries["input"]["mfu"] == pytest.approx(2e12 * 1.0 / 1e13)
    assert {k for k, _, _ in findings} >= {"train-input-bound", "train-straggler",
                                           "train-churn-goodput"}


def test_a_run_no_reader_saw_is_retained():
    """A node's syncer pushes carry a run's gauges, then (past the daemon's
    gauge TTL) a push without them. No reader asked in between: the port's
    GCS has folded the run into its retained view as the gauges arrived;
    JAX's folds only when read, and has lost it (printed, not asserted)."""
    got = {}
    for name, pkg in (("jax", "ray_tpu"), ("port", "ray_tpu_torch")):
        sched = importlib.import_module(f"{pkg}.core.distributed.scheduler")
        syncer = importlib.import_module(f"{pkg}.core.distributed.syncer")
        gcs_mod = jax_gcs if name == "jax" else port_gcs
        view = sched.ClusterView()
        view.nodes["n1"] = sched.NodeView(node_id="n1", address="a", total={},
                                          available={})
        gcs = SimpleNamespace(nodes=SimpleNamespace(view=view), metrics=None,
                              event_log=SimpleNamespace(list_events=lambda **kw: []))
        gcs.train_runs = gcs_mod.TrainRunState(gcs)
        cs = syncer.ClusterSyncer(gcs)
        gauges = _gauge(0, 0, steps=3, compute=0.3, window=(3, 0.3))
        assert cs.push_update("n1", 1, full=True,
                              state={"train": {"exp": {"0@0": gauges}}})["ok"]
        assert cs.push_update("n1", 2, base_version=1, state={"train": {}})["ok"]
        got[name] = sorted(gcs.train_runs.summary()["runs"])
    print(f"runs retained: JAX {got['jax']}, port {got['port']}")
    assert got["port"] == ["exp"]


FAILURES = ["ActorDiedError: the actor died unexpectedly",
            "ActorUnavailableError('...')", "node 1a2b died", "the node is dead",
            "worker process exited with code -9", "Killed", "ValueError: boom",
            "", "GetTimeoutError", "RuntimeError: resource unavailable"]


def test_classify_failure_and_backoff_match_jax():
    assert [port_elastic.classify_failure(s) for s in FAILURES] \
        == [jax_elastic.classify_failure(s) for s in FAILURES]
    import random

    for fc in (None, jax_config.FailureConfig(backoff_initial_s=0.2, backoff_max_s=1.0,
                                              backoff_multiplier=3.0,
                                              backoff_jitter=0.5)):
        pfc = None if fc is None else port_config.FailureConfig(
            **dataclasses.asdict(fc))
        j = jax_elastic.RestartBackoff(fc, rng=random.Random(7))
        p = port_elastic.RestartBackoff(pfc, rng=random.Random(7))
        jd = [j.next_delay() for _ in range(8)]
        pd = [p.next_delay() for _ in range(8)]
        j.reset()
        p.reset()
        assert pd + [p.next_delay()] == jd + [j.next_delay()]


NODES = [{"Alive": True, "Available": {"CPU": 3.0, "GPU": 1.0}},
         {"Alive": True, "Available": {"CPU": 1.0, "GPU": 2.0}},
         {"Alive": False, "Available": {"CPU": 8.0, "GPU": 8.0}},
         {"Alive": True, "Available": {"CPU": 0.5}}]


@pytest.mark.parametrize("strategy", ["PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"])
@pytest.mark.parametrize("freed", [0, 1])
def test_feasible_world_matches_jax(strategy, freed, monkeypatch):
    """The supervisor's capacity probe over the same `nodes()` rows (the
    port's rows have JAX's keys) gives the same world, GPU for TPU."""
    got = {}
    for name, pkg, cfg_mod, el, accel in (
            ("jax", ray_tpu, jax_config, jax_elastic, {"use_tpu": True}),
            ("port", ray_tpu_torch, port_config, port_elastic, {"use_gpu": True})):
        rows = [{**n, "Available": {("TPU" if k == "GPU" and name == "jax" else k): v
                                    for k, v in n["Available"].items()}}
                for n in NODES]
        monkeypatch.setattr(pkg, "nodes", lambda rows=rows: rows)
        trainer = SimpleNamespace(
            scaling_config=cfg_mod.ScalingConfig(num_workers=4, placement_strategy=strategy,
                                                 **accel),
            run_config=cfg_mod.RunConfig())
        got[name] = el.ElasticSupervisor(trainer)._feasible_world(freed=freed)
    assert got["port"] == got["jax"]


# -- chaos injectors ---------------------------------------------------------

def _proc_state(pid: int) -> str:
    with open(f"/proc/{pid}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0]


def _wait_state(pid: int, states: str, timeout: float = 10.0) -> str:
    deadline = time.monotonic() + timeout
    while True:
        s = _proc_state(pid)
        if s in states or time.monotonic() > deadline:
            return s
        time.sleep(0.01)


@pytest.mark.parametrize("pkg", [ray_tpu, ray_tpu_torch], ids=["ray_tpu", "ray_tpu_torch"])
def test_chaos_signals_reach_the_rank(pkg, monkeypatch):
    """kill_rank / sigstop_rank / sigcont_rank fan the signal out to every
    live node's daemon (`signal_worker`); here a stub daemon signals the
    pid itself, a child process."""
    chaos = jax_chaos if pkg is ray_tpu else port_chaos
    rpc = sys.modules[f"{pkg.__name__}.core.distributed.rpc"]
    calls = []

    class Client:
        def __init__(self, address, loop):
            self.address = address

        def call(self, service, method, sig, pid, timeout):
            calls.append((self.address, service, method, sig))
            if self.address == "dead-node":
                raise ConnectionError("down")
            os.kill(pid, sig)
            return {"ok": True}

        def close(self):
            pass

    monkeypatch.setattr(rpc, "SyncRpcClient", Client)
    monkeypatch.setattr(pkg.api, "_global_worker",
                        lambda: SimpleNamespace(loop_thread=None))
    monkeypatch.setattr(pkg, "nodes", lambda: [
        {"Alive": False, "Address": "gone"}, {"Alive": True, "Address": "dead-node"},
        {"Alive": True, "Address": "node-a"}])
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        group = SimpleNamespace(pids=[None, child.pid])
        assert chaos.kill_rank(group, 0) is False
        assert chaos.sigstop_rank(group, 1)
        assert _wait_state(child.pid, "Tt") in "Tt"
        assert chaos.sigcont_rank(group, 1)
        assert _wait_state(child.pid, "SR") in "SR"
        assert chaos.kill_rank(group, 1)
        assert child.wait(timeout=10) == -signal.SIGKILL
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert [c[1:] for c in calls] == [
        ("NodeDaemon", "signal_worker", int(s)) for s in
        (signal.SIGSTOP, signal.SIGSTOP, signal.SIGCONT, signal.SIGCONT,
         signal.SIGKILL, signal.SIGKILL)]
    # The node-level injectors act on a cluster_utils cluster (a stub here;
    # tests/test_torch_client.py drives them on real clusters): NodeKiller
    # removes up to max_kills non-head nodes, seeded, and DelayedPartition
    # SIGSTOPs a node's daemon after its delay and SIGCONTs it on heal.
    head = SimpleNamespace(node_id="head")
    cluster = SimpleNamespace(
        head=head, nodes=[head] + [SimpleNamespace(node_id=f"n{i}")
                                   for i in range(4)])
    removed = []

    def remove_node(node):
        cluster.nodes.remove(node)
        removed.append(node.node_id)

    cluster.remove_node = remove_node
    killer = chaos.NodeKiller(cluster, interval_s=0.01, seed=5,
                              max_kills=2).start()
    deadline = time.monotonic() + 10
    while len(killer.kills) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert killer.stop() == removed and len(removed) == 2
    assert "head" not in removed
    rng = __import__("random").Random(5)
    pool = [f"n{i}" for i in range(4)]
    expect = [pool.pop(pool.index(rng.choice(pool))) for _ in range(2)]
    assert removed == expect      # the same seeded choice in both packages
    daemon = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        part = chaos.DelayedPartition(SimpleNamespace(proc=daemon),
                                      delay_s=0.05).start()
        assert part.partitioned.wait(10)
        assert _wait_state(daemon.pid, "Tt") in "Tt"
        part.stop()
        assert not part.partitioned.is_set()
        assert _wait_state(daemon.pid, "SR") in "SR"
    finally:
        daemon.kill()
        daemon.wait()


# -- HF glue -------------------------------------------------------------------

def test_hf_report_callback_matches_jax(tmp_path):
    """test_profiling_hf.py's two callback cases against the port's: outside
    a session `on_log` is a no-op; inside one it reports the numeric logs
    with the step and epoch."""
    pytest.importorskip("transformers")
    from ray_tpu.train import huggingface as jax_hf
    from ray_tpu.train import session as jax_session
    from ray_tpu_torch.train import huggingface as port_hf
    from ray_tpu_torch.train import session as port_session

    class FakeState:
        global_step = 7
        epoch = 2.0

    got = {}
    for name, hf, sess in (("jax", jax_hf, jax_session),
                           ("port", port_hf, port_session)):
        hf.RayTrainReportCallback().on_log(None, FakeState(), None, logs={"loss": 0.5})
        s = sess.TrainSession(world_rank=0, world_size=1, local_rank=0,
                              trial_dir=str(tmp_path / name), latest_checkpoint=None,
                              experiment_name="hf")
        sess.install_session(s)
        try:
            hf.RayTrainReportCallback().on_log(
                None, FakeState(), None, logs={"loss": 0.25, "ignored": "str"})
            got[name] = s.results.get_nowait()
            assert s.results.empty()
        finally:
            sess.uninstall_session()
    assert got["port"] == got["jax"] == {
        "metrics": {"loss": 0.25, "step": 7, "epoch": 2.0}, "checkpoint": None}
    assert issubclass(port_hf.RayTrainReportCallback,
                      sys.modules["transformers.trainer_callback"].TrainerCallback)
