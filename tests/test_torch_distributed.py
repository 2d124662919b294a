"""The port's sharded train step and tensor-parallel engine on four gloo
processes against JAX's on four devices of its CPU mesh.

One module-scoped pool of four spawned ranks (`torch_dist_worker.py`)
serves every case; each case sends the same inputs (JAX-drawn params,
numpy batches) to both sides and compares: loss and grad norm to 1e-5,
params after 3 steps to atol 1e-4 (as `test_torch_training.py`), shard
shapes exactly, Adafactor's updates to rtol 1e-5, collectives exactly,
MoE's load-balance loss to 1e-5, an engine's greedy tokens exactly and
its first logits to 1e-5 (against JAX's single-device engine).
"""
import dataclasses
import multiprocessing
import os
import queue
import socket
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import forward as jax_forward
from ray_tpu.models.decoding import init_cache as jax_init_cache
from ray_tpu.models.decoding import prefill as jax_prefill
from ray_tpu.models.training import TrainState as JaxTrainState
from ray_tpu.models.training import default_optimizer as jax_default_optimizer
from ray_tpu.models.training import make_train_step as jax_make_train_step
from ray_tpu.models.transformer import param_logical_axes
from ray_tpu.parallel import MeshConfig, build_mesh, collectives as jcol
from ray_tpu.parallel.sharding import (
    DDP_RULES, DEFAULT_RULES, param_shardings as jax_param_shardings)
from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
from ray_tpu_torch.models import configs, init_params
from ray_tpu_torch.models.jax_bridge import params_to_numpy
from ray_tpu_torch.models.transformer import param_shapes
from test_torch_parallel import adafactor_case, check_adafactor

WORLD = 4
TIMEOUT_S = 120
JCFG = dataclasses.replace(jax_configs.TINY, compute_dtype=jnp.float32)
TCFG = dataclasses.replace(configs.TINY, compute_dtype=torch.float32)
OPT = dict(kind="adamw", lr=1e-2, warmup=2, total_steps=10)
JCFGS = {"tiny": JCFG,
         "tiny_moe": dataclasses.replace(jax_configs.TINY_MOE, compute_dtype=jnp.float32)}
TCFGS = {"tiny": TCFG,
         "tiny_moe": dataclasses.replace(configs.TINY_MOE, compute_dtype=torch.float32)}
# tests/test_moe.py's optimizer for its expert-parallel step.
OPT_MOE = dict(kind="adamw", lr=1e-2, warmup=1, total_steps=20)
JAX_RULES = {"default": DEFAULT_RULES, "ddp": DDP_RULES}


class Ranks:
    """The four ranks: `send` gives one case to all, `results` returns
    their results in rank order. A rank that fails leaves the others in a
    collective, so the first failure ends the pool and later cases fail at
    once."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.inboxes = [ctx.Queue() for _ in range(WORLD)]
        self.outbox = ctx.Queue()
        here = os.path.dirname(os.path.abspath(__file__))
        if here not in sys.path:
            sys.path.insert(0, here)
        import torch_dist_worker

        self.procs = [ctx.Process(target=torch_dist_worker.main,
                                  args=(r, WORLD, port, self.inboxes[r], self.outbox),
                                  daemon=True) for r in range(WORLD)]
        for p in self.procs:
            p.start()

    def send(self, name: str, **kwargs) -> None:
        assert all(p.is_alive() for p in self.procs), "the ranks have stopped"
        for box in self.inboxes:
            box.put((name, kwargs))

    def results(self) -> list:
        out = [None] * WORLD
        try:
            for _ in range(WORLD):
                try:
                    rank, ok, result = self.outbox.get(timeout=TIMEOUT_S)
                except queue.Empty:
                    raise AssertionError(f"a rank gave no result in {TIMEOUT_S} s")
                assert ok, f"rank {rank}:\n{result}"
                out[rank] = result
        except AssertionError:
            self.kill()
            raise
        return out

    def kill(self) -> None:
        for p in self.procs:
            p.kill()
            p.join(timeout=10)
        # A message a killed rank never read must not hold this process at
        # exit, where a queue joins its feeder thread.
        for box in self.inboxes:
            box.cancel_join_thread()

    def close(self) -> None:
        for box in self.inboxes:
            box.put(None)
        deadline = time.monotonic() + 30   # for all the ranks, not each
        for p in self.procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        if any(p.is_alive() for p in self.procs):
            self.kill()
            raise AssertionError("a rank did not stop")


@pytest.fixture(scope="module")
def ranks():
    pool = Ranks()
    yield pool
    pool.close()


def _jax_mesh(sizes: dict):
    return build_mesh(MeshConfig(**{"fsdp": 1, **sizes}), devices=jax.devices()[:WORLD])


def _batches(n, b=8, t=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, JCFG.vocab_size, (b, t + 1), dtype=np.int32)
            for _ in range(n)]


def _start_params(cfg_name="tiny"):
    """The config's params at JAX's init scales, as numpy (the port's
    init_params from seed 0; both sides then start from them)."""
    return params_to_numpy(init_params(TCFGS[cfg_name], torch.Generator().manual_seed(0),
                                       device="cpu"))


def _jax_train(sizes, rules, start, batches, sp_attention="ring", cfg_name="tiny",
               opt=OPT):
    """JAX's sharded step from `start`, laid out as its init_fn lays params
    out; the opt state's scalars are replicated as the step returns them,
    so its second call does not compile again."""
    mesh = _jax_mesh(sizes)
    cfg = dataclasses.replace(JCFGS[cfg_name], sp_attention=sp_attention)
    optimizer = optax.adafactor(learning_rate=opt["lr"]) if opt["kind"] == "adafactor" \
        else jax_default_optimizer(opt["lr"], warmup=opt["warmup"],
                                   total_steps=opt["total_steps"])
    _, step_fn = jax_make_train_step(cfg, mesh, rules=JAX_RULES[rules],
                                     optimizer=optimizer)
    params = jax.device_put(start, jax_param_shardings(
        param_logical_axes(cfg), mesh, JAX_RULES[rules]))
    replicated = NamedSharding(mesh, P())
    opt_state = jax.tree.map(lambda x: jax.device_put(x, replicated) if x.ndim == 0
                             else x, optimizer.init(params))
    state = JaxTrainState(step=jax.device_put(jnp.zeros((), jnp.int32), replicated),
                          params=params, opt_state=opt_state)
    metrics = []
    for tokens in batches:
        state, m = step_fn(state, {"tokens": jnp.asarray(tokens)})
        metrics.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    return metrics, jax.device_get(state.params)


def _check_train(ranks, sizes, rules, feed=False, sp_attention="ring", cfg_name="tiny",
                 opt=OPT):
    """Three AdamW steps on both sides (the ranks run while JAX does);
    returns the ranks' results, the batches and the start params."""
    batches, start = _batches(3), _start_params(cfg_name)
    ranks.send("train", sizes=sizes, rules=rules, start=start, batches=batches,
               opt=opt, feed=feed, sp_attention=sp_attention, cfg_name=cfg_name)
    want, want_params = _jax_train(sizes, rules, start, batches, sp_attention,
                                   cfg_name, opt)
    results = ranks.results()
    for res in results:
        for got, exp in zip(res["metrics"], want):
            assert got["loss"] == pytest.approx(exp["loss"], rel=1e-5)
            assert got["grad_norm"] == pytest.approx(exp["grad_norm"], rel=1e-5)
    moved = 0.0
    for a, b, s in zip(jax.tree.leaves(results[0]["params"]), jax.tree.leaves(want_params),
                       jax.tree.leaves(start)):
        np.testing.assert_allclose(a, b, atol=1e-4)
        moved = max(moved, float(np.abs(a - s).max()))
    assert moved > 1e-2  # the steps did change the params
    return results, batches, start


def test_fsdp2_tp2_default_rules_match_jax(ranks):
    _check_train(ranks, {"fsdp": 2, "tp": 2}, "default")


@pytest.mark.parametrize("rules", ["ddp", "default"])
def test_fsdp4_matches_jax_under_ddp_and_default_rules(ranks, rules):
    _check_train(ranks, {"fsdp": 4}, rules)


def test_dp2_fsdp2_fed_by_torch_feed_matches_jax(ranks):
    """dp 2 x fsdp 2, the batches through `torch_feed`: every rank gets the
    rows JAX's P(("dp", "fsdp")) gives the device at its mesh position."""
    sizes = {"dp": 2, "fsdp": 2}
    results, batches, _ = _check_train(ranks, sizes, "default", feed=True)
    sharding = NamedSharding(_jax_mesh(sizes), P(("dp", "fsdp")))
    index = sharding.devices_indices_map(batches[0].shape)
    for rank, res in enumerate(results):
        for fed, batch in zip(res["fed_rows"], batches):
            np.testing.assert_array_equal(fed, batch[index[jax.devices()[rank]]])


def test_fsdp2_sp2_ring_fed_by_torch_feed_matches_jax(ranks):
    """fsdp 2 x sp 2, ring attention: the feed gives each rank its rows
    whole (a DTensor over dp/fsdp, replicated over sp), and the step cuts
    inputs and targets from them before taking its sp share of the
    positions; loss, grad norm and params as JAX's global-view step."""
    results, batches, _ = _check_train(ranks, {"fsdp": 2, "sp": 2}, "default", feed=True,
                                       sp_attention="ring")
    for rank, res in enumerate(results):
        for fed, batch in zip(res["fed_rows"], batches):
            rows = batch.shape[0] // 2
            np.testing.assert_array_equal(fed, batch[rank // 2 * rows:(rank // 2 + 1) * rows])


def test_sp2_tp2_ulysses_matches_jax(ranks):
    """sp 2 x tp 2, Ulysses over this rank's tp heads (4/2 heads: 2 q and,
    repeated, 2 kv heads a rank, split again over sp)."""
    _check_train(ranks, {"sp": 2, "tp": 2}, "default", sp_attention="ulysses")


@pytest.mark.parametrize("sizes", [{"fsdp": 2, "tp": 2}, {"dp": 2, "fsdp": 2}],
                         ids=["fsdp2_tp2", "dp2_fsdp2"])
def test_local_shard_shapes_match_jax(ranks, sizes):
    """Each rank's local shape of wq, embed and w_down, and the port's
    NamedSharding.shard_shape, equal JAX's shard_shape on the same layout."""
    ranks.send("shapes", sizes=sizes, rules="default")
    shardings = jax_param_shardings(param_logical_axes(JCFG), _jax_mesh(sizes),
                                    DEFAULT_RULES)
    shapes = param_shapes(TCFG)
    want = {"embed": shardings["embed"].shard_shape(shapes["embed"])}
    for name in ("wq", "w_down"):
        want[name] = shardings["blocks"][name].shard_shape(shapes["blocks"][name])
    for res in ranks.results():
        assert res == {"local": want, "shard_shape": want}


@pytest.mark.parametrize("lr", [1e-4, 1e-1])
def test_adafactor_under_fsdp2_tp2_matches_optax(ranks, lr):
    """`test_torch_parallel.py`'s Adafactor case with every leaf split by
    DEFAULT_RULES over fsdp 2 x tp 2: the row and column means and both
    RMS values span the shards."""
    params, logical, grads, want = adafactor_case(lr)
    ranks.send("adafactor", sizes={"fsdp": 2, "tp": 2}, rules="default",
               params=params, logical=logical, grads=grads, lr=lr)
    for res in ranks.results():
        check_adafactor(res, want, params)


def test_collectives_match_jax_shard_map(ranks):
    """psum, pmean, all_gather, psum_scatter, all_to_all and ppermute_ring
    over tp of a (fsdp 2, tp 2) mesh: rank r holds rows [4r, 4r + 4)."""
    sizes = {"fsdp": 2, "tp": 2}
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3) ** 1.5
    ops = {
        "psum": lambda v: jcol.psum(v, "tp"),
        "pmean": lambda v: jcol.pmean(v, "tp"),
        "all_gather": lambda v: jcol.all_gather(v, "tp"),
        "psum_scatter": lambda v: jcol.psum_scatter(v, "tp"),
        "all_to_all": lambda v: jcol.all_to_all(v, "tp", split_dim=0, concat_dim=1),
        "ppermute_ring": lambda v: jcol.ppermute_ring(v, "tp"),
    }
    ranks.send("collectives", sizes=sizes, axis="tp", x=x)
    mesh = _jax_mesh(sizes)
    spec = P(("dp", "fsdp", "ep", "sp", "tp"))
    results = ranks.results()
    for name, op in ops.items():
        want = np.asarray(jax.shard_map(op, mesh=mesh, in_specs=spec, out_specs=spec,
                                        check_vma=False)(jnp.asarray(x)))
        got = np.concatenate([r[name] for r in results])
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    assert [r["axis_index"] for r in results] == [0, 1, 0, 1]


def test_layouts_not_ported_yet_raise(ranks):
    """What now runs and what still raises: a dense model on an ep mesh and
    MoE under a data split build their steps; heads that tp, or experts
    that ep, does not divide raise ValueError; MoE in the pipeline raises
    NotImplementedError, as JAX's does."""
    ranks.send("errors")
    for res in ranks.results():
        assert res == {"ep": "no error", "moe": "no error", "heads": "ValueError",
                       "experts": "ValueError", "pipeline_moe": "NotImplementedError"}


# --- MoE under every split ---------------------------------------------------

@pytest.mark.parametrize("sizes", [{"ep": 4}, {"fsdp": 2, "ep": 2}, {"dp": 2, "tp": 2},
                                   {"fsdp": 2, "sp": 2}],
                         ids=["ep4", "fsdp2_ep2", "dp2_tp2", "fsdp2_sp2_ring"])
def test_tiny_moe_train_steps_match_jax(ranks, sizes):
    """Three steps of TINY_MOE (4 experts, top 2) with tests/test_moe.py's
    optimizer, as JAX's sharded step takes them: one routing group over
    the global batch whatever splits it (its capacity, queue order and
    auxiliary means); each rank's w_gate holds E/ep experts; the first
    batch's load-balance and z losses are JAX's global ones."""
    results, batches, start = _check_train(ranks, sizes, "default", cfg_name="tiny_moe",
                                           opt=OPT_MOE)
    jcfg = JCFGS["tiny_moe"]
    aux = {}
    jax_forward(jax.tree.map(jnp.asarray, start), jnp.asarray(batches[0][:, :-1]), jcfg,
                return_aux=aux)
    assert set(aux) == {"moe_load_balance_loss", "moe_z_loss"}
    for res in results:
        assert res["w_gate"][1] == jcfg.n_experts // sizes.get("ep", 1)
        for name, want in aux.items():
            assert res["aux"][name] == pytest.approx(float(want), rel=1e-5)


def test_tiny_moe_adafactor_steps_under_fsdp2_ep2_match_jax(ranks):
    """The same steps with Adafactor(1e-2) (optax.adafactor): its RMS
    statistics of the expert weights span their ep shards."""
    _check_train(ranks, {"fsdp": 2, "ep": 2}, "default", cfg_name="tiny_moe",
                 opt=dict(kind="adafactor", lr=1e-2))


# --- tensor-parallel serving -------------------------------------------------

def _jax_engine(cfg_name, start, prompts, max_tokens, **kw):
    """JAX's single-device LLMEngine: each prompt's greedy tokens, one
    request at a time, and its stats."""
    eng = JaxLLMEngine(JCFGS[cfg_name], jax.tree.map(jnp.asarray, start), num_slots=2,
                       max_len=64, prefill_buckets=(16,), **kw)
    try:
        return [eng.generate(p, max_tokens=max_tokens) for p in prompts], eng.stats
    finally:
        eng.shutdown()


@pytest.mark.parametrize("cfg_name,sizes", [("tiny", {"dp": 2, "tp": 2}),
                                            ("tiny_moe", {"tp": 4})],
                         ids=["tiny_dp2_tp2", "tiny_moe_tp4"])
def test_tp_engine_matches_jax_single_device_engine(ranks, cfg_name, sizes):
    """tests/test_llm.py's tensor-parallel case: `LLMEngine(mesh=...)` with
    weights and cache split over tp gives the greedy tokens of JAX's
    single-device engine on every rank (dp ranks are replicas), and
    `prefill`'s logits through the same shards are JAX's within 1e-5."""
    start, prompts = _start_params(cfg_name), [[4, 5, 6, 7], [9, 1, 2, 8, 8]]
    ranks.send("tp_serve", sizes=sizes, cfg_name=cfg_name, start=start, prompts=prompts,
               max_tokens=10, first=prompts[0])
    want, _ = _jax_engine(cfg_name, start, prompts, 10, prefix_cache_size=0)
    jcfg, tp = JCFGS[cfg_name], sizes["tp"]
    padded = np.zeros((1, 16), np.int32)
    padded[0, :4] = prompts[0]
    _, want_logits = jax_prefill(jax.tree.map(jnp.asarray, start),
                                 jax_init_cache(jcfg, 1, 64), jnp.asarray(padded),
                                 jnp.int32(0), jnp.int32(4), jcfg)
    for res in ranks.results():
        assert res["tokens"] == want
        np.testing.assert_allclose(res["first_logits"], np.asarray(want_logits), atol=1e-5)
        assert res["wq"][2] == jcfg.n_heads * jcfg.head_dim // tp
        assert res["cache_k"][3] == jcfg.n_kv_heads // tp


def test_tp_engine_prefix_cache_and_speculation_match_jax(ranks):
    """Prefix cache and prompt-lookup speculation under a dp 2 x tp 2 mesh:
    a repeated prompt is a prefix hit, and both answers equal JAX's
    single-device engine's with the same options."""
    start, rep = _start_params(), [1, 2, 3, 1, 2, 3, 1, 2]
    kw = dict(prefix_cache_size=2, speculation_k=4)
    ranks.send("tp_serve", sizes={"dp": 2, "tp": 2}, cfg_name="tiny", start=start,
               prompts=[rep, rep], max_tokens=8, **kw)
    want, want_stats = _jax_engine("tiny", start, [rep, rep], 8, **kw)
    assert want[0] == want[1] and want_stats["prefix_hits"] == 1
    for res in ranks.results():
        assert res["tokens"] == want
        assert res["stats"]["prefix_hits"] == 1
        assert res["stats"]["spec_proposed"] == want_stats["spec_proposed"]


def test_tp_engine_raises_jax_error_for_indivisible_tp_and_dryrun_runs(ranks):
    """TINY's 2 kv heads do not split over tp 4: every rank raises JAX's
    ValueError, message and all. `dryrun_tp_serving` runs at tp 2 over the
    first two ranks (the others return at once)."""
    start = _start_params()
    ranks.send("tp_serve", sizes={"tp": 4}, cfg_name="tiny", start=start, prompts=[],
               max_tokens=1)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("tp",))
    with pytest.raises(ValueError, match="does not divide") as jax_error:
        JaxLLMEngine(JCFG, jax.tree.map(jnp.asarray, start), num_slots=2, max_len=64,
                     prefill_buckets=(16,), mesh=mesh)
    for res in ranks.results():
        assert res == {"error": str(jax_error.value)}
    ranks.send("tp_dryrun", tp=2)
    assert ranks.results() == ["ran"] * WORLD
