"""The port's sharded train step on four gloo processes against JAX's on
four devices of its CPU mesh.

One module-scoped pool of four spawned ranks (`torch_dist_worker.py`)
serves every case; each case sends the same inputs (JAX-drawn params,
numpy batches) to both sides and compares: loss and grad norm to 1e-5,
params after 3 steps to atol 1e-4 (as `test_torch_training.py`), shard
shapes exactly, Adafactor's updates to rtol 1e-5, collectives exactly.
"""
import dataclasses
import multiprocessing
import os
import queue
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu.models import configs as jax_configs
from ray_tpu.models.training import TrainState as JaxTrainState
from ray_tpu.models.training import default_optimizer as jax_default_optimizer
from ray_tpu.models.training import make_train_step as jax_make_train_step
from ray_tpu.models.transformer import param_logical_axes
from ray_tpu.parallel import MeshConfig, build_mesh, collectives as jcol
from ray_tpu.parallel.sharding import (
    DDP_RULES, DEFAULT_RULES, param_shardings as jax_param_shardings)
from ray_tpu_torch.models import configs, init_params
from ray_tpu_torch.models.jax_bridge import params_to_numpy
from ray_tpu_torch.models.transformer import param_shapes
from test_torch_parallel import adafactor_case, check_adafactor

WORLD = 4
TIMEOUT_S = 120
JCFG = dataclasses.replace(jax_configs.TINY, compute_dtype=jnp.float32)
TCFG = dataclasses.replace(configs.TINY, compute_dtype=torch.float32)
OPT = dict(kind="adamw", lr=1e-2, warmup=2, total_steps=10)
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

    def close(self) -> None:
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=30)
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


def _start_params():
    """TINY's params at JAX's init scales, as numpy (the port's init_params
    from seed 0; both sides then start from them)."""
    return params_to_numpy(init_params(TCFG, torch.Generator().manual_seed(0),
                                       device="cpu"))


def _jax_train(sizes, rules, start, batches):
    """JAX's sharded step from `start`, laid out as its init_fn lays params
    out; the opt state's scalars are replicated as the step returns them,
    so its second call does not compile again."""
    mesh = _jax_mesh(sizes)
    optimizer = jax_default_optimizer(OPT["lr"], warmup=OPT["warmup"],
                                      total_steps=OPT["total_steps"])
    _, step_fn = jax_make_train_step(JCFG, mesh, rules=JAX_RULES[rules],
                                     optimizer=optimizer)
    params = jax.device_put(start, jax_param_shardings(
        param_logical_axes(JCFG), mesh, JAX_RULES[rules]))
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


def _check_train(ranks, sizes, rules, feed=False):
    """Three AdamW steps on both sides (the ranks run while JAX does);
    returns the ranks' results and the batches."""
    batches, start = _batches(3), _start_params()
    ranks.send("train", sizes=sizes, rules=rules, start=start, batches=batches,
               opt=OPT, feed=feed)
    want, want_params = _jax_train(sizes, rules, start, batches)
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
    return results, batches


def test_fsdp2_tp2_default_rules_match_jax(ranks):
    _check_train(ranks, {"fsdp": 2, "tp": 2}, "default")


@pytest.mark.parametrize("rules", ["ddp", "default"])
def test_fsdp4_matches_jax_under_ddp_and_default_rules(ranks, rules):
    _check_train(ranks, {"fsdp": 4}, rules)


def test_dp2_fsdp2_fed_by_torch_feed_matches_jax(ranks):
    """dp 2 x fsdp 2, the batches through `torch_feed`: every rank gets the
    rows JAX's P(("dp", "fsdp")) gives the device at its mesh position."""
    sizes = {"dp": 2, "fsdp": 2}
    results, batches = _check_train(ranks, sizes, "default", feed=True)
    sharding = NamedSharding(_jax_mesh(sizes), P(("dp", "fsdp")))
    index = sharding.devices_indices_map(batches[0].shape)
    for rank, res in enumerate(results):
        for fed, batch in zip(res["fed_rows"], batches):
            np.testing.assert_array_equal(fed, batch[index[jax.devices()[rank]]])


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
    """sp and ep meshes and MoE under a data split raise NotImplementedError
    naming their ROADMAP item; heads that tp does not divide, ValueError."""
    ranks.send("errors")
    for res in ranks.results():
        assert res == {"sp": "NotImplementedError: item 7",
                       "ep": "NotImplementedError: item 12",
                       "moe": "NotImplementedError: item 12",
                       "heads": "ValueError"}
