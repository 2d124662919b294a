"""ray_tpu_torch train step against the JAX package, on the CPU.

Five steps of `make_train_step` on TINY at fp32 compute, from the same
JAX-drawn weights and the same numpy batches, against JAX's jitted step on
a one-device mesh, and three on TINY_MOE; plus the schedule, clipping and
AdamW update on their own against optax.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import configs as jax_configs
from ray_tpu.models.training import default_optimizer as jax_default_optimizer
from ray_tpu.models.training import make_eval_step as jax_make_eval_step
from ray_tpu.models.training import make_train_step as jax_make_train_step
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu_torch.models import configs
from ray_tpu_torch.models.jax_bridge import params_from_jax, params_to_numpy
from ray_tpu_torch.models.training import (
    clip_by_global_norm_, default_optimizer, make_eval_step, make_train_step,
    tree_leaves)

OPT = dict(lr=1e-2, warmup=2, total_steps=10)
JCFG = dataclasses.replace(jax_configs.TINY, compute_dtype=jnp.float32)
TCFG = dataclasses.replace(configs.TINY, compute_dtype=torch.float32)


def _batches(n, b=4, t=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TCFG.vocab_size, (b, t + 1), dtype=np.int32)
            for _ in range(n)]


def _jax_run(batches):
    mesh = build_mesh(MeshConfig(fsdp=-1), devices=jax.devices()[:1])
    init_fn, step_fn = jax_make_train_step(
        JCFG, mesh, optimizer=jax_default_optimizer(OPT["lr"], warmup=OPT["warmup"],
                                                    total_steps=OPT["total_steps"]))
    state = init_fn(jax.random.key(0))
    start = jax.tree.map(np.asarray, state.params)
    metrics = []
    for tokens in batches:
        state, m = step_fn(state, {"tokens": jnp.asarray(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    return start, metrics, jax.tree.map(np.asarray, state.params)


def test_five_steps_match_jax():
    batches = _batches(5)
    start, want, want_params = _jax_run(batches)

    init_fn, step_fn = make_train_step(
        TCFG, device="cpu",
        optimizer=default_optimizer(OPT["lr"], warmup=OPT["warmup"],
                                    total_steps=OPT["total_steps"]))
    state = init_fn(params=params_from_jax(start, TCFG, device="cpu"))
    for i, tokens in enumerate(batches):
        state, m = step_fn(state, {"tokens": tokens})
        assert m["step"] == want[i]["step"] == i + 1
        assert float(m["loss"]) == pytest.approx(want[i]["loss"], rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(want[i]["grad_norm"], rel=1e-4)
    # Adam divides by sqrt(v) + 1e-8, so for a grad entry near zero the
    # fp32 rounding differences of the two frameworks become update
    # differences far above the grads' own; after 5 steps at lr 1e-2 they
    # reach ~2.4e-5, held here at 1e-4.
    got = params_to_numpy(state.params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(a, b, atol=1e-4)
    moved = max(float(np.abs(a - b).max()) for a, b in
                zip(jax.tree.leaves(got), jax.tree.leaves(start)))
    assert moved > 1e-2  # the steps did change the params


@pytest.mark.parametrize("kw", [dict(lr=3e-4, warmup=10, total_steps=1000),
                                dict(lr=1e-2, warmup=2, total_steps=10),
                                dict(lr=1e-3, warmup=5, total_steps=3)])
def test_schedule_matches_optax(kw):
    ours = default_optimizer(kw["lr"], warmup=kw["warmup"],
                             total_steps=kw["total_steps"])
    sched = optax.warmup_cosine_decay_schedule(
        0.0, kw["lr"], kw["warmup"], max(kw["total_steps"], kw["warmup"] + 1),
        kw["lr"] * 0.1)
    steps = [0, 1, kw["warmup"], (kw["warmup"] + kw["total_steps"]) // 2,
             kw["total_steps"], kw["total_steps"] + 50]
    for count in steps:
        assert ours.learning_rate(count) == pytest.approx(float(sched(count)),
                                                          rel=1e-6, abs=1e-12)
    assert ours.learning_rate(0) == 0.0


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clipping_matches_optax(scale):
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32) * scale
             for s in [(3, 4), (5,), (2, 2, 2)]]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    tgrads = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(tgrads, 1.0)
    assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
    clipped = float(optax.global_norm(want))
    assert clipped == pytest.approx(1.0 if scale > 1 else float(norm), rel=1e-5)
    for a, b in zip(tgrads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_adamw_updates_match_optax():
    """Three updates of the full chain on fixed grads, every param decayed."""
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                          params) for _ in range(3)]
    tx = jax_default_optimizer(0.1, warmup=1, total_steps=5)
    jp, state = params, tx.init(params)
    ours = default_optimizer(0.1, warmup=1, total_steps=5)
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()).requires_grad_(), params)
    leaves = tree_leaves(tp)
    opt = ours.init(leaves)
    for count, g in enumerate(grads):
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for w, gw in zip(leaves, tree_leaves(g)):
            w.grad = torch.from_numpy(gw.copy())
        ours.update(opt, leaves, count)
    for a, b in zip(leaves, tree_leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5, atol=1e-6)


def test_eval_step_matches_jax():
    mesh = build_mesh(MeshConfig(fsdp=-1), devices=jax.devices()[:1])
    jparams = jax.tree.map(np.asarray, jax_make_train_step(JCFG, mesh)[0](
        jax.random.key(3)).params)
    tokens = _batches(1, seed=4)[0]
    want = float(jax_make_eval_step(JCFG, mesh)(jparams, {"tokens": jnp.asarray(tokens)}))
    got = make_eval_step(TCFG, device="cpu")(
        params_from_jax(jparams, TCFG, device="cpu"), {"tokens": tokens})
    assert not got.requires_grad
    assert float(got) == pytest.approx(want, rel=1e-5)


def test_three_moe_train_steps_match_jax():
    """TINY_MOE (4 experts, top 2): the loss, its grad norm and the clipped
    update carry the auxiliary losses as JAX's step does; held as the dense
    steps above."""
    jcfg = dataclasses.replace(jax_configs.TINY_MOE, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.TINY_MOE, compute_dtype=torch.float32)
    opt = dict(lr=1e-2, warmup=1, total_steps=10)
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, tcfg.vocab_size, (4, 33), dtype=np.int32)
               for _ in range(3)]
    mesh = build_mesh(MeshConfig(fsdp=-1), devices=jax.devices()[:1])
    jinit, jstep = jax_make_train_step(
        jcfg, mesh, optimizer=jax_default_optimizer(
            opt["lr"], warmup=opt["warmup"], total_steps=opt["total_steps"]))
    jstate = jinit(jax.random.key(0))
    start = jax.tree.map(np.asarray, jstate.params)
    tinit, tstep = make_train_step(
        tcfg, device="cpu", optimizer=default_optimizer(
            opt["lr"], warmup=opt["warmup"], total_steps=opt["total_steps"]))
    tstate = tinit(params=params_from_jax(start, tcfg, device="cpu"))
    for i, tokens in enumerate(batches):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, tm = tstep(tstate, {"tokens": tokens})
        assert tm["step"] == int(jm["step"]) == i + 1
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-4)
    got = params_to_numpy(tstate.params)
    want = jax.tree.map(np.asarray, jstate.params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, atol=1e-4)
    moved = max(float(np.abs(a - b).max()) for a, b in
                zip(jax.tree.leaves(got), jax.tree.leaves(start)))
    assert moved > 1e-2
