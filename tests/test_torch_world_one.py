"""The sequence-parallel, pipeline, expert-parallel and tensor-parallel
serving paths on a world-1 gloo group in this process (what the card runs
at world 1), the optimizers the pipeline uses and the differentiable
all_gather, against the JAX package and the port's own plain path.

Each test that starts a group destroys it (the `world` fixture). Inputs
are numpy from a seed; fp32 throughout: losses 1e-5 relative, grads and
params 1e-4 (the port's plain path: 1e-6), optimizer updates as optax's
to rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from ray_tpu.models import configs as jax_configs
from ray_tpu.parallel import pipeline as jax_pipeline
from ray_tpu_torch.models import configs, forward, init_params, loss_fn
from ray_tpu_torch.models.jax_bridge import params_from_jax, params_to_numpy
from ray_tpu_torch.models.training import (
    SGD, AdamW, default_optimizer, make_train_step, tree_leaves)
from ray_tpu_torch.ops import flash_attention, ring_attention, ulysses_attention
from ray_tpu_torch.ops.attention import mha_reference
from ray_tpu_torch.parallel import MeshConfig, build_mesh, collectives
from ray_tpu_torch.serve import LLMEngine
from ray_tpu_torch.parallel.pipeline import (
    build_pipeline_mesh, make_pipeline_loss, make_pipeline_train_step, pipeline_shardings)

CFG = dataclasses.replace(configs.TINY, compute_dtype=torch.float32)
JCFG = dataclasses.replace(jax_configs.TINY, compute_dtype=jnp.float32)


@pytest.fixture
def world():
    """The world-1 group a mesh starts; destroyed whatever the test did."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _tokens(seed=0, b=4, t=33):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, t), dtype=np.int32)


def _start(cfg=CFG):
    return params_to_numpy(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))


def _with_grads(tree: dict) -> dict:
    for w in tree_leaves(tree):
        w.requires_grad_()
    return tree


def _grads(tree: dict) -> list[np.ndarray]:
    """The grads of a param tree, whole, in jax.tree.leaves' order."""
    return jax.tree.leaves(params_to_numpy(
        {k: ({n: w.grad for n, w in v.items()} if isinstance(v, dict) else v.grad)
         for k, v in tree.items()}))


@pytest.mark.parametrize("scheme", [ring_attention, ulysses_attention],
                         ids=["ring", "ulysses"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_context_parallel_at_sp_one_is_flash_attention(scheme, causal, world):
    """Over an sp axis of one rank Ulysses' all-to-alls are the identity,
    so it equals flash_attention bit for bit (output and grads); ring's
    one block is the plain softmax, within 1e-5 of mha_reference."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 32, 4, 16), dtype=np.float32))
                   for _ in range(4))
    mesh = build_mesh(MeshConfig(fsdp=1, sp=1), device_type="cpu")
    runs = {}
    for name, fn in (("scheme", lambda a, b, c: scheme(a, b, c, mesh=mesh, causal=causal)),
                     ("flash", lambda a, b, c: flash_attention(a, b, c, causal)),
                     ("reference", lambda a, b, c: mha_reference(a, b, c, causal=causal))):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        (out * do).sum().backward()
        runs[name] = [out.detach()] + [x.grad for x in leaves]
    if scheme is ulysses_attention:
        for got, want in zip(runs["scheme"], runs["flash"]):
            assert torch.equal(got, want)
    for got, want in zip(runs["scheme"], runs["reference"]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_sequence_parallel_config_errors(world):
    """seq_shards > 1 needs a mesh and a known sp_attention, as in JAX."""
    tokens = torch.from_numpy(_tokens(t=16))
    params = init_params(CFG, device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        forward(params, tokens, CFG, seq_shards=2)
    mesh = build_mesh(MeshConfig(fsdp=1, sp=1), device_type="cpu")
    with pytest.raises(ValueError, match="sp_attention='rings'"):
        forward(params, tokens, dataclasses.replace(CFG, sp_attention="rings"),
                mesh=mesh, seq_shards=2)


@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_train_step_with_seq_shards_at_sp_one_equals_plain(scheme, world):
    """make_train_step(seq_shards=2) over an sp axis of one rank: the plain
    step's losses, grad norms and params (the scheme is exact)."""
    cfg = dataclasses.replace(CFG, sp_attention=scheme)
    batches = [_tokens(s) for s in range(3)]
    init_plain, step_plain = make_train_step(cfg, device="cpu")
    plain = init_plain(torch.Generator().manual_seed(0))
    mesh = build_mesh(MeshConfig(fsdp=1, sp=1), device_type="cpu")
    init_sp, step_sp = make_train_step(cfg, mesh, seq_shards=2)
    sp = init_sp(params=plain.params)
    for tokens in batches:
        plain, want = step_plain(plain, {"tokens": tokens})
        sp, got = step_sp(sp, {"tokens": tokens})
        for key in ("loss", "grad_norm"):
            assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5)
    for a, b in zip(tree_leaves(plain.params), tree_leaves(sp.params)):
        torch.testing.assert_close(b.detach().full_tensor(), a.detach(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_pipeline_at_pp_one_matches_jax_and_loss_fn(n_micro, remat, world):
    """make_pipeline_loss on a (1, 1) mesh: the loss and grads of JAX's
    on one device, and of the port's loss_fn (1e-6)."""
    cfg = dataclasses.replace(CFG, remat=remat)
    jcfg = dataclasses.replace(JCFG, remat=remat)
    start = _start(cfg)
    batch = {"tokens": _tokens(1, b=4, t=17)}
    mesh = build_pipeline_mesh(1, device_type="cpu")
    params = _with_grads(params_from_jax(start, cfg, mesh=mesh,
                                         shardings=pipeline_shardings(cfg, mesh)))
    loss = make_pipeline_loss(cfg, mesh, n_micro)(params, batch)
    loss.backward()
    loss = float(loss.detach())
    plain = _with_grads(params_from_jax(start, cfg, device="cpu"))
    want = loss_fn(plain, {"tokens": torch.from_numpy(batch["tokens"])}, cfg)
    want.backward()
    assert loss == pytest.approx(float(want.detach()), rel=1e-6)
    for got, exp in zip(_grads(params), _grads(plain)):
        np.testing.assert_allclose(got, exp, atol=1e-6)
    jax_loss = jax_pipeline.make_pipeline_loss(
        jcfg, jax_pipeline.build_pipeline_mesh(1, devices=jax.devices()[:1]), n_micro)
    jax_value, jax_grads = jax.jit(jax.value_and_grad(jax_loss))(start, batch)
    assert loss == pytest.approx(float(jax_value), rel=1e-5)
    for got, exp in zip(_grads(params), jax.tree.leaves(jax_grads)):
        np.testing.assert_allclose(got, np.asarray(exp), atol=1e-4)


def test_pipeline_train_step_default_adamw_matches_jax(world):
    """Three steps of make_pipeline_train_step with its default optimizer
    (the port's AdamW, optax.adamw(1e-3)) at pp 1 against JAX's."""
    start = _start()
    batches = [{"tokens": _tokens(s, b=4, t=17)} for s in range(3)]
    init_fn, step_fn = make_pipeline_train_step(
        CFG, build_pipeline_mesh(1, device_type="cpu"), n_microbatches=2)
    state = init_fn(params=params_from_jax(start, CFG, device="cpu"))
    got = [float(step_fn(state, b)[1]["loss"]) for b in batches]
    jmesh = jax_pipeline.build_pipeline_mesh(1, devices=jax.devices()[:1])
    _, jstep = jax_pipeline.make_pipeline_train_step(JCFG, jmesh, n_microbatches=2)
    params = jax.tree.map(jnp.asarray, start)
    jstate = jax_pipeline.PipelineTrainState(jnp.zeros((), jnp.int32), params,
                                             optax.adamw(1e-3).init(params))
    want = []
    for b in batches:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(b["tokens"])})
        want.append(float(m["loss"]))
    assert got == pytest.approx(want, rel=1e-5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(state.params)),
                    jax.tree.leaves(jax.device_get(jstate.params))):
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_pipeline_optimizers_match_optax(name):
    """AdamW() = optax.adamw(1e-3) and SGD(lr) = optax.sgd(lr): params after
    each of five updates on fixed grads, rtol 1e-5."""
    rng = np.random.default_rng(5)
    params = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for n, s in (("w", (8, 16)), ("b", (16,)))}
    grads = [{n: rng.standard_normal(p.shape).astype(np.float32) for n, p in params.items()}
             for _ in range(5)]
    opt, tx = (AdamW(), optax.adamw(1e-3)) if name == "adamw" else (SGD(0.1), optax.sgd(0.1))
    leaves = [torch.from_numpy(p.copy()).requires_grad_() for p in params.values()]
    state = opt.init(leaves)
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    jstate = tx.init(jp)
    for count, g in enumerate(grads):
        for p, n in zip(leaves, params):
            p.grad = torch.from_numpy(g[n])
        norm = opt.update(state, leaves, count)
        assert float(norm) == pytest.approx(
            float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g.values()))),
            rel=1e-5)
        upd, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, n in zip(leaves, params):
            assert p.grad is None
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]), rtol=1e-5,
                                       atol=1e-7)


# --- expert parallelism, tensor-parallel serving, the autograd all_gather ---

MOE_CFG = dataclasses.replace(configs.TINY_MOE, compute_dtype=torch.float32)


def test_moe_mesh_step_at_ep_one_equals_plain(world):
    """TINY_MOE's mesh step on an (fsdp 1, ep 1) mesh, tests/test_moe.py's
    optimizer: the plain step's losses within 1e-6 over three steps."""
    opt = default_optimizer(1e-2, warmup=1, total_steps=20)
    init_plain, step_plain = make_train_step(MOE_CFG, device="cpu", optimizer=opt)
    plain = init_plain(torch.Generator().manual_seed(0))
    mesh = build_mesh(MeshConfig(fsdp=-1, ep=1), device_type="cpu")
    init_mesh, step_mesh = make_train_step(MOE_CFG, mesh, optimizer=opt)
    state = init_mesh(params=plain.params)
    assert tuple(state.params["blocks"]["w_gate"].shape) == (2, 4, 64, 128)
    for s in range(3):
        tokens = _tokens(s, t=17)
        plain, want = step_plain(plain, {"tokens": tokens})
        state, got = step_mesh(state, {"tokens": tokens})
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-6)


@pytest.mark.parametrize("cfg", [CFG, MOE_CFG], ids=["tiny", "tiny_moe"])
def test_tp_engine_at_world_one_is_the_meshless_engine(cfg, world):
    """`LLMEngine(mesh=...)` over a tp mesh of one rank gives the meshless
    engine's tokens bit for bit (greedy and sampled, a prefix hit and
    speculation included)."""
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = build_mesh(MeshConfig(fsdp=1, tp=1), device_type="cpu")
    kw = dict(num_slots=2, max_len=64, prefill_buckets=(16,), prefix_cache_size=2,
              speculation_k=4)
    prompts = [([1, 2, 3, 1, 2, 3, 1, 2], 0.0), ([1, 2, 3, 1, 2, 3, 1, 2], 0.0),
               ([7, 9, 11], 0.8)]
    outs = []
    for mesh_kw in ({"device": "cpu"}, {"mesh": mesh}):
        eng = LLMEngine(cfg, params, **kw, **mesh_kw)
        try:
            outs.append([eng.generate(p, max_tokens=8, temperature=t) for p, t in prompts])
        finally:
            eng.shutdown()
        assert eng.stats["prefix_hits"] == 1
    assert outs[0] == outs[1]


@pytest.mark.parametrize("dim", [0, 1])
def test_all_gather_backward_at_world_one(dim, world):
    """The autograd all_gather over a one-rank axis, fp64: the forward is
    its input, and gradcheck holds the backward to a finite difference."""
    mesh = build_mesh(MeshConfig(fsdp=1, tp=1), device_type="cpu")
    x = torch.randn(3, 4, dtype=torch.float64, requires_grad=True)
    w = torch.randn(3, 4, dtype=torch.float64)
    assert torch.equal(collectives.all_gather(x, "tp", mesh=mesh, dim=dim), x)
    assert torch.autograd.gradcheck(
        lambda t: (collectives.all_gather(t, "tp", mesh=mesh, dim=dim) * w).sum(), (x,))
