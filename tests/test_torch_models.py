"""ray_tpu_torch transformer against the JAX package, on the CPU.

Weights are drawn by the JAX init and carried across with `jax_bridge`;
token batches come from numpy. fp32 compute runs the same arithmetic in
both frameworks and is held tight. bf16 compute rounds activations at
each matmul and norm output; the two frameworks' fp32 intermediates differ
in their last bits, so a rounding may flip, and the bound on logits is a
few bf16 steps at their magnitude (~5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import forward as jax_forward
from ray_tpu.models import init_params as jax_init
from ray_tpu.models import loss_fn as jax_loss
from ray_tpu_torch.models import (
    Transformer, configs, forward, init_params, loss_fn)
from ray_tpu_torch.models.jax_bridge import params_from_jax, params_to_numpy
from ray_tpu_torch.models.training import tree_leaves
from ray_tpu_torch.models.transformer import param_shapes

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (logits atol, loss rtol) per compute dtype.
TOLS = {"fp32": (1e-4, 1e-5), "bf16": (0.15, 2e-3)}
NARROW_TIED = dict(name="narrow-tied", vocab_size=300, d_model=96, n_layers=2,
                   n_heads=3, n_kv_heads=3, d_ff=160, tie_embeddings=True,
                   remat=False)
CONFIGS = {"tiny": {}, "narrow-tied": NARROW_TIED}


def _configs(name, dtype="fp32", **overrides):
    jdt, tdt = DTYPES[dtype]
    extra = CONFIGS[name]
    jcfg = dataclasses.replace(jax_configs.TINY, compute_dtype=jdt, **extra,
                               **overrides)
    tcfg = dataclasses.replace(configs.TINY, compute_dtype=tdt, **extra,
                               **overrides)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp = jax_init(jax.random.key(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _tokens(vocab, b=2, t=24, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t + 1),
                                                dtype=np.int32)


def test_bridge_round_trip_is_exact():
    jcfg, tcfg = _configs("tiny")
    jp, tp = _params(jcfg, tcfg)
    back = params_to_numpy(tp)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_bridge_rejects_a_wrong_tree():
    jcfg, tcfg = _configs("tiny")
    tree = jax.tree.map(np.asarray, jax_init(jax.random.key(0), jcfg))
    tree["blocks"]["wq"] = tree["blocks"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq: shape"):
        params_from_jax(tree, tcfg, device="cpu")
    del tree["blocks"]["wq"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, tcfg, device="cpu")


def test_registry_matches_jax():
    assert set(configs.REGISTRY) == set(jax_configs.REGISTRY)
    for name, tcfg in configs.REGISTRY.items():
        jcfg = jax_configs.REGISTRY[name]
        for field in dataclasses.fields(tcfg):
            if field.name not in ("param_dtype", "compute_dtype"):
                assert getattr(tcfg, field.name) == getattr(jcfg, field.name), \
                    (name, field.name)
        assert tcfg.num_params == jcfg.num_params
        assert tcfg.head_dim == jcfg.head_dim


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_tree_and_scales(name):
    jcfg, tcfg = _configs(name)
    want = jax.tree.map(lambda x: x.shape, jax_init(jax.random.key(0), jcfg))
    got = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), got) == want
    assert param_shapes(tcfg) == want
    assert sum(w.numel() for w in tree_leaves(got)) == tcfg.num_params
    d = tcfg.d_model
    assert float(got["blocks"]["wq"].std()) == pytest.approx(d ** -0.5, rel=0.1)
    assert float(got["embed"].std()) == pytest.approx(d ** -0.75, rel=0.1)
    assert torch.equal(got["final_norm"], torch.ones(d))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_and_loss_parity(name, dtype):
    jcfg, tcfg = _configs(name, dtype)
    jp, tp = _params(jcfg, tcfg)
    tokens = _tokens(tcfg.vocab_size)
    logits_atol, loss_rtol = TOLS[dtype]

    want = np.asarray(jax_forward(jp, jnp.asarray(tokens[:, :-1]), jcfg), np.float32)
    got = forward(tp, torch.from_numpy(tokens[:, :-1]), tcfg)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(got.float().numpy(), want, atol=logits_atol)

    batch = {"tokens": tokens}
    assert float(loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)) == \
        pytest.approx(float(jax_loss(jp, batch, jcfg)), rel=loss_rtol)


def test_loss_with_targets_and_mask_parity():
    jcfg, tcfg = _configs("tiny")
    jp, tp = _params(jcfg, tcfg)
    tokens = _tokens(tcfg.vocab_size, seed=3)
    mask = (np.arange(24)[None, :] < np.array([[20], [9]])).astype(np.float32)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:], "mask": mask}
    want = float(jax_loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    got = float(loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg))
    assert got == pytest.approx(want, rel=1e-5)


def test_grads_parity_fp32():
    jcfg, tcfg = _configs("tiny")
    jp, tp = _params(jcfg, tcfg)
    tokens = _tokens(tcfg.vocab_size, seed=4)
    want = jax.grad(jax_loss)(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    leaves = tree_leaves(tp)
    for w in leaves:
        w.requires_grad_()
    loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, tcfg).backward()
    got = params_to_numpy(jax.tree.map(lambda w: w.grad, tp,
                                       is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def test_remat_full_matches_no_remat():
    _, tcfg = _configs("tiny")
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size, seed=5))
    params = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy="full")
        p = {k: ({n: w.clone().requires_grad_() for n, w in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_())
             for k, v in params.items()}
        loss = loss_fn(p, {"tokens": tokens}, cfg)
        loss.backward()
        results.append((loss.detach(), [w.grad for w in tree_leaves(p)]))
    (l0, g0), (l1, g1) = results
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _port_loss_and_grads(params, tokens, cfg):
    p = {k: ({n: w.clone().requires_grad_() for n, w in v.items()}
             if isinstance(v, dict) else v.clone().requires_grad_())
         for k, v in params.items()}
    loss = loss_fn(p, {"tokens": tokens}, cfg)
    loss.backward()
    return loss.detach(), [w.grad for w in tree_leaves(p)]


@pytest.mark.parametrize("policy", ["dots", "ff"])
def test_remat_policy_matches_full_no_remat_and_jax(policy):
    """Dense TINY under "dots" and "ff": the port's loss and grads equal
    those of "full" and of no remat (the same values, saved or recomputed),
    and JAX's under the same policy."""
    jcfg, tcfg = _configs("tiny", remat=True, remat_policy=policy)
    jp, tp = _params(jcfg, tcfg)
    tokens = _tokens(tcfg.vocab_size, seed=7)
    loss, grads = _port_loss_and_grads(tp, torch.from_numpy(tokens), tcfg)
    for other in (dict(remat=True, remat_policy="full"), dict(remat=False)):
        l0, g0 = _port_loss_and_grads(tp, torch.from_numpy(tokens),
                                      dataclasses.replace(tcfg, **other))
        torch.testing.assert_close(loss, l0, rtol=0, atol=0)
        for a, b in zip(grads, g0):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    batch = {"tokens": jnp.asarray(tokens)}
    assert float(loss) == pytest.approx(float(jax_loss(jp, batch, jcfg)),
                                        rel=1e-5)
    want = jax.grad(jax_loss)(jp, batch, jcfg)
    got = _grad_tree(tp, grads)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def _grad_tree(params, grads):
    """The flat grads of `tree_leaves(params)` back in params' tree, numpy."""
    it = iter(grads)
    return params_to_numpy({k: ({n: next(it) for n in v}
                                if isinstance(v, dict) else next(it))
                            for k, v in params.items()})


@pytest.mark.parametrize("policy,rerun_per_layer", [
    ("full", 6), ("dots", 0), ("ff", 6)])
def test_remat_policy_reruns_the_products_it_does_not_save(policy,
                                                           rerun_per_layer):
    """The weight products backward runs again, per layer. "full" reruns
    six of the block's seven: no backward formula reads w_down's output, so
    the recompute stops before it (torch's checkpoint stops early, as JAX's
    partial evaluation leaves it out). "dots" saves all seven. "ff" saves
    w_down's input, whose backward still needs w_gate's and w_up's outputs,
    so the same six run again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                CountMM.count += 1
            return func(*args, **(kwargs or {}))

    _, tcfg = _configs("tiny")
    params = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size, seed=8))
    counts = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        leaves = [w.clone().requires_grad_() for w in tree_leaves(params)]
        it = iter(leaves)
        p = {k: ({n: next(it) for n in v} if isinstance(v, dict) else next(it))
             for k, v in params.items()}
        loss = loss_fn(p, {"tokens": tokens}, cfg)
        CountMM.count = 0
        with CountMM():
            loss.backward()
        counts[remat] = CountMM.count
    assert counts[True] - counts[False] == rerun_per_layer * tcfg.n_layers


def test_unported_paths_raise():
    _, tcfg = _configs("tiny")
    params = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="seq_shards=2"):
        forward(params, torch.zeros(1, 4, dtype=torch.int32), tcfg,
                seq_shards=2)


def test_module_matches_functional():
    _, tcfg = _configs("tiny")
    params = init_params(tcfg, torch.Generator().manual_seed(2), device="cpu")
    model = Transformer(tcfg, params)
    assert sum(p.numel() for p in model.parameters()) == tcfg.num_params
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size, seed=6))
    torch.testing.assert_close(model(tokens[:, :-1]),
                               forward(params, tokens[:, :-1], tcfg))
    torch.testing.assert_close(model.loss({"tokens": tokens}),
                               loss_fn(params, {"tokens": tokens}, tcfg))


def test_gqa_repeat_interleaves_like_jnp_repeat():
    from ray_tpu_torch.models.transformer import _attention

    _, tcfg = _configs("tiny")  # 4 heads over 2 kv heads
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 6, 4, 16, generator=g)
    kv = torch.randn(1, 6, 2, 16, generator=g)
    got = _attention(q, kv, kv, tcfg)
    want = _attention(q, kv[:, :, [0, 0, 1, 1]], kv[:, :, [0, 0, 1, 1]],
                      dataclasses.replace(tcfg, n_kv_heads=4))
    torch.testing.assert_close(got, want)
