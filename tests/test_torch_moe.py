"""ray_tpu_torch MoE against the JAX package, on the CPU.

The routing, the capacity-routed training MLP and the dropless serving MLP
of `ops/moe.py`, then TINY_MOE (4 experts, top 2) through `forward`,
and `loss_fn`. Inputs come from numpy at a fixed seed and
weights are carried across with `jax_bridge`. fp32 compute runs the same
arithmetic in both frameworks: the one-hot dispatch is held equal, the
gates and probabilities to 1e-6, the MLP outputs and auxiliary losses to
1e-5, and the model as tests/test_torch_models.py holds the dense one
(its train steps are in tests/test_torch_training.py).
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
from ray_tpu.ops import moe as jmoe
from ray_tpu_torch.models import configs, forward, init_params, loss_fn
from ray_tpu_torch.models.jax_bridge import params_from_jax, params_to_numpy
from ray_tpu_torch.models.training import tree_leaves
from ray_tpu_torch.models.transformer import param_shapes
from ray_tpu_torch.ops import moe as tmoe

D, F_, E = 16, 32, 4


def _moe_params(rng):
    """One MoE layer's weights at N(0, 1/fan_in), as numpy."""
    def w(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)
    return {"router": w((D, E), D), "w_gate": w((E, D, F_), D),
            "w_up": w((E, D, F_), D), "w_down": w((E, F_, D), F_)}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


def _routing(logits, k, capacity):
    want = [np.asarray(a) for a in jmoe.top_k_routing(jnp.asarray(logits), k,
                                                      capacity)]
    got = [a.numpy() for a in tmoe.top_k_routing(torch.from_numpy(logits), k,
                                                 capacity)]
    np.testing.assert_array_equal(got[0], want[0])          # dispatch
    for a, b in zip(got[1:], want[1:]):                     # combine, probs
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    return got


def test_top_k_routing_over_capacity_matches_jax():
    """16 tokens choose 2 of 4 experts: 32 choices for 16 places, so some
    queues overflow and those choices drop, in JAX's priority order."""
    logits = np.random.default_rng(0).standard_normal((1, 16, E)).astype(
        np.float32)
    dispatch, combine, _ = _routing(logits, 2, 4)
    assert dispatch.shape == combine.shape == (1, 16, E, 4)
    assert dispatch.sum(axis=1).max() <= 1.0               # a place, a token
    assert dispatch.sum() < 32                             # some dropped
    _routing(logits, 2, 8)                                 # none dropped


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_routing_breaks_ties_to_the_lower_index(k):
    """Equal logits, as bf16 routers give: the lower expert index wins, as
    `jax.lax.top_k` orders them."""
    rows = np.array([[1.0, 1.0, 1.0, 1.0], [0.5, 2.0, 2.0, 0.5],
                     [0.0, 3.0, 1.0, 3.0], [2.0, 1.0, 2.0, 2.0],
                     [-1.0, -1.0, 0.0, 0.0]], np.float32)
    dispatch, _, _ = _routing(rows[None], k, 8)
    chosen = [set(np.flatnonzero(r).tolist()) for r in dispatch[0].max(-1)]
    order = [[0, 1, 2], [1, 2, 0], [1, 3, 2], [0, 2, 3], [2, 3, 0]]
    assert chosen == [set(o[:k]) for o in order]
    _, idx = tmoe._top_k(torch.from_numpy(rows), k)
    assert idx.tolist() == [o[:k] for o in order]


@pytest.mark.parametrize("tokens", [(2, 12), (1, 40)])
def test_moe_mlp_and_aux_losses_match_jax(tokens):
    rng = np.random.default_rng(1)
    jp, tp = _both(_moe_params(rng))
    x = rng.standard_normal((*tokens, D)).astype(np.float32)
    want, want_aux = jmoe.moe_mlp(jnp.asarray(x), jp, jmoe.MoEConfig(E, 2))
    got, got_aux = tmoe.moe_mlp(torch.from_numpy(x), tp, tmoe.MoEConfig(E, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert set(got_aux) == set(want_aux) == {"moe_load_balance_loss",
                                             "moe_z_loss"}
    for name in want_aux:
        assert float(got_aux[name]) == pytest.approx(float(want_aux[name]),
                                                     rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("shape", [(2, 12), (5, 1), (3, 4)])
def test_moe_mlp_dropless_matches_jax(shape):
    rng = np.random.default_rng(2)
    jp, tp = _both(_moe_params(rng))
    x = rng.standard_normal((*shape, D)).astype(np.float32)
    want = jmoe.moe_mlp_dropless(jnp.asarray(x), jp, jmoe.MoEConfig(E, 2))
    got = tmoe.moe_mlp_dropless(torch.from_numpy(x), tp, tmoe.MoEConfig(E, 2))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_dropless_is_independent_of_the_batch():
    """Each token's output is the same alone as beside others."""
    rng = np.random.default_rng(3)
    _, tp = _both(_moe_params(rng))
    x = torch.from_numpy(rng.standard_normal((6, D)).astype(np.float32))
    cfg = tmoe.MoEConfig(E, 2)
    together = tmoe.moe_mlp_dropless(x, tp, cfg)
    alone = torch.cat([tmoe.moe_mlp_dropless(x[i:i + 1], tp, cfg)
                       for i in range(6)])
    torch.testing.assert_close(together, alone, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# TINY_MOE through the model
# ---------------------------------------------------------------------------
def _configs(**overrides):
    jcfg = dataclasses.replace(jax_configs.TINY_MOE, compute_dtype=jnp.float32,
                               **overrides)
    tcfg = dataclasses.replace(configs.TINY_MOE, compute_dtype=torch.float32,
                               **overrides)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp = jax_init(jax.random.key(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _tokens(vocab, b=2, t=24, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t + 1),
                                                dtype=np.int32)


def test_moe_param_tree_init_and_bridge_round_trip():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    want = jax.tree.map(np.asarray, jp)
    assert param_shapes(tcfg) == jax.tree.map(lambda x: x.shape, want)
    assert param_shapes(tcfg)["blocks"]["w_down"] == (2, 4, 128, 64)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    got = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), got) == \
        jax.tree.map(lambda x: x.shape, want)
    assert sum(w.numel() for w in tree_leaves(got)) == tcfg.num_params
    for name, fan_in in (("router", 64), ("w_gate", 64), ("w_down", 128)):
        assert float(got["blocks"][name].std()) == pytest.approx(
            fan_in ** -0.5, rel=0.1)
    # Drawn a layer at a time into a bf16 stack.
    bf16 = init_params(dataclasses.replace(tcfg, param_dtype=torch.bfloat16),
                       torch.Generator().manual_seed(0), device="cpu")
    assert all(w.dtype == torch.bfloat16 for w in tree_leaves(bf16))
    assert not torch.equal(bf16["blocks"]["w_up"][0], bf16["blocks"]["w_up"][1])


def _grads(params, batch, cfg):
    leaves = tree_leaves(params)
    for w in leaves:
        w.grad = None
        w.requires_grad_()
    loss = loss_fn(params, batch, cfg)
    loss.backward()
    return float(loss.detach()), params_to_numpy(jax.tree.map(
        lambda w: w.grad, params, is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "dots")])
def test_tiny_moe_forward_loss_and_grads_match_jax(remat, policy):
    jcfg, tcfg = _configs(remat=remat, remat_policy=policy)
    jp, tp = _params(jcfg, tcfg)
    tokens = _tokens(tcfg.vocab_size, seed=4)
    want_aux, got_aux = {}, {}
    want = np.asarray(jax_forward(jp, jnp.asarray(tokens[:, :-1]), jcfg,
                                  return_aux=want_aux))
    got = forward(tp, torch.from_numpy(tokens[:, :-1]), tcfg,
                  return_aux=got_aux)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)
    assert set(got_aux) == set(want_aux)
    for name in want_aux:
        assert float(got_aux[name]) == pytest.approx(float(want_aux[name]),
                                                     rel=1e-5)

    batch = {"tokens": jnp.asarray(tokens)}
    want_loss = float(jax_loss(jp, batch, jcfg))
    want_grads = jax.grad(jax_loss)(jp, batch, jcfg)
    loss, grads = _grads(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def test_tiny_moe_loss_carries_the_aux_terms():
    """loss_fn = cross entropy + 0.01 * load balance + z-loss, as JAX's."""
    _, tcfg = _configs()
    _, tp = _params(*_configs())
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size, seed=5))
    aux = {}
    logits = forward(tp, tokens[:, :-1], tcfg, return_aux=aux).float()
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, tcfg.vocab_size), tokens[:, 1:].reshape(-1).long())
    want = ce + 0.01 * aux["moe_load_balance_loss"] + aux["moe_z_loss"]
    torch.testing.assert_close(loss_fn(tp, {"tokens": tokens}, tcfg), want)
    assert float(aux["moe_load_balance_loss"]) > 0


def test_ff_remat_with_experts_raises_like_jax():
    jcfg, tcfg = _configs(remat=True, remat_policy="ff")
    jp, tp = _params(*_configs())
    tokens = _tokens(tcfg.vocab_size)
    with pytest.raises(ValueError, match="remat_policy='ff'") as want:
        jax_forward(jp, jnp.asarray(tokens[:, :-1]), jcfg)
    with pytest.raises(ValueError, match="remat_policy='ff'") as got:
        forward(tp, torch.from_numpy(tokens[:, :-1]), tcfg)
    assert str(got.value) == str(want.value)
