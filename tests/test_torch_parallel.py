"""The port's mesh, sharding rules and Adafactor against the JAX package,
in one process on the CPU.

`MeshConfig.resolve` and `logical_to_mesh` are compared with JAX's over
tables of inputs; the train step on a world-1 mesh (a gloo group this
process starts, destroyed after each test) with the step without one;
`Adafactor` with `optax.adafactor` over 5 updates. The several-rank
layouts are `test_torch_distributed.py`'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ray_tpu.models import configs as jax_configs
from ray_tpu.models.transformer import param_logical_axes as jax_param_logical_axes
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu.parallel import sharding as jax_sharding
from ray_tpu_torch.models import configs
from ray_tpu_torch.models.training import (
    Adafactor, default_optimizer, factored_dims, make_eval_step, make_train_step,
    tree_leaves)
from ray_tpu_torch.models.transformer import param_logical_axes
from ray_tpu_torch.parallel import mesh, sharding

TCFG = dataclasses.replace(configs.TINY, compute_dtype=torch.float32)


@pytest.fixture
def world():
    """The world-1 group `build_mesh` starts; destroyed whatever the test did."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


RESOLVE_CASES = [
    (dict(), 8), (dict(fsdp=4, tp=2), 8), (dict(dp=2, fsdp=-1, tp=2), 8),
    (dict(dp=-1, fsdp=2), 8), (dict(fsdp=1, tp=-1), 4), (dict(fsdp=2, sp=2, tp=2), 8),
    (dict(ep=2, fsdp=-1), 6), (dict(), 1),
    (dict(dp=-1, fsdp=-1), 8), (dict(fsdp=3), 8), (dict(fsdp=-1, tp=3), 8),
    (dict(fsdp=2, tp=2), 8),
]


@pytest.mark.parametrize("kw,n", RESOLVE_CASES,
                         ids=[f"{kw}-{n}" for kw, n in RESOLVE_CASES])
def test_mesh_config_resolve_matches_jax(kw, n):
    try:
        want = jax_mesh.MeshConfig(**kw).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match="^" + str(e)[:20]):
            mesh.MeshConfig(**kw).resolve(n)
        return
    assert mesh.MeshConfig(**kw).resolve(n) == want
    assert mesh.mesh_shape_for(n, mesh.MeshConfig(**kw)) == want


RULES = {"default": (sharding.DEFAULT_RULES, jax_sharding.DEFAULT_RULES),
         "tp": (sharding.TP_RULES, jax_sharding.TP_RULES),
         "ddp": (sharding.DDP_RULES, jax_sharding.DDP_RULES)}


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("name", ["TINY", "TINY_MOE"])
def test_logical_to_mesh_matches_jax_for_every_leaf(name, rules, world):
    """Every leaf's spec equals JAX's PartitionSpec, and on a mesh its
    placements shard each tensor dim over the mesh axes that spec names."""
    ours, theirs = RULES[rules]
    assert dict(ours) == dict(theirs)
    cfg = getattr(configs, name)
    axes = param_logical_axes(cfg)
    assert axes == jax_param_logical_axes(getattr(jax_configs, name))
    m = mesh.build_mesh(device_type="cpu")
    for logical in jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple)):
        spec = sharding.logical_to_mesh(logical, ours)
        want = jax_sharding.logical_to_mesh(logical, theirs)
        assert spec == tuple(want), logical
        for axis, p in zip(m.mesh_dim_names, sharding.placements(spec, m)):
            dims = [i for i, e in enumerate(want)
                    if axis in (e if isinstance(e, tuple) else (e,))]
            assert (p.is_shard() and [p.dim] == dims) or (p.is_replicate() and not dims)


def test_world_one_mesh_is_named_and_cuda_needs_a_card(world):
    m = mesh.build_mesh(mesh.MeshConfig(fsdp=-1), device_type="cpu")
    assert m.mesh_dim_names == ("dp", "fsdp", "ep", "sp", "tp")
    assert dict(mesh.mesh_axis_sizes(m)) == {a: 1 for a in m.mesh_dim_names}
    assert mesh.local_mesh(device_type="cpu").size() == 1
    x = torch.ones(4, 3)
    assert sharding.with_logical_constraint(x, ("batch", "embed")) is x
    assert sharding.with_logical_constraint(x, ("batch", "embed"), mesh=m) is x
    d = distribute_tensor(x, m, [Replicate()] * 5)
    got = sharding.with_logical_constraint(d, ("batch", "embed"), mesh=m)
    # batch takes dp and fsdp; embed's fsdp is then used, so it replicates.
    assert got.placements == (Shard(0), Shard(0), Replicate(), Replicate(), Replicate())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.build_mesh()


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_world_one_mesh_step_equals_the_step_without_mesh(opt, world):
    """Three steps under MeshConfig(fsdp=-1) on one rank: DTensor params,
    the same losses, grad norms and params as without a mesh."""
    optimizer = default_optimizer(1e-2, warmup=2, total_steps=10) \
        if opt == "adamw" else Adafactor(1e-2)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, TCFG.vocab_size, (4, 33), dtype=np.int32)
               for _ in range(3)]
    init_plain, step_plain = make_train_step(TCFG, device="cpu", optimizer=optimizer)
    plain = init_plain(torch.Generator().manual_seed(0))
    m = mesh.build_mesh(device_type="cpu")
    init_mesh, step_mesh = make_train_step(TCFG, m, optimizer=optimizer)
    sharded = init_mesh(params=plain.params)
    assert all(isinstance(p, DTensor) for p in tree_leaves(sharded.params))
    eval_mesh = make_eval_step(TCFG, m)
    for tokens in batches:
        plain, want = step_plain(plain, {"tokens": tokens})
        sharded, got = step_mesh(sharded, {"tokens": tokens})
        for k in ("loss", "grad_norm"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6, abs=0)
    for a, b in zip(tree_leaves(plain.params), tree_leaves(sharded.params)):
        torch.testing.assert_close(b.detach().full_tensor(), a.detach(),
                                   atol=1e-6, rtol=1e-6)
    loss = eval_mesh(sharded.params, {"tokens": batches[0]})
    assert float(loss) == pytest.approx(
        float(make_eval_step(TCFG, device="cpu")(plain.params, {"tokens": batches[0]})),
        rel=1e-6)


# Adafactor's tree: factored leaves with d1 < d0 (wq) and d1 > d0 (w_down),
# a stacked (L, d) norm and a vector that stay unfactored. Under fsdp 2 x
# tp 2 (test_torch_distributed.py) both factored dims of each factored leaf
# are split.
ADAFACTOR_TREE = {
    "embed": ((512, 128), ("vocab", "embed")),
    "wq": ((2, 128, 256), ("layers", "embed", "heads")),
    "w_down": ((2, 256, 128), ("layers", "mlp", "embed")),
    "norm": ((2, 128), ("layers", "embed")),
    "final_norm": ((128,), ("embed",)),
}


def adafactor_case(lr, updates=5, seed=3):
    """(params, logical axes, grads per update, optax's params after each)
    for optax.adafactor(learning_rate=lr)."""
    rng = np.random.default_rng(seed)
    params = {n: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for n, (s, _) in ADAFACTOR_TREE.items()}
    grads = [{n: (rng.standard_normal(p.shape) * 10.0 ** rng.integers(-3, 1)).astype(
        np.float32) for n, p in params.items()} for _ in range(updates)]
    tx = optax.adafactor(learning_rate=lr)

    @jax.jit
    def update(g, state, p):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    jp = {n: jnp.asarray(p) for n, p in params.items()}
    state, want = tx.init(jp), []
    for g in grads:
        jp, state = update(g, state, jp)
        want.append(jax.device_get(jp))
    return params, {n: a for n, (_, a) in ADAFACTOR_TREE.items()}, grads, want


def check_adafactor(got_steps, want_steps, params):
    """Params after each update to rtol 1e-5; the updates themselves (a
    difference of two fp32 params) to rtol 1e-3. atol is two fp32 ulps of
    the largest params (|p| <= 0.25): an element that ends near zero, or
    moves little, carries the rounding of its larger operands."""
    for got, want in zip(got_steps, want_steps):
        for n, p in params.items():
            np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=3e-8, err_msg=n)
            np.testing.assert_allclose(got[n] - p, want[n] - p, rtol=1e-3, atol=3e-8,
                                       err_msg=n)
    assert min(float(np.abs(want_steps[-1][n] - p).max()) for n, p in params.items()) > 1e-6


# lr 1e-4 is bench-1b4's; at lr 0.1 an update moves each param by ~10%, so
# rtol 1e-5 on the params holds the update itself to ~1e-4.
@pytest.mark.parametrize("lr", [1e-4, 1e-1])
def test_adafactor_matches_optax(lr):
    params, _, grads, want = adafactor_case(lr)
    assert [factored_dims(p.shape) for p in params.values()] == \
        [(1, 0), (1, 2), (2, 1), None, None]
    leaves = [torch.from_numpy(p.copy()).requires_grad_() for p in params.values()]
    opt = Adafactor(lr)
    state = opt.init(leaves)
    got = []
    for count, g in enumerate(grads):
        for p, n in zip(leaves, params):
            p.grad = torch.from_numpy(g[n])
        norm = opt.update(state, leaves, count)
        assert float(norm) == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
        assert all(p.grad is None for p in leaves)
        got.append({n: p.detach().numpy().copy() for n, p in zip(params, leaves)})
    check_adafactor(got, want, params)
