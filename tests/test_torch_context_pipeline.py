"""The port's context-parallel attention (ring, Ulysses), its sequence-
parallel forward and its GPipe pipeline on four gloo processes, against
the JAX package's on four devices of its CPU mesh.

One module-scoped pool of four spawned ranks (`torch_dist_worker.py`,
`Ranks` of `test_torch_distributed.py`) serves every case; each case
sends the same numpy inputs to both sides. Tolerances at fp32: attention
outputs 2e-5 and q/k/v grads 1e-5 (as `tests/test_ops.py`), the forward's
logits 1e-5, pipeline losses 1e-5 relative and grads 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu.models import configs as jax_configs
from ray_tpu.models.transformer import forward as jax_forward
from ray_tpu.ops import ring_attention as jax_ring, ulysses_attention as jax_ulysses
from ray_tpu.parallel import collectives as jcol, pipeline as jax_pipeline
from ray_tpu.parallel.sharding import DEFAULT_RULES
from ray_tpu.parallel.sharding import param_shardings as jax_param_shardings
from ray_tpu.models.transformer import param_logical_axes
from ray_tpu_torch.models import configs, init_params
from ray_tpu_torch.models.jax_bridge import params_to_numpy
from test_torch_distributed import JCFG, Ranks, _jax_mesh, _start_params

# The JAX pipeline tests' model (tests/test_pipeline.py::tiny_cfg), at fp32.
PIPE_KW = dict(d_model=32, d_ff=64, n_heads=4, n_kv_heads=4, vocab_size=128,
               remat=False)


@pytest.fixture(scope="module")
def ranks():
    pool = Ranks()
    yield pool
    pool.close()


def _qkv(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d), dtype=np.float32) for _ in range(4)]


def _jax_cp(scheme, sp, causal, q, k, v, do):
    """JAX's scheme under shard_map over sp: (out, (dq, dk, dv)) of sum(out * do)."""
    spec = P(None, "sp", None, None)
    fn = {"ring": jax_ring, "ulysses": jax_ulysses}[scheme]
    f = jax.shard_map(lambda a, b, c: fn(a, b, c, axis="sp", causal=causal),
                      mesh=_jax_mesh({"sp": sp}), in_specs=(spec,) * 3,
                      out_specs=spec, check_vma=False)
    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(do)

    out, grads = run(q, k, v, do)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_cp(ranks, scheme, sp, causal, q, k, v, do):
    """The ranks' scheme over sp: (out, (dq, dk, dv)), the shards joined
    along the sequence in rank (= sp) order."""
    ranks.send("cp_attention", scheme=scheme, sizes={"sp": sp}, causal=causal,
               q=q, k=k, v=v, do=do)
    results = ranks.results()
    join = lambda key: np.concatenate([r[key] for r in results], axis=1)  # noqa: E731
    return join("out"), [join(g) for g in ("dq", "dk", "dv")]


@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_context_parallel_attention_matches_jax(ranks, scheme, causal):
    """sp 4, (2, 64, 4, 16): outputs within 2e-5, q/k/v grads within 1e-5."""
    q, k, v, do = _qkv(2, 2, 64, 4, 16)
    out, grads = _port_cp(ranks, scheme, 4, causal, q, k, v, do)
    want, want_grads = _jax_cp(scheme, 4, causal, q, k, v, do)
    np.testing.assert_allclose(out, want, atol=2e-5)
    for name, g, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=f"d{name}")


def test_ulysses_matches_ring(ranks):
    """Both schemes are exact: the port's two agree on the same shards."""
    q, k, v, do = _qkv(6, 1, 128, 4, 16)
    ring = _port_cp(ranks, "ring", 4, True, q, k, v, do)
    uly = _port_cp(ranks, "ulysses", 4, True, q, k, v, do)
    np.testing.assert_allclose(uly[0], ring[0], atol=2e-5)
    for g_u, g_r in zip(uly[1], ring[1]):
        np.testing.assert_allclose(g_u, g_r, atol=1e-5)


def test_ulysses_rejects_indivisible_heads(ranks):
    """2 heads over sp 4: the ValueError of the JAX package, on every rank."""
    q, k, v, do = _qkv(8, 1, 64, 2, 16)
    ranks.send("cp_attention", scheme="ulysses", sizes={"sp": 4}, causal=True,
               q=q, k=k, v=v, do=do)
    with pytest.raises(ValueError, match="divisible") as jax_error:
        _jax_cp("ulysses", 4, True, q, k, v, do)
    for res in ranks.results():
        assert res == {"error": str(jax_error.value)}


@pytest.mark.parametrize("sizes", [{"fsdp": 2, "sp": 2}, {"sp": 4}],
                         ids=["fsdp2_sp2", "sp4"])
@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_sequence_parallel_forward_matches_jax(ranks, sizes, scheme):
    """`forward(seq_shards=sp)` on each rank's rows and positions against
    JAX's jitted forward on the same mesh (global view), TINY at fp32 (GQA
    4/2: the kv repeat comes before the scheme), within 1e-5."""
    cfg = dataclasses.replace(JCFG, sp_attention=scheme)
    start = _start_params()
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64), dtype=np.int32)
    ranks.send("sp_forward", sizes=sizes, scheme=scheme, start=start, tokens=tokens)
    mesh = _jax_mesh(sizes)
    params = jax.device_put(start, jax_param_shardings(param_logical_axes(cfg), mesh,
                                                       DEFAULT_RULES))
    with mesh:
        want = np.asarray(jax.jit(lambda p, t: jax_forward(
            p, t, cfg, mesh=mesh, seq_shards=sizes["sp"]))(params, jnp.asarray(tokens)))
    got = np.full_like(want, np.nan)
    for res in ranks.results():
        (r0, r1), (c0, c1) = res["rows"], res["cols"]
        got[r0:r1, c0:c1] = res["logits"]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_collective_grads_match_jax_shard_map(ranks):
    """The backward of ppermute_ring (shift 1 and -1), all_to_all and
    all_gather over tp of a (fsdp 2, tp 2) mesh against jax.vjp through
    shard_map."""
    sizes = {"fsdp": 2, "tp": 2}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 3), dtype=np.float32)
    ops = {"ppermute_ring": lambda v: jcol.ppermute_ring(v, "tp"),
           "ppermute_ring_back": lambda v: jcol.ppermute_ring(v, "tp", shift=-1),
           "all_to_all": lambda v: jcol.all_to_all(v, "tp", split_dim=0, concat_dim=1),
           "all_gather": lambda v: jcol.all_gather(v, "tp")}
    mesh = _jax_mesh(sizes)
    spec = P(("dp", "fsdp", "ep", "sp", "tp"))
    fns = {name: jax.shard_map(op, mesh=mesh, in_specs=spec, out_specs=spec,
                               check_vma=False) for name, op in ops.items()}
    w = {name: rng.standard_normal(jax.eval_shape(f, x).shape, dtype=np.float32)
         for name, f in fns.items()}
    ranks.send("collective_grads", sizes=sizes, axis="tp", x=x, w=w)
    results = ranks.results()
    for name, f in fns.items():
        _, vjp = jax.vjp(f, jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(w[name]))[0])
        got = np.concatenate([r[name] for r in results])
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


# --- the pipeline ------------------------------------------------------------

def _pipe_cfgs(n_layers, **kw):
    """(JAX config, port config kwargs): tests/test_pipeline.py's tiny model
    at fp32, with `kw` over it."""
    kw = {**PIPE_KW, "n_layers": n_layers, **kw}
    return dataclasses.replace(jax_configs.TINY, compute_dtype=jnp.float32, **kw), kw


def _pipe_start(cfg_kw):
    tcfg = dataclasses.replace(configs.TINY, compute_dtype=torch.float32, **cfg_kw)
    return params_to_numpy(init_params(tcfg, torch.Generator().manual_seed(0),
                                       device="cpu"))


def _pipe_batch(seed=1, batch=8, seq=16, mask=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, PIPE_KW["vocab_size"], (batch, seq + 1),
                                  dtype=np.int32)}
    if mask:
        out["mask"] = (rng.uniform(size=(batch, seq)) > 0.3).astype(np.float32)
    return out


def _pipe_results(ranks, pp, dp):
    """The results of the ranks in the pipeline mesh (the first pp x dp)."""
    results = ranks.results()
    assert all(r is None for r in results[pp * dp:])
    return results[:pp * dp]


def _jax_pipe_loss(jcfg, pp, dp, n_micro):
    mesh = jax_pipeline.build_pipeline_mesh(pp, dp=dp)
    return jax.jit(jax_pipeline.make_pipeline_loss(jcfg, mesh, n_micro))


@pytest.mark.parametrize("pp,n_micro", [(2, 2), (4, 4), (2, 4)])
def test_pipeline_loss_matches_jax(ranks, pp, n_micro):
    jcfg, kw = _pipe_cfgs(4)
    start, batch = _pipe_start(kw), _pipe_batch()
    ranks.send("pipeline", pp=pp, dp=1, n_micro=n_micro, cfg_kw=kw, start=start,
               batches=[batch])
    want = float(_jax_pipe_loss(jcfg, pp, 1, n_micro)(start, batch))
    for res in _pipe_results(ranks, pp, 1):
        assert res["loss"] == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_pipeline_grads_match_jax(ranks, remat):
    """pp 2, M 2: every param's grad within 1e-4 (the stage body under a
    full checkpoint with remat)."""
    jcfg, kw = _pipe_cfgs(4, remat=remat)
    start, batch = _pipe_start(kw), _pipe_batch()
    ranks.send("pipeline", pp=2, dp=1, n_micro=2, cfg_kw=kw, start=start,
               batches=[batch], grads=True)
    loss = _jax_pipe_loss(jcfg, 2, 1, 2)
    want_loss, want = jax.jit(jax.value_and_grad(loss))(start, batch)
    for res in _pipe_results(ranks, 2, 1):
        assert res["loss"] == pytest.approx(float(want_loss), rel=1e-5)
        for a, b in zip(jax.tree.leaves(res["grads"]), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("mask", [False, True], ids=["dp2_pp2", "masked"])
def test_pipeline_dp_and_masked_loss_match_jax(ranks, mask):
    """dp 2 x pp 2 (rows over dp, the token count summed over dp only),
    and pp 2 with a mask."""
    jcfg, kw = _pipe_cfgs(2)
    dp = 1 if mask else 2
    start, batch = _pipe_start(kw), _pipe_batch(mask=mask)
    ranks.send("pipeline", pp=2, dp=dp, n_micro=2, cfg_kw=kw, start=start,
               batches=[batch])
    want = float(_jax_pipe_loss(jcfg, 2, dp, 2)(start, batch))
    for res in _pipe_results(ranks, 2, dp):
        assert res["loss"] == pytest.approx(want, rel=1e-5)


def test_pipeline_train_steps_match_jax(ranks):
    """Three SGD(0.5) steps of make_pipeline_train_step at pp 2 x dp 2:
    losses within 1e-5, params within 1e-4, and the params moved."""
    jcfg, kw = _pipe_cfgs(2)
    start = _pipe_start(kw)
    batches = [_pipe_batch(seed=s) for s in range(3)]
    lr = 0.5
    ranks.send("pipeline", pp=2, dp=2, n_micro=2, cfg_kw=kw, start=start,
               batches=batches, opt={"kind": "sgd", "lr": lr})
    mesh = jax_pipeline.build_pipeline_mesh(2, dp=2)
    optimizer = optax.sgd(lr)
    _, step_fn = jax_pipeline.make_pipeline_train_step(
        jcfg, mesh, n_microbatches=2, optimizer=optimizer)
    specs = jax_pipeline._stage_params_spec(jcfg)
    params = jax.device_put(start, jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                                is_leaf=lambda s: isinstance(s, P)))
    state = jax_pipeline.PipelineTrainState(jnp.zeros((), jnp.int32), params,
                                            optimizer.init(params))
    want = []
    for b in batches:
        state, m = step_fn(state, {"tokens": jnp.asarray(b["tokens"])})
        want.append(float(m["loss"]))
    want_params = jax.device_get(state.params)
    for res in _pipe_results(ranks, 2, 2):
        assert res["step"] == 3
        assert res["losses"] == pytest.approx(want, rel=1e-5)
        moved = 0.0
        for a, b, s in zip(jax.tree.leaves(res["params"]), jax.tree.leaves(want_params),
                           jax.tree.leaves(start)):
            np.testing.assert_allclose(a, b, atol=1e-4)
            moved = max(moved, float(np.abs(a - s).max()))
        assert moved > 1e-3


def test_pipeline_moe_raises_and_dryrun_runs(ranks):
    """MoE: the JAX package's NotImplementedError; `dryrun_pipeline` over
    the four ranks, as JAX's over four devices."""
    mesh = jax_pipeline.build_pipeline_mesh(2, dp=1)
    with pytest.raises(NotImplementedError) as jax_error:
        jax_pipeline.make_pipeline_loss(jax_configs.TINY_MOE, mesh, 2)
    jax_pipeline.dryrun_pipeline(4)
    ranks.send("pipeline_errors")
    for res in ranks.results():
        assert res == {"moe": f"NotImplementedError: {jax_error.value}", "dryrun": "ran"}
