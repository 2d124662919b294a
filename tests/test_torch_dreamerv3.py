"""ray_tpu_torch.rllib.dreamerv3 against ray_tpu.rllib.dreamerv3, on the CPU.

At tests/test_rllib_dreamerv3.py's tiny hyperparameters, every case
carries the JAX learner's weights (and, for an update, its whole state)
across by name (`rllib/jax_bridge.py`), gives both packages the same numpy
batch and the same noise, and holds the port to JAX at fp32 within 1e-5.
Where JAX samples from a key inside its program, the test draws the same
numbers from that key as the program splits it (a categorical sample is
argmax(logits + Gumbel draws)) and passes them to the port. The two-hot
bins are JAX's: `jnp.linspace` and `torch.linspace` part by up to 1e-6,
which can move a value on a bin edge into the next bin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ray_tpu.rllib import dreamerv3 as jd
from ray_tpu_torch.rllib import dreamerv3 as td
from ray_tpu_torch.rllib.jax_bridge import learner_state_from_jax, rl_params_from_jax
from test_torch_distributed import Ranks
from test_torch_rllib import TOL, _close, _close_opt, _np

HP_KW = dict(deter_dim=32, num_categoricals=4, num_classes=4, units=32,
             num_bins=9, batch_size=4, batch_length=6, horizon=4)
JHP, THP = jd.DreamerV3Hyperparams(**HP_KW), td.DreamerV3Hyperparams(**HP_KW)
OBS_DIM = 3
KINDS = ["discrete", "continuous"]
TREES = ("wm_params", "actor_params", "critic_params", "slow_critic")
OPTS = ("wm_opt", "actor_opt", "critic_opt")


def _specs(kind):
    return jd.ActSpec(kind, 2, 2.0), td.ActSpec(kind, 2, 2.0)


def _batch(kind, seed, B=4, L=6):
    """A replay window with episode starts and (continuous) terminals."""
    rng = np.random.default_rng(seed)
    prev_a = (rng.integers(0, 2, (B, L)) if kind == "discrete"
              else rng.uniform(-1, 1, (B, L, 2)).astype(np.float32))
    return {"obs": rng.normal(size=(B, L, OBS_DIM)).astype(np.float32),
            "prev_action": prev_a,
            "reward": (rng.normal(size=(B, L)) * 3).astype(np.float32),
            "is_first": (rng.random((B, L)) < 0.15).astype(np.float32),
            "cont": (rng.random((B, L)) > 0.1).astype(np.float32)}


def _t(x):
    return torch.from_numpy(np.array(x))


# -- JAX's draws, split from its keys as its program splits them -------------

def _gumbel(key, shape):
    return np.asarray(jax.random.gumbel(key, shape))


def _action_draw(key, shape, kind):
    return (_gumbel(key, shape) if kind == "discrete"
            else np.asarray(jax.random.normal(key, shape)))


def _post_noise(k_wm, B, L, hp):
    """_observe: keys = split(k_wm, L); one categorical a step."""
    return np.stack([_gumbel(k, (B, hp.num_categoricals, hp.num_classes))
                     for k in jax.random.split(k_wm, L)])


def _imagine_noise(k_img, N, hp, spec):
    """_imagine: keys = split(k_img, H); each step's ka, kz = split(k)."""
    prior, act = [], []
    for k in jax.random.split(k_img, hp.horizon):
        ka, kz = jax.random.split(k)
        prior.append(_gumbel(kz, (N, hp.num_categoricals, hp.num_classes)))
        act.append(_action_draw(ka, (N, spec.n), spec.kind))
    return {"prior": np.stack(prior), "act": np.stack(act)}


def _update_noise(jl, batch):
    """The draws of JAX's next `update`: its key from `_rng`, then
    k_wm, k_img = split(key)."""
    B, L = batch["obs"].shape[:2]
    _, key = jax.random.split(jl._rng)
    k_wm, k_img = jax.random.split(key)
    return {"post": _post_noise(k_wm, B, L, jl.hp),
            **_imagine_noise(k_img, B * L, jl.hp, jl.act_spec)}


def _policy_noise(key, N, hp, spec):
    """policy_step: kz, ka = split(key) (the reverse of _imagine's order)."""
    kz, ka = jax.random.split(key)
    return {"z": _t(_gumbel(kz, (N, hp.num_categoricals, hp.num_classes))),
            "a": _t(_action_draw(ka, (N, spec.n), spec.kind))}


def _pair(kind, seed=0):
    """A JAX learner and a port learner on the CPU holding its whole state
    (the JAX key aside) and its bins."""
    jspec, tspec = _specs(kind)
    jl = jd.DreamerV3Learner(OBS_DIM, jspec, JHP, seed=seed)
    tl = td.DreamerV3Learner(OBS_DIM, tspec, THP, seed=seed, device="cpu")
    tl.set_state(learner_state_from_jax(_np(jl.get_state())))
    tl.bins = _t(jl.bins)
    return jl, tl


def _close_state(tl, jl, what):
    state = tl.get_state()
    for name in TREES:
        _close(state[name], _np(getattr(jl, name)), f"{what} {name}")
    for name in OPTS:
        _close_opt(state[name], getattr(jl, name), f"{what} {name}")
    _close(state["return_scale"], np.asarray(jl.return_scale), f"{what} return_scale")


# -- pure pieces ---------------------------------------------------------------

@pytest.mark.parametrize("num_bins", [9, 41])
def test_symlog_twohot_and_bins_match_jax(num_bins):
    jbins = jnp.linspace(-20.0, 20.0, num_bins)
    tbins = torch.linspace(-20.0, 20.0, num_bins)
    # The port's own bins: within 1e-6 of JAX's.
    np.testing.assert_allclose(tbins.numpy(), np.asarray(jbins), atol=1e-6, rtol=0)
    x = np.array([-1e3, -20.0, -3.3, -1e-3, 0.0, 1e-3, 0.5, 7.0, 20.0, 1e3],
                 np.float32)
    _close(td.symlog(_t(x)), jd.symlog(x), "symlog")
    y = np.array([-20.0, -2.5, 0.0, 0.7, 11.0], np.float32)
    _close(td.symexp(_t(y)), jd.symexp(y), "symexp")
    # In range, on bin edges and beyond both ends (the clamps).
    rng = np.random.default_rng(num_bins)
    vals = np.concatenate([rng.uniform(-25, 25, 64), np.asarray(jbins)[::3],
                           [-1e4, -20.5, 20.5, 1e4]]).astype(np.float32)
    enc_t = td.twohot(_t(vals), _t(jbins))
    _close(enc_t, jd.twohot(vals, jbins), "twohot")
    assert float(enc_t[-4, 0]) == float(enc_t[-1, -1]) == 1.0
    logits = rng.normal(size=(5, 7, num_bins)).astype(np.float32)
    _close(td.twohot_decode(_t(logits), _t(jbins)), jd.twohot_decode(logits, jbins),
           "twohot_decode")


def _jax_nets(kind, seed=0):
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    jspec, _ = _specs(kind)
    return (_np(jd.init_world_model(k1, OBS_DIM, jspec.input_dim, JHP)),
            _np(jd.init_actor(k2, jspec.actor_out_dim, JHP)),
            _np(jd.init_critic(k3, JHP)))


@pytest.mark.parametrize("kind", KINDS)
def test_networks_gru_and_kl_match_jax(kind):
    wm, actor, critic = _jax_nets(kind)
    _, tspec = _specs(kind)
    gen = torch.Generator().manual_seed(0)
    # The port draws its own init with the same names, shapes and scales.
    for got, want in ((td.init_world_model(gen, OBS_DIM, tspec.input_dim, THP), wm),
                      (td.init_actor(gen, tspec.actor_out_dim, THP), actor),
                      (td.init_critic(gen, THP), critic)):
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
    twm, tact, tcrit = (rl_params_from_jax(p, "cpu") for p in (wm, actor, critic))
    rng = np.random.default_rng(1)
    h = rng.normal(size=(8, JHP.deter_dim)).astype(np.float32)
    x = rng.normal(size=(8, JHP.stoch_dim + 2)).astype(np.float32)
    _close(td._apply_gru(twm, "gru", _t(h), _t(x)), jd._apply_gru(wm, "gru", h, x), "gru")
    feat = rng.normal(size=(8, JHP.feat_dim)).astype(np.float32)
    for prefix, params, tparams in (("dec", wm, twm), ("rew", wm, twm),
                                    ("cont", wm, twm), ("actor", actor, tact),
                                    ("critic", critic, tcrit)):
        _close(td._apply_mlp(tparams, prefix, _t(feat)),
               jd._apply_mlp(params, prefix, feat), prefix)
    out = rng.normal(size=(8, 4)).astype(np.float32) * 4   # past both clips
    for got, want in zip(td._actor_dist(_t(out)), jd._actor_dist(out)):
        _close(got, want, "actor dist")
    p, q = (rng.normal(size=(8, 4, 4)).astype(np.float32) * 3 for _ in range(2))
    _close(td._mixed_probs(_t(p), THP), jd._mixed_probs(p, JHP), "mixed probs")
    _close(td._kl_cat(_t(p), _t(q), THP), jd._kl_cat(p, q, JHP), "kl")


def test_sample_latent_matches_jax_value_and_straight_through_grad():
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(16, 4, 4)) * 2).astype(np.float32)
    weight = rng.normal(size=(16, 4, 4)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    sample = jd._sample_latent(logits, key, JHP)
    want_grad = jax.grad(lambda lg: (jd._sample_latent(lg, key, JHP) * weight).sum())(logits)
    lg = _t(logits).requires_grad_()
    got = td._sample_latent(lg, _t(_gumbel(key, logits.shape)), THP)
    _close(got, sample, "sample")
    # The forward value is the one-hot of JAX's categorical draw.
    np.testing.assert_array_equal(
        got.argmax(-1).numpy(),
        np.asarray(jax.random.categorical(key, jnp.log(jd._mixed_probs(logits, JHP)))))
    (got * _t(weight)).sum().backward()
    _close(lg.grad, want_grad, "straight-through grad")


@pytest.mark.parametrize("kind", KINDS)
def test_observe_matches_jax(kind):
    jl, tl = _pair(kind)
    batch = _batch(kind, seed=3)
    key = jax.random.PRNGKey(11)
    want = jl._observe(jl.wm_params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    B, L = batch["obs"].shape[:2]
    b = {k: _t(v) for k, v in batch.items()}
    got = tl._observe(tl.wm_params, b, _t(_post_noise(key, B, L, JHP)))
    for name, g, w in zip(("feats", "hs", "zs", "priors", "posts"), got, want):
        _close(g, w, name)


@pytest.mark.parametrize("kind", KINDS)
def test_imagine_matches_jax(kind):
    jl, tl = _pair(kind)
    rng = np.random.default_rng(4)
    N = 12
    h0 = rng.normal(size=(N, JHP.deter_dim)).astype(np.float32)
    z0 = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (N, 4))]
    key = jax.random.PRNGKey(12)
    feats_j, actions_j = jl._imagine(jl.wm_params, jl.actor_params, h0, z0, key)
    nz = _imagine_noise(key, N, JHP, jl.act_spec)
    with torch.set_grad_enabled(kind == "continuous"):
        feats_t, actions_t = tl._imagine(tl.wm_params, tl.actor_params, _t(h0), _t(z0),
                                         _t(nz["prior"]), _t(nz["act"]))
    _close(feats_t, feats_j, "feats")
    _close(actions_t, actions_j, "actions")


# -- the fused update ----------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_two_updates_match_jax(kind):
    jl, tl = _pair(kind)
    _close_state(tl, jl, "start")
    for step in range(2):
        batch = _batch(kind, seed=10 + step)
        noise = _update_noise(jl, batch)
        jm = jl.update(batch)
        tm = tl.update(batch, noise)
        assert set(tm) == set(jm)
        _close(tm, jm, f"{kind} step {step} metrics")
        _close_state(tl, jl, f"{kind} step {step}")
    assert tl.get_state()["wm_opt"]["count"] == 2


@pytest.mark.parametrize("kind", KINDS)
def test_policy_step_matches_jax_and_resets_on_first(kind):
    jl, tl = _pair(kind)
    N = 3
    rng = np.random.default_rng(6)
    h = rng.normal(size=(N, JHP.deter_dim)).astype(np.float32)
    z = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (N, 4))]
    prev_a = (np.eye(2, dtype=np.float32)[[1, 0, 1]] if kind == "discrete"
              else rng.uniform(-1, 1, (N, 2)).astype(np.float32))
    obs = rng.normal(size=(N, OBS_DIM)).astype(np.float32)
    first = np.array([1.0, 0.0, 0.0], np.float32)
    key = jax.random.PRNGKey(7)
    noise = _policy_noise(key, N, JHP, jl.act_spec)
    for greedy in (False, True):
        want = jl.policy_step(h, z, prev_a, obs, first, key, greedy=greedy)
        got = tl.policy_step(h, z, prev_a, obs, first, noise, greedy=greedy)
        for name, g, w in zip(("action", "h", "z"), got, want):
            _close(g, w, f"greedy={greedy} {name}")
    # A fresh env's step equals one from an all-zero carry.
    _, h1, _ = tl.policy_step(h, z, prev_a, obs, first, noise)
    _, h0, _ = tl.policy_step(np.zeros_like(h), np.zeros_like(z), np.zeros_like(prev_a),
                              obs, np.zeros(N, np.float32), noise)
    np.testing.assert_array_equal(h1[0].numpy(), h0[0].numpy())
    assert not np.allclose(h1[1].numpy(), h0[1].numpy())


def test_state_round_trip_repeats_the_next_update():
    """get_state/set_state carries the trees, the slow critic, the Adam
    moments, return_scale and the noise generator."""
    _, tspec = _specs("discrete")
    a = td.DreamerV3Learner(OBS_DIM, tspec, THP, seed=0, device="cpu")
    a.update(_batch("discrete", seed=1))
    state = a.get_state()
    assert isinstance(state["rng"], np.ndarray) and state["critic_opt"]["count"] == 1
    b = td.DreamerV3Learner(OBS_DIM, tspec, THP, seed=9, device="cpu")
    b.set_state(state)
    batch = _batch("discrete", seed=2)
    assert a.update(batch) == b.update(batch)
    for name in TREES:
        _close(b.get_state()[name], a.get_state()[name], name, tol=0)


def test_learners_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        td.DreamerV3Learner(OBS_DIM, 2, THP)
    with pytest.raises(RuntimeError, match="CUDA"):
        td.DreamerV3Config().environment("CartPole-v1").build()


# -- dp on four gloo ranks against JAX's four-device mesh ----------------------

@pytest.fixture(scope="module")
def ranks():
    pool = Ranks()
    yield pool
    pool.close()


@pytest.mark.parametrize("kind", KINDS)
def test_learner_on_four_ranks_matches_jax_mesh(ranks, kind):
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    jspec, _ = _specs(kind)
    jl = jd.DreamerV3Learner(OBS_DIM, jspec, JHP, seed=0, mesh=mesh)
    start = learner_state_from_jax(_np(jl.get_state()))
    batches = [_batch(kind, seed=30 + s) for s in range(2)]
    noises, want = [], []
    for batch in batches:
        noises.append(_update_noise(jl, batch))
        want.append(jl.update(batch))
    ranks.send("rl_dreamer", kind=kind, hp_kw=HP_KW, obs_dim=OBS_DIM, start=start,
               bins=np.asarray(jl.bins), batches=batches, noises=noises)
    for rank, got in enumerate(ranks.results()):
        for step, (g, w) in enumerate(zip(got["metrics"], want)):
            _close(g, w, f"rank {rank} step {step}")
        for name in TREES:
            _close(got["state"][name], _np(getattr(jl, name)), f"rank {rank} {name}")
        for name in OPTS:
            _close_opt(got["state"][name], getattr(jl, name), f"rank {rank} {name}")
        _close(got["state"]["return_scale"], np.asarray(jl.return_scale), "return_scale")


# -- the algorithm, locally on the CPU -------------------------------------------

def _small_config(env):
    return (td.DreamerV3Config()
            .environment(env)
            .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=16)
            .training(deter_dim=32, num_categoricals=4, num_classes=4, units=32,
                      num_bins=9, batch_size=4, batch_length=8, horizon=4,
                      num_updates_per_iteration=2, learning_starts=64)
            .resources(device="cpu")
            .debugging(seed=0))


@pytest.mark.parametrize("env", ["CartPole-v1", "Pendulum-v1"])
def test_dreamerv3_trains_saves_restores_evaluates(env, tmp_path):
    algo = _small_config(env).build()
    assert algo.act_spec.kind == ("continuous" if env == "Pendulum-v1" else "discrete")
    algo.train()
    m = algo.train()
    assert m["training_iteration"] == 2.0 and m["replay_size"] > 0
    losses = [v for k, v in m.items() if "loss" in k]
    assert len(losses) == 6 and all(np.isfinite(losses)), m
    ckpt = algo.save(str(tmp_path / "ckpt"))
    algo2 = _small_config(env).build()
    algo2.restore(ckpt)
    _close(algo2.get_weights(), algo.get_weights(), "restored weights", tol=0)
    _close(algo2.learner.get_state()["critic_opt"]["mu"],
           algo.learner.get_state()["critic_opt"]["mu"], "restored moments", tol=0)
    assert algo2.evaluate()["evaluation/num_episodes"] >= 1
    if env == "Pendulum-v1":   # replayed actions are normalized vectors
        prev = algo.replay._streams[0]["prev_action"]
        assert prev.shape[1:] == (1,) and np.abs(prev).max() <= 1.0 + 1e-6
    algo.stop()


def test_dreamerv3_replay_records_terminals():
    """Episode ends store the terminal observation with cont=0 and mark
    the auto-reset successor is_first=1 (the on-arrival convention)."""
    algo = _small_config("CartPole-v1").build()
    algo._collect(200)
    st, n = algo.replay._streams[0], algo.replay._len[0]
    ends = np.where(st["cont"][:n] == 0.0)[0]
    assert len(ends) > 0
    for e in ends:
        if e + 1 < n:
            assert st["is_first"][e + 1] == 1.0
    assert (st["reward"][ends] == 1.0).all()


def test_dreamerv3_rejects_remote_runners_learners_and_connectors():
    with pytest.raises(ValueError, match="algorithm's own process"):
        _small_config("CartPole-v1").env_runners(num_env_runners=2).build()
    with pytest.raises(ValueError, match="learner_mesh"):
        _small_config("CartPole-v1").learners(num_learners=2).build()
    with pytest.raises(ValueError, match="connector"):
        _small_config("CartPole-v1").env_runners(
            env_to_module_connector=lambda: None).build()
