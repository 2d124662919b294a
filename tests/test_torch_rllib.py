"""ray_tpu_torch.rllib against ray_tpu.rllib, on the CPU.

Each case carries the JAX learner's weights across by name
(`rllib/jax_bridge.py`), gives both packages the same batch (numpy, fixed
seed) and the same noise: where the JAX update draws from its key inside
its program, the test draws the same numbers from that key and passes
them to the port's `update(batch, noise)`. One full update of PPO,
IMPALA, APPO, DQN (prioritized weights), SAC and CQLLearner must then
agree in params, optimizer state and metrics within 1e-5 at fp32. The
envs, replay buffers and connectors are copies: the same seeds give equal
results. PPO learns CartPole locally, as tests/test_rllib.py has JAX do,
and the dp LearnerGroup on four gloo ranks matches JAX's learner group on
four devices of its CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import appo as jappo
from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib import cql as jcql
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import dreamerv3 as jdreamer
from ray_tpu.rllib import env as jenv
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib import ppo as jppo
from ray_tpu.rllib import replay_buffer as jreplay
from ray_tpu.rllib import sac as jsac
from ray_tpu.rllib.core import LearnerGroup as JaxLearnerGroup
from ray_tpu.rllib.core import rl_module as jmod
from ray_tpu_torch.rllib import appo, connectors, cql, dqn, env, impala, models, ppo
from ray_tpu_torch.rllib import dreamerv3, replay_buffer, sac
from ray_tpu_torch.rllib.core import rl_module
from ray_tpu_torch.rllib.jax_bridge import (
    learner_state_from_jax,
    rl_params_from_jax,
    rl_params_to_numpy,
)
from test_torch_distributed import Ranks

TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close(got, want, what, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            _close(got[k], want[k], f"{what}/{k}", tol)
        return
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


def _moments(opt_state):
    """The optax state in a chain that holds the moments (Adam: mu/nu
    and count; RMSProp: nu)."""
    if hasattr(opt_state, "nu"):
        return opt_state
    for part in opt_state:
        if isinstance(part, tuple) or hasattr(part, "nu"):
            found = _moments(part)
            if found is not None:
                return found
    return None


def _close_opt(got, want, what):
    """The port's moments by name against optax's; a scalar param's
    (log_alpha) moments are the one entry of the port's dict."""
    m = _moments(want)

    def leaf(tree):
        return tree if isinstance(_np(m.nu), dict) else tree["log_alpha"]

    _close(leaf(got["nu"]), _np(m.nu), f"{what}/nu")
    if hasattr(m, "mu"):
        _close(leaf(got["mu"]), _np(m.mu), f"{what}/mu")
        assert got["count"] == int(m.count), what


def _ppo_batch(E=8, T=16, obs_dim=4, seed=0):
    rng = np.random.default_rng(seed)
    dones = (rng.random((E, T)) < 0.05).astype(np.float32)
    return {
        "obs": rng.normal(size=(E, T, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, 2, size=(E, T)).astype(np.int32),
        "logp": np.log(rng.uniform(0.3, 0.7, (E, T))).astype(np.float32),
        "rewards": rng.normal(size=(E, T)).astype(np.float32),
        "dones": dones,
        "values": rng.normal(size=(E, T)).astype(np.float32),
        "final_value": rng.normal(size=(E,)).astype(np.float32),
    }


def _sac_batch(B=64, obs_dim=3, act_dim=1, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
        "actions": rng.uniform(-2, 2, size=(B, act_dim)).astype(np.float32),
        "rewards": rng.normal(size=(B,)).astype(np.float32),
        "next_obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
        "terminals": (rng.random(B) < 0.1).astype(np.float32),
    }


def _dqn_batch(B=64, obs_dim=4, seed=0):
    """A prioritized replay sample: non-uniform importance weights."""
    rng = np.random.default_rng(seed)
    buf = jreplay.PrioritizedReplayBuffer(512, seed=seed)
    n = 256
    buf.add_batch({
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "terminals": (rng.random(n) < 0.1).astype(np.float32)})
    buf.update_priorities(np.arange(n), rng.exponential(size=n))
    sample = buf.sample(B)
    assert sample["weights"].std() > 0
    return sample


# -- the JAX learners' noise, drawn as their updates draw it ----------------

def _ppo_noise(jl, batch):
    _, key = jax.random.split(jl._rng)
    n = batch["rewards"].size
    return {"perms": np.stack([np.asarray(jax.random.permutation(k, n))
                               for k in jax.random.split(key, jl.hp.num_epochs)])}


def _sac_noise(jl, batch, act_dim=1):
    _, key = jax.random.split(jl._rng)
    k1, k2 = jax.random.split(key)
    shape = (len(batch["rewards"]), act_dim)
    return {"next": np.asarray(jax.random.normal(k1, shape)),
            "pi": np.asarray(jax.random.normal(k2, shape))}


def _cql_noise(jl, batch, act_dim=1):
    _, key = jax.random.split(jl._rng)
    k1, k2 = jax.random.split(key)
    k_next, k_rand, k_pi = jax.random.split(k1, 3)
    B, n, lim = len(batch["rewards"]), jl._cql_n, jl.hp.act_limit
    return {
        "next": np.asarray(jax.random.normal(k_next, (B, act_dim))),
        "rand": np.asarray(jax.random.uniform(k_rand, (n, B, act_dim),
                                              minval=-lim, maxval=lim)),
        "pi_cql": np.stack([np.asarray(jax.random.normal(k, (B, act_dim)))
                            for k in jax.random.split(k_pi, n)]),
        "pi": np.asarray(jax.random.normal(k2, (B, act_dim)))}


# -- networks ---------------------------------------------------------------

def _obs(n=16, d=4, seed=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_policy_and_q_networks_match_jax():
    key = jax.random.PRNGKey(0)
    obs = _obs()
    jp = _np(jmodels.init_mlp_policy(key, 4, 3, (32, 16)))
    tp = rl_params_from_jax(jp, "cpu")
    logits_j, value_j = jmodels.apply_mlp_policy(jp, obs)
    logits_t, value_t = models.apply_mlp_policy(tp, _t(obs))
    _close(logits_t, logits_j, "logits")
    _close(value_t, value_j, "value")
    jq = _np(jmodels.init_mlp_q(key, 4, 3))
    _close(models.apply_mlp_q(rl_params_from_jax(jq, "cpu"), _t(obs)),
           jmodels.apply_mlp_q(jq, obs), "q")


def test_sac_networks_and_squashed_sampling_match_jax():
    key = jax.random.PRNGKey(1)
    obs, act = _obs(d=3), np.random.default_rng(4).uniform(
        -2, 2, (16, 2)).astype(np.float32)
    ja = _np(jmodels.init_sac_actor(key, 3, 2))
    # Widen the last layer so log_std reaches both clip bounds.
    ja["actor_w2"] = ja["actor_w2"] * 400.0
    jc = _np(jmodels.init_twin_q(key, 3, 2))
    ta, tc = rl_params_from_jax(ja, "cpu"), rl_params_from_jax(jc, "cpu")
    mu_j, ls_j = jmodels.apply_sac_actor(ja, obs)
    mu_t, ls_t = models.apply_sac_actor(ta, _t(obs))
    assert float(jnp.max(ls_j)) == models.LOG_STD_MAX
    _close(mu_t, mu_j, "mu")
    _close(ls_t, ls_j, "log_std")
    mu, ls = np.asarray(mu_j), np.clip(np.asarray(ls_j), -3, 1)
    k = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(k, mu.shape))
    a_j, logp_j = jmodels.sample_squashed(jnp.asarray(mu), jnp.asarray(ls), k, 2.0)
    a_t, logp_t = models.sample_squashed(_t(mu), _t(ls), _t(noise), 2.0)
    _close(a_t, a_j, "action")
    _close(logp_t, logp_j, "logp")
    for got, want in zip(models.apply_twin_q(tc, _t(obs), _t(act)),
                         jmodels.apply_twin_q(jc, obs, act)):
        _close(got, want, "twin q")


def test_rl_modules_match_jax():
    obs = _obs()
    jm = jmod.MLPPolicyModule(4, 2)
    jp = _np(jm.init(jax.random.PRNGKey(2)))
    tm = rl_module.MLPPolicyModule(4, 2)
    tp = rl_params_from_jax(jp, "cpu")
    assert set(tp) == set(tm.init(torch.Generator().manual_seed(0)))
    for got, want in zip(tm.forward_train(tp, _t(obs)), jm.forward_train(jp, obs)):
        _close(got, want, "forward_train")
    np.testing.assert_array_equal(tm.forward_inference(tp, _t(obs)).numpy(),
                                  np.asarray(jm.forward_inference(jp, obs)))
    a = tm.forward_exploration(tp, _t(obs), torch.Generator().manual_seed(0))
    assert a.shape == (16,) and set(a.tolist()) <= {0, 1}

    jq, tq = jmod.DiscreteQModule(4, 3), rl_module.DiscreteQModule(4, 3)
    qp = _np(jq.init(jax.random.PRNGKey(3)))
    np.testing.assert_array_equal(
        tq.forward_inference(rl_params_from_jax(qp, "cpu"), _t(obs)).numpy(),
        np.asarray(jq.forward_inference(qp, obs)))
    g = torch.Generator().manual_seed(0)
    greedy = tq.forward_exploration(rl_params_from_jax(qp, "cpu"), _t(obs), g, 0.0)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jq.forward_inference(qp, obs)))

    multi = rl_module.MultiRLModule({"pi": tm, "q": tq})
    params = multi.init(torch.Generator().manual_seed(0))
    assert multi.module_ids() == ["pi", "q"] and set(params) == {"pi", "q"}
    out = multi.forward_inference(params, {"pi": _t(obs), "q": _t(obs)})
    assert out["pi"].shape == out["q"].shape == (16,)
    explored = multi.forward_exploration(params, {"pi": _t(obs), "q": _t(obs)},
                                         torch.Generator().manual_seed(1))
    assert set(explored) == {"pi", "q"}


def test_bridge_checks_names_and_shapes():
    like = {"w": torch.zeros(2, 3, requires_grad=True)}
    out = rl_params_from_jax({"w": np.ones((2, 3))}, "cpu", like=like)
    assert out["w"].requires_grad and out["w"].dtype == torch.float32
    with pytest.raises(ValueError, match="keys"):
        rl_params_from_jax({"v": np.ones((2, 3))}, "cpu", like=like)
    with pytest.raises(ValueError, match="shape"):
        rl_params_from_jax({"w": np.ones((3, 2))}, "cpu", like=like)
    np.testing.assert_array_equal(rl_params_to_numpy({"a": {"w": out["w"]}})["a"]["w"],
                                  np.ones((2, 3)))

    # DreamerV3's state: three trees, the slow critic, three optax Adam
    # chains and return_scale, by name into the port's learner.
    hp_kw = dict(deter_dim=8, num_categoricals=2, num_classes=3, units=8, num_bins=5)
    jl = jdreamer.DreamerV3Learner(3, 2, jdreamer.DreamerV3Hyperparams(**hp_kw))
    jstate = _np(jl.get_state())
    jstate["wm_opt"] = jl._wm_tx.update(jstate["wm_params"], jstate["wm_opt"])[1]
    jstate["return_scale"] = np.float32(1.5)
    state = learner_state_from_jax(jstate)
    assert "rng" not in state and state["wm_opt"]["count"] == 1
    tl = dreamerv3.DreamerV3Learner(3, 2, dreamerv3.DreamerV3Hyperparams(**hp_kw),
                                    device="cpu")
    tl.set_state(state)
    got = tl.get_state()
    for name in ("wm_params", "actor_params", "critic_params", "slow_critic"):
        _close(got[name], jstate[name], name, tol=0)
    for name in ("wm_opt", "actor_opt", "critic_opt"):
        _close_opt(got[name], jstate[name], name)
    assert got["return_scale"] == np.float32(1.5)
    assert tl.wm_params["gru_wr"].requires_grad
    for tree, key, value in (("wm_params", "gru_wx", np.zeros((16, 8))),
                             ("actor_params", "actor_w0", np.zeros((3, 8)))):
        bad = dict(state, **{tree: dict(state[tree], **{key: value})})
        with pytest.raises(ValueError, match="keys" if key == "gru_wx" else "shape"):
            tl.set_state(bad)


# -- one update of each learner ----------------------------------------------

@pytest.mark.parametrize("epochs,mb", [(2, 32), (3, 200)])
def test_ppo_update_matches_jax(epochs, mb):
    hp_kw = dict(num_epochs=epochs, minibatch_size=mb)
    jl = jppo.PPOLearner(4, 2, jppo.PPOHyperparams(**hp_kw), seed=0,
                         hidden=(32, 32))
    tl = ppo.PPOLearner(4, 2, ppo.PPOHyperparams(**hp_kw), seed=0,
                        hidden=(32, 32), device="cpu")
    tl.set_state({"params": jl.get_weights()})
    for step in range(2):
        batch = _ppo_batch(seed=step)
        noise = _ppo_noise(jl, batch)
        jm = jl.update(batch)
        tm = tl.update(batch, noise)
        _close(tm, jm, f"step {step} metrics")
        _close(tl.get_weights(), _np(jl.params), f"step {step} params")
        _close_opt(tl.get_state()["opt_state"], jl.opt_state, f"step {step} adam")


@pytest.mark.parametrize("kind", ["impala", "appo"])
def test_impala_and_appo_updates_match_jax(kind):
    jmod_, tmod_ = {"impala": (jimpala, impala), "appo": (jappo, appo)}[kind]
    jcls = jmod_.AppoLearner if kind == "appo" else jmod_.ImpalaLearner
    tcls = tmod_.AppoLearner if kind == "appo" else tmod_.ImpalaLearner
    jhp = (jappo.AppoHyperparams if kind == "appo" else jimpala.ImpalaHyperparams)()
    thp = (appo.AppoHyperparams if kind == "appo" else impala.ImpalaHyperparams)()
    jl = jcls(4, 2, jhp, seed=0)
    tl = tcls(4, 2, thp, seed=0, device="cpu")
    tl.set_weights(jl.get_weights())
    for step in range(2):
        batch = _ppo_batch(seed=10 + step)
        jm, tm = jl.update(batch), tl.update(batch)
        _close(tm, jm, f"{kind} step {step} metrics")
        _close(tl.get_weights(), _np(jl.params), f"{kind} step {step} params")
        _close_opt(tl.get_state()["opt_state"], jl.opt_state, f"{kind} rmsprop")


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches_jax(double_q):
    hp_kw = dict(double_q=double_q, target_network_update_freq=2)
    jl = jdqn.DQNLearner(4, 2, jdqn.DQNHyperparams(**hp_kw), seed=0)
    tl = dqn.DQNLearner(4, 2, dqn.DQNHyperparams(**hp_kw), seed=0, device="cpu")
    js = jl.get_state()
    tl.set_state({"params": js["params"], "target_params": js["target_params"]})
    for step in range(3):
        batch = _dqn_batch(seed=step)
        j_loss, j_td = jl.update(batch)
        t_loss, t_td = tl.update(batch)
        _close(t_loss, j_loss, f"step {step} loss")
        _close(t_td, j_td, f"step {step} td")
        state = tl.get_state()
        _close(state["params"], _np(jl.params), f"step {step} params")
        _close(state["target_params"], _np(jl.target_params), f"step {step} target")
        _close_opt(state["opt_state"], jl.opt_state, f"step {step} adam")
        assert state["updates"] == jl.get_state()["updates"]


def _sac_pair(kind):
    hp_kw = dict(act_limit=2.0, target_entropy=-1.0)
    if kind == "cql":
        jl = jcql.CQLLearner(3, 1, jsac.SACHyperparams(**hp_kw), cql_n_actions=3,
                             seed=0)
        tl = cql.CQLLearner(3, 1, sac.SACHyperparams(**hp_kw), cql_n_actions=3,
                            seed=0, device="cpu")
    else:
        jl = jsac.SACLearner(3, 1, jsac.SACHyperparams(**hp_kw), seed=0)
        tl = sac.SACLearner(3, 1, sac.SACHyperparams(**hp_kw), seed=0, device="cpu")
    js = jl.get_state()
    tl.set_state({k: js[k] for k in ("actor", "critic", "target_critic", "log_alpha")})
    return jl, tl


@pytest.mark.parametrize("kind", ["sac", "cql"])
def test_sac_and_cql_updates_match_jax(kind):
    jl, tl = _sac_pair(kind)
    draw = _cql_noise if kind == "cql" else _sac_noise
    for step in range(2):
        batch = _sac_batch(seed=20 + step)
        noise = draw(jl, batch)
        jm = jl.update(batch)
        tm = tl.update(batch, noise)
        _close(tm, jm, f"{kind} step {step} metrics")
        state = tl.get_state()
        for name in ("actor", "critic", "target_critic", "log_alpha"):
            _close(state[name], _np(getattr(jl, name)), f"{kind} {name}")
        for name in ("actor_opt", "critic_opt", "alpha_opt"):
            _close_opt(state[name], getattr(jl, name), f"{kind} {name}")


def test_learner_state_round_trip_resumes_exactly():
    """get_state/set_state (numpy) carries params, optimizer moments and
    the noise generator: a restored learner repeats the next update."""
    batch = _sac_batch(seed=5)
    a = sac.SACLearner(3, 1, sac.SACHyperparams(), seed=0, device="cpu")
    a.update(batch)
    state = a.get_state()
    assert isinstance(state["rng"], np.ndarray) and state["actor_opt"]["count"] == 1
    b = sac.SACLearner(3, 1, sac.SACHyperparams(), seed=9, device="cpu")
    b.set_state(state)
    assert a.update(batch) == b.update(batch)
    _close(b.get_state()["critic"], a.get_state()["critic"], "critic", tol=0)


def test_learners_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ppo.PPOLearner(4, 2, ppo.PPOHyperparams())
    with pytest.raises(RuntimeError, match="CUDA"):
        ppo.PPOConfig().environment("CartPole-v1").build()


# -- envs, replay buffers, connectors: copies, equal on the same seeds ------

@pytest.mark.parametrize("name,actions", [
    ("CartPole-v1", lambda rng, n: rng.integers(0, 2, n)),
    ("Pendulum-v1", lambda rng, n: rng.uniform(-2.5, 2.5, (n, 1))),
])
def test_envs_equal_jax(name, actions):
    je, te = jenv.make_env(name, 4, seed=3), env.make_env(name, 4, seed=3)
    np.testing.assert_array_equal(je.reset(), te.reset())
    rng = np.random.default_rng(0)
    finished = 0
    for _ in range(260):
        a = actions(rng, 4)
        for got, want in zip(te.step(a), je.step(a)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(te.truncateds, je.truncateds)
        np.testing.assert_array_equal(te.final_obs, je.final_obs)
        finished += int(te.truncateds.sum())
    if name == "Pendulum-v1":
        assert finished == 4   # the 200-step time limit


def test_env_registry():
    env.register_env("tiny-cartpole", lambda num_envs, seed: env.CartPoleVecEnv(
        num_envs=num_envs, seed=seed))
    assert env.make_env("tiny-cartpole", 2).num_envs == 2
    # An unknown name goes to gymnasium, or raises ValueError without it,
    # in both packages alike.
    errors = []
    for make in (jenv.make_env, env.make_env):
        with pytest.raises(Exception) as info:
            make("NoSuchEnv-v0", 1)
        errors.append(type(info.value))
    assert errors[0] is errors[1]


def _transitions(n, seed):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 3)).astype(np.float32),
            "rewards": rng.normal(size=n).astype(np.float32)}


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_buffers_equal_jax(prioritized):
    kw = dict(alpha=0.7, beta=0.5) if prioritized else {}
    jcls = jreplay.PrioritizedReplayBuffer if prioritized else jreplay.ReplayBuffer
    tcls = replay_buffer.PrioritizedReplayBuffer if prioritized \
        else replay_buffer.ReplayBuffer
    jb, tb = jcls(100, seed=1, **kw), tcls(100, seed=1, **kw)
    for i in range(4):
        batch = _transitions(40, i)   # wraps the ring
        jb.add_batch(batch)
        tb.add_batch(batch)
        js, ts = jb.sample(16), tb.sample(16)
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k])
        prio = np.random.default_rng(i).exponential(size=16)
        jb.update_priorities(js["batch_indexes"], prio)
        tb.update_priorities(ts["batch_indexes"], prio)
    assert len(tb) == len(jb) == 100


def test_sequence_replay_buffer_equals_jax():
    jb, tb = jreplay.SequenceReplayBuffer(32, seed=2), \
        replay_buffer.SequenceReplayBuffer(32, seed=2)
    rng = np.random.default_rng(0)
    for t in range(50):
        for e in range(3):
            rec = {"obs": rng.normal(size=2).astype(np.float32),
                   "is_first": np.float32(t == 0)}
            jb.add(e, rec)
            tb.add(e, rec)
    assert tb.can_sample(8) and len(tb) == len(jb)
    js, ts = jb.sample(5, 8), tb.sample(5, 8)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])


def test_connectors_equal_jax():
    pipes = [cls.ConnectorPipeline([cls.ObsNormalizer(clip=3.0), cls.ObsClip(-2, 2)])
             for cls in (jconn, connectors)]
    rng = np.random.default_rng(0)
    for _ in range(5):
        obs = rng.normal(2.0, 3.0, size=(8, 4)).astype(np.float32)
        np.testing.assert_array_equal(pipes[1](obs), pipes[0](obs))
    js, ts = pipes[0].get_state(), pipes[1].get_state()
    assert js["0"]["count"] == ts["0"]["count"] == 40
    np.testing.assert_array_equal(ts["0"]["m2"], js["0"]["m2"])
    fresh = connectors.ConnectorPipeline([connectors.ObsNormalizer(clip=3.0),
                                          connectors.ObsClip(-2, 2)])
    fresh.set_state(ts)
    obs = rng.normal(size=(2, 4)).astype(np.float32)
    np.testing.assert_array_equal(fresh(obs), pipes[0](obs))
    act = rng.normal(size=(4, 1)) * 5
    np.testing.assert_array_equal(connectors.ActionClip(-2, 2)(act),
                                  jconn.ActionClip(-2, 2)(act))
    batch = {"rewards": np.ones(3), "obs": np.zeros(3)}
    np.testing.assert_array_equal(connectors.RewardScale(0.5)(batch)["rewards"],
                                  jconn.RewardScale(0.5)(batch)["rewards"])


# -- the algorithms, locally on the CPU --------------------------------------

def test_ppo_learns_cartpole_local():
    config = (
        ppo.PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                     rollout_fragment_length=128)
        .training(lr=3e-4, minibatch_size=256, num_epochs=4, entropy_coeff=0.01)
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = config.build()
    best, first = 0.0, None
    for _ in range(40):
        ret = algo.train().get("episode_return_mean")
        if ret is not None:
            first = ret if first is None else first
            best = max(best, ret)
            if best >= 150.0:
                break
    assert first is not None
    assert best >= 150.0, f"PPO failed to learn CartPole: first={first} best={best}"


def _small(config, **runners):
    return (config.env_runners(num_envs_per_env_runner=4,
                               rollout_fragment_length=16, **runners)
            .resources(device="cpu").debugging(seed=0))


@pytest.mark.parametrize("kind", ["ppo", "impala", "appo", "dqn", "sac"])
def test_algorithms_train_save_restore_evaluate(kind, tmp_path):
    env_name = "Pendulum-v1" if kind == "sac" else "CartPole-v1"
    config = {"ppo": ppo.PPOConfig().training(minibatch_size=32, num_epochs=2),
              "impala": impala.ImpalaConfig(),
              "appo": appo.APPOConfig(),
              "dqn": dqn.DQNConfig().training(train_batch_size=32,
                                              learning_starts=32,
                                              num_updates_per_iteration=2),
              "sac": sac.SACConfig().training(train_batch_size=32,
                                              learning_starts=32,
                                              num_updates_per_iteration=2)}[kind]
    algo = _small(config.environment(env_name)).evaluation(
        evaluation_interval=2, evaluation_duration=2).build()
    algo.train()
    m = algo.train()
    assert m["training_iteration"] == 2.0
    assert "evaluation/episode_return_mean" in m
    losses = [v for k, v in m.items() if "loss" in k]
    assert losses and all(np.isfinite(losses))
    ckpt = algo.save(str(tmp_path / "ckpt"))
    w = algo.get_weights()
    algo.train()
    algo.restore(ckpt)
    _close(algo.get_weights(), w, "restored weights", tol=0)
    _close(algo.workers[0]._params, w, "broadcast weights", tol=0)
    algo.stop()


def test_obs_normalizer_state_survives_save_restore(tmp_path):
    config = _small(ppo.PPOConfig().environment("CartPole-v1").training(
        minibatch_size=32, num_epochs=1), env_to_module_connector=lambda: [
            connectors.ObsNormalizer()])
    algo = config.build()
    algo.train()
    ckpt = algo.save(str(tmp_path))
    count = algo._connector_state()["0"]["count"]
    algo.train()
    algo.restore(ckpt)
    assert algo._connector_state()["0"]["count"] == count


def test_what_needs_the_runtime_raises():
    """What the port has not ported raises: CQL's offline reader is item
    10b, and configs that contradict themselves are errors. Remote runners
    and learners no longer raise: with the runtime down, building them
    starts a cluster (`test_remote_ppo_across_processes_matches_jax`)."""
    import ray_tpu_torch

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    base = lambda: ppo.PPOConfig().environment("CartPole-v1").resources(device="cpu")  # noqa: E731
    with pytest.raises(NotImplementedError, match="item 10b"):
        cql.CQLConfig().environment("Pendulum-v1").offline_data(
            input_path="unused").resources(device="cpu").build()
    with pytest.raises(ValueError, match="remote_learners"):
        base().learners(remote_learners=True).build()
    with pytest.raises(ValueError, match="continuous"):
        sac.SACConfig().environment("CartPole-v1").resources(device="cpu").build()
    assert not ray_tpu_torch.is_initialized()


# -- remote runners and learner actors in worker processes -------------------

def _gumbel_by_seed(seeds, num_envs, num_actions, draws=96):
    """Each JAX rollout worker's action noise: its key chain (PRNGKey(seed +
    1), split once a policy step) drawing Gumbel as jax.random.categorical
    does; numpy arrays, so the port's workers need no JAX."""
    out = {}
    for seed in seeds:
        key, noise = jax.random.PRNGKey(seed + 1), []
        for _ in range(draws):
            key, sub = jax.random.split(key)
            noise.append(np.asarray(jax.random.gumbel(sub, (num_envs, num_actions))))
        out[seed] = noise
    return out


def _jax_draw_runner(gumbel_by_seed):
    """A port RolloutWorker that samples with JAX's Gumbel draws. Defined in a
    function, so cloudpickle ships it by value to the worker processes."""
    from ray_tpu_torch.rllib import rollout_worker
    from ray_tpu_torch.rllib.models import apply_mlp_policy

    class JaxDrawRunner(rollout_worker.RolloutWorker):
        def __init__(self, env, num_envs=8, seed=0, **kw):
            super().__init__(env, num_envs=num_envs, seed=seed, **kw)
            self._gumbel = list(gumbel_by_seed[seed])

        def _policy_step(self, obs):
            with torch.no_grad():
                logits, value = apply_mlp_policy(self._params, self._dev(obs))
                gumbel = torch.as_tensor(self._gumbel.pop(0), dtype=logits.dtype,
                                         device=logits.device)
                actions = torch.argmax(logits + gumbel, -1)
                logp = torch.log_softmax(logits, -1).gather(1, actions[:, None])[:, 0]
            return actions, logp, value

    return JaxDrawRunner


def test_remote_ppo_across_processes_matches_jax(monkeypatch):
    """PPO with 2 remote env runners and 2 remote learner actors, each in a
    worker process of its runtime's cluster, which building the algorithm
    starts (one runtime at a time). JAX's run records its weights, metrics,
    averaged Adam state and each learner actor's permutations (drawn from
    the actor's key, read before each update); the port's, from JAX's
    weights, under JAX's action draws and permutations, agrees at 1e-5."""
    import types

    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.core.distributed.core_worker import DistributedCoreWorker as JaxWorker
    from ray_tpu_torch.core.distributed.core_worker import DistributedCoreWorker
    from ray_tpu_torch.rllib import algorithm as talgorithm

    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()

    def configure(config):
        return (config.environment("CartPole-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                             rollout_fragment_length=16)
                .training(minibatch_size=32, num_epochs=2).debugging(seed=0)
                .learners(num_learners=2, remote_learners=True))

    record = {"metrics": [], "weights": [], "adam": [], "noise": []}
    try:
        jalgo = configure(jppo.PPOConfig()).build()
        assert isinstance(ray_tpu.api._worker, JaxWorker)
        start = _np(jalgo.get_weights())
        group, update = jalgo.learner, jalgo.learner.update

        def recorded_update(batch):
            states = ray_tpu.get([a.get_state.remote() for a in group._actors])
            record["noise"].append([
                _ppo_noise(types.SimpleNamespace(_rng=st["rng"], hp=types.SimpleNamespace(
                    num_epochs=2)), shard)
                for st, shard in zip(states, group._split(batch))])
            return update(batch)

        group.update = recorded_update
        for _ in range(2):
            record["metrics"].append(jalgo.train())
            record["weights"].append(_np(jalgo.get_weights()))
            record["adam"].append(group.get_state()["opt_state"])
        jalgo.stop()
    finally:
        ray_tpu.shutdown()

    gumbel = _gumbel_by_seed([1000, 2000], num_envs=4, num_actions=2)
    runner = _jax_draw_runner(gumbel)
    make_class = talgorithm._remote_runner_class

    def remote_runner_class(config):
        make_class(config)     # starts the runtime, as the algorithm does
        return ray_tpu_torch.remote(num_cpus=config.num_cpus_per_env_runner)(runner)

    monkeypatch.setattr(talgorithm, "_remote_runner_class", remote_runner_class)
    try:
        talgo = configure(ppo.PPOConfig().resources(device="cpu")).build()
        assert isinstance(ray_tpu_torch.api._worker, DistributedCoreWorker)
        talgo.set_weights(start)
        update = talgo.learner.update
        noises = iter(record["noise"])
        talgo.learner.update = lambda batch, noise=None: update(batch, next(noises))
        for it in range(2):
            _close(talgo.train(), record["metrics"][it], f"iteration {it} metrics")
            _close(talgo.get_weights(), record["weights"][it], f"iteration {it} weights")
            _close_opt(talgo.learner.get_state()["opt_state"], record["adam"][it],
                       f"iteration {it} adam")
        talgo.stop()
    finally:
        ray_tpu_torch.shutdown()


# -- remote runners and learner actors against JAX's, both in local mode -----

@pytest.fixture
def local_runtimes():
    """Both runtimes in local mode, shut down whatever happens."""
    import ray_tpu
    import ray_tpu_torch

    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    try:
        ray_tpu.init(local_mode=True)
        ray_tpu_torch.init(local_mode=True)
        yield ray_tpu, ray_tpu_torch
    finally:
        ray_tpu.shutdown()
        ray_tpu_torch.shutdown()


def _actor_instances(rt, cls) -> list:
    """The instances of `cls` hosted by `rt`'s local engine, in creation order."""
    return [a.instance for a in rt.api._worker._actors.values()
            if isinstance(a.instance, cls)]


def _sample_with_jax_draws(monkeypatch):
    """The port's rollout workers draw JAX's actions: each keeps the JAX
    worker's key chain (PRNGKey(seed + 1), split once a step) and samples
    argmax(logits + Gumbel) as jax.random.categorical does."""
    from ray_tpu_torch.rllib import rollout_worker
    from ray_tpu_torch.rllib.models import apply_mlp_policy

    init = rollout_worker.RolloutWorker.__init__

    def __init__(self, env, num_envs=8, seed=0, **kw):
        init(self, env, num_envs=num_envs, seed=seed, **kw)
        self._jax_key = jax.random.PRNGKey(seed + 1)

    @torch.no_grad()
    def _policy_step(self, obs):
        self._jax_key, key = jax.random.split(self._jax_key)
        logits, value = apply_mlp_policy(self._params, self._dev(obs))
        gumbel = _t(jax.random.gumbel(key, tuple(logits.shape)))
        actions = torch.argmax(logits + gumbel, -1)
        logp = torch.log_softmax(logits, -1).gather(1, actions[:, None])[:, 0]
        return actions, logp, value

    monkeypatch.setattr(rollout_worker.RolloutWorker, "__init__", __init__)
    monkeypatch.setattr(rollout_worker.RolloutWorker, "_policy_step", _policy_step)


@pytest.mark.parametrize("case", ["env_runners", "evaluation", "remote_learners"])
def test_remote_ppo_matches_jax(local_runtimes, monkeypatch, case):
    """PPO with 2 remote env runners, with 1 remote evaluation runner, and
    with 2 remote learner actors (behind 3 remote runners): two iterations
    from JAX's weights, under JAX's action draws and permutations, agree
    with JAX's in metrics, weights and (learner actors) the averaged Adam
    state at 1e-5."""
    from ray_tpu.rllib.core import learner_group as jlg
    from ray_tpu_torch.rllib.core import learner_group as tlg

    jrt, trt = local_runtimes
    _sample_with_jax_draws(monkeypatch)

    # The learners' case splits 3 runners x 3 envs into shards of 5 and 4
    # envs, so the average's row weights matter.
    runners, envs = {"env_runners": (2, 4), "evaluation": (0, 4),
                     "remote_learners": (3, 3)}[case]

    def configure(config):
        config = (config.environment("CartPole-v1")
                  .env_runners(num_env_runners=runners, num_envs_per_env_runner=envs,
                               rollout_fragment_length=16)
                  .training(minibatch_size=32, num_epochs=2).debugging(seed=0))
        if case == "evaluation":
            config = config.evaluation(evaluation_interval=1, evaluation_num_env_runners=1,
                                       evaluation_duration=3)
        if case == "remote_learners":
            config = config.learners(num_learners=2, remote_learners=True)
        return config

    jalgo = configure(jppo.PPOConfig()).build()
    talgo = configure(ppo.PPOConfig().resources(device="cpu")).build()
    talgo.set_weights(_np(jalgo.get_weights()))
    if case == "remote_learners":
        jactors = _actor_instances(jrt, jlg._LearnerActor)
        tactors = _actor_instances(trt, tlg._LearnerActor)
        assert [a.index for a in jactors] == [a.index for a in tactors] == [0, 1]
        learners = [(j.learner, t.learner) for j, t in zip(jactors, tactors)]
    else:
        learners = [(jalgo.learner, talgo.learner)]
    for jl, tl in learners:
        # The port's update draws, before JAX's runs, JAX's permutations
        # for the same shard.
        tl.draw_noise = lambda batch, jl=jl: _ppo_noise(jl, batch)
    for it in range(2):
        tm = talgo.train()
        jm = jalgo.train()
        _close(tm, jm, f"iteration {it} metrics")
        _close(talgo.get_weights(), _np(jalgo.get_weights()), f"iteration {it} weights")
        if case == "remote_learners":
            got, want = talgo.learner.get_state(), jalgo.learner.get_state()
            _close_opt(got["opt_state"], want["opt_state"], f"iteration {it} adam")
            for jl, tl in learners:  # every actor holds the average
                _close(tl.get_weights(), _np(jl.params), f"iteration {it} actor params")
    if case == "evaluation":
        assert "evaluation/episode_return_mean" in tm
    talgo.stop()
    jalgo.stop()


def test_learner_group_of_one_is_the_learner():
    from ray_tpu_torch.rllib.core import LearnerGroup

    hp = ppo.PPOHyperparams(minibatch_size=32, num_epochs=2)
    single = ppo.PPOLearner(4, 2, hp, seed=0, device="cpu")
    group = LearnerGroup(lambda mesh=None: ppo.PPOLearner(
        4, 2, hp, seed=0, mesh=mesh, device="cpu"), num_learners=1)
    batch = _ppo_batch()
    noise = single.draw_noise(batch)
    assert single.update(batch, noise) == group.update(batch, noise)
    _close(group.get_weights(), single.get_weights(), "weights", tol=0)
    with pytest.raises(ValueError, match="ranks"):
        LearnerGroup(lambda mesh=None: None, num_learners=2, device_type="cpu")


# -- the dp LearnerGroup on four gloo ranks against JAX's on four devices --

@pytest.fixture(scope="module")
def ranks():
    pool = Ranks()
    yield pool
    pool.close()


def _jax_group(kind):
    make = {
        "ppo": lambda mesh=None: jppo.PPOLearner(
            4, 2, jppo.PPOHyperparams(minibatch_size=32, num_epochs=2),
            seed=0, mesh=mesh),
        "impala": lambda mesh=None: jimpala.ImpalaLearner(
            4, 2, jimpala.ImpalaHyperparams(), seed=0, mesh=mesh),
        "dqn": lambda mesh=None: jdqn.DQNLearner(
            4, 2, jdqn.DQNHyperparams(), seed=0, mesh=mesh),
        "sac": lambda mesh=None: jsac.SACLearner(
            3, 1, jsac.SACHyperparams(act_limit=2.0), seed=0, mesh=mesh),
        "cql": lambda mesh=None: jcql.CQLLearner(
            3, 1, jsac.SACHyperparams(act_limit=2.0), cql_n_actions=2, seed=0,
            mesh=mesh),
    }[kind]
    return JaxLearnerGroup(make, num_learners=4)


@pytest.mark.parametrize("kind", ["ppo", "impala", "dqn", "sac", "cql"])
def test_learner_group_on_four_ranks_matches_jax(ranks, kind):
    group = _jax_group(kind)
    jl = group._learner
    start = {k: v for k, v in group.get_state().items()
             if k in ("params", "target_params", "actor", "critic",
                      "target_critic", "log_alpha")}
    batches = [{"ppo": _ppo_batch, "impala": _ppo_batch, "dqn": _dqn_batch,
                "sac": _sac_batch, "cql": _sac_batch}[kind](seed=s) for s in range(2)]
    noises, want = [], []
    for batch in batches:
        noises.append({"ppo": _ppo_noise, "sac": _sac_noise,
                       "cql": _cql_noise}.get(kind, lambda *a: None)(jl, batch))
        out = group.update(batch)
        want.append(out if isinstance(out, dict) else
                    {"loss": out[0], "td": np.asarray(out[1])})
    ranks.send("rl_learner_group", kind=kind, start=start, batches=batches,
               noises=noises)
    results = ranks.results()
    state = _np(group.get_state())
    for rank, got in enumerate(results):
        for step, (g, w) in enumerate(zip(got["metrics"], want)):
            _close(g, w, f"rank {rank} step {step}")
        for name, value in got["state"].items():
            if name == "rng":
                continue
            if name.endswith("opt") or name == "opt_state":
                _close_opt(value, getattr(jl, name), f"rank {rank} {name}")
            else:
                _close(value, state[name], f"rank {rank} {name}")
