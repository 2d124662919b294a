"""DreamerV3: model-based RL with a categorical-latent world model,
counterpart of `ray_tpu/rllib/dreamerv3.py`.

ref: rllib/algorithms/dreamerv3/ (Hafner et al. 2023, "Mastering Diverse
Domains through World Models"): an RSSM world model (sequence GRU and
categorical latents), an actor and a critic trained on imagined rollouts,
symlog predictions with two-hot reward and value heads, percentile return
normalization and a critic held to its slow EMA.

Where the JAX update is one jitted program with `lax.scan`s, `update`
here runs the same steps eagerly and in its order:
1. the world model's step, on the posterior scan over the [B, L] window
   (a Python loop over L);
2. imagination from every posterior state of that scan, detached (the
   pre-update states), rolled H steps through the post-update world model;
3. the actor's step, whose loss also moves the return scale (an EMA of
   the 5th-95th percentile span of all imagined returns);
4. the critic's step on the actor loss's detached feats and returns (the
   values came from the pre-update critic), then the slow critic's EMA.
Each loss is differentiated with respect to its own tree only
(`torch.autograd.grad`). Discrete actions train by REINFORCE over a
detached rollout; continuous actions by dynamics backprop: the rollout
stays live, so the actor's gradient flows through the GRU, the prior, the
heads, the critic and the straight-through latents, never into their
params.

Noise: `jax.random.categorical(key, logits)` is argmax(logits + Gumbel
draws), so every sample here takes its Gumbel (or, for continuous actions,
standard-normal) draws as an argument: `draw_noise(batch)` for an update,
`policy_noise(n, generator)` for a policy step. A test can then feed the
port the numbers JAX drew from its key.

Under a dp `DeviceMesh` every rank takes its rows of B, and so of the
N = B*L imagined starts; the means are shares of the global counts, the
gradients are summed over dp before they are clipped, and the percentile
is taken over the returns gathered from every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.env import VectorEnv, make_env
from ray_tpu_torch.rllib.jax_bridge import rl_params_from_jax, rl_params_to_numpy
from ray_tpu_torch.rllib.models import Params, _apply_mlp, _init_mlp
from ray_tpu_torch.rllib.optim import Adam, clip_grads_
from ray_tpu_torch.rllib.replay_buffer import SequenceReplayBuffer

BATCH_KEYS = ("obs", "prev_action", "reward", "is_first", "cont")

# ---------------------------------------------------------------------------
# symlog / two-hot (Hafner et al. 2023, "Robust predictions")
# ---------------------------------------------------------------------------


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def twohot(y: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Scalar y (any shape) -> distribution over `bins` [K] putting mass
    on the two neighbours proportionally to proximity (exact expectation
    for in-range y; clamped at the edges)."""
    num = bins.shape[0]
    k = torch.searchsorted(bins, y.contiguous()).clamp(1, num - 1)
    lo, hi = bins[k - 1], bins[k]
    w_hi = ((y - lo) / (hi - lo)).clamp(0.0, 1.0)
    return (F.one_hot(k - 1, num) * (1.0 - w_hi)[..., None]
            + F.one_hot(k, num) * w_hi[..., None])


def twohot_decode(logits: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    return (torch.softmax(logits, -1) * bins).sum(-1)


# ---------------------------------------------------------------------------
# hyperparams
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DreamerV3Hyperparams:
    deter_dim: int = 256
    num_categoricals: int = 16
    num_classes: int = 16
    units: int = 256            # width of every MLP (2 hidden layers)
    num_bins: int = 41          # two-hot bins for reward/value, symlog space
    batch_size: int = 16
    batch_length: int = 16
    horizon: int = 15
    gamma: float = 0.997
    lam: float = 0.95
    unimix: float = 0.01
    free_bits: float = 1.0
    kl_dyn_scale: float = 0.5
    kl_rep_scale: float = 0.1
    ent_coef: float = 3e-4
    lr_world: float = 1e-3
    lr_actor: float = 3e-4
    lr_critic: float = 3e-4
    grad_clip: float = 100.0
    return_norm_decay: float = 0.99
    slow_critic_decay: float = 0.98
    slow_reg_scale: float = 1.0

    @property
    def stoch_dim(self) -> int:
        return self.num_categoricals * self.num_classes

    @property
    def feat_dim(self) -> int:
        return self.deter_dim + self.stoch_dim


@dataclasses.dataclass(frozen=True)
class ActSpec:
    """Action-space description. `n` is the action count (discrete) or
    the action dimension (continuous); continuous actions live in
    [-limit, limit]^n and are fed to the networks normalized to
    [-1, 1]."""

    kind: str            # "discrete" | "continuous"
    n: int
    limit: float = 1.0

    @property
    def input_dim(self) -> int:
        """Width of the action input to the sequence model."""
        return self.n

    @property
    def actor_out_dim(self) -> int:
        return self.n if self.kind == "discrete" else 2 * self.n


# ---------------------------------------------------------------------------
# networks (flat param dicts, models.py conventions)
# ---------------------------------------------------------------------------


def _init_gru(generator: torch.Generator, prefix: str, in_dim: int, hid: int,
              params: Params) -> None:
    for gate in ("r", "z", "n"):
        params[f"{prefix}_w{gate}"] = torch.randn(
            in_dim + hid, hid, generator=generator,
            device=generator.device) * math.sqrt(1.0 / (in_dim + hid))
        params[f"{prefix}_b{gate}"] = torch.zeros(hid, device=generator.device)


def _apply_gru(params: Params, prefix: str, h: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    hx = torch.cat([h, x], -1)
    r = torch.sigmoid(hx @ params[f"{prefix}_wr"] + params[f"{prefix}_br"])
    z = torch.sigmoid(hx @ params[f"{prefix}_wz"] + params[f"{prefix}_bz"])
    rx = torch.cat([r * h, x], -1)
    n = torch.tanh(rx @ params[f"{prefix}_wn"] + params[f"{prefix}_bn"])
    return (1.0 - z) * n + z * h


def init_world_model(generator: torch.Generator, obs_dim: int, act_in_dim: int,
                     hp: DreamerV3Hyperparams) -> Params:
    p: Params = {}
    u, d, s = hp.units, hp.deter_dim, hp.stoch_dim
    _init_mlp(generator, "enc", [obs_dim, u, u], p)
    _init_gru(generator, "gru", s + act_in_dim, d, p)
    _init_mlp(generator, "prior", [d, u, s], p)
    _init_mlp(generator, "post", [d + u, u, s], p)
    _init_mlp(generator, "dec", [hp.feat_dim, u, u, obs_dim], p)
    _init_mlp(generator, "rew", [hp.feat_dim, u, u, hp.num_bins], p,
              final_scale=0.0)   # zero-init: predict 0 at start
    _init_mlp(generator, "cont", [hp.feat_dim, u, u, 1], p)
    return p


def init_actor(generator: torch.Generator, out_dim: int,
               hp: DreamerV3Hyperparams) -> Params:
    p: Params = {}
    _init_mlp(generator, "actor", [hp.feat_dim, hp.units, hp.units, out_dim],
              p, final_scale=0.01)
    return p


def init_critic(generator: torch.Generator, hp: DreamerV3Hyperparams) -> Params:
    p: Params = {}
    _init_mlp(generator, "critic",
              [hp.feat_dim, hp.units, hp.units, hp.num_bins], p, final_scale=0.0)
    return p


LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0
_HALF_LOG_2PI_E = 0.5 * math.log(2.0 * math.pi * math.e)


def _actor_dist(out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Continuous actor head -> (mu, clipped log_std): imagination, acting
    and the loss all decode through here."""
    mu, log_std = out.chunk(2, dim=-1)
    return mu, log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)


def _mixed_probs(logits: torch.Tensor, hp: DreamerV3Hyperparams) -> torch.Tensor:
    """1% uniform mix keeps every class reachable (bounds the KL)."""
    probs = torch.softmax(logits, -1)
    return (1.0 - hp.unimix) * probs + hp.unimix / hp.num_classes


def _categorical(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical(key, logits, axis=-1) given the key's Gumbel
    draws (logits' shape): argmax(logits + gumbel), the first on a tie."""
    return (logits + gumbel).argmax(-1)


def _sample_latent(logits: torch.Tensor, gumbel: torch.Tensor,
                   hp: DreamerV3Hyperparams) -> torch.Tensor:
    """Straight-through one-hot sample from [.., ncat, ncls] logits, with
    the Gumbel draws (logits' shape) that pick it."""
    probs = _mixed_probs(logits, hp)
    idx = _categorical(torch.log(probs), gumbel)
    onehot = F.one_hot(idx, hp.num_classes).to(probs.dtype)
    return onehot + probs - probs.detach()


def _kl_cat(p_logits: torch.Tensor, q_logits: torch.Tensor,
            hp: DreamerV3Hyperparams) -> torch.Tensor:
    """KL(p || q) summed over categoricals -> [...] (batch dims)."""
    p = _mixed_probs(p_logits, hp)
    q = _mixed_probs(q_logits, hp)
    return (p * (torch.log(p) - torch.log(q))).sum((-2, -1))


def _gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, as jax.random.gumbel makes them from
    uniforms in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


# ---------------------------------------------------------------------------
# learner
# ---------------------------------------------------------------------------


class DreamerV3Learner(Learner):
    """World model + actor + critic in one update."""

    _state_attrs = ("wm_params", "actor_params", "critic_params",
                    "slow_critic", "wm_opt", "actor_opt", "critic_opt",
                    "return_scale", "_rng")
    # Noise of an update: the posterior's Gumbel draws [L, B, ncat, ncls],
    # the prior's [H, N, ncat, ncls] and the actions' [H, N, n]; a rank
    # takes its rows of B (axis 1) and so of N = B*L (axis 1).
    _NOISE_AXES = {"post": 1, "prior": 1, "act": 1}

    def __init__(self, obs_dim: int, act_spec: "ActSpec | int",
                 hp: DreamerV3Hyperparams, seed: int = 0,
                 mesh: Optional[DeviceMesh] = None,
                 device: torch.device | str = "cuda"):
        if isinstance(act_spec, int):  # convenience: N discrete actions
            act_spec = ActSpec("discrete", act_spec)
        self.hp = hp
        self.obs_dim = obs_dim
        self.act_spec = act_spec
        init_gen = self._setup(device, mesh, seed)
        # Symlog space. JAX's linspace parts from torch's by up to 1e-6.
        self.bins = torch.linspace(-20.0, 20.0, hp.num_bins, device=self.device)
        self.wm_params = self._params_on_device(
            init_world_model(init_gen, obs_dim, act_spec.input_dim, hp))
        self.actor_params = self._params_on_device(
            init_actor(init_gen, act_spec.actor_out_dim, hp))
        self.critic_params = self._params_on_device(init_critic(init_gen, hp))
        self.slow_critic = {k: p.detach().clone()
                            for k, p in self.critic_params.items()}
        self._wm_tx = Adam(hp.lr_world)
        self._actor_tx = Adam(hp.lr_actor)
        self._critic_tx = Adam(hp.lr_critic)
        self.wm_opt = self._wm_tx.init(self.wm_params)
        self.actor_opt = self._actor_tx.init(self.actor_params)
        self.critic_opt = self._critic_tx.init(self.critic_params)
        # EMA of percentile(R, 95) - percentile(R, 5): the advantage scale.
        self.return_scale = torch.ones((), device=self.device)

    # The rollout/eval side needs both wm and actor.
    def get_weights(self) -> Any:
        return {"wm": rl_params_to_numpy(self.wm_params),
                "actor": rl_params_to_numpy(self.actor_params)}

    def set_weights(self, weights: Any) -> None:
        self.wm_params = rl_params_from_jax(weights["wm"], self.device,
                                            like=self.wm_params)
        self.actor_params = rl_params_from_jax(weights["actor"], self.device,
                                               like=self.actor_params)

    # -- noise ------------------------------------------------------------
    def _action_noise(self, shape, generator: torch.Generator) -> torch.Tensor:
        if self.act_spec.kind == "discrete":
            return _gumbel(shape, generator)
        return torch.randn(shape, generator=generator, device=generator.device)

    def draw_noise(self, batch: Dict[str, Any]) -> dict:
        """The update's draws for a global [B, L] batch (see _NOISE_AXES)."""
        hp = self.hp
        B, L = np.shape(batch["obs"])[:2]
        N, H = B * L, hp.horizon
        cat = (hp.num_categoricals, hp.num_classes)
        return {"post": _gumbel((L, B, *cat), self._rng),
                "prior": _gumbel((H, N, *cat), self._rng),
                "act": self._action_noise((H, N, self.act_spec.n), self._rng)}

    def policy_noise(self, n: int, generator: torch.Generator) -> dict:
        """A policy step's draws for n envs: the latent's Gumbel draws and
        the action's, from `generator` (on the learner's device)."""
        hp = self.hp
        return {"z": _gumbel((n, hp.num_categoricals, hp.num_classes), generator),
                "a": self._action_noise((n, self.act_spec.n), generator)}

    # -- model pieces ---------------------------------------------------
    def _act_input(self, a: torch.Tensor) -> torch.Tensor:
        """Action(s) -> sequence-model input: one-hot for discrete,
        the normalized [-1, 1] vector unchanged for continuous."""
        if self.act_spec.kind == "discrete":
            return F.one_hot(a.long(), self.act_spec.n).float()
        return a.float()

    def _observe(self, wm: Params, b: Dict[str, torch.Tensor],
                 post_noise: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """RSSM posterior scan over the [B, L] window. Returns feats
        [B, L, F], hs, zs and the prior/post logits [B, L, ncat, ncls]."""
        hp = self.hp
        B, L = b["obs"].shape[:2]
        cat = (hp.num_categoricals, hp.num_classes)
        embed = _apply_mlp(wm, "enc", symlog(b["obs"]))          # [B,L,U]
        prev_a = self._act_input(b["prev_action"])
        first = b["is_first"].float()
        h = torch.zeros(B, hp.deter_dim, device=self.device)
        z = torch.zeros(B, *cat, device=self.device)
        hs, zs, priors, posts = [], [], [], []
        for t in range(L):
            keep = (1.0 - first[:, t])[:, None]
            h = h * keep
            z = z * keep[..., None]
            pa = prev_a[:, t] * keep
            h = _apply_gru(wm, "gru", h, torch.cat([z.reshape(B, -1), pa], -1))
            prior_logits = _apply_mlp(wm, "prior", h).reshape(B, *cat)
            post_logits = _apply_mlp(
                wm, "post", torch.cat([h, embed[:, t]], -1)).reshape(B, *cat)
            z = _sample_latent(post_logits, post_noise[t], hp)
            hs.append(h)
            zs.append(z)
            priors.append(prior_logits)
            posts.append(post_logits)
        hs, zs = torch.stack(hs, 1), torch.stack(zs, 1)
        feats = torch.cat([hs, zs.reshape(B, L, -1)], -1)
        return feats, hs, zs, torch.stack(priors, 1), torch.stack(posts, 1)

    def _imagine(self, wm: Params, actor: Params, h0: torch.Tensor,
                 z0: torch.Tensor, prior_noise: torch.Tensor,
                 act_noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Roll the prior H steps with actor actions from the detached
        [N, ...] starts: feats [H+1, N, F] and the actions [H, N, ...].

        The caller runs the discrete rollout under no_grad (REINFORCE
        re-scores its samples); the continuous one stays live, which is
        the whole dynamics-backprop estimator."""
        hp = self.hp
        N = h0.shape[0]
        h, z = h0, z0
        feats, actions = [], []
        for t in range(hp.horizon):
            feat = torch.cat([h, z.reshape(N, -1)], -1)
            out = _apply_mlp(actor, "actor", feat)
            if self.act_spec.kind == "discrete":
                a = _categorical(out, act_noise[t])
                a_in = F.one_hot(a, self.act_spec.n).float()
                a_rec = a          # action index, for the logp lookup
            else:
                mu, log_std = _actor_dist(out)
                a_rec = mu + torch.exp(log_std) * act_noise[t]   # reparameterized
                a_in = torch.tanh(a_rec)
            h = _apply_gru(wm, "gru", h, torch.cat([z.reshape(N, -1), a_in], -1))
            prior_logits = _apply_mlp(wm, "prior", h).reshape(
                N, hp.num_categoricals, hp.num_classes)
            z = _sample_latent(prior_logits, prior_noise[t], hp)
            feats.append(feat)
            actions.append(a_rec)
        feats.append(torch.cat([h, z.reshape(N, -1)], -1))
        return torch.stack(feats), torch.stack(actions)

    def _rollout_scalars(self, wm: Params, critic: Params, feats: torch.Tensor):
        """World-model heads, lambda returns and the trajectory weights
        along an imagined trajectory (carrying actor gradients when the
        feats do)."""
        hp, bins = self.hp, self.bins
        rewards = symexp(twohot_decode(_apply_mlp(wm, "rew", feats[1:]), bins))
        conts = torch.sigmoid(_apply_mlp(wm, "cont", feats[1:])[..., 0])
        values = symexp(twohot_decode(_apply_mlp(critic, "critic", feats), bins))
        ret, returns = values[-1], []
        for t in reversed(range(hp.horizon)):
            ret = rewards[t] + hp.gamma * conts[t] * (
                (1.0 - hp.lam) * values[t + 1] + hp.lam * ret)
            returns.append(ret)
        returns = torch.stack(returns[::-1])                    # [H, N]
        # Trajectory weights: the probability that the rollout is alive
        # entering each state (terminals cut future losses).
        w = torch.cat([torch.ones_like(conts[:1]),
                       torch.cumprod(conts[:-1], 0)], 0).detach()
        return returns, values, w

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """x of every dp rank, concatenated on axis 1 (x as is at dp 1)."""
        if self._world == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self._world)]
        dist.all_gather(parts, x.contiguous(), group=self._group)
        return torch.cat(parts, 1)

    # -- the update -------------------------------------------------------
    def _wm_loss(self, b, post_noise, count: int):
        """This rank's share of the world-model loss (a mean over the
        global B*L) and of its metrics; hs/zs of the posterior scan."""
        hp, bins = self.hp, self.bins
        wm = self.wm_params
        feats, hs, zs, priors, posts = self._observe(wm, b, post_noise)
        obs_hat = _apply_mlp(wm, "dec", feats)
        recon = ((obs_hat - symlog(b["obs"])) ** 2).sum(-1)
        rew_target = twohot(symlog(b["reward"]), bins)
        rew_loss = -(rew_target
                     * torch.log_softmax(_apply_mlp(wm, "rew", feats), -1)).sum(-1)
        cont_logit = _apply_mlp(wm, "cont", feats)[..., 0]
        cont_loss = F.binary_cross_entropy_with_logits(
            cont_logit, b["cont"].float(), reduction="none")
        dyn = _kl_cat(posts.detach(), priors, hp).clamp_min(hp.free_bits)
        rep = _kl_cat(posts, priors.detach(), hp).clamp_min(hp.free_bits)
        loss = (recon + rew_loss + cont_loss + hp.kl_dyn_scale * dyn
                + hp.kl_rep_scale * rep).sum() / count
        metrics = {"world_model_loss": loss, "recon_loss": recon.sum() / count,
                   "reward_loss": rew_loss.sum() / count,
                   "cont_loss": cont_loss.sum() / count, "kl_dyn": dyn.sum() / count}
        return loss, metrics, hs, zs

    def _actor_loss(self, h0, z0, nz, count: int):
        """This rank's share of the actor loss (a mean over the global
        H*N), its metrics, and what the critic's step needs: the detached
        feats and returns, the weights and the new return scale."""
        hp = self.hp
        actor = self.actor_params
        discrete = self.act_spec.kind == "discrete"
        with torch.set_grad_enabled(not discrete):
            feats, actions = self._imagine(self.wm_params, actor, h0, z0,
                                           nz["prior"], nz["act"])
            returns, values, w = self._rollout_scalars(self.wm_params,
                                                       self.critic_params, feats)
        # Return normalization over every rank's returns (no gradient
        # through the normalizer).
        sg_ret = returns.detach()
        every = self._gather(sg_ret).flatten()
        span = torch.quantile(every, 0.95) - torch.quantile(every, 0.05)
        scale_new = (hp.return_norm_decay * self.return_scale
                     + (1.0 - hp.return_norm_decay) * span)
        inv = 1.0 / torch.clamp_min(scale_new, 1.0)
        out = _apply_mlp(actor, "actor", feats[:-1])
        if discrete:
            logp = torch.log_softmax(out, -1)
            probs = torch.softmax(out, -1)
            taken = logp.gather(-1, actions[..., None])[..., 0]   # [H,N]
            entropy = -(probs * logp).sum(-1)
            adv = ((returns - values[:-1]) * inv).detach()
            loss = -(w * (adv * taken + hp.ent_coef * entropy)).sum() / count
        else:
            mu, log_std = _actor_dist(out)
            # Gaussian entropy (the tanh correction adds no useful
            # gradient to the bonus).
            entropy = (log_std + _HALF_LOG_2PI_E).sum(-1)
            # Dynamics backprop: maximize the normalized lambda returns
            # directly through the rollout.
            loss = -(w * (returns * inv + hp.ent_coef * entropy)).sum() / count
        metrics = {"actor_loss": loss, "entropy": entropy.sum() / count,
                   "imagined_return_mean": sg_ret.sum() / count}
        return loss, metrics, (feats.detach(), sg_ret, w, scale_new)

    def _critic_loss(self, feats, returns, w, count: int):
        hp, bins = self.hp, self.bins
        ret_target = twohot(symlog(returns), bins)                # [H,N,K]
        with torch.no_grad():
            slow_probs = torch.softmax(
                _apply_mlp(self.slow_critic, "critic", feats[:-1]), -1)
        logp = torch.log_softmax(
            _apply_mlp(self.critic_params, "critic", feats[:-1]), -1)
        ce = -(ret_target * logp).sum(-1)
        reg = -(slow_probs * logp).sum(-1) * hp.slow_reg_scale
        return (w * (ce + reg)).sum() / count

    def _step(self, tx: Adam, loss, params: dict, opt_state: dict, metrics: dict):
        """d loss / d params alone, summed over dp, clipped by global norm,
        then one Adam step in place; returns the metrics summed over dp."""
        grads, metrics = self._grads_and_metrics(loss, params, metrics)
        clip_grads_(grads, self.hp.grad_clip)
        tx.update(grads, opt_state, params)
        return metrics

    def update(self, batch: Dict[str, Any],
               noise: Optional[dict] = None) -> Dict[str, float]:
        hp = self.hp
        if noise is None:
            noise = self.draw_noise(batch)
        B, L = np.shape(batch["obs"])[:2]
        b = self._local(batch, BATCH_KEYS)
        nz = self._slices(noise, self._NOISE_AXES)

        wm_loss, wm_metrics, hs, zs = self._wm_loss(b, nz["post"], B * L)
        metrics = self._step(self._wm_tx, wm_loss, self.wm_params, self.wm_opt,
                             wm_metrics)

        # Imagination from every posterior state: the pre-update states,
        # detached, rolled through the post-update world model.
        n_local = hs.shape[0] * L
        h0 = hs.detach().reshape(n_local, -1)
        z0 = zs.detach().reshape(n_local, hp.num_categoricals, hp.num_classes)
        count = hp.horizon * B * L
        a_loss, a_metrics, (feats, returns, w, scale) = self._actor_loss(
            h0, z0, nz, count)
        metrics.update(self._step(self._actor_tx, a_loss, self.actor_params,
                                  self.actor_opt, a_metrics))
        self.return_scale = scale

        c_loss = self._critic_loss(feats, returns, w, count)
        metrics.update(self._step(self._critic_tx, c_loss, self.critic_params,
                                  self.critic_opt, {"critic_loss": c_loss}))
        with torch.no_grad():
            decay = hp.slow_critic_decay
            self.slow_critic = {
                k: decay * s + (1.0 - decay) * self.critic_params[k]
                for k, s in self.slow_critic.items()}
        metrics["return_scale"] = scale
        return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))

    # -- recurrent acting ----------------------------------------------
    def _on_device(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def policy_step(self, h, z, prev_a, obs, first, noise: dict,
                    greedy: bool = False):
        """One recurrent policy step for an [N]-env batch, with the draws
        of `policy_noise(N, ...)`. Returns (action, h, z); continuous
        actions come back NORMALIZED to [-1, 1] (scale by the action
        limit before env.step)."""
        hp = self.hp
        wm, actor = self.wm_params, self.actor_params
        h, z, prev_a = (self._on_device(x) for x in (h, z, prev_a))
        obs, first = self._on_device(obs), self._on_device(first)
        N = obs.shape[0]
        keep = (1.0 - first)[:, None]
        h = h * keep
        z = z * keep[..., None]
        prev_a = prev_a * keep
        h = _apply_gru(wm, "gru", h, torch.cat([z.reshape(N, -1), prev_a], -1))
        emb = _apply_mlp(wm, "enc", symlog(obs))
        post_logits = _apply_mlp(wm, "post", torch.cat([h, emb], -1)).reshape(
            N, hp.num_categoricals, hp.num_classes)
        z = _sample_latent(post_logits, noise["z"], hp)
        out = _apply_mlp(actor, "actor", torch.cat([h, z.reshape(N, -1)], -1))
        if self.act_spec.kind == "discrete":
            a = out.argmax(-1) if greedy else _categorical(out, noise["a"])
        else:
            mu, log_std = _actor_dist(out)
            a = torch.tanh(mu if greedy else mu + torch.exp(log_std) * noise["a"])
        return a, h, z


# ---------------------------------------------------------------------------
# algorithm
# ---------------------------------------------------------------------------


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DreamerV3)
        self.num_envs_per_env_runner = 8
        self.rollout_fragment_length = 64
        self.deter_dim = 256
        self.num_categoricals = 16
        self.num_classes = 16
        self.units = 256
        self.num_bins = 41
        self.batch_size = 16
        self.batch_length = 16
        self.horizon = 15
        self.gamma = 0.997
        self.lam = 0.95
        self.ent_coef = 3e-4
        self.lr_world = 1e-3
        self.lr_actor = 3e-4
        self.lr_critic = 3e-4
        self.num_updates_per_iteration = 8
        self.replay_capacity_per_env = 16384
        self.learning_starts = 256          # env steps before updates

    def hyperparams(self) -> DreamerV3Hyperparams:
        return DreamerV3Hyperparams(
            deter_dim=self.deter_dim,
            num_categoricals=self.num_categoricals,
            num_classes=self.num_classes, units=self.units,
            num_bins=self.num_bins, batch_size=self.batch_size,
            batch_length=self.batch_length, horizon=self.horizon,
            gamma=self.gamma, lam=self.lam, ent_coef=self.ent_coef,
            lr_world=self.lr_world, lr_actor=self.lr_actor,
            lr_critic=self.lr_critic)


class DreamerV3(Algorithm):
    """Owns a recurrent collection loop (no stateless RolloutWorker):
    posterior state is carried across env steps and reset via is_first,
    as the reference's dedicated DreamerV3 EnvRunner does."""

    def __init__(self, config: DreamerV3Config):
        if config.num_env_runners > 0:
            raise ValueError(
                "DreamerV3 collects in the algorithm's own process (the "
                "policy is recurrent); num_env_runners must be 0")
        if config.num_learners > 0:
            raise ValueError(
                "DreamerV3 needs direct learner access for recurrent "
                "acting (policy_step); use "
                "resources(learner_mesh=mesh) for data-parallel "
                "updates instead of learners(num_learners=...)")
        if (config.env_to_module_connector is not None
                or config.module_to_env_connector is not None
                or config.learner_connector is not None):
            raise ValueError(
                "DreamerV3's recurrent collection loop does not run "
                "connector pipelines; configure the env itself instead")
        self.config = config
        self._iteration = 0
        self.workers: list = []
        self._eval_workers: list = []
        self.env: VectorEnv = self._make_env(config.num_envs_per_env_runner,
                                             config.seed)
        if self.env.continuous:
            self.act_spec = ActSpec("continuous", self.env.act_dim,
                                    float(self.env.act_limit))
        else:
            self.act_spec = ActSpec("discrete", self.env.num_actions)
        self.space_info = {"obs_dim": self.env.obs_dim,
                           "num_actions": self.env.num_actions}
        hp = config.hyperparams()
        obs_dim, act_spec, device = self.env.obs_dim, self.act_spec, config.device

        def factory(mesh=None):
            return DreamerV3Learner(obs_dim, act_spec, hp, seed=config.seed,
                                    mesh=mesh, device=device)

        self.learner = self._build_learner(factory)
        self.replay = SequenceReplayBuffer(config.replay_capacity_per_env,
                                           seed=config.seed)
        self._env_steps = 0
        n = self.env.num_envs
        dev = self.learner.device
        self._obs = self.env.reset()
        self._first = np.ones(n, np.float32)
        self._prev_a = self._zero_actions(n)
        self._prev_r = np.zeros(n, np.float32)
        self._h = torch.zeros(n, hp.deter_dim, device=dev)
        self._z = torch.zeros(n, hp.num_categoricals, hp.num_classes, device=dev)
        self._gen = torch.Generator(dev).manual_seed(config.seed + 77)
        self._eval_env: Optional[VectorEnv] = None

    def _make_env(self, num_envs: int, seed: int) -> VectorEnv:
        env = self.config.env
        if callable(env):
            return env(num_envs=num_envs, seed=seed)
        return make_env(env, num_envs=num_envs, seed=seed)

    def _zero_actions(self, n: int) -> np.ndarray:
        if self.act_spec.kind == "discrete":
            return np.zeros(n, np.int64)
        return np.zeros((n, self.act_spec.n), np.float32)

    def _prev_a_input(self, prev_a: np.ndarray) -> torch.Tensor:
        """Collection-side prev-action -> network input (normalized)."""
        a = torch.as_tensor(prev_a, device=self.learner.device)
        return self.learner._act_input(a)

    def _env_actions(self, a: np.ndarray) -> np.ndarray:
        """Network action -> env action (scale continuous to limits)."""
        if self.act_spec.kind == "discrete":
            return a
        return a * self.act_spec.limit

    def _broadcast_weights(self) -> None:
        pass  # collection reads the learner's params directly

    def _policy_step(self, h, z, prev_a, obs, first, generator, greedy=False):
        noise = self.learner.policy_noise(len(obs), generator)
        a, h, z = self.learner.policy_step(h, z, self._prev_a_input(prev_a),
                                           obs, first, noise, greedy=greedy)
        return a.cpu().numpy(), h, z

    def _collect(self, num_steps: int) -> list:
        """Step the vec env `num_steps` times, appending on-arrival
        records; returns finished-episode returns."""
        env = self.env
        n = env.num_envs
        episode_returns = []
        for _ in range(num_steps):
            for i in range(n):
                self.replay.add(i, {
                    "obs": self._obs[i].astype(np.float32),
                    "prev_action": self._prev_a[i],
                    "reward": np.float32(self._prev_r[i]),
                    "is_first": np.float32(self._first[i]),
                    "cont": np.float32(1.0),
                })
            actions, self._h, self._z = self._policy_step(
                self._h, self._z, self._prev_a, self._obs, self._first,
                self._gen)   # normalized for continuous
            obs, rewards, dones, ep_ret = env.step(self._env_actions(actions))
            self._env_steps += n
            for i in range(n):
                if dones[i]:
                    # terminal/truncated observation record (auto-reset
                    # envs surface it via final_obs)
                    self.replay.add(i, {
                        "obs": env.final_obs[i].astype(np.float32),
                        "prev_action": actions[i],
                        "reward": np.float32(rewards[i]),
                        "is_first": np.float32(0.0),
                        "cont": np.float32(1.0 if env.truncateds[i] else 0.0),
                    })
                    self._first[i] = 1.0
                    self._prev_a[i] = 0
                    self._prev_r[i] = 0.0
                else:
                    self._first[i] = 0.0
                    self._prev_a[i] = actions[i]
                    self._prev_r[i] = rewards[i]
            self._obs = obs
            episode_returns.extend(float(r) for r in ep_ret[~np.isnan(ep_ret)])
        return episode_returns

    def training_step(self) -> Dict[str, float]:
        cfg: DreamerV3Config = self.config
        episode_returns = self._collect(cfg.rollout_fragment_length)
        metrics: Dict[str, float] = {}
        if (self._env_steps >= cfg.learning_starts
                and self.replay.can_sample(cfg.batch_length)):
            accum: Dict[str, list] = {}
            for _ in range(cfg.num_updates_per_iteration):
                batch = self.replay.sample(cfg.batch_size, cfg.batch_length)
                for k, v in self.learner.update(batch).items():
                    accum.setdefault(k, []).append(v)
            metrics.update({k: float(np.mean(v)) for k, v in accum.items()})
        if episode_returns:
            metrics["episode_return_mean"] = float(np.mean(episode_returns))
            metrics["num_episodes"] = float(len(episode_returns))
        metrics["num_env_steps_sampled"] = float(self._env_steps)
        metrics["replay_size"] = float(len(self.replay))
        return metrics

    def evaluate(self) -> Dict[str, float]:
        """Greedy recurrent episodes on a separate env (the base
        RolloutWorker path is stateless and cannot drive this policy)."""
        cfg: DreamerV3Config = self.config
        hp = cfg.hyperparams()
        episodes = max(1, cfg.evaluation_duration)
        if self._eval_env is None:
            self._eval_env = self._make_env(1, cfg.seed + 9000)
        env = self._eval_env
        dev = self.learner.device
        gen = torch.Generator(dev).manual_seed(cfg.seed + 4242)
        returns = []
        obs = env.reset()
        h = torch.zeros(1, hp.deter_dim, device=dev)
        z = torch.zeros(1, hp.num_categoricals, hp.num_classes, device=dev)
        prev_a = self._zero_actions(1)
        first = np.ones(1, np.float32)
        for _ in range(2000 * episodes):
            actions, h, z = self._policy_step(h, z, prev_a, obs, first, gen,
                                              greedy=True)
            obs, _, dones, ep_ret = env.step(self._env_actions(actions))
            if dones[0]:
                first[0] = 1.0
                prev_a[0] = 0
                if not np.isnan(ep_ret[0]):
                    returns.append(float(ep_ret[0]))
                if len(returns) >= episodes:
                    break
            else:
                first[0] = 0.0
                prev_a[0] = actions[0]
        return {
            "evaluation/episode_return_mean": float(np.mean(returns))
            if returns else float("nan"),
            "evaluation/num_episodes": float(len(returns)),
        }
