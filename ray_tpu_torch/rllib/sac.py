"""SAC: soft actor-critic for continuous control, counterpart of
`ray_tpu/rllib/sac.py`.

ref: rllib/algorithms/sac/sac.py:1 (twin Q, target entropy auto-tuning,
polyak target updates; training_step: sample -> replay -> K updates).
One update is JAX's fused program written out eagerly and in its order:
the critic step (clipped double-Q, entropy-regularized TD targets from
the target critic), then the actor step through min(Q1, Q2) of the
updated critic, then the temperature step on the actor step's log-probs
(log_alpha moves after both losses used it), then the polyak target move.
Each step is optax's Adam. The action samples are the update's noise
(`draw_noise`): standard-normal draws for the next-state and the actor
samples.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.jax_bridge import rl_params_from_jax, rl_params_to_numpy
from ray_tpu_torch.rllib.models import (
    apply_sac_actor,
    apply_twin_q,
    init_sac_actor,
    init_twin_q,
    sample_squashed,
)
from ray_tpu_torch.rllib.optim import Adam
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer

BATCH_KEYS = ("obs", "actions", "rewards", "next_obs", "terminals")


@dataclasses.dataclass(frozen=True)
class SACHyperparams:
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005                 # polyak target rate
    target_entropy: float = -1.0       # default: -act_dim
    act_limit: float = 1.0
    init_alpha: float = 0.1


class SACLearner(Learner):
    """All three optimizers + the target move in one update; a dp mesh
    (usually from LearnerGroup) splits the batch's rows."""

    _state_attrs = ("actor", "critic", "target_critic", "log_alpha",
                    "actor_opt", "critic_opt", "alpha_opt", "_rng")

    def __init__(self, obs_dim: int, act_dim: int, hp: SACHyperparams,
                 seed: int = 0, hidden=(64, 64),
                 mesh: Optional[DeviceMesh] = None,
                 device: torch.device | str = "cuda"):
        self.hp = hp
        self.act_dim = act_dim
        init_gen = self._setup(device, mesh, seed)
        self.actor = self._params_on_device(
            init_sac_actor(init_gen, obs_dim, act_dim, hidden))
        self.critic = self._params_on_device(
            init_twin_q(init_gen, obs_dim, act_dim, hidden))
        self.target_critic = {k: p.detach().clone() for k, p in self.critic.items()}
        self.log_alpha = torch.tensor(
            float(np.log(np.float32(hp.init_alpha))), device=self.device,
            requires_grad=True)
        self._actor_tx = Adam(hp.actor_lr)
        self._critic_tx = Adam(hp.critic_lr)
        self._alpha_tx = Adam(hp.alpha_lr)
        self.actor_opt = self._actor_tx.init(self.actor)
        self.critic_opt = self._critic_tx.init(self.critic)
        self.alpha_opt = self._alpha_tx.init({"log_alpha": self.log_alpha})

    # -- noise: global shapes, sliced per rank ---------------------------
    _NOISE_AXES = {"next": 0, "pi": 0}

    def draw_noise(self, batch) -> dict:
        """Standard-normal draws [B, act_dim] for the next-state actions
        (the critic target) and the actor's samples."""
        shape = (len(batch["rewards"]), self.act_dim)
        return {k: torch.randn(shape, generator=self._rng, device=self.device)
                for k in ("next", "pi")}

    # -- losses (this rank's share of the global means over n) -----------
    def _td_target(self, b, nz):
        hp = self.hp
        with torch.no_grad():
            mu, log_std = apply_sac_actor(self.actor, b["next_obs"])
            next_a, next_logp = sample_squashed(mu, log_std, nz["next"],
                                                hp.act_limit)
            tq1, tq2 = apply_twin_q(self.target_critic, b["next_obs"], next_a)
            next_v = torch.minimum(tq1, tq2) - torch.exp(self.log_alpha) * next_logp
            return b["rewards"] + hp.gamma * (1.0 - b["terminals"]) * next_v

    def _critic_loss(self, b, nz, n: int):
        target = self._td_target(b, nz)
        q1, q2 = apply_twin_q(self.critic, b["obs"], b["actions"])
        loss = ((q1 - target) ** 2 + (q2 - target) ** 2).sum() / n
        return loss, {"critic_loss": loss}

    def update(self, batch: Dict[str, np.ndarray],
               noise: Optional[dict] = None) -> Dict[str, float]:
        hp = self.hp
        if noise is None:
            noise = self.draw_noise(batch)
        n = len(batch["rewards"])
        b = self._local(batch, BATCH_KEYS)
        nz = self._slices(noise, self._NOISE_AXES)

        c_loss, c_metrics = self._critic_loss(b, nz, n)
        c_grads, c_metrics = self._grads_and_metrics(c_loss, self.critic, c_metrics)
        self._critic_tx.update(c_grads, self.critic_opt, self.critic)

        mu, log_std = apply_sac_actor(self.actor, b["obs"])
        a, logp = sample_squashed(mu, log_std, nz["pi"], hp.act_limit)
        q1, q2 = apply_twin_q(self.critic, b["obs"], a)
        alpha = torch.exp(self.log_alpha).detach()
        a_loss = (alpha * logp - torch.minimum(q1, q2)).sum() / n
        logp = logp.detach()
        # d/d log_alpha of -mean(log_alpha * (logp + target_entropy)),
        # summed over dp with the actor's grads.
        a_grads, a_metrics = self._grads_and_metrics(
            a_loss, self.actor,
            {"actor_loss": a_loss, "entropy": -logp.sum() / n,
             "alpha_grad": -(logp + hp.target_entropy).sum() / n})
        self._actor_tx.update(a_grads, self.actor_opt, self.actor)
        self._alpha_tx.update({"log_alpha": a_metrics.pop("alpha_grad")},
                              self.alpha_opt, {"log_alpha": self.log_alpha})

        with torch.no_grad():
            names = list(self.target_critic)
            moved = torch._foreach_mul([self.target_critic[k] for k in names],
                                       1.0 - hp.tau)
            torch._foreach_add_(moved, torch._foreach_mul(
                [self.critic[k] for k in names], hp.tau))
            self.target_critic = dict(zip(names, moved))
        metrics = {**c_metrics, "actor_loss": a_metrics["actor_loss"],
                   "alpha": torch.exp(self.log_alpha.detach()),
                   "entropy": a_metrics["entropy"]}
        return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))

    # Rollout/eval workers only need the ACTOR.
    def get_weights(self) -> Any:
        return rl_params_to_numpy(self.actor)

    def set_weights(self, actor: Any) -> None:
        self.actor = rl_params_from_jax(actor, self.device, like=self.actor)


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=SAC)
        self.actor_lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.gamma = 0.99
        self.tau = 0.005
        self.train_batch_size = 256
        self.num_updates_per_iteration = 64
        self.replay_buffer_capacity = 100_000
        self.learning_starts = 1000       # uniform-random warmup steps
        self.target_entropy = None        # None -> -act_dim

    def training(self, *, actor_lr=None, critic_lr=None, alpha_lr=None,
                 gamma=None, tau=None, train_batch_size=None,
                 num_updates_per_iteration=None,
                 replay_buffer_capacity=None, learning_starts=None,
                 target_entropy=None, **kwargs) -> "SACConfig":
        for k, v in dict(
                actor_lr=actor_lr, critic_lr=critic_lr, alpha_lr=alpha_lr,
                gamma=gamma, tau=tau, train_batch_size=train_batch_size,
                num_updates_per_iteration=num_updates_per_iteration,
                replay_buffer_capacity=replay_buffer_capacity,
                learning_starts=learning_starts,
                target_entropy=target_entropy).items():
            if v is not None:
                setattr(self, k, v)
        return super().training(**kwargs)

    def hyperparams(self, info: dict) -> SACHyperparams:
        """The learner's hyperparams for an env with these space infos."""
        return SACHyperparams(
            actor_lr=self.actor_lr, critic_lr=self.critic_lr,
            alpha_lr=self.alpha_lr, gamma=self.gamma, tau=self.tau,
            target_entropy=(self.target_entropy
                            if self.target_entropy is not None
                            else -float(info["act_dim"])),
            act_limit=info["act_limit"])


class SAC(Algorithm):
    """training_step: stochastic-actor collection into replay (uniform
    random during warmup), K updates per iteration."""

    _eval_mode = "sac_mean"

    def _setup_learner(self, obs_dim: int, num_actions: int) -> SACLearner:
        cfg: SACConfig = self.config
        info = self.space_info
        if not info["continuous"]:
            raise ValueError("SAC needs a continuous-control env "
                             "(e.g. Pendulum-v1)")
        hp, act_dim = cfg.hyperparams(info), info["act_dim"]
        self.replay = ReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._env_steps = 0
        seed, hidden, device = cfg.seed, cfg.model_hidden, cfg.device

        def factory(mesh=None):
            return SACLearner(obs_dim, act_dim, hp, seed=seed, hidden=hidden,
                              mesh=mesh, device=device)

        return self._build_learner(factory)

    def training_step(self) -> Dict[str, float]:
        cfg: SACConfig = self.config
        warmup = self._env_steps < cfg.learning_starts
        batch, episode_returns = self._collect(
            "sample_transitions_continuous", cfg.rollout_fragment_length,
            uniform=warmup)
        batch = self._apply_learner_connector(batch)
        self.replay.add_batch(batch)
        self._env_steps += len(batch["rewards"])

        metrics: Dict[str, float] = {}
        if not warmup and len(self.replay) >= cfg.train_batch_size:
            agg: Dict[str, list] = {}
            for _ in range(cfg.num_updates_per_iteration):
                sample = self.replay.sample(cfg.train_batch_size)
                for k, v in self.learner.update(sample).items():
                    agg.setdefault(k, []).append(v)
            metrics.update({k: float(np.mean(v)) for k, v in agg.items()})
            self._broadcast_weights()
        if episode_returns:
            metrics["episode_return_mean"] = float(np.mean(episode_returns))
        metrics["num_env_steps_sampled"] = float(self._env_steps)
        return metrics
