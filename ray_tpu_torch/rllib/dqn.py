"""DQN: double Q-learning with (prioritized) replay, counterpart of
`ray_tpu/rllib/dqn.py`.

ref: rllib/algorithms/dqn/dqn.py (training_step: sample -> store ->
train from replay -> target sync) and dqn_rainbow_learner.py. The TD
update (double-DQN targets, Huber loss, importance weights) returns the
per-sample TD errors for the priority write-back; the target network is
a second param dict, copied from the online one every
`target_network_update_freq` updates and otherwise left alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.models import apply_mlp_q, init_mlp_q
from ray_tpu_torch.rllib.optim import Adam, clip_grads_
from ray_tpu_torch.rllib.replay_buffer import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
)

BATCH_KEYS = ("obs", "actions", "rewards", "next_obs", "terminals", "weights")


@dataclasses.dataclass(frozen=True)
class DQNHyperparams:
    lr: float = 1e-3
    gamma: float = 0.99
    train_batch_size: int = 64
    num_updates_per_iteration: int = 16
    target_network_update_freq: int = 100    # in learner updates
    double_q: bool = True
    grad_clip: float = 10.0


def huber_loss(td: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """optax.huber_loss: 0.5 min(|x|, d)^2 + d (|x| - min(|x|, d))."""
    abs_td = td.abs()
    quadratic = torch.clamp(abs_td, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_td - quadratic)


class DQNLearner(Learner):
    """A dp mesh (from LearnerGroup) splits the batch's rows; the TD
    errors come back whole on every rank for the priorities."""

    _state_attrs = ("params", "target_params", "opt_state")

    def __init__(self, obs_dim: int, num_actions: int, hp: DQNHyperparams,
                 seed: int = 0, hidden=(64, 64), mesh=None,
                 device: torch.device | str = "cuda"):
        self.hp = hp
        init_gen = self._setup(device, mesh, seed)
        self.params = self._params_on_device(
            init_mlp_q(init_gen, obs_dim, num_actions, hidden))
        self.target_params = {k: p.detach().clone() for k, p in self.params.items()}
        self._opt = Adam(hp.lr)
        self.opt_state = self._opt.init(self.params)
        self._updates = 0

    def _loss(self, params, b, n: int):
        hp = self.hp
        q = apply_mlp_q(params, b["obs"])
        q_sa = q.gather(1, b["actions"][:, None])[:, 0]
        with torch.no_grad():
            q_next_target = apply_mlp_q(self.target_params, b["next_obs"])
            # Double Q: the online net picks the argmax, the target net
            # evaluates it.
            picker = apply_mlp_q(params, b["next_obs"]) if hp.double_q \
                else q_next_target
            next_q = q_next_target.gather(1, picker.argmax(1)[:, None])[:, 0]
            target = b["rewards"] + hp.gamma * (1.0 - b["terminals"]) * next_q
        td = q_sa - target
        loss = (b["weights"] * huber_loss(td)).sum() / n
        return loss, td.detach()

    def update(self, batch: Dict[str, np.ndarray],
               noise: Optional[dict] = None) -> tuple:
        """One TD step; returns (loss, TD errors [B] as numpy)."""
        b = self._local(batch, BATCH_KEYS)
        b["actions"] = b["actions"].long()
        n = len(batch["rewards"])
        loss, td = self._loss(self.params, b, n)
        grads, metrics = self._grads_and_metrics(loss, self.params,
                                                 {"loss": loss})
        clip_grads_(grads, self.hp.grad_clip)
        self._opt.update(grads, self.opt_state, self.params)
        self._updates += 1
        if self._updates % self.hp.target_network_update_freq == 0:
            self.target_params = {k: p.detach().clone()
                                  for k, p in self.params.items()}
        if self._world > 1:
            parts = [torch.empty_like(td) for _ in range(self._world)]
            dist.all_gather(parts, td, group=self._group)
            td = torch.cat(parts)
        return float(metrics["loss"]), td.cpu().numpy()

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["updates"] = self._updates   # plain int
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        self._updates = int(state.get("updates", self._updates))


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DQN)
        self.lr = 1e-3
        self.gamma = 0.99
        self.train_batch_size = 64
        self.num_updates_per_iteration = 16
        self.target_network_update_freq = 100
        self.double_q = True
        self.grad_clip = 10.0
        self.replay_buffer_capacity = 50_000
        self.prioritized_replay = True
        self.learning_starts = 500           # env steps before updates
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_iterations = 40

    def training(self, *, lr=None, gamma=None, train_batch_size=None,
                 num_updates_per_iteration=None,
                 target_network_update_freq=None, double_q=None,
                 grad_clip=None, replay_buffer_capacity=None,
                 prioritized_replay=None, learning_starts=None,
                 epsilon_initial=None, epsilon_final=None,
                 epsilon_decay_iterations=None, **kwargs) -> "DQNConfig":
        for k, v in dict(
                lr=lr, gamma=gamma, train_batch_size=train_batch_size,
                num_updates_per_iteration=num_updates_per_iteration,
                target_network_update_freq=target_network_update_freq,
                double_q=double_q, grad_clip=grad_clip,
                replay_buffer_capacity=replay_buffer_capacity,
                prioritized_replay=prioritized_replay,
                learning_starts=learning_starts,
                epsilon_initial=epsilon_initial,
                epsilon_final=epsilon_final,
                epsilon_decay_iterations=epsilon_decay_iterations).items():
            if v is not None:
                setattr(self, k, v)
        return super().training(**kwargs)

    def hyperparams(self) -> DQNHyperparams:
        return DQNHyperparams(
            lr=self.lr, gamma=self.gamma,
            train_batch_size=self.train_batch_size,
            num_updates_per_iteration=self.num_updates_per_iteration,
            target_network_update_freq=self.target_network_update_freq,
            double_q=self.double_q, grad_clip=self.grad_clip)


class DQN(Algorithm):
    """training_step: collect epsilon-greedy transitions into replay,
    run K sampled TD updates, write priorities back, broadcast."""

    _eval_mode = "greedy_q"

    def _setup_learner(self, obs_dim: int, num_actions: int) -> DQNLearner:
        cfg: DQNConfig = self.config
        if cfg.prioritized_replay:
            self.replay = PrioritizedReplayBuffer(
                cfg.replay_buffer_capacity, seed=cfg.seed)
        else:
            self.replay = ReplayBuffer(cfg.replay_buffer_capacity,
                                       seed=cfg.seed)
        self._env_steps = 0
        hp, seed, hidden, device = (cfg.hyperparams(), cfg.seed,
                                    cfg.model_hidden, cfg.device)

        def factory(mesh=None):
            return DQNLearner(obs_dim, num_actions, hp, seed=seed,
                              hidden=hidden, mesh=mesh, device=device)

        return self._build_learner(factory)

    def _epsilon(self) -> float:
        cfg: DQNConfig = self.config
        frac = min(1.0, self._iteration / max(1, cfg.epsilon_decay_iterations))
        return (cfg.epsilon_initial
                + frac * (cfg.epsilon_final - cfg.epsilon_initial))

    def training_step(self) -> Dict[str, float]:
        cfg: DQNConfig = self.config
        eps = self._epsilon()
        batch, episode_returns = self._collect(
            "sample_transitions", cfg.rollout_fragment_length, eps)
        self.replay.add_batch(batch)
        self._env_steps += len(batch["rewards"])

        metrics: Dict[str, float] = {"epsilon": eps}
        if self._env_steps >= cfg.learning_starts and len(self.replay) \
                >= cfg.train_batch_size:
            losses = []
            for _ in range(cfg.num_updates_per_iteration):
                sample = self.replay.sample(cfg.train_batch_size)
                loss, td = self.learner.update(sample)
                self.replay.update_priorities(sample["batch_indexes"], td)
                losses.append(loss)
            metrics["loss"] = float(np.mean(losses))
            self._broadcast_weights()
        if episode_returns:
            metrics["episode_return_mean"] = float(np.mean(episode_returns))
            metrics["num_episodes"] = float(len(episode_returns))
        metrics["num_env_steps_sampled"] = float(self._env_steps)
        metrics["replay_size"] = float(len(self.replay))
        return metrics
