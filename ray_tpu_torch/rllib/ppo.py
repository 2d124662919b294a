"""PPO: clipped-surrogate policy optimization, counterpart of
`ray_tpu/rllib/ppo.py`.

Reference: rllib/algorithms/ppo/ppo.py (training_step), core/learner/
learner.py:107. The learner's update is JAX's fused program written out
eagerly: GAE (a reverse loop over time, time-major as `lax.scan(reverse=
True)`), advantage normalization over the whole batch (population std),
then every SGD epoch over the minibatches of that epoch's permutation,
each a clipped-surrogate + value + entropy loss, global-norm clipping and
Adam. The permutations are the update's noise (`draw_noise`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, _tensor
from ray_tpu_torch.rllib.core.rl_module import MLPPolicyModule, RLModule
from ray_tpu_torch.rllib.optim import Adam, clip_grads_

BATCH_KEYS = ("obs", "actions", "logp", "rewards", "dones", "values",
              "final_value")


@dataclasses.dataclass(frozen=True)
class PPOHyperparams:
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 256
    grad_clip: float = 0.5


def gae(rewards, dones, values, final_value, gamma: float, lambda_: float):
    """Generalized advantage estimates [E, T] from [E, T] inputs and the
    bootstrap value [E], by a reverse loop over time."""
    v_next = torch.cat([values[:, 1:], final_value[:, None]], dim=1)
    not_done = 1.0 - dones
    delta = rewards + gamma * v_next * not_done - values
    advs = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[:, 0])
    for t in range(rewards.shape[1] - 1, -1, -1):
        carry = delta[:, t] + gamma * lambda_ * not_done[:, t] * carry
        advs[:, t] = carry
    return advs


class PPOLearner(Learner):
    """Params + Adam state + the update (ref: Learner, learner.py:107);
    a dp mesh (usually handed in by LearnerGroup) splits the batch's
    envs over ranks."""

    _state_attrs = ("params", "opt_state", "_rng")

    def __init__(self, obs_dim: int, num_actions: int, hp: PPOHyperparams,
                 seed: int = 0, mesh: Optional[DeviceMesh] = None,
                 hidden=(64, 64), module: Optional[RLModule] = None,
                 device: torch.device | str = "cuda"):
        self.hp = hp
        init_gen = self._setup(device, mesh, seed)
        self.module = module or MLPPolicyModule(obs_dim, num_actions, hidden)
        self.params = self._params_on_device(self.module.init(init_gen))
        self._opt = Adam(hp.lr)
        self.opt_state = self._opt.init(self.params)

    def _sizes(self, batch) -> tuple:
        """(rows n = E*T, minibatch size, minibatches per epoch)."""
        n = int(np.prod(np.shape(batch["rewards"])))
        mb = min(self.hp.minibatch_size, n)
        return n, mb, max(1, n // mb)

    def draw_noise(self, batch) -> dict:
        """Each epoch's permutation of the n = E*T rows (jax.random.
        permutation in the JAX program)."""
        n = self._sizes(batch)[0]
        return {"perms": torch.stack([
            torch.randperm(n, generator=self._rng, device=self.device)
            for _ in range(self.hp.num_epochs)])}

    def _loss(self, params, mb, n_mb: int):
        """This rank's share of the minibatch's mean loss and metrics."""
        hp = self.hp
        logits, value = self.module.forward_train(params, mb["obs"])
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(1, mb["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - mb["logp_old"])
        adv = mb["advantages"]
        pg = -torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - hp.clip_param, 1 + hp.clip_param) * adv)
        vf = 0.5 * torch.square(value - mb["returns"])
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=1)
        pg_m, vf_m, ent_m = pg.sum() / n_mb, vf.sum() / n_mb, entropy.sum() / n_mb
        loss = pg_m + hp.vf_loss_coeff * vf_m - hp.entropy_coeff * ent_m
        return loss, {"policy_loss": pg_m, "vf_loss": vf_m, "entropy": ent_m,
                      "kl": (mb["logp_old"] - logp).sum() / n_mb}

    def update(self, batch: Dict[str, np.ndarray],
               noise: Optional[dict] = None) -> Dict[str, float]:
        """One training iteration over a sampled batch.

        batch: obs [E,T,D], actions [E,T] int, logp [E,T], rewards [E,T],
        dones [E,T], values [E,T], final_value [E]; noise: `draw_noise`'s.
        """
        hp = self.hp
        if noise is None:
            noise = self.draw_noise(batch)
        n, mb, num_mb = self._sizes(batch)
        b = self._local(batch, BATCH_KEYS)
        perms = _tensor(noise["perms"]).to(self.device)
        E, T = b["rewards"].shape
        with torch.no_grad():
            advs = gae(b["rewards"], b["dones"], b["values"], b["final_value"],
                       hp.gamma, hp.lambda_)
            flat = {
                "obs": b["obs"].reshape(E * T, -1),
                "actions": b["actions"].reshape(E * T).long(),
                "logp_old": b["logp"].reshape(E * T),
                "advantages": advs.reshape(E * T),
                "returns": (advs + b["values"]).reshape(E * T),
            }
            a = flat["advantages"]
            mean = self._psum([a.sum()])[0] / n
            var = self._psum([torch.square(a - mean).sum()])[0] / n
            flat["advantages"] = (a - mean) / (torch.sqrt(var) + 1e-8)

        lo = self._rows(np.shape(batch["rewards"])[0]).start * T
        last = []
        for epoch in range(hp.num_epochs):
            idx = perms[epoch][:num_mb * mb].view(num_mb, mb)
            for j in range(num_mb):
                rows = idx[j]
                if self._world > 1:
                    rows = rows[(rows >= lo) & (rows < lo + E * T)] - lo
                mbatch = {k: v[rows] for k, v in flat.items()}
                loss, metrics = self._loss(self.params, mbatch, mb)
                grads, metrics = self._grads_and_metrics(loss, self.params, metrics)
                clip_grads_(grads, hp.grad_clip)
                self._opt.update(grads, self.opt_state, self.params)
                if epoch == hp.num_epochs - 1:
                    last.append(torch.stack(list(metrics.values())))
        # The final epoch's mean metrics, as the JAX learner reports them.
        means = torch.stack(last).mean(0).tolist()
        return dict(zip(metrics, means))


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=PPO)
        self.lr = 3e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_epochs = 4
        self.minibatch_size = 256
        self.grad_clip = 0.5

    def training(self, *, lr=None, gamma=None, lambda_=None,
                 clip_param=None, vf_loss_coeff=None, entropy_coeff=None,
                 num_epochs=None, minibatch_size=None, grad_clip=None,
                 **kwargs) -> "PPOConfig":
        for k, v in dict(lr=lr, gamma=gamma, lambda_=lambda_,
                         clip_param=clip_param,
                         vf_loss_coeff=vf_loss_coeff,
                         entropy_coeff=entropy_coeff,
                         num_epochs=num_epochs,
                         minibatch_size=minibatch_size,
                         grad_clip=grad_clip).items():
            if v is not None:
                setattr(self, k, v)
        return super().training(**kwargs)

    def hyperparams(self) -> PPOHyperparams:
        return PPOHyperparams(
            lr=self.lr, gamma=self.gamma, lambda_=self.lambda_,
            clip_param=self.clip_param, vf_loss_coeff=self.vf_loss_coeff,
            entropy_coeff=self.entropy_coeff, num_epochs=self.num_epochs,
            minibatch_size=self.minibatch_size, grad_clip=self.grad_clip)


class PPO(Algorithm):
    """ref: rllib/algorithms/ppo/ppo.py — training_step = sample rollouts,
    one learner update, broadcast weights."""

    def _setup_learner(self, obs_dim: int, num_actions: int):
        cfg = self.config
        hp = cfg.hyperparams()
        seed, hidden, device = cfg.seed, cfg.model_hidden, cfg.device

        def factory(mesh=None):
            return PPOLearner(obs_dim, num_actions, hp, seed=seed, mesh=mesh,
                              hidden=hidden, device=device)

        return self._build_learner(factory)

    def training_step(self) -> Dict[str, float]:
        batch, episode_returns = self._sample_rollouts()
        metrics = self.learner.update(batch)
        self._broadcast_weights()
        if episode_returns:
            metrics["episode_return_mean"] = float(np.mean(episode_returns))
            metrics["episode_return_max"] = float(np.max(episode_returns))
            metrics["num_episodes"] = float(len(episode_returns))
        metrics["num_env_steps_sampled"] = float(batch["rewards"].size)
        return metrics
