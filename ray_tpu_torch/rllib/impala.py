"""IMPALA: actor-learner RL with V-trace correction, counterpart of the
local mode of `ray_tpu/rllib/impala.py`.

ref: rllib/algorithms/impala/impala.py and the V-trace returns of
Espeholt et al. 2018. The update is JAX's program written out eagerly:
target-policy logp, clipped importance ratios, the V-trace reverse loop
over time (time-major, as `lax.scan(reverse=True)`), the combined
policy/value/entropy loss (means over the whole [E, T] batch), global-norm
clipping and optax's RMSProp (eps inside the square root). It draws no
noise. Locally the algorithm samples one batch ahead: each update
consumes a batch collected under the weights of the update before it,
the staleness V-trace corrects.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.models import apply_mlp_policy, init_mlp_policy
from ray_tpu_torch.rllib.optim import RMSProp, clip_grads_

BATCH_KEYS = ("obs", "actions", "logp", "rewards", "dones", "final_value")


@dataclasses.dataclass(frozen=True)
class ImpalaHyperparams:
    lr: float = 6e-4
    gamma: float = 0.99
    rho_clip: float = 1.0
    c_clip: float = 1.0
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 40.0


def vtrace(behavior_logp, target_logp, rewards, dones, values, final_value,
           gamma: float, rho_clip: float, c_clip: float):
    """V-trace targets and policy-gradient advantages; all [E, T] but
    final_value [E]. Inputs carry no grad (the JAX learner stops it)."""
    rho = torch.clamp(torch.exp(target_logp - behavior_logp), max=rho_clip)
    c = torch.clamp(torch.exp(target_logp - behavior_logp), max=c_clip)
    v_next = torch.cat([values[:, 1:], final_value[:, None]], dim=1)
    not_done = 1.0 - dones
    deltas = rho * (rewards + gamma * not_done * v_next - values)
    acc = torch.empty_like(values)
    carry = torch.zeros_like(values[:, 0])
    for t in range(values.shape[1] - 1, -1, -1):
        carry = deltas[:, t] + gamma * not_done[:, t] * c[:, t] * carry
        acc[:, t] = carry
    vs = values + acc
    vs_next = torch.cat([vs[:, 1:], final_value[:, None]], dim=1)
    pg_adv = rho * (rewards + gamma * not_done * vs_next - values)
    return vs, pg_adv


class ImpalaLearner(Learner):
    """A dp mesh (from LearnerGroup) splits the [E, T] batch's envs."""

    _state_attrs = ("params", "opt_state")

    def __init__(self, obs_dim: int, num_actions: int,
                 hp: ImpalaHyperparams, seed: int = 0, hidden=(64, 64),
                 mesh=None, device: torch.device | str = "cuda"):
        self.hp = hp
        init_gen = self._setup(device, mesh, seed)
        self.params = self._params_on_device(
            init_mlp_policy(init_gen, obs_dim, num_actions, hidden))
        self._opt = RMSProp(hp.lr, decay=0.99, eps=0.1)
        self.opt_state = self._opt.init(self.params)

    def _pg_loss(self, target_logp, behavior_logp, pg_adv, n: int):
        """This rank's share of the policy-gradient term's mean over n;
        APPO overrides with the clipped surrogate."""
        return -(target_logp * pg_adv).sum() / n

    def _loss(self, params, b, n: int):
        hp = self.hp
        E, T = b["rewards"].shape
        logits, value = apply_mlp_policy(params, b["obs"].reshape(E * T, -1))
        logits = logits.reshape(E, T, -1)
        value = value.reshape(E, T)
        logp_all = torch.log_softmax(logits, -1)
        target_logp = logp_all.gather(2, b["actions"][..., None])[..., 0]
        vs, pg_adv = vtrace(b["logp"], target_logp.detach(), b["rewards"],
                            b["dones"], value.detach(), b["final_value"],
                            hp.gamma, hp.rho_clip, hp.c_clip)
        pg_loss = self._pg_loss(target_logp, b["logp"], pg_adv, n)
        vf_loss = 0.5 * torch.square(value - vs).sum() / n
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1).sum() / n
        loss = (pg_loss + hp.vf_loss_coeff * vf_loss
                - hp.entropy_coeff * entropy)
        mean_rho = torch.exp(target_logp - b["logp"]).sum() / n
        return loss, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                      "entropy": entropy, "mean_rho": mean_rho}

    def update(self, batch: Dict[str, np.ndarray],
               noise: Optional[dict] = None) -> Dict[str, float]:
        b = self._local(batch, BATCH_KEYS)
        b["actions"] = b["actions"].long()
        n = int(np.prod(np.shape(batch["rewards"])))
        loss, metrics = self._loss(self.params, b, n)
        grads, metrics = self._grads_and_metrics(loss, self.params, metrics)
        clip_grads_(grads, self.hp.grad_clip)
        self._opt.update(grads, self.opt_state, self.params)
        return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))


class ImpalaConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=IMPALA)
        self.lr = 6e-4
        self.gamma = 0.99
        self.rho_clip = 1.0
        self.c_clip = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 40.0
        self.queue_depth = 2          # in-flight sample batches per worker
        self.broadcast_interval = 1   # learner updates between weight syncs

    def training(self, *, lr=None, gamma=None, rho_clip=None, c_clip=None,
                 vf_loss_coeff=None, entropy_coeff=None, grad_clip=None,
                 queue_depth=None, broadcast_interval=None,
                 **kwargs) -> "ImpalaConfig":
        for k, v in dict(lr=lr, gamma=gamma, rho_clip=rho_clip,
                         c_clip=c_clip, vf_loss_coeff=vf_loss_coeff,
                         entropy_coeff=entropy_coeff, grad_clip=grad_clip,
                         queue_depth=queue_depth,
                         broadcast_interval=broadcast_interval).items():
            if v is not None:
                setattr(self, k, v)
        return super().training(**kwargs)

    def hyperparams(self) -> ImpalaHyperparams:
        return ImpalaHyperparams(
            lr=self.lr, gamma=self.gamma, rho_clip=self.rho_clip,
            c_clip=self.c_clip, vf_loss_coeff=self.vf_loss_coeff,
            entropy_coeff=self.entropy_coeff, grad_clip=self.grad_clip)


class IMPALA(Algorithm):
    """training_step: consume a sample batch (collected under stale
    weights — V-trace corrects), update, broadcast weights on the
    configured cadence. With remote runners `queue_depth` batches per
    runner stay in flight, refilled round-robin, and the first one done is
    consumed; locally, the oldest of one."""

    _learner_cls = ImpalaLearner   # APPO swaps in AppoLearner

    def _setup_learner(self, obs_dim: int, num_actions: int) -> ImpalaLearner:
        cfg: ImpalaConfig = self.config
        self._pending: List[Any] = []
        self._updates_since_broadcast = 0
        self._next_worker = 0
        cls, hp = self._learner_cls, cfg.hyperparams()
        seed, hidden, device = cfg.seed, cfg.model_hidden, cfg.device

        def factory(mesh=None):
            return cls(obs_dim, num_actions, hp, seed=seed, hidden=hidden,
                       mesh=mesh, device=device)

        return self._build_learner(factory)

    def _refill(self) -> None:
        cfg: ImpalaConfig = self.config
        T = cfg.rollout_fragment_length
        if self._remote:
            while len(self._pending) < cfg.queue_depth * len(self.workers):
                # Persistent round-robin: resetting per call would pile
                # all steady-state refills onto worker 0 and starve the
                # rest.
                w = self.workers[self._next_worker % len(self.workers)]
                self._next_worker += 1
                self._pending.append(w.sample.remote(T))
        else:
            while len(self._pending) < 1:
                self._pending.append(self.workers[0].sample(T))

    def training_step(self) -> Dict[str, float]:
        cfg: ImpalaConfig = self.config
        self._refill()
        if self._remote:
            done, self._pending = ray_tpu_torch.wait(
                self._pending, num_returns=1, timeout=600)
            if not done:
                raise TimeoutError(
                    "no rollout worker produced a sample batch within 600s")
            out = ray_tpu_torch.get(done[0])
        else:
            out = self._pending.pop(0)
        batch = out["batch"]
        metrics = self.learner.update(batch)
        self._updates_since_broadcast += 1
        if self._updates_since_broadcast >= cfg.broadcast_interval:
            self._broadcast_weights()
            self._updates_since_broadcast = 0
        self._refill()   # the next batch, under the weights it now has
        if out["episode_returns"]:
            metrics["episode_return_mean"] = float(
                np.mean(out["episode_returns"]))
            metrics["num_episodes"] = float(len(out["episode_returns"]))
        metrics["num_env_steps_sampled"] = float(batch["rewards"].size)
        return metrics
