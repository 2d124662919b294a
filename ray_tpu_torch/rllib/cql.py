"""CQL: conservative Q-learning, offline RL for continuous control;
counterpart of `ray_tpu/rllib/cql.py`.

ref: rllib/algorithms/cql/cql.py:1 (SAC-based learner with the CQL(H)
conservative regularizer). `CQLLearner` is SAC's update with the critic
loss plus the conservative penalty: logsumexp of Q over uniform-random
and policy actions minus Q of the dataset actions. Its noise adds the
random actions and the policy's standard-normal draws for them.

The `CQL` algorithm trains from offline shards that the JAX package reads
through `ray_tpu.data`; the port's data executor is ROADMAP queue A, item
10b, so building it raises. The learner runs on
any batch of transitions.
"""
from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.models import apply_sac_actor, apply_twin_q, sample_squashed
from ray_tpu_torch.rllib.sac import SACConfig, SACHyperparams, SACLearner


class CQLLearner(SACLearner):
    """SAC learner + conservative critic penalty (CQL(H), simplified:
    uniform + policy action samples, no importance correction — the
    variant the reference defaults to with `lagrangian=False`)."""

    _NOISE_AXES = {"next": 0, "pi": 0, "rand": 1, "pi_cql": 1}

    def __init__(self, obs_dim: int, act_dim: int, hp: SACHyperparams,
                 *, cql_alpha: float = 1.0, cql_n_actions: int = 4,
                 seed: int = 0, hidden=(64, 64), mesh=None,
                 device: torch.device | str = "cuda"):
        self._cql_alpha = cql_alpha
        self._cql_n = cql_n_actions
        super().__init__(obs_dim, act_dim, hp, seed=seed, hidden=hidden,
                         mesh=mesh, device=device)

    def draw_noise(self, batch) -> dict:
        """SAC's draws, plus uniform actions in [-limit, limit] and
        standard-normal draws for the policy's actions, [n, B, act_dim]
        each (n = cql_n_actions)."""
        noise = super().draw_noise(batch)
        shape = (self._cql_n, len(batch["rewards"]), self.act_dim)
        limit = self.hp.act_limit
        noise["rand"] = torch.rand(shape, generator=self._rng,
                                   device=self.device) * (2 * limit) - limit
        noise["pi_cql"] = torch.randn(shape, generator=self._rng,
                                      device=self.device)
        return noise

    def _critic_loss(self, b, nz, n: int):
        target = self._td_target(b, nz)
        q1, q2 = apply_twin_q(self.critic, b["obs"], b["actions"])
        td = ((q1 - target) ** 2 + (q2 - target) ** 2).sum() / n

        # Conservative penalty: push down Q on out-of-distribution
        # actions (logsumexp over sampled actions), push up on the
        # DATASET actions.
        with torch.no_grad():
            mu_c, std_c = apply_sac_actor(self.actor, b["obs"])
            pi_a = torch.stack([
                sample_squashed(mu_c, std_c, e, self.hp.act_limit)[0]
                for e in nz["pi_cql"]])
        all_a = torch.cat([nz["rand"], pi_a])               # [2n, B, d]
        obs = b["obs"].expand(all_a.shape[0], *b["obs"].shape)
        qs1, qs2 = apply_twin_q(self.critic, obs, all_a)    # [2n, B]
        penalty = ((torch.logsumexp(qs1, 0) - q1).sum() / n
                   + (torch.logsumexp(qs2, 0) - q2).sum() / n)
        return td + self._cql_alpha * penalty, {"critic_loss": td,
                                                "cql_penalty": penalty}


class CQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = CQL
        self.cql_alpha = 1.0
        self.cql_n_actions = 4
        self.input_path = None

    def offline_data(self, *, input_path: str) -> "CQLConfig":
        self.input_path = input_path
        return self

    def training(self, *, cql_alpha=None, cql_n_actions=None,
                 **kwargs) -> "CQLConfig":
        if cql_alpha is not None:
            self.cql_alpha = cql_alpha
        if cql_n_actions is not None:
            self.cql_n_actions = cql_n_actions
        return super().training(**kwargs)


class CQL(Algorithm):
    """The JAX package's CQL trains on offline shards read through its
    data executor; that reader is not ported yet (item 10b)."""

    def _setup_learner(self, obs_dim: int, num_actions: int) -> CQLLearner:
        raise NotImplementedError(
            "CQL reads its offline data through the data executor "
            "(read_samples), which is not ported yet (ROADMAP queue A, "
            "item 10b); train a CQLLearner "
            "on batches of transitions instead")
