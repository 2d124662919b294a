"""APPO: asynchronous PPO — IMPALA's decoupled sampling/learning with
PPO's clipped surrogate objective; counterpart of `ray_tpu/rllib/appo.py`.

ref: rllib/algorithms/appo/appo.py — the PPO clip on top of the IMPALA
architecture, so stale-but-cheap rollouts get both V-trace off-policy
correction AND the trust-region-ish update clamp. Only the
policy-gradient term differs from ImpalaLearner's update.
"""
from __future__ import annotations

import dataclasses

import torch

from ray_tpu_torch.rllib.impala import (
    IMPALA,
    ImpalaConfig,
    ImpalaHyperparams,
    ImpalaLearner,
)


@dataclasses.dataclass(frozen=True)
class AppoHyperparams(ImpalaHyperparams):
    clip_param: float = 0.2


class AppoLearner(ImpalaLearner):
    """V-trace advantages through the PPO clipped surrogate (ref:
    appo_torch_learner.py loss)."""

    def _pg_loss(self, target_logp, behavior_logp, pg_adv, n: int):
        eps = self.hp.clip_param
        ratio = torch.exp(target_logp - behavior_logp)
        return -torch.minimum(
            ratio * pg_adv,
            torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * pg_adv).sum() / n


class APPOConfig(ImpalaConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.clip_param = 0.2

    def training(self, *, clip_param=None, **kwargs) -> "APPOConfig":
        if clip_param is not None:
            self.clip_param = clip_param
        return super().training(**kwargs)

    def hyperparams(self) -> AppoHyperparams:
        base = super().hyperparams()
        return AppoHyperparams(**dataclasses.asdict(base),
                               clip_param=self.clip_param)


class APPO(IMPALA):
    """Same training_step as IMPALA; the learner clamps updates."""

    _learner_cls = AppoLearner
