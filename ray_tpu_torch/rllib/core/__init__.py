"""RLlib new-stack core: RLModule / Learner / LearnerGroup, counterpart of
`ray_tpu/rllib/core` (ref: rllib/core/rl_module/rl_module.py,
rllib/core/learner/learner.py:107, rllib/core/learner/learner_group.py:60)."""
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import (
    DiscreteQModule,
    MLPPolicyModule,
    MultiRLModule,
    RLModule,
)

__all__ = [
    "DiscreteQModule",
    "Learner",
    "LearnerGroup",
    "MLPPolicyModule",
    "MultiRLModule",
    "RLModule",
]
