"""RLlib on the PyTorch port: counterpart of `ray_tpu.rllib` (learner side).

Reference surface (ref: rllib/algorithms/algorithm.py:196 Algorithm,
algorithm_config.py AlgorithmConfig, core/learner/learner.py:107 Learner,
evaluation/rollout_worker.py:159 RolloutWorker). A local rollout worker
steps vectorized numpy envs and batches each policy step into one call on
the device; the learner runs each algorithm's whole update (GAE or
V-trace, every epoch and minibatch, clipping, target nets, temperature)
in eager torch on the device, optionally over a dp `DeviceMesh`
(`LearnerGroup`), and computes JAX's update function at fp32. DreamerV3
collects with its own recurrent loop; BC and MARWIL learn from recorded
rows.

Remote env runners, remote evaluation runners and remote learner actors
run on the task/actor core (`ray_tpu_torch.init(local_mode=True)` hosts
them in-process). BC, MARWIL and CQL train on recorded shards read
through the port's data layer (`offline.read_samples`). Importing it tags
"rllib" in the usage stats, as JAX's does.
"""
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.connectors import (
    ActionClip,
    Connector,
    ConnectorPipeline,
    ObsClip,
    ObsNormalizer,
    RewardScale,
)
from ray_tpu_torch.rllib.core import (
    DiscreteQModule,
    Learner,
    LearnerGroup,
    MLPPolicyModule,
    MultiRLModule,
    RLModule,
)
from ray_tpu_torch.rllib.cql import CQL, CQLConfig, CQLLearner
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rllib.env import register_env
from ray_tpu_torch.rllib.impala import IMPALA, ImpalaConfig
from ray_tpu_torch.rllib.offline import (
    BC,
    MARWIL,
    BCConfig,
    MARWILConfig,
    SampleWriter,
    read_samples,
    record_rollouts,
)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.replay_buffer import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
)
from ray_tpu_torch.rllib.sac import SAC, SACConfig

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "ActionClip",
    "Connector",
    "ConnectorPipeline",
    "ObsClip",
    "ObsNormalizer",
    "RewardScale",
    "DiscreteQModule",
    "Learner",
    "LearnerGroup",
    "MLPPolicyModule",
    "MultiRLModule",
    "RLModule",
    "PPO",
    "PPOConfig",
    "DQN",
    "DQNConfig",
    "IMPALA",
    "ImpalaConfig",
    "APPO",
    "APPOConfig",
    "SAC",
    "SACConfig",
    "CQL",
    "CQLConfig",
    "CQLLearner",
    "DreamerV3",
    "DreamerV3Config",
    "BC",
    "BCConfig",
    "MARWIL",
    "MARWILConfig",
    "SampleWriter",
    "read_samples",
    "record_rollouts",
    "ReplayBuffer",
    "PrioritizedReplayBuffer",
    "register_env",
]

# Usage tagging (ref: usage_lib.record_library_usage; local-only,
# see ray_tpu_torch/util/usage_stats.py)
from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu

_rlu("rllib")
del _rlu
