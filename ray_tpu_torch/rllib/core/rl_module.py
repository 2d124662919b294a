"""RLModule: the network abstraction of the RLlib new stack, counterpart
of `ray_tpu/rllib/core/rl_module.py`.

ref: rllib/core/rl_module/rl_module.py — a module owns the neural nets
and exposes forward_train / forward_inference / forward_exploration;
learners own optimization, modules own computation.

As in the JAX package, a module holds NO parameters: `init(generator)`
returns a dict of tensors (on the generator's device) and every forward is
a function of (params, ...). Exploration draws from an explicit
`torch.Generator` on the params' device.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from ray_tpu_torch.rllib.models import (
    apply_mlp_policy,
    apply_mlp_q,
    init_mlp_policy,
    init_mlp_q,
)

Params = Any  # a dict of tensors, or of such dicts


class RLModule:
    """Pure-function network bundle (ref: rl_module.py RLModule API)."""

    def init(self, generator: torch.Generator) -> Params:
        raise NotImplementedError

    def forward_train(self, params: Params, obs: torch.Tensor):
        """Everything the loss needs (e.g. logits AND value)."""
        raise NotImplementedError

    def forward_inference(self, params: Params, obs: torch.Tensor):
        """Greedy/deterministic head for serving and evaluation."""
        raise NotImplementedError

    def forward_exploration(self, params: Params, obs: torch.Tensor,
                            generator: torch.Generator):
        """Stochastic head for rollout collection; defaults to
        inference (deterministic modules)."""
        return self.forward_inference(params, obs)


class MLPPolicyModule(RLModule):
    """Separate pi/v towers for actor-critic algorithms (PPO/IMPALA)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64)):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)

    def init(self, generator: torch.Generator) -> Params:
        return init_mlp_policy(generator, self.obs_dim, self.num_actions,
                               self.hidden)

    def forward_train(self, params: Params, obs: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        return apply_mlp_policy(params, obs)  # (logits [B,A], value [B])

    def forward_inference(self, params: Params, obs: torch.Tensor
                          ) -> torch.Tensor:
        logits, _ = apply_mlp_policy(params, obs)
        return torch.argmax(logits, dim=-1)

    def forward_exploration(self, params: Params, obs: torch.Tensor,
                            generator: torch.Generator) -> torch.Tensor:
        logits, _ = apply_mlp_policy(params, obs)
        return torch.multinomial(torch.softmax(logits, -1), 1,
                                 generator=generator)[:, 0]


class DiscreteQModule(RLModule):
    """Q(s, .) MLP for value-based algorithms (DQN family)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64)):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)

    def init(self, generator: torch.Generator) -> Params:
        return init_mlp_q(generator, self.obs_dim, self.num_actions, self.hidden)

    def forward_train(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        return apply_mlp_q(params, obs)  # Q [B, A]

    def forward_inference(self, params: Params, obs: torch.Tensor
                          ) -> torch.Tensor:
        return torch.argmax(apply_mlp_q(params, obs), dim=-1)

    def forward_exploration(self, params: Params, obs: torch.Tensor,
                            generator: torch.Generator, epsilon: float = 0.05
                            ) -> torch.Tensor:
        return epsilon_greedy(apply_mlp_q(params, obs), generator, epsilon)


def epsilon_greedy(q: torch.Tensor, generator: torch.Generator,
                   epsilon: float) -> torch.Tensor:
    """argmax Q, replaced by a uniform action with probability epsilon."""
    greedy = torch.argmax(q, dim=-1)
    rand = torch.randint(0, q.shape[-1], greedy.shape, generator=generator,
                         device=q.device)
    explore = torch.rand(greedy.shape, generator=generator, device=q.device) < epsilon
    return torch.where(explore, rand, greedy)


class MultiRLModule(RLModule):
    """Container of named sub-modules — the multi-agent / multi-policy
    module (ref: rl_module.py MultiRLModule). `init` returns a dict of
    per-module params; forwards take the module id."""

    def __init__(self, modules: Dict[str, RLModule]):
        self._modules = dict(modules)

    def __getitem__(self, module_id: str) -> RLModule:
        return self._modules[module_id]

    def module_ids(self):
        return sorted(self._modules)

    def init(self, generator: torch.Generator) -> Params:
        return {mid: self._modules[mid].init(generator)
                for mid in sorted(self._modules)}

    def forward_train(self, params: Params, obs, module_id: str = None):
        if module_id is not None:
            return self._modules[module_id].forward_train(
                params[module_id], obs)
        return {mid: m.forward_train(params[mid], obs[mid])
                for mid, m in self._modules.items()}

    def forward_inference(self, params: Params, obs, module_id: str = None):
        if module_id is not None:
            return self._modules[module_id].forward_inference(
                params[module_id], obs)
        return {mid: m.forward_inference(params[mid], obs[mid])
                for mid, m in self._modules.items()}

    def forward_exploration(self, params: Params, obs,
                            generator: torch.Generator, module_id: str = None):
        """Dispatch to submodules, each drawing from the generator in
        sorted order (the base default would silently drop the generator
        and explore greedily)."""
        if module_id is not None:
            return self._modules[module_id].forward_exploration(
                params[module_id], obs, generator)
        return {mid: self._modules[mid].forward_exploration(
                    params[mid], obs[mid], generator)
                for mid in sorted(self._modules)}
