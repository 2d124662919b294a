"""RolloutWorker: experience collection, counterpart of the local
`ray_tpu/rllib/rollout_worker.py`.

ref: rllib/evaluation/rollout_worker.py:159. Steps a numpy VectorEnv in
lockstep and batches every policy forward into one call on `device` (by
default the learner's; "cuda" unless the algorithm runs on the CPU), its
sampling noise from the worker's own `torch.Generator` there. Weights
arrive as numpy (the learner's `get_weights`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Union

import numpy as np
import torch

from ray_tpu_torch.models.transformer import resolve_device
from ray_tpu_torch.rllib.core.rl_module import epsilon_greedy
from ray_tpu_torch.rllib.env import VectorEnv, make_env
from ray_tpu_torch.rllib.jax_bridge import rl_params_from_jax
from ray_tpu_torch.rllib.models import (
    apply_mlp_policy,
    apply_mlp_q,
    apply_sac_actor,
    sample_squashed,
)


class RolloutWorker:
    def __init__(self, env: Union[str, Callable[..., VectorEnv]],
                 num_envs: int = 8, seed: int = 0,
                 bootstrap_gamma: float = 0.99,
                 obs_connector=None, action_connector=None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        if callable(env):
            self.env = env(num_envs=num_envs, seed=seed)
        else:
            self.env = make_env(env, num_envs=num_envs, seed=seed)
        self.obs_dim = self.env.obs_dim
        self.num_actions = self.env.num_actions
        # env->module / module->env connector pipelines (ref:
        # rllib/connectors/connector_v2.py; see rllib/connectors.py).
        # The module only ever sees FILTERED observations — including
        # bootstrap-value calls on final_obs — so train and act spaces
        # stay consistent.
        self._obs_connector = obs_connector
        self._action_connector = action_connector
        self._obs = self._filter(self.env.reset())
        self._params = None
        self._rng = torch.Generator(self.device).manual_seed(seed + 1)
        # Time-limit cuts bootstrap the truncated state's value into the
        # reward (done=1 with no bootstrap would bias V targets low).
        self._gamma = bootstrap_gamma

    def _filter(self, obs: np.ndarray) -> np.ndarray:
        return obs if self._obs_connector is None else \
            self._obs_connector(obs)

    def _act(self, actions: np.ndarray) -> np.ndarray:
        return actions if self._action_connector is None else \
            self._action_connector(actions)

    def _dev(self, obs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(obs, np.float32)).to(self.device)

    def get_connector_state(self):
        return (self._obs_connector.get_state()
                if self._obs_connector is not None else None)

    def set_connector_state(self, state) -> None:
        """Restore the obs filter (checkpoint restore / eval sync) —
        the policy was trained on THIS filter's output space."""
        if self._obs_connector is not None and state is not None:
            self._obs_connector.set_state(state)

    def get_space_info(self) -> Dict[str, Any]:
        return {
            "obs_dim": self.obs_dim,
            "num_actions": self.num_actions,
            "continuous": getattr(self.env, "continuous", False),
            "act_dim": getattr(self.env, "act_dim", 0),
            "act_limit": getattr(self.env, "act_limit", 1.0),
        }

    def set_weights(self, params: Any) -> None:
        self._params = rl_params_from_jax(params, self.device)

    def _require_weights(self) -> None:
        if self._params is None:
            raise RuntimeError("set_weights() before sampling or evaluating")

    @torch.no_grad()
    def _policy_step(self, obs: np.ndarray):
        logits, value = apply_mlp_policy(self._params, self._dev(obs))
        logp_all = torch.log_softmax(logits, -1)
        actions = torch.multinomial(logp_all.exp(), 1, generator=self._rng)
        logp = logp_all.gather(1, actions)[:, 0]
        return actions[:, 0], logp, value

    @torch.no_grad()
    def _value(self, obs: np.ndarray) -> np.ndarray:
        return apply_mlp_policy(self._params, self._dev(obs))[1].cpu().numpy()

    def sample(self, num_steps: int) -> Dict[str, Any]:
        """Collect `num_steps` per env; returns batch arrays [E, T, ...] +
        the bootstrap value and finished-episode returns."""
        self._require_weights()
        E = self.env.num_envs
        obs_buf = np.empty((E, num_steps, self.obs_dim), np.float32)
        act_buf = np.empty((E, num_steps), np.int32)
        logp_buf = np.empty((E, num_steps), np.float32)
        rew_buf = np.empty((E, num_steps), np.float32)
        done_buf = np.empty((E, num_steps), np.float32)
        val_buf = np.empty((E, num_steps), np.float32)
        episode_returns: List[float] = []

        obs = self._obs
        for t in range(num_steps):
            actions, logp, value = self._policy_step(obs)
            # One copy to the host for the step's three outputs.
            out = torch.stack([actions.float(), logp, value]).cpu().numpy()
            actions = out[0].astype(np.int32)
            obs_buf[:, t] = obs
            act_buf[:, t] = actions
            logp_buf[:, t] = out[1]
            val_buf[:, t] = out[2]
            obs, rewards, dones, ep_ret = self.env.step(self._act(actions))
            obs = self._filter(obs)
            trunc = getattr(self.env, "truncateds", None)
            if trunc is not None and trunc.any():
                vals = self._value(self._filter(self.env.final_obs))
                rewards = rewards.copy()
                rewards[trunc] += self._gamma * vals[trunc]
            rew_buf[:, t] = rewards
            done_buf[:, t] = dones
            finished = ~np.isnan(ep_ret)
            if finished.any():
                episode_returns.extend(ep_ret[finished].tolist())
        self._obs = obs
        return {
            "batch": {
                "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
                "rewards": rew_buf, "dones": done_buf, "values": val_buf,
                "final_value": self._value(obs).astype(np.float32),
            },
            "episode_returns": episode_returns,
        }

    def _transitions(self, num_steps: int, act_shape: tuple, act_dtype,
                     policy: Callable[[np.ndarray], np.ndarray]) -> Dict[str, Any]:
        """Flat (s, a, r, s', terminal) transitions for off-policy
        learners. `terminal` excludes time-limit truncations (those
        bootstrap), and s' is the PRE-reset observation on episode ends
        (the auto-reset obs would poison TD targets)."""
        E = self.env.num_envs
        obs_buf = np.empty((E * num_steps, self.obs_dim), np.float32)
        act_buf = np.empty((E * num_steps,) + act_shape, act_dtype)
        rew_buf = np.empty((E * num_steps,), np.float32)
        next_buf = np.empty((E * num_steps, self.obs_dim), np.float32)
        term_buf = np.empty((E * num_steps,), np.float32)
        episode_returns: List[float] = []

        obs = self._obs
        for t in range(num_steps):
            actions = policy(obs)
            lo, hi = t * E, (t + 1) * E
            obs_buf[lo:hi] = obs
            act_buf[lo:hi] = actions
            obs, rewards, dones, ep_ret = self.env.step(self._act(actions))
            obs = self._filter(obs)
            # final_obs is every env's TRUE successor state this step.
            rew_buf[lo:hi] = rewards
            next_buf[lo:hi] = self._filter(self.env.final_obs)
            trunc = getattr(self.env, "truncateds", None)
            terminal = dones.astype(np.float32)
            if trunc is not None:
                terminal = terminal * (1.0 - trunc.astype(np.float32))
            term_buf[lo:hi] = terminal
            finished = ~np.isnan(ep_ret)
            if finished.any():
                episode_returns.extend(ep_ret[finished].tolist())
        self._obs = obs
        return {
            "batch": {
                "obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
                "next_obs": next_buf, "terminals": term_buf,
            },
            "episode_returns": episode_returns,
        }

    def sample_transitions(self, num_steps: int,
                           epsilon: float = 0.0) -> Dict[str, Any]:
        """Off-policy collection for DQN-style learners, epsilon-greedy
        over Q(s, .)."""
        self._require_weights()

        @torch.no_grad()
        def policy(obs):
            q = apply_mlp_q(self._params, self._dev(obs))
            return epsilon_greedy(q, self._rng, epsilon).cpu().numpy()

        return self._transitions(num_steps, (), np.int32, policy)

    def sample_transitions_continuous(self, num_steps: int,
                                      uniform: bool = False
                                      ) -> Dict[str, Any]:
        """Off-policy continuous collection (SAC): float actions from the
        squashed-Gaussian actor (or uniform random warmup)."""
        act_dim = self.env.act_dim
        limit = float(self.env.act_limit)
        E = self.env.num_envs
        if not uniform:
            self._require_weights()

        @torch.no_grad()
        def policy(obs):
            if uniform:
                a = torch.rand((E, act_dim), generator=self._rng,
                               device=self.device) * (2 * limit) - limit
            else:
                mu, log_std = apply_sac_actor(self._params, self._dev(obs))
                noise = torch.randn(mu.shape, generator=self._rng,
                                    device=self.device)
                a = sample_squashed(mu, log_std, noise, limit)[0]
            return a.cpu().numpy()

        return self._transitions(num_steps, (act_dim,), np.float32, policy)

    @torch.no_grad()
    def evaluate(self, num_episodes: int, mode: str = "greedy_pi"
                 ) -> List[float]:
        """Deterministic evaluation episodes on FRESH env state (ref:
        evaluation workers, rllib/evaluation/worker_set.py:82 — separate
        from training collection so metrics aren't exploration-noised).
        mode: greedy_pi (argmax logits) | greedy_q (argmax Q) |
        sac_mean (tanh(mu))."""
        self._require_weights()
        limit = float(getattr(self.env, "act_limit", 1.0))
        returns: List[float] = []
        obs = self._filter(self.env.reset())
        guard = 0
        while len(returns) < num_episodes and guard < 100_000:
            guard += 1
            x = self._dev(obs)
            if mode == "sac_mean":
                actions = torch.tanh(apply_sac_actor(self._params, x)[0]) * limit
            elif mode == "greedy_q":
                actions = torch.argmax(apply_mlp_q(self._params, x), dim=1)
            else:
                actions = torch.argmax(apply_mlp_policy(self._params, x)[0], dim=1)
            obs, _, _, ep_ret = self.env.step(self._act(actions.cpu().numpy()))
            obs = self._filter(obs)
            done = ~np.isnan(ep_ret)
            if done.any():
                returns.extend(ep_ret[done].tolist())
        self._obs = self._filter(self.env.reset())  # training state fresh
        return returns[:num_episodes]
