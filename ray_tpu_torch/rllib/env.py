"""Environments: a numpy-vectorized env API + registry, a copy of
`ray_tpu/rllib/env.py` (the port imports nothing of ray_tpu).

The reference wraps gym/gymnasium envs per rollout worker
(ref: rllib/env/, evaluation/rollout_worker.py:159). Here the native env
interface is *vectorized from the start* (one `VectorEnv` per worker
stepping `num_envs` in lockstep numpy ops) because the policy forward is
one batched call on the device — per-env Python stepping would starve it.
Gymnasium envs are adapted when the package is present; CartPole and
Pendulum ship built-in so the RL stack has zero hard deps.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

_ENV_REGISTRY: Dict[str, Callable[..., "VectorEnv"]] = {}


def register_env(name: str, creator: Callable[..., "VectorEnv"]) -> None:
    """ref: ray.tune.registry.register_env — creator(num_envs, seed)."""
    _ENV_REGISTRY[name] = creator


def make_env(name: str, num_envs: int, seed: int = 0) -> "VectorEnv":
    if name in _ENV_REGISTRY:
        return _ENV_REGISTRY[name](num_envs=num_envs, seed=seed)
    if name in ("CartPole-v1", "CartPole"):
        return CartPoleVecEnv(num_envs=num_envs, seed=seed)
    if name in ("Pendulum-v1", "Pendulum"):
        return PendulumVecEnv(num_envs=num_envs, seed=seed)
    try:
        return GymnasiumVecEnv(name, num_envs=num_envs, seed=seed)
    except ImportError:
        raise ValueError(
            f"unknown env {name!r}: not registered, not built-in, and "
            f"gymnasium is unavailable") from None


class VectorEnv:
    """Batch of envs stepped in lockstep; auto-resets finished episodes.

    Discrete envs set `num_actions`; continuous-control envs set
    `continuous=True` with `act_dim`/`act_limit` (actions are float
    arrays in [-act_limit, act_limit]^act_dim)."""

    num_envs: int
    obs_dim: int
    num_actions: int = 0
    continuous: bool = False
    act_dim: int = 0
    act_limit: float = 1.0

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Returns (obs, rewards, dones, episode_returns) where
        episode_returns[i] is NaN except on the step env i finished.

        After each step, `self.truncateds` marks envs cut by a time limit
        (done but NOT terminal — the learner must bootstrap their value)
        and `self.final_obs` holds every env's pre-reset observation, so
        a truncated state's value is still computable."""
        raise NotImplementedError

    truncateds: np.ndarray
    final_obs: np.ndarray


class CartPoleVecEnv(VectorEnv):
    """Vectorized CartPole (classic Barto-Sutton-Anderson dynamics, the
    same physics constants gymnasium's CartPole-v1 documents)."""

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    num_actions = 2
    obs_dim = 4

    def __init__(self, num_envs: int = 1, seed: int = 0):
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((num_envs, 4), dtype=np.float64)
        self._steps = np.zeros(num_envs, dtype=np.int64)
        self._returns = np.zeros(num_envs, dtype=np.float64)

    def _reset_idx(self, idx: np.ndarray) -> None:
        self._state[idx] = self._rng.uniform(-0.05, 0.05, (idx.sum(), 4))
        self._steps[idx] = 0
        self._returns[idx] = 0.0

    def reset(self) -> np.ndarray:
        all_idx = np.ones(self.num_envs, dtype=bool)
        self._reset_idx(all_idx)
        self.truncateds = np.zeros(self.num_envs, dtype=bool)
        self.final_obs = self._state.astype(np.float32)
        return self._state.astype(np.float32)

    def step(self, actions: np.ndarray):
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(actions == 1, self.FORCE_MAG, -self.FORCE_MAG)
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        temp = (force + pole_ml * theta_dot ** 2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.POLE_HALF_LEN
            * (4.0 / 3.0 - self.POLE_MASS * cos_t ** 2 / total_mass))
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * x_acc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * theta_acc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self._steps += 1
        self._returns += 1.0

        failed = ((np.abs(x) > self.X_LIMIT)
                  | (np.abs(theta) > self.THETA_LIMIT))
        truncated = (self._steps >= self.MAX_STEPS) & ~failed
        dones = failed | truncated
        rewards = np.ones(self.num_envs, dtype=np.float32)
        self.truncateds = truncated.copy()
        self.final_obs = self._state.astype(np.float32)

        episode_returns = np.full(self.num_envs, np.nan)
        if dones.any():
            episode_returns[dones] = self._returns[dones]
            self._reset_idx(dones)
        return (self._state.astype(np.float32), rewards,
                dones.astype(np.float32), episode_returns)


class PendulumVecEnv(VectorEnv):
    """Vectorized Pendulum swing-up (the classic continuous-control
    benchmark; same dynamics constants gymnasium's Pendulum-v1
    documents): obs [cosθ, sinθ, θ̇], one torque action in [-2, 2],
    reward -(θ² + 0.1 θ̇² + 0.001 a²), 200-step time limit (always a
    truncation — there is no terminal state)."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    obs_dim = 3
    continuous = True
    act_dim = 1
    act_limit = 2.0

    def __init__(self, num_envs: int = 1, seed: int = 0):
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self._theta = np.zeros(num_envs)
        self._theta_dot = np.zeros(num_envs)
        self._steps = np.zeros(num_envs, dtype=np.int64)
        self._returns = np.zeros(num_envs)

    def _reset_idx(self, idx: np.ndarray) -> None:
        n = int(idx.sum())
        self._theta[idx] = self._rng.uniform(-np.pi, np.pi, n)
        self._theta_dot[idx] = self._rng.uniform(-1.0, 1.0, n)
        self._steps[idx] = 0
        self._returns[idx] = 0.0

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self._theta), np.sin(self._theta),
                         self._theta_dot], axis=1).astype(np.float32)

    def reset(self) -> np.ndarray:
        self._reset_idx(np.ones(self.num_envs, dtype=bool))
        self.truncateds = np.zeros(self.num_envs, dtype=bool)
        self.final_obs = self._obs()
        return self._obs()

    def step(self, actions: np.ndarray):
        u = np.clip(np.asarray(actions, np.float64).reshape(self.num_envs),
                    -self.MAX_TORQUE, self.MAX_TORQUE)
        th = ((self._theta + np.pi) % (2 * np.pi)) - np.pi  # angle_normalize
        costs = th ** 2 + 0.1 * self._theta_dot ** 2 + 0.001 * u ** 2
        new_dot = self._theta_dot + (
            3 * self.G / (2 * self.L) * np.sin(self._theta)
            + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        new_dot = np.clip(new_dot, -self.MAX_SPEED, self.MAX_SPEED)
        self._theta = self._theta + new_dot * self.DT
        self._theta_dot = new_dot
        self._steps += 1
        rewards = (-costs).astype(np.float32)
        self._returns += rewards

        truncated = self._steps >= self.MAX_STEPS
        dones = truncated.copy()
        self.truncateds = truncated.copy()
        self.final_obs = self._obs()
        episode_returns = np.full(self.num_envs, np.nan)
        if dones.any():
            episode_returns[dones] = self._returns[dones]
            self._reset_idx(dones)
        return self._obs(), rewards, dones.astype(np.float32), \
            episode_returns


class GymnasiumVecEnv(VectorEnv):
    """Adapter over `gymnasium.make_vec` for everything not built-in."""

    def __init__(self, name: str, num_envs: int = 1, seed: int = 0):
        import gymnasium as gym

        # gymnasium >=1.0 defaults vector envs to NEXT_STEP autoreset,
        # which injects a ghost transition after each episode; force the
        # SAME_STEP contract this module is written against.
        try:
            from gymnasium.vector import AutoresetMode

            self._env = gym.make_vec(
                name, num_envs=num_envs,
                vector_kwargs={"autoreset_mode": AutoresetMode.SAME_STEP})
        except (ImportError, TypeError):
            self._env = gym.make_vec(name, num_envs=num_envs)
        self.num_envs = num_envs
        self.obs_dim = int(np.prod(self._env.single_observation_space.shape))
        self.num_actions = int(self._env.single_action_space.n)
        self._seed = seed
        self._returns = np.zeros(num_envs, dtype=np.float64)

    def reset(self) -> np.ndarray:
        obs, _ = self._env.reset(seed=self._seed)
        self._returns[:] = 0.0
        obs = np.asarray(obs, dtype=np.float32).reshape(self.num_envs, -1)
        self.truncateds = np.zeros(self.num_envs, dtype=bool)
        self.final_obs = obs
        return obs

    def step(self, actions: np.ndarray):
        obs, rew, term, trunc, infos = self._env.step(np.asarray(actions))
        obs = np.asarray(obs, dtype=np.float32).reshape(self.num_envs, -1)
        rew = np.asarray(rew, dtype=np.float32)
        term = np.asarray(term, dtype=bool)
        trunc = np.asarray(trunc, dtype=bool) & ~term
        dones = (term | trunc).astype(np.float32)
        self.truncateds = trunc
        # SAME_STEP autoreset puts the pre-reset observation in infos;
        # fall back to the returned obs (no bootstrap) when absent.
        self.final_obs = obs
        final = infos.get("final_obs", infos.get("final_observation"))
        if final is not None:
            self.final_obs = obs.copy()
            for i, fo in enumerate(final):
                if fo is not None:
                    self.final_obs[i] = np.asarray(
                        fo, dtype=np.float32).reshape(-1)
        self._returns += rew
        episode_returns = np.full(self.num_envs, np.nan)
        finished = dones > 0
        if finished.any():
            episode_returns[finished] = self._returns[finished]
            self._returns[finished] = 0.0
        return obs, rew, dones, episode_returns
