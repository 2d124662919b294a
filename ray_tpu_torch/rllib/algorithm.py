"""Algorithm + AlgorithmConfig: the RL training loop, counterpart of
`ray_tpu/rllib/algorithm.py`.

ref: rllib/algorithms/algorithm.py:196 (Algorithm, a Tune Trainable),
algorithm_config.py (a config of chained setters). The Algorithm owns N
rollout workers (one local object, or `num_env_runners` ray_tpu_torch
actors) and one Learner (or a LearnerGroup); `train()` runs one iteration
and returns a metrics dict. The learner and the workers' policy steps run on
`device` ("cuda" by default; `.resources(device="cpu")` runs both on the
CPU), or on the learner mesh's device type.

Remote env runners, remote evaluation runners and remote learners are
actors of the runtime: as in the JAX package, building such an algorithm
calls `init(ignore_reinit_error=True)` when the runtime is down, which
raises until the multi-process runtime is ported (ROADMAP queue A, item
10a-ii); run `ray_tpu_torch.init(local_mode=True)` first to host them in
this process.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

import ray_tpu_torch


class AlgorithmConfig:
    def __init__(self, algo_class=None):
        self.algo_class = algo_class
        self.env: Union[str, Callable, None] = None
        self.num_env_runners = 0
        self.num_envs_per_env_runner = 8
        self.rollout_fragment_length = 128
        self.num_cpus_per_env_runner = 1.0
        self.seed = 0
        self.model_hidden: Tuple[int, ...] = (64, 64)
        self.device = "cuda"      # learner and policy steps
        self.learner_mesh = None  # DeviceMesh with a "dp" dim, or None
        self.num_learners = 0     # 0 = single inline learner
        self.remote_learners = False
        # Connector factories (ref: rllib/connectors/connector_v2.py;
        # see rllib/connectors.py). env/module ones are called once per
        # rollout/eval worker; the learner connector runs in the algorithm's
        # process on every training batch before the update.
        self.env_to_module_connector = None   # () -> Connector
        self.module_to_env_connector = None   # () -> Connector
        self.learner_connector = None         # () -> Connector (batch)
        self.evaluation_interval = 0          # iterations; 0 = disabled
        self.evaluation_num_env_runners = 0   # 0 = evaluate locally
        self.evaluation_duration = 5          # episodes per evaluation

    # chained setters (each returns self, ref: algorithm_config.py)
    def environment(self, env: Union[str, Callable]) -> "AlgorithmConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    num_cpus_per_env_runner: Optional[float] = None,
                    env_to_module_connector: Optional[Callable] = None,
                    module_to_env_connector: Optional[Callable] = None,
                    learner_connector: Optional[Callable] = None
                    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if num_cpus_per_env_runner is not None:
            self.num_cpus_per_env_runner = num_cpus_per_env_runner
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        if module_to_env_connector is not None:
            self.module_to_env_connector = module_to_env_connector
        if learner_connector is not None:
            self.learner_connector = learner_connector
        return self

    def _worker_connectors(self) -> dict:
        """Fresh connector instances for one worker (factories may
        return a single Connector or a list to pipeline)."""
        from ray_tpu_torch.rllib.connectors import Connector, ConnectorPipeline

        def make(factory):
            if factory is None:
                return None
            c = factory()
            if isinstance(c, (list, tuple)):
                c = ConnectorPipeline(list(c))
            if not isinstance(c, Connector):
                raise TypeError("connector factory must return a "
                                "Connector (or list of them)")
            return c

        return {"obs_connector": make(self.env_to_module_connector),
                "action_connector": make(self.module_to_env_connector)}

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def framework(self, _framework: str = "torch") -> "AlgorithmConfig":
        return self  # torch is the only framework

    def resources(self, *, learner_mesh=None, device=None, **_ignored
                  ) -> "AlgorithmConfig":
        """`learner_mesh`: a DeviceMesh with a "dp" dim (its device type
        replaces `device`); `device`: where the learner and the policy
        steps run."""
        if learner_mesh is not None:
            self.learner_mesh = learner_mesh
        if device is not None:
            self.device = device
        return self

    def learners(self, *, num_learners: Optional[int] = None,
                 remote_learners: Optional[bool] = None
                 ) -> "AlgorithmConfig":
        """Data-parallel learner group (ref: AlgorithmConfig.learners /
        core/learner/learner_group.py:60): num_learners>0 builds a
        LearnerGroup, by default a dp mesh over that many ranks of the
        process group; remote_learners=True uses N learner actors."""
        if num_learners is not None:
            self.num_learners = num_learners
        if remote_learners is not None:
            self.remote_learners = remote_learners
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_num_env_runners: Optional[int] = None,
                   evaluation_duration: Optional[int] = None
                   ) -> "AlgorithmConfig":
        """Periodic deterministic evaluation on a SEPARATE worker (ref:
        AlgorithmConfig.evaluation / evaluation/worker_set.py:82), so
        exploration noise never contaminates reported returns."""
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_num_env_runners is not None:
            self.evaluation_num_env_runners = evaluation_num_env_runners
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        return self

    def rl_module(self, *, model_hidden: Optional[Tuple[int, ...]] = None
                  ) -> "AlgorithmConfig":
        if model_hidden is not None:
            self.model_hidden = tuple(model_hidden)
        return self

    def learner_device(self) -> str:
        """The device type the learner and the policy steps run on."""
        mesh = self.learner_mesh
        return mesh.device_type if mesh is not None else self.device

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("AlgorithmConfig has no algo_class; use a "
                             "concrete config (e.g. PPOConfig)")
        if self.env is None:
            raise ValueError("call .environment(env) first")
        return self.algo_class(self)


class Algorithm:
    """One learner + N rollout workers; subclasses provide
    `_setup_learner` and `training_step` (ref: algorithm.py:1490)."""

    def __init__(self, config: AlgorithmConfig):
        from ray_tpu_torch.rllib.rollout_worker import RolloutWorker

        self.config = config
        self._iteration = 0
        self._remote = config.num_env_runners > 0
        gamma = getattr(config, "gamma", 0.99)
        device = config.learner_device()
        if self._remote:
            cls = _remote_runner_class(config)
            self.workers = [
                cls.remote(config.env, num_envs=config.num_envs_per_env_runner,
                           seed=config.seed + 1000 * (i + 1),
                           bootstrap_gamma=gamma, device=device,
                           **config._worker_connectors())
                for i in range(config.num_env_runners)]
            self.space_info = ray_tpu_torch.get(self.workers[0].get_space_info.remote())
        else:
            self.workers = [RolloutWorker(
                config.env, num_envs=config.num_envs_per_env_runner,
                seed=config.seed, bootstrap_gamma=gamma, device=device,
                **config._worker_connectors())]
            self.space_info = self.workers[0].get_space_info()
        self._spaces = (self.space_info["obs_dim"],
                        self.space_info["num_actions"])
        self._eval_workers: List[Any] = []

        obs_dim, num_actions = self._spaces
        self.learner = self._setup_learner(obs_dim, num_actions)
        self._broadcast_weights()

    # -- subclass hooks -----------------------------------------------------
    def _setup_learner(self, obs_dim: int, num_actions: int):
        raise NotImplementedError

    def _build_learner(self, factory):
        """Wrap a `factory(mesh) -> Learner` into the configured learner
        topology: a LearnerGroup when num_learners>0, else one inline
        learner on config.learner_mesh. Conflicting configs are errors,
        not silent reinterpretations."""
        cfg = self.config
        if cfg.num_learners > 0:
            if cfg.learner_mesh is not None:
                raise ValueError(
                    "learner_mesh and num_learners are mutually "
                    "exclusive: num_learners builds its own dp mesh. "
                    "Pass the mesh via resources(learner_mesh=...) "
                    "alone, or let learners(num_learners=N) claim N "
                    "ranks")
            from ray_tpu_torch.rllib.core.learner_group import LearnerGroup

            return LearnerGroup(factory, num_learners=cfg.num_learners,
                                remote=cfg.remote_learners,
                                device_type=cfg.learner_device())
        if cfg.remote_learners:
            raise ValueError("remote_learners=True needs num_learners > 0")
        return factory(cfg.learner_mesh)

    def training_step(self) -> Dict[str, float]:
        raise NotImplementedError

    # -- shared machinery ---------------------------------------------------
    def _on_workers(self, method: str, *args, **kwargs) -> list:
        """`method` of every training worker: remote runners in parallel,
        the local worker inline."""
        if self._remote:
            return ray_tpu_torch.get([getattr(w, method).remote(*args, **kwargs)
                                      for w in self.workers], timeout=600)
        return [getattr(self.workers[0], method)(*args, **kwargs)]

    def _broadcast_weights(self) -> None:
        weights = self.learner.get_weights()
        if self._remote:
            # put() once; workers resolve the shared ref (serialize the
            # weights once per iteration, not once per worker).
            ref = ray_tpu_torch.put(weights)
            ray_tpu_torch.get([w.set_weights.remote(ref) for w in self.workers])
        else:
            self.workers[0].set_weights(weights)

    def _collect(self, method: str, *args, **kwargs
                 ) -> Tuple[Dict[str, np.ndarray], List[float]]:
        """`method` (a sampler) of every training worker, the batches
        concatenated on axis 0 and the episode returns joined."""
        outs = self._on_workers(method, *args, **kwargs)
        batch = {k: np.concatenate([o["batch"][k] for o in outs], axis=0)
                 for k in outs[0]["batch"]}
        return batch, [r for o in outs for r in o["episode_returns"]]

    def _sample_rollouts(self) -> Tuple[Dict[str, np.ndarray], List[float]]:
        batch, episode_returns = self._collect(
            "sample", self.config.rollout_fragment_length)
        return self._apply_learner_connector(batch), episode_returns

    def _apply_learner_connector(self, batch):
        """The batch transform before the learner update (ref:
        the learner connector pipeline, rllib/connectors/learner/);
        built lazily from config.learner_connector."""
        factory = self.config.learner_connector
        if factory is None:
            return batch
        if not hasattr(self, "_learner_conn"):
            self._learner_conn = factory()
        return self._learner_conn(batch)

    # -- evaluation (ref: Algorithm.evaluate + worker_set.py:82) -------------
    _eval_mode = "greedy_pi"   # subclasses: greedy_q (DQN), sac_mean (SAC)

    def _ensure_eval_workers(self) -> None:
        if self._eval_workers:
            return
        from ray_tpu_torch.rllib.rollout_worker import RolloutWorker

        cfg = self.config
        n = cfg.evaluation_num_env_runners
        gamma = getattr(cfg, "gamma", 0.99)
        kw = dict(num_envs=cfg.num_envs_per_env_runner, bootstrap_gamma=gamma,
                  device=cfg.learner_device())
        if n > 0:
            cls = _remote_runner_class(cfg)
            self._eval_workers = [
                cls.remote(cfg.env, seed=cfg.seed + 9000 + i,
                           **kw, **cfg._worker_connectors())
                for i in range(n)]
        else:
            self._eval_workers = [RolloutWorker(
                cfg.env, seed=cfg.seed + 9000, **kw,
                **cfg._worker_connectors())]

    def _connector_state(self):
        """Training worker 0's obs-filter state (None when stateless, or
        when the algorithm collects without workers, as DreamerV3 does)."""
        if self.config.env_to_module_connector is None or not self.workers:
            return None     # no filter: skip the remote round-trip
        m = self.workers[0].get_connector_state
        return ray_tpu_torch.get(m.remote(), timeout=60) if hasattr(m, "remote") else m()

    @staticmethod
    def _push_connector_state(workers, state) -> None:
        if state is None:
            return
        refs = []
        for w in workers:
            m = w.set_connector_state
            if hasattr(m, "remote"):
                refs.append(m.remote(state))
            else:
                m(state)
        if refs:
            ray_tpu_torch.get(refs, timeout=60)

    def evaluate(self) -> Dict[str, float]:
        """Deterministic episodes on the separate eval worker set.
        Stateful obs filters sync from training worker 0 first — the
        policy must be evaluated on the observation space it was trained
        on, not a fresh count=0 filter."""
        self._ensure_eval_workers()
        cfg = self.config
        self._push_connector_state(self._eval_workers, self._connector_state())
        weights = self.learner.get_weights()
        episodes = max(1, cfg.evaluation_duration)
        if cfg.evaluation_num_env_runners > 0:
            ref = ray_tpu_torch.put(weights)
            ray_tpu_torch.get([w.set_weights.remote(ref) for w in self._eval_workers])
            n = len(self._eval_workers)
            per = [episodes // n + (1 if i < episodes % n else 0)
                   for i in range(n)]
            outs = ray_tpu_torch.get([w.evaluate.remote(p, mode=self._eval_mode)
                                      for w, p in zip(self._eval_workers, per) if p],
                                     timeout=600)
            returns = [r for o in outs for r in o]
        else:
            w = self._eval_workers[0]
            w.set_weights(weights)
            returns = w.evaluate(episodes, mode=self._eval_mode)
        return {
            "evaluation/episode_return_mean": float(np.mean(returns)),
            "evaluation/num_episodes": float(len(returns)),
        }

    # -- public surface (ref: Algorithm.train/save/restore/stop) ------------
    def train(self) -> Dict[str, float]:
        self._iteration += 1
        metrics = self.training_step()
        metrics["training_iteration"] = float(self._iteration)
        interval = self.config.evaluation_interval
        if interval and self._iteration % interval == 0:
            metrics.update(self.evaluate())
        return metrics

    def get_weights(self) -> Any:
        return self.learner.get_weights()

    def set_weights(self, weights: Any) -> None:
        self.learner.set_weights(weights)
        self._broadcast_weights()

    def save(self, checkpoint_dir: Optional[str] = None) -> str:
        checkpoint_dir = checkpoint_dir or tempfile.mkdtemp(
            prefix="rllib_ckpt_")
        os.makedirs(checkpoint_dir, exist_ok=True)
        with open(os.path.join(checkpoint_dir, "algorithm.pkl"), "wb") as f:
            pickle.dump({"learner_state": self.learner.get_state(),
                         "iteration": self._iteration,
                         # Stateful obs filters are part of the policy's
                         # input contract; a restore without them feeds
                         # the net a different observation scale.
                         "connector_state": self._connector_state()}, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        """Load a checkpoint this program's `save` wrote (it is a pickle:
        restore only checkpoints you trust)."""
        with open(os.path.join(checkpoint_dir, "algorithm.pkl"), "rb") as f:
            state = pickle.load(f)
        self._iteration = state["iteration"]
        self.learner.set_state(state["learner_state"])
        self._push_connector_state(self.workers, state.get("connector_state"))
        self._broadcast_weights()

    def stop(self) -> None:
        if ray_tpu_torch.is_initialized():  # else the actors are gone
            for w in self.workers + self._eval_workers:
                if isinstance(w, ray_tpu_torch.ActorHandle):
                    ray_tpu_torch.kill(w)
        if hasattr(self.learner, "shutdown"):
            self.learner.shutdown()
        self.workers = []
        self._eval_workers = []


def _remote_runner_class(config: AlgorithmConfig):
    """RolloutWorker as an actor class, starting the runtime as the JAX
    package does when it is down (which raises until the multi-process
    runtime is ported: run `init(local_mode=True)` first)."""
    from ray_tpu_torch.rllib.rollout_worker import RolloutWorker

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(ignore_reinit_error=True)
    return ray_tpu_torch.remote(num_cpus=config.num_cpus_per_env_runner)(RolloutWorker)
