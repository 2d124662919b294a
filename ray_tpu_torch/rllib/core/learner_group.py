"""LearnerGroup: data-parallel training across N learners, counterpart of
`ray_tpu/rllib/core/learner_group.py`.

ref: rllib/core/learner/learner_group.py:60. Two modes, as in JAX:

**In-process dp (default).** The JAX group claims N local devices as a dp
mesh and runs the learner's one program over it. Here each of N processes
(ranks of the default process group, one device each, as torch.distributed
runs them) builds the group with the same arguments and is handed the same
global batch: `num_learners=N` builds a dp `DeviceMesh` over the N ranks of
the group and the factory's learner splits the batch on axis 0 over it,
summing its gradients over dp once per minibatch (`core/learner.py`), so
every rank keeps the same params as a single learner on the whole batch.
At N = 1 it is one learner with no mesh and no collective.

**Remote actors (`remote=True`).** N ray_tpu_torch actors each own a full
learner; per update the batch splits on axis 0 (`np.array_split`), every
actor runs the update on its shard, then the float state (params and
optimizer moments; step counts stay the first actor's) is averaged across
actors weighted by shard rows (`_tree_avg`, in float64 as JAX's) and put
back through the object store: two rounds of actor calls per update. The
weighted mean of per-shard Adam updates is not the global-batch update,
but the actors stay exactly synchronized after every update. Each actor
draws its own noise: actor i > 0 reseeds its generator from its stream
plus i, as JAX folds i into its key.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

import ray_tpu_torch
from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh


def _tree_avg(trees: List[Any], weights: List[float]) -> Any:
    """Row-weighted elementwise mean over float leaves of nested dicts,
    lists and tuples, in float64; the first tree wins elsewhere (optimizer
    step counters must stay integral)."""
    total = float(sum(weights))
    frac = [w / total for w in weights]

    def avg(*leaves):
        first = leaves[0]
        if isinstance(first, dict):
            return {k: avg(*(t[k] for t in leaves)) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(avg(*xs) for xs in zip(*leaves))
        if np.issubdtype(np.asarray(first).dtype, np.floating):
            return sum(f * np.asarray(x, dtype=np.float64)
                       for f, x in zip(frac, leaves))
        return first

    return avg(*trees)


class _LearnerActor:
    """Runs one learner in an actor (wrapped by ray_tpu_torch.remote)."""

    def __init__(self, factory: Callable, index: int):
        self.index = index
        self.learner = factory(None)
        self._decorrelate_rng()

    def _decorrelate_rng(self) -> None:
        """Fork per-actor noise (PPO's permutations, SAC's action noise)
        while param init stays identical (the factory seed fixes init; only
        the running generator forks). Actor 0 keeps the canonical stream."""
        rng = getattr(self.learner, "_rng", None)
        if self.index and rng is not None:
            seed = int(torch.randint(2**62, (1,), generator=rng, device=rng.device))
            rng.manual_seed(seed + self.index)

    def update_and_collect(self, shard: Dict[str, np.ndarray],
                           noise: Optional[dict] = None):
        """One update + the post-update sync state (folds the collect call
        into the update round)."""
        metrics = self.learner.update(shard, noise)
        state = self.learner.get_state()
        state.pop("rng", None)  # each actor keeps its own stream
        return metrics, state

    def set_sync_state(self, state: Dict[str, Any]) -> None:
        self.learner.set_state(state)

    def get_weights(self) -> Any:
        return self.learner.get_weights()

    def set_weights(self, w: Any) -> None:
        self.learner.set_weights(w)

    def get_state(self) -> Dict[str, Any]:
        return self.learner.get_state()

    def set_state(self, state: Dict[str, Any]) -> None:
        self.learner.set_state(state)
        # A broadcast restore ships ONE generator state to every actor;
        # re-fork so actors don't degenerate into N identically-noised copies.
        self._decorrelate_rng()


class LearnerGroup:
    """Drop-in for a single learner: update/get/set weights+state."""

    def __init__(self, factory: Callable, num_learners: int = 1,
                 remote: bool = False, device_type: str = "cuda",
                 resources_per_learner: Optional[dict] = None):
        self._remote = remote and num_learners > 0
        self.num_learners = max(1, num_learners)
        if self._remote:
            opts = dict(resources_per_learner or {"num_cpus": 1})
            cls = ray_tpu_torch.remote(**opts)(_LearnerActor)
            self._actors = [cls.remote(factory, i)
                            for i in range(self.num_learners)]
            # Surface constructor failures now, not at first update.
            ray_tpu_torch.get([a.get_weights.remote() for a in self._actors],
                              timeout=300)
            return
        if self.num_learners == 1:
            self._learner = factory(None)
            return
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.num_learners:
            raise ValueError(
                f"num_learners={self.num_learners} needs a process group of "
                f"as many ranks, one process per learner; it has {world} "
                f"(or use remote=True for learner actors)")
        mesh = build_mesh(MeshConfig(dp=self.num_learners, fsdp=1),
                          device_type=device_type)
        self._learner = factory(mesh)
        if self._learner.mesh is not mesh:
            raise ValueError(
                "learner factory ignored the group mesh; pass mesh "
                "through to the Learner so the update splits over dp")

    # -- update ---------------------------------------------------------
    def update(self, batch: Dict[str, Any], noise: Any = None):
        """One update. In-process, `noise` is the learner's (`draw_noise`);
        with remote actors, None (each draws its own) or one per actor."""
        if not self._remote:
            return self._learner.update(batch, noise)
        shards = self._split(batch)
        rows = [len(next(iter(s.values()))) for s in shards]
        noises = noise if noise is not None else [None] * len(shards)
        # Round 1: update + collect state; round 2: broadcast average.
        outs = ray_tpu_torch.get(
            [a.update_and_collect.remote(s, n)
             for a, s, n in zip(self._actors, shards, noises)], timeout=600)
        metrics = [m for m, _ in outs]
        ref = ray_tpu_torch.put(_tree_avg([s for _, s in outs], rows))
        ray_tpu_torch.get([a.set_sync_state.remote(ref) for a in self._actors],
                          timeout=600)
        total = float(sum(rows))
        return {k: float(sum(r * m[k] for r, m in zip(rows, metrics)) / total)
                for k in metrics[0]}

    def _split(self, batch: Dict[str, Any]) -> List[Dict]:
        n = self.num_learners
        shards: List[Dict] = [{} for _ in range(n)]
        for k, v in batch.items():
            v = np.asarray(v)
            if v.ndim == 0 or len(v) < n:
                raise ValueError(
                    f"batch[{k!r}] has leading dim {v.shape} — cannot "
                    f"shard across {n} learners")
            for i, piece in enumerate(np.array_split(v, n)):
                shards[i][k] = piece
        return shards

    # -- weights / state ------------------------------------------------
    def _on_actors(self, method: str, *args):
        """`method` on every actor (an argument put once), waited for."""
        args = [ray_tpu_torch.put(a) for a in args]
        return ray_tpu_torch.get([getattr(a, method).remote(*args)
                                  for a in self._actors], timeout=300)

    def get_weights(self) -> Any:
        if not self._remote:
            return self._learner.get_weights()
        return ray_tpu_torch.get(self._actors[0].get_weights.remote(), timeout=300)

    def set_weights(self, w: Any) -> None:
        if not self._remote:
            self._learner.set_weights(w)
            return
        self._on_actors("set_weights", w)

    def get_state(self) -> Dict[str, Any]:
        if not self._remote:
            return self._learner.get_state()
        return ray_tpu_torch.get(self._actors[0].get_state.remote(), timeout=300)

    def set_state(self, state: Dict[str, Any]) -> None:
        if not self._remote:
            self._learner.set_state(state)
            return
        self._on_actors("set_state", state)

    def shutdown(self) -> None:
        """Kill the learner actors (gone already if the runtime is down)."""
        if self._remote:
            if ray_tpu_torch.is_initialized():
                for a in self._actors:
                    ray_tpu_torch.kill(a)
            self._actors = []
