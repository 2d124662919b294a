"""LearnerGroup: data-parallel training across N learners, counterpart of
the in-process mode of `ray_tpu/rllib/core/learner_group.py`.

ref: rllib/core/learner/learner_group.py:60. The JAX group claims N local
devices as a dp mesh and runs the learner's one program over it. Here
each of N processes (ranks of the default process group, one device
each, as torch.distributed runs them) builds the group with the same
arguments and is handed the same global batch: `num_learners=N` builds a
dp `DeviceMesh` over the N ranks of the group and the factory's learner splits
the batch on axis 0 over it, summing its gradients over dp once per
minibatch (`core/learner.py`), so every rank keeps the same params as a
single learner on the whole batch. At N = 1 it is one learner with no mesh
and no collective.

The remote-actor mode (`remote=True`: learner actors synced through the
runtime's object store) needs the runtime, which the port does not have
yet (queue A, item 10): it raises.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh


class LearnerGroup:
    """Drop-in for a single learner: update/get/set weights+state."""

    def __init__(self, factory: Callable, num_learners: int = 1,
                 remote: bool = False, device_type: str = "cuda"):
        if remote and num_learners > 0:
            raise NotImplementedError(
                "remote learner actors need the ray_tpu_torch runtime, "
                "which is not ported yet (ROADMAP queue A, item 10); use "
                "the in-process dp mode (one process per learner)")
        self.num_learners = max(1, num_learners)
        if self.num_learners == 1:
            self._learner = factory(None)
            return
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.num_learners:
            raise ValueError(
                f"num_learners={self.num_learners} needs a process group of "
                f"as many ranks, one process per learner; it has {world}")
        mesh = build_mesh(MeshConfig(dp=self.num_learners, fsdp=1),
                          device_type=device_type)
        self._learner = factory(mesh)
        if self._learner.mesh is not mesh:
            raise ValueError(
                "learner factory ignored the group mesh; pass mesh "
                "through to the Learner so the update splits over dp")

    def update(self, batch: Dict[str, Any], noise: Optional[dict] = None):
        return self._learner.update(batch, noise)

    def get_weights(self) -> Any:
        return self._learner.get_weights()

    def set_weights(self, w: Any) -> None:
        self._learner.set_weights(w)

    def get_state(self) -> Dict[str, Any]:
        return self._learner.get_state()

    def set_state(self, state: Dict[str, Any]) -> None:
        self._learner.set_state(state)
