"""Pipeline parallelism: GPipe microbatching over a `pp` mesh axis,
counterpart of `ray_tpu/parallel/pipeline.py`.

SPMD, as the JAX package builds it: one rank per device, the stages a
mesh axis, the block stack split over it on its layers axis, and
activations moving stage to stage by `ppermute_ring` over `pp`.

Schedule: GPipe. With S stages and M microbatches the loop runs
M + S - 1 ticks; each tick every stage applies its L/S blocks to the
activation it holds, then rotates activations one hop along the ring.
Stage 0 feeds fresh microbatches in; the last stage collects outputs.
Backward runs through the same ticks by autograd: each rotation's
backward rotates the cotangent back. The bubble ticks are kept, as in
JAX: every stage computes every tick, and stage-dependent choices are
`torch.where` on a stage flag, so the autograd graph, and with it the
order of the collectives in backward, is the same on every rank. With
`cfg.remat` each block runs under a full checkpoint.

Composes with data parallelism: the mesh is (dp, pp); the batch rows
split over dp and are microbatched over pp time. The stage body is the
port's `_block`, whose attention is `flash_attention`: the hand-written
CUDA kernels on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.models import configs
from ray_tpu_torch.models.training import (
    SGD, AdamW, TrainState, own_params, tree_leaves)
from ray_tpu_torch.models.transformer import (
    Layout, TransformerConfig, _block_fn, init_params, param_shapes, resolve_device)
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.parallel.collectives import axis_index, axis_size, ppermute_ring, psum
from ray_tpu_torch.parallel.mesh import AXIS_DATA, ensure_group, local_batch_rows
from ray_tpu_torch.parallel.sharding import NamedSharding, gather_param

AXIS_PIPE = "pp"
# The train state of `make_pipeline_train_step`: step, params, opt_state.
PipelineTrainState = TrainState


def build_pipeline_mesh(n_stages: int, dp: int = 1, *,
                        device_type: str = "cuda") -> DeviceMesh:
    """A (dp, pp) mesh over the first dp x pp ranks of the default process
    group (a world-1 group is started when there is none), as the JAX
    package takes the first devices. Every rank must call it; a rank past
    dp x pp is in no position of it (`get_coordinate()` is None) and must
    not run the pipeline. Rank r sits at the row-major position r: pp is
    innermost, so a stage hop goes to the next rank."""
    ensure_group(device_type)
    need, world = n_stages * dp, dist.get_world_size()
    if world < need:
        raise ValueError(f"need {need} ranks for dp={dp} x pp={n_stages}, "
                         f"have {world}")
    return DeviceMesh(device_type, torch.arange(need).reshape(dp, n_stages),
                      mesh_dim_names=(AXIS_DATA, AXIS_PIPE))


def _stage_params_spec(cfg: TransformerConfig) -> dict:
    """PartitionSpec-shaped tuples: the block stack split over pp on the
    layers axis, the embedding, final norm and head replicated (stage 0
    and the last stage use them)."""
    specs = {"embed": (),
             "blocks": {name: (AXIS_PIPE,) for name in param_shapes(cfg)["blocks"]},
             "final_norm": ()}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ()
    return specs


def pipeline_shardings(cfg: TransformerConfig, mesh: DeviceMesh) -> dict:
    """`_stage_params_spec` on `mesh`: a tree of NamedShardings."""
    return {k: ({n: NamedSharding(mesh, s) for n, s in v.items()}
                if isinstance(v, dict) else NamedSharding(mesh, v))
            for k, v in _stage_params_spec(cfg).items()}


def make_pipeline_loss(cfg: TransformerConfig, mesh: DeviceMesh,
                       n_microbatches: int) -> Callable:
    """loss(params, batch) -> scalar, pipelined over the mesh's pp axis.

    `params` are laid out by `pipeline_shardings`; `batch` is the global
    batch ({"tokens": (B, T+1)} or tokens and "targets", optionally a
    "mask"), of which each rank takes its dp rows. The same function as
    `models.transformer.loss_fn`: the same blocks and cross entropy,
    microbatched on the batch dim; the loss is the same on every rank.
    """
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "pipeline + MoE: route experts inside a stage via the ep axis")
    n_stages = axis_size(AXIS_PIPE, mesh=mesh)
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"pp={n_stages}")
    M, S = n_microbatches, n_stages
    cd = cfg.compute_dtype
    stage = axis_index(AXIS_PIPE, mesh=mesh)
    device = resolve_device(mesh.device_type)
    # The JAX stage body is jax.checkpoint(_block) with no policy: "full".
    block = _block_fn(dataclasses.replace(cfg, remat_policy="full"))
    plain = Layout()  # the stage body computes on this rank's local weights
    replicated = (AXIS_DATA, AXIS_PIPE)

    def run_stage(x, layers, positions):
        for bp in layers:
            x, _ = block(x, bp, positions, cfg, plain)
        return x

    def pipelined(params, tokens, targets, mask):
        bl, t = tokens.shape
        if bl % M:
            raise ValueError(f"local batch {bl} not divisible by "
                             f"n_microbatches={M}")
        mb = bl // M
        positions = torch.arange(t, dtype=torch.int32, device=tokens.device)
        # This stage's L/S layers, their grads summed over dp; the
        # replicated weights' grads sum over pp too (only stage 0 and the
        # last stage give them one).
        blocks = {n: gather_param(w, keep=(AXIS_PIPE,), partial=(AXIS_DATA,))
                  for n, w in params["blocks"].items()}
        if blocks["wq"].shape[0] != cfg.n_layers // S:
            raise ValueError(f"params hold {blocks['wq'].shape[0]} layers a stage, "
                             f"not {cfg.n_layers // S}: lay them out by "
                             f"pipeline_shardings")
        layers = [dict(zip(blocks, ws))
                  for ws in zip(*(w.unbind(0) for w in blocks.values()))]
        embed = gather_param(params["embed"], partial=replicated)
        # Filled on the device: no host-to-device copy in the step.
        first = torch.full((), stage == 0, device=tokens.device)
        last = torch.full((), stage == S - 1, device=tokens.device)

        x_all = embed.to(cd)[tokens].reshape(M, mb, t, cfg.d_model)
        outs = [torch.zeros((mb, t, cfg.d_model), dtype=cd, device=tokens.device)] * M
        act = torch.zeros((mb, t, cfg.d_model), dtype=cd, device=tokens.device)
        for i in range(M + S - 1):
            x_in = torch.where(first, x_all[min(i, M - 1)], act)
            y = run_stage(x_in, layers, positions)
            idx = i - (S - 1)
            if 0 <= idx < M:
                outs[idx] = torch.where(last, y, outs[idx])
            # The last tick's rotation would go unused (JAX discards it).
            if i < M + S - 2:
                act = ppermute_ring(y, AXIS_PIPE, mesh=mesh)

        # Loss on the last stage only; the psum makes it uniform over pp.
        h = rms_norm(torch.cat(outs), gather_param(params["final_norm"], partial=replicated),
                     eps=cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = h @ embed.to(cd).t()
        else:
            logits = h @ gather_param(params["lm_head"], partial=replicated).to(cd)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        nll = (logz - tgt) * mask
        total = psum(torch.where(last, nll, 0.0).sum(), (AXIS_PIPE, AXIS_DATA), mesh=mesh)
        # The token count sums over dp only: the pp ranks hold replicas.
        n_tokens = psum(mask.sum(), AXIS_DATA, mesh=mesh)
        return total / torch.clamp(n_tokens, min=1.0)

    def loss(params: dict, batch: dict) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"])
        rows = local_batch_rows(mesh, tokens.shape[0], (AXIS_DATA,))
        tokens = tokens[rows].to(device)
        if "targets" in batch:
            inputs, targets = tokens, torch.as_tensor(batch["targets"])[rows].to(device)
        else:
            inputs, targets = tokens[:, :-1], tokens[:, 1:]
        mask = batch.get("mask")
        mask = torch.ones(targets.shape, device=device) if mask is None else \
            torch.as_tensor(mask)[rows].to(device, torch.float32)
        return pipelined(params, inputs, targets, mask)

    return loss


def make_pipeline_train_step(
    cfg: TransformerConfig, mesh: DeviceMesh, *,
    n_microbatches: int,
    optimizer: AdamW | SGD | None = None,
) -> tuple[Callable[..., TrainState], Callable[..., tuple[TrainState, dict]]]:
    """(init_fn(generator=None, *, params=None) -> PipelineTrainState,
    step_fn(state, batch) -> (state, {"loss": ...})) with the block stack
    split over the pp axis; AdamW (optax.adamw(1e-3)) by default.

    Each stage's layer grads stay on their stage; the replicated
    embedding, norm and head have their grads summed over dp and pp by
    `gather_param`. The step updates the state in place, as
    `models.training.make_train_step` does.
    """
    optimizer = optimizer or AdamW()
    loss = make_pipeline_loss(cfg, mesh, n_microbatches)
    shardings = pipeline_shardings(cfg, mesh)
    device = resolve_device(mesh.device_type)

    def init_fn(generator: torch.Generator | None = None, *,
                params: dict | None = None) -> TrainState:
        if params is None:
            params = init_params(cfg, generator, device=device)
        params = own_params(params, shardings, device, cfg.param_dtype)
        return TrainState(step=0, params=params,
                          opt_state=optimizer.init(tree_leaves(params)))

    def step_fn(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        lval = loss(state.params, batch)
        lval.backward()
        optimizer.update(state.opt_state, tree_leaves(state.params), state.step)
        state.step += 1
        return state, {"loss": lval.detach()}

    return init_fn, step_fn


def dryrun_pipeline(n_devices: int, *, device_type: str = "cuda") -> None:
    """A tiny 2-stage GPipe step over the default process group's ranks
    (dp 2 when there are 4 of them), as the JAX package's dry-run hook."""
    pp = 2
    dp = max(1, min(2, n_devices // pp))
    mesh = build_pipeline_mesh(pp, dp=dp, device_type=device_type)
    cfg = dataclasses.replace(configs.TINY, n_layers=2, d_model=64, d_ff=128,
                              n_heads=4, n_kv_heads=4, remat=False)
    init_fn, step_fn = make_pipeline_train_step(cfg, mesh, n_microbatches=2,
                                                optimizer=SGD(1e-3))
    state = init_fn()
    state, metrics = step_fn(state, {"tokens": np.zeros((4 * dp, 33), np.int32)})
    float(metrics["loss"])
    if state.step != 1:
        raise RuntimeError(f"dryrun_pipeline: step {state.step} after one step")
