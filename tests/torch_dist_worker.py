"""The ranks of tests/test_torch_distributed.py: each is a spawned process
that joins a gloo group through `TorchBackend`, then runs the cases its
parent sends, all ranks in the same order, and sends back numpy results.

This module imports torch and the port only, never JAX: it is what each
spawned process imports.
"""
from __future__ import annotations

import dataclasses
import traceback

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from ray_tpu_torch.data import torch_feed
from ray_tpu_torch.models import configs, decoding
from ray_tpu_torch.models.jax_bridge import params_from_jax, params_to_numpy
from ray_tpu_torch.models.transformer import forward, param_logical_axes
from ray_tpu_torch.models.training import (
    SGD, Adafactor, default_optimizer, make_train_step, tree_leaves)
from ray_tpu_torch.ops import ring_attention, ulysses_attention
from ray_tpu_torch.parallel import collectives, pipeline, sharding
from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh, local_batch_rows
from ray_tpu_torch.serve.llm import LLMEngine, dryrun_tp_serving
from ray_tpu_torch.train import TorchBackend

TCFG = dataclasses.replace(configs.TINY, compute_dtype=torch.float32)
CFGS = {"tiny": TCFG,
        "tiny_moe": dataclasses.replace(configs.TINY_MOE, compute_dtype=torch.float32)}
RULES = {"default": sharding.DEFAULT_RULES, "ddp": sharding.DDP_RULES,
         "tp": sharding.TP_RULES}
_meshes: dict = {}


def mesh_for(sizes: dict):
    """One DeviceMesh per layout, built by every rank in the same order."""
    key = tuple(sorted(sizes.items()))
    if key not in _meshes:
        _meshes[key] = build_mesh(MeshConfig(**sizes), device_type="cpu")
    return _meshes[key]


def pipeline_mesh_for(pp: int, dp: int):
    """One pipeline mesh per (pp, dp) over the first pp x dp ranks, built
    by every rank in the same order."""
    if (pp, dp) not in _meshes:
        _meshes[pp, dp] = pipeline.build_pipeline_mesh(pp, dp=dp, device_type="cpu")
    return _meshes[pp, dp]


def _optimizer(opt: dict):
    if opt["kind"] == "adafactor":
        return Adafactor(opt["lr"])
    if opt["kind"] == "sgd":
        return SGD(opt["lr"])
    return default_optimizer(opt["lr"], warmup=opt["warmup"],
                             total_steps=opt["total_steps"])


def train(sizes, rules, start, batches, opt, feed=False, sp_attention="ring",
          cfg_name="tiny"):
    """`len(batches)` steps from the JAX-drawn `start` params on global
    batches; with `feed`, the batches come through `torch_feed` as
    DTensors. Returns the metrics, the final params (whole), the rows fed
    to this rank, the local shape of w_gate and, with MoE, the auxiliary
    losses of `forward` on the first batch before the steps."""
    mesh = mesh_for(sizes)
    cfg = dataclasses.replace(CFGS[cfg_name], sp_attention=sp_attention)
    init_fn, step_fn = make_train_step(cfg, mesh, rules=RULES[rules],
                                       optimizer=_optimizer(opt))
    state = init_fn(params=params_from_jax(start, cfg, mesh=mesh, rules=RULES[rules]))
    aux = {}
    if cfg.n_experts:
        rows = local_batch_rows(mesh, batches[0].shape[0], ("dp", "fsdp"))
        tokens = batches[0][rows, :-1]
        if sizes.get("sp", 1) > 1:
            tokens = _columns(tokens, mesh)
        with torch.no_grad():
            forward(state.params, torch.from_numpy(tokens), cfg, mesh=mesh,
                    rules=RULES[rules], seq_shards=sizes.get("sp", 1), return_aux=aux)
    w_gate = tuple(sharding.local_tensor(state.params["blocks"]["w_gate"]).shape)
    source = ({"tokens": b} for b in batches)
    fed_rows, metrics = [], []
    with torch_feed(source, device="cpu", mesh=mesh if feed else None) as stream:
        for batch in stream:
            if feed:
                fed_rows.append(sharding.local_tensor(batch["tokens"]).numpy())
            state, m = step_fn(state, batch if feed else
                               {"tokens": batch["tokens"].numpy()})
            metrics.append({"loss": float(m["loss"]),
                            "grad_norm": float(m["grad_norm"])})
    return {"metrics": metrics, "params": params_to_numpy(state.params),
            "fed_rows": fed_rows, "w_gate": w_gate,
            "aux": {k: float(v) for k, v in aux.items()}}


def shapes(sizes, rules):
    """The local shapes of embed, wq and w_down on this rank after
    `init_fn`, and what `NamedSharding.shard_shape` says they are."""
    mesh = mesh_for(sizes)
    state = make_train_step(TCFG, mesh, rules=RULES[rules])[0](
        torch.Generator().manual_seed(0))
    shard = sharding.param_shardings(param_logical_axes(TCFG), mesh, RULES[rules])
    leaves = {"embed": (state.params["embed"], shard["embed"])}
    for name in ("wq", "w_down"):
        leaves[name] = (state.params["blocks"][name], shard["blocks"][name])
    return {"local": {n: tuple(sharding.local_tensor(w).shape) for n, (w, _) in leaves.items()},
            "shard_shape": {n: s.shard_shape(w.shape) for n, (w, s) in leaves.items()}}


def adafactor(sizes, rules, params, logical, grads, lr):
    """Adafactor updates on fixed grads, every leaf laid out by `rules`;
    returns the params after each update, whole."""
    mesh = mesh_for(sizes)
    shard = sharding.param_shardings(logical, mesh, RULES[rules])
    names = list(params)
    leaves = [distribute_tensor(torch.from_numpy(params[n]), mesh,
                                shard[n].placements).requires_grad_() for n in names]
    opt = Adafactor(lr)
    state = opt.init(leaves)
    out = []
    for count, g in enumerate(grads):
        for p, n in zip(leaves, names):
            p.grad = distribute_tensor(torch.from_numpy(g[n]), mesh, shard[n].placements)
        opt.update(state, leaves, count)
        out.append({n: p.detach().full_tensor().numpy() for n, p in zip(names, leaves)})
    return out


def collective_ops(sizes, axis, x):
    """This rank's results of each collective over `axis`, on its rows of x
    (the rows a PartitionSpec of all mesh axes, outermost first, gives it)."""
    mesh = mesh_for(sizes)
    n = mesh.size()
    rows = x.shape[0] // n
    local = torch.from_numpy(x[mesh.get_rank() * rows:(mesh.get_rank() + 1) * rows])
    return {
        "psum": collectives.psum(local, axis, mesh=mesh).numpy(),
        "pmean": collectives.pmean(local, axis, mesh=mesh).numpy(),
        "all_gather": collectives.all_gather(local, axis, mesh=mesh).numpy(),
        "psum_scatter": collectives.psum_scatter(local, axis, mesh=mesh).numpy(),
        "all_to_all": collectives.all_to_all(local, axis, mesh=mesh, split_dim=0,
                                             concat_dim=1).numpy(),
        "ppermute_ring": collectives.ppermute_ring(local, axis, mesh=mesh).numpy(),
        "axis_index": collectives.axis_index(axis, mesh=mesh),
    }


def _columns(x: np.ndarray, mesh) -> np.ndarray:
    """This rank's sp share of dim 1 of x."""
    n, i = mesh.size(mesh.mesh_dim_names.index("sp")), mesh.get_local_rank("sp")
    per = x.shape[1] // n
    return x[:, i * per:(i + 1) * per]


def cp_attention(scheme, sizes, causal, q, k, v, do):
    """Ring or Ulysses attention on this rank's sp share of (B, T, H, D)
    q, k, v, and the grads of sum(out * do): this rank's shares of the
    output and of dq, dk, dv; a ValueError's text instead, if it raises."""
    mesh = mesh_for(sizes)
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[scheme]
    q, k, v = (torch.from_numpy(_columns(x, mesh)).requires_grad_() for x in (q, k, v))
    try:
        out = fn(q, k, v, mesh=mesh, causal=causal)
    except ValueError as e:
        return {"error": str(e)}
    (out * torch.from_numpy(_columns(do, mesh))).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


def sp_forward(sizes, scheme, start, tokens):
    """`forward(seq_shards=sp)` on this rank's rows and sp share of the
    global `tokens`; its logits, with the rows and columns they cover."""
    mesh = mesh_for(sizes)
    cfg = dataclasses.replace(TCFG, sp_attention=scheme)
    params = params_from_jax(start, cfg, mesh=mesh)
    rows = local_batch_rows(mesh, tokens.shape[0], ("dp", "fsdp"))
    local = _columns(tokens[rows], mesh)
    logits = forward(params, torch.from_numpy(local), cfg, mesh=mesh,
                     seq_shards=sizes["sp"])
    t = local.shape[1]
    first = mesh.get_local_rank("sp") * t
    return {"logits": logits.detach().numpy(), "rows": (rows.start, rows.stop),
            "cols": (first, first + t)}


def _pipeline_cfg(cfg_kw: dict):
    return dataclasses.replace(configs.TINY, compute_dtype=torch.float32, **cfg_kw)


def pipeline_run(pp, dp, n_micro, cfg_kw, start, batches, grads=False, opt=None):
    """The pipeline over the first pp x dp ranks (the others return None)
    from the JAX-drawn `start` params: with `opt`, one
    `make_pipeline_train_step` step a batch (losses and final params, whole);
    else `make_pipeline_loss` on the first batch (its value and, with
    `grads`, every param's grad, whole)."""
    mesh = pipeline_mesh_for(pp, dp)
    if mesh.get_coordinate() is None:
        return None
    cfg = _pipeline_cfg(cfg_kw)
    params = params_from_jax(start, cfg, mesh=mesh,
                             shardings=pipeline.pipeline_shardings(cfg, mesh))
    if opt is not None:
        init_fn, step_fn = pipeline.make_pipeline_train_step(
            cfg, mesh, n_microbatches=n_micro, optimizer=_optimizer(opt))
        state = init_fn(params=params)
        losses = [float(step_fn(state, b)[1]["loss"]) for b in batches]
        return {"losses": losses, "params": params_to_numpy(state.params),
                "step": state.step}
    for p in tree_leaves(params):
        p.requires_grad_()
    loss = pipeline.make_pipeline_loss(cfg, mesh, n_micro)(params, batches[0])
    out = {"loss": float(loss)}
    if grads:
        loss.backward()
        out["grads"] = params_to_numpy(
            {k: ({n: w.grad for n, w in v.items()} if isinstance(v, dict) else v.grad)
             for k, v in params.items()})
    return out


def pipeline_errors():
    """What the pipeline raises for MoE, and that `dryrun_pipeline` runs
    over all four ranks (dp 2 x pp 2)."""
    out = {}
    try:
        pipeline.make_pipeline_loss(configs.TINY_MOE, pipeline_mesh_for(2, 1), 2)
        out["moe"] = "no error"
    except NotImplementedError as e:
        out["moe"] = f"NotImplementedError: {e}"
    pipeline.dryrun_pipeline(4, device_type="cpu")
    out["dryrun"] = "ran"
    return out


def collective_grads(sizes, axis, x, w):
    """Grads of sum(w_local * op(x_local)) through ppermute_ring and
    all_to_all over `axis`, on this rank's rows of x and of each w."""
    mesh = mesh_for(sizes)

    def part(a):
        rows = a.shape[0] // mesh.size()
        return a[mesh.get_rank() * rows:(mesh.get_rank() + 1) * rows]

    ops = {"ppermute_ring": lambda t: collectives.ppermute_ring(t, axis, mesh=mesh),
           "ppermute_ring_back": lambda t: collectives.ppermute_ring(
               t, axis, mesh=mesh, shift=-1),
           "all_to_all": lambda t: collectives.all_to_all(
               t, axis, mesh=mesh, split_dim=0, concat_dim=1),
           "all_gather": lambda t: collectives.all_gather(t, axis, mesh=mesh)}
    out = {}
    for name, op in ops.items():
        local = torch.from_numpy(part(x)).requires_grad_()
        (op(local) * torch.from_numpy(part(w[name]))).sum().backward()
        out[name] = local.grad.numpy()
    return out


def errors():
    """What make_train_step builds or raises for layouts at the edge of what
    runs: a dense model on an ep mesh and MoE under a data split run; heads
    or experts that tp or ep does not divide raise ValueError, and MoE in
    the pipeline NotImplementedError, as in JAX."""
    out = {}
    cases = {"ep": (TCFG, {"fsdp": 2, "ep": 2}),
             "moe": (configs.TINY_MOE, {"fsdp": 4}),
             "heads": (dataclasses.replace(TCFG, n_heads=3, n_kv_heads=3, d_model=96),
                       {"fsdp": 1, "tp": 4}),
             "experts": (dataclasses.replace(configs.TINY_MOE, n_experts=2),
                         {"fsdp": 1, "ep": 4})}
    for name, (cfg, sizes) in cases.items():
        try:
            make_train_step(cfg, mesh_for(sizes), device="cpu")
            out[name] = "no error"
        except NotImplementedError as e:
            out[name] = "NotImplementedError: " + str(e).split("queue A, ")[-1]
        except ValueError:
            out[name] = "ValueError"
    try:
        pipeline.make_pipeline_loss(configs.TINY_MOE, pipeline_mesh_for(2, 1), 2)
        out["pipeline_moe"] = "no error"
    except NotImplementedError:
        out["pipeline_moe"] = "NotImplementedError"
    return out


def tp_serve(sizes, cfg_name, start, prompts, max_tokens, prefix_cache_size=0,
             speculation_k=0, first=None):
    """`LLMEngine(mesh=...)` from the JAX-drawn `start` params on this
    rank's tp shard: each prompt's greedy tokens, one request at a time,
    and the engine's stats. With `first` (a prompt), then `prefill`'s
    logits of it through the engine's shards and a sharded cache, once the
    engine has stopped (its loop thread issues the mesh's collectives
    while it runs). A ValueError's text instead, if the engine raises."""
    mesh = mesh_for(sizes)
    cfg = CFGS[cfg_name]
    try:
        # The bridge lays the params out by TP_RULES: each rank keeps its shard.
        params = params_from_jax(start, cfg, mesh=mesh, rules=sharding.TP_RULES)
        eng = LLMEngine(cfg, params, mesh=mesh,
                        num_slots=2, max_len=64, prefill_buckets=(16,),
                        prefix_cache_size=prefix_cache_size, speculation_k=speculation_k)
    except ValueError as e:
        return {"error": str(e)}
    try:
        out = {"tokens": [eng.generate(p, max_tokens=max_tokens, timeout=60)
                          for p in prompts]}
    finally:
        eng.shutdown()
    out["stats"] = {k: eng.stats[k] for k in ("prefix_hits", "spec_proposed")}
    out["wq"] = tuple(eng.params["blocks"]["wq"].shape)
    if first is not None:
        cache = decoding.init_cache(cfg, 1, 64, shardings=decoding.cache_shardings(mesh))
        toks = torch.zeros((1, 16), dtype=torch.int32)
        toks[0, :len(first)] = torch.tensor(first)
        with torch.no_grad():
            _, logits = decoding.prefill(eng.params, cache, toks, 0, len(first), cfg, mesh)
        out["first_logits"] = logits.numpy()
        out["cache_k"] = tuple(cache.k.shape)
    return out


def tp_dryrun(tp):
    """`dryrun_tp_serving` of TINY over the first `tp` ranks."""
    dryrun_tp_serving(configs.TINY, tp, device_type="cpu", timeout=60)
    return "ran"


CASES = {"train": train, "errors": errors, "shapes": shapes, "adafactor": adafactor,
         "collectives": collective_ops, "cp_attention": cp_attention,
         "sp_forward": sp_forward, "pipeline": pipeline_run,
         "pipeline_errors": pipeline_errors, "collective_grads": collective_grads,
         "tp_serve": tp_serve, "tp_dryrun": tp_dryrun}


def main(rank: int, world: int, port: int, inbox, outbox) -> None:
    torch.set_num_threads(1)
    backend = TorchBackend("cpu")
    backend.on_start(rank, world, {"MASTER_ADDR": "127.0.0.1",
                                   "MASTER_PORT": str(port)})
    try:
        while (msg := inbox.get()) is not None:
            name, kwargs = msg
            try:
                outbox.put((rank, True, CASES[name](**kwargs)))
            except Exception:  # noqa: BLE001 — reported to the parent
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        backend.on_shutdown()

