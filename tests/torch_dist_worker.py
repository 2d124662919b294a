"""The ranks of tests/test_torch_distributed.py: each is a spawned process
that joins a gloo group through `TorchBackend`, then runs the cases its
parent sends, all ranks in the same order, and sends back numpy results.

This module imports torch and the port only, never JAX: it is what each
spawned process imports.
"""
from __future__ import annotations

import dataclasses
import traceback

import torch
from torch.distributed.tensor import distribute_tensor

from ray_tpu_torch.data import torch_feed
from ray_tpu_torch.models import configs
from ray_tpu_torch.models.jax_bridge import params_from_jax, params_to_numpy
from ray_tpu_torch.models.transformer import param_logical_axes
from ray_tpu_torch.models.training import (
    Adafactor, default_optimizer, make_train_step)
from ray_tpu_torch.parallel import collectives, sharding
from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from ray_tpu_torch.train import TorchBackend

TCFG = dataclasses.replace(configs.TINY, compute_dtype=torch.float32)
RULES = {"default": sharding.DEFAULT_RULES, "ddp": sharding.DDP_RULES,
         "tp": sharding.TP_RULES}
_meshes: dict = {}


def mesh_for(sizes: dict):
    """One DeviceMesh per layout, built by every rank in the same order."""
    key = tuple(sorted(sizes.items()))
    if key not in _meshes:
        _meshes[key] = build_mesh(MeshConfig(**sizes), device_type="cpu")
    return _meshes[key]


def _optimizer(opt: dict):
    if opt["kind"] == "adafactor":
        return Adafactor(opt["lr"])
    return default_optimizer(opt["lr"], warmup=opt["warmup"],
                             total_steps=opt["total_steps"])


def train(sizes, rules, start, batches, opt, feed=False):
    """`len(batches)` steps from the JAX-drawn `start` params on global
    batches; with `feed`, the batches come through `torch_feed` as
    DTensors. Returns the metrics, the final params (whole), each leaf's
    local shape, and the rows fed to this rank."""
    mesh = mesh_for(sizes)
    init_fn, step_fn = make_train_step(TCFG, mesh, rules=RULES[rules],
                                       optimizer=_optimizer(opt))
    state = init_fn(params=params_from_jax(start, TCFG, mesh=mesh, rules=RULES[rules]))
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
            "fed_rows": fed_rows}


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


def errors():
    """What make_train_step raises for layouts the port does not run yet."""
    out = {}
    cases = {"sp": (TCFG, {"fsdp": 2, "sp": 2}), "ep": (TCFG, {"fsdp": 2, "ep": 2}),
             "moe": (configs.TINY_MOE, {"fsdp": 4}),
             "heads": (dataclasses.replace(TCFG, n_heads=3, n_kv_heads=3, d_model=96),
                       {"fsdp": 1, "tp": 4})}
    for name, (cfg, sizes) in cases.items():
        try:
            make_train_step(cfg, mesh_for(sizes))
            out[name] = "no error"
        except NotImplementedError as e:
            out[name] = "NotImplementedError: " + str(e).split("queue A, ")[-1]
        except ValueError:
            out[name] = "ValueError"
    return out


CASES = {"train": train, "errors": errors, "shapes": shapes, "adafactor": adafactor,
         "collectives": collective_ops}


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

