"""TINY's train step tuned by ASHA in ray_tpu_torch's Tuner against
ray_tpu's, on each package's multi-process `init()` cluster (trial actors
in worker processes), on the CPU: the slice as a whole of
tests/test_torch_tune_cluster.py, whose cluster fixture (one cluster per
runtime for this file, never both at once) and helpers this file uses.

TINY's train step in each package's Tuner (JAX's step in JAX's trial
processes, the port's in the port's), the weights carried from JAX by
`models/jax_bridge.py`, the same lr grid and batches, ASHA over the loss,
one trial at a time: every reported fp32 loss within 1e-5 of JAX's and
the same ASHA decisions, with the lrs spread so that the rung comparison
is decided by more than 100 times that tolerance; the port's recorded
results, replayed into a fresh scheduler, give its Tuner's stops.

Classes and trainables sent to workers are nested in the test's helpers
(cloudpickle sends them by value; the test module does not import in a
worker).
"""
import dataclasses

import numpy as np

import ray_tpu
import ray_tpu_torch  # noqa: F401
from tests.test_torch_tune_cluster import _mod, cluster  # noqa: F401

RECORD = {}
LOSS_TOL = 1e-5

TINY_LRS = [1e-1, 3e-2, 1e-2, 1e-3]
TINY_STEPS = 4
TINY_RUNG = 3  # steps 1-2 see the same params: the warmup starts at lr 0
TINY_BATCH, TINY_SEQ = 2, 32


def _tiny_inputs():
    """TINY's JAX params as host arrays, and the batches."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import configs
    from ray_tpu.models.training import make_train_step
    from ray_tpu.parallel import MeshConfig, build_mesh

    cfg = dataclasses.replace(configs.TINY, compute_dtype=jnp.float32)
    mesh = build_mesh(MeshConfig(fsdp=-1), devices=jax.devices()[:1])
    params = make_train_step(cfg, mesh)[0](jax.random.key(0)).params
    corpus = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TINY_STEPS, TINY_BATCH, TINY_SEQ + 1), dtype=np.int32)
    return jax.tree.map(np.asarray, params), corpus


def _tiny_trainable(rt, params, corpus, steps):
    """The trainable for `rt`'s Tuner: its package's TINY step at
    config["lr"] (AdamW with 10 warmup steps over 1,000) on JAX's weights."""
    if rt is ray_tpu:
        def trainable(config):
            import dataclasses

            import jax
            import jax.numpy as jnp

            from ray_tpu import tune
            from ray_tpu.models import configs
            from ray_tpu.models.training import default_optimizer, make_train_step
            from ray_tpu.parallel import MeshConfig, build_mesh

            cfg = dataclasses.replace(configs.TINY, compute_dtype=jnp.float32)
            mesh = build_mesh(MeshConfig(fsdp=-1), devices=jax.devices()[:1])
            init_fn, step = make_train_step(
                cfg, mesh, optimizer=default_optimizer(config["lr"], warmup=10,
                                                       total_steps=1000))
            state = init_fn(jax.random.key(0))
            state = dataclasses.replace(state, params=jax.tree.map(
                lambda p, w: jnp.asarray(w, p.dtype), state.params, params))
            for i in range(steps):
                state, m = step(state, {"tokens": jnp.asarray(corpus[i])})
                tune.report({"loss": float(m["loss"])})
    else:
        def trainable(config):
            import dataclasses

            import torch

            from ray_tpu_torch import tune
            from ray_tpu_torch.models import configs
            from ray_tpu_torch.models.jax_bridge import params_from_jax
            from ray_tpu_torch.models.training import default_optimizer, make_train_step

            cfg = dataclasses.replace(configs.TINY, compute_dtype=torch.float32)
            init_fn, step = make_train_step(
                cfg, device="cpu",
                optimizer=default_optimizer(config["lr"], warmup=10, total_steps=1000))
            state = init_fn(params=params_from_jax(params, cfg, device="cpu"))
            for i in range(steps):
                state, m = step(state, {"tokens": torch.from_numpy(corpus[i])})
                tune.report({"loss": float(m["loss"])})
    return trainable


class _Recorder:
    """A tune.Callback (duck-typed for both packages) that keeps the
    results in the order the Tuner saw them."""

    def __init__(self):
        self.seen = []

    def on_trial_result(self, trial_id, config, result):
        self.seen.append((trial_id, result["training_iteration"], result["loss"]))

    def on_trial_complete(self, *a):
        pass

    def on_experiment_end(self, results):
        pass


def test_tiny_model_tuned_by_asha_matches_jax(cluster, tmp_path):
    rt = cluster
    tune = _mod(rt, "tune")
    params, corpus = _tiny_inputs()

    def scheduler():
        return tune.ASHAScheduler(metric="loss", mode="min", grace_period=TINY_RUNG,
                                  reduction_factor=2, max_t=TINY_STEPS)

    rec = _Recorder()
    grid = tune.Tuner(
        _tiny_trainable(rt, params, corpus, TINY_STEPS),
        param_space={"lr": tune.grid_search(TINY_LRS)},
        tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=1,
                                    scheduler=scheduler()),
        run_config=_mod(rt, "train").RunConfig(name="tiny", storage_path=str(tmp_path),
                                               callbacks=[rec])).fit()
    assert not grid.errors, grid.errors
    trials = [(t.config["lr"], t.state, [m["loss"] for m in t.history])
              for t in grid._trials]
    # Replayed into a fresh scheduler, the results give the Tuner's stops.
    replay = scheduler()
    decisions = [replay.on_result(tid, {"training_iteration": it, "loss": v})
                 for tid, it, v in rec.seen]
    stopped = {tid for (tid, _, _), d in zip(rec.seen, decisions) if d == "STOP"}
    assert stopped
    assert [state for _, state, _ in trials] == [
        "STOPPED" if f"trial_{i:04d}" in stopped else "TERMINATED"
        for i in range(len(TINY_LRS))]
    if rt is ray_tpu:
        RECORD["tiny"] = (trials, rec.seen)
        # The rung is decided by losses far apart next to the tolerance.
        rung = sorted(losses[TINY_RUNG - 1] for _, _, losses in trials)
        assert min(b - a for a, b in zip(rung, rung[1:])) > 100 * LOSS_TOL, rung
        return
    want_trials, want_seen = RECORD["tiny"]
    assert [t[:2] for t in trials] == [t[:2] for t in want_trials]
    assert [s[:2] for s in rec.seen] == [s[:2] for s in want_seen]
    for (_, _, want), (_, _, got) in zip(want_trials, trials):
        assert len(got) == len(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
