"""ray_tpu_torch.rllib.offline against ray_tpu.rllib.offline, on the CPU.

BC and MARWIL updates from JAX's weights on the same rows agree within
1e-5 at fp32 (loss, params, Adam moments), over three updates;
`discounted_returns` is exact. `SampleWriter` writes the shards JAX's
writes (the same columns, dtypes and rows, read back with pyarrow and
json), and `record_rollouts` records a port PPO's rollouts. `read_samples`
reads JAX's rows back from JSON and parquet shards through the port's data
layer, and BC and MARWIL train on them: their first update matches JAX's
at 1e-5. Each runtime runs in local mode and is shut down before the next
starts.
"""
import json
import os

import jax
import numpy as np
import pyarrow.parquet as pq
import pytest

from ray_tpu.rllib import offline as joff
from ray_tpu_torch.rllib import offline, ppo
from test_torch_rllib import _close, _close_opt, _np

OBS_DIM, ACTIONS, HIDDEN = 4, 3, (32, 32)


def _rows(seed, n=64):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, OBS_DIM)).astype(np.float32),
            "actions": rng.integers(0, ACTIONS, n),
            "returns": (rng.normal(size=n) * 5).astype(np.float32)}


def test_bc_updates_match_jax():
    jl = joff.BCLearner(OBS_DIM, ACTIONS, 1e-3, seed=0, hidden=HIDDEN)
    tl = offline.BCLearner(OBS_DIM, ACTIONS, 1e-3, seed=0, hidden=HIDDEN, device="cpu")
    tl.set_weights(jl.get_weights())
    for step in range(3):
        rows = _rows(step)
        want = jl.update(rows["obs"], rows["actions"])
        got = tl.update(rows["obs"], rows["actions"])
        _close(got, want, f"step {step} loss")
        _close(tl.get_weights(), _np(jl.params), f"step {step} params")
        _close_opt(tl.opt_state, jl.opt_state, f"step {step} adam")


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_marwil_updates_match_jax(beta):
    kw = dict(beta=beta, vf_coeff=0.5, seed=0, hidden=HIDDEN)
    jl = joff.MARWILLearner(OBS_DIM, ACTIONS, 1e-3, **kw)
    tl = offline.MARWILLearner(OBS_DIM, ACTIONS, 1e-3, device="cpu", **kw)
    tl.set_weights(jl.get_weights())
    for step in range(3):
        rows = _rows(10 + step)
        want = jl.update(rows["obs"], rows["actions"], rows["returns"])
        got = tl.update(rows["obs"], rows["actions"], rows["returns"])
        assert set(got) == set(want)
        _close(got, want, f"beta {beta} step {step} metrics")
        _close(tl.get_weights(), _np(jl.params), f"beta {beta} step {step} params")
        _close_opt(tl.opt_state, jl.opt_state, f"beta {beta} step {step} adam")


def test_discounted_returns_equal_jax():
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=300).astype(np.float32)
    dones = rng.random(300) < 0.05
    got = offline.discounted_returns(rewards, dones, 0.97)
    np.testing.assert_array_equal(got, joff.discounted_returns(rewards, dones, 0.97))
    assert got.dtype == np.float32


def _read(path, fmt):
    """Each shard under `path` as columns, read with pyarrow or json,
    ordered by row count (shard names are random)."""
    shards = []
    for name in os.listdir(path):
        if fmt == "parquet":
            table = pq.read_table(os.path.join(path, name))
            shards.append({c: table.column(c).to_pylist() for c in table.column_names}
                          | {"_types": [str(t) for t in table.schema.types]})
        else:
            with open(os.path.join(path, name)) as f:
                rows = [json.loads(line) for line in f]
            shards.append({k: [r[k] for r in rows] for k in rows[0]})
    return sorted(shards, key=lambda s: len(s["rewards"]))


@pytest.mark.parametrize("fmt", ["parquet", "json"])
def test_sample_writer_writes_jax_shards(fmt, tmp_path):
    rng = np.random.default_rng(1)
    batches = [{"obs": rng.normal(size=(6, OBS_DIM)).astype(np.float32),
                "actions": rng.integers(0, 2, 6).astype(np.int32),
                "rewards": rng.normal(size=6).astype(np.float32),
                "dones": rng.random(6) < 0.3} for _ in range(3)]
    out = {}
    for name, cls in (("jax", joff.SampleWriter), ("port", offline.SampleWriter)):
        writer = cls(str(tmp_path / name), fmt=fmt, rows_per_shard=10)
        for b in batches:
            writer.write(b)
        writer.close()
        out[name] = _read(str(tmp_path / name), fmt)
    assert [len(s["rewards"]) for s in out["port"]] == [6, 12]
    assert out["port"] == out["jax"]
    if fmt == "json":
        rows = [json.loads(line) for shard in sorted(os.listdir(tmp_path / "port"))
                for line in open(tmp_path / "port" / shard)]
        for k, v in offline._columnar(rows).items():
            want = joff._columnar(rows)[k]
            np.testing.assert_array_equal(v, want)
            assert v.dtype == want.dtype
    with pytest.raises(ValueError, match="format"):
        offline.SampleWriter(str(tmp_path / "x"), fmt="csv")


@pytest.mark.parametrize("fmt", ["parquet", "json"])
def test_record_rollouts_writes_a_port_ppo_rollouts(fmt, tmp_path):
    algo = (ppo.PPOConfig().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=16)
            .resources(device="cpu").debugging(seed=0).build())
    path = offline.record_rollouts(algo, str(tmp_path), num_iterations=2, fmt=fmt)
    rows = [row for shard in _read(path, fmt)
            for row in zip(*(shard[k] for k in ("obs", "actions", "rewards", "dones")))]
    assert len(rows) == 2 * 4 * 16
    obs = np.asarray([r[0] for r in rows], np.float32)
    assert obs.shape == (128, OBS_DIM) and np.isfinite(obs).all()
    assert {r[1] for r in rows} <= {0, 1} and {r[2] for r in rows} == {1.0}
    algo.stop()


def _shards(path, fmt):
    """Two shards of CartPole-shaped rows, written by JAX's SampleWriter."""
    rng = np.random.default_rng(3)
    writer = joff.SampleWriter(str(path), fmt=fmt, rows_per_shard=40)
    for _ in range(2):
        writer.write({"obs": rng.normal(size=(40, OBS_DIM)).astype(np.float32),
                      "actions": rng.integers(0, 2, 40).astype(np.int32),
                      "rewards": rng.normal(size=40).astype(np.float32),
                      "dones": rng.random(40) < 0.1})
    writer.close()
    return str(path)


def _offline_run(rt, algo_mod, kind, path):
    """read_samples' rows, and one offline training iteration of `kind`
    (BC or MARWIL) from the JAX learner's initial weights, on `rt` in local
    mode (shut down before returning)."""
    rt.init(local_mode=True)
    try:
        rows = algo_mod.read_samples(path).take_all()
        config = getattr(algo_mod, f"{kind}Config")().environment("CartPole-v1").offline_data(
            input_path=path).training(num_updates_per_iteration=1, train_batch_size=32)
        if algo_mod is offline:
            config = config.resources(device="cpu")
        algo = config.rl_module(model_hidden=HIDDEN).debugging(seed=0).build()
        return rows, algo
    finally:
        rt.shutdown()


@pytest.mark.parametrize("fmt", ["json", "parquet"])
@pytest.mark.parametrize("kind", ["BC", "MARWIL"])
def test_offline_algorithms_train_on_jax_shards(kind, fmt, tmp_path):
    """read_samples reads JAX's rows from the same shards; BC and MARWIL
    read them through it and their first update (from JAX's initial
    weights) matches JAX's: loss and params within 1e-5."""
    import ray_tpu
    import ray_tpu_torch

    path = _shards(tmp_path / fmt, fmt)
    jrows, jalgo = _offline_run(ray_tpu, joff, kind, path)
    trows, talgo = _offline_run(ray_tpu_torch, offline, kind, path)
    assert len(trows) == len(jrows) == 80
    for t, j in zip(trows, jrows):
        assert list(t) == list(j)
        for k in j:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k].tolist()
                                          if isinstance(j[k], np.ndarray) else j[k]))
    talgo.learner.set_weights(jalgo.learner.get_weights())
    want, got = jalgo.train(), talgo.train()
    loss = "bc_loss" if kind == "BC" else "marwil_loss"
    _close(got[loss], want[loss], f"{kind} {fmt} loss")
    assert got["num_offline_rows"] == want["num_offline_rows"] == 80
    _close(talgo.learner.get_weights(), _np(jalgo.learner.params), f"{kind} {fmt} params")


def test_what_reads_offline_shards_raises(tmp_path):
    """What reading offline shards refuses, as JAX does: a directory with
    no shards, and an offline algorithm built without an input path."""
    import ray_tpu_torch

    with pytest.raises(FileNotFoundError, match="no files matched"):
        offline.read_samples(str(tmp_path))
    for config in (offline.BCConfig(), offline.MARWILConfig()):
        with pytest.raises(ValueError, match="input_path"):
            config.environment("CartPole-v1").resources(device="cpu").build()
    assert not ray_tpu_torch.is_initialized()
    config = offline.MARWILConfig().training(beta=0.5, gamma=0.9, lr=3e-4)
    assert (config.beta, config.gamma, config.lr) == (0.5, 0.9, 3e-4)
    assert config.algo_class is offline.MARWIL


def test_offline_learners_run_on_the_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        offline.BCLearner(OBS_DIM, ACTIONS, 1e-3)
    with pytest.raises(RuntimeError, match="CUDA"):
        offline.MARWILLearner(OBS_DIM, ACTIONS, 1e-3, beta=1.0, vf_coeff=1.0)
