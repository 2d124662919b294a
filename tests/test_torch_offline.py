"""ray_tpu_torch.rllib.offline against ray_tpu.rllib.offline, on the CPU.

BC and MARWIL updates from JAX's weights on the same rows agree within
1e-5 at fp32 (loss, params, Adam moments), over three updates;
`discounted_returns` is exact. `SampleWriter` writes the shards JAX's
writes (the same columns, dtypes and rows, read back with pyarrow and
json, never through a data executor), and `record_rollouts` records a port
PPO's rollouts. What reads shards back (`read_samples`, BC and MARWIL
training) needs the port's runtime and raises.
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


def test_what_reads_offline_shards_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="item 10b"):
        offline.read_samples(str(tmp_path))
    for config in (offline.BCConfig(), offline.MARWILConfig()):
        with pytest.raises(NotImplementedError, match="item 10b"):
            config.environment("CartPole-v1").offline_data(
                input_path=str(tmp_path)).resources(device="cpu").build()
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
