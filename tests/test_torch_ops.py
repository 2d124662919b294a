"""ray_tpu_torch rms_norm and rotary embeddings against the JAX package.

fp32 runs the same arithmetic in both frameworks, so it is held tight.
bf16 compares outputs that both frameworks round to bf16 from fp32 values
differing only in their last bits: one rounding may flip, so the bound is
one bf16 step (2**-7 relative) of the output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.norms import rms_norm as jax_rms_norm
from ray_tpu.ops.rotary import apply_rope as jax_rope
from ray_tpu.ops.rotary import rope_frequencies as jax_freqs
from ray_tpu_torch.ops import apply_rope, rms_norm, rope_frequencies

DTYPES = {"fp32": (jnp.float32, torch.float32, dict(atol=1e-5, rtol=1e-6)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=1e-2, rtol=2 ** -7))}


def _as_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rms_norm_parity(dtype, eps):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    want = jax_rms_norm(jnp.asarray(x, jdt), jnp.asarray(w), eps=eps)
    got = rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w), eps=eps)
    assert got.dtype == tdt
    np.testing.assert_allclose(_as_np(got), _as_np(want), **tol)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_frequencies_parity(theta):
    np.testing.assert_allclose(rope_frequencies(64, theta=theta, device="cpu").numpy(),
                               np.asarray(jax_freqs(64, theta=theta)),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("positions", ["1d", "2d-offset"])
def test_apply_rope_parity(dtype, positions):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)
    if positions == "2d-offset":  # sequence shards feed global offsets
        pos = np.stack([pos, pos + 1000])
    want = jax_rope(jnp.asarray(x, jdt), jnp.asarray(pos), theta=10000.0)
    got = apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                     theta=10000.0)
    assert got.dtype == tdt
    np.testing.assert_allclose(_as_np(got), _as_np(want), **tol)


def test_rope_is_half_rotation():
    """Pair (i, i + D/2) rotates together, not (2i, 2i + 1)."""
    x = torch.zeros(1, 2, 1, 8)
    x[..., 0] = 1.0
    out = apply_rope(x, torch.tensor([0, 1]))
    inv0 = rope_frequencies(8, device="cpu")[0]
    assert out[0, 1, 0, 4] == pytest.approx(float(torch.sin(inv0)))
    assert out[0, 1, 0, 1] == 0.0
