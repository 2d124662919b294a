"""Rotary position embeddings, half-rotation layout (counterpart of
`ray_tpu/ops/rotary.py`).

The head dim is split in halves, not interleaved. Angles are fp32 and the
result is cast back to the input dtype.
"""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, *, theta: float = 10000.0,
                     device: torch.device | str = "cuda"):
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0):
    """x: (B, T, H, D); positions: (B, T) or (T,) integer global positions."""
    inv_freq = rope_frequencies(x.shape[-1], theta=theta, device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * inv_freq          # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
