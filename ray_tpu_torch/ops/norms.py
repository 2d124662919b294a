"""Normalization ops (counterpart of `ray_tpu/ops/norms.py`).

RMSNorm is bandwidth-bound elementwise work with no TPU kernel behind it,
so it stays plain tensor math. Statistics are fp32 whatever the input dtype.
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6):
    """x * rsqrt(mean(x^2)) * weight, stats in fp32, output in x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)
