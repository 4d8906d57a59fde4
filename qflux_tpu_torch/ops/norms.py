"""Normalization + AdaLN modulation primitives.

Counterpart of qflux_tpu/ops/norms.py: RMSNorm, LayerNorm without affine,
modulation, and the AdaLN projections.  Statistics run in float32 whatever
the input dtype, with the casts where the JAX code puts them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qflux_tpu_torch.ops.layers import dense


def rms_norm(x, scale=None, eps: float = 1e-6):
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(x.dtype)


def layer_norm(x, eps: float = 1e-6):
    """LayerNorm without learnable affine (elementwise_affine=False)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def modulate(x, shift, scale):
    """x * (1 + scale) + shift, broadcasting [B, D] mods over [B, S, D]."""
    return x * (1.0 + scale[:, None, :].to(x.dtype)) + shift[:, None, :].to(x.dtype)


def ada_ln_mods(proj, temb, n_mods: int) -> list:
    """SiLU(temb) → Linear (the `proj` Dense) → n_mods chunks of [B, D]
    (float32: the projection runs on the f32 activation, as in JAX)."""
    m = dense(proj, F.silu(temb.float()))
    return list(torch.chunk(m, n_mods, dim=-1))
