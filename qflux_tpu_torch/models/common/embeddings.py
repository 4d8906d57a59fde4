"""Timestep / projection embeddings, as qflux_tpu/models/common/embeddings.py
(diffusers Timesteps + TimestepEmbedding: sinusoidal-256 → Linear → SiLU →
Linear, flip_sin_to_cos=True, downscale_freq_shift=0)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from qflux_tpu_torch.ops.layers import MLP, dense


def sinusoidal_embedding(t, dim: int = 256, max_period: float = 10000.0,
                         time_factor: float = 1000.0):
    """t [B] (0..1 model time) → [B, dim] float32, cos first."""
    t = t.float() * time_factor
    half = dim // 2
    freqs = torch.exp(-np.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def mlp_silu(p: MLP, x):
    """Linear → SiLU → Linear (diffusers TimestepEmbedding / text projection)."""
    return dense(p.lin_out, F.silu(dense(p.lin_in, x)))
