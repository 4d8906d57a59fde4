"""Multi-axis rotary position embeddings (FLUX 3-axis ids), rotate-half layout.

Counterpart of qflux_tpu/ops/rope.py (`rope_from_coords`, `flux_image_ids`,
`flux_text_ids`).  The inverse frequencies are computed in float64 on the
host and cast to float32, as in the JAX code; the q/k projection channels
are already permuted to the rotate-half layout by the JAX weight converter.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_from_coords(coords, axes_dim: tuple[int, ...], theta: float = 10000.0):
    """coords [..., n_axes] → (cos, sin) each [..., sum(axes_dim)] float32,
    rotate-half layout: pairs are (j, j + D/2)."""
    cos_parts, sin_parts = [], []
    for i, d in enumerate(axes_dim):
        pos = coords[..., i].float()
        inv = (1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))).astype(np.float32)
        freqs = pos[..., None] * torch.from_numpy(inv).to(pos.device)
        cos_parts.append(torch.cos(freqs))
        sin_parts.append(torch.sin(freqs))
    cos = torch.cat(cos_parts, dim=-1)
    sin = torch.cat(sin_parts, dim=-1)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def flux_image_ids(height: int, width: int, set_id: int = 0,
                   h_offset: int = 0, w_offset: int = 0) -> np.ndarray:
    """[(h*w), 3] ids (set, row, col) for one packed-latent image plane;
    set_id > 0 marks control images."""
    ids = np.zeros((height, width, 3), dtype=np.float32)
    ids[..., 0] = set_id
    ids[..., 1] = np.arange(height)[:, None] + h_offset
    ids[..., 2] = np.arange(width)[None, :] + w_offset
    return ids.reshape(height * width, 3)


def flux_text_ids(seq_len: int) -> np.ndarray:
    return np.zeros((seq_len, 3), dtype=np.float32)
