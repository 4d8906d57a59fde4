"""Per-timestep loss-weight schemes.

Counterpart of qflux_tpu/scheduler/weighting.py: the bell-shaped
mean-normalized weights in closed form, the half-bell variant, and the
reference's 1000-entry empirical table or a user's (`load_weighting_table`),
looked up by σ.  The table is the
port's own byte-for-byte copy of the JAX package's
`qflux_tpu/scheduler/default_weighting_table.npy`, beside this module.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np
import torch

NUM_TIMESTEPS = 1000
DEFAULT_TABLE = Path(__file__).resolve().parent / "default_weighting_table.npy"


@functools.lru_cache(maxsize=None)
def default_weighting_table() -> np.ndarray:
    """Index 0 ↔ timestep 1000 (σ=1), index 999 ↔ timestep 1."""
    return np.load(DEFAULT_TABLE).astype(np.float32)


def load_weighting_table(path) -> np.ndarray:
    """A user-supplied table: .npy, or .json/.txt with one float per entry."""
    if str(path).endswith(".npy"):
        return np.load(path).astype(np.float32)
    return np.asarray(json.loads(Path(path).read_text()), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def bell_weights(num_timesteps: int = NUM_TIMESTEPS) -> np.ndarray:
    """Bell-shaped mean-normalized timestep weights ("bsmntw")."""
    x = np.arange(num_timesteps, dtype=np.float32)
    y = np.exp(-2 * ((x - num_timesteps / 2) / num_timesteps) ** 2)
    y = y - y.min()
    return y * (num_timesteps / y.sum())


@functools.lru_cache(maxsize=None)
def half_bell_weights(num_timesteps: int = NUM_TIMESTEPS) -> np.ndarray:
    """Half-bell variant: second half flattened to the max."""
    w = bell_weights(num_timesteps).copy()
    w[num_timesteps // 2:] = w[num_timesteps // 2:].max()
    return w


def weights_for_sigmas(sigmas, scheme: str = "bell", table=None):
    """Loss weight per sample given σ ∈ (0, 1] ([B] tensor → [B] f32).

    scheme: "none" | "bell" | "half_bell" | "table" (requires `table`).  The
    index is n - round(σ·n), with σ·n taken in σ's dtype as in JAX."""
    if scheme == "none":
        return torch.ones_like(sigmas)
    if scheme == "bell":
        tab = bell_weights()
    elif scheme == "half_bell":
        tab = half_bell_weights()
    elif scheme == "table":
        if table is None:
            raise ValueError("scheme='table' requires a weight table")
        tab = np.asarray(table, dtype=np.float32)
    else:
        raise ValueError(f"unknown weighting scheme {scheme!r}")
    n = len(tab)
    idx = torch.clamp(n - torch.round(sigmas * n).to(torch.int32), 0, n - 1)
    return torch.from_numpy(tab).to(sigmas.device)[idx.long()]
