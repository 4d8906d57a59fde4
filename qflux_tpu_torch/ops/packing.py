"""Latent 2×2 patch packing/unpacking, NHWC as in qflux_tpu/ops/packing.py."""

from __future__ import annotations


def pack_latents(latents):
    """[B, H, W, C] → [B, (H/2)*(W/2), C*4], (c, dy, dx)-major per token."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # [B, H/2, W/2, C, 2, 2]
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(packed, height: int, width: int):
    """[B, (H/2)*(W/2), C*4] → [B, H, W, C] (latent-space H, W)."""
    b, _, c4 = packed.shape
    c = c4 // 4
    x = packed.reshape(b, height // 2, width // 2, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)  # [B, H/2, 2, W/2, 2, C]
    return x.reshape(b, height, width, c)
