"""A PNG encoder on zlib: uint8 images → PNG bytes, for the TensorBoard
writer's image summaries (no PIL on the card's machine)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels → gray, gray+alpha, RGB, RGBA


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """[H, W] or [H, W, C] (C = 1–4) uint8 → an 8-bit PNG, no filtering."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"encode_png takes 1-4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))
