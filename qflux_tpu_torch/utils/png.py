"""PNG on zlib, with no PIL or cv2 (the card's machine has neither): an
encoder (uint8 images → PNG bytes, for the TensorBoard writer's image
summaries and `--predict`'s output) and a decoder (`decode_png`: 8-bit
gray / gray + alpha / RGB / RGBA, non-interlaced, all five filter types),
which the dataset reads images with."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels → gray, gray+alpha, RGB, RGBA
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}
SIGNATURE = b"\x89PNG\r\n\x1a\n"


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
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    of [h, 1 + w·bpp] bytes → [h, w, bpp] uint8.  Where no row uses Average
    or Paeth, row by row (Sub is a running sum along the row).  Otherwise
    along anti-diagonals: pixel (y, x) needs only (y, x-1), (y-1, x) and
    (y-1, x-1), so one step decodes a pixel of every row at once, whatever
    each row's filter (h + w - 1 steps)."""
    h = raw.shape[0]
    kinds = raw[:, 0].astype(np.int64)
    data = raw[:, 1:].astype(np.int32).reshape(h, -1, bpp)
    w = data.shape[1]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown filter type {int(kinds.max())}")
    if not np.isin(kinds, (3, 4)).any():
        out = np.zeros_like(data)
        prev = np.zeros((w, bpp), np.int32)
        for y in range(h):
            row = data[y]
            if kinds[y] == 1:
                row = np.cumsum(row, axis=0)
            elif kinds[y] == 2:
                row = row + prev
            out[y] = prev = row & 0xFF
        return out.astype(np.uint8)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row above, a zero column left
    for t in range(h + w - 1):
        y = np.arange(max(0, t - w + 1), min(h, t + 1))
        x = t - y
        left, up, ul = out[y + 1, x], out[y, x + 1], out[y, x]
        k = kinds[y][:, None]
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [left, up, (left + up) >> 1, paeth], 0)
        out[y + 1, x + 1] = (data[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 [H, W] (gray) or [H, W, C] (C = 2 gray + alpha, 3
    RGB, 4 RGBA).  Raises ValueError on anything else: another bit depth,
    a palette, interlacing, a bad chunk CRC, truncated data."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if pos + 12 + length > len(data):
            raise ValueError(f"PNG: chunk {kind!r} runs past the end of the data")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"PNG: bit depth {depth}, color type {color}, interlace {interlace}; "
                         "8-bit gray / gray+alpha / RGB / RGBA, non-interlaced, decode")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"PNG: {raw.size} bytes of image data for {w}x{h}x{c}")
    img = _unfilter(raw.reshape(h, 1 + w * c), c)
    return img[:, :, 0] if c == 1 else img


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
