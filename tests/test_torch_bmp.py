"""The port's BMP reader (qflux_tpu_torch/utils/bmp.py) against cv2.imread
on files built byte by byte here, and written by cv2 and PIL: every array
equal to the bit under IMREAD_UNCHANGED (as `_read_image` turns it: BGR →
RGB, alpha dropped) and IMREAD_GRAYSCALE, and every file cv2 refuses
refused (ValueError).  Headers OS/2 core, BITMAPINFOHEADER, V4 and V5;
1 / 4 / 8-bit palettes (gray and colour), RLE4 and RLE8 (runs, absolute
runs, end of line, delta, end of bitmap), 16-bit 555 and 565, 24-bit,
32-bit with and without masks; bottom-up and top-down rows."""

from __future__ import annotations

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from qflux_tpu_torch.utils import bmp

SIZES = [(1, 1), (7, 5), (16, 3), (13, 9)]


def build(width, height, bpp, pixels: bytes, palette=None, header=40, compression=0,
          masks=None, clrused=None, os2=False) -> bytes:
    """A BMP file: `palette` entries are (b, g, r); `pixels` the rows as
    stored.  A 40-byte header's masks follow it; a longer one holds them."""
    if os2:
        head = struct.pack("<IHHHH", 12, width, height, 1, bpp)
        pal = b"".join(bytes(p[:3]) for p in (palette or []))
    else:
        n = len(palette) if palette is not None else 0
        head = struct.pack("<IiiHHIIiiII", header, width, height, 1, bpp, compression,
                           len(pixels), 2835, 2835, n if clrused is None else clrused, 0)
        if header > 40:
            head += struct.pack("<IIII", *(masks or (0, 0, 0, 0))) + b"\0" * (header - 56)
        pal = b"".join(bytes(p[:3]) + b"\0" for p in (palette or []))
        if masks is not None and header == 40:
            pal = struct.pack("<III", *masks[:3]) + pal
    offset = 14 + len(head) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + head + pal + pixels


def pad(row: bytes) -> bytes:
    return row + b"\0" * (-len(row) % 4)


def cv2_read(data: bytes, grayscale: bool):
    a = cv2.imdecode(np.frombuffer(data, np.uint8),
                     cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_UNCHANGED)
    return a[:, :, :3][:, :, ::-1] if a is not None and a.ndim == 3 else a


def assert_as_cv2(data: bytes) -> None:
    for grayscale in (False, True):
        want = cv2_read(data, grayscale)
        if want is None:
            with pytest.raises(ValueError, match="BMP"):
                bmp.decode_bmp(data, grayscale)
            continue
        got = bmp.decode_bmp(data, grayscale)
        assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


def palette_rows(idx: np.ndarray, bpp: int) -> bytes:
    if bpp == 8:
        rows = [bytes(r.astype(np.uint8)) for r in idx]
    elif bpp == 4:
        rows = [bytes(np.packbits(np.unpackbits(r.astype(np.uint8)[:, None], axis=1)[:, 4:]))
                for r in idx]
    else:
        rows = [bytes(np.packbits(r.astype(np.uint8))) for r in idx]
    return b"".join(pad(r) for r in rows)


@pytest.mark.parametrize("wh", SIZES, ids=str)
@pytest.mark.parametrize("bpp", [1, 4, 8])
@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
def test_palettes(wh, bpp, gray):
    """Every header with every palette depth, rows both ways up, a short
    palette (clrused), and OS/2 core files (which cv2 reads as gray)."""
    w, h = wh
    rng = np.random.default_rng(w * h * bpp)
    n = 1 << bpp
    pal = ([(v, v, v) for v in rng.integers(0, 256, n)] if gray
           else [tuple(rng.integers(0, 256, 3)) for _ in range(n)])
    px = palette_rows(rng.integers(0, n, (h, w)), bpp)
    for height in (h, -h):
        for header in (40, 108, 124):
            assert_as_cv2(build(w, height, bpp, px, pal, header=header))
    assert_as_cv2(build(w, h, bpp, px, pal, os2=True))
    assert_as_cv2(build(w, h, bpp, px, pal[:2], clrused=2))
    assert (bmp.decode_bmp(build(w, h, bpp, px, pal)).ndim == 2) == gray


@pytest.mark.parametrize("wh", SIZES, ids=str)
def test_direct_colour(wh):
    """24- and 32-bit in every header and OS/2; 16-bit as 555 (BI_RGB and
    BI_BITFIELDS) and 565, and a V5 565 file whose masks live only in its
    header (cv2 reads them after it, and refuses the file)."""
    w, h = wh
    rng = np.random.default_rng(w + h)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    words = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
    w16 = b"".join(pad(r.tobytes()) for r in words)
    for height in (h, -h):
        for bpp in (24, 32):
            px = b"".join(pad(bytes(r[:, :bpp // 8].ravel())) for r in img)
            for header in (40, 108, 124):
                assert_as_cv2(build(w, height, bpp, px, header=header))
            assert_as_cv2(build(w, abs(height), bpp, px, os2=True))
        assert_as_cv2(build(w, height, 16, w16))
        assert_as_cv2(build(w, height, 16, w16, compression=3, masks=(0x7C00, 0x3E0, 0x1F)))
        assert_as_cv2(build(w, height, 16, w16, compression=3, masks=(0xF800, 0x7E0, 0x1F)))
        assert_as_cv2(build(w, height, 16, w16, header=124, compression=3,
                            masks=(0xF800, 0x7E0, 0x1F, 0)))
        assert_as_cv2(build(w, height, 16, w16, compression=3, masks=(0xF00, 0xF0, 0xF)))


@pytest.mark.parametrize("masks", [(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                                   (0xFF, 0xFF00, 0xFF0000, 0), (0xFF0000, 0xFF00, 0xFF, 0),
                                   (0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000),
                                   (0xF0, 0xF000, 0xF00000, 0)],
                         ids=lambda m: "-".join(f"{v:x}" for v in m))
@pytest.mark.parametrize("header", [40, 52, 56, 108, 124])
def test_32_bit_bitfields(masks, header):
    """32-bit BI_BITFIELDS: a header of 56 bytes or more holds masks that
    cv2 applies (each field scaled to 8 bits, gray from f32 weights); a
    shorter one's bytes are read as B, G, R."""
    rng = np.random.default_rng(header)
    img = rng.integers(0, 256, (9, 70, 4), dtype=np.uint8)
    for height in (9, -9):
        assert_as_cv2(build(70, height, 32, bytes(img.ravel()), header=header, compression=3,
                            masks=masks))


def rle(idx: np.ndarray, four: bool, rng, style: str) -> bytes:
    """RLE8 / RLE4 codes for rows of palette indices: runs and absolute
    runs, an end of line a row; `style` adds a delta, a blank row (an end of
    line at its start), an early end of bitmap, or leaves the last end of
    line out.  A run of RLE4 alternates two nibbles: the run's first index
    and the next one."""
    out = bytearray()
    h, w = idx.shape
    for y in range(h):
        row, x = idx[y], 0
        if style == "delta" and y == 1:
            out += bytes([0, 2, 2, 1])
            continue
        if style == "blank" and y == 2:
            out += bytes([0, 0])
            continue
        while x < w:
            n = int(min(rng.integers(1, 9), w - x))
            if n >= 3 and rng.random() < 0.5:
                vals = [int(v) for v in row[x:x + n]]
                out += bytes([0, n])
                if four:
                    vals += [0] * (len(vals) % 2)
                    data = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, len(vals), 2))
                else:
                    data = bytes(vals)
                out += data + b"\0" * (len(data) % 2)
            else:
                a, b = int(row[x]), int(row[min(x + 1, w - 1)])
                out += bytes([n, (a << 4) | b if four else a])
            x += n
        if style == "early_eob" and y == h - 2:
            return bytes(out + bytes([0, 1]))
        if not (style == "no_final_eol" and y == h - 1):
            out += bytes([0, 0])
    return bytes(out + bytes([0, 1]))


@pytest.mark.parametrize("four", [False, True], ids=["rle8", "rle4"])
@pytest.mark.parametrize("style", ["plain", "delta", "blank", "early_eob", "no_final_eol"])
def test_rle(four, style):
    """Run-length files as an encoder writes them, and with each of the
    codes cv2 treats its own way (an RLE4 end of bitmap ends the row only,
    so cv2 refuses an early one)."""
    rng = np.random.default_rng(7)
    n = 16 if four else 256
    pal = [tuple(rng.integers(0, 256, 3)) for _ in range(n)]
    for w, h in [(1, 1), (8, 5), (13, 7), (40, 9)]:
        if h < 3 and style != "plain":
            continue
        data = rle(rng.integers(0, n, (h, w)), four, rng, style)
        for height in (h, -h):
            assert_as_cv2(build(w, height, 4 if four else 8, data, pal,
                                compression=2 if four else 1))


@pytest.mark.parametrize("four", [False, True], ids=["rle8", "rle4"])
def test_rle_escape_codes(four):
    """Streams built code by code: an end of bitmap first, then runs; a
    delta down a row and along it; a run that ends exactly at its row's end,
    then an end of line (RLE8 skips it); a run past a row's end and a
    stream that ends early (both refused)."""
    rng = np.random.default_rng(11)
    pal = [tuple(rng.integers(0, 256, 3)) for _ in range(16 if four else 256)]
    c, bpp = (2, 4) if four else (1, 8)
    for codes in ([0, 1, 4, 0x12, 0, 0, 4, 0x34, 0, 0], [0, 1, 0, 0, 4, 0x34, 0, 0],
                  [2, 0x12, 0, 1, 4, 0x34, 0, 0, 4, 0x56, 0, 0],
                  [2, 0x12, 0, 2, 1, 1, 1, 0x77, 0, 0, 4, 0x56, 0, 0, 4, 0x89, 0, 0],
                  [2, 0x12, 0, 2, 0, 1, 2, 0x77, 0, 0, 4, 0x56, 0, 0, 4, 0x89, 0, 0],
                  [2, 0x12, 0, 2, 6, 0, 2, 0x77, 0, 0, 4, 0x56, 0, 0], [0, 1],
                  [4, 1, 0, 0, 4, 2, 0, 0, 2, 3, 0, 0, 0, 1], [4, 1, 4, 2, 2, 3, 0, 1],
                  [6, 1, 0, 0, 0, 1], [4, 1, 0, 0, 2]):
        for height in (3, -3):
            assert_as_cv2(build(4, height, bpp, bytes(codes), pal, compression=c))


def test_written_by_pil_and_cv2():
    rng = np.random.default_rng(3)
    for w, h in SIZES:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for mode in ("1", "L", "P", "RGB", "RGBA"):
            out = io.BytesIO()
            Image.fromarray(img).convert(mode).save(out, "BMP")
            assert_as_cv2(out.getvalue())
        for arr in (img, img[:, :, 0]):
            ok, buf = cv2.imencode(".bmp", arr)
            assert_as_cv2(buf.tobytes())


def test_refused():
    """What cv2 does not read raises ValueError: another compression, a
    header size it does not know, data that ends early, not a BMP."""
    px = bytes(16)
    with pytest.raises(ValueError, match="compression 4"):
        bmp.decode_bmp(build(2, 2, 24, px, compression=4))
    with pytest.raises(ValueError, match="64-byte header|header"):
        bmp.decode_bmp(build(2, 2, 24, px, header=20))
    with pytest.raises(ValueError, match="ends early"):
        bmp.decode_bmp(build(4, 4, 24, px))
    with pytest.raises(ValueError, match="not a BMP"):
        bmp.decode_bmp(b"GIF89a" + px)
