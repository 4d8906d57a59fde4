"""BMP decoding with no PIL or cv2 (the card's machine has neither), as
cv2's own reader (imgcodecs/src/grfmt_bmp.cpp) gives a file to
cv2.imread, in numpy.

Headers: OS/2 core (12 bytes), BITMAPINFOHEADER (40) and the longer ones
(V4 108, V5 124), of which cv2 reads the first 36 bytes and then goes on
after the whole header: a 16-bit BI_BITFIELDS file's three masks are read
from there, and must be 555 or 565.  Pixels: 1 / 4 / 8-bit palettes,
RLE4 and RLE8 (cv2's run decoding, its end-of-line, delta and
end-of-bitmap codes filling with palette entry 0; in RLE4 an end of bitmap
ends the row only, and a delta moves along the row only), 16-bit 555 and 565
(each field shifted to the top of its byte, low bits zero), 24-bit, and
32-bit (the fourth byte dropped); rows bottom-up, or top-down where the
height is negative.

What a read gives (data/dataset.py's `_read_image` and `_read_mask`):
`grayscale=False` (IMREAD_UNCHANGED) a palette that is all gray, and every
OS/2 core file (cv2 leaves its colour flag unset there), as [H, W], else
RGB [H, W, 3]; `grayscale=True` (IMREAD_GRAYSCALE) [H, W].  Gray values
come from B, G, R with cv2's weights (1868, 9617, 4899) / 2^14, rounded;
a palette is converted entry by entry.  What cv2 does not read (another
compression, a header it refuses, data that ends early, a run past the
end of its row) raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"BM"
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
GRAY_WEIGHTS = (1868, 9617, 4899)  # B, G, R in 14 bits, as cv2's BGR → gray


def to_gray(bgr: np.ndarray) -> np.ndarray:
    """[..., 3] B, G, R uint8 → [...] uint8 with cv2's weights."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    wb, wg, wr = GRAY_WEIGHTS
    return ((b * wb + g * wg + r * wr + 8192) >> 14).astype(np.uint8)


class _Reader:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("BMP: the data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]


def _header(data: bytes):
    """(width, height (signed), bpp, compression, pixel offset, palette
    [256, 3] BGR, color, masks) as BmpDecoder::readHeader reads them; bpp is
    15 for a 555 file; masks are a 32-bit BI_BITFIELDS file's R, G, B
    masks where its header holds them (56 bytes or more), else None."""
    if data[:2] != SIGNATURE or len(data) < 18:
        raise ValueError("not a BMP file")
    offset, size = struct.unpack_from("<iI", data, 10)
    palette = np.zeros((256, 3), np.uint8)
    color = False
    masks = None
    if size >= 36:
        if len(data) < 14 + size:
            raise ValueError("BMP: the data ends early")
        width, height, planes_bpp, comp = struct.unpack_from("<iiIi", data, 18)
        bpp = planes_bpp >> 16
        (clrused,) = struct.unpack_from("<i", data, 46)
        if not 0 <= comp <= BI_BITFIELDS:
            raise ValueError(f"BMP: compression {comp} (cv2 reads 0-3 only)")
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == BI_RGB)
            or (bpp in (16, 32) and comp in (BI_RGB, BI_BITFIELDS))
            or (bpp == 4 and comp == BI_RLE4) or (bpp == 8 and comp == BI_RLE8))
        if not ok:
            raise ValueError(f"BMP: {bpp} bits a pixel with compression {comp}")
        color = True
        at = 14 + size
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                raise ValueError(f"BMP: {clrused} palette entries")
            n = clrused or 1 << bpp
            entries = np.frombuffer(_Reader(data, at).take(4 * n), np.uint8).reshape(n, 4)
            palette[:n] = entries[:, :3]
            used = palette[:1 << bpp]
            color = bool(((used[:, 0] != used[:, 1]) | (used[:, 0] != used[:, 2])).any())
        elif bpp == 16 and comp == BI_BITFIELDS:
            red, green, blue = struct.unpack("<III", _Reader(data, at).take(12))
            if (blue, green, red) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (blue, green, red) != (0x1F, 0x7E0, 0xF800):
                raise ValueError(f"BMP: 16-bit masks R {red:#x} G {green:#x} B {blue:#x} "
                                 "(cv2 reads 555 and 565)")
        elif bpp == 16:
            bpp = 15
        elif bpp == 32 and comp == BI_BITFIELDS and size >= 56:
            masks = struct.unpack_from("<III", data, 54)
    elif size == 12:
        width, height, planes_bpp = struct.unpack_from("<HHI", data, 18)
        bpp, comp = planes_bpp >> 16, BI_RGB
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise ValueError(f"BMP: an OS/2 file of {bpp} bits a pixel")
        if bpp <= 8:
            n = 1 << bpp
            palette[:n] = np.frombuffer(_Reader(data, 26).take(3 * n), np.uint8).reshape(n, 3)
    else:
        raise ValueError(f"BMP: a {size}-byte header")
    if offset < 0:
        raise ValueError("BMP: a negative pixel offset")
    return width, height, bpp, comp, offset, palette, color, masks


def _by_masks(rows: np.ndarray, width: int, masks) -> np.ndarray:
    """A 32-bit BI_BITFIELDS file whose header holds its masks: each of R, G,
    B is (pixel & mask) >> shift, scaled to 8 bits as v · 255 // its
    largest value (0 where the mask is 0) → B, G, R uint8."""
    v = rows.view("<u4")[:, :width].astype(np.int64)
    out = []
    for m in reversed(masks):
        if not m:
            out.append(np.zeros_like(v))
            continue
        shift = (m & -m).bit_length() - 1
        out.append(((v & m) >> shift) * 255 // (m >> shift))
    return np.stack(out, -1).astype(np.uint8)


def _float_gray(bgr: np.ndarray) -> np.ndarray:
    """The gray of a masked 32-bit file: r · 0.299 + g · 0.587 + b · 0.114 in
    f32, in that order, truncated."""
    b, g, r = (bgr[..., i].astype(np.float32) for i in range(3))
    y = r * np.float32(0.299) + g * np.float32(0.587) + b * np.float32(0.114)
    return y.astype(np.uint8)


def _rows(data: bytes, offset: int, width: int, height: int, bpp: int) -> np.ndarray:
    """The stored rows, in file order: [height, pitch] uint8 (pitch padded to 4)."""
    pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
    raw = _Reader(data, offset).take(pitch * height)
    return np.frombuffer(raw, np.uint8).reshape(height, pitch)


def _unpack_bits(rows: np.ndarray, width: int, bpp: int) -> np.ndarray:
    """Palette indices of 1- or 4-bit rows, the high bits first."""
    if bpp == 1:
        return np.unpackbits(rows, axis=1)[:, :width]
    return np.stack([rows >> 4, rows & 15], -1).reshape(rows.shape[0], -1)[:, :width]


def _fill(out, pos, count, value, width, height):
    """cv2's FillUniColor: `count` pixels of `value` from (y, x) on, to the
    end of each row and on into the next, stopping past the last row."""
    y, x = pos
    while True:
        end = min(x + count, width)
        if y < height:
            out[y, x:end] = value
        count -= end - x
        x = end
        if x >= width:
            y, x = y + 1, 0
            if y >= height:
                break
        if count <= 0:
            break
    return y, x


def _rle(data: bytes, offset: int, width: int, height: int, four: bool) -> np.ndarray:
    """RLE4 / RLE8 palette indices [height, width] in decode order (row 0
    first), as BmpDecoder::readData runs the codes."""
    out = np.zeros((height, width), np.int64)
    rd = _Reader(data, offset)
    y = x = 0
    line_end_flag = False
    while True:
        n, code = rd.byte(), rd.byte()
        if n:  # a run
            if x + n > width:
                raise ValueError("BMP: an RLE run past the end of its row")
            if four:
                out[y, x:x + n] = np.resize([code >> 4, code & 15], n)
                x += n
            else:
                prev = y
                y, x = _fill(out, (y, x), n, code, width, height)
                line_end_flag = y != prev
                if y >= height:
                    break
        elif code > 2:  # absolute mode
            if x + code > width:
                raise ValueError("BMP: an RLE run past the end of its row")
            size = ((((code + 1) >> 1) + 1) & ~1) if four else (code + 1) & ~1
            raw = np.frombuffer(rd.take(size), np.uint8)
            vals = np.stack([raw >> 4, raw & 15], -1).ravel() if four else raw
            out[y, x:x + code] = vals[:code]
            x += code
            line_end_flag = False
        else:  # 0 end of line, 1 end of bitmap, 2 delta (dx, dy)
            # RLE8 moves dx on and dy rows down (to the end of the bitmap for
            # code 1); cv2's RLE4 moves dx on only (to the end of the row for
            # codes 0 and 1: end of bitmap ends the row), reading dy
            dx, dy = width - x, height - y
            if four or code or not line_end_flag or dx < width:
                if code == 2:
                    dx, dy = rd.byte(), rd.byte()
                count = dx + (dy * width if code and not four else 0)
                y, x = _fill(out, (y, x), count, 0, width, height)
            line_end_flag = False
            if y >= height:
                break
    return out


def decode_bmp(data: bytes, grayscale: bool = False) -> np.ndarray:
    """BMP bytes → uint8 as cv2.imread gives them: IMREAD_UNCHANGED ([H, W]
    for a gray palette or an OS/2 core file, else RGB [H, W, 3]) or, with
    `grayscale`, IMREAD_GRAYSCALE ([H, W])."""
    width, height, bpp, comp, offset, palette, color, masks = _header(data)
    color = color and not grayscale
    h = abs(height)
    if comp in (BI_RLE4, BI_RLE8):
        idx = _rle(data, offset, width, h, comp == BI_RLE4)
    else:
        rows = _rows(data, offset, width, h, bpp)
        if bpp <= 8:
            idx = rows[:, :width] if bpp == 8 else _unpack_bits(rows, width, bpp)
        elif bpp in (15, 16):
            t = rows.view("<u2")[:, :width].astype(np.int64)
            g = (t >> 2) & 0xF8 if bpp == 15 else (t >> 3) & 0xFC
            r = (t >> 7) & 0xF8 if bpp == 15 else (t >> 8) & 0xF8
            bgr = np.stack([(t << 3) & 0xF8, g, r], -1).astype(np.uint8)
        elif masks is not None:
            bgr = _by_masks(rows, width, masks)
        else:
            bgr = rows[:, :width * (bpp // 8)].reshape(h, width, bpp // 8)[:, :, :3]
    if bpp <= 8:
        img = palette[idx] if color else to_gray(palette)[idx]
    elif color:
        img = bgr
    else:
        img = to_gray(bgr) if masks is None else _float_gray(bgr)
    if height > 0:  # bottom-up rows
        img = img[::-1]
    if img.ndim == 3:
        img = img[:, :, ::-1]  # BGR → RGB
    return np.ascontiguousarray(img)

