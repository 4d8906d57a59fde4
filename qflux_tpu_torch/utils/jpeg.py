"""JPEG decoding with no PIL or cv2 (the card's machine has neither), equal
to the bit to libjpeg-turbo 3.1 as cv2.imread and PIL call it: the islow
IDCT, fancy upsampling, no block smoothing needed, no merged upsampler.

The file is parsed here (markers, tables, scan headers, the entropy-coded
segments unstuffed and split at their restart markers, all with numpy:
no loop over bytes).  The per-symbol and per-pixel work has two versions,
one function each, the same steps in the same order:

  * `_decode_plain`: Python + numpy.  Huffman decoding of every scan
    (sequential, and progressive DC / AC first and refinement scans with
    their EOB runs) into per-component coefficient arrays, then
    dequantization and `jidctint.c`'s jpeg_idct_islow (CONST_BITS 13,
    PASS1_BITS 2, the post-IDCT range-limit table indexed with RANGE_MASK),
    `jdsample.c`'s upsamplers (h2v1 / h2v2 / h1v2 fancy, where a plane is
    wider than 2 samples for the h2 cases; int_upsample otherwise) and
    `jdcolor.c`'s fixed-point YCbCr → RGB and RGB → gray;
  * `_decode_native`: the same steps in C++ (csrc/jpeg_decode.cu, host
    code that runtime/build.py compiles into the kernel library), through
    its C entry `qflux_jpeg_decode`.

`decode_jpeg(..., impl=None)` takes the native one where
`torch.cuda.is_available()` (the card's machine) and the plain one
elsewhere; there is no fallback from one to the other.

What a read gives, as cv2.imread does (data/dataset.py's `_read_image` and
`_read_mask`): `grayscale=False` (IMREAD_UNCHANGED) a gray file as [H, W],
a colour one as RGB [H, W, 3], with no EXIF rotation; `grayscale=True`
(IMREAD_GRAYSCALE) [H, W]: the Y plane of a YCbCr file, the weighted sum
of an RGB one, turned as the first APP1 segment's EXIF orientation
(IFD0 tag 0x0112) says.  A file is RGB rather than YCbCr when it has no
JFIF APP0 and an Adobe APP14 says transform 0, or its component ids are
'R', 'G', 'B' (jdapimin.c:default_decompress_parms).

Arithmetic coding, 12-bit and lossless files, 4-component (CMYK / YCCK)
files, and a progressive file whose scans leave low-frequency AC bits
unknown (where libjpeg would smooth blocks, jdcoefct.c:smoothing_ok) raise
NotImplementedError naming what they are; corrupt or truncated data raises
ValueError.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

SIGNATURE = b"\xff\xd8"
NATIVE_DECODES = 0  # decodes through the C++ entry in this process

# zigzag position k -> natural (row-major 8 × 8) index
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
_NAT = NATURAL_ORDER.tolist()

# the fields of one scan's row of the native entry's int32 table
SCAN_FIELDS = 24
(_S_NCOMP, _S_COMP, _S_DC, _S_AC, _S_SS, _S_SE, _S_AH, _S_AL, _S_MCUX, _S_MCUY,
 _S_RESTART, _S_IFIRST, _S_NINT) = (0, 1, 5, 9, 13, 14, 15, 16, 17, 18, 19, 20, 21)
COMP_FIELDS = 8  # h, v, blocks wide, blocks high, plane width, plane height, needed, 0
# colour conversions, as the native entry numbers them
GRAY_OF_Y, YCC_TO_RGB, RGB_TO_RGB, RGB_TO_GRAY = 0, 1, 2, 3
# the native entry's error codes
_ERRORS = {1: "a Huffman code that is not in its table",
           2: "a coefficient past position 63 of its block",
           3: "a restart interval's data ends before its MCUs do",
           4: "an invalid argument"}

_SOF_UNSUPPORTED = {
    0xC3: "lossless JPEG (SOF3)", 0xC5: "hierarchical JPEG (SOF5)",
    0xC6: "hierarchical JPEG (SOF6)", 0xC7: "hierarchical lossless JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)", 0xCA: "arithmetic-coded progressive JPEG (SOF10)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "arithmetic-coded hierarchical JPEG (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless JPEG (SOF15)"}


def _range_limit() -> np.ndarray:
    """jdmaster.c:prepare_range_limit_table's post-IDCT part, indexed by a
    descaled IDCT output (centred on 0) & RANGE_MASK (1023): x + 128 for
    -128 <= x < 128, 255 above up to 511, 0 below down to -512, and the
    table wraps past that (a mask, not a clamp)."""
    i = np.arange(1024)
    return np.select([i < 128, i < 512, i < 896], [i + 128, 255, 0], i - 896).astype(np.uint8)


IDCT_LIMIT = _range_limit()


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


# jdcolor.c's tables (SCALEBITS 16): build_ycc_rgb_table and, for RGB → gray,
# the R / G / B → Y weights with ONE_HALF on blue
_X = np.arange(256, dtype=np.int64) - 128
CR_R = (_fix(1.40200) * _X + 32768) >> 16
CB_B = (_fix(1.77200) * _X + 32768) >> 16
CR_G = -_fix(0.71414) * _X
CB_G = -_fix(0.34414) * _X + 32768
_Y_R, _Y_G, _Y_B = _fix(0.29900), _fix(0.58700), _fix(0.11400)


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "qt", "width", "height", "bw", "bh", "pbw", "pbh")


class _Scan:
    __slots__ = ("comps", "dc", "ac", "ss", "se", "ah", "al", "restart", "mcux", "mcuy",
                 "data", "intervals")


class Frame:
    """What the markers say: the frame's geometry and components, every
    scan with its tables and its unstuffed entropy-coded bytes (`data`,
    split into restart intervals by `intervals`: [start, end) byte
    offsets), the colour space, and the EXIF orientation."""

    def __init__(self):
        self.width = self.height = 0
        self.progressive = False
        self.components: list[_Component] = []
        self.scans: list[_Scan] = []
        self.max_h = self.max_v = 1
        self.rgb = False          # three components that are R, G, B, not Y, Cb, Cr
        self.orientation = 1      # EXIF IFD0 0x0112, 1 where absent
        self.tables: list[tuple[bytes, bytes]] = []  # (16 counts, values) per DHT snapshot
        self.coef_bits: list[list[int]] = []  # per component, zigzag k → its last scan's Al


def _u16(data: bytes, pos: int) -> int:
    if pos + 2 > len(data):
        raise ValueError("JPEG: truncated marker segment")
    return (data[pos] << 8) | data[pos + 1]


def _exif_orientation(payload: bytes) -> int:
    """The orientation cv2's ExifReader finds in an APP1 payload: past its
    6 identifier bytes a TIFF header ('II' or 'MM', 42), IFD0's entries in
    order, tag 0x0112's first SHORT.  1 (leave as is) where the data stops
    short or holds no such entry."""
    tiff = payload[6:]
    if tiff[:2] == b"II":
        end = "<"
    elif tiff[:2] == b"MM":
        end = ">"
    else:
        return 1
    try:
        if struct.unpack_from(end + "H", tiff, 2)[0] != 42:
            return 1
        ifd = struct.unpack_from(end + "I", tiff, 4)[0]
        (count,) = struct.unpack_from(end + "H", tiff, ifd)
        for i in range(count):
            at = ifd + 2 + 12 * i
            (tag,) = struct.unpack_from(end + "H", tiff, at)
            if tag == 0x0112:
                return struct.unpack_from(end + "H", tiff, at + 8)[0]
    except struct.error:
        return 1
    return 1


def _huffman_codes(counts: bytes, values: bytes) -> list[tuple[int, int, int]]:
    """(length, code, symbol) of a table's canonical codes, as
    jdhuff.c:jpeg_make_d_derived_tbl assigns them; ValueError where the
    counts overflow a code length."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out.append((length, code, values[k]))
            code += 1
            k += 1
        if code > (1 << length):
            raise ValueError("JPEG: a Huffman table whose counts overflow its code lengths")
        code <<= 1
    return out


def _check_table(counts: bytes, values: bytes, dc: bool) -> None:
    _huffman_codes(counts, values)
    if dc and any(v > 15 for v in values):
        raise ValueError("JPEG: a DC Huffman table with a symbol above 15")


def _entropy_segment(arr: np.ndarray, marks: dict, start: int) -> tuple[np.ndarray, list, int]:
    """The entropy-coded bytes that begin at `start`: unstuffed (FF 00 → FF,
    fill bytes before a marker dropped), split at the restart markers
    (their numbers must run 0, 1, …, 7, 0, … from the scan's start), and
    the offset of the marker that ends the segment."""
    ffs, nxt = marks["ff"], marks["next"]
    i0 = int(np.searchsorted(ffs, start))
    ends = np.flatnonzero(marks["ends"][i0:])
    if not len(ends):
        raise ValueError("JPEG: the data ends inside a scan (no EOI)")
    i1 = i0 + int(ends[0])
    end = int(ffs[i1])
    pos, kind = ffs[i0:i1] - start, nxt[i0:i1]
    keep = np.ones(end - start, bool)
    keep[pos[kind == 0] + 1] = False            # the 00 of a stuffed FF
    keep[pos[kind == 0xFF]] = False             # a fill byte
    rst = (kind >= 0xD0) & (kind <= 0xD7)
    keep[pos[rst]] = False
    keep[pos[rst] + 1] = False
    numbers = kind[rst].astype(np.int64) - 0xD0
    if (numbers != np.arange(len(numbers)) % 8).any():
        raise ValueError("JPEG: restart markers out of sequence")
    before = np.concatenate([[0], np.cumsum(keep)])
    cuts = [0] + before[pos[rst]].tolist() + [int(before[-1])]
    return arr[start:end][keep], list(zip(cuts[:-1], cuts[1:])), end


def parse(data: bytes) -> Frame:
    """JPEG bytes → Frame.  Raises NotImplementedError for the formats the
    decoder does not take, ValueError for data that is not a whole JPEG."""
    if data[:2] != SIGNATURE:
        raise ValueError("not a JPEG file")
    arr = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    marks = {"ff": ff, "next": nxt,
             "ends": (nxt != 0) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))}
    f = Frame()
    qt: dict[int, np.ndarray] = {}
    dc: dict[int, int] = {}
    ac: dict[int, int] = {}
    restart = 0
    jfif = adobe = False
    transform = None
    app1_seen = False
    pos = 2
    sof = None
    while True:
        # next marker (jdmarker.c:next_marker): skip anything up to an FF,
        # FF fill bytes, and an FF 00 pair outside a scan
        i = int(np.searchsorted(ff, pos))
        while i < len(ff) and nxt[i] in (0, 0xFF):
            i += 1
        if i >= len(ff):
            raise ValueError("JPEG: the data ends before EOI")
        marker, pos = int(nxt[i]), int(ff[i]) + 2
        if marker == 0xD9:  # EOI
            break
        if marker == 0xD8:
            raise ValueError("JPEG: a second SOI")
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue  # parameterless markers
        length = _u16(data, pos)
        if length < 2 or pos + length > len(data):
            raise ValueError(f"JPEG: marker FF{marker:02X}'s segment runs past the data")
        seg = data[pos + 2:pos + length]
        nextpos = pos + length
        if marker in _SOF_UNSUPPORTED:
            raise NotImplementedError(
                f"JPEG: {_SOF_UNSUPPORTED[marker]} is not decoded by the port")
        if marker in (0xC0, 0xC1, 0xC2):
            if sof is not None:
                raise ValueError("JPEG: two SOF markers")
            sof = marker
            if len(seg) < 6:
                raise ValueError("JPEG: truncated SOF")
            precision, f.height, f.width, n = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
            if precision == 12:
                raise NotImplementedError("JPEG: 12-bit samples are not decoded by the port")
            if precision != 8:
                raise ValueError(f"JPEG: {precision}-bit samples")
            if f.height == 0:
                raise NotImplementedError("JPEG: a height set by a DNL marker is not decoded "
                                          "by the port")
            if f.width == 0 or n == 0:
                raise ValueError("JPEG: an empty frame")
            if n == 4:
                raise NotImplementedError("JPEG: 4-component (CMYK / YCCK) files are not "
                                          "decoded by the port")
            if n not in (1, 3):
                raise NotImplementedError(f"JPEG: {n}-component files are not decoded by "
                                          "the port")
            if len(seg) < 6 + 3 * n:
                raise ValueError("JPEG: truncated SOF")
            for k in range(n):
                c = _Component()
                c.cid, hv, c.tq = seg[6 + 3 * k], seg[7 + 3 * k], seg[8 + 3 * k]
                c.h, c.v = hv >> 4, hv & 15
                if not (1 <= c.h <= 4 and 1 <= c.v <= 4) or c.tq > 3:
                    raise ValueError("JPEG: bad sampling factors or quantization table id")
                c.qt = None
                f.components.append(c)
            f.progressive = marker == 0xC2
            f.max_h = max(c.h for c in f.components)
            f.max_v = max(c.v for c in f.components)
            mx, my = -(-f.width // (8 * f.max_h)), -(-f.height // (8 * f.max_v))
            for c in f.components:
                if f.max_h % c.h or f.max_v % c.v:
                    raise NotImplementedError("JPEG: sampling factors that do not divide the "
                                              "largest are not decoded by the port")
                c.width = -(-f.width * c.h // f.max_h)
                c.height = -(-f.height * c.v // f.max_v)
                c.bw, c.bh = -(-c.width // 8), -(-c.height // 8)
                c.pbw, c.pbh = mx * c.h, my * c.v  # the padded block grid
            f.coef_bits = [[-1] * 64 for _ in f.components]
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                if p + 17 > len(seg):
                    raise ValueError("JPEG: truncated DHT")
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = seg[p + 1:p + 17]
                total = sum(counts)
                if tc > 1 or th > 3 or total > 256 or p + 17 + total > len(seg):
                    raise ValueError("JPEG: bad DHT")
                values = seg[p + 17:p + 17 + total]
                _check_table(counts, values, tc == 0)
                f.tables.append((bytes(counts), bytes(values)))
                (dc if tc == 0 else ac)[th] = len(f.tables) - 1
                p += 17 + total
        elif marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                size = 128 if pq else 64
                if pq > 1 or tq > 3 or p + 1 + size > len(seg):
                    raise ValueError("JPEG: bad DQT")
                vals = np.frombuffer(seg, ">u2" if pq else np.uint8, 64, p + 1)
                table = np.zeros(64, np.int64)
                table[NATURAL_ORDER] = vals
                qt[tq] = table
                p += 1 + size
        elif marker == 0xDD:  # DRI
            restart = _u16(seg, 0)
        elif marker == 0xE0:
            if seg[:5] == b"JFIF\x00" and len(seg) >= 14:
                jfif = True
        elif marker == 0xE1:
            if not app1_seen:
                app1_seen = True
                f.orientation = _exif_orientation(seg)
        elif marker == 0xEE:
            if seg[:5] == b"Adobe" and len(seg) >= 12:
                adobe, transform = True, seg[11]
        elif marker == 0xDA:  # SOS
            if sof is None:
                raise ValueError("JPEG: SOS before SOF")
            nextpos = _scan(f, seg, qt, dc, ac, restart, arr, marks, nextpos)
        elif marker == 0xCC:
            raise NotImplementedError("JPEG: arithmetic coding (DAC) is not decoded by the port")
        pos = nextpos
    if sof is None or not f.scans:
        raise ValueError("JPEG: no image data")
    if len(f.components) == 3:
        ids = tuple(c.cid for c in f.components)
        if jfif:
            f.rgb = False
        elif adobe:
            f.rgb = transform == 0
        else:
            f.rgb = ids == (82, 71, 66)
    for c in f.components:
        if c.qt is None:  # a component no scan carries keeps zero coefficients
            if c.tq not in qt:
                raise ValueError("JPEG: no quantization table for a component")
            c.qt = qt[c.tq]
    if f.progressive and _smoothing_wanted(f):
        raise NotImplementedError(
            "JPEG: a progressive file whose scans leave low-frequency AC bits unknown "
            "(libjpeg block-smooths it) is not decoded by the port")
    return f


def _scan(f, seg, qt, dc, ac, restart, arr, marks, start) -> int:
    """One SOS: its components, tables (snapshots of those in force), and
    parameters, the quantization tables its components latch, its MCU grid,
    and its entropy-coded data from `start` on; the offset after the data."""
    if not seg or len(seg) < 1 + 2 * seg[0] + 3:
        raise ValueError("JPEG: truncated SOS")
    n = seg[0]
    if not 1 <= n <= 4:
        raise ValueError("JPEG: a scan of no components")
    s = _Scan()
    s.comps, s.dc, s.ac = [], [], []
    by_id = {c.cid: k for k, c in enumerate(f.components)}
    for k in range(n):
        cid, t = seg[1 + 2 * k], seg[2 + 2 * k]
        if cid not in by_id or by_id[cid] in s.comps:
            raise ValueError(f"JPEG: a scan names component {cid}, which the frame lacks")
        s.comps.append(by_id[cid])
        s.dc.append(t >> 4)
        s.ac.append(t & 15)
    s.ss, s.se = seg[1 + 2 * n], seg[2 + 2 * n]
    s.ah, s.al = seg[3 + 2 * n] >> 4, seg[3 + 2 * n] & 15
    s.restart = restart
    comps = [f.components[k] for k in s.comps]
    if n > 1 and sum(c.h * c.v for c in comps) > 10:
        raise ValueError("JPEG: more than 10 blocks in an MCU")
    if f.progressive:
        bad = (s.se != 0) if s.ss == 0 else (s.ss > s.se or s.se > 63 or n != 1)
        if (s.ah and s.al != s.ah - 1) or s.al > 13 or bad:
            raise ValueError("JPEG: a progressive scan with bad parameters")
        for k in s.comps:
            bits = f.coef_bits[k]
            for i in range(s.ss, s.se + 1):
                bits[i] = s.al
    # the tables this scan decodes with, by index into f.tables
    need_dc = not f.progressive or (s.ss == 0 and s.ah == 0)
    need_ac = not f.progressive or s.ss > 0
    dci, aci = [], []
    for t_dc, t_ac in zip(s.dc, s.ac):
        if need_dc and t_dc not in dc:
            raise ValueError(f"JPEG: no DC Huffman table {t_dc}")
        if need_ac and t_ac not in ac:
            raise ValueError(f"JPEG: no AC Huffman table {t_ac}")
        dci.append(dc.get(t_dc, -1) if need_dc else -1)
        aci.append(ac.get(t_ac, -1) if need_ac else -1)
    s.dc, s.ac = dci, aci
    for c in comps:  # jdinput.c:latch_quant_tables
        if c.qt is None:
            if c.tq not in qt:
                raise ValueError(f"JPEG: no quantization table {c.tq}")
            c.qt = qt[c.tq].copy()
    if n == 1:
        s.mcux, s.mcuy = comps[0].bw, comps[0].bh
    else:
        s.mcux, s.mcuy = -(-f.width // (8 * f.max_h)), -(-f.height // (8 * f.max_v))
    s.data, intervals, end = _entropy_segment(arr, marks, start)
    total = s.mcux * s.mcuy
    need = -(-total // restart) if restart else 1
    if len(intervals) < need:
        raise ValueError("JPEG: fewer restart intervals than the scan's MCUs need")
    s.intervals = intervals[:need]
    f.scans.append(s)
    return end


def _smoothing_wanted(f: Frame) -> bool:
    """jdcoefct.c:smoothing_ok at the output pass, after every scan: each
    component's DC known in part, and some coefficient 1–9 of some
    component not known to its last bit (a nonzero quantizer assumed)."""
    if any(bits[0] < 0 for bits in f.coef_bits):
        return False
    if any(c.qt[NATURAL_ORDER[:10]].min() == 0 for c in f.components):
        return False
    return any(bits[k] != 0 for bits in f.coef_bits for k in range(1, 10))


# ---------------------------------------------------------------------------
# the plain version: Python + numpy

def _lookup(counts: bytes, values: bytes) -> list:
    """A 16-bit lookahead table: the next 16 bits → length << 8 | symbol
    (0 where no code matches)."""
    lut = np.zeros(1 << 16, np.int64)
    for length, code, sym in _huffman_codes(counts, values):
        lut[code << (16 - length):(code + 1) << (16 - length)] = (length << 8) | sym
    return lut.tolist()


class _HuffmanError(ValueError):
    pass


def _windows(buf: np.ndarray) -> list:
    """The 32 bits that start at each byte of buf (zeros past its end)."""
    b = np.concatenate([buf, np.zeros(4, np.uint8)]).astype(np.int64)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


def _decode_scan_plain(f: Frame, s: _Scan, coefs: list, luts: dict) -> None:
    """One scan's MCUs into `coefs` (a flat list per component, 64 a block
    in natural order, blocks row-major over the padded block grid)."""
    win = _windows(s.data)
    comps = [f.components[k] for k in s.comps]
    single = len(s.comps) == 1
    # per block of an MCU: (component slot, block row offset, block column offset)
    if single:
        layout = [(0, 0, 0)]
    else:
        layout = [(j, y, x) for j, c in enumerate(comps) for y in range(c.v) for x in range(c.h)]
    dcl = [luts.get(t) for t in s.dc]
    acl = [luts.get(t) for t in s.ac]
    cf = [coefs[k] for k in s.comps]
    pbw = [c.pbw for c in comps]
    hv = [(c.h, c.v) for c in comps]
    nat = _NAT
    prog = f.progressive
    ss, se, ah, al = s.ss, s.se, s.ah, s.al
    kind = ("seq" if not prog else "dc_first" if ss == 0 and ah == 0 else "dc_refine"
            if ss == 0 else "ac_first" if ah == 0 else "ac_refine")
    p1, m1 = 1 << al, -1 << al
    per = s.restart or s.mcux * s.mcuy
    mcu = 0
    total = s.mcux * s.mcuy
    for (istart, iend) in s.intervals:
        p = istart * 8
        pend = iend * 8
        pred = [0] * len(comps)
        eobrun = 0
        for m in range(mcu, min(mcu + per, total)):
            my, mx = divmod(m, s.mcux)
            for (j, oy, ox) in layout:
                if single:
                    base = (my * pbw[0] + mx) * 64
                else:
                    h, v = hv[j]
                    base = ((my * v + oy) * pbw[j] + mx * h + ox) * 64
                blk = cf[j]
                if kind == "seq" or kind == "dc_first":
                    v_ = dcl[j][(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not v_:
                        raise _HuffmanError(1)
                    p += v_ >> 8
                    t = v_ & 255
                    if t:
                        r = (win[p >> 3] >> (32 - (p & 7) - t)) & ((1 << t) - 1)
                        p += t
                        if r < (1 << (t - 1)):
                            r -= (1 << t) - 1
                        pred[j] += r
                    if kind == "dc_first":
                        blk[base] = pred[j] << al
                        continue
                    blk[base] = pred[j]
                    lut = acl[j]
                    k = 1
                    while k < 64:
                        v_ = lut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                        if not v_:
                            raise _HuffmanError(1)
                        p += v_ >> 8
                        t = v_ & 15
                        r = (v_ >> 4) & 15
                        if t:
                            k += r
                            if k > 63:
                                raise _HuffmanError(2)
                            r = (win[p >> 3] >> (32 - (p & 7) - t)) & ((1 << t) - 1)
                            p += t
                            if r < (1 << (t - 1)):
                                r -= (1 << t) - 1
                            blk[base + nat[k]] = r
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
                elif kind == "dc_refine":
                    if (win[p >> 3] >> (31 - (p & 7))) & 1:
                        blk[base] |= p1
                    p += 1
                elif kind == "ac_first":
                    if eobrun:
                        eobrun -= 1
                        continue
                    lut = acl[j]
                    k = ss
                    while k <= se:
                        v_ = lut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                        if not v_:
                            raise _HuffmanError(1)
                        p += v_ >> 8
                        t = v_ & 15
                        r = (v_ >> 4) & 15
                        if t:
                            k += r
                            if k > 63:
                                raise _HuffmanError(2)
                            r = (win[p >> 3] >> (32 - (p & 7) - t)) & ((1 << t) - 1)
                            p += t
                            if r < (1 << (t - 1)):
                                r -= (1 << t) - 1
                            blk[base + nat[k]] = r * p1
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = 1 << r
                            if r:
                                eobrun += (win[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                                p += r
                            eobrun -= 1
                            break
                        k += 1
                else:  # ac_refine
                    lut = acl[j]
                    k = ss
                    if not eobrun:
                        while k <= se:
                            v_ = lut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                            if not v_:
                                raise _HuffmanError(1)
                            p += v_ >> 8
                            t = v_ & 15
                            r = (v_ >> 4) & 15
                            if t:
                                t = p1 if (win[p >> 3] >> (31 - (p & 7))) & 1 else m1
                                p += 1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += (win[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                                    p += r
                                break
                            while k <= se:
                                at = base + nat[k]
                                c = blk[at]
                                if c:
                                    if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                                        blk[at] = c + p1 if c >= 0 else c + m1
                                    p += 1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if t:
                                if k > 63:
                                    raise _HuffmanError(2)
                                blk[base + nat[k]] = t
                            k += 1
                    if eobrun:
                        while k <= se:
                            at = base + nat[k]
                            c = blk[at]
                            if c:
                                if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                                    blk[at] = c + p1 if c >= 0 else c + m1
                                p += 1
                            k += 1
                        eobrun -= 1
            if p > pend:
                raise _HuffmanError(3)
        mcu += per


def _idct_1d(d):
    """jpeg_idct_islow's butterfly on 8 arrays (int64): the 8 outputs
    before their descale."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    z1 = (d2 + d6) * 4433
    tmp2 = z1 + d6 * -15137
    tmp3 = z1 + d2 * 6270
    tmp0 = (d0 + d4) << 13
    tmp1 = (d0 - d4) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d7, d5, d3, d1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """[..., 64] coefficients (natural order) and their quantizers → [..., 8,
    8] uint8 samples, as jpeg_idct_islow (its all-zero-AC shortcuts give
    the same values as the full butterflies)."""
    x = (coef.astype(np.int64) * q).reshape(coef.shape[:-1] + (8, 8))
    cols = _idct_1d([x[..., i, :] for i in range(8)])          # pass 1, down the columns
    ws = np.stack([((c + 1024) >> 11).astype(np.int32).astype(np.int64) for c in cols], -2)
    rows = _idct_1d([ws[..., :, i] for i in range(8)])         # pass 2, along the rows
    out = np.stack([(r + (1 << 17)) >> 18 for r in rows], -1)
    return IDCT_LIMIT[out & 1023]


def _upsample(plane: np.ndarray, c: _Component, f: Frame) -> np.ndarray:
    """One component's plane [height, width] → [height · v_out / v, width ·
    h_out / h], as jdsample.c picks its method."""
    hx, vx = f.max_h // c.h, f.max_v // c.v
    if hx == 1 and vx == 1:
        return plane
    x = plane.astype(np.int32)
    if hx == 2 and vx == 1 and c.width > 2:
        return _h2(x, 1, 2, 2)
    if hx == 1 and vx == 2:
        return _v2(x, 1, 2)
    if hx == 2 and vx == 2 and c.width > 2:
        return _h2(_v2(x, 0, 0, True), 8, 7, 4)
    return np.repeat(np.repeat(plane, vx, 0), hx, 1)


def _v2(x, even_bias, odd_bias, keep_sums=False):
    """Rows 2i, 2i+1 from 3·x[i] + x[i-1] / x[i+1] (edge rows repeated):
    the column sums of h2v2 (`keep_sums`) or h1v2's (sum + bias) >> 2."""
    above = np.concatenate([x[:1], x[:-1]])
    below = np.concatenate([x[1:], x[-1:]])
    out = np.empty((2 * x.shape[0],) + x.shape[1:], np.int32)
    if keep_sums:
        out[0::2], out[1::2] = 3 * x + above, 3 * x + below
        return out
    out[0::2] = (3 * x + above + even_bias) >> 2
    out[1::2] = (3 * x + below + odd_bias) >> 2
    return out.astype(np.uint8)


def _h2(x, even_bias, odd_bias, shift):
    """Columns 2j, 2j+1 from 3·x[j] + x[j-1] / x[j+1] with h2v1's biases
    (1, 2; >> 2), or from h2v2's column sums (8, 7; >> 4), the first and
    last column as the edge cases write them."""
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + even_bias) >> shift
    out[:, 1::2] = (3 * x + right + odd_bias) >> shift
    # first / last columns: thiscolsum · 4 + bias in place of the neighbour
    out[:, 0] = (4 * x[:, 0] + even_bias) >> shift
    out[:, -1] = (4 * x[:, -1] + odd_bias) >> shift
    return out.astype(np.uint8)


def _convert(f: Frame, planes: list, grayscale: bool) -> np.ndarray:
    """jdcolor.c: the planes (upsampled, cropped) → the output."""
    if len(planes) == 1:  # a gray file, or a YCbCr one's Y plane (`_needed`)
        return planes[0]
    a, b, c = (p.astype(np.int64) for p in planes)
    if f.rgb:
        if grayscale:
            return ((a * _Y_R + b * _Y_G + c * _Y_B + 32768) >> 16).astype(np.uint8)
        return np.stack(planes, -1)
    rgb = np.stack([a + CR_R[c], a + ((CB_G[b] + CR_G[c]) >> 16), a + CB_B[b]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _needed(f: Frame, grayscale: bool) -> list:
    """Which components the output reads: a YCbCr file read as gray reads Y
    only (libjpeg's component_needed)."""
    return [k == 0 or not grayscale or f.rgb for k in range(len(f.components))]


def _decode_plain(f: Frame, grayscale: bool) -> np.ndarray:
    coefs = [[0] * (c.pbw * c.pbh * 64) for c in f.components]
    luts = {t: _lookup(*f.tables[t]) for s in f.scans for t in s.dc + s.ac if t >= 0}
    try:
        for s in f.scans:
            _decode_scan_plain(f, s, coefs, luts)
    except _HuffmanError as e:
        raise ValueError(f"JPEG: {_ERRORS[e.args[0]]}") from None
    except IndexError:
        raise ValueError(f"JPEG: {_ERRORS[3]}") from None
    planes = []
    for c, cf, need in zip(f.components, coefs, _needed(f, grayscale)):
        if not need:
            continue
        blocks = np.array(cf, np.int64).astype(np.int16).reshape(c.pbh, c.pbw, 64)
        samples = idct_islow(blocks[:c.bh, :c.bw], c.qt)              # [bh, bw, 8, 8]
        plane = samples.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        planes.append(_upsample(plane[:c.height, :c.width], c, f)[:f.height, :f.width])
    return np.ascontiguousarray(_convert(f, planes, grayscale))


# ---------------------------------------------------------------------------
# the native version: csrc/jpeg_decode.cu

def native_arguments(f: Frame, grayscale: bool) -> dict:
    """The native entry's arrays: the scans' bytes end to end, a row of
    SCAN_FIELDS int32 a scan, the restart intervals' [start, end) byte
    offsets, each Huffman table as 16 counts and 256 values (uint8), a row
    of COMP_FIELDS int32 and 64 quantizers (natural order) a component, and
    the colour conversion."""
    scans = np.zeros((len(f.scans), SCAN_FIELDS), np.int32)
    data, intervals, off = [], [], 0
    for i, s in enumerate(f.scans):
        row = scans[i]
        row[_S_NCOMP] = len(s.comps)
        row[_S_COMP:_S_COMP + 4] = (s.comps + [0] * 4)[:4]
        row[_S_DC:_S_DC + 4] = (s.dc + [-1] * 4)[:4]
        row[_S_AC:_S_AC + 4] = (s.ac + [-1] * 4)[:4]
        row[_S_SS], row[_S_SE], row[_S_AH], row[_S_AL] = s.ss, s.se, s.ah, s.al
        row[_S_MCUX], row[_S_MCUY], row[_S_RESTART] = s.mcux, s.mcuy, s.restart
        row[_S_IFIRST], row[_S_NINT] = len(intervals), len(s.intervals)
        intervals += [(off + a, off + b) for a, b in s.intervals]
        data.append(s.data)
        off += len(s.data)
    tables = np.zeros((max(len(f.tables), 1), 272), np.uint8)
    for t, (counts, values) in enumerate(f.tables):
        tables[t, :16] = np.frombuffer(counts, np.uint8)
        tables[t, 16:16 + len(values)] = np.frombuffer(values, np.uint8)
    comps = np.array([[c.h, c.v, c.pbw, c.pbh, c.width, c.height, int(need), 0]
                      for c, need in zip(f.components, _needed(f, grayscale))], np.int32)
    qt = np.stack([c.qt for c in f.components]).astype(np.int32)
    if len(f.components) == 1 or (grayscale and not f.rgb):
        color = GRAY_OF_Y
    elif f.rgb:
        color = RGB_TO_GRAY if grayscale else RGB_TO_RGB
    else:
        color = YCC_TO_RGB
    return {"data": np.concatenate(data + [np.zeros(8, np.uint8)]), "scans": scans,
            "intervals": np.array(intervals, np.int32).reshape(-1, 2), "tables": tables,
            "comps": comps, "qt": qt, "color": color,
            "channels": 1 if color in (GRAY_OF_Y, RGB_TO_GRAY) else 3}


def _decode_native(f: Frame, grayscale: bool) -> np.ndarray:
    global NATIVE_DECODES
    from qflux_tpu_torch.runtime.build import load_library

    lib = load_library().lib
    a = native_arguments(f, grayscale)
    out = np.empty((f.height, f.width, a["channels"]), np.uint8)

    def ptr(x):
        return ctypes.c_void_p(x.ctypes.data)

    code = lib.qflux_jpeg_decode(
        ptr(a["data"]), ptr(a["scans"]), len(f.scans), ptr(a["intervals"]), ptr(a["tables"]),
        ptr(a["comps"]), ptr(a["qt"]), len(f.components), f.width, f.height, f.max_h,
        f.max_v, int(f.progressive), a["color"], ptr(out))
    NATIVE_DECODES += 1
    if code:
        raise ValueError(f"JPEG: {_ERRORS.get(code, f'native error {code}')}")
    return out[:, :, 0] if a["channels"] == 1 else out


# ---------------------------------------------------------------------------

def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform: orientations 2–8 as flips of the image or of its
    transpose; any other value leaves it as it is."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def default_impl() -> str:
    import torch

    return "native" if torch.cuda.is_available() else "plain"


def decode_jpeg(data: bytes, grayscale: bool = False, impl: Optional[str] = None) -> np.ndarray:
    """JPEG bytes → uint8 as cv2.imread gives them: IMREAD_UNCHANGED ([H, W]
    gray, [H, W, 3] RGB) or, with `grayscale`, IMREAD_GRAYSCALE ([H, W],
    EXIF orientation applied).  `impl` is "plain" or "native"; None takes
    the native decoder where a CUDA device is present."""
    impl = impl or default_impl()
    if impl not in ("plain", "native"):
        raise ValueError(f"impl must be 'plain' or 'native', got {impl!r}")
    f = parse(data)
    img = (_decode_native if impl == "native" else _decode_plain)(f, grayscale)
    return orient(img, f.orientation) if grayscale else img

