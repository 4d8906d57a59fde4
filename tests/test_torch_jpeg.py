"""The port's JPEG decoder (qflux_tpu_torch/utils/jpeg.py, its plain Python
version, which the CPU runs) against cv2.imread on files written here by
cv2 and PIL, or edited byte by byte: every array equal to the bit, under
IMREAD_UNCHANGED (`grayscale=False`) and IMREAD_GRAYSCALE (EXIF orientation
applied).  Also: what the decoder refuses, the routing between its plain and
native versions (no fallback), the data layer without cv2 or PIL, and the
committed fixtures' digests that chip_smoke.py holds the card to."""

from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from qflux_tpu_torch.data import dataset as tdataset
from qflux_tpu_torch.utils import bmp, jpeg, png

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111,
            "411": 0x411111}
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"


def photo(rng, h, w, c=3) -> np.ndarray:
    """Smooth ripples plus noise: every coefficient band gets some energy."""
    y, x = np.mgrid[0:h, 0:w]
    chans = []
    for k in range(c):
        f = rng.uniform(0.01, 0.2, 4)
        v = 128 + 60 * np.sin(x * f[0] + y * f[1] + k) + 40 * np.cos(x * f[2] * 0.5 - y * f[3])
        chans.append(v + rng.normal(0, 12, (h, w)))
    img = np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)
    return img[:, :, 0] if c == 1 else img


def cv_jpeg(img, quality=90, samp="420", progressive=False, rst=0, optimize=False) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[samp]]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if rst:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if optimize:
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def pil_jpeg(img, **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", **kw)
    return out.getvalue()


def cv2_read(data: bytes, grayscale: bool):
    """cv2.imread's array, as the port returns it (BGR → RGB)."""
    a = cv2.imdecode(np.frombuffer(data, np.uint8),
                     cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_UNCHANGED)
    return a[:, :, ::-1] if a is not None and a.ndim == 3 else a


def assert_as_cv2(data: bytes, modes=(False, True)) -> None:
    for grayscale in modes:
        want = cv2_read(data, grayscale)
        got = jpeg.decode_jpeg(data, grayscale, impl="plain")
        assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


def segments(data: bytes):
    """(marker, start, end) of each marker segment up to the first SOS, and
    the SOS segments with their entropy-coded data after."""
    out, pos = [], 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            out.append((marker, pos, pos + 2))
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        end = pos + 2 + length
        if marker == 0xDA:  # the entropy-coded data runs to the next non-RST marker
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
        out.append((marker, pos, end))
        pos = end
    return out


def drop_scans(data: bytes, which) -> bytes:
    """The file without the SOS segments (and their data) numbered in `which`."""
    keep, k = [data[:2]], 0
    for marker, a, b in segments(data):
        if marker == 0xDA:
            if k in which:
                k += 1
                continue
            k += 1
        keep.append(data[a:b])
    return b"".join(keep)


def with_segment(data: bytes, marker: int, payload: bytes) -> bytes:
    """A marker segment put right after SOI."""
    head = bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2)
    return data[:2] + head + payload + data[2:]


def exif(orientation: int, big_endian: bool) -> bytes:
    """An APP1 payload: 'Exif\\0\\0', a TIFF header and IFD0 with one SHORT
    entry 0x0112."""
    e = ">" if big_endian else "<"
    tiff = (b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
    tiff += struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
    return b"Exif\x00\x00" + tiff + struct.pack(e + "I", 0)


# ---------------------------------------------------------------------------
# the decoder against cv2


@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (2, 5), (33, 47)], ids=str)
@pytest.mark.parametrize("samp", list(SAMPLING))
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_sampling_sizes_and_modes(hw, samp, progressive):
    img = photo(np.random.default_rng(sum(hw)), *hw)
    assert_as_cv2(cv_jpeg(img, 90, samp, progressive))


@pytest.mark.parametrize("quality", [50, 75, 90, 100])
def test_qualities(quality):
    assert_as_cv2(cv_jpeg(photo(np.random.default_rng(quality), 61, 77), quality))


@pytest.mark.parametrize("samp,progressive", [("420", False), ("420", True), ("444", False)])
def test_517x513(samp, progressive):
    """An odd size at full resolution: MCUs cut at both edges."""
    assert_as_cv2(cv_jpeg(photo(np.random.default_rng(5), 513, 517), 90, samp, progressive))


@pytest.mark.parametrize("samp,rst,progressive,optimize", [
    ("444", 3, False, True), ("420", 2, False, False), ("420", 2, True, False),
    ("422", 1, False, True), ("420", 5, True, True)])
def test_restart_intervals_and_optimized_tables(samp, rst, progressive, optimize):
    data = cv_jpeg(photo(np.random.default_rng(rst), 45, 67), 90, samp, progressive, rst,
                   optimize)
    assert any(data[i] == 0xFF and data[i + 1] == 0xD0 for i in range(len(data) - 1))
    assert_as_cv2(data)


@pytest.mark.parametrize("progressive", [False, True])
def test_grayscale_file(progressive):
    data = cv_jpeg(photo(np.random.default_rng(3), 45, 37, 1), 90, progressive=progressive)
    assert_as_cv2(data)
    assert jpeg.decode_jpeg(data, impl="plain").shape == (45, 37)


def test_pil_files():
    """PIL's own writer: 4:2:2 progressive with optimized tables; an RGB
    (Adobe transform 0) file; 16-bit quantization tables (SOF1)."""
    img = photo(np.random.default_rng(9), 40, 51)
    assert_as_cv2(pil_jpeg(img, quality=80, subsampling=1, progressive=True, optimize=True))
    rgb = pil_jpeg(img, quality=90, keep_rgb=True)
    assert jpeg.parse(rgb).rgb
    assert_as_cv2(rgb)
    sixteen = pil_jpeg(img, qtables=[[min(1000, 10 * k + 300) for k in range(64)]] * 2)
    assert b"\xff\xc1" in sixteen
    assert_as_cv2(sixteen)


def test_colour_space_rules():
    """jdapimin.c's rules on an RGB file: without its Adobe marker the 'R',
    'G', 'B' component ids still make it RGB; with a JFIF marker put in, it
    reads as YCbCr, as libjpeg reads it."""
    rgb = pil_jpeg(photo(np.random.default_rng(2), 24, 40), quality=90, keep_rgb=True)
    adobe = next((a, b) for m, a, b in segments(rgb) if m == 0xEE)
    no_adobe = rgb[:adobe[0]] + rgb[adobe[1]:]
    assert jpeg.parse(no_adobe).rgb
    assert_as_cv2(no_adobe)
    jfif = with_segment(rgb, 0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    assert not jpeg.parse(jfif).rgb
    assert_as_cv2(jfif)


@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation(orientation):
    """cv2 turns a grayscale read (a mask) by the EXIF orientation, and
    leaves an IMREAD_UNCHANGED read (an image) as stored; 0 and 9 are not
    orientations.  Little-endian EXIF written by PIL, big-endian built
    here."""
    img = photo(np.random.default_rng(orientation), 20, 31)
    ex = Image.Exif()
    ex[0x0112] = orientation
    assert_as_cv2(pil_jpeg(img, quality=90, exif=ex.tobytes()))
    assert_as_cv2(with_segment(cv_jpeg(img), 0xE1, exif(orientation, big_endian=True)))
    turned = jpeg.decode_jpeg(pil_jpeg(img, exif=ex.tobytes()), grayscale=True, impl="plain")
    assert turned.shape == ((31, 20) if orientation in (5, 6, 7, 8) else (20, 31))


def test_block_smoothing_refused_and_complete_ac_decoded():
    """libjpeg smooths the blocks of a progressive file whose scans leave
    AC coefficients 1-9 unknown (jdcoefct.c:smoothing_ok): the port raises
    for it.  A file missing only its DC refinement has every AC bit known,
    is not smoothed, and decodes as cv2 decodes it."""
    data = cv_jpeg(photo(np.random.default_rng(4), 40, 48), 90, "420", progressive=True)
    n = sum(m == 0xDA for m, _, _ in segments(data))
    assert n == 10  # libjpeg's default progression for YCbCr
    no_last = drop_scans(data, {n - 1})  # the final luma AC refinement
    assert cv2_read(no_last, False) is not None
    with pytest.raises(NotImplementedError, match="block-smooths"):
        jpeg.decode_jpeg(no_last, impl="plain")
    no_dc_refine = drop_scans(data, {6})
    assert jpeg.parse(no_dc_refine).coef_bits[0][0] == 1
    assert_as_cv2(no_dc_refine)


@pytest.mark.parametrize("marker,what", [(0xC9, "arithmetic"), (0xCA, "arithmetic"),
                                         (0xC3, "lossless"), (0xC5, "hierarchical")])
def test_unsupported_processes_raise(marker, what):
    data = bytearray(cv_jpeg(photo(np.random.default_rng(0), 16, 16)))
    sof = next(a for m, a, _ in segments(bytes(data)) if m == 0xC0)
    data[sof + 1] = marker
    with pytest.raises(NotImplementedError, match=what):
        jpeg.decode_jpeg(bytes(data), impl="plain")


def test_twelve_bit_and_cmyk_raise():
    data = bytearray(cv_jpeg(photo(np.random.default_rng(0), 16, 16)))
    sof = next(a for m, a, _ in segments(bytes(data)) if m == 0xC0)
    data[sof + 4] = 12
    with pytest.raises(NotImplementedError, match="12-bit"):
        jpeg.decode_jpeg(bytes(data), impl="plain")
    cmyk = io.BytesIO()
    Image.fromarray(photo(np.random.default_rng(0), 16, 16)).convert("CMYK").save(cmyk, "JPEG")
    with pytest.raises(NotImplementedError, match="CMYK"):
        jpeg.decode_jpeg(cmyk.getvalue(), impl="plain")


def test_corrupt_and_truncated_data_raise():
    data = cv_jpeg(photo(np.random.default_rng(1), 32, 32), 90, rst=1)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"GIF89a" + data, impl="plain")
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(data[:len(data) // 2], impl="plain")
    with pytest.raises(ValueError, match="before EOI|no EOI"):
        jpeg.decode_jpeg(data[:-2], impl="plain")
    # the entropy-coded bytes of the first interval made all ones (FF 00):
    # 16 one bits are no code of any table
    sos = next(a for m, a, _ in segments(data) if m == 0xDA)
    (length,) = struct.unpack(">H", data[sos + 2:sos + 4])
    body = sos + 2 + length
    rst0 = data.index(b"\xff\xd0", body)
    bad = data[:body] + b"\xff\x00" * ((rst0 - body) // 2 + 1) + data[rst0:]
    with pytest.raises(ValueError, match="Huffman code"):
        jpeg.decode_jpeg(bad, impl="plain")
    swapped = data.replace(b"\xff\xd0", b"\xff\xd1", 1)
    with pytest.raises(ValueError, match="restart markers"):
        jpeg.decode_jpeg(swapped, impl="plain")


@settings(max_examples=25, deadline=None, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), samp=st.sampled_from(list(SAMPLING)),
       progressive=st.booleans(), quality=st.integers(30, 100), seed=st.integers(0, 2 ** 16))
def test_random_sizes_and_sampling(h, w, samp, progressive, quality, seed):
    assert_as_cv2(cv_jpeg(photo(np.random.default_rng(seed), h, w), quality, samp, progressive))


# ---------------------------------------------------------------------------
# routing, the data layer, the fixtures


def test_native_arguments_describe_the_scans():
    """The flat arrays the native entry takes: one row a scan, the restart
    intervals' byte ranges inside the concatenated data, a table row a DHT
    snapshot, a component row with the plane sizes."""
    data = cv_jpeg(photo(np.random.default_rng(6), 33, 47), 90, "420", True, 2)
    f = jpeg.parse(data)
    a = jpeg.native_arguments(f, grayscale=False)
    assert a["scans"].shape == (len(f.scans), jpeg.SCAN_FIELDS)
    assert a["comps"].shape == (3, jpeg.COMP_FIELDS) and a["qt"].shape == (3, 64)
    assert a["channels"] == 3 and a["color"] == jpeg.YCC_TO_RGB
    assert a["intervals"][-1, 1] + 8 == len(a["data"])
    assert (a["intervals"][:, 0] <= a["intervals"][:, 1]).all()
    assert a["tables"].shape[1] == 272
    g = jpeg.native_arguments(f, grayscale=True)
    assert g["channels"] == 1 and g["comps"][:, 6].tolist() == [1, 0, 0]


def test_default_impl_follows_cuda_and_native_never_falls_back(monkeypatch):
    """impl=None takes the plain decoder on a machine without CUDA and the
    native one with it; where the native library cannot be built (a
    `load_library` that raises stands in) a native read raises and does not
    decode in Python."""
    import torch

    from qflux_tpu_torch.runtime import build

    data = cv_jpeg(photo(np.random.default_rng(0), 16, 16))
    assert jpeg.default_impl() == ("native" if torch.cuda.is_available() else "plain")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert jpeg.default_impl() == "native"

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "load_library", no_library)
    for read in (lambda: jpeg.decode_jpeg(data), lambda: jpeg.decode_jpeg(data, impl="native")):
        with pytest.raises(RuntimeError, match="nvcc"):
            read()
    with pytest.raises(ValueError, match="impl"):
        jpeg.decode_jpeg(data, impl="cv2")


def test_data_layer_reads_jpeg_and_bmp_without_cv2_or_pil(tmp_path, monkeypatch):
    """The contract of the card's machine: with cv2 and PIL absent,
    `_read_image` and `_read_mask` decode JPEG and BMP, equal to what cv2
    gave for the same files, the mask turned by its EXIF orientation."""
    img = photo(np.random.default_rng(8), 21, 34)
    ex = Image.Exif()
    ex[0x0112] = 6
    (tmp_path / "a.jpg").write_bytes(pil_jpeg(img, quality=90, exif=ex.tobytes()))
    cv2.imwrite(str(tmp_path / "b.bmp"), img[:, :, ::-1])
    want = {p: (cv2_read((tmp_path / p).read_bytes(), False),
                cv2_read((tmp_path / p).read_bytes(), True)) for p in ("a.jpg", "b.bmp")}
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for p, (image, mask) in want.items():
        np.testing.assert_array_equal(tdataset._read_image(tmp_path / p), image)
        np.testing.assert_array_equal(tdataset._read_mask(tmp_path / p), mask)
    assert tdataset._read_mask(tmp_path / "a.jpg").shape == (34, 21)


def test_signature_not_extension_picks_the_decoder(tmp_path):
    """A JPEG named .png and a BMP named .jpg decode by what they are."""
    img = photo(np.random.default_rng(4), 12, 10)
    (tmp_path / "jpeg.png").write_bytes(cv_jpeg(img))
    cv2.imwrite(str(tmp_path / "real.bmp"), img)
    (tmp_path / "bmp.jpg").write_bytes((tmp_path / "real.bmp").read_bytes())
    np.testing.assert_array_equal(tdataset._read_image(tmp_path / "jpeg.png"),
                                  cv2_read(cv_jpeg(img), False))
    np.testing.assert_array_equal(tdataset._read_image(tmp_path / "bmp.jpg"), img[:, :, ::-1])
    (tmp_path / "x.gif").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(NotImplementedError, match="this format is not decoded"):
        tdataset._read_image(tmp_path / "x.gif")


DIGESTS = json.loads((FIXTURES / "digests.json").read_text())


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_digests(name):
    """The digests chip_smoke.py holds the card's decodes to: each file is
    the one they were taken of, cv2 here gives the same arrays, and so do
    the port's plain decoders (a colour PNG's mask excepted: the port's PNG
    gray conversion is within one step of cv2's libpng, by design)."""
    want = DIGESTS[name]
    path = FIXTURES / name
    data = path.read_bytes()
    assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    assert len(data) == want["bytes"]

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for mode, grayscale in (("unchanged", False), ("grayscale", True)):
        theirs = cv2_read(data, grayscale)
        assert list(theirs.shape) == want[f"{mode}_shape"]
        assert digest(theirs) == want[f"{mode}_sha256"]
        if name.endswith(".jpg"):
            ours = jpeg.decode_jpeg(data, grayscale, impl="plain")
        elif name.endswith(".bmp"):
            ours = bmp.decode_bmp(data, grayscale)
        elif not grayscale:
            ours = png.decode_png(data)
        else:
            assert np.abs(tdataset._read_mask(path).astype(int) - theirs).max() <= 1
            continue
        assert digest(ours) == want[f"{mode}_sha256"], (name, mode)


def test_fixtures_stay_small():
    assert sum(v["bytes"] for v in DIGESTS.values()) < 1_000_000
    assert {n.rsplit(".", 1)[1] for n in DIGESTS} == {"jpg", "bmp", "png"}
