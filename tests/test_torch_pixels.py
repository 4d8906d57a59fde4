"""The port's pixel path (qflux_tpu_torch/data/preprocess.py:_resize and
ImageProcessor.process_image / preprocess, utils/png.py:decode_png,
data/dataset.py:_read_image / _read_mask) against cv2 and the JAX package
on the CPU.

Bounds: "bilinear", "nearest" and "area" resampling equal cv2.resize to
the bit (area's non-integer shrinks too, Qwen-Image-Edit-Plus's condition
images among them); "bicubic" within one uint8 step of it, the share of
pixels that differ printed and held to 6% (measured 4.2% over the cases
below: cv2's vector paths round an f32 sum, the port an exact one);
the PNG decoder equal to cv2.imread for every color type and filter; a
color mask within one step of cv2's grayscale read (libpng converts in
linear light), a gray one to the bit.
"""

from __future__ import annotations

import itertools
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from qflux_tpu.data import dataset as jdataset
from qflux_tpu.data import preprocess as jpre
from qflux_tpu_torch.data import dataset as tdataset
from qflux_tpu_torch.data import preprocess as tpre
from qflux_tpu_torch.utils import png

CV2 = {"bilinear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST,
       "bicubic": cv2.INTER_CUBIC, "area": cv2.INTER_AREA}
DIFF_SHARE = {"bicubic": 0.06}
EXACT = ("bilinear", "nearest", "area")
SRC = [(37, 53), (64, 64), (100, 75), (300, 200), (17, 9), (1000, 750)]
DST = [(16, 16), (33, 21), (48, 64), (250, 180), (512, 512), (500, 375), (1024, 768)]


@pytest.mark.parametrize("mode", list(CV2))
def test_resize_matches_cv2(mode):
    """Odd, upscaling, downscaling and integer-factor sizes (2x, 4x), RGB
    and gray."""
    rng = np.random.default_rng(list(CV2).index(mode))
    worst, n_diff, n = 0, 0, 0
    cases = list(itertools.product(SRC, DST)) + [((512, 512), (256, 256)),
                                                 ((512, 768), (128, 192))]
    for (h, w), (oh, ow) in cases:
        for shape in ((h, w, 3), (h, w)):
            img = rng.integers(0, 256, shape, dtype=np.uint8)
            want = cv2.resize(img, (ow, oh), interpolation=CV2[mode])
            got = tpre._resize(img, ow, oh, mode)
            assert got.dtype == np.uint8 and got.shape == want.shape
            d = np.abs(got.astype(np.int64) - want)
            worst, n_diff, n = max(worst, int(d.max())), n_diff + int((d > 0).sum()), n + d.size
    share = n_diff / n
    print(f"{mode}: max |diff| {worst}, {100 * share:.3f}% of {n} values differ")
    if mode in EXACT:
        assert worst == 0
    else:
        assert worst <= 1 and share <= DIFF_SHARE[mode]


@pytest.mark.parametrize("src", [(512, 512), (1024, 1024), (832, 576), (640, 480), (100, 77)])
def test_area_shrink_by_a_non_integer_factor_matches_cv2(src):
    """INTER_AREA where the factor is not an integer (cv2's f32 area sums,
    not its block average): Qwen-Image-Edit-Plus's condition images
    (`qwen_edit_plus.resize_condition_image`: 512² → 384², a factor of 4/3,
    and 832×576 → 448×320) and other odd shrinks, RGB and gray, on random,
    gradient and four-level images (whose sums land on halves most often):
    equal to the bit."""
    from qflux_tpu_torch.trainer.qwen_edit_plus import resize_condition_image

    rng = np.random.default_rng(src[0] + src[1])
    h, w = src
    yy, xx = np.mgrid[0:h, 0:w]
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
              np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1), (xx + yy) % 256],
                       -1).astype(np.uint8),
              (rng.integers(0, 4, (h, w)) * 85).astype(np.uint8)]
    for img in images:
        small = resize_condition_image(img)
        sh, sw = small.shape[:2]
        assert sh * sw <= 384 * 384 and sh % 32 == sw % 32 == 0
        for oh, ow in {(sh, sw), (h * 3 // 4 + 1, w * 2 // 3 + 1), (h // 3 + 2, w // 5 + 3)}:
            want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA)
            np.testing.assert_array_equal(tpre._resize(img, ow, oh, "area"), want)


def test_resize_refuses_what_cv2_would_not_give_bits_for():
    with pytest.raises(ValueError, match="uint8"):
        tpre._resize(np.zeros((8, 8, 3), np.float32), 4, 4)
    with pytest.raises(KeyError):
        tpre._resize(np.zeros((8, 8, 3), np.uint8), 4, 4, "lanczos")


PROCESSORS = [
    {},
    {"process_type": "resize", "target_size": [48, 80], "controls_size": [[32, 32], None],
     "divisible_by": 16},
    {"process_type": "center_crop", "target_size": [64, 48]},
    {"process_type": "center_padding", "target_size": [64, 64], "resize_mode": "nearest"},
    {"process_type": "right_padding", "target_size": [48, 96]},
    {"process_type": "fixed_pixels", "target_pixels": "64*64", "controls_pixels": [None, 2048]},
    {"multi_resolutions": [[64, 64], [96, 64], [64, 96]]},
    {"multi_resolutions": {"target": [[64, 64], [96, 64]], "controls": [[[32, 32]], [[64, 64]]]},
     "resize_mode": "area"},
]


@pytest.mark.parametrize("i", range(len(PROCESSORS)))
def test_process_image_and_preprocess_match_jax(i):
    """process_image for the target and three controls, and preprocess of a
    sample with a mask and two extra controls, against the JAX package's
    (cv2 inside) in every process_type: equal to the bit (bilinear, nearest
    and area)."""
    kw = dict(PROCESSORS[i])
    if not kw:
        kw = {"target_size": [64, 64]}
    j = jpre.ImageProcessor(jpre.ProcessorSection(**kw))
    t = tpre.ImageProcessor(**kw)
    rng = np.random.default_rng(i)
    exact = t.config.resize_mode in EXACT

    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        assert d.max(initial=0) <= (0 if exact else (1.0 if a.dtype == np.uint8 else 1 / 255)
                                    + 1e-7)

    for kind in ("target", "control_0", "control_1", "control_2"):
        for shape in ((70, 90, 3), (120, 61, 3), (50, 50)):
            img = rng.integers(0, 256, shape, dtype=np.uint8)
            same(t.process_image(img, kind), j.process_image(img, kind))
    sample = {"image": rng.integers(0, 256, (81, 67, 3), dtype=np.uint8),
              "mask": rng.integers(0, 256, (81, 67), dtype=np.uint8),
              "control": rng.integers(0, 256, (60, 100, 3), dtype=np.uint8),
              "controls": [rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)] * 2,
              "prompt": "p"}
    got, want = t.preprocess(sample), j.preprocess(sample)
    assert sorted(got) == sorted(want) and got["prompt"] == "p"
    for k in ("image", "mask", "control"):
        same(got[k], want[k])
    assert len(got["controls"]) == 2
    for a, b in zip(got["controls"], want["controls"]):
        same(a, b)
    assert t.bucket_key(got) == j.bucket_key(want)


# ---------------------------------------------------------------------------
# PNG decoding and image reading

FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE, "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP, "avg": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH}


def _photo(rng, h, w, c):
    """Smooth gradients plus noise: the filters then matter."""
    y, x = np.mgrid[:h, :w]
    base = np.stack([(x * 3 + y * k) % 256 for k in range(1, c + 1)], axis=-1)
    img = (base + rng.integers(0, 20, (h, w, c))).clip(0, 255).astype(np.uint8)
    return img[:, :, 0] if c == 1 else img


@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_matches_cv2(tmp_path, channels, filt):
    """PNGs written by cv2 with one filter each, gray / RGB / RGBA: decoded
    equal to cv2.imread(IMREAD_UNCHANGED) (BGR(A) turned to RGB(A))."""
    img = _photo(np.random.default_rng(channels), 37, 53, channels)
    bgr = img if channels == 1 else img[:, :, [2, 1, 0, 3][:channels]]
    path = tmp_path / "x.png"
    assert cv2.imwrite(str(path), bgr, [cv2.IMWRITE_PNG_FILTER, FILTERS[filt]])
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    want = want if channels == 1 else want[:, :, [2, 1, 0, 3][:channels]]
    np.testing.assert_array_equal(png.read_png(path), want)
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_decoder_matches_pil(tmp_path, mode):
    """PNGs written by PIL (its adaptive filter choice: rows of every
    type), gray + alpha included, and by the port's own encoder."""
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    rng = np.random.default_rng(c)
    img = rng.integers(0, 256, (29, 31, c), dtype=np.uint8)
    img[:, :15] = _photo(rng, 29, 15, c).reshape(29, 15, c)
    img = img[:, :, 0] if c == 1 else img
    Image.fromarray(img, mode).save(tmp_path / "pil.png", optimize=True)
    np.testing.assert_array_equal(png.read_png(tmp_path / "pil.png"), img)
    np.testing.assert_array_equal(png.decode_png(png.encode_png(img)), img)


def test_png_decoder_refuses_what_it_does_not_decode(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    Image.fromarray(img).convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="color type 3"):
        png.read_png(tmp_path / "p.png")
    cv2.imwrite(str(tmp_path / "w.png"), np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(tmp_path / "w.png")
    data = bytearray(png.encode_png(img))
    data[-1] ^= 1  # the IEND chunk's CRC
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))
    with pytest.raises(ValueError, match="past the end"):
        png.decode_png(bytes(data[:-20]))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")


@pytest.mark.parametrize("ext,channels", [(".png", 1), (".png", 2), (".png", 3), (".png", 4),
                                          (".jpg", 1), (".jpg", 3), (".bmp", 3)])
def test_read_image_matches_jax(tmp_path, ext, channels):
    """_read_image against the JAX package's (cv2.imread UNCHANGED, BGR →
    RGB, alpha dropped): PNG, JPEG and BMP each by the port's own decoder
    (utils/png.py, utils/jpeg.py's plain version, utils/bmp.py); gray +
    alpha PNGs (written by PIL) as three equal channels."""
    img = _photo(np.random.default_rng(channels), 24, 40, channels if channels != 2 else 1)
    path = tmp_path / f"x{ext}"
    if channels == 2:
        Image.fromarray(np.stack([img, 255 - img], -1), "LA").save(path)
    else:
        cv2.imwrite(str(path), img if channels == 1 else img[:, :, [2, 1, 0, 3][:channels]])
    got, want = tdataset._read_image(path), jdataset._read_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_read_mask_matches_cv2_grayscale(tmp_path):
    rng = np.random.default_rng(3)
    gray = _photo(rng, 30, 30, 1)
    cv2.imwrite(str(tmp_path / "g.png"), gray)
    np.testing.assert_array_equal(tdataset._read_mask(tmp_path / "g.png"),
                                  cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_GRAYSCALE))
    color = rng.integers(0, 256, (30, 30, 3), dtype=np.uint8)
    color[:10] = 77  # gray pixels stay as they are
    Image.fromarray(color).save(tmp_path / "c.png")
    got = tdataset._read_mask(tmp_path / "c.png").astype(np.int64)
    want = cv2.imread(str(tmp_path / "c.png"), cv2.IMREAD_GRAYSCALE)
    assert np.abs(got - want).max() <= 1 and (got[:10] == 77).all()


def test_tensor_helpers_match_jax():
    """utils/tensors.py against the JAX package's: layout and range
    inference, the conversion to HWC uint8, batch-field extraction and the
    numeric control-key order."""
    from qflux_tpu.utils import tensors as jt
    from qflux_tpu_torch.utils import tensors as tt

    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 256, (8, 9, 3), dtype=np.uint8), rng.random((3, 8, 9)),
              rng.uniform(-1, 1, (2, 8, 9, 3)), rng.random((2, 4, 8, 9)), rng.random((8, 9)),
              rng.random((5, 6, 7)) * 200, np.zeros((0, 3, 4)), rng.random((2, 3, 4, 5, 6))]
    for a in arrays:
        assert tt.infer_image_tensor(a) == jt.infer_image_tensor(a)
        if a.ndim in (2, 3, 4) and a.size:
            np.testing.assert_array_equal(tt.to_hwc_uint8(a), jt.to_hwc_uint8(a))
    batch = {"prompt": ["a", "b"], "image": arrays[2], "scalar": np.float32(3)}
    for key, idx in (("prompt", 1), ("image", 0), ("image", None), ("scalar", 0), ("x", 0)):
        got, want = tt.extract_batch_field(batch, key, idx), jt.extract_batch_field(batch, key, idx)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    keys = ["control_10", "control", "control_2", "control_1", "image"]
    assert sorted(keys, key=tt.numeric_suffix_key) == sorted(keys, key=jt.numeric_suffix_key)


def test_non_png_without_cv2_names_item_5b(tmp_path, monkeypatch):
    """Without cv2 (the card's machine): a WebP image raises naming the
    format and item 5b; a JPEG, a BMP and a PNG decode, images and masks."""
    cv2.imwrite(str(tmp_path / "x.jpg"), np.zeros((8, 8, 3), np.uint8))
    cv2.imwrite(str(tmp_path / "x.bmp"), np.full((8, 8, 3), 5, np.uint8))
    cv2.imwrite(str(tmp_path / "x.png"), np.full((8, 8, 3), 9, np.uint8))
    cv2.imwrite(str(tmp_path / "x.webp"), np.zeros((8, 8, 3), np.uint8))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(NotImplementedError, match="WebP is not decoded by the port.*item 5b"):
        tdataset._read_image(tmp_path / "x.webp")
    with pytest.raises(NotImplementedError, match="WebP"):
        tdataset._read_mask(tmp_path / "x.webp")
    assert (tdataset._read_image(tmp_path / "x.jpg") == 0).all()
    assert (tdataset._read_image(tmp_path / "x.bmp") == 5).all()
    assert tdataset._read_mask(tmp_path / "x.jpg").shape == (8, 8)
    assert (tdataset._read_image(tmp_path / "x.png") == 9).all()
    with pytest.raises(FileNotFoundError):
        tdataset._read_image(tmp_path / "missing.png")
