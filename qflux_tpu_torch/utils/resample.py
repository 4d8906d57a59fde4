"""PIL's `Image.resize` for 8-bit images (modes "L" and "RGB"), in numpy.

The JAX package resamples with PIL in two places: the Qwen2.5-VL
processor's bicubic resize (qflux_tpu/models/qwen/vl_encoder.py:
preprocess_image) and the perceptual hash's Lanczos
(qflux_tpu/utils/hashing.py:phash_image).  The card's machine has no PIL,
so this is PIL's uint8 resampler (libImaging/Resample.c) written out:

  * a separable convolution, the horizontal pass first (over the source
    rows the vertical pass reads), its result clipped to uint8 before the
    vertical pass; an axis whose size does not change is not resampled;
  * per output pixel: scale = in / out, the support the filter's times
    max(scale, 1), center = (i + 0.5) · scale, the window
    [int(center − support + 0.5), int(center + support + 0.5)) cut to the
    image, weights filter((x − center + 0.5) / max(scale, 1)) in double,
    divided by their sequential sum;
  * the weights made fixed-point at PRECISION_BITS = 22, rounded half away
    from zero by sign (C's truncating `(int)(w · 2^22 ± 0.5)`); a pixel is
    (2^21 + Σ value · weight) >> 22, clamped to [0, 255].

Bicubic is Keys' cubic at a = −0.5 (support 2), Lanczos the sinc windowed
by sinc(x / 3) (support 3).  `tests/test_torch_qwen_encoders.py` holds it
to PIL to the bit.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 22


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _sinc(x: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore", divide="ignore"):
        px = x * math.pi
        return np.where(x == 0.0, 1.0, np.sin(px) / px)


def _lanczos(x: np.ndarray) -> np.ndarray:
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3), 0.0)


FILTERS = {"bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


def coefficients(in_size: int, out_size: int, method: str):
    """(xmin [out], fixed-point weights [out, ksize] int64) of one axis,
    zero past each window's end (PIL's precompute_coeffs and
    normalize_coeffs_8bpc)."""
    fn, support = FILTERS[method]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) truncates toward zero; both bounds are then cut to the image
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = fn(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):  # PIL's sum runs tap by tap
        ww = ww + w[:, x]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * float(1 << PRECISION_BITS)
    kk = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    return xmin, kk


def _pass(img: np.ndarray, out_size: int, method: str, axis: int) -> np.ndarray:
    """One axis of an [H, W, C] uint8 image resampled to out_size."""
    in_size = img.shape[axis]
    xmin, kk = coefficients(in_size, out_size, method)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    bshape = (out_size,) + (1,) * (src.ndim - 1)
    for x in range(kk.shape[1]):
        idx = np.minimum(xmin + x, in_size - 1)  # a weight past the window is 0
        acc += src[idx] * kk[:, x].reshape(bshape)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(image: np.ndarray, size: tuple[int, int], method: str = "bicubic") -> np.ndarray:
    """uint8 [H, W] or [H, W, C] → [h, w](, C), as
    `np.asarray(Image.fromarray(image).resize((w, h), method))` for modes L
    and RGB.  `size` is (h, w)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"resize takes uint8 images, not {img.dtype}")
    if method not in FILTERS:
        raise ValueError(f"unknown resampling method {method!r} (bicubic | lanczos)")
    gray = img.ndim == 2
    x = img[:, :, None] if gray else img
    h, w = size
    if w != x.shape[1]:
        x = _pass(x, w, method, axis=1)
    if h != x.shape[0]:
        x = _pass(x, h, method, axis=0)
    x = np.ascontiguousarray(x)
    return x[:, :, 0] if gray else x


def to_luma(image: np.ndarray) -> np.ndarray:
    """uint8 RGB(A) [H, W, C] → PIL's "L": ITU-R 601-2 luma in 16-bit fixed
    point, (R·19595 + G·38470 + B·7471 + 0x8000) >> 16; an [H, W] image as
    it is."""
    img = np.asarray(image)
    if img.ndim == 2:
        return img.astype(np.uint8)
    rgb = img[..., :3].astype(np.uint32)
    y = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16
    return y.astype(np.uint8)
