"""The resolution policy and the pixel path: which (H, W) each image of a
sample becomes, and the resampling that makes it so.

Counterpart of qflux_tpu/data/preprocess.py: the fixed-pixel-budget
factorization (`count_hw_pairs`, `best_area_near`, `best_hw_given_area`),
`calculate_best_resolution`, and `ImageProcessor`'s multi-resolution
candidates (a list, or a per-type dict {target, controls}) with the
max-aspect-ratio guard, its per-kind sizes and budgets, `output_shape` (the
processed (H, W) from the source dimensions alone), `bucket_key`, and the
pixels: `process_image` in every process_type (resize, center_crop,
center_padding / right_padding, fixed_pixels, multi-resolution candidates)
and `preprocess` (target, mask, controls).  Every resolution it can emit is
a bucket: one static shape a train step runs at.

The JAX package resamples with cv2.resize; the card's machine has no cv2,
so `_resize` is cv2's uint8 resampling written in numpy:

  * "bilinear" (INTER_LINEAR, the default resize_mode): cv2's fixed-point
    path, 11-bit weights (INTER_RESIZE_COEF_BITS) from the f32 source
    coordinate, the horizontal pass in int32, the vertical one as
    ((b0·(h0 >> 4)) >> 16) + ((b1·(h1 >> 4)) >> 16) + 2) >> 2; the source
    column clamps at the borders with its weight reset, the row does not.
    Equal to cv2 to the bit;
  * "nearest" (INTER_NEAREST): src = min(floor(dst · (1 / (dst_n / src_n))),
    src_n - 1) in double.  Equal to cv2 to the bit;
  * "bicubic" (INTER_CUBIC): cv2's A = -0.75 taps, the weights rounded to
    11 bits, borders replicated, the sum rounded once (cv2's vector path
    rounds an f32 sum): within 1 step of cv2;
  * "area" (INTER_AREA): a block average where the scale is an integer in
    both directions; where it shrinks by another factor (Qwen-Image-Edit-
    Plus's condition images, 512² → 384²), cv2's area-overlap weights in
    f32 summed in cv2's order, a source row's cells first, then the rows
    of each destination row; where it grows, cv2's bilinear emulation (its
    own weights, the fixed-point path).  Equal to cv2 to the bit.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Mapping, Optional, Sequence

import numpy as np

from qflux_tpu_torch.config import DEFAULTS, parse_pixels

ITEM_5B = ("ROADMAP.md, queue 1 item 5b: \"The rest of the pixel path\", whose WebP "
           "images and HF Hub datasets the port does not read")


# ---------------------------------------------------------------------------
# resampling: cv2.resize on uint8, in numpy

INTERPOLATIONS = ("bilinear", "bicubic", "nearest", "area")
_COEF_BITS = 11                 # cv2's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _inv(dst: int, src: int) -> float:
    """cv2's source step: 1 / (dst / src), in double."""
    return 1.0 / (dst / src)


def _fixed(c) -> np.ndarray:
    """f32 weights → cv2's 11-bit integers (saturate_cast<short>: rint)."""
    return np.rint(np.asarray(c, np.float32) * np.float32(_COEF_SCALE)).astype(np.int64)


def _linear_axis(dst: int, src: int, area: bool, column: bool):
    """(i0, i1, w0, w1) of one axis of cv2's two-tap resampling: the source
    index and f32 fraction of each destination index (INTER_LINEAR's
    centre mapping, or INTER_AREA's when it grows), the weights 1 - f and
    f in 11 bits.  A column past either border clamps with its fraction
    reset to 0; a row's indices clamp and keep their fraction."""
    scale = _inv(dst, src)
    d = np.arange(dst, dtype=np.float64)
    if area:
        i = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (i + 1) * (dst / src)).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        i = np.floor(f).astype(np.int64)
        f = (f - i.astype(np.float32)).astype(np.float32)
    if column:
        low, high = i < 0, i >= src - 1
        f = np.where(low | high, np.float32(0), f).astype(np.float32)
        i = np.where(low, 0, np.where(high, src - 1, i))
    i0, i1 = np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1)
    return i0, i1, _fixed(np.float32(1) - f), _fixed(f)


def _resize_linear(img: np.ndarray, w: int, h: int, area: bool) -> np.ndarray:
    c0, c1, a0, a1 = _linear_axis(w, img.shape[1], area, column=True)
    r0, r1, b0, b1 = _linear_axis(h, img.shape[0], area, column=False)
    src = img.astype(np.int64)
    rows = np.unique(np.concatenate([r0, r1]))
    hor = np.zeros((img.shape[0], w) + img.shape[2:], np.int64)
    hor[rows] = (src[rows][:, c0] * a0.reshape(-1, *[1] * (img.ndim - 2))
                 + src[rows][:, c1] * a1.reshape(-1, *[1] * (img.ndim - 2)))
    shape = (-1, 1) + (1,) * (img.ndim - 2)
    out = (((b0.reshape(shape) * (hor[r0] >> 4)) >> 16)
           + ((b1.reshape(shape) * (hor[r1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _nearest_index(dst: int, src: int) -> np.ndarray:
    return np.minimum(np.floor(np.arange(dst) * _inv(dst, src)).astype(np.int64), src - 1)


def _cubic_weights(f: np.ndarray) -> np.ndarray:
    """cv2's interpolateCubic (A = -0.75) in f32 → [n, 4] 11-bit weights."""
    a = np.float32(-0.75)
    one = np.float32(1)
    x = f.astype(np.float32)
    c0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return _fixed(np.stack([c0, c1, c2, c3], axis=1).astype(np.float32))


def _cubic_axis(dst: int, src: int):
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * _inv(dst, src) - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = (f - i.astype(np.float32)).astype(np.float32)
    idx = np.clip(i[:, None] + np.arange(-1, 3)[None, :], 0, src - 1)
    return idx, _cubic_weights(f)


def _resize_cubic(img: np.ndarray, w: int, h: int) -> np.ndarray:
    cx, wx = _cubic_axis(w, img.shape[1])
    ry, wy = _cubic_axis(h, img.shape[0])
    tail = (1,) * (img.ndim - 2)
    src = img.astype(np.int64)
    hor = sum(src[:, cx[:, k]] * wx[:, k].reshape(-1, *tail) for k in range(4))
    ver = sum(hor[ry[:, k]] * wy[:, k].reshape(-1, 1, *tail) for k in range(4))
    out = np.rint(ver.astype(np.float64) / float(_COEF_SCALE * _COEF_SCALE))
    return np.clip(out, 0, 255).astype(np.uint8)


def _area_table(dst: int, src: int) -> tuple[np.ndarray, np.ndarray]:
    """cv2's computeResizeAreaTab: per destination index its source indices
    [dst, n] and f32 area-overlap weights [dst, n], in cv2's order (the
    partial first cell, the whole cells, the partial last cell), padded
    with weight 0."""
    scale = _inv(dst, src)
    rows = []
    for d in range(dst):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, src - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        row = [(s1 - 1, (s1 - fs1) / cell)] if s1 - fs1 > 1e-3 else []
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            row.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
        rows.append(row)
    n = max(len(r) for r in rows)
    idx = np.zeros((dst, n), np.int64)
    alpha = np.zeros((dst, n), np.float32)
    for d, row in enumerate(rows):
        idx[d, :len(row)] = [i for i, _ in row]
        alpha[d, :len(row)] = [a for _, a in row]  # each weight rounded to f32, as cv2
    return idx, alpha


def _resize_area(img: np.ndarray, w: int, h: int) -> np.ndarray:
    sh, sw = img.shape[:2]
    sx, sy = _inv(w, sw), _inv(h, sh)
    if sx < 1 or sy < 1:  # growing in a direction: cv2's bilinear emulation
        return _resize_linear(img, w, h, area=True)
    ix, iy = int(round(sx)), int(round(sy))
    if abs(sx - ix) < np.finfo(float).eps and abs(sy - iy) < np.finfo(float).eps:
        blocks = img[: h * iy, : w * ix].astype(np.int64).reshape(
            h, iy, w, ix, *img.shape[2:]).sum(axis=(1, 3))
        if ix == iy == 2:
            return ((blocks + 2) >> 2).astype(np.uint8)
        out = np.rint(blocks.astype(np.float32) * np.float32(1.0 / (ix * iy)))
        return np.clip(out, 0, 255).astype(np.uint8)
    # cv2's resizeArea_<uchar, float>: each source row's f32 sum of
    # products over its table in order, then each destination row's f32
    # sum of weighted source rows in order, rounded half to even
    cx, wx = _area_table(w, sw)
    cy, wy = _area_table(h, sh)
    tail = (1,) * (img.ndim - 2)
    src = img.astype(np.float32)
    rows = np.zeros((sh, w) + img.shape[2:], np.float32)
    for j in range(cx.shape[1]):
        rows = rows + src[:, cx[:, j]] * wx[:, j].reshape(1, -1, *tail)
    out = np.zeros((h, w) + img.shape[2:], np.float32)
    for j in range(cy.shape[1]):
        out = out + wy[:, j].reshape(-1, 1, *tail) * rows[cy[:, j]]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _resize(img: np.ndarray, w: int, h: int, interp: str = "bilinear") -> np.ndarray:
    """uint8 [H, W] or [H, W, C] → [h, w(, C)], as cv2.resize(img, (w, h),
    interpolation=...) (the module docstring says how close)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"_resize takes uint8 images, got {img.dtype}")
    if interp not in INTERPOLATIONS:
        raise KeyError(interp)
    if img.shape[:2] == (h, w):
        return img.copy()
    if interp == "nearest":
        return img[_nearest_index(h, img.shape[0])][:, _nearest_index(w, img.shape[1])]
    if interp == "bicubic":
        return _resize_cubic(img, w, h)
    if interp == "area":
        return _resize_area(img, w, h)
    return _resize_linear(img, w, h, area=False)


# ---------------------------------------------------------------------------
# fixed-pixel-budget factorization

def count_hw_pairs(area: int, min_side=256, max_side=2048, step=16, max_examples=12):
    """Ordered (H, W) pairs with H*W == area, step-divisible, side-bounded."""
    base = step * step
    if area % base:
        return 0, []
    n = area // base
    count, examples = 0, []
    for a in range(1, n + 1):
        if n % a:
            continue
        b = n // a
        H, W = step * a, step * b
        if min_side <= H <= max_side and min_side <= W <= max_side:
            count += 1
            if len(examples) < max_examples:
                examples.append((H, W))
    return count, examples


def best_area_near(area: int, tol=0.20, min_side=256, max_side=2048, step=16,
                   max_examples=12) -> Optional[dict]:
    """Area within ±tol of `area` with the most step-divisible (H, W)
    factorizations; ties → smaller relative error → smaller area."""
    if area <= 0:
        raise ValueError("area must be positive")
    base = step * step
    lo, hi = math.ceil(area * (1 - tol)), math.floor(area * (1 + tol))
    a = ((lo + base - 1) // base) * base
    best = None
    while a <= hi:
        cnt, exs = count_hw_pairs(a, min_side, max_side, step, max_examples)
        if cnt > 0:
            item = (-cnt, abs(a - area) / area, a, exs)
            if best is None or item[:3] < best[:3]:
                best = item
        a += base
    if best is None:
        return None
    return {"best_area": best[2], "count": -best[0], "relative_error": best[1],
            "examples": best[3]}


def best_hw_given_area(area: int, w: int, h: int, step: int = 16,
                       min_side: Optional[int] = None,
                       max_side: Optional[int] = None) -> Optional[tuple[int, int]]:
    """(new_w, new_h) with new_w*new_h == area, step-divisible, aspect ratio
    closest to w/h (log distance; ties → L1 to the original → smaller max
    side)."""
    base = step * step
    if area % base:
        return None
    n = area // base
    target = w / h
    best = None
    for a in range(1, n + 1):
        if n % a:
            continue
        b = n // a
        nh, nw = step * a, step * b
        if min_side is not None and (nw < min_side or nh < min_side):
            continue
        if max_side is not None and (nw > max_side or nh > max_side):
            continue
        score = (abs(math.log((nw / nh) / target)), abs(nw - w) + abs(nh - h),
                 max(nw, nh), nw, nh)
        if best is None or score < best:
            best = score
    return None if best is None else (best[3], best[4])


def calculate_best_resolution(width: int, height: int, pixels: int,
                              divisor: int = 32) -> tuple[int, int]:
    """Aspect-preserving (w, h) near `pixels` in total, divisor-rounded."""
    ratio = width / height
    w = math.sqrt(pixels * ratio)
    return round(w / divisor) * divisor, round(w / ratio / divisor) * divisor


# ---------------------------------------------------------------------------
# processor

def processor_config(config=None, **overrides) -> SimpleNamespace:
    """data.processor as a namespace: `config` (a namespace or a dict, else
    the JAX ProcessorSection's defaults) with `overrides`, pixel budgets
    parsed as ProcessorSection's validators parse them."""
    if isinstance(config, SimpleNamespace):
        config = vars(config)
    raw = {**DEFAULTS["data"]["processor"], **(config or {}), **overrides}
    unknown = sorted(set(raw) - set(DEFAULTS["data"]["processor"]))
    if unknown:
        raise ValueError(f"unknown data.processor keys {unknown}")
    raw["target_pixels"] = parse_pixels(raw["target_pixels"])
    if raw["controls_pixels"] is not None:
        raw["controls_pixels"] = [parse_pixels(x) for x in raw["controls_pixels"]]
    return SimpleNamespace(**raw)


class ImageProcessor:
    def __init__(self, config=None, **overrides):
        self.config = processor_config(config, **overrides)
        self._parse_multi_res()

    # -- multi-res candidates ------------------------------------------------

    def _parse_multi_res(self):
        mr = self.config.multi_resolutions
        if mr is None:
            self.multi_res_target = None
            self.multi_res_controls = None
        elif isinstance(mr, list):
            pix = [self._as_pixels(c) for c in mr]
            self.multi_res_target = pix
            self.multi_res_controls = [pix]
        elif isinstance(mr, Mapping):
            tgt = mr.get("target", (mr.get("controls") or [[]])[0])
            self.multi_res_target = [self._as_pixels(c) for c in tgt]
            ctls = mr.get("controls", [tgt])
            self.multi_res_controls = [[self._as_pixels(c) for c in cl] for cl in ctls]
        else:
            raise ValueError(f"multi_resolutions must be list or dict, got {type(mr)}")

    @staticmethod
    def _as_pixels(cand) -> int:
        """A candidate is [H, W] or a pixel count."""
        if isinstance(cand, (list, tuple)):
            return int(cand[0]) * int(cand[1])
        return int(cand)

    def candidates_for(self, kind: str) -> Optional[list[int]]:
        if kind == "target":
            return self.multi_res_target
        if kind.startswith("control"):
            if not self.multi_res_controls:
                return None
            idx = int(kind.split("_")[1]) if "_" in kind else 0
            return self.multi_res_controls[idx % len(self.multi_res_controls)]
        return None

    def select_pixels(self, orig_w: int, orig_h: int, candidates: Sequence[int]) -> int:
        ratio = orig_w / orig_h
        mar = self.config.max_aspect_ratio
        if mar is not None and (ratio > mar or ratio < 1.0 / mar):
            raise ValueError(
                f"image aspect ratio {ratio:.2f} exceeds max_aspect_ratio {mar:.2f}")
        area = orig_w * orig_h
        errs = [abs(c - area) / area for c in candidates]
        return candidates[int(np.argmin(errs))]

    # -- per-kind sizes --------------------------------------------------------

    def _size_for(self, kind):
        cfg = self.config
        if kind == "target":
            return cfg.target_size
        idx = int(kind.split("_")[1]) if "_" in kind else 0
        if cfg.controls_size and idx < len(cfg.controls_size) and cfg.controls_size[idx]:
            return cfg.controls_size[idx]
        return cfg.target_size

    def _pixels_for(self, kind):
        cfg = self.config
        if kind == "target":
            return cfg.target_pixels
        idx = int(kind.split("_")[1]) if "_" in kind else 0
        if cfg.controls_pixels and idx < len(cfg.controls_pixels) and cfg.controls_pixels[idx]:
            return cfg.controls_pixels[idx]
        return cfg.target_pixels

    def make_divisible(self, size) -> tuple[int, int]:
        h, w = size
        d = self.config.divisible_by
        return (h // d) * d, (w // d) * d

    def output_shape(self, orig_h: int, orig_w: int, kind: str = "target") -> tuple[int, int]:
        """Processed (H, W) from the source dimensions alone, branch for
        branch as the JAX package's `process_image` resizes."""
        cfg = self.config
        cands = self.candidates_for(kind)
        if cands:
            best = self.select_pixels(orig_w, orig_h, cands)
            nw, nh = calculate_best_resolution(orig_w, orig_h, best)
            return nh, nw
        if cfg.process_type == "fixed_pixels":
            pixels = int(self._pixels_for(kind) / (32 * 32)) * (32 * 32)
            hw = best_hw_given_area(pixels, orig_w, orig_h)
            if hw is None:
                raise ValueError(f"no 16-divisible factorization of {pixels}")
            return hw[1], hw[0]
        # resize / center_crop / *_padding all emit the divisor-rounded
        # configured size whatever the input's
        return self.make_divisible(self._size_for(kind))

    # -- pixels ------------------------------------------------------------------

    def process_image(self, image: np.ndarray, kind: str = "target",
                      size: Optional[Sequence[int]] = None,
                      pixels: Optional[int] = None) -> np.ndarray:
        """One uint8 image resampled by its kind's policy, branch for branch
        as the JAX package's."""
        cfg = self.config
        cands = self.candidates_for(kind)
        if cands:
            h, w = image.shape[:2]
            best = self.select_pixels(w, h, cands)
            nw, nh = calculate_best_resolution(w, h, best)
            return _resize(image, nw, nh, cfg.resize_mode)
        if size is None:
            size = self._size_for(kind)
        if pixels is None:
            pixels = self._pixels_for(kind)
        if cfg.process_type == "resize":
            th, tw = self.make_divisible(size)
            return _resize(image, tw, th, cfg.resize_mode)
        if cfg.process_type == "center_crop":
            return self._center_crop(image, self.make_divisible(size))
        if cfg.process_type.endswith("_padding"):
            return self._padding(image, self.make_divisible(size))
        if cfg.process_type == "fixed_pixels":
            return self._fixed_pixels(image, pixels)
        return self._center_crop(image, self.make_divisible(size))

    def _center_crop(self, image, size):
        h, w = image.shape[:2]
        th, tw = size
        scale = min(w / tw, h / th)
        nw, nh = int(tw * scale), int(th * scale)
        x0, y0 = (w - nw) // 2, (h - nh) // 2
        return _resize(image[y0:y0 + nh, x0:x0 + nw], tw, th, self.config.resize_mode)

    def _padding(self, image, size):
        h, w = image.shape[:2]
        th, tw = size
        scale = min(tw / w, th / h)
        nw, nh = int(w * scale), int(h * scale)
        resized = _resize(image, nw, nh, self.config.resize_mode)
        shape = (th, tw) if image.ndim == 2 else (th, tw, image.shape[2])
        out = np.zeros(shape, dtype=image.dtype)
        if self.config.process_type == "right_padding":
            x0, y0 = 0, (th - nh) // 2
        else:
            x0, y0 = (tw - nw) // 2, (th - nh) // 2
        out[y0:y0 + nh, x0:x0 + nw] = resized
        return out

    def _fixed_pixels(self, image, pixels):
        h, w = image.shape[:2]
        pixels = int(pixels / (32 * 32)) * (32 * 32)
        hw = best_hw_given_area(pixels, w, h)
        if hw is None:
            raise ValueError(f"no 16-divisible factorization of {pixels}")
        nw, nh = hw
        return _resize(image, nw, nh, self.config.resize_mode)

    def preprocess(self, sample: dict) -> dict:
        """{image, mask?, control?, controls?}: each by its own policy; the
        mask follows the target and becomes f32 in [0, 1]."""
        out = dict(sample)
        if "image" in out:
            out["image"] = self.process_image(np.asarray(out["image"]), "target")
        if "mask" in out:
            m = self.process_image(np.asarray(out["mask"]), "target")
            out["mask"] = m.astype(np.float32) / 255.0
        if "control" in out:
            out["control"] = self.process_image(np.asarray(out["control"]), "control_0")
        if "controls" in out:
            out["controls"] = [self.process_image(np.asarray(c), f"control_{i + 1}")
                               for i, c in enumerate(out["controls"])]
        return out

    # -- bucket registry -----------------------------------------------------------

    def bucket_key(self, sample: dict) -> tuple:
        """Static-shape key: (H, W) of the target and of every control."""
        shapes = [tuple(np.asarray(sample["image"]).shape[:2])]
        if "control" in sample:
            shapes.append(tuple(np.asarray(sample["control"]).shape[:2]))
        for c in sample.get("controls", []):
            shapes.append(tuple(np.asarray(c).shape[:2]))
        return tuple(shapes)
