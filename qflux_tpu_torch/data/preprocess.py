"""The resolution policy: which (H, W) each image of a sample becomes.

Counterpart of qflux_tpu/data/preprocess.py for the geometry the loader's
buckets need: the fixed-pixel-budget factorization (`count_hw_pairs`,
`best_area_near`, `best_hw_given_area`), `calculate_best_resolution`, and
`ImageProcessor`'s multi-resolution candidates (a list, or a per-type dict
{target, controls}) with the max-aspect-ratio guard, its per-kind sizes and
budgets, `output_shape` (the processed (H, W) from the source dimensions
alone) and `bucket_key`.  Every resolution it can emit is a bucket: one
static shape a train step runs at.

Resampling pixels (`process_image`, `preprocess`: cv2 in the JAX package)
belongs to the pixel path, which needs the encoders: ROADMAP.md, queue 1
item 5.  The port's training reads the embedding cache.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Mapping, Optional, Sequence

import numpy as np

from qflux_tpu_torch.config import DEFAULTS, parse_pixels

ITEM_5 = "ROADMAP.md, queue 1 item 5: \"Cache pass and encoders\""


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

    # -- pixels: the cache pass's -----------------------------------------------

    def process_image(self, image, kind: str = "target", size=None, pixels=None):
        raise NotImplementedError(f"resampling pixels is not ported yet ({ITEM_5}); "
                                  "train from an embedding cache")

    def preprocess(self, sample: dict) -> dict:
        raise NotImplementedError(f"resampling pixels is not ported yet ({ITEM_5}); "
                                  "train from an embedding cache")

    # -- bucket registry -----------------------------------------------------------

    def bucket_key(self, sample: dict) -> tuple:
        """Static-shape key: (H, W) of the target and of every control."""
        shapes = [tuple(np.asarray(sample["image"]).shape[:2])]
        if "control" in sample:
            shapes.append(tuple(np.asarray(sample["control"]).shape[:2]))
        for c in sample.get("controls", []):
            shapes.append(tuple(np.asarray(c).shape[:2]))
        return tuple(shapes)
