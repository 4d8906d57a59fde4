"""Edit-triplet dataset (target image, control images, prompt, optional
mask) over local folders and CSV files, fed from the embedding cache.

Counterpart of qflux_tpu/data/dataset.py:
  * the local-folder layout with alias directory names and the
    `stem_control_N` / `stem_mask` / `stem.txt` conventions, scanned in the
    same order;
  * CSV sources with path_target / path_control_N / prompt / path_mask
    columns, read with the stdlib `csv` module into the values
    `pandas.read_csv` gives the JAX package (an empty cell, or one of
    pandas' NA strings, is NaN: an empty prompt becomes "nan");
  * the per-sample content hashes that key the cache (`file_hashes`, byte
    for byte);
  * the cached item with conditioning dropout, its draws keyed by (seed,
    sample index, visit) as in JAX, so they repeat JAX's on every visit
    whatever order the loader's threads fetch in;
  * a sample the cache does not hold (or every sample, with the cache off):
    its images read (`_read_image`, `_read_mask`: as the JAX package's
    cv2.imread reads them, by the port's own decoders, chosen by the
    file's signature as cv2 chooses: PNG utils/png.py, JPEG utils/jpeg.py,
    BMP utils/bmp.py), resampled by the processor, and returned as pixels
    with `drop_context` for the Trainer to encode.

A WebP image, or any other format, raises NotImplementedError, and so does
an HF Hub dataset (it needs the network and the `datasets` package); both
name ROADMAP.md queue 1 item 5b.  Batching is data/loader.py's.
"""

from __future__ import annotations

import csv
import glob
import logging
import os
import re
import threading
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np

from qflux_tpu_torch.data.cache import EmbeddingCacheManager
from qflux_tpu_torch.data.preprocess import ITEM_5B, ImageProcessor
from qflux_tpu_torch.utils import bmp, jpeg
from qflux_tpu_torch.utils.hashing import md5_string
from qflux_tpu_torch.utils.png import SIGNATURE, decode_png

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
IMAGE_DIR_ALIASES = ["training_images", "images", "target_images", "target", "targets"]
CONTROL_DIR_ALIASES = ["control_images", "control", "condition_images", "controls"]

# the strings pandas.read_csv reads as NaN by default
CSV_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_BOOLS = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False,
          "false": False}
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)",
                    re.IGNORECASE)


# libpng's RGB → gray weights as cv2's PNG reader sets them (0.299, 0.587 in
# 15 bits, the rest blue)
_GRAY_WEIGHTS = (9797, 19235, 3736)


def _decode(path, grayscale: bool) -> np.ndarray:
    """An image file's bytes → the decoder its signature names, as cv2.imread
    picks one: PNG, JPEG (FF D8 FF) or BMP; WebP and anything else raise."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == SIGNATURE:
        return decode_png(data)
    if data[:3] == jpeg.SIGNATURE + b"\xff":
        return jpeg.decode_jpeg(data, grayscale)
    if data[:2] == bmp.SIGNATURE:
        return bmp.decode_bmp(data, grayscale)
    what = "WebP" if data[:4] == b"RIFF" and data[8:12] == b"WEBP" else "this format"
    raise NotImplementedError(f"{path}: {what} is not decoded by the port ({ITEM_5B}); "
                              "convert the image to PNG or JPEG")


def _read_image(path) -> np.ndarray:
    """An image file → uint8 [H, W] (gray) or [H, W, 3] RGB, as the JAX
    package's cv2.imread(IMREAD_UNCHANGED) read gives it: alpha dropped,
    gray + alpha as three equal channels, no EXIF rotation."""
    img = _decode(path, grayscale=False)
    if img.ndim == 3:
        img = np.repeat(img[:, :, :1], 3, axis=2) if img.shape[2] == 2 else img[:, :, :3]
    return np.ascontiguousarray(img)


def _read_mask(path) -> np.ndarray:
    """A mask file → uint8 [H, W], as cv2.imread(IMREAD_GRAYSCALE): a JPEG
    or BMP by its decoder's grayscale read (a JPEG turned by its EXIF
    orientation); a gray PNG (with or without alpha) as it is, a color one
    through libpng's truncating 15-bit weights (cv2's libpng converts in
    linear light: within one step)."""
    img = _decode(path, grayscale=True)
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        return np.ascontiguousarray(img[:, :, 0])
    rgb = img[:, :, :3].astype(np.int64)
    gray = sum(rgb[:, :, i] * w for i, w in enumerate(_GRAY_WEIGHTS)) >> 15
    same = (rgb[:, :, 0] == rgb[:, :, 1]) & (rgb[:, :, 0] == rgb[:, :, 2])
    return np.where(same, rgb[:, :, 0], gray).astype(np.uint8)


def _first_existing(d: str, stem: str) -> Optional[str]:
    for ext in IMG_EXTS:
        p = os.path.join(d, stem + ext)
        if os.path.exists(p):
            return p
    return None


def _find_mask(images_dir, control_dir, stem) -> Optional[str]:
    for d in (control_dir, images_dir):
        if d is None:
            continue
        for ext in (".png",) + IMG_EXTS:
            p = os.path.join(d, f"{stem}_mask{ext}")
            if os.path.exists(p):
                return p
    return None


def _collect_extra_controls(control_dir: str, stem: str) -> list[str]:
    out = []
    i = 1
    while (p := _first_existing(control_dir, f"{stem}_control_{i}")) is not None:
        out.append(p)
        i += 1
    return out


def is_huggingface_repo(path: str) -> bool:
    """'org/name' that is not an existing local path."""
    return ("/" in path and not os.path.exists(path)
            and len(path.split("/")) == 2 and not path.startswith((".", "/")))


def read_csv(path: str) -> tuple[list[str], list[dict[str, Any]]]:
    """(columns, rows) as `pandas.read_csv` types them: NA strings → NaN, a
    column whose other cells are all booleans → bool, all integers → int
    (float if it has a NaN), all numbers → float, else the strings."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        columns = next(reader)
        cells = [r for r in reader if r]
    rows = [dict(zip(columns, r + [""] * (len(columns) - len(r)))) for r in cells]
    for col in columns:
        vals = [r[col] for r in rows]
        present = [v for v in vals if v not in CSV_NA_VALUES]
        has_na = len(present) < len(vals)
        if present and all(v in _BOOLS for v in present):
            conv = _BOOLS.__getitem__
        elif present and all(_INT.fullmatch(v) for v in present):
            conv = float if has_na else int
        elif present and all(_FLOAT.fullmatch(v) for v in present):
            conv = float
        else:
            conv = str
        for r in rows:
            r[col] = float("nan") if r[col] in CSV_NA_VALUES else conv(r[col])
    return columns, rows


class ImageDataset:
    def __init__(
        self,
        dataset_path: str | Sequence[str] | None = None,
        csv_path: Optional[str] = None,
        processor: Optional[ImageProcessor] = None,
        cache_dir: Optional[str] = None,
        use_cache: bool = False,
        caption_dropout_rate: float = 0.0,
        prompt_image_dropout_rate: float = 0.0,
        use_edit_mask: bool = False,
        selected_control_indexes: Optional[Sequence[int]] = None,
        seed: int = 0,
        **_,
    ):
        self.processor = processor or ImageProcessor()
        self.cache_manager = EmbeddingCacheManager(cache_dir) if cache_dir else None
        self.use_cache = use_cache and cache_dir is not None
        self.caption_dropout_rate = caption_dropout_rate
        # drops the prompt AND the control context (cfg-style regularization)
        self.prompt_image_dropout_rate = prompt_image_dropout_rate
        self.use_edit_mask = use_edit_mask
        # 1-based control selection
        self.selected_control_indexes = (list(selected_control_indexes)
                                         if selected_control_indexes else None)
        self._seed = seed
        self._visit_counts: dict[int, int] = {}
        self._rng_lock = threading.Lock()
        self.samples: list[dict] = []

        paths = ([dataset_path] if isinstance(dataset_path, (str, Path))
                 else list(dataset_path or []))
        for p in paths:
            p = str(p)
            if is_huggingface_repo(p):
                raise NotImplementedError(
                    f"HF Hub dataset {p!r}: reading a dataset from the hub is not ported "
                    f"({ITEM_5B}); point dataset_path at a local folder or a CSV")
            self._scan_local(p)
        if csv_path:
            self._load_csv(csv_path)
        if not self.samples:
            raise ValueError(f"no samples found in {paths or csv_path}")

    # -- sources -------------------------------------------------------------

    def _find_dirs(self, root: str):
        images_dir = next((os.path.join(root, n) for n in IMAGE_DIR_ALIASES
                           if os.path.isdir(os.path.join(root, n))), None)
        control_dir = next((os.path.join(root, n) for n in CONTROL_DIR_ALIASES
                            if os.path.isdir(os.path.join(root, n))), None)
        return images_dir, control_dir

    def _scan_local(self, root: str):
        images_dir, control_dir = self._find_dirs(root)
        if images_dir is None:
            raise ValueError(f"no image directory found under {root} "
                             f"(looked for {IMAGE_DIR_ALIASES})")
        targets = sorted(
            p for p in glob.glob(os.path.join(images_dir, "*.*"))
            if p.lower().endswith(IMG_EXTS)
            and "_mask" not in os.path.basename(p)
            and "_control_" not in os.path.basename(p)
        )
        for img_path in targets:
            stem = os.path.splitext(os.path.basename(img_path))[0]
            prompt_file = None
            for d in (images_dir, control_dir):
                if d and os.path.exists(os.path.join(d, f"{stem}.txt")):
                    prompt_file = os.path.join(d, f"{stem}.txt")
                    break
            if prompt_file is None:
                continue
            controls: list[str] = []
            if control_dir:
                main = _first_existing(control_dir, stem)
                if main:
                    controls = [main] + _collect_extra_controls(control_dir, stem)
                if self.selected_control_indexes and controls:
                    controls = [controls[i - 1] for i in self.selected_control_indexes
                                if 0 < i <= len(controls)]
            self.samples.append({
                "image": img_path,
                "controls": controls,
                "prompt_file": prompt_file,
                "mask_file": _find_mask(images_dir, control_dir, stem),
                "source": "local",
            })
        logging.info("scanned %s: %d samples", root, len(self.samples))

    def _load_csv(self, csv_path: str):
        columns, rows = read_csv(csv_path)
        base = os.path.dirname(os.path.abspath(csv_path))

        def resolve(p):
            return p if os.path.isabs(p) else os.path.join(base, p)

        ctl_cols = sorted(c for c in columns if c.startswith("path_control"))
        for row in rows:
            controls = [resolve(row[c]) for c in ctl_cols if isinstance(row[c], str) and row[c]]
            self.samples.append({
                "image": resolve(row["path_target"]),
                "controls": controls,
                "prompt": str(row["prompt"]),
                "mask_file": resolve(row["path_mask"])
                if "path_mask" in columns and isinstance(row.get("path_mask"), str) else None,
                "source": "csv",
            })

    # -- hashing ---------------------------------------------------------------

    def file_hashes(self, sample: dict) -> dict[str, str]:
        cm = EmbeddingCacheManager  # static hashing helpers
        hashes: dict[str, str] = {}
        main = ""
        hashes["image_hash"] = cm.get_hash(sample["image"])
        main += hashes["image_hash"]
        prompt = self._prompt_of(sample)
        controls = sample.get("controls") or []
        if controls:
            hashes["control_hash"] = cm.get_hash(controls[0])
            main += hashes["control_hash"]
        hashes["prompt_hash"] = md5_string(prompt)
        main += hashes["prompt_hash"]
        hashes["empty_prompt_hash"] = md5_string("empty")
        if controls:
            hashes["control_prompt_hash"] = cm.get_hash(controls[0], prompt)
            hashes["control_empty_prompt_hash"] = cm.get_hash(controls[0], "empty")
            controls_sum = hashes["control_hash"]
            for i, c in enumerate(controls[1:], start=1):
                hashes[f"control_{i}_hash"] = cm.get_hash(c)
                controls_sum += hashes[f"control_{i}_hash"]
            hashes["controls_sum_hash"] = md5_string(controls_sum)
        hashes["main_hash"] = md5_string(main)
        return hashes

    def _prompt_of(self, sample: dict) -> str:
        if sample.get("prompt") is not None:
            return sample["prompt"]
        return Path(sample["prompt_file"]).read_text().strip()

    # -- item access -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.samples)

    def dropout_draws(self, idx: int) -> tuple[bool, bool]:
        """(drop_all, drop_caption) for this visit of sample `idx`: two
        uniforms from numpy's generator seeded (seed, idx, visit)."""
        with self._rng_lock:
            visit = self._visit_counts.get(idx, 0)
            self._visit_counts[idx] = visit + 1
        u1, u2 = np.random.default_rng((self._seed, idx, visit)).random(2)
        drop_all = bool(self.prompt_image_dropout_rate > 0
                        and u1 < self.prompt_image_dropout_rate)
        drop_caption = drop_all or bool(self.caption_dropout_rate > 0
                                        and u2 < self.caption_dropout_rate)
        return drop_all, drop_caption

    def __getitem__(self, idx: int) -> dict[str, Any]:
        sample = self.samples[idx]
        hashes = self.file_hashes(sample)
        out: dict[str, Any] = {"prompt": self._prompt_of(sample), "file_hashes": hashes,
                               "cached": False}
        # caption dropout swaps in the cached empty-prompt embeddings;
        # prompt-image dropout also zeroes the control latents (same shapes)
        drop_all, drop_caption = self.dropout_draws(idx)
        cached = None
        if self.use_cache and self.cache_manager.exists(hashes["main_hash"]):
            cached = self.cache_manager.load(hashes["main_hash"], use_empty_prompt=drop_caption)
        if cached is not None:
            out.update(cached)
            if drop_all:
                for k, v in out.items():
                    if k.startswith("control") and hasattr(v, "dtype"):
                        out[k] = np.zeros_like(v)
            out["cached"] = True
            return out
        # not cached: read and resample the pixels for the Trainer to encode
        raw: dict[str, Any] = {"image": _read_image(sample["image"])}
        controls = sample.get("controls") or []
        if controls:
            raw["control"] = _read_image(controls[0])
            if len(controls) > 1:
                raw["controls"] = [_read_image(c) for c in controls[1:]]
        if self.use_edit_mask and sample.get("mask_file"):
            raw["mask"] = _read_mask(sample["mask_file"])
        proc = self.processor.preprocess(raw)
        if drop_caption:
            out["prompt"] = ""
        # prompt-image dropout on the pixel path: the Trainer zeroes the
        # control latents after encoding, as the cached path zeroes them
        out["drop_context"] = bool(drop_all)
        out["image"] = proc["image"]
        out["img_shapes"] = [tuple(proc["image"].shape[:2])]
        if "control" in proc:
            out["control"] = proc["control"]
            out["img_shapes"].append(tuple(proc["control"].shape[:2]))
        for i, c in enumerate(proc.get("controls", []), start=1):
            out[f"control_{i}"] = c
            out["img_shapes"].append(tuple(c.shape[:2]))
        if "mask" in proc:
            out["mask"] = proc["mask"]
        return out
