"""Write the 512² image fixtures that chip_smoke.py's phase F trains from,
and the digests of cv2's decode of each, to tests/fixtures/images/.

    python scripts/make_image_fixtures.py [--out tests/fixtures/images]

Needs cv2 and PIL (the machine that writes the fixtures, not the card's).
The content is smooth and synthetic (gradients, soft discs, a low sine
ripple) so that the files stay small; each file exercises one path of the
port's decoders (utils/jpeg.py, utils/bmp.py, utils/png.py):

  target_0.jpg   baseline JPEG, 4:2:0, quality 90 (cv2)
  control_0.jpg  progressive JPEG, 4:2:0, quality 90 (cv2)
  target_1.jpg   4:4:4 JPEG, a restart marker every 4 MCUs, optimized
                 Huffman tables, quality 90 (cv2)
  control_1.jpg  baseline JPEG, 4:2:2, quality 85 (cv2): --predict's control
  target_2.bmp   24-bit BMP (cv2)
  control_2.png  RGB PNG (cv2, compression 9)
  target_3.jpg   RGB (not YCbCr) JPEG with an Adobe marker, quality 90 (PIL)
  control_3.jpg  baseline JPEG, 4:4:0, quality 90 (cv2)

digests.json holds, for each file, its own sha256 and, for cv2.imread
under IMREAD_UNCHANGED (as data/dataset.py's `_read_image` turns it: BGR
→ RGB, alpha dropped) and under IMREAD_GRAYSCALE, the decoded array's
shape and the sha256 of its bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

SIZE = 512
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111}
FIXTURES = {
    "target_0.jpg": ("baseline JPEG 4:2:0 q90 (cv2)", {"samp": "420"}),
    "control_0.jpg": ("progressive JPEG 4:2:0 q90 (cv2)", {"samp": "420", "progressive": True}),
    "target_1.jpg": ("JPEG 4:4:4 q90, restart interval 4 MCUs, optimized Huffman tables (cv2)",
                     {"samp": "444", "rst": 4, "optimize": True}),
    "control_1.jpg": ("baseline JPEG 4:2:2 q85 (cv2)", {"samp": "422", "quality": 85}),
    "target_2.bmp": ("24-bit BMP (cv2)", {}),
    "control_2.png": ("RGB PNG (cv2)", {}),
    "target_3.jpg": ("RGB JPEG with an Adobe APP14 marker, transform 0, q90 (PIL)",
                     {"pil_rgb": True}),
    "control_3.jpg": ("baseline JPEG 4:4:0 q90 (cv2)", {"samp": "440"}),
}


def content(seed: int) -> np.ndarray:
    """A smooth 512² RGB image from a seed."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:SIZE, 0:SIZE].astype(np.float64) / SIZE
    img = np.zeros((SIZE, SIZE, 3))
    for c in range(3):
        a, b = rng.uniform(-1, 1, 2)
        img[:, :, c] = 128 + 70 * (a * x + b * y)
    for _ in range(4):
        cy, cx, r = rng.uniform(0.15, 0.85, 2).tolist() + [rng.uniform(0.05, 0.2)]
        color = rng.uniform(-60, 60, 3)
        disc = 1 / (1 + np.exp((np.hypot(y - cy, x - cx) - r) * 60))
        img += disc[:, :, None] * color
    img += 6 * np.sin(2 * np.pi * (3 * x + 2 * y))[:, :, None]
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def write(path: Path, rgb: np.ndarray, opts: dict) -> None:
    bgr = np.ascontiguousarray(rgb[:, :, ::-1])
    if path.suffix == ".bmp":
        ok = cv2.imwrite(str(path), bgr)
    elif path.suffix == ".png":
        ok = cv2.imwrite(str(path), bgr, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    elif opts.get("pil_rgb"):
        Image.fromarray(rgb).save(path, "JPEG", quality=90, keep_rgb=True)
        ok = True
    else:
        params = [cv2.IMWRITE_JPEG_QUALITY, opts.get("quality", 90),
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[opts["samp"]]]
        if opts.get("progressive"):
            params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        if opts.get("rst"):
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, opts["rst"]]
        if opts.get("optimize"):
            params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
        ok = cv2.imwrite(str(path), bgr, params)
    if not ok:
        raise RuntimeError(f"cv2 could not write {path}")


def cv2_reads(path: Path) -> dict:
    """cv2.imread's arrays, as `_read_image` / `_read_mask` give them."""
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[:, :, :3][:, :, ::-1]
    return {"unchanged": np.ascontiguousarray(img),
            "grayscale": cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)}


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(Path(__file__).resolve().parent.parent
                                          / "tests" / "fixtures" / "images"))
    out = Path(ap.parse_args(argv).out)
    out.mkdir(parents=True, exist_ok=True)
    table = {}
    for i, (name, (what, opts)) in enumerate(FIXTURES.items()):
        path = out / name
        write(path, content(100 + i), opts)
        reads = cv2_reads(path)
        table[name] = {"what": what, "file_sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
                       "bytes": path.stat().st_size,
                       **{f"{mode}_shape": list(a.shape) for mode, a in reads.items()},
                       **{f"{mode}_sha256": digest(a) for mode, a in reads.items()}}
    (out / "digests.json").write_text(json.dumps(table, indent=1) + "\n")
    total = sum(v["bytes"] for v in table.values())
    print(f"wrote {len(table)} fixtures, {total} bytes, to {out}")


if __name__ == "__main__":
    main()
