"""Image-array layout / range heuristics and batch-field helpers.

The port's copy of qflux_tpu/utils/tensors.py (numpy only)."""

from __future__ import annotations

import re
from typing import Any

import numpy as np


def infer_image_tensor(arr) -> dict[str, Any]:
    """Infer the layout (HWC / CHW / NHWC / NCHW / HW) and value range
    ("0_255", "-1_1", "0_1") of an image array."""
    a = np.asarray(arr)
    info: dict[str, Any] = {"shape": tuple(a.shape), "dtype": str(a.dtype)}

    if a.ndim == 2:
        info["layout"] = "HW"
    elif a.ndim == 3:
        if a.shape[-1] in (1, 3, 4) and a.shape[0] not in (1, 3, 4):
            info["layout"] = "HWC"
        elif a.shape[0] in (1, 3, 4):
            info["layout"] = "CHW"
        else:
            info["layout"] = "HWC"  # ambiguous → channels-last convention
    elif a.ndim == 4:
        if a.shape[-1] in (1, 3, 4) and a.shape[1] not in (1, 3, 4):
            info["layout"] = "NHWC"
        elif a.shape[1] in (1, 3, 4):
            info["layout"] = "NCHW"
        else:
            info["layout"] = "NHWC"
    else:
        info["layout"] = "unknown"

    lo, hi = (float(a.min()), float(a.max())) if a.size else (0.0, 0.0)
    if a.dtype == np.uint8 or hi > 2.0:
        info["range"] = "0_255"
    elif lo < -0.01:
        info["range"] = "-1_1"
    else:
        info["range"] = "0_1"
    return info


def to_hwc_uint8(arr) -> np.ndarray:
    """Any inferred layout / range → HWC (NHWC) uint8."""
    a = np.asarray(arr)
    info = infer_image_tensor(a)
    if info["layout"] == "CHW":
        a = a.transpose(1, 2, 0)
    elif info["layout"] == "NCHW":
        a = a.transpose(0, 2, 3, 1)
    if info["range"] == "-1_1":
        a = (a + 1.0) * 127.5
    elif info["range"] == "0_1":
        a = a * 255.0
    return np.clip(np.round(a), 0, 255).astype(np.uint8)


def extract_batch_field(batch: dict, key: str, index: int | None = None):
    """`key` of a collated batch, optionally one sample's."""
    if key not in batch:
        return None
    val = batch[key]
    if index is None:
        return val
    if isinstance(val, (list, tuple)):
        return val[index]
    arr = np.asarray(val)
    return arr[index] if arr.ndim >= 1 else arr


def numeric_suffix_key(key: str) -> tuple[int, str]:
    """Sort key ordering `control_2` before `control_10`."""
    m = re.search(r"_(\d+)$", key)
    return (int(m.group(1)) if m else -1, key)
