"""Batch collation: numpy in, padded and stacked numpy out.

Counterpart of qflux_tpu/data/collate.py, unchanged in behaviour: arrays
of one shape stack; arrays whose shapes differ are right-padded with zeros
to the batch's elementwise-max shape and get a `valid_masks[key]` [B, max
first dim] (only those keys); numbers become one numpy array; anything
else (dicts, strings, lists) becomes a list.  A per-sample image-space
`mask` becomes the packed-latent `edit_mask` BEFORE padding, so its tokens
align with each sample's own latent grid.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np


def _latent_edit_mask(mask: np.ndarray, vae_scale: int = 8) -> np.ndarray:
    """[H, W] float mask → [seq] packed-latent weights (numpy twin of
    losses.map_mask_to_latent)."""
    h, w = mask.shape[:2]
    lh, lw = h // vae_scale, w // vae_scale
    m = mask[: lh * vae_scale, : lw * vae_scale].astype(np.float32)
    m = m.reshape(lh, vae_scale, lw, vae_scale).mean(axis=(1, 3))
    m = m.reshape(lh // 2, 2, lw // 2, 2).max(axis=(1, 3))
    return m.reshape(-1)


def pad_to_max_shape(arrays: Sequence[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad arrays to their elementwise-max shape: (stacked [B, …],
    valid [B, max first dim])."""
    max_shape = tuple(max(a.shape[d] for a in arrays) for d in range(arrays[0].ndim))
    out = np.zeros((len(arrays),) + max_shape, dtype=arrays[0].dtype)
    valid = np.zeros((len(arrays), max_shape[0]) if arrays[0].ndim else (len(arrays),),
                     dtype=bool)
    for i, a in enumerate(arrays):
        out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
        valid[i, : a.shape[0]] = True
    return out, valid


def collate(samples: Sequence[dict]) -> dict[str, Any]:
    batch: dict[str, Any] = {}
    for key in samples[0].keys():
        vals = [s[key] for s in samples]
        if key == "mask":
            batch["edit_mask"], _ = pad_to_max_shape([_latent_edit_mask(np.asarray(v))
                                                      for v in vals])
            continue
        first = vals[0]
        if isinstance(first, np.ndarray):
            if all(v.shape == first.shape for v in vals):
                batch[key] = np.stack(vals)
            else:
                padded, valid = pad_to_max_shape([np.asarray(v) for v in vals])
                batch[key] = padded
                batch.setdefault("valid_masks", {})[key] = valid
        elif isinstance(first, (int, float, bool, np.number)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = list(vals)
    return batch
