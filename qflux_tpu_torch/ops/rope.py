"""Multi-axis rotary position embeddings (FLUX 3-axis ids, Qwen-Image 3-axis
coordinates), rotate-half layout.

Counterpart of qflux_tpu/ops/rope.py (`rope_from_coords`, `flux_image_ids`,
`flux_text_ids`, `dreamomni2_control_ids`, `qwen_video_coords`, `qwen_rope`,
`interleaved_to_half_perm`, `half_to_interleaved_perm`).  The inverse
frequencies are computed in float64 on the host and cast to float32, as in
the JAX code; the q/k projection channels are already permuted to the
rotate-half layout by the weight converters (`models/porting.py`).
"""

from __future__ import annotations

import numpy as np
import torch


def rope_from_coords(coords, axes_dim: tuple[int, ...], theta: float = 10000.0):
    """coords [..., n_axes] → (cos, sin) each [..., sum(axes_dim)] float32,
    rotate-half layout: pairs are (j, j + D/2)."""
    cos_parts, sin_parts = [], []
    for i, d in enumerate(axes_dim):
        pos = coords[..., i].float()
        inv = (1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))).astype(np.float32)
        freqs = pos[..., None] * torch.from_numpy(inv).to(pos.device)
        cos_parts.append(torch.cos(freqs))
        sin_parts.append(torch.sin(freqs))
    cos = torch.cat(cos_parts, dim=-1)
    sin = torch.cat(sin_parts, dim=-1)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def flux_image_ids(height: int, width: int, set_id: int = 0,
                   h_offset: int = 0, w_offset: int = 0) -> np.ndarray:
    """[(h*w), 3] ids (set, row, col) for one packed-latent image plane;
    set_id > 0 marks control images."""
    ids = np.zeros((height, width, 3), dtype=np.float32)
    ids[..., 0] = set_id
    ids[..., 1] = np.arange(height)[:, None] + h_offset
    ids[..., 2] = np.arange(width)[None, :] + w_offset
    return ids.reshape(height * width, 3)


def interleaved_to_half_perm(d: int) -> np.ndarray:
    """Channel permutation taking torch interleaved-pair rope layout to the
    rotate-half layout: even indices first, then odd. ours[j] = torch[perm[j]]."""
    return np.concatenate([np.arange(0, d, 2), np.arange(1, d, 2)])


def half_to_interleaved_perm(d: int) -> np.ndarray:
    return np.argsort(interleaved_to_half_perm(d))


def flux_text_ids(seq_len: int) -> np.ndarray:
    return np.zeros((seq_len, 3), dtype=np.float32)


def dreamomni2_control_ids(shapes: list[tuple[int, int]]) -> np.ndarray:
    """Ids of DreamOmni2's N reference images: image i gets set id i + 1 and
    row and column offsets summed over the images before it, as JAX's.  The
    row offset is JAX's own: the reference pipeline offsets the columns
    only, and the port keeps JAX's ids."""
    out, h_off, w_off = [], 0, 0
    for i, (h, w) in enumerate(shapes):
        out.append(flux_image_ids(h, w, set_id=i + 1, h_offset=h_off, w_offset=w_off))
        h_off += h
        w_off += w
    return np.concatenate(out, axis=0)


def qwen_video_coords(frame: int, height: int, width: int, idx: int = 0,
                      scale_rope: bool = True) -> np.ndarray:
    """[(f*h*w), 3] coords (image index, row, col) for one (frame, H, W)
    plane; scale_rope centres rows and columns on zero: h coord ∈
    [-(h - h//2), h//2)."""
    f = np.full((frame, height, width), idx, dtype=np.float32)
    if scale_rope:
        hs = np.arange(-(height - height // 2), height // 2, dtype=np.float32)
        ws = np.arange(-(width - width // 2), width // 2, dtype=np.float32)
    else:
        hs = np.arange(height, dtype=np.float32)
        ws = np.arange(width, dtype=np.float32)
    h = np.broadcast_to(hs[None, :, None], (frame, height, width))
    w = np.broadcast_to(ws[None, None, :], (frame, height, width))
    return np.stack([f, h, w], axis=-1).reshape(-1, 3)


def qwen_rope(video_fhw: list[tuple[int, int, int]], txt_seq_len: int,
              axes_dim=(16, 56, 56), theta: float = 10000.0, scale_rope: bool = True):
    """(vid_cos, vid_sin, txt_cos, txt_sin) f32 tensors on the CPU for the
    joint Qwen stream: the image planes in order, and text tokens placed past
    the largest image coordinate on all three axes."""
    coords = [qwen_video_coords(f, h, w, idx=i, scale_rope=scale_rope)
              for i, (f, h, w) in enumerate(video_fhw)]
    vid = np.concatenate(coords, axis=0)
    if scale_rope:
        max_vid = max(max(h // 2, w // 2) for _, h, w in video_fhw)
    else:
        max_vid = max(max(h, w) for _, h, w in video_fhw)
    txt = np.repeat(np.arange(max_vid, max_vid + txt_seq_len, dtype=np.float32)[:, None], 3,
                    axis=1)
    vid_cos, vid_sin = rope_from_coords(torch.from_numpy(vid), axes_dim, theta)
    txt_cos, txt_sin = rope_from_coords(torch.from_numpy(txt), axes_dim, theta)
    return vid_cos, vid_sin, txt_cos, txt_sin
