"""Qwen2.5-VL multimodal encoder (vision tower + M-RoPE LM) in PyTorch: the
Qwen-Image-Edit text encoder.

Counterpart of qflux_tpu/models/qwen/vl_encoder.py, the KV cache and the
steps of greedy decoding (DreamOmni2's prompt enhancer) included.
Module attribute names are the JAX tree's keys, so
`models/bridge.py:load_params` loads JAX's stacked trees and either
package's converter output into them ([L, …] leaves into the ModuleLists,
dense `kernel [in, out]` into `weight [out, in]`).  JAX runs the encoder in
XLA with no Pallas kernel; here it is plain PyTorch, in float32 (raising on
the card unless TF32 is off, `ops.layers.require_f32`):

  * vision tower: 14×14 patches (two duplicated frames) embedded by one
    matmul, rotate-half 2D RoPE (its cos / sin made in float64 on the host
    and cast to f32, as JAX's numpy makes them), window attention and the
    full attention of `fullatt_block_indexes` as one segment-masked
    softmax over the window-reordered sequence (−1e30 logits, f32
    softmax), the 2×2 patch merger (RMSNorm, MLP with exact GELU), the
    reorder undone;
  * LM: Qwen2 decoder layers (GQA with qkv bias, SwiGLU, RMSNorm) with
    multimodal 3D RoPE (the mrope_section channel split over t / h / w
    positions), a causal mask ANDed with the padding mask; the output is
    the final RMSNorm of the last layer (transformers' hidden_states[-1]);
  * greedy decoding: `make_kv_cache` (a fixed-size [L, B, max_len, n_kv,
    head_dim] cache), `text_prefill` (`text_forward` that fills it) and
    `text_decode_step` (one token attending over the cache up to its own
    slot), as JAX's jitted pair computes them.

The host helpers re-implement the HF processor exactly: `smart_resize`,
`preprocess_image` (PIL's bicubic through `utils/resample.py`, then JAX's
normalisation, which numpy promotes to float64), `vision_rot_pos_ids`,
`window_index` and `get_rope_index`.  `vision_init` / `text_init` draw the
weights on a device with the JAX inits' distributions, module by module
(the full LM is 30.5 GB of f32: it is never built on the host first);
`load_from_state_dict` reads a transformers checkpoint one block / layer
at a time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qflux_tpu_torch.models.flux.text_encoders import NormParams, _param
from qflux_tpu_torch.ops.layers import Dense, dense, require_f32
from qflux_tpu_torch.utils.resample import resize

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class VLVisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3456
    num_heads: int = 16
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    in_channels: int = 3

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls):
        return cls(depth=2, hidden_size=32, intermediate_size=64, num_heads=2,
                   fullatt_block_indexes=(1,), out_hidden_size=48, window_size=28)


@dataclasses.dataclass(frozen=True)
class VLTextConfig:
    hidden_size: int = 3584
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    intermediate_size: int = 18944
    rope_theta: float = 1_000_000.0
    mrope_section: tuple[int, ...] = (16, 24, 24)
    vocab_size: int = 152064
    rms_norm_eps: float = 1e-6

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls):
        return cls(hidden_size=48, num_layers=2, num_heads=4, num_kv_heads=2,
                   intermediate_size=96, vocab_size=512, mrope_section=(2, 2, 2))


@dataclasses.dataclass(frozen=True)
class VLSpecialTokens:
    image_token_id: int = 151655       # <|image_pad|>
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    eos_token_ids: tuple[int, ...] = (151645, 151643)


# ===========================================================================
# host-side preprocessing (the HF Qwen2VLImageProcessor)

def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56, max_pixels: int = 28 * 28 * 1280):
    """Nearest factor-multiple size within the pixel budget (HF smart_resize)."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio too extreme for the VL encoder")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def preprocess_image(image: np.ndarray, cfg: VLVisionConfig, min_pixels: int = 56 * 56,
                     max_pixels: int = 28 * 28 * 1280):
    """uint8 HWC RGB → (patches [n, C·tps·ps²] f32, grid_thw (1, h, w)):
    smart_resize, PIL's bicubic, x / 255 in f32 minus the CLIP mean over the
    CLIP std (float64, as numpy promotes JAX's f32 by the float64 tables),
    two identical frames, patches flattened in merged-2×2-major order, then
    f32."""
    h0, w0 = image.shape[:2]
    factor = cfg.patch_size * cfg.spatial_merge_size
    h, w = smart_resize(h0, w0, factor, min_pixels, max_pixels)
    img = resize(np.asarray(image, np.uint8), (h, w), "bicubic")
    x = img.astype(np.float32) / 255.0
    x = (x - np.asarray(OPENAI_CLIP_MEAN)) / np.asarray(OPENAI_CLIP_STD)
    x = x.transpose(2, 0, 1)
    x = np.tile(x[None], (cfg.temporal_patch_size, 1, 1, 1))
    ps, msz, tps = cfg.patch_size, cfg.spatial_merge_size, cfg.temporal_patch_size
    grid_t, grid_h, grid_w = 1, h // ps, w // ps
    c = cfg.in_channels
    patches = x.reshape(tps, c, grid_h // msz, msz, ps, grid_w // msz, msz, ps)
    patches = patches.transpose(2, 5, 3, 6, 1, 0, 4, 7)
    flat = patches.reshape(grid_h * grid_w, c * tps * ps * ps)
    return flat.astype(np.float32), (grid_t, grid_h, grid_w)


def vision_rot_pos_ids(grid_thw: Sequence[tuple[int, int, int]], merge: int) -> np.ndarray:
    """[S, 2] (h, w) position ids in merged-2×2-major order (HF rot_pos_emb)."""
    out = []
    for t, h, w in grid_thw:
        hp = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hp = hp.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
        wp = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wp = wp.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
        out.append(np.tile(np.stack([hp, wp], axis=-1), (t, 1)))
    return np.concatenate(out, axis=0)


def window_index(grid_thw, cfg: VLVisionConfig):
    """(window_index [S/4], window segment id per merged unit): HF
    get_window_index, its cu_seqlens as segment ids for the masked softmax."""
    msz = cfg.spatial_merge_size
    vit_ws = cfg.window_size // msz // cfg.patch_size
    idx_list, seg_list = [], []
    base, seg0 = 0, 1
    for t, h, w in grid_thw:
        lh, lw = h // msz, w // msz
        index = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h, pad_w = (-lh) % vit_ws, (-lw) % vit_ws
        nwh, nww = (lh + pad_h) // vit_ws, (lw + pad_w) // vit_ws
        padded = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
        padded[:, :lh, :lw] = index
        padded = padded.reshape(t, nwh, vit_ws, nww, vit_ws).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t * nwh * nww, vit_ws * vit_ws)
        for wi, row in enumerate(padded):
            valid = row[row != -100]
            idx_list.append(valid + base)
            seg_list.append(np.full(len(valid), seg0 + wi, np.int32))
        base += t * lh * lw
        seg0 += len(padded)
    return np.concatenate(idx_list), np.concatenate(seg_list)


def get_rope_index(input_ids: np.ndarray, grid_thw_per_image: list[tuple[int, int, int]],
                   merge: int, tokens: VLSpecialTokens,
                   attention_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """input_ids [B, S] → position_ids [3, B, S] (t / h / w): the
    images-only form of HF get_rope_index; padding positions stay 0."""
    b, s = input_ids.shape
    pos = np.zeros((3, b, s), np.int64)
    img_iter = 0
    for bi in range(b):
        ids = input_ids[bi]
        valid = np.ones(s, bool) if attention_mask is None else attention_mask[bi].astype(bool)
        idxs = np.where(valid)[0]
        cur = 0
        out = np.zeros((3, len(idxs)), np.int64)
        i = 0
        while i < len(idxs):
            if ids[idxs[i]] == tokens.image_token_id:
                t, h, w = grid_thw_per_image[img_iter]
                lh, lw = h // merge, w // merge
                n = t * lh * lw
                out[0, i:i + n] = cur + np.repeat(np.arange(t), lh * lw)
                out[1, i:i + n] = cur + np.tile(np.repeat(np.arange(lh), lw), t)
                out[2, i:i + n] = cur + np.tile(np.arange(lw), t * lh)
                cur += int(max(t, lh, lw))
                i += n
                img_iter += 1
            else:
                out[:, i] = cur
                cur += 1
                i += 1
        pos[:, bi, idxs] = out
    return pos


# ===========================================================================
# modules (attribute names are the JAX tree's keys)

class _Mlp(nn.Module):
    def __init__(self, d, ff, bias, **kw):
        super().__init__()
        self.gate, self.up = Dense(d, ff, bias=bias, **kw), Dense(d, ff, bias=bias, **kw)
        self.down = Dense(ff, d, bias=bias, **kw)


class _VisionAttn(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.qkv, self.proj = Dense(d, 3 * d, **kw), Dense(d, d, **kw)


class VisionBlock(nn.Module):
    def __init__(self, cfg: VLVisionConfig, **kw):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = NormParams(d, bias=False, **kw)
        self.norm2 = NormParams(d, bias=False, **kw)
        self.attn = _VisionAttn(d, **kw)
        self.mlp = _Mlp(d, cfg.intermediate_size, True, **kw)


class _Merger(nn.Module):
    def __init__(self, cfg: VLVisionConfig, **kw):
        super().__init__()
        dm = cfg.hidden_size * cfg.spatial_merge_size ** 2
        self.ln_q = NormParams(cfg.hidden_size, bias=False, **kw)
        self.mlp_0 = Dense(dm, dm, **kw)
        self.mlp_2 = Dense(dm, cfg.out_hidden_size, **kw)


class VisionTower(nn.Module):
    def __init__(self, cfg: VLVisionConfig, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        in_dim = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2
        self.patch_embed = Dense(in_dim, cfg.hidden_size, bias=False, **kw)
        self.blocks = nn.ModuleList(VisionBlock(cfg, **kw) for _ in range(cfg.depth))
        self.merger = _Merger(cfg, **kw)


class _TextAttn(nn.Module):
    def __init__(self, cfg: VLTextConfig, **kw):
        super().__init__()
        d, kv = cfg.hidden_size, cfg.num_kv_heads * cfg.head_dim
        self.q, self.k, self.v = Dense(d, d, **kw), Dense(d, kv, **kw), Dense(d, kv, **kw)
        self.o = Dense(d, d, bias=False, **kw)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: VLTextConfig, **kw):
        super().__init__()
        d = cfg.hidden_size
        self.input_layernorm = NormParams(d, bias=False, **kw)
        self.post_attention_layernorm = NormParams(d, bias=False, **kw)
        self.attn = _TextAttn(cfg, **kw)
        self.mlp = _Mlp(d, cfg.intermediate_size, False, **kw)


class TextModel(nn.Module):
    def __init__(self, cfg: VLTextConfig, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.embed_tokens = _param(cfg.vocab_size, cfg.hidden_size, **kw)
        self.norm = NormParams(cfg.hidden_size, bias=False, **kw)
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw) for _ in range(cfg.num_layers))


def _normal_in(d: Dense, generator) -> None:
    """JAX's `_nb`: N(0, 1/in), no bias."""
    d.weight.normal_(generator=generator).mul_(d.in_dim ** -0.5)


@torch.no_grad()
def vision_init(generator: torch.Generator, cfg: VLVisionConfig, device=None,
                dtype=torch.float32) -> VisionTower:
    """Random weights with `vision_init`'s distributions, drawn on `device`:
    patch_embed N(0, 1/in), every other dense layer U(±1/sqrt(in)) with its
    bias, unit RMS scales."""
    model = VisionTower(cfg, device=device, dtype=dtype)
    _normal_in(model.patch_embed, generator)
    for mod in list(model.merger.modules()) + list(model.blocks.modules()):
        if isinstance(mod, Dense):
            mod.init_(generator)
    return model


@torch.no_grad()
def text_init(generator: torch.Generator, cfg: VLTextConfig, device=None,
              dtype=torch.float32) -> TextModel:
    """Random weights with `text_init`'s distributions, drawn on `device`:
    embed_tokens N(0, 0.02²), q / k / v U(±1/sqrt(in)) with their biases, o
    and the MLP N(0, 1/in) without, unit RMS scales."""
    model = TextModel(cfg, device=device, dtype=dtype)
    model.embed_tokens.normal_(generator=generator).mul_(0.02)
    for lp in model.layers:
        for d in (lp.attn.q, lp.attn.k, lp.attn.v):
            d.init_(generator)
        for d in (lp.attn.o, lp.mlp.gate, lp.mlp.up, lp.mlp.down):
            _normal_in(d, generator)
    return model


# ===========================================================================
# forward

def _rms(p: NormParams, x, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p.scale.float()).to(x.dtype)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _rope(x, cos, sin):
    x32 = x.float()
    return (x32 * cos + _rotate_half(x32) * sin).to(x.dtype)


def _seg_attn(q, k, v, same, scale):
    """[S, H, D] unbatched attention, masked to the pairs `same` [S, S]
    allows (−1e30 logits, f32 softmax)."""
    logits = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    logits = torch.where(same[None], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("hqk,khd->qhd", probs, v)


def vision_forward(params: VisionTower, cfg: VLVisionConfig, patches,
                   grid_thw: Sequence[tuple[int, int, int]]) -> torch.Tensor:
    """patches [S, C·tps·ps²] (numpy or a tensor) → merged features
    [S / merge², out_hidden] on the tower's device."""
    dev = params.patch_embed.weight.device
    x = torch.as_tensor(np.asarray(patches) if not torch.is_tensor(patches)
                        else patches).to(dev, torch.float32)
    require_f32(x, "the VL vision tower")
    n_h, hd = cfg.num_heads, cfg.head_dim
    msz2 = cfg.spatial_merge_size ** 2
    x = dense(params.patch_embed, x)
    s = x.shape[0]

    # host-side index math and the rope tables, in float64 as JAX's numpy
    pos = vision_rot_pos_ids(grid_thw, cfg.spatial_merge_size)
    win_idx, win_seg_units = window_index(grid_thw, cfg)
    inv = 1.0 / (10000.0 ** (np.arange(0, hd // 2, 2, dtype=np.float64) / (hd // 2)))
    freqs = (pos[:, :, None] * inv[None, None, :]).reshape(s, -1)
    emb = np.concatenate([freqs, freqs], axis=-1)
    reorder = (win_idx[:, None] * msz2 + np.arange(msz2)[None, :]).reshape(-1)
    cos = torch.from_numpy(np.cos(emb).astype(np.float32)[reorder]).to(dev)[:, None, :]
    sin = torch.from_numpy(np.sin(emb).astype(np.float32)[reorder]).to(dev)[:, None, :]
    x = x[torch.from_numpy(reorder).to(dev)]
    win_seg = torch.from_numpy(np.repeat(win_seg_units, msz2)).to(dev)
    full_seg = np.concatenate([np.full(t * h * w, i + 1, np.int32)
                               for i, (t, h, w) in enumerate(grid_thw)])
    full_seg = torch.from_numpy(full_seg[reorder]).to(dev)
    masks = {False: win_seg[:, None] == win_seg[None, :],
             True: full_seg[:, None] == full_seg[None, :]}
    scale = hd ** -0.5
    for li, lp in enumerate(params.blocks):
        h_in = _rms(lp.norm1, x)
        qkv = dense(lp.attn.qkv, h_in).reshape(s, 3, n_h, hd)
        q, k, v = _rope(qkv[:, 0], cos, sin), _rope(qkv[:, 1], cos, sin), qkv[:, 2]
        o = _seg_attn(q, k, v, masks[li in cfg.fullatt_block_indexes], scale).reshape(s, -1)
        x = x + dense(lp.attn.proj, o)
        h_in = _rms(lp.norm2, x)
        x = x + dense(lp.mlp.down, F.silu(dense(lp.mlp.gate, h_in)) * dense(lp.mlp.up, h_in))
    m = params.merger
    x = _rms(m.ln_q, x).reshape(s // msz2, msz2 * cfg.hidden_size)
    x = dense(m.mlp_2, F.gelu(dense(m.mlp_0, x), approximate="none"))
    return x[torch.from_numpy(np.argsort(win_idx)).to(dev)]


def mrope_cos_sin(position_ids, cfg: VLTextConfig, device=None):
    """position_ids [3, B, S] → (cos, sin) [B, S, head_dim]: the inverse
    frequencies made in float64 and cast to f32, the rest in f32, each
    channel section taking its t / h / w position (mrope_section)."""
    hd = cfg.head_dim
    inv = torch.from_numpy((1.0 / (cfg.rope_theta ** (
        np.arange(0, hd, 2, dtype=np.float64) / hd))).astype(np.float32)).to(device)
    pos = torch.as_tensor(np.asarray(position_ids)).to(device, torch.float32)
    freqs = pos[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    cos3, sin3 = torch.cos(emb), torch.sin(emb)
    sizes = list(cfg.mrope_section) * 2
    cos = torch.cat([c[i % 3] for i, c in enumerate(torch.split(cos3, sizes, dim=-1))], dim=-1)
    sin = torch.cat([c[i % 3] for i, c in enumerate(torch.split(sin3, sizes, dim=-1))], dim=-1)
    return cos, sin


def _attend(cfg: VLTextConfig, q, k, v, mask=None):
    """GQA by repeat, f32 logits with the −1e30 mask (None: every key), f32
    softmax cast to v's dtype: [B, Sq, n_h, hd] over [B, Sk, n_kv, hd] →
    [B, Sq, n_h · hd]."""
    b, s = q.shape[:2]
    rep = cfg.num_heads // cfg.num_kv_heads
    kr, vr = torch.repeat_interleave(k, rep, dim=2), torch.repeat_interleave(v, rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * (cfg.head_dim ** -0.5)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(vr.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vr).reshape(b, s, -1)


def _qkv(cfg: VLTextConfig, lp: DecoderLayer, x, cos, sin):
    """The layer's input norm and q / k / v, q and k roped: k and v as a KV
    cache keeps them (before the GQA repeat)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = _rms(lp.input_layernorm, x, cfg.rms_norm_eps)
    a = lp.attn
    q = _rope(dense(a.q, h).reshape(b, s, cfg.num_heads, hd), cos[:, :, None], sin[:, :, None])
    k = _rope(dense(a.k, h).reshape(b, s, cfg.num_kv_heads, hd), cos[:, :, None],
              sin[:, :, None])
    return q, k, dense(a.v, h).reshape(b, s, cfg.num_kv_heads, hd)


def _finish_layer(cfg: VLTextConfig, lp: DecoderLayer, x, o):
    """The attention output's projection and residual, then the SwiGLU MLP."""
    x = x + dense(lp.attn.o, o)
    h = _rms(lp.post_attention_layernorm, x, cfg.rms_norm_eps)
    return x + dense(lp.mlp.down, F.silu(dense(lp.mlp.gate, h)) * dense(lp.mlp.up, h))


def _decoder_layer(cfg: VLTextConfig, x, lp: DecoderLayer, cos, sin, mask):
    """One Qwen2 decoder layer (GQA + qkv bias, SwiGLU) → (x, (k, v)), k and
    v as a KV cache stores them."""
    q, k, v = _qkv(cfg, lp, x, cos, sin)
    return _finish_layer(cfg, lp, x, _attend(cfg, q, k, v, mask)), (k, v)


def _causal_mask(s: int, attention_mask, device) -> torch.Tensor:
    mask = torch.tril(torch.ones(s, s, dtype=torch.bool, device=device))[None, None]
    if attention_mask is not None:
        keep = torch.as_tensor(np.asarray(attention_mask) if not torch.is_tensor(
            attention_mask) else attention_mask).to(device).bool()
        mask = mask & keep[:, None, None, :]
    return mask


def text_forward(params: TextModel, cfg: VLTextConfig, inputs_embeds, position_ids,
                 attention_mask=None) -> torch.Tensor:
    """inputs_embeds [B, S, D] → hidden_states[-1] in the transformers
    sense: the last decoder layer's output through the final RMSNorm.
    `params.layers` is iterated once, so a caller may hand in a stand-in
    that streams the layers."""
    x = inputs_embeds
    require_f32(x, "the VL language model")
    cos, sin = mrope_cos_sin(position_ids, cfg, x.device)
    mask = _causal_mask(x.shape[1], attention_mask, x.device)
    for lp in params.layers:
        x, _ = _decoder_layer(cfg, x, lp, cos, sin, mask)
    return _rms(params.norm, x, cfg.rms_norm_eps)


# ===========================================================================
# KV-cached greedy decoding (DreamOmni2's prompt enhancer)

def make_kv_cache(cfg: VLTextConfig, batch: int, max_len: int, dtype=torch.float32,
                  device=None) -> dict:
    """{"k", "v"}: zeros [num_layers, B, max_len, n_kv, head_dim], as JAX's."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def text_prefill(params: TextModel, cfg: VLTextConfig, inputs_embeds, position_ids,
                 cache: dict) -> tuple[torch.Tensor, dict]:
    """`text_forward` (causal, no padding mask) that also writes every
    layer's k / v into cache[:, :, :S].  Returns (hidden [B, S, D], cache)."""
    x = inputs_embeds
    require_f32(x, "the VL language model")
    s = x.shape[1]
    cos, sin = mrope_cos_sin(position_ids, cfg, x.device)
    mask = _causal_mask(s, None, x.device)
    for li, lp in enumerate(params.layers):
        x, (k, v) = _decoder_layer(cfg, x, lp, cos, sin, mask)
        cache["k"][li, :, :s] = k.to(cache["k"].dtype)
        cache["v"][li, :, :s] = v.to(cache["v"].dtype)
    return _rms(params.norm, x, cfg.rms_norm_eps), cache


@torch.no_grad()
def text_decode_step(params: TextModel, cfg: VLTextConfig, embed, position_ids, cache: dict,
                     cache_len: int) -> tuple[torch.Tensor, dict]:
    """One decoding step: embed [B, 1, D] at M-RoPE positions [3, B, 1],
    its k / v written at slot `cache_len`, attending over the cache's slots
    0 … cache_len (JAX masks the rest of the fixed-size cache with −1e30
    and attends over all max_len slots; a masked slot's weight is an exact
    0, so the port attends over the live slots alone).  Returns (hidden
    [B, D] through the final norm, cache)."""
    x = embed
    require_f32(x, "the VL language model")
    cos, sin = mrope_cos_sin(position_ids, cfg, x.device)
    n = cache_len + 1
    for li, lp in enumerate(params.layers):
        q, k, v = _qkv(cfg, lp, x, cos, sin)
        cache["k"][li, :, cache_len] = k[:, 0].to(cache["k"].dtype)
        cache["v"][li, :, cache_len] = v[:, 0].to(cache["v"].dtype)
        o = _attend(cfg, q, cache["k"][li, :, :n].to(x.dtype), cache["v"][li, :, :n].to(x.dtype))
        x = _finish_layer(cfg, lp, x, o)
    return _rms(params.norm, x, cfg.rms_norm_eps)[:, 0], cache


# ===========================================================================
# checkpoints (transformers Qwen2_5_VLForConditionalGeneration names)

def load_from_state_dict(sd: Mapping, vcfg: VLVisionConfig, tcfg: VLTextConfig,
                         device=None, lm_head: bool = False):
    """The vision tower and the LM on `device` (and with `lm_head` the LM
    head, a `Dense` [hidden → vocab] from `lm_head.weight` or the tied
    embedding, `convert_vl_lm_head`), read from a checkpoint one vision
    block and one decoder layer at a time through the port's converters
    (`models/qwen/porting.py`, either prefix form), so the host holds one
    layer's f32 copy at a time.  Every tensor read is recorded: the keys no
    converter read (`lm_head.weight` among them when the head is not
    asked for) are reported as the coverage audit does."""
    from qflux_tpu_torch.models import bridge, porting
    from qflux_tpu_torch.models.qwen import porting as qporting

    tsd = porting.TrackingStateDict(sd)
    vision = VisionTower(vcfg, device=device)
    top = qporting.vl_vision_top(tsd)
    bridge.load_params(vision.patch_embed, top["patch_embed"])
    bridge.load_params(vision.merger, top["merger"])
    vpre = qporting.vision_prefix(tsd)
    for i, blk in enumerate(vision.blocks):
        bridge.load_params(blk, qporting.vl_vision_block(tsd, vpre, i))
    text = TextModel(tcfg, device=device)
    top = qporting.vl_text_top(tsd)
    with torch.no_grad():
        text.embed_tokens.copy_(top["embed_tokens"])
    bridge.load_params(text.norm, top["norm"])
    tpre = qporting.text_prefix(tsd)
    for i, lp in enumerate(text.layers):
        bridge.load_params(lp, qporting.vl_text_layer(tsd, tpre, i))
    head = None
    if lm_head:
        head = Dense(tcfg.hidden_size, tcfg.vocab_size, bias=False, device=device,
                     dtype=torch.float32)
        bridge.load_params(head, qporting.convert_vl_lm_head(tsd))
    porting.report_unconsumed(tsd.unconsumed(), len(sd), "the Qwen2.5-VL converters")
    return (vision, text, head) if lm_head else (vision, text)
