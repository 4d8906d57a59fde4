"""Qwen-Image VAE (Wan 2.1 family causal 3D-conv VAE) in PyTorch: the
encoder and the decoder.

Counterpart of qflux_tpu/models/qwen/vae.py.  For image
editing every input is a single-frame video (T = 1), so each causal 3D conv
reduces to its LAST time tap (the current frame; the causal front padding
zeroes the others), as the JAX `_conv3d_t1`; the parameters keep the 3D
shapes ([cout, cin, kt, kh, kw] here, the JAX [kt, kh, kw, cin, cout]) so a
ported checkpoint loads unchanged.  The public boundary keeps the JAX
layout (NHWC latents in, NHWC images out); inside, the convolutions run
NCHW.  Channel RMS norms, single-head spatial attention in the mid block
(query-chunked past `flux.vae.ATTN_CHUNK` tokens, as the JAX decoder), and
nearest 2× upsampling followed by a 3×3 conv in the decoder, a zero pad
(0, 1, 0, 1) and a stride-2 3×3 conv in the encoder.  `encode` keeps the
mean half of the moments and normalizes it per channel by
`latents_mean` / `latents_std`.

Both halves run in float32 with TF32 off on the card (`encode_moments` and
`decode` raise otherwise, as the FLUX VAE's).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from qflux_tpu_torch.models.flux import vae as flux_vae
from qflux_tpu_torch.models.flux.vae import Conv
from qflux_tpu_torch.ops.layers import Dense, require_f32

# per-channel latent statistics of the released Qwen-Image VAE config
LATENTS_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
LATENTS_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)


@dataclasses.dataclass(frozen=True)
class QwenVAEConfig:
    base_dim: int = 96
    z_dim: int = 16
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    latents_mean: tuple[float, ...] = LATENTS_MEAN
    latents_std: tuple[float, ...] = LATENTS_STD

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)

    @classmethod
    def tiny(cls) -> "QwenVAEConfig":
        return cls(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                   latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4)


# ---------------------------------------------------------------------------
# modules (attribute names are the JAX tree's keys)

class Conv3(nn.Module):
    """A causal 3D conv: weight [cout, cin, kt, kh, kw], bias [cout]."""

    def __init__(self, kt, kh, kw, cin, cout, device=None, dtype=None):
        super().__init__()
        kwargs = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.empty(cout, cin, kt, kh, kw, **kwargs),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout, **kwargs), requires_grad=False)

    def init_(self, generator):
        """As `_c3`: U(±1/sqrt(kt·kh·kw·cin)) for kernel and bias."""
        cout, cin, kt, kh, kw = self.weight.shape
        bound = (1.0 / (kt * kh * kw * cin)) ** 0.5
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)


class RMSGamma(nn.Module):
    def __init__(self, c, device=None, dtype=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c, device=device, dtype=dtype), requires_grad=False)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.norm1 = RMSGamma(cin, **kw)
        self.conv1 = Conv3(3, 3, 3, cin, cout, **kw)
        self.norm2 = RMSGamma(cout, **kw)
        self.conv2 = Conv3(3, 3, 3, cout, cout, **kw)
        self.conv_shortcut = Conv3(1, 1, 1, cin, cout, **kw) if cin != cout else None


class AttnBlock(nn.Module):
    def __init__(self, c, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.norm = RMSGamma(c, **kw)
        self.to_qkv = Dense(c, 3 * c, **kw)
        self.proj = Dense(c, c, **kw)


class Mid(nn.Module):
    def __init__(self, c, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.res_0 = ResBlock(c, c, **kw)
        self.attn = AttnBlock(c, **kw)
        self.res_1 = ResBlock(c, c, **kw)


class DownBlock(nn.Module):
    def __init__(self, cin, cout, n_res, downsample, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        for j in range(n_res):
            self.add_module(f"res_{j}", ResBlock(cin if j == 0 else cout, cout, **kw))
        self.n_res = n_res
        self.down = Conv(3, 3, cout, cout, **kw) if downsample else None


class Encoder(nn.Module):
    """`quant_conv`: the WanVAE's 1×1 conv on the moments, which checkpoints
    carry (a channel linear, as the JAX tree keeps it)."""

    def __init__(self, cfg: QwenVAEConfig, device=None, dtype=None, quant_conv: bool = False):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dims = [cfg.base_dim * m for m in cfg.dim_mult]
        self.conv_in = Conv3(3, 3, 3, 3, dims[0], **kw)
        cin = dims[0]
        for i, cout in enumerate(dims):
            self.add_module(f"down_{i}", DownBlock(cin, cout, cfg.num_res_blocks,
                                                   i < len(dims) - 1, **kw))
            cin = cout
        self.mid = Mid(dims[-1], **kw)
        self.norm_out = RMSGamma(dims[-1], **kw)
        self.conv_out = Conv3(3, 3, 3, dims[-1], 2 * cfg.z_dim, **kw)
        if quant_conv:
            self.quant_conv = Dense(2 * cfg.z_dim, 2 * cfg.z_dim, **kw)


class UpBlock(nn.Module):
    def __init__(self, cin, cout, n_res, up_out, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        for j in range(n_res):
            self.add_module(f"res_{j}", ResBlock(cin if j == 0 else cout, cout, **kw))
        self.n_res = n_res
        self.up = Conv(3, 3, cout, up_out, **kw) if up_out else None


class Decoder(nn.Module):
    """`post_quant_conv`: the WanVAE's 1×1 conv on the latents, which
    checkpoints carry (a channel linear, as the JAX tree keeps it)."""

    def __init__(self, cfg: QwenVAEConfig, device=None, dtype=None,
                 post_quant_conv: bool = False):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        if post_quant_conv:
            self.post_quant_conv = Dense(cfg.z_dim, cfg.z_dim, **kw)
        rev = [cfg.base_dim * m for m in reversed(cfg.dim_mult)]
        self.conv_in = Conv3(3, 3, 3, cfg.z_dim, rev[0], **kw)
        self.mid = Mid(rev[0], **kw)
        cin = rev[0]
        for i, cout in enumerate(rev):
            up_out = rev[i + 1] if i < len(rev) - 1 else 0
            self.add_module(f"up_{i}", UpBlock(cin, cout, cfg.num_res_blocks + 1, up_out, **kw))
            cin = up_out or cout
        self.norm_out = RMSGamma(rev[-1], **kw)
        self.conv_out = Conv3(3, 3, 3, rev[-1], 3, **kw)


class QwenVAE(nn.Module):
    """{"encoder": ..., "decoder": ...} of the JAX VAE tree.
    `post_quant_conv`: the checkpoint's two 1×1 convs, the encoder's
    quant_conv and the decoder's post_quant_conv (a WanVAE checkpoint
    carries both)."""

    def __init__(self, cfg: QwenVAEConfig, device=None, dtype=None,
                 post_quant_conv: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device=device, dtype=dtype, quant_conv=post_quant_conv)
        self.decoder = Decoder(cfg, device=device, dtype=dtype, post_quant_conv=post_quant_conv)


def init(generator: torch.Generator, cfg: QwenVAEConfig, device=None,
         dtype=torch.float32) -> QwenVAE:
    """Random decoder and encoder weights (drawn in that order) with the
    `_c3` / `_c2` / `_lin` bounds and unit RMS gammas."""
    model = QwenVAE(cfg, device=device, dtype=dtype)
    with torch.no_grad():
        # the decoder first: its draws stay those of a decoder-only VAE
        for half in (model.decoder, model.encoder):
            for mod in half.modules():
                if isinstance(mod, (Conv3, Conv, Dense)):
                    mod.init_(generator)
    return model


# ---------------------------------------------------------------------------
# apply (NCHW inside)

def _conv3d_t1(p: Conv3, x, spatial_pad=1):
    """The last time tap of the causal 3D conv, over x [B, C, H, W]."""
    w = p.weight[:, :, -1]
    return F.conv2d(x, w.to(x.dtype), p.bias.to(x.dtype), padding=spatial_pad)


def _rms_norm_ch(p: RMSGamma, x, eps=1e-12):
    """Wan RMS_norm: L2-normalize over channels × sqrt(C) × gamma."""
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=1, keepdim=True) + eps)
    c = x.shape[1]
    return (x32 / norm * (c ** 0.5) * p.gamma.float()[None, :, None, None]).to(x.dtype)


def _resblock(p: ResBlock, x):
    h = _conv3d_t1(p.conv1, F.silu(_rms_norm_ch(p.norm1, x)))
    h = _conv3d_t1(p.conv2, F.silu(_rms_norm_ch(p.norm2, h)))
    if p.conv_shortcut is not None:
        x = _conv3d_t1(p.conv_shortcut, x, spatial_pad=0)
    return x + h


def _attn_block(p: AttnBlock, x):
    b, c, h, w = x.shape
    s = h * w
    y = _rms_norm_ch(p.norm, x).reshape(b, c, s).transpose(1, 2)
    qkv = flux_vae._lin(p.to_qkv, y)
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    if s > flux_vae.ATTN_CHUNK:
        cq = flux_vae.ATTN_CHUNK
        while s % cq:  # largest power-of-two divisor of S ≤ the chunk target
            cq //= 2
        o = torch.cat([flux_vae._sdpa(q[:, i:i + cq], k, v, c) for i in range(0, s, cq)], dim=1)
    else:
        o = flux_vae._sdpa(q, k, v, c)
    o = flux_vae._lin(p.proj, o)
    return x + o.transpose(1, 2).reshape(b, c, h, w)


def _mid(p: Mid, x):
    x = _resblock(p.res_0, x)
    x = _attn_block(p.attn, x)
    return _resblock(p.res_1, x)


def encode_moments(params: QwenVAE, cfg: QwenVAEConfig, images):
    """images [B, H, W, 3] in [-1, 1] → moments [B, H/8, W/8, 2·z_dim] (f32;
    TF32 must be off on the card)."""
    require_f32(images, "the VAE encoder")
    enc = params.encoder
    x = _conv3d_t1(enc.conv_in, images.permute(0, 3, 1, 2))
    for i in range(len(cfg.dim_mult)):
        blk = getattr(enc, f"down_{i}")
        for j in range(blk.n_res):
            x = _resblock(getattr(blk, f"res_{j}"), x)
        if blk.down is not None:
            # Wan's downsample2d: zero pad (0, 1, 0, 1), then stride 2, no padding
            x = flux_vae._conv(blk.down, F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)
    x = _mid(enc.mid, x)
    x = F.silu(_rms_norm_ch(enc.norm_out, x))
    x = _conv3d_t1(enc.conv_out, x).permute(0, 2, 3, 1)
    if hasattr(enc, "quant_conv"):
        x = flux_vae._lin(enc.quant_conv, x)
    return x


def encode(params: QwenVAE, cfg: QwenVAEConfig, images):
    """images [B, H, W, 3] in [-1, 1] → normalized latents [B, H/8, W/8, z]:
    the mode of the diagonal Gaussian (the mean half of the moments),
    normalized per channel by latents_mean / latents_std."""
    moments = encode_moments(params, cfg, images)
    mean = moments[..., : cfg.z_dim]
    mu = torch.tensor(cfg.latents_mean, dtype=mean.dtype, device=mean.device)
    std = torch.tensor(cfg.latents_std, dtype=mean.dtype, device=mean.device)
    return (mean - mu) / std


def decode(params: QwenVAE, cfg: QwenVAEConfig, latents):
    """Normalized latents [B, h, w, z] → images [B, H, W, 3] in [-1, 1]."""
    require_f32(latents, "VAE decode")
    std = torch.tensor(cfg.latents_std, dtype=latents.dtype, device=latents.device)
    mean = torch.tensor(cfg.latents_mean, dtype=latents.dtype, device=latents.device)
    z = latents * std + mean
    dec = params.decoder
    if hasattr(dec, "post_quant_conv"):
        z = flux_vae._lin(dec.post_quant_conv, z)
    x = _conv3d_t1(dec.conv_in, z.permute(0, 3, 1, 2))
    x = _mid(dec.mid, x)
    for i in range(len(cfg.dim_mult)):
        blk = getattr(dec, f"up_{i}")
        for j in range(blk.n_res):
            x = _resblock(getattr(blk, f"res_{j}"), x)
        if blk.up is not None:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = flux_vae._conv(blk.up, x)
    x = F.silu(_rms_norm_ch(dec.norm_out, x))
    return _conv3d_t1(dec.conv_out, x).permute(0, 2, 3, 1)
