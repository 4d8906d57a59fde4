"""AutoencoderKL (FLUX VAE) in PyTorch: the encoder and the decoder.

Counterpart of qflux_tpu/models/flux/vae.py.  The public boundary keeps the
JAX layout (NHWC images / latents in and out); inside, the convolutions run
NCHW through `F.conv2d`.  The mid-block attention is plain matmul +
softmax, as the JAX `_sdpa` is plain XLA.

Both halves run in float32, as JAX runs them.  On the card, float32
convolutions and matmuls must not silently run in TF32 (cuDNN takes TF32
for f32 convolutions by default, ~1e-3 off): `encode_moments` and `decode`
raise unless `torch.backends.cudnn.allow_tf32` and
`torch.backends.cuda.matmul.allow_tf32` are False (`ops.layers.require_f32`;
the Trainer turns both off on the card).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from qflux_tpu_torch.ops.layers import Dense, require_f32


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 16
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(8, 16), layers_per_block=1,
                   latent_channels=4, norm_num_groups=4,
                   scaling_factor=1.0, shift_factor=0.0)


# ---------------------------------------------------------------------------
# modules (attribute names are the JAX tree's keys)

class Conv(nn.Module):
    """weight OIHW (the JAX tree's kernel is HWIO), bias [O]."""

    def __init__(self, kh, kw, cin, cout, device=None, dtype=None):
        super().__init__()
        kwargs = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw, **kwargs), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout, **kwargs), requires_grad=False)

    def init_(self, generator):
        """As `_conv_init`: U(±1/sqrt(kh·kw·cin)) for kernel and bias."""
        cout, cin, kh, kw = self.weight.shape
        bound = (1.0 / (kh * kw * cin)) ** 0.5
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)


class GroupNormParams(nn.Module):
    def __init__(self, c, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c, device=device, dtype=dtype), requires_grad=False)


class Resnet(nn.Module):
    def __init__(self, cin, cout, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.norm1 = GroupNormParams(cin, **kw)
        self.conv1 = Conv(3, 3, cin, cout, **kw)
        self.norm2 = GroupNormParams(cout, **kw)
        self.conv2 = Conv(3, 3, cout, cout, **kw)
        self.conv_shortcut = Conv(1, 1, cin, cout, **kw) if cin != cout else None


class AttnBlock(nn.Module):
    def __init__(self, c, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.group_norm = GroupNormParams(c, **kw)
        for name in ("to_q", "to_k", "to_v", "to_out"):
            self.add_module(name, Dense(c, c, **kw))


class MidBlock(nn.Module):
    def __init__(self, c, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.resnets_0 = Resnet(c, c, **kw)
        self.attentions_0 = AttnBlock(c, **kw)
        self.resnets_1 = Resnet(c, c, **kw)


class DownBlock(nn.Module):
    def __init__(self, cin, cout, n_resnets, downsample, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        for j in range(n_resnets):
            self.add_module(f"resnets_{j}", Resnet(cin if j == 0 else cout, cout, **kw))
        self.n_resnets = n_resnets
        self.downsample = Conv(3, 3, cout, cout, **kw) if downsample else None


class UpBlock(nn.Module):
    def __init__(self, cin, cout, n_resnets, upsample, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        for j in range(n_resnets):
            self.add_module(f"resnets_{j}", Resnet(cin if j == 0 else cout, cout, **kw))
        self.n_resnets = n_resnets
        self.upsample = Conv(3, 3, cout, cout, **kw) if upsample else None


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        ch = cfg.block_out_channels
        self.conv_in = Conv(3, 3, cfg.in_channels, ch[0], **kw)
        cin = ch[0]
        for i, cout in enumerate(ch):
            self.add_module(f"down_{i}", DownBlock(cin, cout, cfg.layers_per_block,
                                                    i < len(ch) - 1, **kw))
            cin = cout
        self.mid = MidBlock(ch[-1], **kw)
        self.norm_out = GroupNormParams(ch[-1], **kw)
        self.conv_out = Conv(3, 3, ch[-1], 2 * cfg.latent_channels, **kw)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        ch = cfg.block_out_channels
        self.conv_in = Conv(3, 3, cfg.latent_channels, ch[-1], **kw)
        self.mid = MidBlock(ch[-1], **kw)
        rev = list(reversed(ch))
        cin = ch[-1]
        for i, cout in enumerate(rev):
            self.add_module(f"up_{i}", UpBlock(cin, cout, cfg.layers_per_block + 1,
                                                i < len(rev) - 1, **kw))
            cin = cout
        self.norm_out = GroupNormParams(ch[0], **kw)
        self.conv_out = Conv(3, 3, ch[0], cfg.out_channels, **kw)


class VAE(nn.Module):
    """{"encoder": ..., "decoder": ...} of the JAX VAE tree."""

    def __init__(self, cfg: VAEConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device=device, dtype=dtype)
        self.decoder = Decoder(cfg, device=device, dtype=dtype)


def init(generator: torch.Generator, cfg: VAEConfig, device=None,
         dtype=torch.float32) -> VAE:
    """Random decoder and encoder weights (drawn in that order) with
    `_conv_init`/`_dense_init` bounds, unit group-norm scales and zero
    group-norm biases."""
    model = VAE(cfg, device=device, dtype=dtype)
    with torch.no_grad():
        # the decoder first: its draws stay those of a decoder-only VAE
        for half in (model.decoder, model.encoder):
            for mod in half.modules():
                if isinstance(mod, (Conv, Dense)):
                    mod.init_(generator)
    return model


# ---------------------------------------------------------------------------
# apply (NCHW inside)

def _conv(p: Conv, x, stride=1, padding=1):
    return F.conv2d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), stride=stride, padding=padding)


def _group_norm(p: GroupNormParams, x, groups, eps=1e-6):
    y = F.group_norm(x.float(), groups, eps=eps)
    return (y * p.scale[None, :, None, None] + p.bias[None, :, None, None]).to(x.dtype)


def _resnet(p: Resnet, x, groups):
    h = _conv(p.conv1, F.silu(_group_norm(p.norm1, x, groups)))
    h = _conv(p.conv2, F.silu(_group_norm(p.norm2, h, groups)))
    if p.conv_shortcut is not None:
        x = _conv(p.conv_shortcut, x, padding=0)
    return x + h


# past this sequence length the spatial attention runs query-chunked, as the
# JAX decoder does: O(S·chunk) score memory instead of O(S²)
ATTN_CHUNK = 4096


def _lin(p: Dense, y):
    return torch.matmul(y, p.weight.to(y.dtype).t()) + p.bias.to(y.dtype)


def _sdpa(q, k, v, c):
    logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
    probs = torch.softmax(logits / (c ** 0.5), dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkc->bqc", probs, v)


def _attn_block(p: AttnBlock, x, groups):
    """Single-head spatial self-attention (diffusers Attention in the VAE
    mid block)."""
    b, c, h, w = x.shape
    s = h * w
    y = _group_norm(p.group_norm, x, groups).reshape(b, c, s).transpose(1, 2)
    q, k, v = _lin(p.to_q, y), _lin(p.to_k, y), _lin(p.to_v, y)
    if s > ATTN_CHUNK:
        cq = ATTN_CHUNK
        while s % cq:  # largest divisor of S that is ≤ the chunk target
            cq //= 2
        o = torch.cat([_sdpa(q[:, i:i + cq], k, v, c) for i in range(0, s, cq)], dim=1)
    else:
        o = _sdpa(q, k, v, c)
    o = _lin(p.to_out, o)
    return x + o.transpose(1, 2).reshape(b, c, h, w)


def _mid_block(p: MidBlock, x, groups):
    x = _resnet(p.resnets_0, x, groups)
    x = _attn_block(p.attentions_0, x, groups)
    return _resnet(p.resnets_1, x, groups)


def encode_moments(params: VAE, cfg: VAEConfig, images):
    """images [B, H, W, 3] in [-1, 1] → moments [B, H/8, W/8, 2*latent_ch]
    (f32; TF32 must be off on the card)."""
    require_f32(images, "the VAE encoder")
    g = cfg.norm_num_groups
    enc = params.encoder
    x = _conv(enc.conv_in, images.permute(0, 3, 1, 2))
    for i in range(len(cfg.block_out_channels)):
        blk = getattr(enc, f"down_{i}")
        for j in range(blk.n_resnets):
            x = _resnet(getattr(blk, f"resnets_{j}"), x, g)
        if blk.downsample is not None:
            # diffusers pads (0,1,0,1) then strides 2 with no padding
            x = _conv(blk.downsample, F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)
    x = _mid_block(enc.mid, x, g)
    x = F.silu(_group_norm(enc.norm_out, x, g))
    return _conv(enc.conv_out, x).permute(0, 2, 3, 1)


def encode(params: VAE, cfg: VAEConfig, images):
    """Deterministic latents: the mode of the diagonal Gaussian (the mean
    half of the moments), shift / scale normalized."""
    moments = encode_moments(params, cfg, images)
    mean = moments[..., : cfg.latent_channels]
    return (mean - cfg.shift_factor) * cfg.scaling_factor


def decode(params: VAE, cfg: VAEConfig, latents):
    """Normalized latents [B, h, w, C] → images [B, H, W, 3] in [-1, 1]."""
    require_f32(latents, "VAE decode")
    g = cfg.norm_num_groups
    z = latents / cfg.scaling_factor + cfg.shift_factor
    dec = params.decoder
    x = _conv(dec.conv_in, z.permute(0, 3, 1, 2))
    x = _mid_block(dec.mid, x, g)
    for i in range(len(cfg.block_out_channels)):
        blk = getattr(dec, f"up_{i}")
        for j in range(blk.n_resnets):
            x = _resnet(getattr(blk, f"resnets_{j}"), x, g)
        if blk.upsample is not None:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = _conv(blk.upsample, x)
    x = F.silu(_group_norm(dec.norm_out, x, g))
    return _conv(dec.conv_out, x).permute(0, 2, 3, 1)
