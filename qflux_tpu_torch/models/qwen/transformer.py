"""Qwen-Image MMDiT (60 dual-stream blocks) in PyTorch.

Counterpart of qflux_tpu/models/qwen/transformer.py.  The JAX model scans
one traced block over stacked `[60, ...]` leaves; here the blocks are
`QwenBlock` modules in an `nn.ModuleList`, run in a Python loop.  The math,
layouts and cast points are the JAX package's: per-stream AdaLN (SiLU(temb)
→ Linear(dim → 6·dim) → two (shift, scale, gate) triples, computed in f32),
LayerNorm without affine, joint attention over [txt, img] with qk-RMSNorm +
rotate-half RoPE through `ops.attention.qk_norm_rope_attention` (on the
card JAX's one-chip route: the fused kernel K1 where `flash_nr.supports`
holds, as at 512², else the plain norm + rope and kernel K3, as at 832×576;
the scale pairs are [norm_added_*, norm_*], row 0 for the text rows < st), GELU-tanh MLPs, temb from the sinusoidal-256 embedding
only.  The dense layers may hold quantized weights in any form of
ops/layers.py: over the int4-requant base the large products run kernel
K5a and their input gradients kernel K5b; over the W4A16 (`int4`) base
with QFLUX_FUSED_INT4=1, every product of a shape JAX's fused kernel takes
(K % 3072, N % 128) runs kernel K6a and its input gradient kernel K6b;
over the W8A8 (`int8_dynamic`) base the large products run the int8 GEMM
of csrc/int8_gemm.cu.

The 20B model is 40.8 GB in bf16: `init` draws the blocks one at a time
and, given a quantize config, quantizes each block as it is drawn, so the
bf16 tree never exists whole (the int4 DiT is ~11.5 GB, the int8 one
~20 GB).

Training recomputes each block in backward under the remat policies of
models/flux/transformer.py (`_remat`, every policy of the JAX forward;
"flash_single" is "flash" here, as in JAX, the architecture having one
kind of block; the published 832×576 config runs "flash_offload").  A
policy applies only when autograd records (predict never applies one); an
unknown name raises either way.  The per-block
AdaLN mods are computed outside the checkpointed region from temb, which
depends on σ alone: nothing records for them, so no dequantized mod weight
is ever saved for backward, and over the W4A16 base their M = B rows launch
K6a but never K6b.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from qflux_tpu_torch.models.common.embeddings import mlp_silu, sinusoidal_embedding
from qflux_tpu_torch.models.flux.transformer import (AdaProj, DualAttn, RMSScale, _remat,
                                                     qkv_keeps)
from qflux_tpu_torch.ops import remat
from qflux_tpu_torch.ops.attention import qk_norm_rope_attention
from qflux_tpu_torch.ops.layers import MLP, Dense, dense
from qflux_tpu_torch.ops.norms import ada_ln_mods, layer_norm, modulate, rms_norm
from qflux_tpu_torch.ops.rope import qwen_rope


@dataclasses.dataclass(frozen=True)
class QwenImageConfig:
    patch_size: int = 2
    in_channels: int = 64
    out_channels: int = 16
    num_layers: int = 60
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 3584
    guidance_embeds: bool = False
    axes_dims_rope: tuple[int, ...] = (16, 56, 56)
    mlp_ratio: float = 4.0
    scale_rope: bool = True

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def tiny(cls) -> "QwenImageConfig":
        """Test-scale topology, as the JAX package's QwenImageConfig.tiny()."""
        return cls(num_layers=2, attention_head_dim=32, num_attention_heads=4,
                   joint_attention_dim=48, in_channels=16, out_channels=4,
                   axes_dims_rope=(8, 12, 12))


# ---------------------------------------------------------------------------
# modules (attribute names are the JAX tree's keys)

class QwenBlock(nn.Module):
    def __init__(self, cfg: QwenImageConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dim, hidden = cfg.dim, int(cfg.dim * cfg.mlp_ratio)
        self.img_mod = AdaProj(dim, 6, **kw)
        self.txt_mod = AdaProj(dim, 6, **kw)
        self.attn = DualAttn(cfg, **kw)
        self.img_mlp = MLP(dim, hidden, **kw)
        self.txt_mlp = MLP(dim, hidden, **kw)

    def forward(self, fn, img, txt, temb_s):
        """`fn(self, img, txt, img_mod, txt_mod)` (`_block`, under its
        checkpoint in training) after the f32 mods ("mod_out"), computed
        here and outside the checkpoint.  A module call, so that FSDP2's
        hooks gather a sharded block's weights before its forward and
        before the recompute in backward."""
        return fn(self, img, txt, dense(self.img_mod.proj, temb_s),
                  dense(self.txt_mod.proj, temb_s))


class QwenImageTransformer(nn.Module):
    """`blocks=False` leaves the block list empty, for `init` to fill."""

    def __init__(self, cfg: QwenImageConfig, device=None, dtype=None, blocks: bool = True):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dim = cfg.dim
        self.cfg = cfg
        self.img_in = Dense(cfg.in_channels, dim, **kw)
        self.txt_norm = RMSScale(cfg.joint_attention_dim, **kw)
        self.txt_in = Dense(cfg.joint_attention_dim, dim, **kw)
        self.time_in = MLP(256, dim, out_dim=dim, **kw)
        if cfg.guidance_embeds:
            self.guidance_in = MLP(256, dim, out_dim=dim, **kw)
        self.blocks = nn.ModuleList(QwenBlock(cfg, **kw) for _ in range(cfg.num_layers if blocks
                                                                       else 0))
        self.norm_out = AdaProj(dim, 2, **kw)
        self.proj_out = Dense(dim, cfg.patch_size ** 2 * cfg.out_channels, **kw)

    def forward(self, cfg: QwenImageConfig, *args, **kwargs):
        """The module-level `forward` over this model, through a module call
        (FSDP2's root hooks, `parallel/partitioning.py:shard_base`)."""
        return _forward(self, cfg, *args, **kwargs)


def _init_denses(module: nn.Module, generator: torch.Generator) -> None:
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, Dense):
                mod.init_(generator)


def init(generator: torch.Generator, cfg: QwenImageConfig, device=None,
         dtype=torch.bfloat16, quantize=None, mesh=None) -> QwenImageTransformer:
    """Random weights on `device` from `generator`, with `dense_init`'s
    bounds (U(±1/sqrt(in)) for kernel and bias) and unit norm scales.  The
    blocks are drawn one at a time; with `quantize` (a quantize config, as
    ops/quant.quantize_tree takes) each block is quantized right after it is
    drawn, so only one block's full-precision weights exist at a time; with
    `mesh` (a parallel/mesh.Mesh) each block is then sharded over its fsdp
    ranks (`parallel/partitioning.py:shard_module`)."""
    from qflux_tpu_torch.ops.quant import quantize_tree
    from qflux_tpu_torch.parallel.partitioning import shard_module

    model = QwenImageTransformer(cfg, device=device, dtype=dtype, blocks=False)
    _init_denses(model, generator)
    for i in range(cfg.num_layers):
        block = QwenBlock(cfg, device=device, dtype=dtype)
        _init_denses(block, generator)
        if quantize is not None:
            quantize_tree(block, quantize, prefix=f"blocks/{i}/")
        if mesh is not None:
            shard_module(block, mesh, f"blocks/{i}/")
        model.blocks.append(block)
    return model


def load_from_state_dict(sd, cfg: QwenImageConfig, device=None, dtype=torch.bfloat16,
                         quantize=None, mesh=None) -> QwenImageTransformer:
    """The DiT from a diffusers state dict (`utils/safetensors.SafeTensors`
    reads it lazily), one block at a time, as `init` draws it: each block's
    tensors are read, converted (`models/qwen/porting.py`, in f32), loaded
    through the bridge in `dtype` on `device` and, with `quantize`,
    quantized right after, so no more than one block's full-precision
    weights exist at a time, on the host or the device; with `mesh`, each
    block is then sharded, as `init` shards it.  Tensors that no converter
    reads are reported in a warning."""
    from qflux_tpu_torch.models import porting
    from qflux_tpu_torch.models.bridge import load_params
    from qflux_tpu_torch.models.qwen.porting import qwen_block, qwen_transformer_top
    from qflux_tpu_torch.ops.quant import quantize_tree
    from qflux_tpu_torch.parallel.partitioning import shard_module

    tsd = porting.TrackingStateDict(sd)
    model = QwenImageTransformer(cfg, device=device, dtype=dtype, blocks=False)
    load_params(model, qwen_transformer_top(tsd))
    for i in range(cfg.num_layers):
        block = load_params(QwenBlock(cfg, device=device, dtype=dtype),
                            qwen_block(tsd, i, head_dim=cfg.attention_head_dim))
        if quantize is not None:
            quantize_tree(block, quantize, prefix=f"blocks/{i}/")
        if mesh is not None:
            shard_module(block, mesh, f"blocks/{i}/")
        model.blocks.append(block)
    porting.report_unconsumed(tsd.unconsumed(), len(sd), "the Qwen DiT loader")
    return model


# ---------------------------------------------------------------------------
# forward

def _heads(x, n):
    return x.reshape(x.shape[0], x.shape[1], n, -1)


def _joint_tables(txt_cos, txt_sin, vid_cos, vid_sin):
    """Per-stream rope tables → joint [S_txt + S_img, D] (or [B, S, D] when
    either side is per-sample)."""
    if txt_cos.dim() != vid_cos.dim():
        b = txt_cos.shape[0] if txt_cos.dim() == 3 else vid_cos.shape[0]

        def up(t):
            return t[None].expand(b, *t.shape) if t.dim() == 2 else t

        txt_cos, txt_sin, vid_cos, vid_sin = map(up, (txt_cos, txt_sin, vid_cos, vid_sin))
    return (torch.cat([txt_cos, vid_cos], dim=-2).contiguous(),
            torch.cat([txt_sin, vid_sin], dim=-2).contiguous())


def _modulate3(x, mod):
    """mod [B, 3D] → (modulated x, gate [B, 1, D]); chunk order shift, scale,
    gate."""
    shift, scale, gate = torch.chunk(mod, 3, dim=-1)
    return modulate(x, shift, scale), gate[:, None, :].to(x.dtype)


def _mlp(p: MLP, x):
    return dense(p.lin_out, F.gelu(dense(p.lin_in, x, keep=remat.MLP_H), approximate="tanh"))


def _block(p: QwenBlock, cfg, img, txt, img_mod, txt_mod, cos, sin, seg, attn_impl):
    n_h = cfg.num_attention_heads
    st = txt.shape[1]
    img_mod1, img_mod2 = torch.chunk(img_mod, 2, dim=-1)
    txt_mod1, txt_mod2 = torch.chunk(txt_mod, 2, dim=-1)

    img_n, img_gate1 = _modulate3(layer_norm(img), img_mod1)
    txt_n, txt_gate1 = _modulate3(layer_norm(txt), txt_mod1)

    a = p.attn
    # RAW q/k, joint order [txt, img]; qk-RMSNorm + rope run inside the fused
    # attention, the text rows (< st) with the norm_added_* scales
    kqk, kv = qkv_keeps(st + img.shape[1], cfg.attention_head_dim, attn_impl)
    q = torch.cat([_heads(dense(a.add_q, txt_n, keep=kqk), n_h),
                   _heads(dense(a.to_q, img_n, keep=kqk), n_h)], dim=1)
    k = torch.cat([_heads(dense(a.add_k, txt_n, keep=kqk), n_h),
                   _heads(dense(a.to_k, img_n, keep=kqk), n_h)], dim=1)
    v = torch.cat([_heads(dense(a.add_v, txt_n, keep=kv), n_h),
                   _heads(dense(a.to_v, img_n, keep=kv), n_h)], dim=1)
    qs2 = torch.stack([a.norm_added_q.scale, a.norm_q.scale])
    ks2 = torch.stack([a.norm_added_k.scale, a.norm_k.scale])
    o = qk_norm_rope_attention(q, k, v, qs2, ks2, cos, sin, st, segment_ids=seg, impl=attn_impl)
    o = o.reshape(o.shape[0], o.shape[1], -1)
    txt_attn, img_attn = o[:, :st], o[:, st:]

    img = img + img_gate1 * dense(a.to_out, img_attn)
    txt = txt + txt_gate1 * dense(a.add_out, txt_attn)

    img_n2, img_gate2 = _modulate3(layer_norm(img), img_mod2)
    img = img + img_gate2 * _mlp(p.img_mlp, img_n2)
    txt_n2, txt_gate2 = _modulate3(layer_norm(txt), txt_mod2)
    txt = txt + txt_gate2 * _mlp(p.txt_mlp, txt_n2)
    return img, txt


def forward(params: QwenImageTransformer, cfg: QwenImageConfig, *args, **kwargs):
    """Returns [B, S_img, patch²·out_channels] over the full image stream;
    the arguments are `_forward`'s.  Runs as a call of `params`, and each
    block as a call of its module, so that a base sharded by FSDP2 is
    gathered block by block."""
    return params(cfg, *args, **kwargs)


def _forward(params: QwenImageTransformer, cfg: QwenImageConfig,
             hidden_states,                  # [B, S_img, in_channels]
             encoder_hidden_states,          # [B, S_txt, joint_attention_dim]
             timestep,                       # [B] σ ∈ [0, 1]
             img_shapes: Optional[list] = None,  # [(f, h, w), …] per image plane
             guidance=None,
             segment_ids: Optional[torch.Tensor] = None,  # [B, S_txt + S_img]
             rope: Optional[tuple] = None,   # (vid_cos, vid_sin, txt_cos, txt_sin)
             attn_impl: str = "auto",
             remat: bool = True,
             remat_policy: str = "full"):
    """Returns [B, S_img, patch²·out_channels] over the full image stream.
    With `remat` and autograd recording, every block is recomputed in
    backward under `remat_policy`; without autograd (inference) nothing is,
    whatever the policy names."""
    img = dense(params.img_in, hidden_states)
    txt = rms_norm(encoder_hidden_states, params.txt_norm.scale)
    txt = dense(params.txt_in, txt)

    temb = mlp_silu(params.time_in, sinusoidal_embedding(timestep))
    if cfg.guidance_embeds and guidance is not None:
        temb = temb + mlp_silu(params.guidance_in, sinusoidal_embedding(guidance))
    temb = temb.to(img.dtype)

    if rope is None:
        rope = [t.to(img.device) for t in qwen_rope(
            img_shapes, txt.shape[1], cfg.axes_dims_rope, scale_rope=cfg.scale_rope)]
    vid_cos, vid_sin, txt_cos, txt_sin = (t.float() for t in rope)
    cos, sin = _joint_tables(txt_cos, txt_sin, vid_cos, vid_sin)

    def block_fn(p, img, txt, img_mod, txt_mod):
        return _block(p, cfg, img, txt, img_mod, txt_mod, cos, sin, segment_ids, attn_impl)

    if remat:  # the policy is checked even where nothing records for backward
        remat_block = _remat(block_fn, remat_policy, "qwen")
        if torch.is_grad_enabled():
            block_fn = remat_block
    temb_s = F.silu(temb.float())
    for p in params.blocks:
        # the "mod_out" save point: f32 mods computed outside the block
        img, txt = p(block_fn, img, txt, temb_s)

    scale, shift = ada_ln_mods(params.norm_out.proj, temb, 2)
    img = modulate(layer_norm(img), shift, scale)
    return dense(params.proj_out, img)
