"""FLUX MMDiT (19 dual-stream + 38 single-stream blocks) in PyTorch.

Counterpart of qflux_tpu/models/flux/transformer.py.  The JAX model is a
pure function over a stacked-leaf pytree iterated with `lax.scan`; here the
blocks are `DualBlock`/`SingleBlock` modules held in `nn.ModuleList`s and run
in a Python loop.  The math, the layouts and the cast points are the JAX
package's: rotate-half RoPE with q/k channels permuted by the JAX weight
converter, the split single-block `proj_out`/`proj_out_mlp`, and joint
attention through `ops.attention.qk_norm_rope_attention`, which runs on the
card the kernels JAX runs on one TPU chip: the fused K1 forward / K2
backward where `flash_nr.supports` holds (FLUX at 512²), else the plain
norm + rope and K3 / K4.

Training recomputes each block in backward (`remat`, the JAX package's
`jax.checkpoint` per scanned block) with non-reentrant
`torch.utils.checkpoint`, under every policy of the JAX forward, each
keeping per block what JAX's keeps (ops/remat.py: one store per block,
filled in its forward and read back in its recompute): "full" keeps
nothing; "flash" (the config default) the attention op's out and lse, K1's
`qflux::flash_nr_fwd` or K3's `qflux::flash_fwd`, so backward runs K2 or
K4 on them without a second forward kernel; "flash_offload" the same pair
in pinned host memory between the forward and the recompute (JAX's offload
to pinned_host: none of it on the device in between, the same gradients
to the bit); "flash_qkv" also the q / k / v that reach the kernel (the raw
projections on K1's route; on K3's the normed and roped q / k and the raw
v, whose projection the recompute skips, while the q / k projections run
again for the norm + rope's backward, as in JAX);
"flash_mlp" also each MLP's pre-activation (`mlp_h`); "flash_single"
"full" on the dual blocks and "flash" on the single ones; "dots"
(`mesh.remat: minimal`) the output of every product with no batch
dimension, the base product of every dense layer and both LoRA products,
but not the attention kernels' (a pallas_call is no dot), so the recompute
runs no GEMM and relaunches K1; "dots_all" also the batched products (the
W4A8 per-group route's).  The AdaLN modulation vectors ("mod_out" in JAX)
are computed outside the checkpointed block and passed in: saved by
construction, their f32 GEMV never reruns in backward.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from qflux_tpu_torch.models.common.embeddings import mlp_silu, sinusoidal_embedding
from qflux_tpu_torch.ops import remat
from qflux_tpu_torch.ops.attention import fused_route, qk_norm_rope_attention
from qflux_tpu_torch.ops.layers import MLP, Dense, dense
from qflux_tpu_torch.ops.norms import ada_ln_mods, layer_norm, modulate
from qflux_tpu_torch.ops.rope import rope_from_coords


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    patch_size: int = 1
    in_channels: int = 64
    out_channels: int = 64
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True  # FLUX.1-Kontext-dev is guidance-distilled
    axes_dims_rope: tuple[int, ...] = (16, 56, 56)
    mlp_ratio: float = 4.0

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def tiny(cls) -> "FluxConfig":
        """Test-scale topology, as the JAX package's FluxConfig.tiny()."""
        return cls(num_layers=2, num_single_layers=4, attention_head_dim=32,
                   num_attention_heads=4, joint_attention_dim=64,
                   in_channels=16, out_channels=16,
                   pooled_projection_dim=32, axes_dims_rope=(8, 12, 12))


# ---------------------------------------------------------------------------
# modules

class RMSScale(nn.Module):
    """The learned scale of a qk-RMSNorm ({"scale": [D]} in the JAX tree)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype),
                                  requires_grad=False)


class AdaProj(nn.Module):
    """AdaLN modulation projection ({"proj": dense} in the JAX tree)."""

    def __init__(self, dim: int, n_mods: int, device=None, dtype=None):
        super().__init__()
        self.proj = Dense(dim, n_mods * dim, device=device, dtype=dtype)


class DualAttn(nn.Module):
    def __init__(self, cfg: FluxConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dim, dh = cfg.dim, cfg.attention_head_dim
        for name in ("to_q", "to_k", "to_v", "to_out", "add_q", "add_k", "add_v", "add_out"):
            self.add_module(name, Dense(dim, dim, **kw))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            self.add_module(name, RMSScale(dh, **kw))


class SingleAttn(nn.Module):
    def __init__(self, cfg: FluxConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dim, dh = cfg.dim, cfg.attention_head_dim
        for name in ("to_q", "to_k", "to_v"):
            self.add_module(name, Dense(dim, dim, **kw))
        for name in ("norm_q", "norm_k"):
            self.add_module(name, RMSScale(dh, **kw))


class DualBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dim, hidden = cfg.dim, int(cfg.dim * cfg.mlp_ratio)
        self.img_mod = AdaProj(dim, 6, **kw)
        self.txt_mod = AdaProj(dim, 6, **kw)
        self.attn = DualAttn(cfg, **kw)
        self.img_mlp = MLP(dim, hidden, **kw)
        self.txt_mlp = MLP(dim, hidden, **kw)

    def forward(self, fn, img, txt, temb):
        """`fn(self, img, txt, i_mods, t_mods)` (`_dual_block`, under its
        checkpoint in training) after the AdaLN mods, computed here and
        outside the checkpoint.  A module call, so that FSDP2's hooks gather
        a sharded block's weights before its forward and before the
        recompute in backward."""
        return fn(self, img, txt, ada_ln_mods(self.img_mod.proj, temb, 6),
                  ada_ln_mods(self.txt_mod.proj, temb, 6))


class SingleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dim, hidden = cfg.dim, int(cfg.dim * cfg.mlp_ratio)
        self.mod = AdaProj(dim, 3, **kw)
        self.attn = SingleAttn(cfg, **kw)
        self.proj_mlp = Dense(dim, hidden, **kw)
        # split proj_out, as the JAX tree: o @ W[:d] (+ bias) + mlp @ W[d:]
        self.proj_out = Dense(dim, dim, **kw)
        self.proj_out_mlp = Dense(hidden, dim, bias=False, **kw)

    def forward(self, fn, x, temb):
        """`fn(self, x, mods)` after the AdaLN mods, as `DualBlock.forward`."""
        return fn(self, x, ada_ln_mods(self.mod.proj, temb, 3))


class FluxTransformer(nn.Module):
    """`blocks=False` leaves the block lists empty, for a loader to fill."""

    def __init__(self, cfg: FluxConfig, device=None, dtype=None, blocks: bool = True):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dim = cfg.dim
        self.cfg = cfg
        self.x_embedder = Dense(cfg.in_channels, dim, **kw)
        self.context_embedder = Dense(cfg.joint_attention_dim, dim, **kw)
        self.time_in = MLP(256, dim, out_dim=dim, **kw)
        if cfg.pooled_projection_dim:
            self.pooled_in = MLP(cfg.pooled_projection_dim, dim, out_dim=dim, **kw)
        if cfg.guidance_embeds:
            self.guidance_in = MLP(256, dim, out_dim=dim, **kw)
        self.dual = nn.ModuleList(DualBlock(cfg, **kw)
                                  for _ in range(cfg.num_layers if blocks else 0))
        self.single = nn.ModuleList(SingleBlock(cfg, **kw)
                                    for _ in range(cfg.num_single_layers if blocks else 0))
        self.norm_out = AdaProj(dim, 2, **kw)
        self.proj_out = Dense(dim, cfg.patch_size ** 2 * cfg.out_channels, **kw)

    def forward(self, cfg: FluxConfig, *args, **kwargs):
        """The module-level `forward` over this model, through a module call
        (FSDP2's root hooks, `parallel/partitioning.py:shard_base`)."""
        return _forward(self, cfg, *args, **kwargs)


def init(generator: torch.Generator, cfg: FluxConfig, device=None,
         dtype=torch.bfloat16) -> FluxTransformer:
    """Random weights on `device` from `generator`, with `dense_init`'s
    bounds (U(±1/sqrt(in)) for kernel and bias) and unit norm scales."""
    model = FluxTransformer(cfg, device=device, dtype=dtype)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                mod.init_(generator)
    return model


def load_from_state_dict(sd, cfg: FluxConfig, device=None, dtype=torch.bfloat16,
                         quantize=None, mesh=None) -> FluxTransformer:
    """The DiT from a diffusers state dict (`utils/safetensors.SafeTensors`
    reads it lazily), one block at a time: each block's tensors are read,
    converted (`models/porting.py`, in f32, as the JAX loader converts),
    loaded through the bridge in `dtype` on `device` and, with `quantize`
    (a quantize config, as ops/quant.quantize_tree takes), quantized right
    after, so no more than one block's full-precision weights exist at a
    time, on the host or the device.  The parameters equal those of
    `bridge.load_params` over `porting.convert_flux_transformer` of the
    whole dict.  Tensors that no converter reads are reported in a
    warning.  With `mesh` (a parallel/mesh.Mesh) each block is sharded
    over its fsdp ranks as it loads (`parallel/partitioning.py:shard_module`)."""
    from qflux_tpu_torch.models import porting
    from qflux_tpu_torch.models.bridge import load_params
    from qflux_tpu_torch.ops.quant import quantize_tree
    from qflux_tpu_torch.parallel.partitioning import shard_module

    tsd = porting.TrackingStateDict(sd)
    dh = cfg.attention_head_dim
    model = FluxTransformer(cfg, device=device, dtype=dtype, blocks=False)
    load_params(model, porting.flux_transformer_top(tsd))
    for name, make, convert, n in (("dual", DualBlock, porting.flux_dual_block, cfg.num_layers),
                                   ("single", SingleBlock, porting.flux_single_block,
                                    cfg.num_single_layers)):
        for i in range(n):
            block = load_params(make(cfg, device=device, dtype=dtype),
                                convert(tsd, i, head_dim=dh))
            if quantize is not None:
                quantize_tree(block, quantize, prefix=f"{name}/{i}/")
            if mesh is not None:
                shard_module(block, mesh, f"{name}/{i}/")
            getattr(model, name).append(block)
    porting.report_unconsumed(tsd.unconsumed(), len(sd), "the FLUX DiT loader")
    return model


# ---------------------------------------------------------------------------
# forward

def _heads(x, n_heads):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1)


def _mlp(p: MLP, x):
    return dense(p.lin_out, F.gelu(dense(p.lin_in, x, keep=remat.MLP_H), approximate="tanh"))


def qkv_keeps(seq: int, head_dim: int, attn_impl: str):
    """The remat save points of the q / k and the v projections (QKV where
    their output reaches the attention kernel as it is: v always, q / k on
    the fused route only)."""
    return remat.QKV if fused_route(seq, seq, head_dim, attn_impl) else None, remat.QKV


def _dual_block(p: DualBlock, cfg, img, txt, i_mods, t_mods, cos, sin, seg, attn_impl):
    n_h = cfg.num_attention_heads
    st = txt.shape[1]

    i_shift, i_scale, i_gate, i_shift2, i_scale2, i_gate2 = i_mods
    t_shift, t_scale, t_gate, t_shift2, t_scale2, t_gate2 = t_mods

    img_n = modulate(layer_norm(img), i_shift, i_scale)
    txt_n = modulate(layer_norm(txt), t_shift, t_scale)

    a = p.attn
    # RAW q/k: the norm and rope run inside the fused attention (txt rows
    # < st norm with the norm_added_* scales, img rows with norm_q/norm_k)
    kqk, kv = qkv_keeps(st + img.shape[1], cfg.attention_head_dim, attn_impl)
    q = torch.cat([_heads(dense(a.add_q, txt_n, keep=kqk), n_h),
                   _heads(dense(a.to_q, img_n, keep=kqk), n_h)], dim=1)
    k = torch.cat([_heads(dense(a.add_k, txt_n, keep=kqk), n_h),
                   _heads(dense(a.to_k, img_n, keep=kqk), n_h)], dim=1)
    v = torch.cat([_heads(dense(a.add_v, txt_n, keep=kv), n_h),
                   _heads(dense(a.to_v, img_n, keep=kv), n_h)], dim=1)
    qs2 = torch.stack([a.norm_added_q.scale, a.norm_q.scale])
    ks2 = torch.stack([a.norm_added_k.scale, a.norm_k.scale])

    o = qk_norm_rope_attention(q, k, v, qs2, ks2, cos, sin, st,
                               segment_ids=seg, impl=attn_impl)
    o = o.reshape(o.shape[0], o.shape[1], -1)
    txt_attn, img_attn = o[:, :st], o[:, st:]

    img = img + i_gate[:, None, :].to(img.dtype) * dense(a.to_out, img_attn)
    img_mlp_in = modulate(layer_norm(img), i_shift2, i_scale2)
    img = img + i_gate2[:, None, :].to(img.dtype) * _mlp(p.img_mlp, img_mlp_in)

    txt = txt + t_gate[:, None, :].to(txt.dtype) * dense(a.add_out, txt_attn)
    txt_mlp_in = modulate(layer_norm(txt), t_shift2, t_scale2)
    txt = txt + t_gate2[:, None, :].to(txt.dtype) * _mlp(p.txt_mlp, txt_mlp_in)
    return img, txt


def _single_block(p: SingleBlock, cfg, x, mods, cos, sin, seg, attn_impl):
    n_h = cfg.num_attention_heads
    shift, scale, gate = mods
    x_n = modulate(layer_norm(x), shift, scale)

    a = p.attn
    kqk, kv = qkv_keeps(x.shape[1], cfg.attention_head_dim, attn_impl)
    q = _heads(dense(a.to_q, x_n, keep=kqk), n_h)
    k = _heads(dense(a.to_k, x_n, keep=kqk), n_h)
    v = _heads(dense(a.to_v, x_n, keep=kv), n_h)
    # single-stream: one scale for every row (st=0 → row 1 of the pair)
    qs2 = torch.stack([a.norm_q.scale, a.norm_q.scale])
    ks2 = torch.stack([a.norm_k.scale, a.norm_k.scale])
    o = qk_norm_rope_attention(q, k, v, qs2, ks2, cos, sin, 0,
                               segment_ids=seg, impl=attn_impl)
    o = o.reshape(o.shape[0], o.shape[1], -1)

    mlp = F.gelu(dense(p.proj_mlp, x_n, keep=remat.MLP_H), approximate="tanh")
    out = dense(p.proj_out, o) + dense(p.proj_out_mlp, mlp)
    return x + gate[:, None, :].to(x.dtype) * out


def _remat(fn, policy: str, kind: str):
    """`fn`, a block of `kind` ("flux_dual", "flux_single" or "qwen"),
    recomputed in backward under `policy`: what `remat.names` says the
    policy keeps in such a block, in one store per call of `fn`; nothing
    kept, a plain checkpoint."""
    names = remat.names(policy, kind)
    if not names:
        return functools.partial(checkpoint, fn, use_reentrant=False)
    ctx = functools.partial(remat.contexts, names, offload=policy == "flash_offload")
    return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=ctx)


def forward(params: FluxTransformer, cfg: FluxConfig, *args, **kwargs):
    """Returns [B, S_img, out_channels] velocity prediction (full sequence —
    callers slice [:, :S_target] to drop control-image positions); the
    arguments are `_forward`'s.  Runs as a call of `params`, and each block
    as a call of its module, so that a base sharded by FSDP2 is gathered
    block by block."""
    return params(cfg, *args, **kwargs)


def _forward(params: FluxTransformer, cfg: FluxConfig,
             hidden_states,              # [B, S_img, in_channels] packed latents
             encoder_hidden_states,      # [B, S_txt, joint_attention_dim]
             pooled_projections,         # [B, pooled_projection_dim] or None
             timestep,                   # [B] in [0, 1]
             img_ids,                    # [S_img, 3] or [B, S_img, 3]
             txt_ids,                    # [S_txt, 3] or [B, S_txt, 3]
             guidance=None,              # [B]
             segment_ids: Optional[torch.Tensor] = None,  # [B, S_txt+S_img]; 0 = padding
             attn_impl: str = "auto",
             remat: bool = True,
             remat_policy: str = "full"):     # a name of remat.POLICY_NAMES
    """Returns [B, S_img, out_channels] velocity prediction (full sequence —
    callers slice [:, :S_target] to drop control-image positions).  With
    `remat` and autograd recording, every block is recomputed in backward
    under `remat_policy`; without autograd (inference) nothing is."""
    img = dense(params.x_embedder, hidden_states)
    txt = dense(params.context_embedder, encoder_hidden_states)

    temb = mlp_silu(params.time_in, sinusoidal_embedding(timestep))
    if cfg.guidance_embeds:
        if guidance is None:
            raise ValueError("guidance_embeds model requires a guidance input")
        temb = temb + mlp_silu(params.guidance_in, sinusoidal_embedding(guidance))
    if cfg.pooled_projection_dim and pooled_projections is not None:
        temb = temb + mlp_silu(params.pooled_in, pooled_projections.float())
    temb = temb.to(img.dtype)

    if txt_ids.dim() != img_ids.dim():  # mixed shared/per-sample ids
        b = hidden_states.shape[0]
        if txt_ids.dim() == 2:
            txt_ids = txt_ids[None].expand(b, *txt_ids.shape)
        if img_ids.dim() == 2:
            img_ids = img_ids[None].expand(b, *img_ids.shape)
    ids = torch.cat([txt_ids, img_ids], dim=-2)
    cos, sin = rope_from_coords(ids, cfg.axes_dims_rope)

    st = txt.shape[1]
    dual_fn = lambda p, img, txt, i_mods, t_mods: _dual_block(  # noqa: E731
        p, cfg, img, txt, i_mods, t_mods, cos, sin, segment_ids, attn_impl)
    single_fn = lambda p, x, mods: _single_block(  # noqa: E731
        p, cfg, x, mods, cos, sin, segment_ids, attn_impl)
    if remat:  # the policy is checked even where nothing records for backward
        remat_dual = _remat(dual_fn, remat_policy, "flux_dual")
        remat_single = _remat(single_fn, remat_policy, "flux_single")
        if torch.is_grad_enabled():
            dual_fn, single_fn = remat_dual, remat_single
    for p in params.dual:
        img, txt = p(dual_fn, img, txt, temb)
    x = torch.cat([txt, img], dim=1)
    for p in params.single:
        x = p(single_fn, x, temb)
    img = x[:, st:]

    scale, shift = ada_ln_mods(params.norm_out.proj, temb, 2)  # continuous: scale first
    img = modulate(layer_norm(img), shift, scale)
    return dense(params.proj_out, img)
