"""Qwen-family checkpoint converters: the Qwen2.5-VL encoder, the DiT and
the 3D VAE.

The port's copy of qflux_tpu/models/qwen/porting.py (`_detect_prefix`,
`convert_vl_vision`, `convert_vl_text`, `convert_vl_lm_head` (the LM head
DreamOmni2's prompt enhancer decodes with), `convert_qwen_image_transformer`,
`convert_qwen_vae`), on the helpers of `models/porting.py`:
any mapping name → tensor in, the JAX package's trees (torch tensors on the
CPU as leaves) out.  The DiT and the VL encoder have per-block forms
(`qwen_transformer_top` / `qwen_block`; `vl_vision_top` / `vl_vision_block`,
`vl_text_top` / `vl_text_layer`), which `models/qwen/transformer.py` and
`models/qwen/vl_encoder.py:load_from_state_dict` use to build the models one
block at a time.
"""

from __future__ import annotations

from typing import Mapping

import torch

from qflux_tpu_torch.models.porting import (_lin, _lin_nobias, _permute_qk, _permute_qk_scale,
                                            _scale, _stack, _t)


def _detect_prefix(sd: Mapping, candidates: list[str]) -> str:
    """The first candidate some key starts with, else ""."""
    for c in candidates:
        if any(k.startswith(c) for k in sd):
            return c
    return ""


# ---------------------------------------------------------------------------
# Qwen2.5-VL (transformers Qwen2_5_VLForConditionalGeneration names, in the
# layout of either transformers version)

def vision_prefix(sd: Mapping) -> str:
    return _detect_prefix(sd, ["model.visual.", "visual."])


def text_prefix(sd: Mapping) -> str:
    return _detect_prefix(sd, ["model.language_model.", "language_model.model.", "model."])


def vl_vision_top(sd: Mapping, dtype=torch.float32) -> dict:
    """The vision tree's leaves but "blocks": the patch embedding (Conv3d
    weight [D, C, tps, ps, ps] → the matmul kernel [C·tps·ps², D], flattened
    in the processor's patch order) and the merger."""
    pre = vision_prefix(sd)
    w = _t(sd[f"{pre}patch_embed.proj.weight"]).to(dtype)
    return {"patch_embed": {"kernel": w.reshape(w.shape[0], -1).t()},
            "merger": {"ln_q": _scale(sd, f"{pre}merger.ln_q", dtype),
                       "mlp_0": _lin(sd, f"{pre}merger.mlp.0", dtype),
                       "mlp_2": _lin(sd, f"{pre}merger.mlp.2", dtype)}}


def vl_vision_block(sd: Mapping, pre: str, i: int, dtype=torch.float32) -> dict:
    b = f"{pre}blocks.{i}"
    return {"norm1": _scale(sd, f"{b}.norm1", dtype),
            "norm2": _scale(sd, f"{b}.norm2", dtype),
            "attn": {"qkv": _lin(sd, f"{b}.attn.qkv", dtype),
                     "proj": _lin(sd, f"{b}.attn.proj", dtype)},
            "mlp": {"gate": _lin(sd, f"{b}.mlp.gate_proj", dtype),
                    "up": _lin(sd, f"{b}.mlp.up_proj", dtype),
                    "down": _lin(sd, f"{b}.mlp.down_proj", dtype)}}


def convert_vl_vision(sd: Mapping, depth: int, dtype=torch.float32) -> dict:
    """The vision tower's tree, "blocks" stacked [depth, ...]."""
    p = vl_vision_top(sd, dtype)
    pre = vision_prefix(sd)
    p["blocks"] = _stack([vl_vision_block(sd, pre, i, dtype) for i in range(depth)])
    return p


def vl_text_top(sd: Mapping, dtype=torch.float32) -> dict:
    pre = text_prefix(sd)
    return {"embed_tokens": _t(sd[f"{pre}embed_tokens.weight"]).to(dtype),
            "norm": _scale(sd, f"{pre}norm", dtype)}


def vl_text_layer(sd: Mapping, pre: str, i: int, dtype=torch.float32) -> dict:
    b = f"{pre}layers.{i}"
    return {"input_layernorm": _scale(sd, f"{b}.input_layernorm", dtype),
            "post_attention_layernorm": _scale(sd, f"{b}.post_attention_layernorm", dtype),
            "attn": {"q": _lin(sd, f"{b}.self_attn.q_proj", dtype),
                     "k": _lin(sd, f"{b}.self_attn.k_proj", dtype),
                     "v": _lin(sd, f"{b}.self_attn.v_proj", dtype),
                     "o": _lin_nobias(sd, f"{b}.self_attn.o_proj", dtype)},
            "mlp": {"gate": _lin_nobias(sd, f"{b}.mlp.gate_proj", dtype),
                    "up": _lin_nobias(sd, f"{b}.mlp.up_proj", dtype),
                    "down": _lin_nobias(sd, f"{b}.mlp.down_proj", dtype)}}


def convert_vl_text(sd: Mapping, num_layers: int, dtype=torch.float32) -> dict:
    """The LM's tree, "layers" stacked [num_layers, ...]."""
    p = vl_text_top(sd, dtype)
    pre = text_prefix(sd)
    p["layers"] = _stack([vl_text_layer(sd, pre, i, dtype) for i in range(num_layers)])
    return p


def convert_vl_lm_head(sd: Mapping, dtype=torch.float32) -> dict:
    """The LM head {"kernel": [hidden, vocab]} for greedy decoding:
    `lm_head.weight` [vocab, hidden] transposed, or, in a checkpoint that
    ties it to the token embedding (the smaller variants), embed_tokens'."""
    for key in ("lm_head.weight", "model.lm_head.weight"):
        if key in sd:
            return {"kernel": _t(sd[key]).to(dtype).t()}
    return {"kernel": _t(sd[f"{text_prefix(sd)}embed_tokens.weight"]).to(dtype).t()}


# ---------------------------------------------------------------------------
# Qwen-Image MMDiT (diffusers QwenImageTransformer2DModel names)

def qwen_transformer_top(sd: Mapping, dtype=torch.float32) -> dict:
    """The top-level leaves of the Qwen DiT tree (everything but "blocks")."""
    return {
        "img_in": _lin(sd, "img_in", dtype),
        "txt_in": _lin(sd, "txt_in", dtype),
        "txt_norm": _scale(sd, "txt_norm", dtype),
        "time_in": {"in": _lin(sd, "time_text_embed.timestep_embedder.linear_1", dtype),
                    "out": _lin(sd, "time_text_embed.timestep_embedder.linear_2", dtype)},
        "norm_out": {"proj": _lin(sd, "norm_out.linear", dtype)},
        "proj_out": _lin(sd, "proj_out", dtype),
    }


def qwen_block(sd: Mapping, i: int, dtype=torch.float32, head_dim: int = 128) -> dict:
    b = f"transformer_blocks.{i}"
    return {
        "img_mod": {"proj": _lin(sd, f"{b}.img_mod.1", dtype)},
        "txt_mod": {"proj": _lin(sd, f"{b}.txt_mod.1", dtype)},
        "attn": {
            "to_q": _permute_qk(_lin(sd, f"{b}.attn.to_q", dtype), head_dim),
            "to_k": _permute_qk(_lin(sd, f"{b}.attn.to_k", dtype), head_dim),
            "to_v": _lin(sd, f"{b}.attn.to_v", dtype),
            "to_out": _lin(sd, f"{b}.attn.to_out.0", dtype),
            "add_q": _permute_qk(_lin(sd, f"{b}.attn.add_q_proj", dtype), head_dim),
            "add_k": _permute_qk(_lin(sd, f"{b}.attn.add_k_proj", dtype), head_dim),
            "add_v": _lin(sd, f"{b}.attn.add_v_proj", dtype),
            "add_out": _lin(sd, f"{b}.attn.to_add_out", dtype),
            "norm_q": _permute_qk_scale(_scale(sd, f"{b}.attn.norm_q", dtype), head_dim),
            "norm_k": _permute_qk_scale(_scale(sd, f"{b}.attn.norm_k", dtype), head_dim),
            "norm_added_q": _permute_qk_scale(_scale(sd, f"{b}.attn.norm_added_q", dtype),
                                              head_dim),
            "norm_added_k": _permute_qk_scale(_scale(sd, f"{b}.attn.norm_added_k", dtype),
                                              head_dim),
        },
        "img_mlp": {"in": _lin(sd, f"{b}.img_mlp.net.0.proj", dtype),
                    "out": _lin(sd, f"{b}.img_mlp.net.2", dtype)},
        "txt_mlp": {"in": _lin(sd, f"{b}.txt_mlp.net.0.proj", dtype),
                    "out": _lin(sd, f"{b}.txt_mlp.net.2", dtype)},
    }


def convert_qwen_image_transformer(sd: Mapping, num_layers=60, dtype=torch.float32,
                                   head_dim=128) -> dict:
    """q/k projections + norms permuted to the rotate-half rope layout
    (ops/rope.py:interleaved_to_half_perm; attention outputs invariant)."""
    p = qwen_transformer_top(sd, dtype)
    p["blocks"] = _stack([qwen_block(sd, i, dtype, head_dim) for i in range(num_layers)])
    return p


# ---------------------------------------------------------------------------
# Qwen 3D VAE (diffusers AutoencoderKLQwenImage — the WanVAE layout)

def _c3d(sd, name, dtype=torch.float32):
    """CausalConv3d weight [cout, cin, kt, kh, kw] → kernel [kt, kh, kw, cin, cout]."""
    return {"kernel": _t(sd[f"{name}.weight"]).to(dtype).permute(2, 3, 4, 1, 0),
            "bias": _t(sd[f"{name}.bias"]).to(dtype)}


def _c2d(sd, name, dtype=torch.float32):
    """Conv2d weight [cout, cin, kh, kw] → kernel [kh, kw, cin, cout]."""
    return {"kernel": _t(sd[f"{name}.weight"]).to(dtype).permute(2, 3, 1, 0),
            "bias": _t(sd[f"{name}.bias"]).to(dtype)}


def _gamma(sd, name, dtype=torch.float32):
    """WanRMS_norm gamma [c, 1, 1] (or [c]) → [c]."""
    return {"gamma": _t(sd[f"{name}.gamma"]).to(dtype).reshape(-1)}


def _conv1x1_lin(sd, name, dtype=torch.float32):
    """1×1(×1) conv → linear over channels: kernel [cin, cout]."""
    w = _t(sd[f"{name}.weight"]).to(dtype)
    return {"kernel": w.reshape(w.shape[0], w.shape[1]).t(),
            "bias": _t(sd[f"{name}.bias"]).to(dtype)}


def _wan_res(sd, base, dtype):
    p = {"norm1": _gamma(sd, f"{base}.norm1", dtype),
         "conv1": _c3d(sd, f"{base}.conv1", dtype),
         "norm2": _gamma(sd, f"{base}.norm2", dtype),
         "conv2": _c3d(sd, f"{base}.conv2", dtype)}
    if f"{base}.conv_shortcut.weight" in sd:
        p["conv_shortcut"] = _c3d(sd, f"{base}.conv_shortcut", dtype)
    return p


def _wan_mid(sd, base, dtype):
    return {"res_0": _wan_res(sd, f"{base}.resnets.0", dtype),
            "attn": {"norm": _gamma(sd, f"{base}.attentions.0.norm", dtype),
                     "to_qkv": _conv1x1_lin(sd, f"{base}.attentions.0.to_qkv", dtype),
                     "proj": _conv1x1_lin(sd, f"{base}.attentions.0.proj", dtype)},
            "res_1": _wan_res(sd, f"{base}.resnets.1", dtype)}


def convert_qwen_vae(sd: Mapping, num_res_blocks: int = 2, levels: int = 4,
                     dtype=torch.float32) -> dict:
    """diffusers AutoencoderKLQwenImage state dict → the Qwen VAE tree.

    The Wan encoder/decoder store blocks as a FLAT ModuleList (residuals and
    resamples interleaved); this walks it back into the per-level layout.
    `time_conv` weights inside 3D resamples are skipped: the image pipeline
    runs T=1 frames, where only the trailing time slice of each causal
    kernel acts.  quant_conv / post_quant_conv become 1×1 channel linears."""
    enc: dict = {"conv_in": _c3d(sd, "encoder.conv_in", dtype)}
    k = 0
    for i in range(levels):
        blk: dict = {}
        for j in range(num_res_blocks):
            blk[f"res_{j}"] = _wan_res(sd, f"encoder.down_blocks.{k}", dtype)
            k += 1
        if i < levels - 1:
            blk["down"] = _c2d(sd, f"encoder.down_blocks.{k}.resample.1", dtype)
            k += 1
        enc[f"down_{i}"] = blk
    enc["mid"] = _wan_mid(sd, "encoder.mid_block", dtype)
    enc["norm_out"] = _gamma(sd, "encoder.norm_out", dtype)
    enc["conv_out"] = _c3d(sd, "encoder.conv_out", dtype)
    if "quant_conv.weight" in sd:
        enc["quant_conv"] = _conv1x1_lin(sd, "quant_conv", dtype)

    dec: dict = {"conv_in": _c3d(sd, "decoder.conv_in", dtype),
                 "mid": _wan_mid(sd, "decoder.mid_block", dtype)}
    k = 0
    for i in range(levels):
        blk = {}
        for j in range(num_res_blocks + 1):
            blk[f"res_{j}"] = _wan_res(sd, f"decoder.up_blocks.{k}", dtype)
            k += 1
        if i < levels - 1:
            blk["up"] = _c2d(sd, f"decoder.up_blocks.{k}.resample.1", dtype)
            k += 1
        dec[f"up_{i}"] = blk
    dec["norm_out"] = _gamma(sd, "decoder.norm_out", dtype)
    dec["conv_out"] = _c3d(sd, "decoder.conv_out", dtype)
    if "post_quant_conv.weight" in sd:
        dec["post_quant_conv"] = _conv1x1_lin(sd, "post_quant_conv", dtype)
    return {"encoder": enc, "decoder": dec}
