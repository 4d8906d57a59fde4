"""Diffusers / transformers state dicts → the port's parameter trees (FLUX
DiT and VAE, CLIP-L and T5 text encoders).

The port's copy of qflux_tpu/models/porting.py (FLUX MMDiT, FLUX VAE, CLIP
text, T5 encoder and the coverage audit).
A state dict is any mapping name → tensor: a dict of torch tensors or numpy
arrays, or the lazy safetensors reader (`utils/safetensors.py:SafeTensors`),
which reads a tensor only when a converter asks for it.  The converters
write the JAX package's trees, keys and layouts alike, with torch tensors
on the CPU as leaves, so `models/bridge.py:load_params` loads them as it
loads a JAX tree.  A leaf may be a view of the tensor read (a transposed
dense weight is its [out, in] weight seen as [in, out]): the values are
JAX's, and the bridge, which turns the layout back, then copies the
file's memory order to the device without a transpose on the host.

  * torch nn.Linear [out, in] → kernel [in, out]  (transpose)
  * torch conv OIHW → HWIO
  * per-layer torch modules → stacked leaves [L, …]
  * q/k projections and their RMS-norm scales permuted to the rotate-half
    rope layout (`_permute_qk`), and a single block's proj_out split in two
    (`_split_single_proj_out`).

`convert_flux_transformer` converts the whole dict; its per-block form,
`flux_transformer_top` / `flux_dual_block` / `flux_single_block`, converts
the top-level leaves and then one block at a time, which is how
`models/flux/transformer.py:load_from_state_dict` builds the model.
"""

from __future__ import annotations

import logging
import re
from typing import Callable, Iterator, Mapping

import numpy as np
import torch

from qflux_tpu_torch.ops.rope import interleaved_to_half_perm


def _t(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _qk_out_perm(out_dim: int, head_dim: int) -> np.ndarray:
    """Expand the per-head interleaved→rotate-half channel permutation to a
    full projection output dim (ours[..., j] = torch[..., perm[j]])."""
    perm = interleaved_to_half_perm(head_dim)
    return (np.arange(out_dim).reshape(-1, head_dim)[:, perm]).reshape(-1)


def _permute_qk(p: dict, head_dim: int) -> dict:
    """Permute a q/k projection param dict (kernel [..., in, out], bias [out])
    to the rotate-half head layout used by the DiTs (ops/rope.py)."""
    out = dict(p)
    idx = torch.from_numpy(_qk_out_perm(p["kernel"].shape[-1], head_dim))
    out["kernel"] = p["kernel"][..., idx]
    if "bias" in p:
        out["bias"] = p["bias"][..., idx]
    return out


def _permute_qk_scale(p: dict, head_dim: int) -> dict:
    perm = torch.from_numpy(interleaved_to_half_perm(head_dim))
    return {"scale": p["scale"][..., perm]}


def _lin(sd: Mapping, name: str, dtype=torch.float32) -> dict:
    p = {"kernel": _t(sd[f"{name}.weight"]).to(dtype).t()}
    if f"{name}.bias" in sd:
        p["bias"] = _t(sd[f"{name}.bias"]).to(dtype)
    return p


def _lin_nobias(sd: Mapping, name: str, dtype=torch.float32) -> dict:
    return {"kernel": _t(sd[f"{name}.weight"]).to(dtype).t()}


def _split_single_proj_out(lin: dict) -> dict:
    """FLUX single-block proj_out [d+hidden, d] → two partial GEMMs:
    `proj_out` takes the attention rows [:d] (+ bias), `proj_out_mlp` the
    MLP rows [d:].  d is the output width."""
    k = lin["kernel"]
    d = k.shape[-1]
    out = {"proj_out": {"kernel": k[:d]}, "proj_out_mlp": {"kernel": k[d:]}}
    if "bias" in lin:
        out["proj_out"]["bias"] = lin["bias"]
    return out


def _conv(sd: Mapping, name: str, dtype=torch.float32) -> dict:
    # OIHW → HWIO
    return {"kernel": _t(sd[f"{name}.weight"]).to(dtype).permute(2, 3, 1, 0),
            "bias": _t(sd[f"{name}.bias"]).to(dtype)}


def _gn(sd: Mapping, name: str, dtype=torch.float32) -> dict:
    return {"scale": _t(sd[f"{name}.weight"]).to(dtype), "bias": _t(sd[f"{name}.bias"]).to(dtype)}


def _scale(sd: Mapping, name: str, dtype=torch.float32) -> dict:
    return {"scale": _t(sd[f"{name}.weight"]).to(dtype)}


def _stack(trees: list) -> dict:
    """List of identical param dicts → one dict with stacked leaves."""
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, Mapping)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def count_blocks(sd: Mapping, prefix: str) -> int:
    """1 + the largest i of a `{prefix}.{i}.` key (0 when there is none)."""
    pat = re.compile(rf"{re.escape(prefix)}\.(\d+)\.")
    return 1 + max((int(m.group(1)) for k in sd for m in [pat.match(k)] if m), default=-1)


# ===========================================================================
# FLUX MMDiT (diffusers FluxTransformer2DModel names)

def flux_transformer_top(sd: Mapping, dtype=torch.float32) -> dict:
    """The top-level leaves of the FLUX DiT tree (everything but "dual" and
    "single")."""
    p = {
        "x_embedder": _lin(sd, "x_embedder", dtype),
        "context_embedder": _lin(sd, "context_embedder", dtype),
        "time_in": {"in": _lin(sd, "time_text_embed.timestep_embedder.linear_1", dtype),
                    "out": _lin(sd, "time_text_embed.timestep_embedder.linear_2", dtype)},
        "norm_out": {"proj": _lin(sd, "norm_out.linear", dtype)},
        "proj_out": _lin(sd, "proj_out", dtype),
    }
    if "time_text_embed.text_embedder.linear_1.weight" in sd:
        # absent on FLUX.2-Klein (pooled_projection_dim=0)
        p["pooled_in"] = {
            "in": _lin(sd, "time_text_embed.text_embedder.linear_1", dtype),
            "out": _lin(sd, "time_text_embed.text_embedder.linear_2", dtype)}
    if "time_text_embed.guidance_embedder.linear_1.weight" in sd:
        p["guidance_in"] = {
            "in": _lin(sd, "time_text_embed.guidance_embedder.linear_1", dtype),
            "out": _lin(sd, "time_text_embed.guidance_embedder.linear_2", dtype)}
    return p


def flux_dual_block(sd: Mapping, i: int, dtype=torch.float32, head_dim: int = 128) -> dict:
    b = f"transformer_blocks.{i}"
    return {
        "img_mod": {"proj": _lin(sd, f"{b}.norm1.linear", dtype)},
        "txt_mod": {"proj": _lin(sd, f"{b}.norm1_context.linear", dtype)},
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
        "img_mlp": {"in": _lin(sd, f"{b}.ff.net.0.proj", dtype),
                    "out": _lin(sd, f"{b}.ff.net.2", dtype)},
        "txt_mlp": {"in": _lin(sd, f"{b}.ff_context.net.0.proj", dtype),
                    "out": _lin(sd, f"{b}.ff_context.net.2", dtype)},
    }


def flux_single_block(sd: Mapping, i: int, dtype=torch.float32, head_dim: int = 128) -> dict:
    b = f"single_transformer_blocks.{i}"
    return {
        "mod": {"proj": _lin(sd, f"{b}.norm.linear", dtype)},
        "attn": {
            "to_q": _permute_qk(_lin(sd, f"{b}.attn.to_q", dtype), head_dim),
            "to_k": _permute_qk(_lin(sd, f"{b}.attn.to_k", dtype), head_dim),
            "to_v": _lin(sd, f"{b}.attn.to_v", dtype),
            "norm_q": _permute_qk_scale(_scale(sd, f"{b}.attn.norm_q", dtype), head_dim),
            "norm_k": _permute_qk_scale(_scale(sd, f"{b}.attn.norm_k", dtype), head_dim),
        },
        "proj_mlp": _lin(sd, f"{b}.proj_mlp", dtype),
        **_split_single_proj_out(_lin(sd, f"{b}.proj_out", dtype)),
    }


def convert_flux_transformer(sd: Mapping, num_layers=19, num_single_layers=38,
                             dtype=torch.float32, head_dim=128) -> dict:
    """The whole FLUX DiT tree, blocks stacked [L, …] under "dual" and
    "single".  q/k projections and their RMS-norm scales are permuted to the
    rotate-half rope layout (attention outputs are invariant)."""
    p = flux_transformer_top(sd, dtype)
    p["dual"] = _stack([flux_dual_block(sd, i, dtype, head_dim) for i in range(num_layers)])
    p["single"] = _stack([flux_single_block(sd, i, dtype, head_dim)
                          for i in range(num_single_layers)])
    return p


# ===========================================================================
# FLUX VAE (diffusers AutoencoderKL names)

def _resnet_sd(sd, base, dtype):
    p = {"norm1": _gn(sd, f"{base}.norm1", dtype), "conv1": _conv(sd, f"{base}.conv1", dtype),
         "norm2": _gn(sd, f"{base}.norm2", dtype), "conv2": _conv(sd, f"{base}.conv2", dtype)}
    if f"{base}.conv_shortcut.weight" in sd:
        p["conv_shortcut"] = _conv(sd, f"{base}.conv_shortcut", dtype)
    return p


def _vae_attn_sd(sd, base, dtype):
    return {
        "group_norm": _gn(sd, f"{base}.group_norm", dtype),
        "to_q": _lin(sd, f"{base}.to_q", dtype), "to_k": _lin(sd, f"{base}.to_k", dtype),
        "to_v": _lin(sd, f"{base}.to_v", dtype), "to_out": _lin(sd, f"{base}.to_out.0", dtype),
    }


def _mid_sd(sd, base, dtype):
    return {"resnets_0": _resnet_sd(sd, f"{base}.resnets.0", dtype),
            "attentions_0": _vae_attn_sd(sd, f"{base}.attentions.0", dtype),
            "resnets_1": _resnet_sd(sd, f"{base}.resnets.1", dtype)}


def convert_flux_vae(sd: Mapping, num_blocks=4, layers_per_block=2,
                     dtype=torch.float32) -> dict:
    enc = {"conv_in": _conv(sd, "encoder.conv_in", dtype),
           "mid": _mid_sd(sd, "encoder.mid_block", dtype),
           "norm_out": _gn(sd, "encoder.conv_norm_out", dtype),
           "conv_out": _conv(sd, "encoder.conv_out", dtype)}
    for i in range(num_blocks):
        blk = {}
        for j in range(layers_per_block):
            blk[f"resnets_{j}"] = _resnet_sd(sd, f"encoder.down_blocks.{i}.resnets.{j}", dtype)
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            blk["downsample"] = _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", dtype)
        enc[f"down_{i}"] = blk
    dec = {"conv_in": _conv(sd, "decoder.conv_in", dtype),
           "mid": _mid_sd(sd, "decoder.mid_block", dtype),
           "norm_out": _gn(sd, "decoder.conv_norm_out", dtype),
           "conv_out": _conv(sd, "decoder.conv_out", dtype)}
    for i in range(num_blocks):
        blk = {}
        for j in range(layers_per_block + 1):
            blk[f"resnets_{j}"] = _resnet_sd(sd, f"decoder.up_blocks.{i}.resnets.{j}", dtype)
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            blk["upsample"] = _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", dtype)
        dec[f"up_{i}"] = blk
    return {"encoder": enc, "decoder": dec}


# ===========================================================================
# CLIP text (transformers CLIPTextModel names)

def convert_clip_text(sd: Mapping, num_layers=12, dtype=torch.float32) -> dict:
    """The JAX CLIP tree: "layers" a list of per-layer dicts.  Keys with or
    without the "text_model." prefix."""
    pre = "text_model."
    if not any(k.startswith(pre) for k in sd):
        pre = ""
    p = {
        "token_embedding": _t(sd[f"{pre}embeddings.token_embedding.weight"]).to(dtype),
        "position_embedding": _t(sd[f"{pre}embeddings.position_embedding.weight"]).to(dtype),
        "final_layer_norm": _gn(sd, f"{pre}final_layer_norm", dtype),
        "layers": [],
    }
    for i in range(num_layers):
        b = f"{pre}encoder.layers.{i}"
        p["layers"].append({
            "layer_norm1": _gn(sd, f"{b}.layer_norm1", dtype),
            "layer_norm2": _gn(sd, f"{b}.layer_norm2", dtype),
            "attn": {"q": _lin(sd, f"{b}.self_attn.q_proj", dtype),
                     "k": _lin(sd, f"{b}.self_attn.k_proj", dtype),
                     "v": _lin(sd, f"{b}.self_attn.v_proj", dtype),
                     "out": _lin(sd, f"{b}.self_attn.out_proj", dtype)},
            "mlp": {"fc1": _lin(sd, f"{b}.mlp.fc1", dtype),
                    "fc2": _lin(sd, f"{b}.mlp.fc2", dtype)},
        })
    return p


# ===========================================================================
# T5 encoder (transformers T5EncoderModel names)

def convert_t5_encoder(sd: Mapping, num_layers=24, dtype=torch.float32) -> dict:
    """The JAX T5 tree: the relative-attention table of block 0 (the only
    block that has one), "layers" a list of per-layer dicts, no biases."""
    p = {
        "shared": _t(sd["shared.weight"]).to(dtype),
        "relative_attention_bias": _t(sd[
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]).to(dtype),
        "final_layer_norm": _scale(sd, "encoder.final_layer_norm", dtype),
        "layers": [],
    }
    for i in range(num_layers):
        b = f"encoder.block.{i}"
        p["layers"].append({
            "ln0": _scale(sd, f"{b}.layer.0.layer_norm", dtype),
            "attn": {"q": _lin_nobias(sd, f"{b}.layer.0.SelfAttention.q", dtype),
                     "k": _lin_nobias(sd, f"{b}.layer.0.SelfAttention.k", dtype),
                     "v": _lin_nobias(sd, f"{b}.layer.0.SelfAttention.v", dtype),
                     "o": _lin_nobias(sd, f"{b}.layer.0.SelfAttention.o", dtype)},
            "ln1": _scale(sd, f"{b}.layer.1.layer_norm", dtype),
            "ff": {"wi_0": _lin_nobias(sd, f"{b}.layer.1.DenseReluDense.wi_0", dtype),
                   "wi_1": _lin_nobias(sd, f"{b}.layer.1.DenseReluDense.wi_1", dtype),
                   "wo": _lin_nobias(sd, f"{b}.layer.1.DenseReluDense.wo", dtype)},
        })
    return p


# ---------------------------------------------------------------------------
# converter coverage auditing

class TrackingStateDict(Mapping):
    """A view of a state dict that records key reads, so converters can be
    audited: every checkpoint tensor must be consumed (unconsumed keys =
    renamed/missing parameters that would silently stay unset).  It wraps
    the mapping without copying it, so a lazy reader stays lazy."""

    def __init__(self, sd: Mapping):
        self.sd = sd
        self.accessed: set = set()

    def __getitem__(self, k):
        value = self.sd[k]
        self.accessed.add(k)
        return value

    def get(self, k, default=None):
        if k in self.sd:
            self.accessed.add(k)
        return self.sd.get(k, default)

    def __contains__(self, k) -> bool:
        return k in self.sd

    def __iter__(self) -> Iterator:
        return iter(self.sd)

    def __len__(self) -> int:
        return len(self.sd)

    def unconsumed(self) -> list:
        return sorted(set(self.sd) - self.accessed)


def report_unconsumed(unconsumed: list, total: int, what: str, strict: bool = False) -> None:
    if not unconsumed:
        return
    msg = (f"{len(unconsumed)}/{total} checkpoint tensors NOT consumed by {what}: "
           f"{unconsumed[:8]}{'...' if len(unconsumed) > 8 else ''}")
    if strict:
        raise ValueError(msg)
    logging.warning(msg)


def convert_with_coverage(convert_fn: Callable, sd: Mapping, *args, strict: bool = False, **kw):
    """Run a converter and report unconsumed checkpoint keys: strict=True
    raises, otherwise a warning is logged.  Returns (tree, unconsumed_keys)."""
    tsd = TrackingStateDict(sd)
    tree = convert_fn(tsd, *args, **kw)
    unconsumed = tsd.unconsumed()
    report_unconsumed(unconsumed, len(sd), getattr(convert_fn, "__name__", convert_fn), strict)
    return tree, unconsumed
