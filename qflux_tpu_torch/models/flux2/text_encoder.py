"""Qwen3 causal LM as FLUX.2-Klein's text encoder, in PyTorch.

Counterpart of qflux_tpu/models/flux2/text_encoder.py (`Qwen3Config`,
`init`, `encode`, `convert_qwen3`).  Klein conditions on the hidden states
of layers (9, 18, 27) of Qwen3-4B, channel-concatenated → [B, L, 3 · 2560].
Qwen3 is the Qwen2 decoder with a per-head RMSNorm on q and k before the
rotary embedding, no qkv biases and a plain 1D RoPE (its cos / sin made in
float64 on the host and cast to f32, as JAX's numpy makes them); GQA by
repeat, f32 logits with the −1e30 mask (causal AND padding), SwiGLU.  The
indexing is transformers': hidden_states[k] is the input of layer k (the
embeddings at k = 0), and hidden_states[num_layers] the final-normed output.

JAX runs all 36 layers and picks three; the port stops after the highest
layer it picks (27), and applies the final norm only where num_layers is
picked: the layers after it change none of the states it returns.  Module
attribute names are the JAX tree's keys (`models/bridge.py:load_text_params`
loads a JAX tree, its "layers" a list, or either package's `convert_qwen3`
output).  It runs in float32, as JAX runs it, and on the card raises unless
TF32 is off (`ops.layers.require_f32`); JAX computes it in XLA with no
Pallas kernel, so it is plain PyTorch here.  `load_from_state_dict` reads a
transformers Qwen3ForCausalLM checkpoint one layer at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from qflux_tpu_torch.models.flux.text_encoders import NormParams, _param
from qflux_tpu_torch.models.qwen.vl_encoder import (_Mlp, _attend, _causal_mask, _finish_layer,
                                                    _normal_in, _rms, _rope)
from qflux_tpu_torch.ops.layers import Dense, dense, require_f32


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    hidden_size: int = 2560            # Qwen3-4B (Klein's encoder)
    num_layers: int = 36
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 9728
    rope_theta: float = 1_000_000.0
    vocab_size: int = 151936
    rms_norm_eps: float = 1e-6

    @classmethod
    def tiny(cls):
        return cls(hidden_size=48, num_layers=4, num_heads=4, num_kv_heads=2,
                   head_dim=12, intermediate_size=96, vocab_size=512)


class _Attn(nn.Module):
    def __init__(self, cfg: Qwen3Config, **kw):
        super().__init__()
        d, q_dim, kv_dim = cfg.hidden_size, cfg.num_heads * cfg.head_dim, \
            cfg.num_kv_heads * cfg.head_dim
        self.q, self.k = Dense(d, q_dim, bias=False, **kw), Dense(d, kv_dim, bias=False, **kw)
        self.v, self.o = Dense(d, kv_dim, bias=False, **kw), Dense(q_dim, d, bias=False, **kw)
        self.q_norm = NormParams(cfg.head_dim, bias=False, **kw)
        self.k_norm = NormParams(cfg.head_dim, bias=False, **kw)


class Qwen3Layer(nn.Module):
    def __init__(self, cfg: Qwen3Config, **kw):
        super().__init__()
        d = cfg.hidden_size
        self.input_layernorm = NormParams(d, bias=False, **kw)
        self.post_attention_layernorm = NormParams(d, bias=False, **kw)
        self.attn = _Attn(cfg, **kw)
        self.mlp = _Mlp(d, cfg.intermediate_size, False, **kw)


class Qwen3Encoder(nn.Module):
    def __init__(self, cfg: Qwen3Config, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.embed_tokens = _param(cfg.vocab_size, cfg.hidden_size, **kw)
        self.norm = NormParams(cfg.hidden_size, bias=False, **kw)
        self.layers = nn.ModuleList(Qwen3Layer(cfg, **kw) for _ in range(cfg.num_layers))


@torch.no_grad()
def init(generator: torch.Generator, cfg: Qwen3Config, device=None,
         dtype=torch.float32) -> Qwen3Encoder:
    """Random weights with JAX `init`'s distributions, drawn on `device`:
    embed_tokens N(0, 0.02²), every dense layer N(0, 1/in) without bias,
    unit RMS scales."""
    model = Qwen3Encoder(cfg, device=device, dtype=dtype)
    model.embed_tokens.normal_(generator=generator).mul_(0.02)
    for lp in model.layers:
        for d in (lp.attn.q, lp.attn.k, lp.attn.v, lp.attn.o, lp.mlp.gate, lp.mlp.up,
                  lp.mlp.down):
            _normal_in(d, generator)
    return model


def rope_cos_sin(cfg: Qwen3Config, s: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [1, S, 1, head_dim], float64 on the host cast to f32."""
    hd = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    freqs = np.arange(s, dtype=np.float64)[:, None] * inv[None, :]
    emb = np.concatenate([freqs, freqs], axis=-1)
    return tuple(torch.from_numpy(f(emb).astype(np.float32)).to(device)[None, :, None, :]
                 for f in (np.cos, np.sin))


def _layer(cfg: Qwen3Config, x, lp: Qwen3Layer, cos, sin, mask):
    b, s, _ = x.shape
    hd, eps = cfg.head_dim, cfg.rms_norm_eps
    h = _rms(lp.input_layernorm, x, eps)
    a = lp.attn
    q = _rms(a.q_norm, dense(a.q, h).reshape(b, s, cfg.num_heads, hd), eps)
    k = _rms(a.k_norm, dense(a.k, h).reshape(b, s, cfg.num_kv_heads, hd), eps)
    v = dense(a.v, h).reshape(b, s, cfg.num_kv_heads, hd)
    o = _attend(cfg, _rope(q, cos, sin), _rope(k, cos, sin), v, mask)
    return _finish_layer(cfg, lp, x, o)


@torch.no_grad()
def encode(params: Qwen3Encoder, cfg: Qwen3Config, input_ids, attention_mask=None,
           hidden_states_layers: Sequence[int] = (9, 18, 27)) -> torch.Tensor:
    """input_ids [B, S] (numpy or a tensor) → the picked hidden states
    channel-concatenated, [B, S, len(layers) · hidden], f32 on the
    encoder's device.  Layers past the highest one picked are not run."""
    dev = params.embed_tokens.device
    ids = torch.as_tensor(np.asarray(input_ids) if not torch.is_tensor(input_ids)
                          else input_ids).to(dev, torch.long)
    s = ids.shape[1]
    x = params.embed_tokens[ids]
    require_f32(x, "the Qwen3 text encoder")
    cos, sin = rope_cos_sin(cfg, s, dev)
    mask = _causal_mask(s, attention_mask, dev)
    top = max(hidden_states_layers)
    collected = {0: x}
    for li, lp in enumerate(params.layers):
        if li >= top:
            break
        x = _layer(cfg, x, lp, cos, sin, mask)
        collected[li + 1] = x
    if top >= cfg.num_layers:
        collected[cfg.num_layers] = _rms(params.norm, x, cfg.rms_norm_eps)
    return torch.cat([collected[k] for k in hidden_states_layers], dim=-1)


# ===========================================================================
# checkpoints (transformers Qwen3ForCausalLM names)

def qwen3_top(sd: Mapping, dtype=torch.float32) -> dict:
    from qflux_tpu_torch.models.porting import _scale, _t
    from qflux_tpu_torch.models.qwen.porting import _detect_prefix

    pre = _detect_prefix(sd, ["model."])
    return {"embed_tokens": _t(sd[f"{pre}embed_tokens.weight"]).to(dtype),
            "norm": _scale(sd, f"{pre}norm", dtype)}


def qwen3_layer(sd: Mapping, i: int, dtype=torch.float32) -> dict:
    from qflux_tpu_torch.models.porting import _lin_nobias, _scale
    from qflux_tpu_torch.models.qwen.porting import _detect_prefix

    b = f"{_detect_prefix(sd, ['model.'])}layers.{i}"
    return {"input_layernorm": _scale(sd, f"{b}.input_layernorm", dtype),
            "post_attention_layernorm": _scale(sd, f"{b}.post_attention_layernorm", dtype),
            "attn": {"q": _lin_nobias(sd, f"{b}.self_attn.q_proj", dtype),
                     "k": _lin_nobias(sd, f"{b}.self_attn.k_proj", dtype),
                     "v": _lin_nobias(sd, f"{b}.self_attn.v_proj", dtype),
                     "o": _lin_nobias(sd, f"{b}.self_attn.o_proj", dtype),
                     "q_norm": _scale(sd, f"{b}.self_attn.q_norm", dtype),
                     "k_norm": _scale(sd, f"{b}.self_attn.k_norm", dtype)},
            "mlp": {"gate": _lin_nobias(sd, f"{b}.mlp.gate_proj", dtype),
                    "up": _lin_nobias(sd, f"{b}.mlp.up_proj", dtype),
                    "down": _lin_nobias(sd, f"{b}.mlp.down_proj", dtype)}}


def convert_qwen3(sd: Mapping, num_layers: int, dtype=torch.float32) -> dict:
    """A transformers Qwen3ForCausalLM state dict → JAX's tree ("layers" a
    list of per-layer dicts; torch tensors on the CPU as leaves)."""
    p = qwen3_top(sd, dtype)
    p["layers"] = [qwen3_layer(sd, i, dtype) for i in range(num_layers)]
    return p


def load_from_state_dict(sd: Mapping, cfg: Qwen3Config, device=None,
                         num_layers: Optional[int] = None) -> Qwen3Encoder:
    """The encoder on `device`, read one layer at a time (the host holds one
    layer's f32 copy), `num_layers` of them (cfg.num_layers by default).
    The keys no converter read (`lm_head.weight` among them) are reported
    as the coverage audit does."""
    from qflux_tpu_torch.models import bridge, porting

    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    tsd = porting.TrackingStateDict(sd)
    model = Qwen3Encoder(cfg, device=device)
    top = qwen3_top(tsd)
    with torch.no_grad():
        model.embed_tokens.copy_(top["embed_tokens"])
    bridge.load_params(model.norm, top["norm"])
    for i, lp in enumerate(model.layers):
        bridge.load_params(lp, qwen3_layer(tsd, i))
    porting.report_unconsumed(tsd.unconsumed(), len(sd), "the Qwen3 converter")
    return model
