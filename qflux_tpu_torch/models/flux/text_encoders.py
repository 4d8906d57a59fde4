"""CLIP-L text encoder (pooled) and T5 encoder (sequence) for FLUX
conditioning, in PyTorch.

Counterpart of qflux_tpu/models/flux/text_encoders.py.  Module attribute
names are the JAX tree's keys (`models/bridge.py:load_text_params` loads a
JAX tree or either package's converter output into them; a dense layer is
a `Dense`, weight [out, in]).  Both run in float32, as JAX runs them, and
on the card raise unless TF32 is off (`ops.layers.require_f32`).

CLIP (openai/clip-vit-large-patch14 text tower): 12 layers, d = 768, causal
attention, quick-GELU; pooled output = the final-LN hidden at the first EOS
position.  T5 (google/t5-v1_1-xxl encoder): 24 blocks, d = 4096, RMS layer
norm (no mean subtraction), a relative-position-bucket attention bias
shared from block 0 (computed once a call: [H, S, S] f32 is 64 MiB at
S = 512), gated-GELU feed-forward, no biases, no 1/sqrt(d) score scale.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qflux_tpu_torch.ops.layers import Dense, dense, require_f32


def _param(*shape, device=None, dtype=None, fill=None) -> nn.Parameter:
    t = torch.empty(*shape, device=device, dtype=dtype)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class NormParams(nn.Module):
    """{"scale", "bias"} of a layer norm (T5's: {"scale"} alone)."""

    def __init__(self, d, bias=True, device=None, dtype=None):
        super().__init__()
        self.scale = _param(d, device=device, dtype=dtype, fill=1.0)
        self.bias = _param(d, device=device, dtype=dtype, fill=0.0) if bias else None


# ===========================================================================
# CLIP text encoder

@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    eos_token_id: int = 49407

    @classmethod
    def tiny(cls):
        return cls(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64, max_position_embeddings=16, eos_token_id=999)


class _CLIPAttn(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.q, self.k, self.v = Dense(d, d, **kw), Dense(d, d, **kw), Dense(d, d, **kw)
        self.lin_out = Dense(d, d, **kw)  # the tree's "out"


class _CLIPMlp(nn.Module):
    def __init__(self, d, ff, **kw):
        super().__init__()
        self.fc1, self.fc2 = Dense(d, ff, **kw), Dense(ff, d, **kw)


class _CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1, self.layer_norm2 = NormParams(d, **kw), NormParams(d, **kw)
        self.attn = _CLIPAttn(d, **kw)
        self.mlp = _CLIPMlp(d, cfg.intermediate_size, **kw)


class CLIPText(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.token_embedding = _param(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embedding = _param(cfg.max_position_embeddings, cfg.hidden_size, **kw)
        self.final_layer_norm = NormParams(cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(_CLIPLayer(cfg, **kw) for _ in range(cfg.num_layers))


def clip_init(generator: torch.Generator, cfg: CLIPTextConfig, device=None,
              dtype=torch.float32) -> CLIPText:
    """Random weights with `clip_init`'s distributions: embeddings N(0,
    0.02²), dense layers U(±1/sqrt(in)), unit / zero layer norms."""
    model = CLIPText(cfg, device=device, dtype=dtype)
    with torch.no_grad():
        for emb in (model.token_embedding, model.position_embedding):
            emb.normal_(generator=generator).mul_(0.02)
        for mod in model.modules():
            if isinstance(mod, Dense):
                mod.init_(generator)
    return model


def _ln(p: NormParams, x, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return (((x32 - mu) * torch.rsqrt(var + eps)) * p.scale + p.bias).to(x.dtype)


def _ids(params: nn.Module, input_ids) -> torch.Tensor:
    dev = next(params.parameters()).device
    return torch.as_tensor(np.asarray(input_ids) if not torch.is_tensor(input_ids)
                           else input_ids).to(device=dev, dtype=torch.long)


def clip_encode(params: CLIPText, cfg: CLIPTextConfig, input_ids):
    """input_ids [B, S] → (last_hidden [B, S, D], pooled [B, D]): pooled is
    the final-LN hidden at the first EOS token (CLIPTextModel's pooler)."""
    ids = _ids(params, input_ids)
    require_f32(ids, "CLIP")
    b, s = ids.shape
    n_h = cfg.num_heads
    x = params.token_embedding[ids] + params.position_embedding[:s]
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=ids.device))
    for lp in params.layers:
        h = _ln(lp.layer_norm1, x)
        a = lp.attn
        q = dense(a.q, h).reshape(b, s, n_h, -1)
        k = dense(a.k, h).reshape(b, s, n_h, -1)
        v = dense(a.v, h).reshape(b, s, n_h, -1)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(
            q.shape[-1])
        logits = torch.where(causal[None, None], logits, torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1)
        x = x + dense(a.lin_out, o)
        h = _ln(lp.layer_norm2, x)
        h = dense(lp.mlp.fc1, h)
        h = h * torch.sigmoid(1.702 * h)  # quick_gelu
        x = x + dense(lp.mlp.fc2, h)
    x = _ln(params.final_layer_norm, x)
    eos_pos = torch.argmax((ids == cfg.eos_token_id).to(torch.int32), dim=1)
    pooled = x[torch.arange(b, device=ids.device), eos_pos]
    return x, pooled


# ===========================================================================
# T5 encoder

@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6

    @classmethod
    def tiny(cls):
        return cls(vocab_size=1000, d_model=64, d_kv=16, d_ff=128,
                   num_layers=2, num_heads=4)


class _T5Attn(nn.Module):
    def __init__(self, d, inner, **kw):
        super().__init__()
        self.q, self.k, self.v = (Dense(d, inner, bias=False, **kw) for _ in range(3))
        self.o = Dense(inner, d, bias=False, **kw)


class _T5FF(nn.Module):
    def __init__(self, d, ff, **kw):
        super().__init__()
        self.wi_0, self.wi_1 = Dense(d, ff, bias=False, **kw), Dense(d, ff, bias=False, **kw)
        self.wo = Dense(ff, d, bias=False, **kw)


class _T5Layer(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        d = cfg.d_model
        self.ln0 = NormParams(d, bias=False, **kw)
        self.attn = _T5Attn(d, cfg.num_heads * cfg.d_kv, **kw)
        self.ln1 = NormParams(d, bias=False, **kw)
        self.ff = _T5FF(d, cfg.d_ff, **kw)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.shared = _param(cfg.vocab_size, cfg.d_model, **kw)
        self.relative_attention_bias = _param(cfg.relative_attention_num_buckets,
                                              cfg.num_heads, **kw)
        self.final_layer_norm = NormParams(cfg.d_model, bias=False, **kw)
        self.layers = nn.ModuleList(_T5Layer(cfg, **kw) for _ in range(cfg.num_layers))


def t5_init(generator: torch.Generator, cfg: T5Config, device=None,
            dtype=torch.float32) -> T5Encoder:
    """Random weights with `t5_init`'s distributions: `shared` N(0, 1), the
    bias table N(0, 0.1²), every dense weight N(0, 1/in), unit norms."""
    model = T5Encoder(cfg, device=device, dtype=dtype)
    with torch.no_grad():
        model.shared.normal_(generator=generator)
        model.relative_attention_bias.normal_(generator=generator).mul_(0.1)
        for mod in model.modules():
            if isinstance(mod, Dense):
                mod.weight.normal_(generator=generator).mul_(mod.in_dim ** -0.5)
    return model


def _t5_ln(p: NormParams, x, eps=1e-6):
    """T5 layer norm: RMS, no mean subtraction, no bias."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p.scale.float()).to(x.dtype)


def _relative_position_bucket(rel_pos, num_buckets=32, max_distance=128):
    """Bidirectional T5 bucket mapping (half the buckets for each sign,
    log-spaced beyond num_buckets // 4), in numpy on the host."""
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int32) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int32)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


def t5_position_bias(params: T5Encoder, cfg: T5Config, seq_len: int) -> torch.Tensor:
    """[1, heads, S, S] additive attention bias, f32 (buckets on the host,
    the table gathered on the parameters' device)."""
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    buckets = _relative_position_bucket(
        mem - ctx, cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance)
    table = params.relative_attention_bias
    bias = table[torch.from_numpy(buckets).to(table.device, torch.long)]  # [S, S, H]
    return bias.permute(2, 0, 1)[None].float()


def t5_encode(params: T5Encoder, cfg: T5Config, input_ids, attention_mask=None):
    """input_ids [B, S] → last hidden state [B, S, d_model]."""
    ids = _ids(params, input_ids)
    require_f32(ids, "T5")
    b, s = ids.shape
    n_h, dk = cfg.num_heads, cfg.d_kv
    x = params.shared[ids]
    bias = t5_position_bias(params, cfg, s)
    if attention_mask is not None:
        keep = torch.as_tensor(np.asarray(attention_mask) if not torch.is_tensor(
            attention_mask) else attention_mask).to(ids.device).bool()
        bias = bias + torch.where(keep[:, None, None, :], 0.0, -1e30)
    for lp in params.layers:
        h = _t5_ln(lp.ln0, x, cfg.layer_norm_eps)
        a = lp.attn
        q = dense(a.q, h).reshape(b, s, n_h, dk)
        k = dense(a.k, h).reshape(b, s, n_h, dk)
        v = dense(a.v, h).reshape(b, s, n_h, dk)
        # T5 applies NO 1/sqrt(d) scaling (folded into its init)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(logits + bias, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1)
        x = x + dense(a.o, o)
        h = _t5_ln(lp.ln1, x, cfg.layer_norm_eps)
        gelu = F.gelu(dense(lp.ff.wi_0, h), approximate="tanh")
        x = x + dense(lp.ff.wo, gelu * dense(lp.ff.wi_1, h))
    return _t5_ln(params.final_layer_norm, x, cfg.layer_norm_eps)
