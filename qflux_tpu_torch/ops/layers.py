"""Dense layers with LoRA, and the LoRA tree plumbing.

Counterpart of qflux_tpu/ops/layers.py.  The JAX package keeps parameters in
a nested-dict pytree and LoRA in a second tree grafted onto it by
`merge_lora`; here a dense layer is a `Dense` module (weight [out, in], as
nn.Linear) and a LoRA tree is a flat dict keyed by the module's '/'-path
(`"dual/3/attn/to_q"`) holding {"a" [in, r], "b" [r, out], "scaling"}.
`merge_lora` attaches those tensors to the matching `Dense` modules in place,
beside the frozen base weight: there is never a second copy of the base.

A dense layer may also hold its frozen weight quantized, as frozen
parameters (`QUANT_LEAVES`), in any form of JAX's `quantize_tree` (`Dense.set_quantized`;
`q_form` names the form).  The int4 forms keep packed int4 `q4 [K/2, N]`
and group scales `scale [K/G, N]` in the JAX layout; the per-channel forms
keep `q [N, K]` (int8 or fp8, laid out as the weight) and `scale [1, N]`.
Each routes as qflux_tpu/ops/layers.py:_base_matmul does:

  * W4A8-requant ("int4_requant", JAX's `kernel_q4_rq`), with the requant
    factors (f, s_vec) cached beside q4: calls with at most 32 rows (the
    AdaLN modulation projections, `time_in`) dequantize the weight to
    x.dtype and multiply with an f32 result; the rest run the fused requant
    matmul (kernel K5a on the card, its input gradient kernel K5b), whose
    result is already in x.dtype;
  * W4A8 per group ("int4_dynamic", `kernel_q4_dyn`): the same tiny-M rule,
    else `quant.dyn_int4_matmul`, in x.dtype;
  * W4A16 ("int4", `kernel_q4`), with no tiny-M rule: where
    `QFLUX_FUSED_INT4=1` is set when the call runs and
    `int4_matmul.supports` holds, the fused W4A16 matmul (kernel K6a on the
    card, its input gradient kernel K6b; x cast to bf16, the result in
    x.dtype); otherwise, JAX's default, the weight dequantized to x.dtype and
    an f32 product;
  * W8A8 ("int8_dynamic", `kernel_q_dyn`): at most 32 rows take the
    weight-only product (f32 result); the rest the W8A8 matmul
    (ops/int8_matmul.py: the row quantization and the int8 `wgmma` GEMM
    on the card), in x.dtype;
  * weight-only ("int8", "fp8_e4m3", "fp8_e5m2", `kernel_q`):
    `quant.wo_matmul`, the weight dequantized to x.dtype, an f32 result.

A base product in x.dtype makes the LoRA delta and the bias add in x.dtype.
Every route is differentiable in x and never in the frozen weight.
`set_int4_impl(model, "plain")` sends the kernel routes (K5a, K6a, W8A8)
to their plain versions instead: an explicit switch for comparing with the
kernels, as attn_impl="plain" is.  `fuse_lora` folds a LoRA into the base
weights in place, through a dequantize → requantize cycle on quantized
layers.

For training, `mark_trainable` makes `a`, `b` and `scaling` f32 leaf
tensors with `requires_grad`; the base weights and biases stay frozen
parameters.  `scaling` (alpha / r, a 0-dim f32 tensor) is differentiated
too, because in JAX it is an f32 array leaf of the LoRA tree that
`jax.value_and_grad` differentiates: its gradient joins the global norm
(clip and logged grad_norm) while its update is zeroed
(trainer/train_step.py).  Upstream PEFT keeps alpha / r a Python float with
no gradient; the port mirrors the JAX package, not PEFT (ROADMAP.md, queue 3).
"""

from __future__ import annotations

import os
import re
from typing import Iterator, Optional

import torch
from torch import nn

from qflux_tpu_torch.ops import int4_matmul, int8_matmul, quant, remat
from qflux_tpu_torch.ops.quant import _matmul_f32

LoraTree = dict  # {"dual/0/attn/to_q": {"a", "b", "scaling"}, ...}


def require_f32(t: torch.Tensor, what: str) -> None:
    """Raise where `t` is on the card and torch would run f32 matmuls or
    convolutions in TF32 (cuDNN's default for convolutions, ~1e-3 off):
    `what` runs in float32, as JAX runs it.  The caller turns both switches
    off (the Trainer does on the card, for the whole process)."""
    if t.is_cuda and (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(f"{what} runs in float32: set torch.backends.cudnn.allow_tf32 "
                           "and torch.backends.cuda.matmul.allow_tf32 to False first")


# the frozen parameters a quantized Dense holds in place of its weight
QUANT_LEAVES = ("q4", "q", "scale", "rq_f", "rq_s_vec")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    """A frozen parameter over t's values, contiguous (parameters, not
    buffers, so that FSDP2 shards them with the rest of the base)."""
    return nn.Parameter(t.detach().contiguous(), requires_grad=False)


class Dense(nn.Module):
    """y = x @ W^T + b.  `lora` is None or the {"a", "b", "scaling"} dict
    set by `merge_lora`.  The weight is `weight [out, in]`, or, after
    `set_quantized`, the frozen parameters of the form `q_form` names: `q4` and
    `scale` (+ `rq_f`, `rq_s_vec` for "int4_requant") for the int4 forms,
    `q` and `scale` for the per-channel ones."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.in_dim, self.out_dim = in_dim, out_dim
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, **kw), requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(out_dim, **kw), requires_grad=False)
                     if bias else None)
        self.lora: Optional[dict] = None
        for name in QUANT_LEAVES:
            self.register_parameter(name, None)
        self.q_form: Optional[str] = None  # quant.INT4_FORMS / CHANNEL_FORMS once quantized
        self.impl = "auto"  # "plain": the plain matmuls instead of K5a / K6a / W8A8

    @property
    def device(self) -> torch.device:
        return next(t for t in (self.weight, self.q4, self.q) if t is not None).device

    def set_quantized(self, q, scale, form: str) -> None:
        """Hold the frozen weight in `form`, dropping the full-precision
        weight.  The int4 forms take q4 [in/2, out] int8 and scale [in/G,
        out] (JAX's `kernel_q4*` / `kernel_scale`); "int4_requant" caches
        its requant factors.  The per-channel forms take q [out, in] (JAX's
        `kernel_q` / `kernel_q_dyn` transposed: int8 for "int8" and
        "int8_dynamic", fp8 for "fp8_*") and scale [1, out].  Raises on a
        leaf that does not fit the layer."""
        if form in quant.INT4_FORMS:
            want, name = ((self.in_dim // 2, self.out_dim), torch.int8), "q4"
            fits = (scale.dim() == 2 and scale.shape[1] == self.out_dim
                    and self.in_dim % scale.shape[0] == 0)
        elif form in quant.CHANNEL_FORMS:
            dt = quant.QDTYPE["int8" if form == "int8_dynamic" else form]
            want, name = ((self.out_dim, self.in_dim), dt), "q"
            fits = tuple(scale.shape) == (1, self.out_dim)
        else:
            raise ValueError(f"unknown quantized form {form!r}")
        if (tuple(q.shape), q.dtype) != want:
            raise ValueError(f"{form} q {q.dtype} {tuple(q.shape)} does not fit "
                             f"{self.in_dim}→{self.out_dim}")
        if not fits:
            raise ValueError(f"{form} scale {tuple(scale.shape)} does not fit "
                             f"{self.in_dim}→{self.out_dim}")
        self.weight = None
        self.q_form = form
        for n in QUANT_LEAVES:
            setattr(self, n, None)
        for n, t in ((name, q), ("scale", scale.float())):
            setattr(self, n, _frozen(t))
        if form == "int4_requant":
            f, s_vec = quant._requant_factors(self.scale)
            for n, t in (("rq_f", f), ("rq_s_vec", s_vec)):
                setattr(self, n, _frozen(t))

    def init_(self, generator: torch.Generator) -> None:
        """Torch-nn.Linear-compatible init, as `dense_init`: U(±1/sqrt(in))."""
        bound = 1.0 / (self.in_dim ** 0.5)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)


class MLP(nn.Module):
    """Linear → activation → Linear; `lin_in`/`lin_out` are the JAX tree's
    "in"/"out" nodes."""

    def __init__(self, dim: int, hidden: int, out_dim: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        self.lin_in = Dense(dim, hidden, device=device, dtype=dtype)
        self.lin_out = Dense(hidden, out_dim or dim, device=device, dtype=dtype)


def _base_matmul(p: Dense, x):
    """x @ W^T for whatever form the frozen weight is held in, by the JAX
    package's routes (the module docstring): the tiny-M rule (at most 32
    rows) for int4_requant, int4_dynamic and int8_dynamic; f32 results from
    the full-precision, dequantized and weight-only products, x.dtype from
    the int8 ones."""
    form = p.q_form
    if form is None:
        return _matmul_f32(x, p.weight)
    plain = p.impl == "plain"
    tiny_m = x.numel() // x.shape[-1] <= 32
    if form == "int4":
        if (os.environ.get("QFLUX_FUSED_INT4") == "1"
                and int4_matmul.supports(2 * p.q4.shape[0], p.q4.shape[1], p.scale.shape[-2])):
            if plain:
                return int4_matmul.int4_matmul_plain(x, p.q4, p.scale)
            return int4_matmul.int4_matmul(x, p.q4, p.scale)
    elif form == "int4_dynamic" and not tiny_m:
        return quant.dyn_int4_matmul(x, p.q4, p.scale)
    elif form == "int4_requant" and not tiny_m:
        factors = (p.rq_f, p.rq_s_vec)
        if plain:
            return quant.requant_int4_matmul(x, p.q4, p.scale, factors)
        return int4_matmul.rq_fused_matmul(x, p.q4, p.scale, factors)
    elif form == "int8_dynamic" and not tiny_m:
        if plain:
            return quant.dyn_int8_matmul(x, p.q, p.scale[0])
        return int8_matmul.dyn_int8_matmul(x, p.q, p.scale[0])
    elif form in quant.CHANNEL_FORMS:
        return quant.wo_matmul(x, p.q, p.scale[0])
    return _matmul_f32(x, quant.dequantize_kernel_int4(p.q4, p.scale, x.dtype).t())


def dense(p: Dense, x, lora_scale: float = 1.0, keep: Optional[str] = None):
    """y = x@W + b [+ lora_scale · scaling · (x@a)@b], returned in x.dtype.

    Cast points as in JAX: the base product accumulates and stays in f32
    (the fused int4 matmuls return x.dtype); both LoRA dots emit
    x.dtype and the scaling (a float, or a tensor that autograd
    differentiates) is rounded to x.dtype; the delta and the bias are added
    in y's dtype.

    Remat save points (ops/remat.py): the base product and both LoRA
    products are DOTs, which a "dots" block keeps.  `keep` (remat.QKV or
    remat.MLP_H) names the layer's whole output: a block that keeps it
    stores the output in its forward, and in its recompute the base product
    returns a placeholder (its autograd node saves what it always saves),
    the LoRA products run for their own saved tensors, and the stored
    output comes back, with their autograd history, in place of the adds,
    which save nothing."""
    replay = keep is not None and remat.replays(keep)
    if replay:
        with remat.skipping():
            y = _base_matmul(p, x)
    else:
        y = _base_matmul(p, x)
    if p.lora is not None:
        la, lb = p.lora["a"].to(x.dtype), p.lora["b"].to(x.dtype)
        s = p.lora.get("scaling", 1.0)
        s = s * lora_scale if torch.is_tensor(s) else torch.tensor(float(s) * lora_scale)
        s = s.to(device=x.device, dtype=x.dtype)
        xa = remat.product(remat.DOT, lambda: torch.matmul(x, la))
        delta = remat.product(remat.DOT, lambda: torch.matmul(xa, lb)) * s
        if replay:
            return remat.take(keep, x.device, y, delta)
        y = y + delta.to(y.dtype)
    elif replay:
        return remat.take(keep, x.device, y)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return remat.put(keep, y.to(x.dtype)) if keep is not None else y.to(x.dtype)


def set_int4_impl(module: nn.Module, impl: str) -> None:
    """Route every quantized dense layer of `module` through the kernels
    (K5a, K6a, the W8A8 GEMM: "auto") or their plain versions ("plain")."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown int4 impl {impl!r} (auto | plain)")
    for _, node in iter_dense_paths(module):
        node.impl = impl


def iter_dense_paths(module: nn.Module) -> Iterator[tuple[str, Dense]]:
    """(path, Dense) for every dense layer, path '/'-joined ("dual/0/attn/to_q")."""
    for name, mod in module.named_modules():
        if isinstance(mod, Dense):
            yield name.replace(".", "/"), mod


def merge_lora(model: nn.Module, lora: Optional[LoraTree]) -> nn.Module:
    """Make `lora` the model's adapter set, in place: every Dense whose path
    is a key of `lora` gets that {"a", "b", "scaling"} dict, every other
    Dense gets none (so a later call without LoRA leaves no stale adapter).
    The tensors are referenced, not copied.  Returns the model."""
    lora = lora or {}
    seen = set()
    for path, node in iter_dense_paths(model):
        leaf = lora.get(path)
        if leaf is not None:
            if leaf["a"].shape[-2] != node.in_dim or leaf["b"].shape[-1] != node.out_dim:
                raise ValueError(f"LoRA {path}: a {tuple(leaf['a'].shape)} / b "
                                 f"{tuple(leaf['b'].shape)} do not fit {node.in_dim}→{node.out_dim}")
            seen.add(path)
        node.lora = leaf
    missing = sorted(set(lora) - seen)
    if missing:
        raise KeyError(f"LoRA paths with no dense layer in the model: {missing[:5]}")
    return model


def build_lora_tree(generator: torch.Generator, model: nn.Module,
                    target_patterns: list[str], rank: int, alpha: float,
                    dtype=torch.float32, init: str = "gaussian") -> LoraTree:
    """A LoRA leaf for every dense layer whose '/'-path matches any regex in
    target_patterns (reference LoraConfig.target_modules semantics): a
    gaussian (·1/rank) or kaiming-uniform, b zeros, scaling alpha/rank (a
    0-dim f32 tensor).  Tensors live on the generator's device; they do not
    require grad until `mark_trainable`."""
    pats = [re.compile(p) for p in target_patterns]
    device = generator.device
    tree: LoraTree = {}
    for path, node in iter_dense_paths(model):
        if not any(p.search(path) for p in pats):
            continue
        shape = (node.in_dim, rank)
        if init == "gaussian":
            a = torch.randn(shape, generator=generator, device=device, dtype=dtype) * (1.0 / rank)
        else:  # kaiming-uniform, PEFT default
            bound = (3.0 / node.in_dim) ** 0.5
            a = torch.empty(shape, device=device, dtype=dtype).uniform_(
                -bound, bound, generator=generator)
        tree[path] = {"a": a,
                      "b": torch.zeros((rank, node.out_dim), device=device, dtype=dtype),
                      "scaling": torch.tensor(alpha / rank, device=device, dtype=torch.float32)}
    return tree


def mark_trainable(lora: LoraTree) -> LoraTree:
    """Make every tensor of the tree (a, b and scaling) a leaf that requires
    grad, in place, and return the tree.  A float scaling becomes a 0-dim f32
    tensor: JAX differentiates it as an array leaf."""
    for leaf in lora.values():
        s = leaf.get("scaling", 1.0)
        if not torch.is_tensor(s):
            s = torch.tensor(float(s), dtype=torch.float32, device=leaf["a"].device)
        leaf["scaling"] = s
        for key in ("a", "b", "scaling"):
            leaf[key] = leaf[key].detach().requires_grad_()
    return lora


def _fuse_into_node(node: Dense, delta) -> None:
    """W += delta ([in, out] f32), in place, for whatever form the frozen
    weight is held in, as JAX's `_fuse_into_node`: a full-precision weight
    adds in f32 and casts back; a quantized one is dequantized to f32, the
    delta added, and quantized again onto the same family (per-channel int8
    / fp8, or grouped int4 with the group size from the scale's shape; the
    requant factors recomputed)."""
    with torch.no_grad():
        if node.q_form is None:
            w = node.weight
            w.copy_((w.float() + delta.t()).to(w.dtype))
            return
        if node.q_form in quant.INT4_FORMS:
            w = quant.dequantize_kernel_int4(node.q4, node.scale, torch.float32)
            q, scale = quant.quantize_kernel_int4(w + delta, w.shape[-2] // node.scale.shape[-2])
        else:
            w = node.q.float().t() * node.scale  # [in, out], JAX's f32(q) · scale
            qdt = "int8" if node.q_form == "int8_dynamic" else node.q_form
            q, scale = quant.quantize_kernel(w + delta, qdt)
            q = q.t()
        node.set_quantized(q, scale, node.q_form)


def fuse_lora(model: nn.Module, lora: LoraTree, scale: float = 1.0) -> nn.Module:
    """Fold `lora` into the base weights for good, in place (W +=
    scale · scaling · a@b, the product in f32), over full-precision and
    quantized layers alike (`_fuse_into_node`), as JAX's `fuse_lora`: used
    for DreamOmni2's fused edit-LoRA load.  Returns the model."""
    nodes = dict(iter_dense_paths(model))
    missing = sorted(set(lora) - set(nodes))
    if missing:
        raise KeyError(f"LoRA paths with no dense layer in the model: {missing[:5]}")
    for path, leaf in lora.items():
        node = nodes[path]
        scaling = torch.as_tensor(leaf.get("scaling", 1.0), dtype=torch.float32,
                                  device=node.device)
        delta = torch.matmul(leaf["a"].detach().to(node.device, torch.float32),
                             leaf["b"].detach().to(node.device, torch.float32))
        _fuse_into_node(node, delta * (scale * scaling.detach()))
    return model
