"""Dense layers with LoRA, and the LoRA tree plumbing.

Counterpart of qflux_tpu/ops/layers.py.  The JAX package keeps parameters in
a nested-dict pytree and LoRA in a second tree grafted onto it by
`merge_lora`; here a dense layer is a `Dense` module (weight [out, in], as
nn.Linear) and a LoRA tree is a flat dict keyed by the module's '/'-path
(`"dual/3/attn/to_q"`) holding {"a" [in, r], "b" [r, out], "scaling"}.
`merge_lora` attaches those tensors to the matching `Dense` modules in place,
beside the frozen base weight: there is never a second copy of the base.

A dense layer may also hold its frozen weight as packed int4 `q4 [K/2, N]`
and group scales `scale [K/G, N]` in the JAX layout, as frozen buffers
(`quantize_tree` leaves them so), in one of two forms, which `q4_form`
names.  Each routes as qflux_tpu/ops/layers.py:_base_matmul does:

  * W4A8-requant (`Dense.set_int4_requant`, JAX's `kernel_q4_rq`), with the
    requant factors (f, s_vec) cached beside q4: calls with at most 32 rows
    (the AdaLN modulation projections, `time_in`) dequantize the weight to
    x.dtype and multiply with an f32 result; the rest run the fused requant
    matmul (kernel K5a on the card, its input gradient kernel K5b), whose
    result is already in x.dtype;
  * W4A16 (`Dense.set_int4`, JAX's `kernel_q4`), with no tiny-M rule: where
    `QFLUX_FUSED_INT4=1` is set when the call runs and
    `int4_matmul.supports` holds, the fused W4A16 matmul (kernel K6a on the
    card, its input gradient kernel K6b; x cast to bf16, the result in
    x.dtype); otherwise, JAX's default, the weight dequantized to x.dtype and
    an f32 product.

A base product in x.dtype makes the LoRA delta and the bias add in x.dtype.
Every route is differentiable in x and never in the frozen weight.
`set_int4_impl(model, "plain")` sends the fused routes to their plain
versions instead: an explicit switch for comparing with the kernels, as
attn_impl="plain" is.

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

from qflux_tpu_torch.ops import int4_matmul, quant

LoraTree = dict  # {"dual/0/attn/to_q": {"a", "b", "scaling"}, ...}


class Dense(nn.Module):
    """y = x @ W^T + b.  `lora` is None or the {"a", "b", "scaling"} dict
    set by `merge_lora`.  The weight is `weight [out, in]`, or, after
    `set_int4_requant`, the buffers `q4`, `scale`, `rq_f` and `rq_s_vec`
    (`q4_form` "int4_requant"), or, after `set_int4`, `q4` and `scale`
    (`q4_form` "int4")."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.in_dim, self.out_dim = in_dim, out_dim
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, **kw), requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(out_dim, **kw), requires_grad=False)
                     if bias else None)
        self.lora: Optional[dict] = None
        for name in ("q4", "scale", "rq_f", "rq_s_vec"):
            self.register_buffer(name, None)
        self.q4_form: Optional[str] = None  # "int4_requant" | "int4" once quantized
        self.impl = "auto"  # "plain": the plain int4 matmuls instead of K5a / K6a

    def _set_q4(self, q4, scale, form: str) -> None:
        if tuple(q4.shape) != (self.in_dim // 2, self.out_dim) or q4.dtype != torch.int8:
            raise ValueError(f"q4 {q4.dtype} {tuple(q4.shape)} does not fit "
                             f"{self.in_dim}→{self.out_dim}")
        if (scale.dim() != 2 or scale.shape[1] != self.out_dim
                or self.in_dim % scale.shape[0]):
            raise ValueError(f"scale {tuple(scale.shape)} does not fit "
                             f"{self.in_dim}→{self.out_dim}")
        self.weight = None
        self.q4_form = form
        for name, t in (("q4", q4), ("scale", scale.float())):
            self.register_buffer(name, t.contiguous())

    def set_int4_requant(self, q4, scale) -> None:
        """Hold the frozen weight as W4A8-requant int4 (q4 [in/2, out] int8,
        scale [in/G, out] f32, the JAX `kernel_q4_rq` / `kernel_scale`),
        dropping the full-precision weight; caches the requant factors."""
        self._set_q4(q4, scale, "int4_requant")
        f, s_vec = quant._requant_factors(self.scale)
        for name, t in (("rq_f", f), ("rq_s_vec", s_vec)):
            self.register_buffer(name, t.contiguous())

    def set_int4(self, q4, scale) -> None:
        """Hold the frozen weight as W4A16 int4 (q4 [in/2, out] int8, scale
        [in/G, out] f32, the JAX `kernel_q4` / `kernel_scale`), dropping the
        full-precision weight."""
        self._set_q4(q4, scale, "int4")

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


class _MatmulF32Out(torch.autograd.Function):
    """x2 [N, in] @ W^T with an f32 result through cuBLAS `out_dtype`.  The
    `aten::mm.dtype` overload has no derivative formula, so this gives it
    one: dx = g @ W in x's dtype (bf16 operands, f32 accumulation).  W is a
    frozen base weight: no dW is computed."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return torch.mm(g.to(w.dtype), w), None


def _matmul_f32(x, w):
    """x @ w^T (w [out, in]) with an f32 result, as `jnp.dot(...,
    preferred_element_type=f32)`: f32 inputs multiply in f32 (the weight
    cast to x.dtype, as JAX); bf16 inputs accumulate in f32 and keep the f32
    result (cuBLAS `out_dtype` on the card; widened operands on the CPU,
    same math)."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w.to(x.dtype).t())
    w = w.to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        y = _MatmulF32Out.apply(x2, w)
    else:
        y = torch.mm(x2.float(), w.float().t())
    return y.reshape(*x.shape[:-1], w.shape[0])


def _base_matmul(p: Dense, x):
    """x @ W^T for whatever form the frozen weight is held in, by the JAX
    package's routes.  W4A16: with `QFLUX_FUSED_INT4=1` where `supports`
    holds, the fused W4A16 matmul, in x.dtype; otherwise dequantized to
    x.dtype, f32 result.  W4A8-requant: at most 32 rows → dequantized to
    x.dtype, f32 result (a GEMV-shaped call gains nothing from the int8
    path); otherwise the requant matmul, in x.dtype."""
    if p.q4 is None:
        return _matmul_f32(x, p.weight)
    if p.q4_form == "int4":
        if (os.environ.get("QFLUX_FUSED_INT4") == "1"
                and int4_matmul.supports(2 * p.q4.shape[0], p.q4.shape[1], p.scale.shape[-2])):
            if p.impl == "plain":
                return int4_matmul.int4_matmul_plain(x, p.q4, p.scale)
            return int4_matmul.int4_matmul(x, p.q4, p.scale)
    elif x.numel() // x.shape[-1] > 32:
        factors = (p.rq_f, p.rq_s_vec)
        if p.impl == "plain":
            return quant.requant_int4_matmul(x, p.q4, p.scale, factors)
        return int4_matmul.rq_fused_matmul(x, p.q4, p.scale, factors)
    return _matmul_f32(x, quant.dequantize_kernel_int4(p.q4, p.scale, x.dtype).t())


def dense(p: Dense, x, lora_scale: float = 1.0):
    """y = x@W + b [+ lora_scale · scaling · (x@a)@b], returned in x.dtype.

    Cast points as in JAX: the base product accumulates and stays in f32
    (the fused int4 matmuls return x.dtype); both LoRA dots emit
    x.dtype and the scaling (a float, or a tensor that autograd
    differentiates) is rounded to x.dtype; the delta and the bias are added
    in y's dtype."""
    y = _base_matmul(p, x)
    if p.lora is not None:
        la, lb = p.lora["a"].to(x.dtype), p.lora["b"].to(x.dtype)
        s = p.lora.get("scaling", 1.0)
        s = s * lora_scale if torch.is_tensor(s) else torch.tensor(float(s) * lora_scale)
        s = s.to(device=x.device, dtype=x.dtype)
        y = y + (torch.matmul(torch.matmul(x, la), lb) * s).to(y.dtype)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y.to(x.dtype)


def raise_quantized(kind: str):
    """Quantized frozen bases other than int4 (`kernel_q4`) and
    W4A8-requant (`kernel_q4_rq`) are not ported yet."""
    raise NotImplementedError(
        f"quantized dense form {kind!r} is not ported yet (ROADMAP.md, queue 1: \"The rest "
        "of slice B, part 2: the quantized bases that JAX runs in XLA, not Pallas\"; "
        "ported: kernel_q4, kernel_q4_rq)")


def set_int4_impl(module: nn.Module, impl: str) -> None:
    """Route every int4 dense layer of `module` through the kernels K5a / K6a
    ("auto") or the plain requant and W4A16 matmuls ("plain")."""
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
