"""Weight bridge: the JAX package's parameter trees → the port's modules.

Takes the nested-dict trees of qflux_tpu (leaves as numpy arrays, anything
`np.asarray` accepts, or CPU torch tensors) — the FLUX DiT tree from
`flux.init`, from the JAX package's converters or from the port's own
(`models/porting.py`, `models/qwen/porting.py`), the VAE tree, the LoRA
tree — and loads them into the port, so that both packages compute on the
same weights:

  * stacked `[L, ...]` leaves ("dual", "single", the VL encoder's "blocks"
    and "layers") are unstacked into the
    `nn.ModuleList`s;
  * a dense `kernel [in, out]` becomes `weight [out, in]`;
  * a quantized dense (qflux_tpu/ops/quant.py:quantize_tree) goes in with
    `Dense.set_quantized`, dropping the full-precision weight: the int4
    forms keep the JAX layout, `{kernel_q4_rq | kernel_q4 | kernel_q4_dyn
    [in/2, out], kernel_scale [in/G, out]}` (W4A8-requant, W4A16, W4A8 per
    group); the per-channel forms `{kernel_q | kernel_q_dyn [in, out],
    kernel_scale [1, out]}` (weight-only int8 / fp8, W8A8) are transposed
    once to q [out, in], as a kernel is.  A `kernel_q` leaf's element type
    names its form (int8, or ml_dtypes' float8_e4m3fn / float8_e5m2, which
    cross numpy as bytes); a leaf that does not fit the layer raises;
  * a conv `kernel` HWIO becomes `weight` OIHW, a 3D one [kt, kh, kw, cin,
    cout] `weight` OIDHW;
  * the JAX MLP nodes "in"/"out" are the modules `lin_in`/`lin_out`.

This module imports no jax; the trees come in as plain dicts of arrays.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from qflux_tpu_torch.ops.layers import Dense, LoraTree
from qflux_tpu_torch.ops.quant import QDTYPE

_RENAME = {"in": "lin_in", "out": "lin_out"}


def _tensor(x) -> torch.Tensor:
    """A leaf as a CPU torch tensor: torch tensors as they are (the port's
    converters write them), anything else through numpy as float32."""
    return x.detach() if torch.is_tensor(x) else torch.from_numpy(_np32(x))


def _np32(x) -> np.ndarray:
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":  # ml_dtypes bf16
        a = a.astype(np.float32)
    # torch.from_numpy wants a writable array (jax hands out read-only views)
    return a if a.flags.writeable else a.copy()


def _child(module: nn.Module, key: str) -> nn.Module:
    name = _RENAME.get(key, key)
    child = getattr(module, name, None)
    if not isinstance(child, nn.Module):
        raise KeyError(f"{type(module).__name__} has no submodule {name!r}")
    return child


# the quantized leaves that load, and the form each names (kernel_q's from
# its element type)
_Q_LEAVES = {"kernel_q4_rq": "int4_requant", "kernel_q4": "int4",
             "kernel_q4_dyn": "int4_dynamic", "kernel_q_dyn": "int8_dynamic", "kernel_q": None}
_Q_DTYPES = {dt: name for name, dt in QDTYPE.items()}
_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _qtensor(x) -> torch.Tensor:
    """A quantized leaf as a CPU torch tensor of its own element type: int8,
    or fp8 through a byte view (numpy knows fp8 only as ml_dtypes' types)."""
    if torch.is_tensor(x):
        return x.detach()
    a = np.asarray(x)
    if a.dtype.name in _FP8:
        return torch.from_numpy(a.view(np.uint8).copy()).view(_FP8[a.dtype.name])
    if a.dtype != np.int8:
        raise ValueError(f"a quantized leaf of {a.dtype}: int8 or fp8 loads")
    return torch.from_numpy(np.array(a))


def _load(module: nn.Module, tree: Mapping[str, Any], loaded: set, path: str) -> None:
    for key, form in _Q_LEAVES.items():
        if key not in tree:
            continue
        if not isinstance(module, Dense):
            raise KeyError(f"{path}{key}: {type(module).__name__} is not a dense layer")
        dev = module.device
        q = _qtensor(tree[key])
        scale = _tensor(tree["kernel_scale"]).to(dev, torch.float32)
        if key in ("kernel_q", "kernel_q_dyn"):
            form = form or _Q_DTYPES.get(q.dtype)
            if form is None:
                raise ValueError(f"{path}{key}: {q.dtype} is no quantized form")
            q = q.t() if q.dim() == 2 else q
        module.set_quantized(q.to(dev), scale, form)
        loaded.update(id(p) for p in module.parameters(recurse=False))
        tree = {k: v for k, v in tree.items() if k not in (key, "kernel_scale")}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            child = _child(module, key)
            if isinstance(child, nn.ModuleList):
                for i, blk in enumerate(child):
                    _load(blk, _index(val, i), loaded, f"{path}{key}/{i}/")
            else:
                _load(child, val, loaded, f"{path}{key}/")
            continue
        arr = _tensor(val)
        if key == "kernel":
            param = module.weight
            # [in, out] → [out, in]; HWIO → OIHW; [kt, kh, kw, cin, cout] → OIDHW
            arr = arr.permute({2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[arr.dim()])
        else:
            param = getattr(module, key, None)
            if not isinstance(param, nn.Parameter):
                raise KeyError(f"{path}{key}: {type(module).__name__} has no parameter {key!r}")
        if param.shape != arr.shape:
            raise ValueError(f"{path}{key}: tree {tuple(arr.shape)} vs module "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            # to the device in the leaf's own memory order, then the copy
            # there lays it out and casts it
            param.copy_(arr.to(param.device))
        loaded.add(id(param))


def _index(tree: Mapping[str, Any], i: int) -> dict:
    return {k: (_index(v, i) if isinstance(v, Mapping)
                else v[i] if torch.is_tensor(v) else np.asarray(v)[i])
            for k, v in tree.items()}


def load_params(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX parameter tree into `module` (any dtype/device the module
    has); raises if a leaf has no parameter, a shape differs, or a parameter
    of the module is left unset."""
    loaded: set = set()
    _load(module, tree, loaded, "")
    missing = [n for n, p in module.named_parameters() if id(p) not in loaded]
    if missing:
        raise KeyError(f"parameters the tree did not set: {missing[:8]}")
    return module


def load_vae_params(vae: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """The JAX VAE tree {"encoder", "decoder"} into the port's VAE (FLUX's
    or Qwen's): each half the module has."""
    return load_params(vae, {k: v for k, v in tree.items() if hasattr(vae, k)})


def load_text_params(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """A JAX CLIP or T5 parameter tree (`clip_init` / `t5_init`, or either
    package's converters), its "layers" a list of per-layer dicts, into
    the port's `text_encoders.CLIPText` / `T5Encoder`."""
    tree = dict(tree)
    if isinstance(tree.get("layers"), (list, tuple)):
        tree["layers"] = _stack_list(tree["layers"])
    return load_params(module, tree)


def _stack_list(trees: list) -> dict:
    """Per-layer dicts → one dict of stacked [L, ...] leaves."""
    out = {}
    for k, v in trees[0].items():
        vals = [t[k] for t in trees]
        if isinstance(v, Mapping):
            out[k] = _stack_list(vals)
        elif torch.is_tensor(v):
            out[k] = torch.stack(vals)
        else:
            out[k] = np.stack([np.asarray(x) for x in vals])
    return out


def lora_from_tree(model: nn.Module, tree: Mapping[str, Any], device=None,
                   dtype=torch.float32) -> LoraTree:
    """JAX LoRA tree (nested, stacked [L, ...] under "dual"/"single") → the
    port's flat {path: {"a", "b", "scaling"}} dict, keyed by the model's
    module paths ("dual/0/attn/to_q"); scaling as a 0-dim f32 tensor."""
    out: LoraTree = {}

    def leaf(node):
        scaling = np.asarray(node.get("scaling", 1.0), np.float32)
        return {"a": torch.from_numpy(_np32(node["a"])).to(device=device, dtype=dtype),
                "b": torch.from_numpy(_np32(node["b"])).to(device=device, dtype=dtype),
                "scaling": torch.tensor(float(scaling), dtype=torch.float32, device=device)}

    def rec(module, node, path):
        if "a" in node and "b" in node and not isinstance(node["a"], Mapping):
            out[path.rstrip("/")] = leaf(node)
            return
        for key, val in node.items():
            name = _RENAME.get(key, key)
            child = _child(module, key)
            if isinstance(child, nn.ModuleList):
                for i, blk in enumerate(child):
                    rec(blk, _index(val, i), f"{path}{name}/{i}/")
            else:
                rec(child, val, f"{path}{name}/")

    rec(model, tree, "")
    return out


def lora_to_numpy(lora: LoraTree, grads: bool = False) -> dict:
    """The port's LoRA tree → {path: {"a", "b", "scaling"}} of f32 numpy
    arrays (their `.grad`s with grads=True), keyed as the port keys it; the
    inverse direction of `lora_from_tree`, for comparing with a JAX tree."""
    def arr(t):
        t = t.grad if grads else t
        return t.detach().to("cpu", torch.float32).numpy()

    return {path: {k: arr(leaf[k]) for k in ("a", "b", "scaling")}
            for path, leaf in lora.items()}
