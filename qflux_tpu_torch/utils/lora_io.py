"""LoRA safetensors import / export, diffusers and PEFT key formats.

The port's copy of qflux_tpu/utils/lora_io.py, over the port's LoRA tree:
the flat {path: {"a" [in, r], "b" [r, out], "scaling"}} dict keyed by the
model's module paths ("dual/0/attn/to_q", "blocks/3/img_mlp/lin_in"), as
`ops/layers.py:build_lora_tree` builds it and `models/bridge.py:
lora_to_numpy` returns it.  Files are written with the port's safetensors
writer (`utils/safetensors.py`) and carry the JAX package's metadata, so
the port's file for a LoRA is byte for byte the JAX package's file for the
same LoRA, and either package reads the other's.

Formats:
  diffusers: transformer.<module>.lora_A.weight [r, in], .lora_B.weight [out, r]
  PEFT:      base_model.model.<module>.lora_A.weight …
`.alpha` keys (alpha = scaling · rank) are written alongside, so loaders
recover the scaling.

The module-name maps (`flux_module_name` / `flux_tree_path` here, Qwen's in
`trainer/qwen_edit.py`) speak the JAX tree's paths: a path tuple without
the layer index ("dual", "attn", "to_q") and the layer, None for a
top-level module.  `jax_location` / `port_path` convert between those and
the port's flat paths (the port's MLP modules `lin_in` / `lin_out` are the
JAX tree's "in" / "out").
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from qflux_tpu_torch.ops.rope import half_to_interleaved_perm, interleaved_to_half_perm
from qflux_tpu_torch.utils.safetensors import load_file, save_file

# q/k projection outputs live in the rotate-half rope layout inside the
# param trees (ops/rope.py); diffusers/PEFT checkpoints use the interleaved
# layout, so LoRA B matrices for these modules are permuted on import/export.
QK_PROJ_NAMES = {"to_q", "to_k", "add_q", "add_k"}
LORA_FILE_BASE_NAME = "pytorch_lora_weights.safetensors"
FILE_METADATA = {"format": "qflux_tpu.diffusers"}


def _expand_perm(out_dim: int, perm: np.ndarray) -> np.ndarray:
    head_dim = len(perm)
    return (np.arange(out_dim).reshape(-1, head_dim)[:, perm]).reshape(-1)


# ---------------------------------------------------------------------------
# FLUX module-path mapping (JAX tree path ↔ diffusers module name)

_FLUX_DUAL = {
    ("attn", "to_q"): "attn.to_q",
    ("attn", "to_k"): "attn.to_k",
    ("attn", "to_v"): "attn.to_v",
    ("attn", "to_out"): "attn.to_out.0",
    ("attn", "add_q"): "attn.add_q_proj",
    ("attn", "add_k"): "attn.add_k_proj",
    ("attn", "add_v"): "attn.add_v_proj",
    ("attn", "add_out"): "attn.to_add_out",
    ("img_mlp", "in"): "ff.net.0.proj",
    ("img_mlp", "out"): "ff.net.2",
    ("txt_mlp", "in"): "ff_context.net.0.proj",
    ("txt_mlp", "out"): "ff_context.net.2",
    ("img_mod", "proj"): "norm1.linear",
    ("txt_mod", "proj"): "norm1_context.linear",
}
_FLUX_SINGLE = {
    ("attn", "to_q"): "attn.to_q",
    ("attn", "to_k"): "attn.to_k",
    ("attn", "to_v"): "attn.to_v",
    ("proj_mlp",): "proj_mlp",
    ("proj_out",): "proj_out",
    ("mod", "proj"): "norm.linear",
}


def flux_module_name(path: tuple[str, ...], layer: Optional[int]) -> Optional[str]:
    if path[0] == "dual":
        sub = _FLUX_DUAL.get(tuple(path[1:]))
        return None if sub is None else f"transformer_blocks.{layer}.{sub}"
    if path[0] == "single":
        sub = _FLUX_SINGLE.get(tuple(path[1:]))
        return None if sub is None else f"single_transformer_blocks.{layer}.{sub}"
    return ".".join(path)  # top-level modules keep their names


def flux_tree_path(module: str):
    parts = module.split(".")
    if parts[0] == "transformer_blocks":
        layer = int(parts[1])
        rest = ".".join(parts[2:])
        for k, v in _FLUX_DUAL.items():
            if v == rest:
                return ("dual",) + k, layer
        return None
    if parts[0] == "single_transformer_blocks":
        layer = int(parts[1])
        rest = ".".join(parts[2:])
        for k, v in _FLUX_SINGLE.items():
            if v == rest:
                return ("single",) + k, layer
        return None
    return tuple(parts), None


# ---------------------------------------------------------------------------
# the port's flat paths ↔ the JAX tree's (path, layer)

_TO_JAX = {"lin_in": "in", "lin_out": "out"}
_TO_PORT = {v: k for k, v in _TO_JAX.items()}


def jax_location(path: str) -> tuple[tuple[str, ...], Optional[int]]:
    """"dual/0/img_mlp/lin_in" → (("dual", "img_mlp", "in"), 0);
    "x_embedder" → (("x_embedder",), None)."""
    parts = [_TO_JAX.get(p, p) for p in path.split("/")]
    if len(parts) > 1 and parts[1].isdigit():
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def port_path(path: tuple[str, ...], layer: Optional[int]) -> str:
    parts = [_TO_PORT.get(p, p) for p in path]
    if layer is not None:
        parts.insert(1, str(layer))
    return "/".join(parts)


# ---------------------------------------------------------------------------
# classification & helpers

def classify_lora_weight(sd: Mapping) -> str:
    """'peft' vs 'diffusers' key format."""
    for k in sd:
        if k.startswith("base_model.model."):
            return "peft"
        if k.startswith("transformer.") or k.startswith("unet."):
            return "diffusers"
    raise ValueError("unrecognized LoRA state-dict format")


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# export

def export_lora(lora: Mapping, module_name_fn: Callable = flux_module_name,
                prefix: str = "transformer", head_dim: int = 128) -> dict[str, np.ndarray]:
    """The port's LoRA tree (tensors or arrays) → diffusers-format flat
    dict (numpy, float32).  q/k-projection B matrices are un-permuted back
    to the torch interleaved rope layout."""
    flat: dict[str, np.ndarray] = {}
    for path, node in lora.items():
        jpath, layer = jax_location(path)
        mod = module_name_fn(jpath, layer)
        if mod is None:
            raise ValueError(f"no module mapping for lora path {path}")
        a, b = _f32(node["a"]), _f32(node["b"])      # [in, r], [r, out]
        if jpath[-1] in QK_PROJ_NAMES and b.shape[1] % head_dim == 0:
            b = b[:, _expand_perm(b.shape[1], half_to_interleaved_perm(head_dim))]
        rank = a.shape[1]
        sc = float(_f32(node.get("scaling", 1.0)))
        flat[f"{prefix}.{mod}.lora_A.weight"] = np.ascontiguousarray(a.T)  # [r, in]
        flat[f"{prefix}.{mod}.lora_B.weight"] = np.ascontiguousarray(b.T)  # [out, r]
        flat[f"{prefix}.{mod}.alpha"] = np.asarray(sc * rank, np.float32)
    return flat


def save_lora_safetensors(lora: Mapping, path, module_name_fn: Callable = flux_module_name,
                          prefix: str = "transformer", head_dim: int = 128) -> Path:
    """Write the LoRA file; a directory `path` gets LORA_FILE_BASE_NAME in
    it.  Returns the file's path."""
    path = Path(path)
    if path.is_dir():
        path = path / LORA_FILE_BASE_NAME
    path.parent.mkdir(parents=True, exist_ok=True)
    save_file(export_lora(lora, module_name_fn, prefix, head_dim), path,
              metadata=FILE_METADATA)
    return path


# ---------------------------------------------------------------------------
# import

def import_lora(sd: Mapping, tree_path_fn: Callable = flux_tree_path,
                head_dim: int = 128) -> dict:
    """diffusers/PEFT flat dict (tensors or arrays) → the port's LoRA tree
    of float32 numpy arrays {path: {"a", "b", "scaling"}}.  A module's
    layers must run 0..L-1 without a gap, as the JAX package stacks them."""
    fmt = classify_lora_weight(sd)
    strip = "base_model.model." if fmt == "peft" else None

    modules: dict[str, dict] = {}
    for key, arr in sd.items():
        k = key
        if strip and k.startswith(strip):
            k = k[len(strip):]
        for pref in ("transformer.", "unet."):
            if k.startswith(pref):
                k = k[len(pref):]
                break
        if k.endswith(".lora_A.weight") or k.endswith(".lora_A.default.weight"):
            modules.setdefault(k.split(".lora_A")[0], {})["a"] = _f32(arr).T
        elif k.endswith(".lora_B.weight") or k.endswith(".lora_B.default.weight"):
            modules.setdefault(k.split(".lora_B")[0], {})["b"] = _f32(arr).T
        elif k.endswith(".alpha"):
            modules.setdefault(k[: -len(".alpha")], {})["alpha"] = float(_f32(arr))

    grouped: dict[tuple, dict] = {}
    for mod, node in modules.items():
        loc = tree_path_fn(mod)
        if loc is None:
            raise ValueError(f"cannot map LoRA module {mod!r} into the param tree")
        jpath, layer = loc
        rank = node["a"].shape[1]
        alpha = node.get("alpha", float(rank))
        b = node["b"]
        if jpath[-1] in QK_PROJ_NAMES and b.shape[1] % head_dim == 0:
            b = b[:, _expand_perm(b.shape[1], interleaved_to_half_perm(head_dim))]
        grouped.setdefault(jpath, {})[layer] = {
            "a": np.ascontiguousarray(node["a"]), "b": np.ascontiguousarray(b),
            "scaling": np.asarray(alpha / rank, np.float32)}

    tree: dict = {}
    for jpath, by_layer in grouped.items():
        layers = sorted(by_layer, key=lambda i: -1 if i is None else i)
        if None not in by_layer and layers != list(range(len(layers))):
            raise ValueError(f"non-contiguous LoRA layers for {jpath}: {layers}")
        for layer in layers:
            tree[port_path(jpath, layer)] = by_layer[layer]
    return tree


def load_lora_safetensors(path, tree_path_fn: Callable = flux_tree_path,
                          head_dim: int = 128) -> dict:
    """Read a LoRA file (a directory: its LORA_FILE_BASE_NAME) into the
    port's LoRA tree of float32 numpy arrays."""
    path = Path(path)
    if path.is_dir():
        path = path / LORA_FILE_BASE_NAME
    return import_lora(load_file(path), tree_path_fn, head_dim=head_dim)
