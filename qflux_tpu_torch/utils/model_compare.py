"""Parity tooling: a per-parameter diff of two parameter trees or state
dicts, and the comparison of two LoRA weight files.

Counterpart of qflux_tpu/utils/model_compare.py, with the same statuses,
paths and report: a tree is nested dicts and lists of numpy arrays or torch
tensors; a LoRA file (diffusers, PEFT or the packages' own format) is read
with the port's safetensors reader and `utils/lora_io.py:import_lora`, then
stacked as the JAX package's tree ("dual/attn/to_q/a" [L, in, r]) so that
the report names what JAX's names."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch


@dataclasses.dataclass
class ParamDiff:
    path: str
    status: str            # match | value_mismatch | shape_mismatch | only_in_a | only_in_b
    shape_a: tuple | None = None
    shape_b: tuple | None = None
    max_abs: float | None = None
    rel_err: float | None = None


def _array(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = _array(tree)
    return out


def rel_err(a: np.ndarray, b: np.ndarray) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(a) + np.linalg.norm(b) + 1e-12))


def compare_params(tree_a: Any, tree_b: Any, rtol: float = 1e-5) -> list[ParamDiff]:
    """Elementwise comparison of two parameter trees (or flat state dicts)."""
    fa, fb = _flatten(tree_a), _flatten(tree_b)
    diffs: list[ParamDiff] = []
    for path in sorted(set(fa) | set(fb)):
        if path not in fa:
            diffs.append(ParamDiff(path, "only_in_b", shape_b=fb[path].shape))
        elif path not in fb:
            diffs.append(ParamDiff(path, "only_in_a", shape_a=fa[path].shape))
        elif fa[path].shape != fb[path].shape:
            diffs.append(ParamDiff(path, "shape_mismatch",
                                   shape_a=fa[path].shape, shape_b=fb[path].shape))
        else:
            e = rel_err(fa[path], fb[path])
            mx = float(np.abs(fa[path].astype(np.float64)
                              - fb[path].astype(np.float64)).max()) if fa[path].size else 0.0
            status = "match" if e <= rtol else "value_mismatch"
            diffs.append(ParamDiff(path, status, fa[path].shape, fb[path].shape, mx, e))
    return diffs


def summarize(diffs: list[ParamDiff]) -> dict[str, int]:
    out: dict[str, int] = {}
    for d in diffs:
        out[d.status] = out.get(d.status, 0) + 1
    return out


def _jax_lora_tree(lora: Mapping) -> dict:
    """The port's flat LoRA tree {path: {"a", "b", "scaling"}} → the JAX
    package's nested one, a block stack's layers stacked [L, ...]."""
    from qflux_tpu_torch.utils.lora_io import jax_location

    grouped: dict[tuple, dict] = {}
    for path, leaf in lora.items():
        jpath, layer = jax_location(path)
        grouped.setdefault(jpath, {})[layer] = leaf
    tree: dict = {}
    for jpath, by_layer in grouped.items():
        node = tree
        for part in jpath[:-1]:
            node = node.setdefault(part, {})
        if None in by_layer:
            node[jpath[-1]] = {k: _array(by_layer[None][k]) for k in ("a", "b", "scaling")}
        else:
            node[jpath[-1]] = {k: np.stack([_array(by_layer[i][k]) for i in sorted(by_layer)])
                               for k in ("a", "b", "scaling")}
    return tree


def compare_lora_files(path_a: str, path_b: str, rtol: float = 1e-5) -> list[ParamDiff]:
    """Diff two LoRA safetensors files (any of diffusers / PEFT / our
    formats)."""
    from qflux_tpu_torch.utils.lora_io import import_lora
    from qflux_tpu_torch.utils.safetensors import load_file

    a = _jax_lora_tree(import_lora(load_file(str(path_a))))
    b = _jax_lora_tree(import_lora(load_file(str(path_b))))
    return compare_params(a, b, rtol)


def print_report(diffs: list[ParamDiff], max_rows: int = 40) -> str:
    lines = [f"{'path':60s} {'status':16s} {'rel_err':>10s}"]
    shown = 0
    for d in diffs:
        if d.status == "match":
            continue
        lines.append(f"{d.path:60s} {d.status:16s} "
                     f"{d.rel_err if d.rel_err is not None else float('nan'):>10.3e}")
        shown += 1
        if shown >= max_rows:
            lines.append(f"… ({len(diffs)} total entries)")
            break
    lines.append(f"summary: {summarize(diffs)}")
    report = "\n".join(lines)
    print(report)
    return report
