"""Parameter, dtype, memory and LoRA statistics, as one table logged at the
start of a fit.

Counterpart of qflux_tpu/utils/model_summary.py (`model_summary_rows`),
over the port's modules: a row per top-level child of the DiT (the JAX
tree's top-level keys, which the port's children share), a total with the
count of attention projections, the LoRA and the trainable share.  A
quantized layer's packed int4 `q4` counts two parameters a byte, as JAX
counts `kernel_q4*`; a per-channel `q` counts one a byte by its type (int8,
float8_e4m3fn, float8_e5m2), as JAX counts `kernel_q` / `kernel_q_dyn`, and
every `scale` as f32; the requant factors the port caches beside an
int4-requant q4 (`rq_f`, `rq_s_vec`, derived from `scale`) are not
parameters of the JAX tree and are not counted.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch import nn

from qflux_tpu_torch.ops.layers import Dense

_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1, "int32": 4,
          "float8_e4m3fn": 1, "float8_e5m2": 1, "int4_packed": 0.5}
_DERIVED = ("rq_f", "rq_s_vec")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _tensors(module: nn.Module):
    """(name, tensor) of every parameter and buffer, the cached requant
    factors excepted."""
    for name, t in (*module.named_parameters(), *module.named_buffers()):
        if t is not None and name.rsplit(".", 1)[-1] not in _DERIVED:
            yield name, t


def _stats(named_tensors):
    """(n_params, n_bytes, {dtype: count}); a packed int4 `q4` counts its
    logical parameters (2 a byte)."""
    n = b = 0
    dtypes: dict[str, int] = defaultdict(int)
    for name, t in named_tensors:
        size = t.numel()
        if name.rsplit(".", 1)[-1] == "q4":
            n += 2 * size
            b += size
            dtypes["int4_packed"] += 2 * size
        else:
            dt = _dtype_name(t)
            n += size
            b += size * _BYTES.get(dt, 4)
            dtypes[dt] += size
    return n, int(b), dict(dtypes)


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if b < 1024:
            return f"{b:.1f} {unit}"
        b /= 1024
    return f"{b:.2f} TB"


def _fmt_dtypes(dtypes: dict) -> str:
    return ", ".join(f"{k}:{v:,}" for k, v in sorted(dtypes.items()))


def attention_projections(model: nn.Module) -> int:
    """Dense layers that sit directly in an `attn` module, one per block."""
    return sum(1 for name, mod in model.named_modules()
               if isinstance(mod, Dense) and name.split(".")[-2:-1] == ["attn"])


def model_summary_rows(model: nn.Module, lora=None) -> list[dict]:
    rows = []
    total_n = total_b = 0
    for name, child in sorted(model.named_children()):
        n, b, dtypes = _stats(_tensors(child))
        total_n += n
        total_b += b
        rows.append({"component": f"base/{name}", "params": f"{n:,}", "memory": _fmt_bytes(b),
                     "dtypes": _fmt_dtypes(dtypes), "trainable": "no"})
    rows.append({"component": "base TOTAL", "params": f"{total_n:,}",
                 "memory": _fmt_bytes(total_b),
                 "dtypes": f"attention projections: {attention_projections(model)}",
                 "trainable": "no"})
    if lora is not None:
        ln, lb, ldt = _stats((f"{path}.{k}", t) for path, leaf in lora.items()
                             for k, t in leaf.items())
        ranks = sorted({int(leaf["a"].shape[-1]) for leaf in lora.values()})
        rows.append({"component": "lora", "params": f"{ln:,}", "memory": _fmt_bytes(lb),
                     "dtypes": _fmt_dtypes(ldt) + (f" | ranks: {ranks}" if ranks else ""),
                     "trainable": "yes"})
        rows.append({"component": "trainable %",
                     "params": f"{100 * ln / max(total_n, 1):.4f}%",
                     "memory": "", "dtypes": "", "trainable": ""})
    return rows
