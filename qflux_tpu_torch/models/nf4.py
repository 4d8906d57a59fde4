"""bitsandbytes 4-bit (NF4 / FP4) checkpoint import, numpy only.

The port's copy of qflux_tpu/models/nf4.py (`is_bnb_4bit`,
`import_bnb_4bit` and their helpers, unchanged), plus `bnb_4bit_groups`,
which lets the safetensors reader (`utils/safetensors.py`) dequantize one
weight at a time: the JAX package's `load_safetensors` runs
`import_bnb_4bit` on every file it reads, so a pretrained 4-bit checkpoint
reaches the converters as if it were full precision.

bnb serialization (one Linear4bit weight `X.weight`):
  X.weight                              uint8 [ceil(numel/2), 1] — two 4-bit
                                        codes per byte, first in the HIGH
                                        nibble, flattened row-major
  X.weight.quant_map                    float [16] codebook (nf4 or fp4)
  X.weight.absmax                       float [numel/blocksize]  (plain) or
                                        uint8 codes          (double-quant)
  X.weight.nested_absmax                float — absmax of the absmax blocks
  X.weight.nested_quant_map             float [256] int8 codebook for absmax
  X.weight.quant_state.bitsandbytes__nf4 (or __fp4)
                                        uint8 json: {"blocksize", "shape",
                                        "dtype", "nested_blocksize",
                                        "nested_offset", ...}
"""

from __future__ import annotations

import json
import logging
from typing import Iterable, Mapping

import numpy as np

_QS_SUFFIXES = (".quant_state.bitsandbytes__nf4", ".quant_state.bitsandbytes__fp4")
_AUX_SUFFIXES = (".absmax", ".quant_map", ".nested_absmax", ".nested_quant_map",
                 ".quant_state.bitsandbytes__nf4", ".quant_state.bitsandbytes__fp4")

_NP_DTYPES = {"float32": np.float32, "float16": np.float16,
              "bfloat16": np.float32,  # converters re-cast; np has no bf16
              "torch.float32": np.float32, "torch.float16": np.float16,
              "torch.bfloat16": np.float32}


def is_bnb_4bit(state: Iterable[str]) -> bool:
    return any(k.endswith(_QS_SUFFIXES) for k in state)


def bnb_4bit_groups(keys: Iterable[str]) -> dict[str, list[str]]:
    """{4-bit weight key: [that key and its auxiliary keys present]} of a
    state dict's keys; empty when no weight is 4-bit."""
    keys = set(keys)
    groups = {}
    for k in keys:
        for suf in _QS_SUFFIXES:
            if k.endswith(suf):
                wk = k[: -len(suf)]
                groups[wk] = [wk] + [wk + s for s in _AUX_SUFFIXES if wk + s in keys]
    return groups


def _unpack_4bit(packed: np.ndarray, n: int) -> np.ndarray:
    b = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
    out = np.empty(b.size * 2, np.uint8)
    out[0::2] = b >> 4
    out[1::2] = b & 0xF
    return out[:n]


def _dequant_nested_absmax(codes: np.ndarray, nested_absmax: np.ndarray,
                           nested_quant_map: np.ndarray, offset: float,
                           nested_blocksize: int) -> np.ndarray:
    """Double quantization: absmax itself is int8 codes into a 256-entry
    codebook, scaled blockwise and shifted by a global offset."""
    vals = np.asarray(nested_quant_map, np.float32)[
        np.ascontiguousarray(codes, dtype=np.uint8).reshape(-1)]
    scale = np.repeat(np.asarray(nested_absmax, np.float32).reshape(-1),
                      nested_blocksize)[: vals.size]
    return vals * scale + np.float32(offset)


def dequantize_4bit(codes: np.ndarray, absmax: np.ndarray, quant_map: np.ndarray,
                    blocksize: int, shape, dtype=np.float32) -> np.ndarray:
    """codes → codebook lookup → per-block absmax scale → [shape]."""
    n = int(np.prod(shape))
    vals = np.asarray(quant_map, np.float32)[_unpack_4bit(codes, n)]
    scale = np.repeat(np.asarray(absmax, np.float32).reshape(-1), blocksize)[:n]
    return (vals * scale).reshape(shape).astype(dtype)


def _parse_quant_state(raw: np.ndarray) -> dict:
    return json.loads(bytes(np.ascontiguousarray(raw, dtype=np.uint8)).decode())


def import_bnb_4bit(state: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Replace every bnb-4bit serialized weight in a flat state dict with its
    dequantized tensor; aux tensors are consumed.  Non-quantized entries pass
    through untouched.  Returns a new dict."""
    out: dict[str, np.ndarray] = {}
    quantized: dict[str, str] = {}  # weight key -> quant_state key
    for k in state:
        for suf in _QS_SUFFIXES:
            if k.endswith(suf):
                quantized[k[: -len(suf)]] = k
    if not quantized:
        return dict(state)

    consumed = set()
    for wk, qsk in quantized.items():
        qs = _parse_quant_state(state[qsk])
        blocksize = int(qs.get("blocksize", 64))
        shape = [int(s) for s in qs["shape"]]
        dtype = _NP_DTYPES.get(str(qs.get("dtype", "float32")), np.float32)
        quant_map = state[wk + ".quant_map"]
        absmax = state[wk + ".absmax"]
        if wk + ".nested_absmax" in state:
            absmax = _dequant_nested_absmax(
                absmax, state[wk + ".nested_absmax"],
                state[wk + ".nested_quant_map"],
                float(qs.get("nested_offset", 0.0)),
                int(qs.get("nested_blocksize", 256)))
        out[wk] = dequantize_4bit(state[wk], absmax, quant_map, blocksize,
                                  shape, dtype)
        consumed.add(wk)
        consumed.update(wk + s for s in _AUX_SUFFIXES if wk + s in state)

    for k, v in state.items():
        if k not in consumed:
            out[k] = v
    logging.info("imported %d bnb-4bit weights (%s)", len(quantized),
                 "nf4" if any(k.endswith("__nf4") for k in state) else "fp4")
    return out
