"""Model-config inspection: dump and compare the configurations of the
model families, as qflux_tpu/utils/get_model_config.py does over the JAX
package's dataclasses, here over the port's (the same fields and
defaults)."""

from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Any

KNOWN_CONFIGS = {
    "flux-kontext": "qflux_tpu_torch.models.flux.transformer:FluxConfig",
    "flux-vae": "qflux_tpu_torch.models.flux.vae:VAEConfig",
    "clip-text": "qflux_tpu_torch.models.flux.text_encoders:CLIPTextConfig",
    "t5": "qflux_tpu_torch.models.flux.text_encoders:T5Config",
    "qwen-image": "qflux_tpu_torch.models.qwen.transformer:QwenImageConfig",
    "qwen-vae": "qflux_tpu_torch.models.qwen.vae:QwenVAEConfig",
    "qwen-vl-vision": "qflux_tpu_torch.models.qwen.vl_encoder:VLVisionConfig",
    "qwen-vl-text": "qflux_tpu_torch.models.qwen.vl_encoder:VLTextConfig",
    "qwen3": "qflux_tpu_torch.models.flux2.text_encoder:Qwen3Config",
}


def get_model_config(name: str) -> dict[str, Any]:
    """The fields of the named config at its defaults."""
    if name not in KNOWN_CONFIGS:
        raise KeyError(f"unknown model config {name!r}; known: {sorted(KNOWN_CONFIGS)}")
    module, attr = KNOWN_CONFIGS[name].split(":")
    return dataclasses.asdict(getattr(importlib.import_module(module), attr)())


def dump_model_config(name: str) -> str:
    return json.dumps(get_model_config(name), indent=2, default=str)


def compare_model_configs(name_a: str, name_b: str) -> dict[str, tuple]:
    """Field-level diff of two model configs: {field: (a's, b's)} where they
    differ, "<absent>" for a field only one has."""
    a, b = get_model_config(name_a), get_model_config(name_b)
    out: dict[str, tuple] = {}
    for k in sorted(set(a) | set(b)):
        va, vb = a.get(k, "<absent>"), b.get(k, "<absent>")
        if va != vb:
            out[k] = (va, vb)
    return out
