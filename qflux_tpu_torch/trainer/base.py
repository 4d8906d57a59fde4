"""The port's Trainer: load the model, build or load a LoRA, and predict from
cached embeddings.

Counterpart of the predict slice of qflux_tpu/trainer/base.py
(`load_model`, `build_lora`, `predict_from_embeddings`).  Fit, cache and
checkpointing come with later slices.

The Trainer reads its settings by attribute.  The JAX package's pydantic
`Config` works where pydantic is installed (`Trainer.from_yaml`, which
imports `qflux_tpu.config` only when called); `predict_config()` builds the
same fields as plain namespaces, which is what runs on a machine without
pydantic or YAML.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Any, Optional

import numpy as np
import torch

from qflux_tpu_torch.ops.layers import build_lora_tree, merge_lora, raise_quantized
from qflux_tpu_torch.scheduler.flow_match import FlowMatchScheduler
from qflux_tpu_torch.trainer.flux_kontext import FluxKontextAdapter
from qflux_tpu_torch.trainer.sampling import SamplingConfig, make_sampler

ADAPTERS = {"FluxKontextLoraTrainer": FluxKontextAdapter}


def predict_config(variant: str = "test", num_inference_steps: int = 20):
    """The settings the predict slice reads, as plain namespaces.  Values are
    the JAX Config's defaults (PredictSection, LoggingSection.sampling_seed,
    TrainSection.seed) and configs/example_fluxkontext_bf16.yaml's LoRA."""
    ns = SimpleNamespace
    return ns(
        trainer=ns(value="FluxKontextLoraTrainer"),
        model=ns(variant=variant, quantize=None,
                 lora=ns(r=16, lora_alpha=16.0, init_lora_weights="gaussian",
                         target_modules=["to_q", "to_k", "to_v", "to_out"],
                         pretrained_weight=None)),
        train=ns(seed=1234, weight_dtype="bfloat16"),
        logging=ns(sampling_seed=42),
        predict=ns(num_inference_steps=num_inference_steps, guidance=2.5,
                   true_cfg_scale=1.0, max_sequence_length=512))


class Trainer:
    def __init__(self, config, device):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the f32 VAE (and any f32 matmul) must not run in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        kind = config.trainer.value
        if kind not in ADAPTERS:
            raise NotImplementedError(
                f"trainer {kind!r} is not ported yet (ROADMAP.md: the port's slices; "
                f"ported: {sorted(ADAPTERS)})")
        self.adapter_cls = ADAPTERS[kind]
        self.scheduler = FlowMatchScheduler()
        self.adapter: Optional[FluxKontextAdapter] = None
        self.bundle = None
        self.lora = None
        # what the last predict_from_embeddings call measured: denoise_s,
        # steps, decode_s (host clock around synchronised work) and whether
        # the final latents were all finite
        self.last_predict: dict = {}

    @classmethod
    def from_yaml(cls, path: str, device) -> "Trainer":
        from qflux_tpu.config import load_config_from_yaml  # pydantic + yaml, lazily

        return cls(load_config_from_yaml(path), device=device)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.train.weight_dtype == "bfloat16" else torch.float32

    def load_model(self):
        qz = getattr(self.config.model, "quantize", None)
        if qz and qz.enabled:
            raise_quantized(qz.dtype)
        self.adapter, self.bundle = self.adapter_cls.load(self.config, self.device, self.dtype)

    def build_lora(self):
        """A fresh LoRA over the configured targets (a gaussian, b zeros),
        from a generator seeded train.seed + 1, as the JAX Trainer."""
        lcfg = self.config.model.lora
        if lcfg.pretrained_weight:
            raise NotImplementedError(
                "loading a LoRA safetensors file is not ported yet (ROADMAP.md: "
                "utils/lora_io.py comes with the train-step slice)")
        targets = lcfg.target_modules or list(self.adapter.default_lora_targets)
        targets = [t if "/" in t else rf"attn/{t}" for t in targets]
        init = "gaussian" if lcfg.init_lora_weights in (True, "gaussian") else "kaiming"
        gen = torch.Generator(self.device).manual_seed(self.config.train.seed + 1)
        return build_lora_tree(gen, self.bundle.dit_params, targets, rank=lcfg.r,
                               alpha=lcfg.lora_alpha, init=init)

    def predict_from_embeddings(self, emb: dict, height: int, width: int,
                                num_inference_steps: Optional[int] = None,
                                lora: Optional[Any] = None,
                                seed: Optional[int] = None,
                                guidance: Optional[float] = None,
                                true_cfg_scale: Optional[float] = None) -> np.ndarray:
        """Cached embeddings (numpy or tensors) → uint8 images [B, H, W, 3].

        In order: prepare the cached embeddings, plan the sigmas, merge the
        LoRA (`lora`, else the trainer's own), run the Euler loop over
        `predict_velocity`, decode with the VAE.  `guidance` and
        `true_cfg_scale` default to the predict section.  The initial
        latents come from a generator seeded `seed` (default
        logging.sampling_seed).  Latents and embeddings run in the weight
        dtype, as in the JAX Trainer."""
        pcfg = self.config.predict
        steps = num_inference_steps or pcfg.num_inference_steps
        guidance = pcfg.guidance if guidance is None else guidance
        true_cfg_scale = pcfg.true_cfg_scale if true_cfg_scale is None else true_cfg_scale
        emb = self.adapter.prepare_cached_embeddings(emb)
        gh, gw = self.adapter.latent_grid(height, width)
        s_img = gh * gw
        plan = self.scheduler.sampling_plan(steps, image_seq_len=s_img)
        params = merge_lora(self.bundle.dit_params, lora if lora is not None else self.lora)
        sampler = make_sampler(self.adapter.predict_velocity, SamplingConfig(
            num_inference_steps=steps, true_cfg_scale=true_cfg_scale))
        b = int(np.shape(emb["prompt_embeds"])[0])
        dtype = self.dtype
        gen = torch.Generator(self.device).manual_seed(
            self.config.logging.sampling_seed if seed is None else seed)
        lat0 = torch.randn((b, s_img, self.bundle.dit_cfg.in_channels), generator=gen,
                           device=self.device, dtype=dtype)
        batch = {}
        for k, v in emb.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            if t.dtype in (torch.float32, torch.float16, torch.float64):
                t = t.to(dtype)
            batch[k] = t.to(self.device)
        if "guidance" not in batch:
            batch["guidance"] = torch.full((b,), guidance, dtype=dtype, device=self.device)
        t0 = time.perf_counter()
        latents = sampler(params, batch, lat0, plan.sigmas)
        finite = bool(torch.isfinite(latents).all())  # waits for the device
        t1 = time.perf_counter()
        images = self.adapter.decode_latents(self.bundle, latents, height, width)
        self.last_predict = {"steps": plan.num_steps, "denoise_s": t1 - t0,
                             "decode_s": time.perf_counter() - t1, "latents_finite": finite}
        return images
