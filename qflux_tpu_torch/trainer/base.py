"""The port's Trainer: load the model, build a LoRA, train it on cached
embeddings, and predict from cached embeddings.

Counterpart of the predict and train slices of qflux_tpu/trainer/base.py
(`load_model`, `build_lora`, `build_optimizer`, `build_criterion`,
`_build_step_config`, `fit`, `predict_from_embeddings`).  `fit` runs the
train step over an iterable of cached-embedding batches and records loss,
grad_norm and lr per step in `history`; checkpoint files, the LoRA
safetensors export, logging backends, validation, resume and the cache pass
come with later slices (ROADMAP.md, queue 1).

The Trainer reads its settings by attribute, from the namespaces of the
port's own loader (`qflux_tpu_torch/config.py`: `Trainer.from_yaml` reads a
YAML file of the JAX package's format; `predict_config()` and
`train_config()` build the same namespaces in code, which is what runs on a
machine without YAML).

Two model families are ported: FLUX.1-Kontext and Qwen-Image-Edit, each
with predict and the LoRA train step.  `load_model` quantizes the DiT with
`ops/quant.quantize_tree` where `model.quantize.enabled` (int4 and
int4_requant; other dtypes raise there), and `fit` trains over that base
(the fused int4 matmuls' backwards are kernels K5b and K6b on the card).  `quantize.attention` runs
the int8 score GEMM of K1 and K2 wherever JAX on a TPU would (S up to 2560
at head dim 128; bf16 attention through K3 / K4 elsewhere, as there), and the remat
policies not ported raise in the transformer.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from qflux_tpu_torch import losses
from qflux_tpu_torch.config import config_from_dict, load_config_from_yaml
from qflux_tpu_torch.ops.layers import build_lora_tree, mark_trainable, merge_lora
from qflux_tpu_torch.ops.quant import quantize_tree
from qflux_tpu_torch.scheduler.flow_match import FlowMatchScheduler
from qflux_tpu_torch.scheduler.weighting import default_weighting_table
from qflux_tpu_torch.trainer.flux_kontext import FluxKontextAdapter
from qflux_tpu_torch.trainer.qwen_edit import QwenImageEditAdapter
from qflux_tpu_torch.trainer.sampling import SamplingConfig, make_sampler
from qflux_tpu_torch.trainer.train_step import (TrainStepConfig, lora_leaves,
                                                make_lr_schedule, make_train_step)

ADAPTERS = {"FluxKontextLoraTrainer": FluxKontextAdapter,
            "QwenImageEditTrainer": QwenImageEditAdapter}
# loss.class_path → the port's loss (the JAX names, as configs carry them)
CRITERIA = {f"{pkg}.{name}": getattr(losses, name)
            for pkg in ("qflux_tpu.losses", "qflux_tpu.losses.losses")
            for name in ("MseLoss", "MaskEditLoss", "AttentionMaskMseLoss")}
ADAMW_ARGS = ("b1", "b2", "eps", "weight_decay")  # the optax.adamw arguments ported


def predict_config(variant: str = "test", num_inference_steps: int = 20):
    """The FLUX.1-Kontext predict settings as namespaces: the JAX Config's
    defaults (`config.DEFAULTS`) and configs/example_fluxkontext_bf16.yaml's
    LoRA targets."""
    return config_from_dict({
        "model": {"variant": variant,
                  "lora": {"target_modules": ["to_q", "to_k", "to_v", "to_out"]}},
        "predict": {"num_inference_steps": num_inference_steps}})


def train_config(variant: str = "test", max_train_steps: int = 1000):
    """The train settings: `predict_config` with train.max_train_steps set
    (optimizer, lr schedule, loss and the train section at the JAX Config's
    defaults: optax.adamw b1 0.9, b2 0.999, weight_decay 1e-2 at lr 1e-4,
    constant lr, MseLoss)."""
    cfg = predict_config(variant)
    cfg.train.max_train_steps = max_train_steps
    return cfg


class Trainer:
    def __init__(self, config, device="cuda"):
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
        self.adapter = None
        self.bundle = None
        self.lora = None
        # what the last predict_from_embeddings call measured: denoise_s,
        # steps, decode_s (host clock around synchronised work) and whether
        # the final latents were all finite
        self.last_predict: dict = {}
        # one entry per fit step: step, loss, grad_norm, lr, step_s (host
        # clock around the step, which ends by reading the loss)
        self.history: list[dict] = []

    @classmethod
    def from_yaml(cls, path: str, device="cuda") -> "Trainer":
        return cls(load_config_from_yaml(path), device=device)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.train.weight_dtype == "bfloat16" else torch.float32

    def load_model(self):
        """The adapter's model, then (as the JAX Trainer) the DiT quantized
        with `quantize_tree` where model.quantize.enabled.  An adapter may
        already have quantized its blocks while drawing them; quantize_tree
        leaves a quantized layer as it is."""
        self.adapter, self.bundle = self.adapter_cls.load(self.config, self.device, self.dtype)
        qz = self.config.model.quantize
        if qz and qz.enabled:
            self.bundle.dit_params = quantize_tree(self.bundle.dit_params, qz)

    def build_lora(self):
        """A fresh LoRA over the configured targets (a gaussian, b zeros),
        from a generator seeded train.seed + 1, as the JAX Trainer."""
        lcfg = self.config.model.lora
        if lcfg.pretrained_weight:
            raise NotImplementedError(
                "loading a LoRA safetensors file is not ported yet (ROADMAP.md, queue 1: "
                "\"The rest of slice B, part 1: files, real weights and data\")")
        targets = lcfg.target_modules or list(self.adapter.default_lora_targets)
        targets = [t if "/" in t else rf"attn/{t}" for t in targets]
        init = "gaussian" if lcfg.init_lora_weights in (True, "gaussian") else "kaiming"
        gen = torch.Generator(self.device).manual_seed(self.config.train.seed + 1)
        return build_lora_tree(gen, self.bundle.dit_params, targets, rank=lcfg.r,
                               alpha=lcfg.lora_alpha, init=init)

    def build_optimizer(self, params: list):
        """(torch.optim.AdamW over `params`, lr schedule): `optax.adamw` with
        the configured b1 / b2 / eps / weight_decay (optax's defaults where
        absent) and the configured lr schedule.  Any other optimizer or
        argument raises."""
        ocfg = self.config.optimizer
        if ocfg.class_path != "optax.adamw":
            raise NotImplementedError(
                f"optimizer {ocfg.class_path!r} is not ported yet (ROADMAP.md, queue 1: "
                "\"Optimizers and CLI\"; ported: optax.adamw)")
        args = dict(ocfg.init_args or {})
        unknown = sorted(set(args) - set(ADAMW_ARGS))
        if unknown:
            raise NotImplementedError(
                f"optax.adamw arguments {unknown} are not ported yet (ROADMAP.md, queue 1: "
                f"\"Optimizers and CLI\"; ported: {list(ADAMW_ARGS)})")
        schedule = make_lr_schedule(ocfg.learning_rate, self.config.lr_scheduler.scheduler_type,
                                    self.config.lr_scheduler.warmup_steps,
                                    self.config.train.max_train_steps)
        opt = torch.optim.AdamW(params, lr=schedule(0),
                                betas=(args.get("b1", 0.9), args.get("b2", 0.999)),
                                eps=args.get("eps", 1e-8),
                                weight_decay=args.get("weight_decay", 1e-4))
        return opt, schedule

    def build_criterion(self):
        lcfg = self.config.loss
        if lcfg.class_path not in CRITERIA:
            raise NotImplementedError(
                f"loss {lcfg.class_path!r} is not ported (ported: {sorted(CRITERIA)})")
        return CRITERIA[lcfg.class_path](**(lcfg.init_args or {}))

    def _build_step_config(self) -> TrainStepConfig:
        """Config → TrainStepConfig, resolving the weighting scheme and table
        as the JAX Trainer: "weighted" sampling = uniform σ + the empirical
        loss-weight table."""
        t = self.config.train
        sampling = t.timestep_sampling
        scheme, table = t.weighting_scheme, None
        if sampling == "weighted":
            sampling = "uniform"
            if scheme == "none":
                scheme = "weighted"
        if scheme == "weighted":
            if t.weighting_table:
                raise NotImplementedError(
                    "a user weighting_table file is not ported yet (ROADMAP.md, queue 1: "
                    "\"The rest of slice B, part 1: files, real weights and data\"); the "
                    "default table is")
            table, scheme = default_weighting_table(), "table"
        return TrainStepConfig(timestep_sampling=sampling, logit_mean=t.logit_mean,
                               logit_std=t.logit_std, weighting_scheme=scheme,
                               weighting_table=table, max_grad_norm=t.max_grad_norm,
                               grad_accum_steps=t.gradient_accumulation_steps)

    def _device_batch(self, emb: dict) -> dict:
        """Cached embeddings (numpy or tensors) → tensors on the device:
        floats in the weight dtype (edit_mask stays f32), as the JAX
        Trainer's `_device_batch`; ids rebuilt by the adapter."""
        emb = self.adapter.prepare_cached_embeddings(emb)
        out = {}
        for k, v in emb.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            if t.dtype in (torch.float32, torch.float16, torch.float64, torch.bfloat16):
                t = t.to(torch.float32 if k == "edit_mask" else self.dtype)
            out[k] = t.to(self.device)
        return out

    def fit(self, batches):
        """Train a fresh LoRA on `batches` (an iterable of cached-embedding
        dicts with `image_latents`) for at most train.max_train_steps steps.
        Noise and σ come from a generator seeded train.seed.  Returns the
        LoRA tree, trained in place; `history` holds one entry per step."""
        cfg = self.config
        if self.adapter is None:
            self.load_model()
        self.lora = lora = mark_trainable(self.build_lora())
        optimizer, schedule = self.build_optimizer(lora_leaves(lora)[0])
        step = make_train_step(self.adapter.predict_velocity, self.build_criterion(), optimizer,
                               schedule, self._build_step_config())
        gen = torch.Generator(self.device).manual_seed(cfg.train.seed)
        self.history = []
        for batch in batches:
            if len(self.history) >= cfg.train.max_train_steps:
                break
            emb = self._device_batch(batch)
            t0 = time.perf_counter()
            metrics = step(self.bundle.dit_params, lora, emb, gen)
            loss = float(metrics["loss"])  # waits for the device
            self.history.append({"step": len(self.history) + 1, "loss": loss,
                                 "grad_norm": float(metrics["grad_norm"]),
                                 "lr": float(metrics["lr"]),
                                 "step_s": time.perf_counter() - t0})
        return lora

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
        batch = self._device_batch(emb)
        gh, gw = self.adapter.latent_grid(height, width)
        s_img = gh * gw
        plan = self.scheduler.sampling_plan(steps, image_seq_len=s_img)
        params = merge_lora(self.bundle.dit_params, lora if lora is not None else self.lora)
        sampler = make_sampler(self.adapter.predict_velocity, SamplingConfig(
            num_inference_steps=steps, true_cfg_scale=true_cfg_scale))
        b = batch["prompt_embeds"].shape[0]
        dtype = self.dtype
        gen = torch.Generator(self.device).manual_seed(
            self.config.logging.sampling_seed if seed is None else seed)
        lat0 = torch.randn((b, s_img, self.bundle.dit_cfg.in_channels), generator=gen,
                           device=self.device, dtype=dtype)
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
