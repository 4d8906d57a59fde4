"""The port's Trainer: load the model, build a LoRA, train it on cached
embeddings or on pixels with logging, validation sampling, checkpoints and
resume, write the embedding cache, and predict from cached embeddings or
raw images.

Counterpart of qflux_tpu/trainer/base.py (`load_model`, `build_lora`,
`build_optimizer`, `build_criterion`, `_build_step_config`,
`setup_versioned_dir`, `fit`, `_embeddings_for_batch`,
`_build_multires_masks`, `save_checkpoint`, `_load_train_state`, `cache`,
`predict_from_embeddings`, `predict`, `_load_validation_samples`,
`setup_validation`, `run_validation`).  `fit` runs JAX's loop over a
`data.loader.DataLoader` of the embedding cache (shape buckets, or padded
mixed-resolution batches with segment ids), of pixels (encoded as they
come, `_embeddings_for_batch`), or any re-iterable of such batches:
epochs, `global_step`, the next batch staged while the step runs,
TensorBoard (or wandb / SwanLab) logging, a profiler window, a checkpoint
every train.checkpointing_steps and the last one at the end, a stop after
the step on SIGINT / SIGTERM, and `resume`.  Its files are the JAX
trainer's, so either package resumes the other's run:

    <logging.output_dir>/<logging.project>/vN/
        train_config.yaml                     the config (JSON, which YAML reads)
        logs/events.out.tfevents.*            TensorBoard events
        checkpoint-{step}/, checkpoint-last-{step}/
            pytorch_lora_weights.safetensors  the LoRA, diffusers names
            optimizer_state.npz               the optimizer's moments, optax's keys
            state.json                        global_step, epoch, is_last, git
            generator_state.npy               the port's noise generator

Batches of pixels, validation sampling, the cache pass, predict on raw
images and `predict_multires` (one padded sampler call over items of
different sizes; the families whose JAX adapter has it) run each family's
encoders: FLUX.1-Kontext's and DreamOmni2's VAE encoder, CLIP-L and T5-XXL
(DreamOmni2's prompts first rewritten by Qwen2.5-VL where its enhancer is
on); Qwen-Image-Edit's and Qwen-Image-Edit-Plus's 3D VAE encoder and
Qwen2.5-VL; FLUX.2-Klein's VAE encoder and Qwen3.  With
train.async_checkpointing a writer thread writes the same files
(`save_checkpoint`); logging.push_to_hub uploads the last LoRA and only
warns on failure.  JAX's orbax checkpoints are not read (item 2).
`history` records loss, grad_norm, lr and the step's host times per step.

The Trainer reads its settings by attribute, from the namespaces of the
port's own loader (`qflux_tpu_torch/config.py`: `Trainer.from_yaml` reads a
YAML file of the JAX package's format, or one in JSON syntax where PyYAML
is absent; `predict_config()` and `train_config()` build the same
namespaces in code).  `python -m qflux_tpu_torch.main` is the CLI.

The five trainers of JAX's TrainerKind are ported (`ADAPTERS`):
FLUX.1-Kontext, Qwen-Image-Edit, Qwen-Image-Edit-Plus, DreamOmni2 and
FLUX.2-Klein, each with predict and the LoRA train step, from synthetic
weights or from a diffusers checkpoint directory
(`model.pretrained_model_name_or_path`, read block by block).
`load_model` quantizes the DiT with `ops/quant.quantize_tree` where
`model.quantize.enabled`, in every dtype JAX's config allows (int8 by
default; int8 / fp8 weight-only, W8A8 `int8_dynamic`, the int4 forms), and
`fit` trains over that base (on the card the input gradients of the fused
int4 matmuls are kernels K5b and K6b, and W8A8's runs the int8 GEMM of
csrc/int8_gemm.cu).  `quantize.attention` runs the int8 score GEMM of K1
and K2 wherever JAX on a TPU would (S up to 2560 at head dim 128; bf16
attention through K3 / K4 elsewhere, as there).  Every remat policy of the
JAX forward trains (models/flux/transformer.py), and a step that runs out
of device memory under one that keeps tensors degrades once to "full" and
runs again, as JAX's `_degrade_remat_or_raise`.  The optimizers are
the optax ones of `trainer/optimizers.py` (adamw, adam, lion, sgd,
contrib.prodigy) and JAX's blockwise-fp8
`qflux_tpu.ops.adam8bit.adamw8bit` (ops/adam8bit.py).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import logging
import re
import shutil
import signal
import subprocess
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from qflux_tpu_torch import losses
from qflux_tpu_torch.config import config_from_dict, config_to_dict, load_config_from_yaml
from qflux_tpu_torch.data.cache import EmbeddingCacheManager
from qflux_tpu_torch.data.preprocess import ImageProcessor
from qflux_tpu_torch.ops.adam8bit import AdamW8bit
from qflux_tpu_torch.ops.layers import (build_lora_tree, iter_dense_paths, mark_trainable,
                                        merge_lora)
from qflux_tpu_torch.ops.quant import quantize_tree
from qflux_tpu_torch.parallel import collectives
from qflux_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from qflux_tpu_torch.parallel.partitioning import shard_base
from qflux_tpu_torch.scheduler.flow_match import FlowMatchScheduler
from qflux_tpu_torch.scheduler.weighting import default_weighting_table, load_weighting_table
from qflux_tpu_torch.trainer.dreamomni2 import DreamOmni2Adapter
from qflux_tpu_torch.trainer.flux2_klein import Flux2KleinAdapter
from qflux_tpu_torch.trainer import optimizers
from qflux_tpu_torch.trainer.flux_kontext import FluxKontextAdapter
from qflux_tpu_torch.trainer.qwen_edit import QwenImageEditAdapter
from qflux_tpu_torch.trainer.qwen_edit_plus import QwenImageEditPlusAdapter
from qflux_tpu_torch.trainer.sampling import SamplingConfig, make_sampler
from qflux_tpu_torch.trainer.train_step import (SHARED_BATCH_KEY_PREFIXES, TrainStepConfig,
                                                lora_leaves, make_lr_schedule,
                                                make_train_step)
from qflux_tpu_torch.utils import checkpoint
from qflux_tpu_torch.utils.fps import FpsLogger
from qflux_tpu_torch.utils.logger import LoggerManager, NullLogger
from qflux_tpu_torch.utils.lora_io import (LORA_FILE_BASE_NAME, load_lora_safetensors,
                                           save_lora_safetensors)
from qflux_tpu_torch.utils.model_summary import model_summary_rows
from qflux_tpu_torch.utils.seed import seed_everything
from qflux_tpu_torch.utils.tensors import numeric_suffix_key

# every trainer of JAX's TrainerKind (qflux_tpu/config.py)
ADAPTERS = {"FluxKontextLoraTrainer": FluxKontextAdapter,
            "QwenImageEditTrainer": QwenImageEditAdapter,
            "QwenImageEditPlusTrainer": QwenImageEditPlusAdapter,
            "DreamOmni2Trainer": DreamOmni2Adapter,
            "Flux2KleinLoraTrainer": Flux2KleinAdapter}
# loss.class_path → the port's loss (the JAX names, as configs carry them)
CRITERIA = {f"{pkg}.{name}": getattr(losses, name)
            for pkg in ("qflux_tpu.losses", "qflux_tpu.losses.losses")
            for name in ("MseLoss", "MaskEditLoss", "AttentionMaskMseLoss")}
# optimizer.class_path → the arguments ported
ADAM8BIT = "qflux_tpu.ops.adam8bit.adamw8bit"
OPTIMIZER_ARGS = {**{path: args for path, (_, args) in optimizers.OPTIMIZERS.items()},
                  ADAM8BIT: ("b1", "b2", "eps", "weight_decay", "block_size")}
ITEM_7 = ("ROADMAP.md, queue 1 item 7: \"Optimizers and CLI\" (what is left: optax.adafactor "
          "and the rest of optax.contrib)")
ITEM_2 = ("ROADMAP.md, queue 1 item 2: \"The rest of slice B, part 1: files, real weights and "
          "data\" (what is left: reading the JAX trainer's orbax checkpoints)")
# the joint sequence from which `_advise_sequence_parallel` suggests mesh.sp
# (qflux_tpu/parallel/planner.py:SP_ADVICE_SEQ; the planner is not ported)
SP_ADVICE_SEQ = 16384


def get_git_info() -> dict:
    """Commit/branch provenance saved into state.json."""
    info = {}
    for key, cmd in [("commit", ["git", "rev-parse", "HEAD"]),
                     ("branch", ["git", "rev-parse", "--abbrev-ref", "HEAD"])]:
        try:
            info[key] = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=5).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            info[key] = None
    return info


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
        self.mesh = self._build_mesh()
        if self.device.type == "cuda":
            # the f32 VAE and text encoders (and any f32 matmul) must not run
            # in TF32 (they raise otherwise: ops.layers.require_f32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        kind = config.trainer.value
        if kind not in ADAPTERS:
            raise ValueError(f"unknown trainer {kind!r} (the trainers: {sorted(ADAPTERS)})")
        self.adapter_cls = ADAPTERS[kind]
        self.scheduler = FlowMatchScheduler()
        self.fps = FpsLogger()
        self.logger = NullLogger()
        self._lr_schedule = None
        self._criterion = None
        self.adapter = None
        self.bundle = None
        self.lora = None
        self.global_step = 0
        self.epoch = 0
        self.output_dir: Optional[Path] = None
        # fit's optimizer and noise generator, which checkpoints save
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.generator: Optional[torch.Generator] = None
        self._ckpt_writer: Optional[checkpoint.AsyncWriter] = None
        # the seconds each save_checkpoint of the last fit held the train thread
        self.save_blocked_s: list[float] = []
        self._interrupted = False
        # what the last predict_from_embeddings call measured: denoise_s,
        # steps, decode_s (host clock around synchronised work) and whether
        # the final latents were all finite
        self.last_predict: dict = {}
        # one entry per fit step: step, loss, grad_norm, lr, step_s (host
        # clock around the step, which ends by reading the loss)
        self.history: list[dict] = []

    def _build_mesh(self):
        """The mesh of config.mesh over the process group (a world of one
        without one), as the JAX Trainer builds it; under a process group
        the device is this rank's (cuda:LOCAL_RANK, as `init_distributed`
        set it) and must match the backend: NCCL for cuda, gloo for cpu."""
        import torch.distributed as dist

        m = self.config.mesh
        if dist.is_available() and dist.is_initialized():
            want = {"cuda": "nccl", "cpu": "gloo"}.get(self.device.type)
            if dist.get_backend() != want:
                raise RuntimeError(f"a {self.device.type} Trainer under a "
                                   f"{dist.get_backend()} process group: {self.device.type} "
                                   f"runs over {want}")
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        return build_mesh(MeshConfig(dp=m.dp, fsdp=m.fsdp, tp=m.tp, sp=m.sp,
                                     dcn_axes=tuple(m.dcn_axes or ())),
                          device_type=self.device.type)

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
        leaves a quantized layer as it is.  Where the mesh shards the base
        (`Mesh.shards_base`: fsdp > 1 ranks) the frozen base is then sharded
        over the fsdp axis (JAX's `shard_pytree(dit_params, mmdit_rules(),
        mesh)`): each block as it loads where the adapter's loader builds
        it block by block (the adapter is given the mesh), the rest and the
        root after the quantization."""
        mesh = self.mesh if self.mesh.shards_base else None
        self.adapter, self.bundle = self.adapter_cls.load(self.config, self.device, self.dtype,
                                                          mesh=mesh)
        qz = self.config.model.quantize
        if qz and qz.enabled:
            self.bundle.dit_params = quantize_tree(self.bundle.dit_params, qz)
        if mesh is not None:
            self.bundle.dit_params = shard_base(self.bundle.dit_params, mesh)
        self._advise_sequence_parallel()

    def _advise_sequence_parallel(self) -> None:
        """Warn where the configured resolution gives a joint sequence long
        enough for ring attention (SP_ADVICE_SEQ) while mesh.sp is 1, as the
        JAX Trainer does."""
        ts = self.config.data.processor.target_size
        if not ts or self.adapter is None or self.mesh.shape.get("sp", 1) > 1:
            return
        h = int(ts[0])
        w = int(ts[1]) if len(ts) > 1 else h
        try:
            gh, gw = self.adapter.latent_grid(h, w)
        except Exception:
            return
        joint = (self.config.predict.max_sequence_length or 512) + 2 * gh * gw
        if joint >= SP_ADVICE_SEQ:
            logging.warning(
                "joint sequence ~%d tokens at %dx%d (target + control + text); set mesh.sp >= "
                "2 to split it with ring attention — per-device attention residency scales "
                "1/sp", joint, h, w)

    def setup_versioned_dir(self) -> Path:
        """<logging.output_dir>/<logging.project>/vN, one past the highest
        kept version, as the JAX Trainer numbers them: an old vN whose
        state.json says global_step < 5 and that holds no *.safetensors is
        an invalid run and is deleted first.  Under several ranks only the
        main rank scans, deletes and makes the directory; the version is
        broadcast, so every rank names the same run dir."""
        root = Path(self.config.logging.output_dir) / self.config.logging.project
        main = collectives.is_main_process()
        v = 0
        if main:
            root.mkdir(parents=True, exist_ok=True)
            versions = []
            for d in root.iterdir():
                m = re.fullmatch(r"v(\d+)", d.name)
                if not (m and d.is_dir()):
                    continue
                state_file = d / checkpoint.STATE_FILE
                step = 0
                if state_file.exists():
                    try:
                        step = json.loads(state_file.read_text()).get("global_step", 0)
                    except (OSError, ValueError, AttributeError):
                        step = 0
                if step < 5 and not any(d.rglob("*.safetensors")):
                    shutil.rmtree(d, ignore_errors=True)  # an invalid run
                else:
                    versions.append(int(m.group(1)))
            v = max(versions, default=-1) + 1
        out = root / f"v{int(collectives.broadcast_from_main(v))}"
        if main:
            out.mkdir(parents=True, exist_ok=True)
        return out

    def _install_signal_handlers(self) -> dict:
        """SIGINT / SIGTERM set a flag that `fit` reads after each step (it
        then saves the last checkpoint and returns).  Returns the handlers
        replaced, which `fit` puts back when it returns."""
        def handler(signum, frame):
            logging.warning("signal %s received; saving last checkpoint after this step",
                            signum)
            self._interrupted = True

        old = {}
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                old[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not on the main thread
        return old

    def build_lora(self):
        """model.lora.pretrained_weight: the LoRA of that file (or of a
        checkpoint directory's pytorch_lora_weights.safetensors), f32 on the
        device.  Otherwise a fresh LoRA over the configured targets (a
        gaussian, b zeros), from a generator seeded train.seed + 1, as the
        JAX Trainer."""
        lcfg = self.config.model.lora
        if lcfg.pretrained_weight:
            tree = load_lora_safetensors(lcfg.pretrained_weight, self.adapter.lora_tree_path_fn,
                                         head_dim=self.bundle.dit_cfg.attention_head_dim)
            # in the model's layer order, as a fresh tree (the order of the
            # global gradient norm's sum, so a resumed run repeats its bits)
            order = [p for p, _ in iter_dense_paths(self.bundle.dit_params) if p in tree]
            unknown = sorted(set(tree) - set(order))
            if unknown:
                raise KeyError(f"LoRA paths with no dense layer in the model: {unknown[:5]}")
            return {path: {"a": torch.from_numpy(tree[path]["a"]).to(self.device),
                           "b": torch.from_numpy(tree[path]["b"]).to(self.device),
                           "scaling": torch.tensor(float(tree[path]["scaling"]),
                                                   dtype=torch.float32, device=self.device)}
                    for path in order}
        targets = lcfg.target_modules or list(self.adapter.default_lora_targets)
        targets = [t if "/" in t else rf"attn/{t}" for t in targets]
        init = "gaussian" if lcfg.init_lora_weights in (True, "gaussian") else "kaiming"
        gen = torch.Generator(self.device).manual_seed(self.config.train.seed + 1)
        return build_lora_tree(gen, self.bundle.dit_params, targets, rank=lcfg.r,
                               alpha=lcfg.lora_alpha, init=init)

    @staticmethod
    def _broadcast_lora(lora) -> None:
        """Every rank's LoRA made the main rank's, in place (one broadcast
        over the device's process group), so the replicas start equal."""
        if collectives.process_count() == 1:
            return
        import torch.distributed as dist

        leaves = [leaf[k] for leaf in lora.values() for k in ("a", "b", "scaling")]
        with torch.no_grad():
            flat = torch.cat([t.reshape(-1).float() for t in leaves])
            dist.broadcast(flat, src=0)
            for t, part in zip(leaves, torch.split(flat, [t.numel() for t in leaves])):
                t.copy_(part.view_as(t))

    def build_optimizer(self, params: list, stacks=None, frozen=()):
        """(optimizer over `params`, lr schedule) with the configured lr
        schedule: an optax optimizer of `trainer/optimizers.py` (adamw,
        adam, lion, sgd, contrib.prodigy), or JAX's
        `qflux_tpu.ops.adam8bit.adamw8bit` as `AdamW8bit` (`stacks`: the
        params grouped as JAX stacks its leaves, `checkpoint.lora_stacks`),
        each with the configured arguments at optax's defaults where absent.
        `frozen` (the LoRA's scaling leaves) reaches the optimizers whose
        update depends on the whole tree (Prodigy).  Any other optimizer or
        argument raises."""
        ocfg = self.config.optimizer
        ported = OPTIMIZER_ARGS.get(ocfg.class_path)
        if ported is None:
            raise NotImplementedError(
                f"optimizer {ocfg.class_path!r} is not ported yet ({ITEM_7}; ported: "
                f"{sorted(OPTIMIZER_ARGS)})")
        args = dict(ocfg.init_args or {})
        unknown = sorted(set(args) - set(ported))
        if unknown:
            why = ("; optax's `mask` takes a pytree or a callable, which a config cannot "
                   "give" if "mask" in unknown else "")
            raise NotImplementedError(
                f"{ocfg.class_path} arguments {unknown} are not ported yet ({ITEM_7}; "
                f"ported: {list(ported)}{why})")
        schedule = make_lr_schedule(ocfg.learning_rate, self.config.lr_scheduler.scheduler_type,
                                    self.config.lr_scheduler.warmup_steps,
                                    self.config.train.max_train_steps)
        if ocfg.class_path == ADAM8BIT:
            opt = AdamW8bit(params, lr=schedule(0), betas=(args.get("b1", 0.9),
                                                           args.get("b2", 0.999)),
                            eps=args.get("eps", 1e-8), weight_decay=args.get("weight_decay", 1e-2),
                            block_size=args.get("block_size", 256), stacks=stacks)
        else:
            opt = optimizers.build(ocfg.class_path, params, schedule(0), args, frozen=frozen)
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
            table = (load_weighting_table(t.weighting_table) if t.weighting_table
                     else default_weighting_table())
            scheme = "table"
        return TrainStepConfig(timestep_sampling=sampling, logit_mean=t.logit_mean,
                               logit_std=t.logit_std, weighting_scheme=scheme,
                               weighting_table=table, max_grad_norm=t.max_grad_norm,
                               grad_accum_steps=t.gradient_accumulation_steps)

    def _device_batch(self, emb: dict) -> dict:
        """Cached embeddings (numpy or tensors) → tensors on the device:
        floats in the weight dtype (edit_mask stays f32), as the JAX
        Trainer's `_device_batch`; ids rebuilt by the adapter.  On a CUDA
        device a host tensor is pinned and copied without blocking, so the
        copy queues behind a step still running instead of waiting for it."""
        emb = self._prepare_cached(emb)
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in emb.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            if t.dtype in (torch.float32, torch.float16, torch.float64, torch.bfloat16):
                t = t.to(torch.float32 if k == "edit_mask" else self.dtype)
            if cuda and t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=cuda)
        return out

    def _rank_rows(self, emb: dict):
        """This rank's rows of a global batch → (emb, losses.DataShard), as
        JAX shards a batch over (dp, fsdp): each per-sample array's rows of
        every global microbatch of train.gradient_accumulation_steps in turn
        (microbatch i's rows split in data-rank order); shared arrays (ids,
        RoPE tables) whole, their per-sample [B, S, ·] forms (a mixed-size
        batch's) split too.  A batch of one on a data mesh trains
        replicated, with JAX's one warning; any other batch that the data
        ranks (times the microbatches) do not divide raises JAX's error."""
        mesh = getattr(self, "mesh", None)
        n_data = mesh.data_size if mesh is not None else 1
        if n_data == 1:
            return emb, losses.DataShard()
        lat = emb.get("image_latents")
        b = lat.shape[0] if lat is not None else self._batch_items(emb)
        if b == 1:
            if not getattr(self, "_warned_replicated_batch", False):
                self._warned_replicated_batch = True
                logging.warning(
                    "batch size 1 on a dp×fsdp=%d mesh trains fully REPLICATED (every rank "
                    "computes the same sample); raise data.batch_size to a multiple of %d "
                    "for data parallelism", n_data, n_data)
            return emb, losses.DataShard()
        n = self.config.train.gradient_accumulation_steps
        split = {k for k, v in emb.items() if hasattr(v, "shape") and len(v.shape) >= 1
                 and v.shape[0] > 1 and (not k.startswith(SHARED_BATCH_KEY_PREFIXES)
                                         or (len(v.shape) >= 3 and v.shape[0] == b))}
        for k in sorted(split):
            if emb[k].shape[0] % (n_data * n):
                raise ValueError(
                    f"batch size {emb[k].shape[0]} (key {k!r}) must be divisible by dp×fsdp = "
                    f"{n_data} (mesh {dict(mesh.shape)})"
                    + (f" times grad_accum_steps = {n}" if n > 1 else "")
                    + "; adjust data.batch_size or the mesh section")
        m = b // (n_data * n)
        rows = [i * (b // n) + mesh.data_index * m + j for i in range(n) for j in range(m)]
        out = {k: (v[rows] if k in split else v) for k, v in emb.items()}
        return out, losses.DataShard(mesh.data_index, n_data, mesh.data_group)

    def _fit_batch(self, batch):
        """A loader's batch → (this rank's device batch, its DataShard), or
        None at the end."""
        if batch is None:
            return None
        emb, data = self._rank_rows(self._embeddings_for_batch(batch))
        return self._device_batch(emb), data

    def _embeddings_for_batch(self, batch: dict) -> dict:
        """A collated batch (or a plain dict of arrays) → the step's
        embeddings, as the JAX Trainer's.  A cached batch: only the arrays
        are kept (`cached`, the prompts, file hashes and `valid_masks` go);
        a batch whose latents were padded to one shape gets segment ids and
        a token loss mask (`_build_multires_masks`); otherwise ids collated
        per sample collapse to the shared ones; then the adapter rebuilds
        img_ids / the RoPE tables.  A batch of pixels (no `image_latents`)
        is encoded by the adapter, and the control latents of the samples
        flagged `drop_context` (prompt-image dropout) are zeroed, as the
        cached path zeroes them at load."""
        if "image_latents" not in batch:
            emb = self.adapter.prepare_embeddings(self.bundle, batch,
                                                  self.config.predict.max_sequence_length)
            flags = batch.get("drop_context")
            if flags is not None and np.any(flags):
                keep = torch.as_tensor(1.0 - np.asarray(flags, np.float32)).reshape(-1, 1, 1)
                for k in list(emb):
                    if k.startswith("control") and torch.is_tensor(emb[k]) and emb[k].dim() == 3:
                        emb[k] = emb[k] * keep.to(emb[k].device)
            return emb
        emb = {k: v for k, v in batch.items()
               if isinstance(v, np.ndarray) or hasattr(v, "device")}
        emb.pop("cached", None)
        valid = batch.get("valid_masks") or {}
        if any(k in valid for k in ("image_latents", "control_latents")):
            emb = self._build_multires_masks(emb, valid)
        else:
            for k in ("img_ids", "txt_ids"):
                if k in emb and emb[k].ndim == 3:
                    emb[k] = emb[k][0]  # shared ids, collated per sample
        return self._prepare_cached(emb)

    def _prepare_cached(self, emb: dict) -> dict:
        """The adapter's `prepare_cached_embeddings` where it has one (FLUX's
        ids, Qwen's RoPE tables), else the embeddings as they are (Klein),
        as the JAX Trainer."""
        if hasattr(self.adapter, "prepare_cached_embeddings"):
            return self.adapter.prepare_cached_embeddings(emb)
        return emb

    def _build_multires_masks(self, emb: dict, valid: dict) -> dict:
        """A mixed-resolution batch, right-padded by `collate`: segment ids
        over the joint sequence laid out [txt, target, control] (padding →
        segment 0; the text part is prompt_embeds_mask where there is one)
        and `attention_mask`, the target tokens' loss mask (f32), as the
        JAX Trainer derives them."""
        b = emb["image_latents"].shape[0]
        img_valid = np.asarray(valid.get("image_latents",
                                         np.ones(emb["image_latents"].shape[:2], bool)))
        if "prompt_embeds_mask" in emb:
            parts = [np.asarray(emb["prompt_embeds_mask"]).astype(np.int32)]
        else:
            parts = [np.ones((b, emb["prompt_embeds"].shape[1]), np.int32)]
        parts.append(img_valid.astype(np.int32))
        if "control_latents" in emb and emb["control_latents"].shape[1]:
            parts.append(np.asarray(valid.get(
                "control_latents", np.ones(emb["control_latents"].shape[:2], bool))
            ).astype(np.int32))
        emb["segment_ids"] = np.concatenate(parts, axis=1)
        emb["attention_mask"] = img_valid.astype(np.float32)
        crit = getattr(self, "_criterion", None) or self.build_criterion()
        if not isinstance(crit, losses.AttentionMaskMseLoss):
            logging.warning(
                "multi-resolution batch with a non-token-masked loss (%s); padded tokens "
                "will pollute the loss — set loss.class_path="
                "qflux_tpu.losses.AttentionMaskMseLoss", self.config.loss.class_path)
        return emb

    def _batch_items(self, batch) -> int:
        """The batch size: the leading dim of the first array."""
        for v in batch.values():
            if hasattr(v, "shape") and len(v.shape) >= 1:
                return int(v.shape[0])
        return 1

    def _lr_value(self, step: int) -> float:
        """The learning rate the schedule gives at update count `step`, for
        logging (as the JAX Trainer logs it: at global_step after the
        update)."""
        if self._lr_schedule is None:
            lr = self.config.lr_scheduler
            self._lr_schedule = make_lr_schedule(self.config.optimizer.learning_rate,
                                                 lr.scheduler_type, lr.warmup_steps,
                                                 self.config.train.max_train_steps)
        return float(self._lr_schedule(step))

    def _schedule_has_count(self) -> bool:
        """Whether optax's adamw state carries a schedule count ("2/count"):
        the JAX lr is a schedule unless it is constant without warmup."""
        lr = self.config.lr_scheduler
        return not (lr.scheduler_type == "constant" and lr.warmup_steps == 0)

    def fit(self, dataloader):
        """Train the LoRA on `dataloader`: a `data.loader.DataLoader`, or any
        re-iterable of cached-embedding batches (collated dicts, or plain
        dicts of arrays with `image_latents`), as the JAX Trainer's loop.

        Up to train.num_epochs passes over `dataloader` and
        train.max_train_steps steps; the next batch is fetched and copied
        to the device while the step runs, before its loss is read; a
        checkpoint every train.checkpointing_steps (the throughput clock
        paused) and the last one (checkpoint-last-{step}) always; a stop
        after the step on SIGINT / SIGTERM.  The run dir is a new vN under
        logging.output_dir / logging.project, with the config as
        train_config.yaml and, under logging.report_to "tensorboard", an
        events file in logs/: the hparams and the model summary at step 0,
        `compile_s` (the first step's wall time) at step 1, then loss,
        smooth_loss (EMA 0.95), epoch, lr and fps at every step.  With
        logging.profile_dir, torch.profiler traces steps 2–4 into a chrome
        trace there.  Noise and σ come from a generator seeded train.seed.
        With `resume` (a checkpoint directory), the LoRA comes from its
        file, then the optimizer's moments, global_step, epoch and the generator
        are restored, so the run goes on as if it had not stopped.
        Returns the LoRA tree, trained in place; `history` holds one entry
        per step: step, loss, grad_norm, lr (of this update), step_s (host
        clock from the step's launch to its loss read, the next batch's
        staging inside it), stage_s (that staging: fetch, `_embeddings_for_batch`
        and the copies queued) and data_wait_s (time this step's batch kept
        the loop blocked in `next`).  With validation.enabled and samples or
        a dataset, `run_validation` samples every validation.steps steps
        (the throughput clock paused), as in JAX."""
        cfg = self.config
        seed_everything(cfg.train.seed)
        if self.adapter is None:
            self.load_model()
        self.global_step = self.epoch = 0
        self.save_blocked_s = []
        self._interrupted = False
        self.output_dir = self.setup_versioned_dir()
        config_dict = config_to_dict(cfg)
        main = collectives.is_main_process()
        if main:  # rank-gated: one config file, one logger
            (self.output_dir / "train_config.yaml").write_text(json.dumps(config_dict, indent=2)
                                                               + "\n")
            self.logger = LoggerManager(report_to=cfg.logging.report_to,
                                        log_dir=self.output_dir / "logs",
                                        project=cfg.logging.tracker_project_name
                                        or cfg.logging.project, config=config_dict)
        else:
            self.logger = NullLogger()
        if cfg.resume:
            cfg.model.lora.pretrained_weight = str(cfg.resume)
        lora = self.build_lora()
        self._broadcast_lora(lora)
        self.lora = lora = mark_trainable(lora)
        params, scalings = lora_leaves(lora)
        self.optimizer, schedule = self.build_optimizer(params, checkpoint.lora_stacks(lora),
                                                        frozen=scalings)
        self.generator = torch.Generator(self.device).manual_seed(cfg.train.seed)
        if cfg.resume:
            self._load_train_state(Path(cfg.resume))
        criterion = self._criterion = self.build_criterion()
        step_cfg = self._build_step_config()
        step = make_train_step(self.adapter.predict_velocity, criterion, self.optimizer,
                               schedule, step_cfg, first_update=self.global_step)
        self.logger.log_table("model_summary",
                              model_summary_rows(self.bundle.dit_params, lora), 0)
        self.history = []
        self._validation_setup_done = False
        old_handlers = self._install_signal_handlers()
        profiler = None
        ema_loss = None
        if cfg.train.async_checkpointing:
            self._ckpt_writer = checkpoint.AsyncWriter(self.device)
        try:
            done = False
            self.fps.start()
            for epoch in range(self.epoch, cfg.train.num_epochs):
                self.epoch = epoch
                batch_iter = iter(dataloader)
                t0 = time.perf_counter()
                batch = next(batch_iter, None)
                wait = time.perf_counter() - t0
                staged = self._fit_batch(batch)
                while batch is not None:
                    if cfg.logging.profile_dir:  # trace steps 2-4: past the first
                        if self.global_step == 1 and profiler is None:
                            profiler = self._profile(None)
                        elif self.global_step == 4 and profiler is not None:
                            profiler = self._profile(profiler)
                    t0 = time.perf_counter()
                    metrics, step = self._run_step(step, *staged, criterion, schedule,
                                                   step_cfg)
                    self.global_step += 1
                    if self.global_step == 1:  # the first step alone, before staging
                        loss = float(metrics["loss"])
                        self.logger.log_metrics({"compile_s": time.perf_counter() - t0}, 1)
                    # stage the next batch while the device runs the step,
                    # then read the loss (which waits for the device)
                    t_stage = time.perf_counter()
                    next_batch = next(batch_iter, None)
                    next_wait = time.perf_counter() - t_stage
                    staged = self._fit_batch(next_batch)
                    stage_s = time.perf_counter() - t_stage
                    loss = float(metrics["loss"])
                    step_s = time.perf_counter() - t0
                    ema_loss = loss if ema_loss is None else 0.95 * ema_loss + 0.05 * loss
                    fps = self.fps.step(n_items=self._batch_items(batch))
                    self.logger.log_metrics(
                        {"loss": loss, "smooth_loss": ema_loss, "epoch": epoch,
                         "lr": self._lr_value(self.global_step),
                         **({"fps": fps} if fps else {})}, self.global_step)
                    self.history.append({"step": self.global_step, "loss": loss,
                                         "grad_norm": float(metrics["grad_norm"]),
                                         "lr": float(metrics["lr"]), "step_s": step_s,
                                         "stage_s": stage_s, "data_wait_s": wait})
                    wait = next_wait
                    if self.global_step % cfg.train.checkpointing_steps == 0:
                        self.fps.pause()
                        self.save_checkpoint()
                        self.fps.resume()
                    if (cfg.validation.enabled and cfg.validation.steps > 0
                            and self.global_step % cfg.validation.steps == 0):
                        self.fps.pause()
                        self.run_validation()
                        self.fps.resume()
                    # a stop is every rank's, or the others would wait in a collective
                    if (collectives.any_across(self._interrupted)
                            or self.global_step >= cfg.train.max_train_steps):
                        done = True
                        break
                    batch = next_batch
                if done:
                    break
            if profiler is not None:
                profiler = self._profile(profiler)
            last_ckpt = self.save_checkpoint(last=True)
            if self._ckpt_writer is not None:
                self._ckpt_writer.wait()  # the last save lands before fit returns
            if cfg.logging.push_to_hub:
                self._push_to_hub(last_ckpt / LORA_FILE_BASE_NAME, cfg.logging.push_to_hub)
        finally:
            if self._ckpt_writer is not None:
                self._ckpt_writer.close()
                self._ckpt_writer = None
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
            if profiler is not None:
                profiler.__exit__(None, None, None)
            self.logger.close()
        return lora

    def _run_step(self, step, emb, data, criterion, schedule, step_cfg):
        """One train step on this rank's rows (`data`, a losses.DataShard)
        → (metrics, the step to go on with).  A step that raises
        torch.OutOfMemoryError before the optimizer began its update,
        under a remat policy that keeps tensors, is run once more on the
        same batch and the same noise under "full" (`_degrade_remat_or_raise`).
        Under a dp-only mesh the step raises on every rank where any ran
        out (`make_train_step`), so all retry together; where the step
        exchanges tensors with other ranks (`Mesh.step_collectives`: a
        sharded base, the ring) the others wait in its collectives, so the
        error is raised, not retried, and ends the run."""
        rng_state = self.generator.get_state()
        try:
            return step(self.bundle.dit_params, self.lora, emb, self.generator, data=data), step
        except torch.OutOfMemoryError as err:
            if self.mesh.step_collectives:
                logging.error(
                    "train step ran out of memory under a mesh whose step exchanges tensors "
                    "between ranks (fsdp > 1 or sp > 1): the other ranks cannot join a retry; "
                    "set mesh.remat: full or raise fsdp / sp, and rerun")
                raise
            step = self._degrade_remat_or_raise(err, step, criterion, schedule, step_cfg)
        # out of the except block, the failed step's graph is gone with its
        # traceback: free its gradients and the cached blocks too
        for t in sum(lora_leaves(self.lora), []):
            t.grad = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.generator.set_state(rng_state)
        return step(self.bundle.dit_params, self.lora, emb, self.generator, data=data), step

    def _degrade_remat_or_raise(self, err, step, criterion, schedule, step_cfg):
        """JAX's rule for a step that ran out of memory: the adapter
        replaced by one with remat_policy "full", the step rebuilt at the
        current update count; re-raises `err` unchanged under "full" or
        without remat, and where the optimizer had begun its update (the
        LoRA may be half stepped; JAX's donated-state case)."""
        policy = getattr(self.adapter, "remat_policy", "full")
        if policy in ("full", "none") or not getattr(self.adapter, "remat", False):
            raise err
        if step.began_update:
            logging.error(
                "train step ran out of memory AFTER the optimizer began its update — cannot "
                "retry with a degraded remat policy; set mesh.remat: full in the config and "
                "rerun")
            raise err
        logging.warning(
            "train step ran out of memory under remat policy %r: %s — retrying with "
            "mesh.remat: full (save-nothing recompute; slower but minimal-memory). Set "
            "mesh.remat: full in the config to skip this probe.", policy, str(err)[:300])
        self.adapter = dataclasses.replace(self.adapter, remat_policy="full")
        return make_train_step(self.adapter.predict_velocity, criterion, self.optimizer,
                               schedule, step_cfg, first_update=self.global_step)

    def _profile(self, profiler):
        """Start torch.profiler (profiler None), or stop it and write its
        chrome trace into logging.profile_dir; returns the running profiler
        or None."""
        if profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.__enter__()
            return profiler
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.__exit__(None, None, None)
        out = Path(self.config.logging.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"fit_steps_2-{self.global_step}.trace.json"
        profiler.export_chrome_trace(str(path))
        logging.info("profiler trace written to %s", path)
        return None

    def save_checkpoint(self, last: bool = False) -> Path:
        """checkpoint-{step} (checkpoint-last-{step} with `last`) in the run
        dir: the LoRA file, the optimizer's state as the JAX trainer writes
        it, the generator's state and state.json.  Under
        train.async_checkpointing the train thread waits for the save
        before (one in flight) and for host copies of the tensors, and a
        writer thread writes the same files from them (`utils/checkpoint.py:
        AsyncWriter`).  `save_blocked_s` gets the seconds the train thread
        spent here.  Only the main rank writes (the LoRA and the optimizer's
        state are replicated); every rank reads on resume.  Returns the
        directory."""
        t0 = time.perf_counter()
        name = f"checkpoint-last-{self.global_step}" if last else f"checkpoint-{self.global_step}"
        ckpt_dir = self.output_dir / name
        if not collectives.is_main_process():
            return ckpt_dir
        writer = self._ckpt_writer
        if writer is not None:
            writer.wait()
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        tensors = {"lora": {path: dict(leaf) for path, leaf in self.lora.items()},
                   "state": checkpoint.optimizer_state_tensors(
                       self.lora, self.optimizer, self.global_step, self._schedule_has_count())}
        meta = {"global_step": self.global_step, "epoch": self.epoch, "is_last": last}
        generator_state = self.generator.get_state().numpy().copy()
        if writer is None:
            self._write_checkpoint(ckpt_dir, tensors, generator_state, meta)
        else:
            writer.submit(self._write_checkpoint, ckpt_dir, writer.snapshot(tensors),
                          generator_state, meta)
        self.save_blocked_s.append(time.perf_counter() - t0)
        return ckpt_dir

    def _write_checkpoint(self, ckpt_dir: Path, tensors: dict, generator_state, meta: dict):
        """The checkpoint's files from `save_checkpoint`'s tensors (on the
        device, or their host copies)."""
        save_lora_safetensors(tensors["lora"], ckpt_dir, self.adapter.lora_module_name_fn,
                              head_dim=self.bundle.dit_cfg.attention_head_dim)
        checkpoint.write_train_state(ckpt_dir, checkpoint.host_arrays(tensors["state"]),
                                     generator_state)
        (ckpt_dir / checkpoint.STATE_FILE).write_text(json.dumps({**meta, "git": get_git_info()}))
        logging.info("saved checkpoint %s", ckpt_dir)

    @staticmethod
    def _push_to_hub(lora_file: Path, repo_id: str) -> None:
        """Upload the last LoRA (`utils/hub.py`); a failure only warns, as
        in JAX (the push needs huggingface_hub and a network)."""
        try:
            from qflux_tpu_torch.utils.hub import upload_lora_safetensors

            upload_lora_safetensors(lora_file, repo_id)
            logging.info("pushed LoRA to hub repo %s", repo_id)
        except Exception as err:
            logging.warning("hub push failed: %s", err)

    def _load_train_state(self, ckpt: Path) -> None:
        """global_step and epoch from state.json, the optimizer's state from
        optimizer_state.npz (the JAX trainer's npz route) and the
        generator's state, each where the checkpoint has it.  The JAX
        trainer's async route keeps its optimizer state in an orbax
        directory beside the checkpoints instead, which the port does not
        read: it warns, naming it, and without an npz the moments start
        fresh."""
        state_file = ckpt / checkpoint.STATE_FILE
        if state_file.exists():
            st = json.loads(state_file.read_text())
            self.global_step = st.get("global_step", 0)
            self.epoch = st.get("epoch", 0)
        opt_file = ckpt / checkpoint.OPTIMIZER_FILE
        orbax_dir = ckpt.parent / "orbax"
        if orbax_dir.exists():
            logging.warning(
                "%s is an orbax checkpoint (the JAX trainer's train.async_checkpointing), which "
                "the port does not read (%s); %s", orbax_dir, ITEM_2,
                f"restoring {opt_file} instead" if opt_file.exists()
                else "the optimizer's state starts fresh")
        if opt_file.exists():
            with np.load(opt_file) as arrays:
                checkpoint.restore_optimizer_state(dict(arrays), self.lora, self.optimizer)
        checkpoint.load_generator_state(ckpt, self.generator)

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
        lat0 = self._initial_latents((b, s_img, self.bundle.dit_cfg.in_channels), seed)
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

    def _initial_latents(self, shape: tuple, seed: Optional[int]) -> torch.Tensor:
        """Gaussian noise of `shape` in the weight dtype on the device, from a
        generator seeded `seed` (default logging.sampling_seed): the port's
        own stream, where JAX draws `jax.random.normal`."""
        gen = torch.Generator(self.device).manual_seed(
            self.config.logging.sampling_seed if seed is None else seed)
        return torch.randn(shape, generator=gen, device=self.device, dtype=self.dtype)

    # ------------------------------------------------------------------
    # the cache pass

    def cache(self, dataloader) -> int:
        """Encode every sample of `dataloader` (bs=1 batches of pixels) not
        yet in cache.cache_dir into it, in the JAX package's format (fp16
        arrays under their content hashes, `data/cache.py`), so either
        package trains from the result.  Returns the number of samples
        written; `last_cache` holds that, the pass's seconds (the model's
        load apart) and per sample written its `encode_s` (the encoders,
        ending with the arrays on the host) and `write_s` (the npz files)."""
        if self.adapter is None:
            self.load_model()
        cache_dir = self.config.cache.cache_dir
        if not cache_dir:
            raise ValueError("cache mode requires cache.cache_dir")
        cm = EmbeddingCacheManager(cache_dir)
        t0 = time.perf_counter()
        encode_s, write_s = [], []
        for batch in dataloader:
            hashes = batch["file_hashes"]
            hashes = hashes[0] if isinstance(hashes, list) else hashes
            if cm.exists(hashes["main_hash"]):
                continue
            t1 = time.perf_counter()
            arrays, hash_keys = self.adapter.cache_embeddings(
                self.bundle, batch, self.config.predict.max_sequence_length)
            t2 = time.perf_counter()
            if collectives.is_main_process():  # one writer under several ranks
                cm.save(hashes["main_hash"], arrays,
                        {k: hashes[v] if v in hashes else v for k, v in hash_keys.items()})
            encode_s.append(t2 - t1)
            write_s.append(time.perf_counter() - t2)
        n = len(encode_s)
        self.last_cache = {"samples": n, "seconds": time.perf_counter() - t0,
                           "encode_s": encode_s, "write_s": write_s}
        logging.info("cached %d new samples into %s", n, cache_dir)
        return n

    # ------------------------------------------------------------------
    # predict on raw images

    def _pixel_item(self, images: list, prompt: str, height=None, width=None) -> dict:
        """Control images (uint8 arrays, none for text to image) + prompt →
        one unbatched pixel item: each image resampled as control_i by
        data.processor ("control", "control_1", …), a zero target of
        (height, width), the first control's size unless given."""
        processor = ImageProcessor(self.config.data.processor)
        controls = [processor.process_image(np.asarray(im), f"control_{i}")
                    for i, im in enumerate(images)]
        height = height or controls[0].shape[0]
        width = width or controls[0].shape[1]
        item = {"image": np.zeros((height, width, 3), np.uint8), "prompt": prompt}
        for i, c in enumerate(controls):
            item["control" if i == 0 else f"control_{i}"] = c
        return item

    def _pixel_embeddings(self, images: list, prompt: str, height=None, width=None,
                          negative_prompt: Optional[str] = None):
        """`_pixel_item` as a bs=1 batch → (embeddings without the target's
        latents, height, width); with `negative_prompt` also its
        embeddings."""
        item = self._pixel_item(images, prompt, height, width)
        batch = {k: (v[None] if isinstance(v, np.ndarray) else [v]) for k, v in item.items()}
        msl = self.config.predict.max_sequence_length
        emb = self.adapter.prepare_embeddings(self.bundle, batch, msl)
        emb.pop("image_latents", None)
        if negative_prompt is not None:
            emb.update(self.adapter.negative_embeddings(self.bundle, negative_prompt, batch, msl))
        return emb, item["image"].shape[0], item["image"].shape[1]

    def predict(self, images, prompt: str, height: Optional[int] = None,
                width: Optional[int] = None, **kw) -> np.ndarray:
        """Edit raw images: uint8 [H, W, 3] control image(s) and a prompt →
        uint8 images [1, H, W, 3], as the JAX Trainer's `predict` (the
        LoRA of model.lora.pretrained_weight when the trainer has none;
        `negative_prompt` (default " ") where predict.true_cfg_scale > 1;
        other keywords go to `predict_from_embeddings`)."""
        if self.adapter is None:
            self.load_model()
        if self.lora is None and self.config.model.lora.pretrained_weight:
            self.lora = self.build_lora()
        imgs = images if isinstance(images, list) else [images]
        negative = kw.pop("negative_prompt", " ")
        use_neg = self.config.predict.true_cfg_scale > 1.0
        emb, height, width = self._pixel_embeddings(imgs, prompt, height, width,
                                                    negative if use_neg else None)
        return self.predict_from_embeddings(emb, height, width, **kw)

    def predict_multires(self, items: list, num_inference_steps=None, seed=None) -> list:
        """Edit items of different sizes in one padded sampler call, as the
        JAX Trainer's: each item {"prompt", "images": [uint8 controls],
        "height", "width"} resampled by data.processor (its size that of
        its first control unless given), the adapter's
        `prepare_multires_embeddings` (segment ids mask the padding), one
        Euler loop over the longest target (the sigma plan at its length,
        predict's steps and true_cfg_scale, the trainer's LoRA merged), then
        each sample's latents cut to its own grid and decoded alone.
        Returns [uint8 [H_i, W_i, 3]]."""
        if self.adapter is None:
            self.load_model()
        if not hasattr(self.adapter, "prepare_multires_embeddings"):
            raise NotImplementedError(
                f"{type(self.adapter).__name__} has no multi-res predict path")
        prepped = [self._pixel_item(it.get("images", []), it["prompt"], it.get("height"),
                                    it.get("width")) for it in items]
        pcfg = self.config.predict
        emb = self.adapter.prepare_multires_embeddings(self.bundle, prepped,
                                                       pcfg.max_sequence_length)
        grids = emb.pop("sample_grids")
        emb.pop("attention_mask", None)
        lat_template = emb.pop("image_latents")
        steps = num_inference_steps or pcfg.num_inference_steps
        plan = self.scheduler.sampling_plan(steps, image_seq_len=lat_template.shape[1])
        params = merge_lora(self.bundle.dit_params, self.lora)
        sampler = make_sampler(self.adapter.predict_velocity, SamplingConfig(
            num_inference_steps=steps, true_cfg_scale=pcfg.true_cfg_scale))
        batch = self._device_batch(emb)
        if "guidance" not in batch:
            batch["guidance"] = torch.full((len(items),), pcfg.guidance, dtype=self.dtype,
                                           device=self.device)
        latents = sampler(params, batch, self._initial_latents(tuple(lat_template.shape), seed),
                          plan.sigmas)
        vs2 = self.adapter.vae_scale * 2
        return [self.adapter.decode_latents(self.bundle, latents[i:i + 1, :gh * gw],
                                            gh * vs2, gw * vs2)[0]
                for i, (gh, gw) in enumerate(grids)]

    # ------------------------------------------------------------------
    # validation

    def _load_validation_samples(self) -> list[dict]:
        """validation.samples ({prompt, images: [paths], height, width}) or
        the first validation.max_samples items of validation.dataset (its
        cache off, data.processor its default processor): [{prompt, images
        (uint8 arrays), height, width}]."""
        from qflux_tpu_torch.data.dataset import _read_image
        from qflux_tpu_torch.utils.instantiate import instantiate_class

        vcfg = self.config.validation
        if vcfg.samples:
            return [{"prompt": s.get("prompt", ""),
                     "images": [_read_image(p) for p in s.get("images", [])],
                     "height": s.get("height"), "width": s.get("width")}
                    for s in vcfg.samples]
        out = []
        if vcfg.dataset:
            init_args = dict(vcfg.dataset.get("init_args", {}))
            init_args.pop("use_cache", None)
            init_args.pop("cache_dir", None)
            # data.processor, as the CLI gives the training dataset (JAX's
            # validation dataset takes the default one, which has no size)
            init_args.setdefault("processor", ImageProcessor(self.config.data.processor))
            ds = instantiate_class(vcfg.dataset["class_path"], **init_args)
            for i in range(min(vcfg.max_samples, len(ds))):
                item = ds[i]
                keys = [k for k in ("control",) if k in item] + sorted(
                    (k for k in item if k.startswith("control_")), key=numeric_suffix_key)
                out.append({"prompt": item.get("prompt", ""),
                            "images": [np.asarray(item[k]) for k in keys],
                            "height": np.shape(item["image"])[0],
                            "width": np.shape(item["image"])[1]})
        return out

    def setup_validation(self) -> None:
        """Encode the validation samples once (the JAX Trainer's
        `setup_validation`), this rank's shard of them (`_validation_shard`):
        each sample's controls resampled
        by data.processor, its size that of the sample, else of its first
        control, else processor.target_size, else 512².  Text encoders
        that were not built before (a fit from the embedding cache) are
        built for these samples alone and freed after them, so the steps
        that follow never hold them; the bundle's factory rebuilds them
        where a later call needs them."""
        built_here = not self.bundle.text_params and self.bundle.text_factory is not None
        samples = self._load_validation_samples()
        self._validation_prompts = [s["prompt"] for s in samples]
        self._validation_embeddings = []
        self._validation_setup_done = True
        tgt = self.config.data.processor.target_size or (512, 512)
        mine = set(self._validation_shard(len(samples)))
        for i, s in enumerate(samples):
            if i not in mine:
                continue
            h, w = s.get("height"), s.get("width")
            if not s["images"]:
                h, w = h or tgt[0], w or tgt[1]
            emb, h, w = self._pixel_embeddings(s["images"], s["prompt"], h, w)
            self._validation_embeddings.append({"index": i, "prompt": s["prompt"], "emb": emb,
                                                "height": h, "width": w})
        if built_here:
            self.bundle.text_params = {}
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def _validation_shard(self, n: int) -> list[int]:
        """The validation samples this rank samples: round-robin over the dp
        index (JAX shards over processes).  The ranks of one dp index (their
        fsdp and sp ranks) sample the same ones together, as their gathered
        weights and the ring need them to."""
        mesh = getattr(self, "mesh", None)
        if mesh is None:
            return collectives.shard_validation_samples(n)
        return collectives.shard_validation_samples(n, rank=mesh.coords["dp"],
                                                    world=mesh.shape["dp"])

    def run_validation(self) -> list:
        """Sample every validation embedding with validation's own steps,
        guidance and true_cfg_scale, and log each as
        `validation/sample_{i}` (images) and `validation/prompt_{i}` (text)
        at the current step.  A failure raises unless
        validation.fail_on_error is false (then it is logged).  Returns
        [(index, images)]."""
        vcfg = self.config.validation
        if not getattr(self, "_validation_setup_done", False):
            if vcfg.samples or vcfg.dataset:
                self.setup_validation()
            if not getattr(self, "_validation_embeddings", None):
                return []
        results = []
        for rec in self._validation_embeddings:
            try:
                img = self.predict_from_embeddings(
                    dict(rec["emb"]), rec["height"], rec["width"],
                    num_inference_steps=vcfg.num_inference_steps, guidance=vcfg.guidance,
                    true_cfg_scale=vcfg.true_cfg_scale)
                results.append((rec["index"], np.asarray(img)))
            except Exception as e:
                if vcfg.fail_on_error:
                    raise
                logging.warning("validation sample %d failed: %s", rec["index"], e)
        if collectives.process_count() > 1:
            # every rank sampled its dp index's shard; gather the images so the
            # main rank's logger writes all of them (one copy of each: the
            # first fsdp / sp rank of each dp index contributes)
            mesh = self.mesh
            lead = all(mesh.coords[a] == 0 for a in ("fsdp", "tp", "sp"))
            mine = results if lead else []
            try:
                idxs, imgs = collectives.gather_validation_images(
                    [i for i, _ in mine], [im for _, im in mine],
                    n_total=len(self._validation_prompts))
                results = list(zip(idxs, imgs))
            except Exception as e:
                if vcfg.fail_on_error:
                    raise
                logging.warning("validation image gather failed (%s); logging only this "
                                "rank's shard", e)
        prompts = getattr(self, "_validation_prompts", None) or []
        for idx, img in results:
            self.logger.log_images(f"validation/sample_{idx}", list(img), self.global_step)
            if idx < len(prompts):
                self.logger.log_text(f"validation/prompt_{idx}", prompts[idx], self.global_step)
        return results
