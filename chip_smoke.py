#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qflux_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full width with synthetic weights from a seed.  FLUX.1-Kontext-dev (19 dual + 38 single blocks, bf16, a rank-16 LoRA
on to_q/to_k/to_v/to_out, 512² target with one 512² control image and 512
T5 tokens, S = 2560): predict from cached embeddings (20 Euler steps, full
f32 VAE decode) and the LoRA train step from cached embeddings (MseLoss,
optax.adamw defaults, remat "flash").  Qwen-Image-Edit (the 20B DiT: 60
dual-stream blocks, dim 3072, over the int4-requant base of
configs/example_qwen_single_chip_832x576.yaml as published, quantize.attention
on; 832×576 target with one control image and 256 Qwen2.5-VL tokens, S =
4000, where int8 attention does not apply and the fused K1 / K2 do not
either, so attention runs as JAX runs it on one chip: the plain norm + rope,
then kernels K3 / K4 in bf16 — path B):
predict from cached embeddings, and the LoRA train step from cached
embeddings over the same base (the config's rank-16 LoRA on the eight
attention projections, logit_normal σ, optax.adamw at lr 1e-4, MseLoss,
clip 1.0, remat "flash_offload"); then the same model at the config's 512²
operating point (S = 2304, remat "flash"), where its int8 attention runs
the s_int8 modes of K1 and K2 (path A); then the same DiT over the W4A16
`int4` base (the config with quantize.dtype int4 and attention off) at 512²
with QFLUX_FUSED_INT4=1, where every GEMM that JAX's fused kernel takes
runs K6a and its dx K6b (path C).  In phases:

  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: the hand-written kernels from qflux_tpu_torch/csrc;
  3. kernel K1 (csrc/flash_nr_fwd.cu, bf16 mode) against its plain PyTorch
     version on the card, at the main paths' shapes (FLUX's S = 2560, path
     C's S = 2304 with Qwen's text padding) and at longer/masked ones, two
     calls identical to the bit, with the times of the public op, of the
     kernel alone (its kn prep apart) and of the wrapper's host work;
  4. kernel K2 (csrc/flash_nr_bwd.cu, bf16 mode) against its plain version
     (f32 autograd through the plain forward) at the same six shapes, with
     nonzero cotangents on padded rows, two calls identical to the bit,
     timed alone (its prep apart) and through its wrapper beside its bound
     (TFLOP/s and share of the bound per case);
 4a. kernel K3 (csrc/flash_fwd.cu) against its plain version at path B's
     shape (S = 4000, 26 padding tokens) at bs=1 and 2, an unmasked S =
     4096, a masked S = 8704 and a ring hop's Sq = Sk = 2000 with other q /
     kv ids, two calls identical to the bit, timed alone and through its
     wrapper beside its bound (TFLOP/s and share of the bound per case) and
     SDPA flash; at path B's shape also the fused K1 on the raw q / k
     against the norm + rope and K3;
 4b. kernel K4 (csrc/flash_bwd.cu) against its plain version (the explicit
     formula from the residuals) at the same shapes, nonzero cotangents on
     padded rows, two calls identical to the bit, timed alone and through
     its wrapper (device and host time) beside its bound and SDPA flash's
     backward;
  5. predict: one full-width forward through K1 and through the plain
     attention (relative L2 error), then three requests through
     Trainer.predict_from_embeddings, each checked for uint8 images, finite
     latents and exactly 57 × 20 K1 launches, then a profiled denoising
     step;
  6. train: one full-width step's LoRA gradients through K1 + K2 and
     through the plain attention (relative L2 error), then Trainer.fit at
     bs=1 and bs=2, checked for finite losses, a LoRA b that moved, and
     exactly 57 K1 and 57 K2 launches per step, then a profiled train step;
  7. kernel K5a (csrc/rq_int4_fwd.cu: a regrid pass, then an int8 `wgmma`
     GEMM) against its plain version at every int4-requant GEMM shape of the
     Qwen forward (exact: max |diff| = 0; two calls identical), timed alone
     with the weights rotated past L2 beside the bound and torch._int_mm,
     and the row quantization before it (csrc/rowquant.cu) against
     quant._rowquant to the bit, timed alone beside it;
  8. Qwen predict (the FLUX model freed first): one full-width forward
     through K5a + K3, through the plain requant route + K3 (identical to
     the bit) and all plain (relative L2 error), then two requests (bs=1
     and bs=2) through Trainer.predict_from_embeddings, each checked for uint8
     images, finite latents and exactly 60 K3 and 723 K5a launches per
     forward (no K1, no s_int8);
  9. kernel K5b (csrc/rq_int4_bwd.cu), the requant matmul's backward,
     against its plain version at the dx of every K5a case and of the bs=2
     MLP down-projection (exact: max |diff| = 0; two calls identical), timed
     as K5a, with the row quantization of g · s_vec;
 10. Qwen train (the predict phase's model): one full-width step's LoRA
     gradients through K5a + K5b + K3 + K4 under "flash_offload" against
     the plain requant route + plain attention under "full" (relative L2
     error), with exact launch counts; "flash_offload" against "flash" at
     bs=1 and bs=2 (gradients identical to the bit, device memory after the
     forward); then Trainer.fit at bs=1 and bs=2, checked for finite
     losses, LoRA b that moved, and exactly 60 K3, 60 K4, 1,443 K5a and 712
     K5b launches per step (no K1 / K2, no s_int8 launch); then a one-step
     torch.profiler breakdown;
 11. K1 and K2 in their s_int8 mode against their plain versions at three
     shapes (the prep's int8 operands to the bit, two calls identical),
     each timed alone (its prep apart) beside its bound, bf16 K1 / K2
     alone, the wrapper and SDPA flash;
 12. Qwen 512² predict with int8 attention (path A: path B's
     configuration at full width cut to 6 of its 60 blocks, AC_BLOCKS,
     for the smoke's time budget): a forward through K1 s_int8 against
     the plain int8 attention, two requests with exactly 6 K1 s_int8 and
     75 K5a launches per denoising step, and a profiled step;
 13. Qwen 512² train (path A): one step's LoRA gradients through the
     kernels against the plain int8 attention, then Trainer.fit at bs=1
     and bs=2 with exactly 6 K1 s_int8, 6 K2 s_int8, 147 K5a and 64
     K5b launches per step, then a profiled step;
 14. kernel K6a (csrc/int4_fwd.cu), the W4A16 matmul, against its plain
     version (the int4-requant model freed first) at every GEMM shape of
     path C that `supports` admits, M in {1, 2, 256, 2048, 4096} (relative
     L2 4e-3, max 2 bf16 ulps) and two calls identical to the bit, with
     times of the kernel alone (its share of the bound, its factor against
     cuBLAS on the dequantized weight) beside the wrapper's device and host
     time, the plain version, cuBLAS and JAX's default dequant route;
 15. kernel K6b (csrc/int4_bwd.cu), its backward, in the same way at the dx
     of every K6a case; then the two wrappers' host time per call at the
     main shape and at M = 1;
 16. Qwen 512² predict over the int4 base (path C, cut to 6 of the 60
     blocks as path A): a forward through K6a + K1 against the
     plain W4A16 route and against the default dequant route (which
     launches no K6a), three requests with exactly 6 K1 and 85 K6a
     launches per denoising step, a profiled step;
 17. Qwen 512² train over the int4 base (path C): one step's LoRA
     gradients through K6a + K6b + K1 + K2 against the plain path, then
     Trainer.fit at bs=1 and bs=2 with exactly 6 K1, 6 K2, 157 K6a and
     63 K6b launches per step, then a profiled step.

The file layer (checkpoints, resume, weights and LoRA files) runs as three
more phases, A and B after 6 (on its FLUX model), C after 13 (on its Qwen
model), each with the card's name and power limit on every line:

  A. FLUX save / resume at full width and depth: Trainer.fit over four
     identical bs=1 batches with a checkpoint at step 2, a second Trainer
     resumed from checkpoint-2 (steps 3-4, exactly 2 × 57 K1 and K2
     launches) ending with the first run's LoRA and AdamW moments to the
     bit, the checkpoint files and state.json as the JAX trainer writes
     them, the save and the resume's load timed, and a 20-step predict
     with the LoRA read from checkpoint-last-4's file equal to the bit to
     the one with the in-memory LoRA;
  B. FLUX.1-Kontext-dev weights from files: a state dict drawn from a seed
     in the diffusers names and published shapes, cut to 2 dual + 2 single
     blocks, written as two bf16 shards with the index and an f32 VAE,
     loaded through Trainer.load_model block by block (write and load
     times, GB/s and the host's peak RSS during the load), every parameter
     equal to the bridge's load of the whole dict's conversion, the forward
     within FORWARD_REL_TOL of the plain attention, and a 4-step 512²
     predict with 4 × 4 K1 launches;
  C. Qwen-Image-Edit weights from files over the int4-requant base (4 of 60
     blocks): block 0 quantized on the card equal to its quantization on
     the CPU, every quantized leaf equal to quantize_tree of the in-memory
     conversion, a 2-step 832×576 predict with exact K3 / K5a counts; then
     the full-depth model's trained LoRA written to a file and read back
     into a fresh LoRA, whose 2-step predict equals the in-memory one's to
     the bit (the Qwen name maps and the q/k permutation on the card).

The data layer and the CLI run as phase D, in two parts, with the card's
name and power limit on every line and the phase's wall time printed:

  D. (a) after B, the FLUX model freed: a 6-sample FLUX embedding cache in
     configs/example_multiresolution.yaml's buckets (512², 768×512,
     512×768) written with the port's EmbeddingCacheManager beside a folder
     of PNGs, then `qflux_tpu_torch.main.main` in process on that config
     (JSON, full width and depth, bs=2, 3 steps), bucketed and then padded
     (segment ids, AttentionMaskMseLoss): per step the exact K1 / K2 (S =
     2560) or K3 / K4 (S = 3584) launches, finite losses, the events file's
     loss scalars read back, checkpoint-last-3; then the padded run's
     full-width mixed-batch forward against the plain attention and against
     each sample alone, and its LoRA gradients through K3 + K4 (per-sample
     segment ids) against the plain attention's; the cache's write time and
     the loader's host time a batch; (b) after C, on path B's model: Trainer.fit(DataLoader(...))
     over an 832×576 and a 512² sample padded to S = 4000, two bs=2 steps
     with exact K3 / K4, K5a, K5b and row-quantization launches.

The quantized bases that JAX runs in XLA run as phase E, after 17 (the int4
model freed first), with the card's name and power limit on every line and
the phase's wall time printed:

  E. (a) the repair's probe (the int4 group scales of one weight with the
     old Python-scalar divisor on the card and on the CPU, and the repaired
     `quantize_kernel_int4`), then every quantized form's leaves quantized
     on the card and on the CPU at a full-width FLUX dual block, equal to
     the bit; the W8A8 matmul (csrc/int8_gemm.cu's GEMM, forward and dx,
     and its transpose) against its plain version at FLUX's 512² shapes
     and two ragged row counts (forward and dx equal to the bit, two calls
     identical), each timed alone beside torch._int_mm, cuBLAS bf16 on the
     dequantized weight and the weight-only route; int4_dynamic's group
     products;
     (b) FLUX.1-Kontext-dev at full width and depth over int8_dynamic: a
     forward through K1 and the W8A8 kernels against the plain W8A8 route,
     a 20-step bs=1 request, a profiled denoising step, one step's LoRA
     gradients against the plain path, and Trainer.fit for 4 bs=1 steps,
     each with exact K1 / K2 / W8A8 / row-quantization counts derived from
     the model (`_flux_w8_counts`), beside the bf16 base's numbers;
     (c) FLUX at full width, 2 dual + 2 single blocks, over int8, fp8_e4m3,
     fp8_e5m2 and int4_dynamic: card against CPU quantization, a forward
     and one step's LoRA gradients against the dequantized base, a fit
     step;
     (d) the 20B Qwen-Image-Edit DiT at full depth over int8 weight-only: a
     4-step 512² request through K1, its peak memory and s/request.

The FLUX.1-Kontext cache pass and the raw-image entry points run as phase
F, last, with the card's name and power limit on every line and the
phase's wall time printed:

  F. (a) the repair probe: the W8A8 matmul (forward, and the dx whose row
     quantization of g · s_w runs over N = 18,432) and int4_dynamic (whose
     dx contracts over N past 16,513 terms) at the AdaLN mods' shape with
     33 rows, 3072 → 18432, each equal to its plain version (float64
     products on the card) to the bit, forward and dx, and timed;
     int4_dynamic's dx equal to the CPU's to the bit and its forward within
     one bf16 ulp of it; (a') the image decoders over the committed 512²
     fixtures of tests/fixtures/images (written by
     scripts/make_image_fixtures.py: baseline 4:2:0, progressive, 4:4:4
     with restart markers and optimized tables, 4:2:2, 4:4:0 and Adobe RGB
     JPEGs, a 24-bit BMP, a PNG): each JPEG decoded by the native decoder
     (csrc/jpeg_decode.cu, host code in the kernel library) and by the
     plain Python one, equal to the bit, and every decode equal to the
     committed digest of cv2's, images and masks, with host ms a decode for
     each path; (b) FLUX.1-Kontext-dev at full width (19 +
     38 blocks, the full VAE, CLIP-L, T5-XXL at 512 tokens, synthetic
     weights) through `qflux_tpu_torch.main` in process: `--cache` over
     the four target / control pairs of those fixtures listed in a CSV
     (read through the native JPEG decoder: the nine cached keys at JAX's
     shapes, s per sample, peak memory), then the first
     sample's prompt embeds, pooled output and target / control latents
     computed whole on the CPU (CLIP-L, all 24 T5-XXL blocks at 512
     tokens, the VAE encoder at 512²), against which the card's f32
     outputs and the fp16 arrays `--cache` wrote are held, and each
     encoder timed on the card; (c) + (e) a fit
     of three steps from that cache (57 K1 and 57 K2 launches a step) whose
     validation section samples once at the last step (57 K1 a denoising
     step) and logs the image; (d) `--predict` on the 4:2:2 JPEG control,
     20 steps at 512² (57 K1 a step), the output PNG [512, 512, 3] uint8
     with finite latents, and a second request on the loaded model timed.
     `python3 chip_smoke.py --decode` runs (a') alone.

The Qwen-Image-Edit cache pass and `predict_multires` run as phase G,
after F, with the card's name and power limit on every line and the
phase's wall time printed:

  G. configs/example_qwen_single_chip_832x576.yaml as published (the 60-block
     DiT over int4_requant with attention: true, flash_offload, the full
     Qwen VAE, Qwen2.5-VL with 32 vision blocks × 1,280 and 28 LM layers ×
     3,584; synthetic weights drawn on the card from seeds, the hash
     tokenizer) through `qflux_tpu_torch.main` in process: (a) `--cache`
     over two 832×576 target / control PNG pairs in a CSV (JAX's seven
     keys at JAX's shapes, s per sample, peak memory, no kernel launched),
     then the first sample computed whole on the CPU (the vision tower, all
     28 LM layers streamed one layer at a time, the VAE encoder at
     832×576), against which the card's f32 outputs and the fp16 arrays
     `--cache` wrote are held, each module timed on the card; (b) a fit of
     two bs=1 steps from that cache (60 K3, 60 K4, 1,443 K5a, 712 K5b a
     step) whose validation samples after each step (two steps, 60 K3
     and 723 K5a each), Qwen2.5-VL built once, for the validation set-up
     after step 1, and freed before step 2 (whose peak memory stays below
     the VL's bytes); (c) `--predict` on a raw 832×576 PNG, four steps,
     the PNG [832, 576, 3] uint8; (d) `predict_multires` over an 832×576
     and a 512² item on that model, and FLUX.1-Kontext's over a 512² and a
     768×512 item, two steps each, one padded batch, outputs at each
     item's size; (e) every kernel (a)-(d) launched held to its plain
     version at each shape they launched it at (recorded by wrapping the
     launchers), K3 / K4 with the path's own segment ids.

The remat policies, the out-of-memory fallback and adamw8bit run as phase
I, after H, each line with the card's name and power limit and the phase's
wall time printed (`python3 chip_smoke.py --remat` runs phase I alone):

  I. (a) FLUX.1-Kontext-dev at full width (19 + 38 blocks, bf16, 512² with
     one control, S = 2,560): one bs=1 step's LoRA gradients at a fixed
     noise and σ under every policy (full, flash, flash_offload, dots,
     dots_all, flash_qkv, flash_mlp, flash_single), each equal to "full"'s
     to the bit; then each of full, dots, dots_all, flash_qkv, flash_mlp
     and flash_single at bs=1 and bs=2, one warm step and two timed ones:
     ms per step, peak memory, and K1 / K2 a step (114 / 57 under full,
     dots, dots_all; 57 / 57 under flash_qkv, flash_mlp; 76 / 57 under
     flash_single); (b) the 20B Qwen DiT over int4_requant cut to 12 blocks
     at 832×576 (S = 4,000, K3 / K4), bs=1, one step each under full, dots
     and flash_mlp: gradients equal to "full"'s to the bit, K5a 291 / 147 /
     267 a step, K3 24 / 24 / 12, K4 12, K5b 136, then every kernel held to
     its plain version at the shapes the steps launched it at; (c) the
     process capped (`torch.cuda.set_per_process_memory_fraction`, lifted
     after) half-way between (a)'s bs=2 peaks of full and dots:
     `Trainer.fit` under mesh.remat: minimal at bs=2 runs out of memory,
     warns, degrades to "full" once and finishes its steps; (d)
     `Trainer.fit` with optimizer.class_path
     qflux_tpu.ops.adam8bit.adamw8bit, four bs=1 steps: finite, moving
     losses, the fp8 state's bytes beside AdamW's, and one more update on
     the card against the same update on the CPU, to the bit.

The optax optimizers and async checkpointing run as phase J, after I, each
line with the card's name and power limit and the phase's wall time
printed (`python3 chip_smoke.py --optim` runs phase J alone):

  J. on FLUX.1-Kontext-dev at full width (19 + 38 blocks, bf16, 512² with
     one control, S = 2,560): (a) optax.adamw (and with nesterov, eps_root
     and a bf16 mu), optax.adam, optax.lion, optax.sgd (nesterov momentum)
     and optax.contrib.prodigy over the full-width LoRA and its scaling
     leaves, five updates on the card and on the CPU from seeded
     gradients: the largest relative error of the parameters and of the
     state (the elementwise optimizers to the bit, Prodigy within 1e-5),
     ms per update on the card; (b) `Trainer.fit`, three bs=1 steps under
     Prodigy and under Lion: finite losses, every LoRA tensor moved, K1 /
     K2 a step as counted; (c) a four-step fit with a checkpoint every two
     steps, synchronous and async: every file equal byte for byte, the
     train thread's blocked ms per save, and a run resumed from the async
     checkpoint-2 equal to the uninterrupted one to the bit.

Phase K (attention in f32 and the narrow modes, the f32 FLUX fit, variant
test, the tokenizers; `--f32` alone) runs after J.  Multi-GPU distribution
runs last, as phase L (`python3 chip_smoke.py --dist` runs it alone), on
the one card as a world of one (NCCL refuses two ranks on one device):

  L. (a) FLUX.1-Kontext-dev at full width, Trainer.fit 2 steps at bs=2
     with no process group, then inside init_process_group("nccl",
     world_size=1) with the base sharded by FSDP2 over the one-rank fsdp
     group (K1 / K2 and cuBLAS read what FSDP2 unshards): the losses and
     the LoRA held to each other (the largest difference printed; 0 is
     expected), 57 / 57 K1 / K2 launches a step; (a′) path A's model (the
     20B Qwen over int4_requant cut to AC_BLOCKS) one fit step at 512² the
     same two ways, K5a / K5b (24n + 3 / 12n − 8) and K1 / K2 s_int8 as
     counted unsharded; (b) `ring_attention_sharded` over the one-rank sp
     group at S = 4,000, H = 24, D = 128, bf16, 26 masked rows, forward and
     backward: out, dq, dk and dv equal to K3 / K4's to the bit, one K3 and
     one K4 launch, the ring's ms against K3 + K4 alone; then
     `python -m qflux_tpu_torch.main --distributed` as a subprocess with
     torchrun's variables for a world of one (variant test, 2 steps): one
     run dir, one checkpoint.

Every temporary file (the fits' run dirs included) is removed before the
smoke exits.  Each path runs with the launch counts set to 0 just before
it and read just after.

    python3 chip_smoke.py --ab PARENT

is a measurement, not the smoke: K1 and K2 (bf16 and s_int8), K3, K4, K5a
and K5b alone before and after on one card (PARENT an unpacked checkout of
an earlier commit, e.g. from git archive), the K1 / K2 bf16, K3, K4, K5a /
K5b and K6a / K6b outputs and the s_int8 prep's operands compared to the
bit across the two, and the change's K1 / K2 s_int8 checked against their
plain versions and for repeatable bits (`ab_main`).

    python3 chip_smoke.py --data-ab

is a measurement too: a full-width FLUX fit over the DataLoader against
the same batches handed in as a list, in turns (`data_ab_main`).

The smoke prints the kernel
table as one JSON line before the last (each kernel's time, the bound for the same work on this card's published peaks,
the plain version's time and one PyTorch call's time as a yardstick), the
wall time, and as the last line {"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}.  Exits non-zero, without that line, if there is
no CUDA device or any phase fails.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

# K1's output is bf16: one ulp at magnitude 1 is 2^-8 = 3.9e-3.  The kernel
# and the plain version round p to bf16 at different points (online softmax
# against the running max vs. the normalised probabilities) and sum in other
# orders, so allow 4 ulps at magnitude 1 (|out| < 1 at these inputs).
OUT_ATOL = 1.6e-2
# lse is f32 and its inputs (the bf16 normed q/k) are the same on both sides:
# only the order of the f32 sums differs.
LSE_ATOL = 1e-4
# Full-width forward, K1 vs plain attention, relative L2 error of the bf16
# velocity: each of the 57 attention calls differs by ~1 bf16 ulp (2^-8
# relative) and the residual stream carries those differences through the
# later blocks; 3e-2 is ~8 ulps, loose enough for that and far below the
# O(1) error of a wrong kernel.
FORWARD_REL_TOL = 3e-2
# K2 against its f32 plain version, per gradient.  dq/dk/dv leave the kernel
# in bf16 (one ulp is 2^-8 = 3.9e-3 relative) and the kernel rounds p and ds
# to bf16 before their products, as the TPU kernel does: measured ~4.8e-3
# relative L2 on every gradient.  1.5e-2 is ~3x that, and far below the
# O(1) error of a wrong or missing term.  The scale-pair gradients are f32
# sums over all rows of those bf16-rounded products: the same bound.
BWD_REL_TOL = 1.5e-2
# and elementwise, against the largest |gradient| of the same tensor (the
# max error sits on large elements: measured ~6e-3 of max |ref|)
BWD_MAX_TOL = 2e-2
# Full-width LoRA gradients, K1 + K2 vs the plain attention under autograd,
# relative L2 over every a and b: the two paths round to bf16 at different
# points in each of the 57 blocks' backward (the plain path at every cast of
# the norm / rope chain, the kernels only at their outputs), and the
# residual stream carries those differences through the earlier blocks.
# 1e-1 is loose for that and far below the error of a lost attention
# gradient (q/k/v LoRA gradients at 0, relative error ~1).
GRAD_REL_TOL = 1e-1
# Full-width Qwen LoRA gradients, K5a + K5b + K1 + K2 vs the plain requant
# route + plain attention: K5a and K5b equal the plain requant matmul and its
# backward to the bit given the same operands, so the paths differ by the
# attention's bf16 rounding points only, as in GRAD_REL_TOL's case, over 60
# blocks; a difference then moves some activations and cotangents across an
# int8 step of their row quantization, which adds noise of the same order.
# The same 1e-1 bound, for the same reason: a lost gradient term gives ~1.
QWEN_GRAD_REL_TOL = 1e-1
STEPS = 20
# path B's two requests: 8 denoising steps each (a step's launches and time do
# not depend on the count; fewer steps leave the smoke's time to phase H)
B_STEPS = 8
HEIGHT = WIDTH = 512
TRAIN_STEPS = 4  # Trainer.fit steps at each batch size (FLUX, path C)
# paths B and A, cut to stay within the smoke's time budget as path C was
# added: two fit steps at each batch size and one request at each
EARLIER_TRAIN_STEPS = 3
# Qwen-Image-Edit: configs/example_qwen_single_chip_832x576.yaml as the port
# reads it, with one cut: no checkpoint path (the weights are synthetic, from
# a seed).  quantize.attention is on, as in the file: at 832×576 (S = 4000)
# it runs bf16 attention, as on the TPU, and at the 512² operating point its
# comment names (S = 2304) the int8 score GEMM.  Written out here because the
# card's machine has no PyYAML; tests/test_torch_qwen.py holds it to the
# YAML file.
QWEN_832X576 = {
    "trainer": "QwenImageEditTrainer",
    "mesh": {"dp": 1, "fsdp": 1, "tp": 1, "remat": "flash_offload"},
    "model": {"lora": {"r": 16, "lora_alpha": 16},
              "quantize": {"enabled": True, "dtype": "int4_requant", "attention": True}},
    "optimizer": {"class_path": "optax.adamw", "learning_rate": 1.0e-4},
    "train": {"max_train_steps": 5000, "checkpointing_steps": 500, "weight_dtype": "bfloat16",
              "timestep_sampling": "logit_normal"},
    "logging": {"output_dir": "/tmp/qwen_832", "project": "qwen_832x576"},
}
QWEN_HEIGHT, QWEN_WIDTH = 832, 576
QWEN_TXT, QWEN_TXT_PAD = 256, 26  # Qwen2.5-VL tokens, the last 26 padding
# the K5a cases: every (K, N) of an int4-requant GEMM of the Qwen forward
# (block projections, MLP up / down, txt_in, img_in, proj_out) at the image
# stream's and the text stream's rows for bs=1, and the MLP up at bs=2
RQ_KN = [(3072, 3072), (3072, 12288), (12288, 3072), (3584, 3072), (64, 3072), (3072, 64)]
RQ_CASES = [(m, k, n) for m in (3744, 256) for k, n in RQ_KN] + [(7488, 3072, 12288)]
RQ_MAIN = (3744, 3072, 12288)  # the case the kernel table reports
# the K5b cases: the dx (g [M, N] → dx [M, K]) of every K5a case and of the
# bs=2 MLP down-projection; the table reports the dx of RQ_MAIN
RQ_BWD_CASES = RQ_CASES + [(7488, 12288, 3072)]
# `--ab`'s K5a / K5b cases: the main one (and its dx), the block projections'
# image-stream GEMM (8 of a block's 12) and the text stream's MLP down (split)
AB_RQ_CASES = [RQ_MAIN, (3744, 3072, 3072), (256, 12288, 3072)]
# the card's published peaks (NVIDIA H100 SXM data sheet, dense), for bounds
PEAK_BYTES_PER_MS = 3.35e9
PEAK_BF16_PER_MS = 989e9
PEAK_INT8_PER_MS = 1979e9
# f32-accurate products on the tensor cores: three TF32 products (495 TFLOP/s
# dense) a product, the 3xTF32 split csrc/flash_f32_fwd.cu runs
PEAK_F32_SPLIT_PER_MS = 495e9 / 3
# the SFU's ex2 (one a softmax score): 16 a clock on each of 132 SMs at the
# same 1.98 GHz as the two rates above; not a data-sheet number.  An ex2
# emulated by a polynomial on the FMA pipe (which no kernel here does) would
# add to this rate, so a time from it is the floor of the SFU's exponentials
PEAK_EXP_PER_MS = 16 * 132 * 1.98e6
# the f32 modes (csrc/flash_f32_fwd.cu, csrc/flash_f32_bwd.cu; their prep and rope +
# norm backward in csrc/flash_simt.cu) against their plain versions on the card
# (relative L2): the same f32 arithmetic summed in another order, exp and
# rsqrt an ulp apart: out and lse within 2e-5, and the gradients, sums of
# five products (and the rope + norm backward), within 1e-4
F32_REL_TOL = 2e-5
F32_GRAD_TOL = 1e-4


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def _median_ms(fn, n=10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _bound(n_bytes: float, n_ops: float, peak_ops_per_ms: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_MS, n_ops / peak_ops_per_ms
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def _sdpa_flash_ms(qn, kn, v, do=None) -> float:
    """One PyTorch call for the same attention on the already normed and
    roped q/k: scaled_dot_product_attention on its flash backend (its
    backward with `do`).  A yardstick only: the port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, vv = (t.transpose(1, 2) for t in (qn, kn, v))  # [B, H, S, D]
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        if do is None:
            with torch.no_grad():
                return _median_ms(lambda: F.scaled_dot_product_attention(q, k, vv))
        q, k, vv = (t.detach().requires_grad_() for t in (q, k, vv))
        out = F.scaled_dot_product_attention(q, k, vv)
        g = do.transpose(1, 2)
        return _median_ms(lambda: torch.autograd.grad(out, (q, k, vv), g, retain_graph=True))


def _attn_inputs(gen, b, s, h=24, d=128, dtype=torch.bfloat16):
    dev = "cuda"
    q, k, v = (torch.randn(b, s, h, d, device=dev, generator=gen).to(dtype) for _ in range(3))
    qs2 = (1 + 0.1 * torch.randn(2, d, device=dev, generator=gen)).to(dtype)
    ks2 = (1 + 0.1 * torch.randn(2, d, device=dev, generator=gen)).to(dtype)
    ang = torch.rand(s, d // 2, device=dev, generator=gen) * 6.28
    cos = torch.cat([ang.cos()] * 2, -1).contiguous()
    sin = torch.cat([ang.sin()] * 2, -1).contiguous()
    return q, k, v, qs2, ks2, cos, sin


CASES = [  # name, B, S, st, segment ids
    ("dual_512sq", 1, 2560, 512, None),
    ("single_512sq", 1, 2560, 0, None),
    ("masked_bs2", 2, 2560, 512, "masked"),
    ("832x576", 1, 4256, 512, None),
    ("s8192", 1, 8192, 512, None),
    # path C's bf16 shape: Qwen 512^2 over the int4 base, 26 padding text tokens
    ("qwen_512sq_int4", 1, 2304, 256, "text_pad"),
]


def _segments(seg_kind, b, s):
    if not seg_kind:
        return None
    seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
    if seg_kind == "text_pad":  # the Qwen text stream's padding tokens
        seg[:, QWEN_TXT - QWEN_TXT_PAD:QWEN_TXT] = 0
        return seg
    seg[0, 2100:] = 0          # sample 0 padded from token 2100
    seg[1, 1300:] = 2          # sample 1: two segments
    return seg


def _pad_rows(seg_kind):
    """The rows of sample 0 that `_segments(seg_kind, ...)` pads."""
    if seg_kind == "text_pad":
        return slice(QWEN_TXT - QWEN_TXT_PAD, QWEN_TXT)
    return slice(2100, None)


def _window_ms(fn, reps=20, n=5) -> float:
    """Device time per call of `fn`: the median over n windows of `reps`
    back-to-back calls between CUDA events (no host gap inside a window
    once the queue fills)."""
    return _rotating_ms(lambda i: fn(), 1, reps=reps, n=n)


def _k1_alone(args, st, seg, scale, reps=20) -> dict:
    """K1's bf16 mode alone: `ms`, the device time of the C entry point (the
    kn prep and the main kernel) on checked arguments into preallocated
    outputs and scratch, back to back; `prep_ms`, the prep alone, where the
    library has it (else None); and `wrapper_host_us`, the host time per call
    of `_flash_nr_cuda`.  Uses only `_kernel_args`, the C signature and
    `_flash_nr_cuda`, so the same function times an earlier checkout's
    package put first on sys.path (the --ab mode)."""
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.runtime.build import load_library

    q, k, v, qs2, ks2, cos, sin = args
    qs, ks, cs_bstride, seg32 = flash_nr._kernel_args(q, k, v, qs2, ks2, cos, sin, seg)
    b, s, h, _ = q.shape
    lib = load_library().lib
    kn, out = torch.empty_like(k), torch.empty_like(q)
    lse = torch.empty((b, h, s), device="cuda", dtype=torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    segp = None if seg32 is None else seg32.data_ptr()
    ms = _window_ms(lambda: lib.qflux_flash_nr_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), cs_bstride, segp, kn.data_ptr(), None, None, 0, out.data_ptr(),
        lse.data_ptr(), b, s, h, st, scale, stream), reps)
    prep_ms = None
    if hasattr(lib, "qflux_flash_nr_kn_prep"):
        prep_ms = _window_ms(lambda: lib.qflux_flash_nr_kn_prep(
            k.data_ptr(), ks.data_ptr(), cos.data_ptr(), sin.data_ptr(), cs_bstride,
            kn.data_ptr(), b, s, h, st, stream), reps)
    host_us = _host_us(lambda: flash_nr._flash_nr_cuda(*args, st, seg, scale))
    return {"ms": ms, "prep_ms": prep_ms, "wrapper_host_us": host_us}


def _k4_alone(q, k, v, q_seg, kv_seg, out, lse, do, scale, reps=5) -> dict:
    """K4 alone: `ms`, the device time of the C entry point (delta, dk / dv,
    dq) into preallocated outputs and scratch, back to back, and
    `wrapper_host_us`, the host time per call of `_flash_bwd_cuda`; like
    `_k1_alone`, usable on an earlier checkout's package."""
    from qflux_tpu_torch.ops import flash_attention as fa
    from qflux_tpu_torch.runtime.build import load_library

    b, sq, h, _ = q.shape
    lib = load_library().lib
    delta = torch.empty((b, h, sq), device="cuda", dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    qp, kp = ((None, None) if q_seg is None else
              (q_seg.to(torch.int32).contiguous(), kv_seg.to(torch.int32).contiguous()))
    stream = torch.cuda.current_stream().cuda_stream
    hd = _head_dim_arg(lib.qflux_flash_bwd, 19, q)
    ms = _window_ms(lambda: lib.qflux_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if qp is None else qp.data_ptr(),
        None if kp is None else kp.data_ptr(), out.data_ptr(), lse.data_ptr(), do.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], h,
        *hd, scale, stream), reps)
    host_us = _host_us(lambda: fa._flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do, scale),
                       n=50)
    return {"ms": ms, "wrapper_host_us": host_us}


def _k2_alone(args, st, seg, scale, out, lse, do, reps=5) -> dict:
    """K2's bf16 mode alone: `ms`, the device time of the C entry point (the
    prep, dk / dv and dq) on checked arguments into preallocated outputs,
    scratch and partials, back to back; `prep_ms`, the prep alone, where the
    library has it (else None); `wrapper_host_us`, the host time per call of
    `_flash_nr_bwd_cuda`.  Like `_k1_alone`, usable on an earlier checkout's
    package."""
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.runtime.build import load_library

    q, k, v, qs2, ks2, cos, sin = args
    qs, ks, cs_bstride, seg32 = flash_nr._kernel_args(q, k, v, qs2, ks2, cos, sin, seg)
    b, s, h, d = q.shape
    lib = load_library().lib
    qn, kn, dq, dk, dv = (torch.empty_like(q) for _ in range(5))
    delta = torch.empty((b, h, s), device="cuda", dtype=torch.float32)
    parts = torch.empty((2, b, h, lib.qflux_flash_nr_bwd_tiles(s), 2, d), device="cuda",
                        dtype=torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    segp = None if seg32 is None else seg32.data_ptr()
    ms = _window_ms(lambda: lib.qflux_flash_nr_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), cs_bstride, segp, out.data_ptr(), lse.data_ptr(), do.data_ptr(),
        qn.data_ptr(), kn.data_ptr(), delta.data_ptr(), None, None, None, 0, dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), b, s, h, st,
        scale, stream), reps)
    prep_ms = None
    if hasattr(lib, "qflux_flash_nr_bwd_prep"):
        prep_ms = _window_ms(lambda: lib.qflux_flash_nr_bwd_prep(
            q.data_ptr(), k.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), cs_bstride, out.data_ptr(), do.data_ptr(), qn.data_ptr(),
            kn.data_ptr(), delta.data_ptr(), b, s, h, st, stream), reps)
    host_us = _host_us(lambda: flash_nr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do),
                       n=50)
    return {"ms": ms, "prep_ms": prep_ms, "wrapper_host_us": host_us}


def _int8_prep_alone(lib, args, st, rows, reps, out=None, do=None):
    """The s_int8 prep alone through `qflux_flash_nr_int8_prep`, as K1 (out =
    do = None: kn, kq and amax) or K2 (also qn, qq and delta) runs it; None
    where the library's entry predates that form (an earlier checkout in
    --ab)."""
    from qflux_tpu_torch.ops import flash_nr

    if len(lib.qflux_flash_nr_int8_prep.argtypes) != 21:
        return None
    q, k, v, qs2, ks2, cos, sin = args
    qs, ks, cs_bstride, _ = flash_nr._kernel_args(q, k, v, qs2, ks2, cos, sin, None)
    b, s, h, _ = q.shape
    k2 = do is not None
    qn, kn, dl = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty((b, h, s), device="cuda", dtype=torch.float32))
    qq, kq = (torch.empty(q.shape, device="cuda", dtype=torch.int8) for _ in range(2))
    amax = torch.empty((b, h, 1 + -(-s // rows)), device="cuda", dtype=torch.int32)
    stream = torch.cuda.current_stream().cuda_stream
    return _window_ms(lambda: lib.qflux_flash_nr_int8_prep(
        q.data_ptr(), k.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), cs_bstride, out.data_ptr() if k2 else None,
        do.data_ptr() if k2 else None, qn.data_ptr() if k2 else None, kn.data_ptr(),
        dl.data_ptr() if k2 else None, qq.data_ptr() if k2 else None, kq.data_ptr(),
        amax.data_ptr(), b, s, h, st, rows, stream), reps)


def _k1_int8_alone(args, st, seg, scale, rows, reps=20) -> dict:
    """K1's s_int8 mode alone, as `_k1_alone` times the bf16 mode: `ms`, the
    device time of the C entry point (the s_int8 prep and the main kernel)
    on checked arguments into preallocated outputs and scratch, back to
    back; `prep_ms`, the prep alone (`_int8_prep_alone`); `wrapper_host_us`,
    the host time per call of `_flash_nr_cuda`.  Usable on an earlier
    checkout's package (--ab)."""
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.runtime.build import load_library

    q, k, v, qs2, ks2, cos, sin = args
    qs, ks, cs_bstride, seg32 = flash_nr._kernel_args(q, k, v, qs2, ks2, cos, sin, seg)
    b, s, h, _ = q.shape
    lib = load_library().lib
    kn, out = torch.empty_like(k), torch.empty_like(q)
    kq = torch.empty(k.shape, device="cuda", dtype=torch.int8)
    amax = torch.empty((b, h, 1 + -(-s // rows)), device="cuda", dtype=torch.int32)
    lse = torch.empty((b, h, s), device="cuda", dtype=torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    segp = None if seg32 is None else seg32.data_ptr()
    ms = _window_ms(lambda: lib.qflux_flash_nr_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), cs_bstride, segp, kn.data_ptr(), kq.data_ptr(), amax.data_ptr(), rows,
        out.data_ptr(), lse.data_ptr(), b, s, h, st, scale, stream), reps)
    host_us = _host_us(lambda: flash_nr._flash_nr_cuda(*args, st, seg, scale, rows), n=50)
    return {"ms": ms, "prep_ms": _int8_prep_alone(lib, args, st, rows, reps),
            "wrapper_host_us": host_us}


def _k2_int8_alone(args, st, seg, scale, out, lse, do, rows, reps=5) -> dict:
    """K2's s_int8 mode alone, as `_k2_alone` times the bf16 mode: `ms` of the
    C entry point (the s_int8 prep, dk / dv and dq) into preallocated
    outputs, scratch and partials; `prep_ms`, the prep alone with delta
    (`_int8_prep_alone`); `wrapper_host_us` of `_flash_nr_bwd_cuda`.  Usable
    on an earlier checkout's package (--ab)."""
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.runtime.build import load_library

    q, k, v, qs2, ks2, cos, sin = args
    qs, ks, cs_bstride, seg32 = flash_nr._kernel_args(q, k, v, qs2, ks2, cos, sin, seg)
    b, s, h, d = q.shape
    lib = load_library().lib
    qn, kn, dq, dk, dv = (torch.empty_like(q) for _ in range(5))
    qq, kq = (torch.empty(q.shape, device="cuda", dtype=torch.int8) for _ in range(2))
    amax = torch.empty((b, h, 1 + -(-s // rows)), device="cuda", dtype=torch.int32)
    delta = torch.empty((b, h, s), device="cuda", dtype=torch.float32)
    parts = torch.empty((2, b, h, lib.qflux_flash_nr_bwd_tiles(s), 2, d), device="cuda",
                        dtype=torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    segp = None if seg32 is None else seg32.data_ptr()
    ms = _window_ms(lambda: lib.qflux_flash_nr_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), cs_bstride, segp, out.data_ptr(), lse.data_ptr(), do.data_ptr(),
        qn.data_ptr(), kn.data_ptr(), delta.data_ptr(), qq.data_ptr(), kq.data_ptr(),
        amax.data_ptr(), rows, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), parts[0].data_ptr(),
        parts[1].data_ptr(), b, s, h, st, scale, stream), reps)
    host_us = _host_us(lambda: flash_nr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do,
                                                           rows), n=50)
    return {"ms": ms, "prep_ms": _int8_prep_alone(lib, args, st, rows, reps, out, do),
            "wrapper_host_us": host_us}


def _head_dim_arg(entry, n_args, q) -> tuple:
    """(D,) where K3's / K4's C entry takes the head dim (n_args arguments),
    else () (an earlier checkout's entry, D = 128 only, in --ab)."""
    return (q.shape[-1],) if len(entry.argtypes) == n_args else ()


def _k3_alone(q, k, v, q_seg, kv_seg, scale, reps=10) -> dict:
    """K3 alone: `ms`, the device time of the C entry point into
    preallocated out / lse, back to back, and `wrapper_host_us`, the host time
    per call of `_flash_fwd_cuda`; like `_k1_alone`, usable on an earlier
    checkout's package."""
    from qflux_tpu_torch.ops import flash_attention as fa
    from qflux_tpu_torch.runtime.build import load_library

    b, sq, h, _ = q.shape
    lib = load_library().lib
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device="cuda", dtype=torch.float32)
    qp, kp = ((None, None) if q_seg is None else
              (q_seg.to(torch.int32).contiguous(), kv_seg.to(torch.int32).contiguous()))
    stream = torch.cuda.current_stream().cuda_stream
    hd = _head_dim_arg(lib.qflux_flash_fwd, 14, q)
    ms = _window_ms(lambda: lib.qflux_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if qp is None else qp.data_ptr(),
        None if kp is None else kp.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, k.shape[1],
        h, *hd, scale, stream), reps)
    host_us = _host_us(lambda: fa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale), n=50)
    return {"ms": ms, "wrapper_host_us": host_us}


def phase_kernel(card: str) -> dict:
    """K1 (bf16) against flash_attention_nr_reference at CASES: out and lse
    within OUT_ATOL / LSE_ATOL, the fully masked rows at 0, two calls
    identical to the bit; times of the public op, of the kernel alone (prep
    + main kernel, the prep apart: `_k1_alone`), the wrapper's host time and
    the plain version.  Returns the first case's table entry."""
    from qflux_tpu_torch.ops import flash_nr

    gen = torch.Generator("cuda").manual_seed(0)
    main = None
    for name, b, s, st, seg_kind in CASES:
        args = _attn_inputs(gen, b, s)
        seg = _segments(seg_kind, b, s)
        out, lse = flash_nr.flash_attention_nr(*args, st, segment_ids=seg)
        out2, lse2 = flash_nr.flash_attention_nr(*args, st, segment_ids=seg)
        torch.cuda.synchronize()
        same = torch.equal(out, out2) and torch.equal(lse, lse2)
        del out2, lse2
        ref, ref_lse = flash_nr.flash_attention_nr_reference(*args, st, segment_ids=seg)
        err = (out.float() - ref.float()).abs().max().item()
        valid = ref_lse > -1e29
        lse_err = (lse - ref_lse).abs()[valid].max().item()
        ok = (same and err <= OUT_ATOL and lse_err <= LSE_ATOL
              and bool(torch.isfinite(out).all()))
        dead = (~valid).permute(0, 2, 1).all(-1)  # [B, S]: rows every head masks
        ok = ok and not out[dead].any() and (seg_kind is None or bool(dead.any()))
        op_ms = _median_ms(lambda: flash_nr.flash_attention_nr(*args, st, segment_ids=seg))
        alone = _k1_alone(args, st, seg, 128 ** -0.5)
        plain_ms = _median_ms(
            lambda: flash_nr.flash_attention_nr_reference(*args, st, segment_ids=seg))
        gflop = 4.0 * b * 24 * s * s * 128 / 1e9
        ms, prep_ms = alone["ms"], alone["prep_ms"]
        print(f"[kernel] {name}: B={b} S={s} H=24 D=128 st={st} seg={seg_kind or 'none'} "
              f"max_abs_err(out)={err:.3e} (tol {OUT_ATOL}) max_abs_err(lse)={lse_err:.3e} "
              f"(tol {LSE_ATOL}), {int(dead.sum())} fully masked rows at 0, two calls identical "
              f"{same}; kernel alone {ms:.4f} ms ({gflop / ms:.1f} TFLOP/s; prep {prep_ms:.4f} "
              f"ms, main kernel {ms - prep_ms:.4f} ms, {gflop / (ms - prep_ms):.1f} TFLOP/s), "
              f"op {op_ms:.3f} ms, wrapper host {alone['wrapper_host_us']:.1f} us per call, "
              f"plain {plain_ms:.3f} ms [{card}]", flush=True)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version (or with itself) in "
                                 f"case {name}")
        if main is None:  # the dual-block shape of the predict path
            q, k, v, qs2, ks2, cos, sin = args
            qn = flash_nr.apply_qk_norm_rope(q, qs2, cos, sin, st)
            kn = flash_nr.apply_qk_norm_rope(k, ks2, cos, sin, st)
            lib_ms = _sdpa_flash_ms(qn, kn, v)
            # q, k, v, out in bf16, lse f32, cos/sin f32; QK^T and PV
            n_bytes = 4 * b * s * 24 * 128 * 2 + b * 24 * s * 4 + 2 * s * 128 * 4
            main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "prep_ms": prep_ms, "op_ms": op_ms,
                    "wrapper_host_us": alone["wrapper_host_us"],
                    **_bound(n_bytes, gflop * 1e9, PEAK_BF16_PER_MS)}
            print(f"[kernel] {name}: bound {main['bound_ms']:.4f} ms ({main['bound_by']}), "
                  f"SDPA flash on the normed/roped q,k {lib_ms:.3f} ms [{card}]", flush=True)
            del qn, kn
        del args, out, lse, ref, ref_lse
        torch.cuda.empty_cache()
    return main


def _k2_bound(q, seg) -> dict:
    """K2: in q, k, v, out, do bf16, lse f32, cos / sin f32; out dq, dk, dv
    bf16.  The least work is five S x S x D GEMMs (QK^T recomputed once, dP,
    dV, dQ, dK) over the pairs that attend; the kernels do seven."""
    b, s, h, d = q.shape
    n_bytes = 8 * b * s * h * d * 2 + b * h * s * 4 + 2 * s * d * 4
    return _bound(n_bytes, 10.0 * d * h * _attending_pairs(q, q, seg, seg), PEAK_BF16_PER_MS)


def phase_kernel_bwd(card: str) -> dict:
    """K2 against flash_attention_nr_bwd_reference at the K1 cases, do ~ N(0,
    1) on every row (padded ones included), two calls identical to the bit;
    times of the kernel alone (its prep apart: `_k2_alone`) beside the bound
    from the pairs that attend, of the wrapper and of the plain version."""
    from qflux_tpu_torch.ops import flash_nr

    gen = torch.Generator("cuda").manual_seed(1)
    main = None
    for name, b, s, st, seg_kind in CASES:
        args = _attn_inputs(gen, b, s)
        do = torch.randn(b, s, 24, 128, device="cuda", generator=gen).to(torch.bfloat16)
        seg = _segments(seg_kind, b, s)
        scale = 128 ** -0.5
        out, lse = flash_nr._flash_nr_cuda(*args, st, seg, scale)
        got = flash_nr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do)
        torch.cuda.synchronize()
        ref = flash_nr.flash_attention_nr_bwd_reference(*args, st, do, segment_ids=seg,
                                                        scale=scale)
        ok, errs, max_err = True, [], 0.0
        for gname, g, r in zip(("dq", "dk", "dv", "dqs", "dks"), got, ref):
            diff = g.float() - r
            rel = (diff.norm() / r.norm()).item()
            mx = diff.abs().max().item()
            ok = ok and rel <= BWD_REL_TOL and mx <= BWD_MAX_TOL * r.abs().max().item()
            ok = ok and bool(torch.isfinite(g).all())
            if gname in ("dq", "dk", "dv"):
                max_err = max(max_err, mx)
            errs.append(f"{gname} rel {rel:.3e} max {mx:.3e}")
        if seg_kind:
            ok = ok and all(bool((g[0, _pad_rows(seg_kind)] == 0).all()) for g in got[:3])
        again = flash_nr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = ok and same
        del got, ref, again
        torch.cuda.empty_cache()
        op_ms = _median_ms(lambda: flash_nr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse,
                                                                do))
        alone = _k2_alone(args, st, seg, scale, out, lse, do)
        ms, prep_ms = alone["ms"], alone["prep_ms"]
        plain_ms = _median_ms(lambda: flash_nr.flash_attention_nr_bwd_reference(
            *args, st, do, segment_ids=seg, scale=scale), n=5)
        gflop = 14.0 * b * 24 * s * s * 128 / 1e9  # seven S x S x D GEMMs, every pair
        bound = _k2_bound(args[0], seg)
        print(f"[kernel_bwd] {name}: B={b} S={s} H=24 D=128 st={st} seg={seg_kind or 'none'} "
              f"{'; '.join(errs)} (tol rel {BWD_REL_TOL}, max {BWD_MAX_TOL} x max|ref|), two "
              f"calls identical {same}; K2 alone {ms:.4f} ms ({gflop / ms:.1f} TFLOP/s of its "
              f"seven products; prep {prep_ms:.4f} ms, main kernels {ms - prep_ms:.4f} ms), "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
              f"{100 * bound['bound_ms'] / ms:.1f}% of it), wrapper {op_ms:.3f} ms and "
              f"{alone['wrapper_host_us']:.1f} us host per call, plain {plain_ms:.3f} ms "
              f"[{card}]", flush=True)
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version in case {name}")
        if main is None:  # the dual-block shape of the train path
            q, k, v, qs2, ks2, cos, sin = args
            qn = flash_nr.apply_qk_norm_rope(q, qs2, cos, sin, st)
            kn = flash_nr.apply_qk_norm_rope(k, ks2, cos, sin, st)
            lib_ms = _sdpa_flash_ms(qn, kn, v, do)
            main = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "prep_ms": prep_ms, "op_ms": op_ms,
                    "wrapper_host_us": alone["wrapper_host_us"], **bound}
            print(f"[kernel_bwd] {name}: bound {main['bound_ms']:.4f} ms ({main['bound_by']}), "
                  f"SDPA flash backward on the normed/roped q,k {lib_ms:.3f} ms [{card}]",
                  flush=True)
            del qn, kn
        del args, out, lse, do
        torch.cuda.empty_cache()
    return main


# K3 / K4 (ops/flash_attention.py), where JAX's one-chip dispatch runs them.
# Cases: name, B, S, ids.  Path B's shape (S = 4000, the 26 padding text
# tokens 230..255 masked) at bs=1 and 2; an unmasked S = 4096; a masked S =
# 8704, where JAX's backward takes the split K4b / K4c; and a ring hop's
# shape, Sq = Sk = 2000 with other q and kv ids (q: path B's first 2000
# rows; kv: another shard whose last 400 keys belong to a second sample).
# The first is the one the kernel table reports.
FLASH_CASES = [("qwen_832x576", 1, 4000, "text_pad"), ("qwen_832x576_bs2", 2, 4000, "text_pad"),
               ("s4096", 1, 4096, None), ("s8704_masked", 1, 8704, "text_pad"),
               ("ring_hop", 1, 2000, "hop")]


def _flash_case(gen, b, s, ids, h=24, d=128, dtype=torch.bfloat16):
    """q, k, v [B, S, H, D] of `dtype` on the card and the (q, kv) ids, or
    None."""
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    if ids is None:
        return q, k, v, None, None
    q_seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
    q_seg[:, QWEN_TXT - QWEN_TXT_PAD:QWEN_TXT] = 0
    kv_seg = q_seg
    if ids == "hop":
        kv_seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
        kv_seg[:, s - 400:] = 2
    return q, k, v, q_seg, kv_seg


def _attending_pairs(q, k, q_seg, kv_seg) -> int:
    """The (q row, key) pairs the segment mask lets attend, over the batch:
    the work this run's data needs (masked pairs need no product)."""
    if q_seg is None:
        return q.shape[0] * q.shape[1] * k.shape[1]
    return sum(int(((qs == sid).sum() * (ks == sid).sum()).item())
               for qs, ks in zip(q_seg, kv_seg) for sid in torch.unique(qs).tolist() if sid)


def _flash_bound(q, k, q_seg, kv_seg, bwd=False) -> dict:
    """K3: 4·D·H flops per attending pair (QK^T and PV) against q, k, v, out
    (bf16) and lse (f32); K4: 10·D·H per pair (five products) against q, k,
    v, out, do, dq, dk, dv and lse."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_ops = (10 if bwd else 4) * d * h * _attending_pairs(q, k, q_seg, kv_seg)
    n_bytes = ((4 * sq + 4 * sk) if bwd else (2 * sq + 2 * sk)) * b * h * d * 2 + b * h * sq * 4
    return _bound(n_bytes, n_ops, PEAK_BF16_PER_MS)


def _k3_agrees(q, k, v, q_seg, kv_seg, scale):
    """K3 on these inputs against flash_fwd_reference → (ok, max |out
    error|, max |lse error| over the rows that attend anything, the [B, S]
    rows every head masks, out, lse).  ok: out within OUT_ATOL and lse
    within LSE_ATOL (f32 inputs: both errors relative L2, within
    F32_REL_TOL), out finite, the masked rows' lse at -1e30 and their out
    0."""
    from qflux_tpu_torch.ops import flash_attention as fa

    out, lse = fa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
    valid = ref_lse > -1e29
    if q.dtype == torch.float32:  # relative L2, as `_fwd_agrees`
        err, lse_err = _rel(out, ref), _rel(lse[valid], ref_lse[valid])
        ok = err <= F32_REL_TOL and lse_err <= F32_REL_TOL
    else:
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs()[valid].max().item()
        ok = err <= OUT_ATOL and lse_err <= LSE_ATOL
    ok = ok and bool(torch.isfinite(out).all()) and bool((lse[~valid] == -1e30).all())
    dead = (~valid).permute(0, 2, 1).all(-1)
    return ok and not out[dead].any(), err, lse_err, dead, out, lse


def _k4_agrees(q, k, v, q_seg, kv_seg, out, lse, do, scale):
    """K4 on these inputs, twice, against flash_bwd_reference → (ok, the
    errors as text, max |error|, (dq, dk, dv)).  ok: the two calls
    identical, and each gradient finite, within BWD_REL_TOL in relative L2
    and within BWD_MAX_TOL × max |reference| (f32: within F32_GRAD_TOL
    relative L2, `_grad_agrees`)."""
    from qflux_tpu_torch.ops import flash_attention as fa

    got = fa._flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    again = fa._flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    torch.cuda.synchronize()
    ok = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    ref = fa.flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    errs, max_err = [], 0.0
    for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
        g_ok, text = _grad_agrees(g, r, q.dtype == torch.float32)
        ok = ok and g_ok
        max_err = max(max_err, (g.float() - r).abs().max().item())
        errs.append(f"{gname} {text}")
    return ok, "; ".join(errs), max_err, got


def phase_flash_kernel(card: str) -> dict:
    """K3 against flash_fwd_reference at FLASH_CASES (out, lse, the fully
    masked rows at 0, two calls identical to the bit), with the times of the
    kernel alone (`_k3_alone`) beside the bound (from the pairs that attend),
    of the wrapper, of the plain version and of SDPA flash (unmasked: its
    flash backend takes no mask).
    At path B's shape also what following JAX's dispatch costs: the fused
    K1 on the raw q / k against the plain norm + rope and K3."""
    from qflux_tpu_torch.ops import flash_attention as fa
    from qflux_tpu_torch.ops import flash_nr

    gen = torch.Generator("cuda").manual_seed(12)
    scale = 128 ** -0.5
    main = None
    for name, b, s, ids in FLASH_CASES:
        q, k, v, q_seg, kv_seg = _flash_case(gen, b, s, ids)
        ok, err, lse_err, dead, out, lse = _k3_agrees(q, k, v, q_seg, kv_seg, scale)
        ok = ok and (ids is None or bool(dead.any()))
        torch.cuda.empty_cache()
        out2, lse2 = fa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
        torch.cuda.synchronize()
        same = torch.equal(out, out2) and torch.equal(lse, lse2)
        ok = ok and same
        del out2, lse2
        op_ms = _median_ms(lambda: fa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale))
        alone = _k3_alone(q, k, v, q_seg, kv_seg, scale)
        ms = alone["ms"]
        plain_ms = _median_ms(lambda: fa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale),
                              n=5)
        lib_ms = _sdpa_flash_ms(q, k, v)
        bound = _flash_bound(q, k, q_seg, kv_seg)
        tflops = 4.0 * 24 * 128 * _attending_pairs(q, k, q_seg, kv_seg) / ms / 1e9
        print(f"[flash_fwd] {name}: B={b} S={s} H=24 D=128 ids={ids or 'none'} "
              f"max_abs_err(out)={err:.3e} (tol {OUT_ATOL}) max_abs_err(lse)={lse_err:.3e} "
              f"(tol {LSE_ATOL}), {int(dead.sum())} fully masked rows at 0, two calls identical "
              f"{same}; K3 alone {ms:.4f} ms ({tflops:.1f} TFLOP/s of the attending pairs' "
              f"products), bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
              f"{100 * bound['bound_ms'] / ms:.1f}% of it; dense "
              f"{4.0 * b * 24 * s * s * 128 / PEAK_BF16_PER_MS:.4f}), wrapper {op_ms:.3f} ms and "
              f"{alone['wrapper_host_us']:.1f} us host per call, plain {plain_ms:.3f} ms, "
              f"SDPA flash (unmasked) {lib_ms:.3f} ms [{card}]", flush=True)
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version (or with itself) in case "
                                 f"{name}")
        if main is None:
            main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "op_ms": op_ms, "wrapper_host_us": alone["wrapper_host_us"], **bound}
            # following JAX's dispatch at path B's shape: K1 over the raw q / k
            # against the norm + rope (two plain launches chains) and K3
            _, _, _, qs2, ks2, cos, sin = _attn_inputs(gen, b, s)
            st = QWEN_TXT

            def route():
                qn = flash_nr.apply_qk_norm_rope(q, qs2, cos, sin, st)
                kn = flash_nr.apply_qk_norm_rope(k, ks2, cos, sin, st)
                return fa.flash_attention(qn, kn, v, segment_ids=q_seg)

            with torch.no_grad():
                o1, _ = flash_nr.flash_attention_nr(q, k, v, qs2, ks2, cos, sin, st,
                                                    segment_ids=q_seg)
                o3 = route()
                diff = (o1.float() - o3.float())
                rel = (diff.norm() / o1.float().norm()).item()
                k1_ms = _median_ms(lambda: flash_nr.flash_attention_nr(
                    q, k, v, qs2, ks2, cos, sin, st, segment_ids=q_seg))
                route_ms = _median_ms(route)
                norm_ms = _median_ms(lambda: (flash_nr.apply_qk_norm_rope(q, qs2, cos, sin, st),
                                              flash_nr.apply_qk_norm_rope(k, ks2, cos, sin, st)))
            print(f"[flash_fwd] {name}: JAX's one-chip route (plain norm + rope, then K3) "
                  f"{route_ms:.3f} ms (norm + rope of q and k {norm_ms:.3f} ms) against the "
                  f"fused K1 on the raw q / k {k1_ms:.3f} ms; outputs max|diff| "
                  f"{diff.abs().max().item():.3e}, rel L2 {rel:.3e} [{card}]", flush=True)
            if not (rel <= FORWARD_REL_TOL and bool(torch.isfinite(o3).all())):
                raise AssertionError("norm + rope + K3 disagrees with K1 at path B's shape")
            main.update(k1_same_shape_ms=k1_ms, jax_route_ms=route_ms)
            del o1, o3, diff, qs2, ks2, cos, sin
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return main


def phase_flash_bwd_kernel(card: str) -> dict:
    """K4 against flash_bwd_reference (the explicit f32 formula) at
    FLASH_CASES, from K3's out / lse with do ~ N(0, 1) on every row (padded
    ones included), with median times beside the bound and SDPA flash's
    backward (unmasked)."""
    from qflux_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(13)
    scale = 128 ** -0.5
    main = None
    for name, b, s, ids in FLASH_CASES:
        q, k, v, q_seg, kv_seg = _flash_case(gen, b, s, ids)
        do = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
        out, lse = fa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
        ok, errs, max_err, got = _k4_agrees(q, k, v, q_seg, kv_seg, out, lse, do, scale)
        if ids == "text_pad":  # the padded rows: no query attends them, they attend nothing
            pad = slice(QWEN_TXT - QWEN_TXT_PAD, QWEN_TXT)
            ok = ok and all(not g[:, pad].any() for g in got)
        del got
        torch.cuda.empty_cache()
        op_ms = _median_ms(lambda: fa._flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do,
                                                      scale))
        alone = _k4_alone(q, k, v, q_seg, kv_seg, out, lse, do, scale)
        ms = alone["ms"]
        plain_ms = _median_ms(lambda: fa.flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse,
                                                             do, scale), n=3)
        lib_ms = _sdpa_flash_ms(q, k, v, do)
        bound = _flash_bound(q, k, q_seg, kv_seg, bwd=True)
        print(f"[flash_bwd] {name}: B={b} S={s} H=24 D=128 ids={ids or 'none'} "
              f"{errs} (tol rel {BWD_REL_TOL}, max {BWD_MAX_TOL} x max|ref|), within "
              f"them and two calls identical {ok}; K4 alone {ms:.4f} ms "
              f"({14.0 * b * 24 * s * s * 128 / ms / 1e9:.1f} TFLOP/s of its seven products), "
              f"wrapper {op_ms:.3f} ms and {alone['wrapper_host_us']:.1f} us host per call, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; dense "
              f"{10.0 * b * 24 * s * s * 128 / PEAK_BF16_PER_MS:.4f}), plain {plain_ms:.3f} ms, "
              f"SDPA flash backward (unmasked) {lib_ms:.3f} ms [{card}]", flush=True)
        if not ok:
            raise AssertionError(f"K4 disagrees with its plain version (or with itself) in "
                                 f"case {name}")
        if main is None:
            main = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "op_ms": op_ms,
                    "wrapper_host_us": alone["wrapper_host_us"], **bound}
        del q, k, v, out, lse, do
        torch.cuda.empty_cache()
    return main


def _request(rng, cfg, gh, gw, b):
    """A cached-embedding request: 512 T5 tokens × 4096, pooled CLIP 768,
    one control image of gh×gw packed tokens × 64 channels."""
    from qflux_tpu_torch.ops.rope import flux_image_ids, flux_text_ids

    s_txt = 512
    f32 = np.float32
    return {
        "control_latents": rng.standard_normal((b, gh * gw, cfg.in_channels)).astype(f32),
        "prompt_embeds": rng.standard_normal((b, s_txt, cfg.joint_attention_dim)).astype(f32),
        "pooled_prompt_embeds": rng.standard_normal((b, cfg.pooled_projection_dim)).astype(f32),
        "tgt_ids": flux_image_ids(gh, gw, 0),
        "ctl_ids": flux_image_ids(gh, gw, 1),
        "txt_ids": flux_text_ids(s_txt),
    }


def phase_predict(card: str):
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.ops.layers import merge_lora
    from qflux_tpu_torch.trainer.base import Trainer, predict_config

    trainer = Trainer(predict_config(variant="full", num_inference_steps=STEPS), device="cuda")
    t0 = time.perf_counter()
    trainer.load_model()
    torch.cuda.synchronize()
    dit, cfg = trainer.bundle.dit_params, trainer.bundle.dit_cfg
    n_dit = sum(p.numel() for p in dit.parameters())
    b_dit = sum(p.numel() * p.element_size() for p in dit.parameters())
    n_vae = sum(p.numel() for p in trainer.bundle.vae_params.parameters())
    lora = trainer.build_lora()
    gen = torch.Generator("cuda").manual_seed(7)
    _perturb_b(lora, gen)
    n_lora = sum(leaf["a"].numel() + leaf["b"].numel() for leaf in lora.values())
    print(f"[slice] DiT {cfg.num_layers} dual + {cfg.num_single_layers} single, dim {cfg.dim}: "
          f"{n_dit} params, {b_dit} bytes bf16; VAE decoder {n_vae} params f32; LoRA "
          f"{len(lora)} layers rank {trainer.config.model.lora.r}, {n_lora} params; "
          f"built in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    rng = np.random.default_rng(0)
    gh, gw = trainer.adapter.latent_grid(HEIGHT, WIDTH)

    # one full-width forward through K1 and through the plain attention
    emb = trainer.adapter.prepare_cached_embeddings(_request(rng, cfg, gh, gw, 1))
    batch = {k: torch.as_tensor(v).to("cuda", torch.bfloat16) for k, v in emb.items()}
    batch["guidance"] = torch.full((1,), 2.5, dtype=torch.bfloat16, device="cuda")
    lat = torch.randn(1, gh * gw, cfg.in_channels, device="cuda", generator=gen).to(torch.bfloat16)
    sigma = torch.full((1,), 1.0, dtype=torch.bfloat16, device="cuda")
    plain = dataclasses.replace(trainer.adapter, attn_impl="plain")
    merge_lora(dit, lora)
    with torch.inference_mode():
        before = flash_nr.KERNEL_LAUNCHES
        v_k = trainer.adapter.predict_velocity(dit, batch, lat, sigma).float()
        if flash_nr.KERNEL_LAUNCHES - before != cfg.num_layers + cfg.num_single_layers:
            raise AssertionError("the full-width forward did not run K1 in every block")
        v_p = plain.predict_velocity(dit, batch, lat, sigma).float()
    rel = (torch.linalg.vector_norm(v_k - v_p) / torch.linalg.vector_norm(v_p)).item()
    print(f"[slice] full-width forward [1, {gh * gw}, {cfg.out_channels}] K1 vs plain "
          f"attention: rel L2 err {rel:.3e} (tol {FORWARD_REL_TOL}), |v| rms "
          f"{v_p.pow(2).mean().sqrt().item():.4f} [{card}]", flush=True)
    if not (rel <= FORWARD_REL_TOL and bool(torch.isfinite(v_k).all())):
        raise AssertionError("full-width forward through K1 disagrees with the plain path")
    del v_k, v_p, batch
    torch.cuda.empty_cache()

    # the main path: three requests, counts reset just before
    per_request = STEPS * (cfg.num_layers + cfg.num_single_layers)
    flash_nr.KERNEL_LAUNCHES = 0
    for i, (b, seed) in enumerate([(1, 42), (1, 43), (2, 44)]):
        emb = _request(rng, cfg, gh, gw, b)
        torch.cuda.reset_peak_memory_stats()
        before = flash_nr.KERNEL_LAUNCHES
        t0 = time.perf_counter()
        images = trainer.predict_from_embeddings(emb, HEIGHT, WIDTH, lora=lora, seed=seed)
        secs = time.perf_counter() - t0
        stats = trainer.last_predict
        launched = flash_nr.KERNEL_LAUNCHES - before
        print(f"[predict] request {i}: bs={b} seed={seed} {secs:.3f} s, "
              f"{1000 * stats['denoise_s'] / stats['steps']:.1f} ms/denoising step "
              f"({stats['steps']} steps), VAE decode {1000 * stats['decode_s']:.1f} ms, "
              f"peak mem {torch.cuda.max_memory_allocated()} bytes, K1 launches {launched}, "
              f"images {images.dtype} {list(images.shape)} mean {images.mean():.2f} [{card}]",
              flush=True)
        if i == 0:
            BF16_FLUX["predict"] = {"s": secs, "peak": torch.cuda.max_memory_allocated(),
                                    "ms_step": 1000 * stats["denoise_s"] / stats["steps"]}
        if images.dtype != np.uint8 or images.shape != (b, HEIGHT, WIDTH, 3):
            raise AssertionError(f"request {i}: images {images.dtype} {images.shape}")
        if not stats["latents_finite"]:
            raise AssertionError(f"request {i}: non-finite latents")
        if launched != per_request:
            raise AssertionError(f"request {i}: {launched} K1 launches, expected {per_request}")
    launches = flash_nr.KERNEL_LAUNCHES

    # one profiled denoising step at bs=1, outside the counted run
    emb = trainer.adapter.prepare_cached_embeddings(_request(rng, cfg, gh, gw, 1))
    batch = {k: torch.as_tensor(v).to("cuda", torch.bfloat16) for k, v in emb.items()}
    batch["guidance"] = torch.full((1,), 2.5, dtype=torch.bfloat16, device="cuda")
    merge_lora(dit, lora)

    def denoising_step():
        with torch.inference_mode():
            trainer.adapter.predict_velocity(dit, batch, lat, sigma)

    _profile(card, f"one FLUX denoising step, bs=1, S = {512 + 2 * lat.shape[1]}", denoising_step)
    return trainer, launches


def _perturb_b(lora, gen):
    """b ~ N(0, 0.005²): the LoRA delta is then about a tenth of the base
    projection, so the adapter visibly changes the output and every a has
    a gradient."""
    with torch.no_grad():
        for leaf in lora.values():
            leaf["b"].normal_(0.0, 0.005, generator=gen)


def _train_batch(rng, cfg, gh, gw, b):
    emb = _request(rng, cfg, gh, gw, b)
    emb["image_latents"] = rng.standard_normal((b, gh * gw, cfg.in_channels)).astype(np.float32)
    return emb


def _lora_grad_check(card, label, names, dit, lora, batch, noise, sigma, adapter, criterion,
                     kernels, n_blocks, groups, tol=GRAD_REL_TOL, plain_impl="plain") -> dict:
    """One step's LoRA gradients through `adapter`'s kernels (its remat
    policy) against the plain attention, attn_impl `plain_impl` ("int8_plain"
    for an "int8" adapter; remat "full": there is no kernel output to save),
    on the same batch, noise and σ.  The kernel run must
    launch the kernels at `kernels` (two indices of _launch_counts) once a
    block each; the relative L2 error over all layers must be within `tol`
    (GRAD_REL_TOL), and every layer must get a finite, non-zero gradient.
    Prints the error per projection group in `groups`; returns them."""
    from qflux_tpu_torch.trainer.train_step import TrainStepConfig, _loss_for_microbatch

    plain = dataclasses.replace(adapter, attn_impl=plain_impl, remat_policy="full")
    grads = {}
    for name, ad in (("kernels", adapter), ("plain", plain)):
        for leaf in lora.values():
            leaf["a"].grad = leaf["b"].grad = leaf["scaling"].grad = None
        before = _launch_counts()
        t0 = time.perf_counter()
        loss = _loss_for_microbatch(dit, lora, batch, noise, sigma, ad.predict_velocity,
                                    criterion, TrainStepConfig())
        loss.backward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        grads[name] = {p: torch.cat([leaf["a"].grad.flatten(), leaf["b"].grad.flatten()])
                       for p, leaf in lora.items()}
        after = _launch_counts()
        launched = tuple(after[i] - before[i] for i in kernels)
        print(f"{label} gradient check, {name}: loss {loss.item():.5f}, forward + backward "
              f"{secs:.3f} s, {names} launches {launched} [{card}]", flush=True)
        if name == "kernels" and launched != (n_blocks, n_blocks):
            raise AssertionError(f"{label}: the kernel step launched {names} {launched} "
                                 f"times, expected {n_blocks} each")
    rels = {}
    for group in (*groups, ""):
        keys = [p for p in grads["plain"] if p.endswith(group)]
        gk = torch.cat([grads["kernels"][p] for p in keys])
        gp = torch.cat([grads["plain"][p] for p in keys])
        rels[group or "all"] = (gk - gp).norm().item() / gp.norm().item()
    print(f"{label} LoRA gradients, {names} vs plain attention ({plain_impl}): rel L2 err "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f" (tol {tol} on all) [{card}]", flush=True)
    if not rels["all"] <= tol or not all(
            bool(torch.isfinite(g).all()) for g in grads["kernels"].values()):
        raise AssertionError(f"{label}: LoRA gradients through {names} disagree with the "
                             "plain path")
    if not all(g.abs().sum() > 0 for g in grads["kernels"].values()):
        raise AssertionError(f"{label}: a LoRA layer got no gradient through the kernels")
    for leaf in lora.values():
        leaf["a"].grad = leaf["b"].grad = leaf["scaling"].grad = None
    return rels


def phase_train(card: str, trainer) -> tuple[int, int]:
    """The full-width gradient check, then Trainer.fit at bs=1 and bs=2 on
    the model the predict phase loaded, then a profiled bs=1 train step.
    Returns the K1 and K2 launches of the fit runs."""
    from qflux_tpu_torch.losses import MseLoss
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.ops.layers import mark_trainable
    from qflux_tpu_torch.trainer.base import Trainer, train_config
    from qflux_tpu_torch.trainer.train_step import lora_leaves, make_train_step

    dit, cfg = trainer.bundle.dit_params, trainer.bundle.dit_cfg
    n_blocks = cfg.num_layers + cfg.num_single_layers
    rng = np.random.default_rng(1)
    gh, gw = trainer.adapter.latent_grid(HEIGHT, WIDTH)

    # one full-width step's LoRA gradients, K1 + K2 (remat "flash") vs the
    # plain attention (remat "full": there is no kernel output to save)
    tt = Trainer(train_config(variant="full"), device="cuda")
    tt.adapter, tt.bundle = trainer.adapter, trainer.bundle
    batch = tt._device_batch(_train_batch(rng, cfg, gh, gw, 1))
    gen = torch.Generator("cuda").manual_seed(8)
    noise = torch.randn(batch["image_latents"].shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    sigma = torch.full((1,), 0.6, device="cuda", dtype=torch.bfloat16)
    lora = mark_trainable(tt.build_lora())
    _perturb_b(lora, gen)
    _lora_grad_check(card, "[train] full-width", "K1+K2", dit, lora, batch, noise, sigma,
                     trainer.adapter, MseLoss(), (0, 1), n_blocks,
                     ("to_q", "to_k", "to_v", "to_out"))
    del lora, batch, noise
    torch.cuda.empty_cache()

    # the main path: Trainer.fit, counts reset just before each run
    k1_total = k2_total = 0
    for b in (1, 2):
        tt = Trainer(train_config(variant="full", max_train_steps=TRAIN_STEPS), device="cuda")
        tt.adapter, tt.bundle = trainer.adapter, trainer.bundle
        batches = [_train_batch(rng, cfg, gh, gw, b) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_nr.KERNEL_LAUNCHES = flash_nr.BWD_KERNEL_LAUNCHES = 0
        lora = _fit_in_tmp(tt, batches)
        k1, k2 = flash_nr.KERNEL_LAUNCHES, flash_nr.BWD_KERNEL_LAUNCHES
        k1_total, k2_total = k1_total + k1, k2_total + k2
        peak = torch.cuda.max_memory_allocated()
        hist = tt.history
        ms = [1000 * h["step_s"] for h in hist]
        warm = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
        steps = ", ".join(f"{m:.1f}" for m in ms)
        losses = ", ".join(f"{h['loss']:.5f}" for h in hist)
        norms = ", ".join(f"{h['grad_norm']:.4e}" for h in hist)
        stage = statistics.median(1000 * h["stage_s"] for h in hist)
        print(f"[train] fit bs={b}: {len(hist)} steps, ms/step {steps} (median after the "
              f"first {warm:.1f}; staging the next batch inside each, median {stage:.1f}), "
              f"peak mem {peak} bytes, loss {losses}, grad_norm {norms}, "
              f"lr {hist[-1]['lr']:g}, K1 launches {k1}, K2 launches {k2} [{card}]", flush=True)
        if b == 1:
            BF16_FLUX["fit"] = {"median": warm, "peak": peak}
        want = n_blocks * len(hist)
        if len(hist) != TRAIN_STEPS or not all(np.isfinite(h["loss"]) for h in hist):
            raise AssertionError(f"fit bs={b}: {len(hist)} steps or non-finite losses")
        if (k1, k2) != (want, want):
            raise AssertionError(f"fit bs={b}: K1/K2 launched {k1}/{k2} times, expected "
                                 f"{want} each ({n_blocks} per step)")
        if not all(leaf["b"].abs().sum() > 0 for leaf in lora.values()):
            raise AssertionError(f"fit bs={b}: a LoRA b did not move from zero")
        del lora, batches, tt
        torch.cuda.empty_cache()

    # one bs=1 train step under the profiler, after the counted runs
    tt = Trainer(train_config(variant="full"), device="cuda")
    tt.adapter, tt.bundle = trainer.adapter, trainer.bundle
    lora = mark_trainable(tt.build_lora())
    optimizer, schedule = tt.build_optimizer(lora_leaves(lora)[0])
    step = make_train_step(tt.adapter.predict_velocity, tt.build_criterion(), optimizer, schedule,
                           tt._build_step_config())
    batch = tt._device_batch(_train_batch(rng, cfg, gh, gw, 1))
    gen = torch.Generator("cuda").manual_seed(9)
    _profile(card, f"one FLUX train step, bs=1, S = {512 + 2 * gh * gw}, remat flash",
             lambda: step(dit, lora, batch, gen)["loss"].item())
    del lora, batch, step, optimizer
    torch.cuda.empty_cache()
    return k1_total, k2_total


def _rq_operands(gen, m, k_in, n):
    """One K5 case: weights U(±1/sqrt(K)) quantized to int4 (groups of
    min(128, K)) with their requant factors, enough copies of (q4, f, s_vec)
    to exceed the L2 cache three times, and bf16 x [m, K] and g [m, N]."""
    from qflux_tpu_torch.ops import quant

    w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
    q4, scale = quant.quantize_kernel_int4(w, 128)
    f, sv = quant._requant_factors(scale)
    copies = max(2, int(np.ceil(3 * L2_BYTES / (q4.numel() + f.numel() * 4))))
    weights = [(q4.clone(), f.clone(), sv.clone()) for _ in range(copies)]
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn(m, n, device="cuda", generator=gen).to(torch.bfloat16)
    return q4, scale, weights, x, g


def _k5_alone(ti4, backward, a, sr, weights, out_dtype, reps=20) -> dict:
    """K5a (or, with `backward`, K5b) alone: its C entry launched back to
    back (CUDA events around the window) on the row-quantized input `a` (xq
    [M, K] or gq [M, N]) and its row scales `sr` [M] into a preallocated
    output, each call on the next copy of the weights, past the L2 cache as
    each GEMM of a forward finds its weight.  Takes this tree's entry (the
    regrid pass, the int8 GEMM and, split, the reduction, with `_rq_plan`'s
    split and a preallocated scratch) and the earlier `mma.sync` one (one
    kernel, no plan), so `--ab` times both sides with the same function.  Returns
    the median ms and the output of a first call."""
    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    m = a.shape[0]
    half, n = weights[0][0].shape
    k_in = 2 * half
    gsz = k_in // weights[0][1].shape[0]
    out = torch.empty(m, k_in if backward else n, device="cuda", dtype=out_dtype)
    f32 = int(out_dtype == torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    extra, bufs = (), ()
    if hasattr(ti4, "_rq_plan"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = ti4._rq_plan(m, n, k_in, gsz, sms, backward)
        bufs = (torch.empty(plan.scratch, device="cuda", dtype=torch.uint8),
                torch.empty(max(plan.workspace, 1), device="cuda", dtype=torch.int32))
        extra = (plan.splits, bufs[0].data_ptr(), bufs[1].data_ptr())
    if backward:
        def call(i):
            q4, f, _ = weights[i]
            return kl.lib.qflux_rq_int4_bwd(a.data_ptr(), q4.data_ptr(), f.data_ptr(),
                                            sr.data_ptr(), out.data_ptr(), m, n, k_in, gsz, f32,
                                            *extra, stream)
    else:
        def call(i):
            q4, f, sv = weights[i]
            return kl.lib.qflux_rq_int4_fwd(a.data_ptr(), q4.data_ptr(), f.data_ptr(),
                                            sr.data_ptr(), sv.data_ptr(), out.data_ptr(), m, n,
                                            k_in, gsz, f32, *extra, stream)
    kl.check(call(0), "K5b alone" if backward else "K5a alone")
    first = out.clone()
    ms = _rotating_ms(call, len(weights), reps=reps)
    return {"ms": ms, "out": first, "splits": extra[0] if extra else 1}


def _rowquant_alone(x, s_vec=None, reps=20) -> float:
    """The row-quantization kernel alone: its C entry back to back into
    preallocated outputs (ms)."""
    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    m, k = x.shape
    xq = torch.empty(m, k, device="cuda", dtype=torch.int8)
    s = torch.empty(m, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sv = None if s_vec is None else s_vec.data_ptr()
    f32 = int(x.dtype == torch.float32)

    def call(_):
        return kl.lib.qflux_rowquant(x.data_ptr(), sv, xq.data_ptr(), s.data_ptr(), m, k, f32,
                                     stream)

    kl.check(call(0), "rowquant alone")
    return _rotating_ms(call, 1, reps=reps)


def _rq_phase(card: str, backward: bool) -> dict:
    """K5a (or, with `backward`, K5b) against its plain version at RQ_CASES
    (RQ_BWD_CASES), through rq_fused_matmul (its backward), bf16 x and g:
    the kernel must equal the plain version to the bit, and two calls must
    give the same bits.  Times (CUDA events, weights rotated past the L2
    cache): the kernel alone (`_k5_alone`, on the row-quantized input: what
    the bound counts), the row-quantization kernel alone beside the plain
    `quant._rowquant` on the same input, the whole wrapper (row quantization
    and kernel), the plain version, and torch._int_mm on the same int8
    operands with q8 materialized (q8ᵀ contiguous for the dx; the int GEMM
    JAX's default XLA path runs; a yardstick only).  Prints each case's share
    of the bound and factor against torch._int_mm; returns the main case's
    numbers (RQ_MAIN, or its dx) and the row quantization's there."""
    from qflux_tpu_torch.ops import int4_matmul as ti4, quant

    tag, name = ("rq_bwd", "K5b") if backward else ("rq", "K5a")
    gen = torch.Generator("cuda").manual_seed(4 if backward else 3)
    main = rowq = None
    for m, k_in, n in (RQ_BWD_CASES if backward else RQ_CASES):
        q4, scale, weights, x, g = _rq_operands(gen, m, k_in, n)
        f, sv = weights[0][1], weights[0][2]
        if backward:
            x.requires_grad_()
            ti4.rq_fused_matmul(x, q4, scale, (f, sv)).backward(g)
            got = x.grad
            x.grad = None
            ti4.rq_fused_matmul(x, q4, scale, (f, sv)).backward(g)
            again = x.grad
            want = quant.requant_int4_matmul_dx(g, q4, (f, sv))
            a_in, sv_in = g, sv          # the row quantization's input: g · s_vec
            a, sr = quant._rowquant(g.float() * sv)
        else:
            got = ti4.rq_fused_matmul(x, q4, scale, (f, sv))
            again = ti4.rq_fused_matmul(x, q4, scale, (f, sv))
            want = quant.requant_int4_matmul(x, q4, scale, (f, sv))
            a_in, sv_in = x, None
            a, sr = quant._rowquant(x)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not (torch.equal(got, want) and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{name} differs from its plain version at M={m} K={k_in} "
                                 f"N={n}: max |diff| {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} is not deterministic at M={m} K={k_in} N={n}")
        alone = _k5_alone(ti4, backward, a, sr.reshape(m), weights, g.dtype)
        if not torch.equal(alone["out"], want):
            raise AssertionError(f"{name} alone differs from its plain version at M={m} "
                                 f"K={k_in} N={n}")
        ms = alone["ms"]
        # the row quantization: the kernel against the plain version, alone
        rq_got = ti4.rowquant_cuda(a_in, sv_in)
        rq_err = max((rq_got[0].int() - a.int()).abs().max().item(),
                     (rq_got[1] - sr).abs().max().item())
        if not (torch.equal(rq_got[0], a) and torch.equal(rq_got[1], sr)):
            raise AssertionError(f"the row quantization differs from quant._rowquant at "
                                 f"[{m}, {a_in.shape[1]}]: max |diff| {rq_err}")
        rq_ms = _rowquant_alone(a_in, sv_in)
        rq_plain_ms = _rotating_ms(
            lambda i: quant._rowquant(a_in if sv_in is None else a_in.float() * sv_in), 1)
        c = len(weights)
        if backward:
            def wrapper(i):
                gq_, sg_ = ti4.rowquant_cuda(g, weights[i][2])
                return ti4.rq_int4_bwd_cuda(gq_, weights[i][0], weights[i][1], sg_, g.dtype)
            plain = lambda i: quant.requant_int4_matmul_dx(g, weights[i][0], weights[i][1:])
        else:
            def wrapper(i):
                xq_, sx_ = ti4.rowquant_cuda(x)
                q4_, f_, sv_ = weights[i]
                return ti4.rq_int4_fwd_cuda(xq_, q4_, f_, sx_, sv_, x.dtype)
            plain = lambda i: quant.requant_int4_matmul(x, weights[i][0], None, weights[i][1:])
        wrapper_ms = _rotating_ms(wrapper, c)
        plain_ms = _rotating_ms(plain, c, reps=3, n=3)
        q8s = [quant._requant_q8(w[0], w[1]) for w in weights[:4]]
        if backward:
            q8s = [q.t().contiguous() for q in q8s]
        try:
            lib_ms = _rotating_ms(lambda i: torch._int_mm(a, q8s[i]), len(q8s))
        except RuntimeError as e:  # a shape torch._int_mm refuses: no yardstick
            lib_ms = None
            print(f"[{tag}] torch._int_mm refuses M={m} K={k_in} N={n}: {e}", flush=True)
        del q8s
        ops = 2.0 * m * k_in * n
        out_cols = k_in if backward else n
        # the int8 input, q4, f, the row (and, forward, channel) scales read once; the
        # output (bf16) written once
        n_bytes = (m * (n if backward else k_in) + k_in * n // 2 + f.numel() * 4 + m * 4
                   + (0 if backward else n * 4) + m * out_cols * 2)
        bound = _bound(n_bytes, ops, PEAK_INT8_PER_MS)
        rq_bound = _bound(a_in.numel() * a_in.element_size() + a.numel() + m * 4
                          + (0 if sv_in is None else sv_in.numel() * 4), 0, PEAK_INT8_PER_MS)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x)"
        print(f"[{tag}] {'dx of ' if backward else ''}M={m} K={k_in} N={n}: max |kernel - "
              f"plain| {err} (tol 0), two calls identical; {name} alone {ms:.4f} ms "
              f"({ops / ms / 1e9:.1f} TOPS, {100 * bound['bound_ms'] / ms:.1f}% of the bound, "
              f"splits {alone['splits']}), wrapper with the row quantization {wrapper_ms:.4f} "
              f"ms, plain {plain_ms:.3f} ms, torch._int_mm {lib}, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); row quantization "
              f"[{m}, {a_in.shape[1]}]{' x s_vec' if backward else ''} alone {rq_ms:.4f} ms "
              f"({100 * rq_bound['bound_ms'] / rq_ms:.1f}% of its {rq_bound['bound_ms']:.4f} ms "
              f"bound), plain {rq_plain_ms:.4f} ms [{card}]", flush=True)
        if (m, k_in, n) == RQ_MAIN:
            main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "wrapper_ms": wrapper_ms, **bound}
            rowq = {"max_abs_err": rq_err, "ms": rq_ms, "plain_ms": rq_plain_ms,
                    "library_ms": None, "shape": [m, a_in.shape[1]], **rq_bound}
        del q4, scale, weights, x, g, got, again, want, a, sr, alone, rq_got
        torch.cuda.empty_cache()
    return {**main, "rowquant": rowq}


def phase_rq_kernel(card: str) -> dict:
    """K5a at RQ_CASES (`_rq_phase`)."""
    return _rq_phase(card, False)


def phase_rq_bwd_kernel(card: str) -> dict:
    """K5b at the dx of RQ_BWD_CASES (`_rq_phase`)."""
    return _rq_phase(card, True)


def _qwen_request(rng, cfg, gh, gw, b):
    """A cached-embedding request of the Qwen adapter: 256 Qwen2.5-VL tokens ×
    3584 (the last 26 padding), one control image of gh×gw packed tokens."""
    mask = np.ones((b, QWEN_TXT), np.int64)
    mask[:, QWEN_TXT - QWEN_TXT_PAD:] = 0
    f32 = np.float32
    return {
        "control_latents": rng.standard_normal((b, gh * gw, cfg.in_channels)).astype(f32),
        "prompt_embeds": rng.standard_normal((b, QWEN_TXT, cfg.joint_attention_dim)).astype(f32),
        "prompt_embeds_mask": mask,
        "img_shapes_arr": np.asarray([(1, gh, gw), (1, gh, gw)], np.int32),
    }


def phase_qwen_predict(card: str):
    """The 20B Qwen-Image-Edit predict path over the int4-requant base at
    832×576 (S = 4000), where JAX's one-chip dispatch runs the norm + rope
    and K3.  Returns the trainer (its model stays loaded for the train
    phase) and the K3, K5a and row-quantization launches of the requests."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.ops import flash_attention, int4_matmul
    from qflux_tpu_torch.ops.layers import iter_dense_paths, merge_lora, set_int4_impl
    from qflux_tpu_torch.trainer.base import Trainer

    trainer = Trainer(config_from_dict(QWEN_832X576), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.load_model()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    dit, cfg = trainer.bundle.dit_params, trainer.bundle.dit_cfg
    denses = [m for _, m in iter_dense_paths(dit)]
    quantized = [m for m in denses if m.q4 is not None]
    n_int4 = sum(2 * m.q4.numel() for m in quantized)
    n_full = sum(p.numel() for p in dit.parameters())
    b_nibbles = sum(m.q4.numel() for m in quantized)
    b_scales = sum(m.scale.numel() * 4 for m in quantized)
    b_factors = sum((m.rq_f.numel() + m.rq_s_vec.numel()) * 4 for m in quantized)
    b_full = sum(p.numel() * p.element_size() for p in dit.parameters())
    n_vae = sum(p.numel() for p in trainer.bundle.vae_params.parameters())
    lora = trainer.build_lora()
    gen = torch.Generator("cuda").manual_seed(9)
    _perturb_b(lora, gen)
    n_lora = sum(leaf["a"].numel() + leaf["b"].numel() for leaf in lora.values())
    print(f"[qwen] DiT {cfg.num_layers} blocks, dim {cfg.dim}, {len(quantized)} of "
          f"{len(denses)} dense layers int4-requant: {n_int4 + n_full} weights ({n_int4} int4, "
          f"{n_full} bf16); {b_nibbles + b_scales + b_factors + b_full} bytes ({b_nibbles} "
          f"packed nibbles, {b_scales} group scales, {b_factors} cached requant factors, "
          f"{b_full} bf16); VAE decoder {n_vae} params f32; LoRA {len(lora)} layers rank "
          f"{trainer.config.model.lora.r}, {n_lora} params; loaded in {load_s:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated()} bytes [{card}]", flush=True)

    rng = np.random.default_rng(5)
    gh, gw = trainer.adapter.latent_grid(QWEN_HEIGHT, QWEN_WIDTH)
    n_blocks = cfg.num_layers
    per_forward = n_blocks * 12 + 3  # 8 projections + 4 MLP GEMMs a block; img_in, txt_in, proj_out

    # one full-width forward three ways
    batch = trainer._device_batch(_qwen_request(rng, cfg, gh, gw, 1))
    lat = torch.randn(1, gh * gw, cfg.in_channels, device="cuda", generator=gen).to(
        torch.bfloat16)
    sigma = torch.full((1,), 1.0, dtype=torch.bfloat16, device="cuda")
    plain_attn = dataclasses.replace(trainer.adapter, attn_impl="plain")
    merge_lora(dit, lora)
    try:
        with torch.inference_mode():
            c0 = _launch_counts()
            v_k = trainer.adapter.predict_velocity(dit, batch, lat, sigma)
            launched = tuple(b - a for a, b in zip(c0, _launch_counts()))
            want = _rq((0, 0, per_forward, 0, 0, 0, 0, 0, n_blocks, 0))
            if launched != want:
                raise AssertionError(f"the full-width Qwen forward launched {COUNT_NAMES} "
                                     f"{launched} times, expected {want}")
            set_int4_impl(dit, "plain")
            v_int4_plain = trainer.adapter.predict_velocity(dit, batch, lat, sigma)
            v_p = plain_attn.predict_velocity(dit, batch, lat, sigma).float()
    finally:
        set_int4_impl(dit, "auto")
    identical = torch.equal(v_k, v_int4_plain)
    v_k = v_k.float()
    rel = (torch.linalg.vector_norm(v_k - v_p) / torch.linalg.vector_norm(v_p)).item()
    print(f"[qwen] full-width forward [1, {gh * gw}, {v_k.shape[-1]}], S = "
          f"{QWEN_TXT + 2 * gh * gw}: K5a + K3 vs plain requant + K3 identical to the bit: "
          f"{identical}; vs all plain: rel L2 err {rel:.3e} (tol {FORWARD_REL_TOL}), |v| rms "
          f"{v_p.pow(2).mean().sqrt().item():.4f}; {COUNT_NAMES} launches {launched} [{card}]",
          flush=True)
    if not identical:
        raise AssertionError("the Qwen forward through K5a differs from the plain requant route")
    if not (rel <= FORWARD_REL_TOL and bool(torch.isfinite(v_k).all())):
        raise AssertionError("the Qwen forward through K5a + K3 disagrees with the plain path")
    del v_k, v_p, v_int4_plain, batch
    torch.cuda.empty_cache()

    # the main path: two requests, counts reset just before; quantize.attention
    # is on, and at S = 4000 it runs bf16 attention through K3, as on the TPU
    _reset_counts()
    for i, (b, seed) in enumerate([(1, 42), (2, 44)]):
        emb = _qwen_request(rng, cfg, gh, gw, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = _launch_counts()
        t0 = time.perf_counter()
        images = trainer.predict_from_embeddings(emb, QWEN_HEIGHT, QWEN_WIDTH, lora=lora,
                                                 seed=seed, num_inference_steps=B_STEPS)
        secs = time.perf_counter() - t0
        stats = trainer.last_predict
        launched = tuple(b_ - a for a, b_ in zip(c0, _launch_counts()))
        print(f"[qwen] request {i}: bs={b} seed={seed} {secs:.3f} s, "
              f"{1000 * stats['denoise_s'] / stats['steps']:.1f} ms/denoising step "
              f"({stats['steps']} steps), VAE decode {1000 * stats['decode_s']:.1f} ms, "
              f"peak mem {torch.cuda.max_memory_allocated()} bytes, {COUNT_NAMES} launches "
              f"{launched}, images {images.dtype} {list(images.shape)} mean "
              f"{images.mean():.2f} [{card}]", flush=True)
        if images.dtype != np.uint8 or images.shape != (b, QWEN_HEIGHT, QWEN_WIDTH, 3):
            raise AssertionError(f"Qwen request {i}: images {images.dtype} {images.shape}")
        if not stats["latents_finite"]:
            raise AssertionError(f"Qwen request {i}: non-finite latents")
        want = _rq((0, 0, B_STEPS * per_forward, 0, 0, 0, 0, 0, B_STEPS * n_blocks, 0))
        if launched != want:
            raise AssertionError(f"Qwen request {i}: {COUNT_NAMES} launched {launched} times, "
                                 f"expected {want}")
    counts = (flash_attention.KERNEL_LAUNCHES, int4_matmul.RQ_KERNEL_LAUNCHES,
              int4_matmul.ROWQUANT_LAUNCHES)
    batch = trainer._device_batch(_qwen_request(rng, cfg, gh, gw, 1))
    lat = torch.randn(1, gh * gw, cfg.in_channels, device="cuda").to(torch.bfloat16)
    sigma = torch.full((1,), 0.5, dtype=torch.bfloat16, device="cuda")
    merge_lora(dit, lora)

    def denoising_step():
        with torch.inference_mode():
            trainer.adapter.predict_velocity(dit, batch, lat, sigma)

    _profile(card, f"one Qwen denoising step, bs=1, S = {QWEN_TXT + 2 * gh * gw}",
             denoising_step)
    merge_lora(dit, None)
    return trainer, counts


def _qwen_train_batch(rng, cfg, gh, gw, b):
    emb = _qwen_request(rng, cfg, gh, gw, b)
    emb["image_latents"] = rng.standard_normal((b, gh * gw, cfg.in_channels)).astype(np.float32)
    return emb


COUNT_NAMES = "K1/K2/K5a/K5b/K1 s_int8/K2 s_int8/K6a/K6b/K3/K4/row quant"


def _launch_counts() -> tuple[int, ...]:
    """(K1, K2, K5a, K5b, K1 s_int8, K2 s_int8, K6a, K6b, K3, K4, row quant)
    launches so far."""
    from qflux_tpu_torch.ops import flash_attention, flash_nr, int4_matmul

    return (flash_nr.KERNEL_LAUNCHES, flash_nr.BWD_KERNEL_LAUNCHES,
            int4_matmul.RQ_KERNEL_LAUNCHES, int4_matmul.RQ_BWD_KERNEL_LAUNCHES,
            flash_nr.INT8_KERNEL_LAUNCHES, flash_nr.INT8_BWD_KERNEL_LAUNCHES,
            int4_matmul.INT4_KERNEL_LAUNCHES, int4_matmul.INT4_BWD_KERNEL_LAUNCHES,
            flash_attention.KERNEL_LAUNCHES, flash_attention.BWD_KERNEL_LAUNCHES,
            int4_matmul.ROWQUANT_LAUNCHES)


def _rq(counts: tuple[int, ...]) -> tuple[int, ...]:
    """The first ten of _launch_counts' order, with the row quantization's
    count appended: one launch before every K5a and every K5b."""
    return (*counts, counts[2] + counts[3])


def _reset_counts() -> None:
    from qflux_tpu_torch.ops import flash_attention, flash_nr, int4_matmul

    flash_nr.KERNEL_LAUNCHES = flash_nr.BWD_KERNEL_LAUNCHES = 0
    flash_nr.INT8_KERNEL_LAUNCHES = flash_nr.INT8_BWD_KERNEL_LAUNCHES = 0
    int4_matmul.RQ_KERNEL_LAUNCHES = int4_matmul.RQ_BWD_KERNEL_LAUNCHES = 0
    int4_matmul.ROWQUANT_LAUNCHES = 0
    int4_matmul.INT4_KERNEL_LAUNCHES = int4_matmul.INT4_BWD_KERNEL_LAUNCHES = 0
    flash_attention.KERNEL_LAUNCHES = flash_attention.BWD_KERNEL_LAUNCHES = 0


def phase_qwen_train(card: str, trainer) -> tuple[tuple[int, ...], dict]:
    """The Qwen LoRA train step over the int4-requant base, on the model the
    predict phase loaded: the full-width gradient check, "flash_offload"
    against "flash", Trainer.fit at bs=1 and bs=2, and a profiled step.
    Returns the launches of the fit runs (_launch_counts' order): at S =
    4000 JAX's one-chip dispatch runs the norm + rope and K3 / K4 (no K1 /
    K2), and quantize.attention bf16 attention (no s_int8 launch); and the
    LoRA the bs=2 fit trained."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.losses import MseLoss
    from qflux_tpu_torch.ops.layers import mark_trainable, set_int4_impl
    from qflux_tpu_torch.trainer.base import Trainer
    from qflux_tpu_torch.trainer.train_step import (TrainStepConfig, _loss_for_microbatch,
                                                    lora_leaves, make_train_step)

    dit, cfg = trainer.bundle.dit_params, trainer.bundle.dit_cfg
    n = cfg.num_layers
    # per step: K3 and K4 once a block; K5a 723 in the forward + 720 in the
    # recompute; K5b wherever the GEMM's input needs a gradient and its
    # output reaches the loss: 6 in block 0 (its q/k/v inputs carry none),
    # 12 in each middle block, 9 in the last (its add_out and text MLP feed
    # only the dropped text stream), 1 for proj_out
    per_step = _rq((0, 0, 2 * 12 * n + 3, 6 + 12 * (n - 2) + 9 + 1, 0, 0, 0, 0, n, n))
    # the two LoRA layers the loss does not reach: the last block's text
    # queries and text output projection
    zero_grad = {f"blocks/{n - 1}/attn/add_q", f"blocks/{n - 1}/attn/add_out"}
    rng = np.random.default_rng(6)
    gh, gw = trainer.adapter.latent_grid(QWEN_HEIGHT, QWEN_WIDTH)
    s = QWEN_TXT + 2 * gh * gw

    def make_trainer(steps=QWEN_832X576["train"]["max_train_steps"]):
        config = config_from_dict(QWEN_832X576)
        config.train.max_train_steps = steps
        tt = Trainer(config, device="cuda")
        tt.adapter, tt.bundle = trainer.adapter, trainer.bundle
        return tt

    tt = make_trainer()
    gen = torch.Generator("cuda").manual_seed(10)
    lora = tt.build_lora()
    _perturb_b(lora, gen)
    lora = mark_trainable(lora)

    def one_step(adapter, batch, noise, sigma):
        """One microbatch's loss and LoRA gradients: (loss, {path: a|b
        gradient}, launches, device memory after the forward, peak, s)."""
        for leaf in lora.values():
            for t in leaf.values():
                t.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = _launch_counts()
        t0 = time.perf_counter()
        loss = _loss_for_microbatch(dit, lora, batch, noise, sigma, adapter.predict_velocity,
                                    MseLoss(), TrainStepConfig())
        torch.cuda.synchronize()
        after_fwd = torch.cuda.memory_allocated()
        loss.backward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = tuple(b - a for a, b in zip(c0, _launch_counts()))
        grads = {p: torch.cat([torch.zeros_like(leaf[k]).flatten() if leaf[k].grad is None
                               else leaf[k].grad.flatten() for k in ("a", "b")])
                 for p, leaf in lora.items()}
        return (loss.item(), grads, launched, after_fwd, torch.cuda.max_memory_allocated(),
                secs)

    # flash_offload against flash (both through the kernels), at bs=1 and 2;
    # at bs=1 also the plain requant route + plain attention under "full"
    offload = trainer.adapter
    flash = dataclasses.replace(offload, remat_policy="flash")
    plain = dataclasses.replace(offload, attn_impl="plain", remat_policy="full")
    for b in (1, 2):
        batch = trainer._device_batch(_qwen_train_batch(rng, cfg, gh, gw, b))
        noise = torch.randn(batch["image_latents"].shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        sigma = torch.full((b,), 0.6, device="cuda", dtype=torch.bfloat16)
        runs = {name: one_step(adapter, batch, noise, sigma)
                for name, adapter in (("flash_offload", offload), ("flash", flash))}
        if b == 1:
            # the plain path in bf16, and in f32 activations as the reference
            # both bf16 paths are measured against
            batch32 = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
            set_int4_impl(dit, "plain")
            try:
                runs["plain"] = one_step(plain, batch, noise, sigma)
                runs["plain_f32"] = one_step(plain, batch32, noise.float(), sigma.float())
            finally:
                set_int4_impl(dit, "auto")
        for name, (loss, _, launched, after_fwd, peak, secs) in runs.items():
            print(f"[qwen_train] bs={b} {name}: loss {loss:.5f}, forward + backward "
                  f"{secs:.3f} s, device memory after the forward {after_fwd} bytes, peak "
                  f"{peak} bytes, {COUNT_NAMES} launches {launched} [{card}]", flush=True)
            if not name.startswith("plain") and launched != per_step:
                raise AssertionError(f"bs={b} {name}: {COUNT_NAMES} launched {launched} "
                                     f"times, expected {per_step}")
        g_off, g_flash = runs["flash_offload"][1], runs["flash"][1]
        identical = all(torch.equal(g_off[p], g_flash[p]) for p in g_off)
        residual = n * (b * s * cfg.dim * 2 + b * cfg.num_attention_heads * s * 4)
        saved = runs["flash"][3] - runs["flash_offload"][3]
        print(f"[qwen_train] bs={b}: flash_offload vs flash gradients identical to the bit: "
              f"{identical}; device memory after the forward {saved} bytes lower under "
              f"flash_offload (K3's out + lse over {n} blocks: {residual} bytes) [{card}]",
              flush=True)
        if not identical:
            raise AssertionError(f"bs={b}: flash_offload and flash gradients differ")
        if not saved >= 0.9 * residual:
            raise AssertionError(f"bs={b}: flash_offload saved {saved} bytes of device memory "
                                 f"after the forward, expected ~{residual}")
        if b == 1:
            g_plain, g_f32 = runs["plain"][1], runs["plain_f32"][1]
            norm_all = torch.cat(list(g_f32.values())).norm().item()
            rels, lines = {}, []
            for group in ("to_q", "to_k", "to_v", "to_out", "add_q", "add_k", "add_v",
                          "add_out", ""):
                keys = [p for p in g_plain if p.endswith(group)]
                gk, gp, gf = (torch.cat([g[p] for p in keys]) for g in (g_off, g_plain, g_f32))
                rels[group or "all"] = (gk - gp).norm().item() / gp.norm().item()
                lines.append(f"{group or 'all'}: share of |g| {gf.norm().item() / norm_all:.3e}, "
                             f"kernels vs plain {rels[group or 'all']:.3e}, vs f32 "
                             f"{(gk - gf).norm().item() / gf.norm().item():.3e}, plain vs f32 "
                             f"{(gp - gf).norm().item() / gf.norm().item():.3e}")
            print("[qwen_train] full-width LoRA gradients (rel L2 err per projection group), "
                  "K5a + K5b + K3 + K4 (flash_offload) vs plain requant + plain attention "
                  "(full), and each against the plain path in f32 activations: "
                  + "; ".join(lines) + f" (tol {QWEN_GRAD_REL_TOL} on kernels vs plain, all) "
                  f"[{card}]", flush=True)
            if not rels["all"] <= QWEN_GRAD_REL_TOL or not all(
                    bool(torch.isfinite(g).all()) for g in g_off.values()):
                raise AssertionError("full-width Qwen LoRA gradients through the kernels "
                                     "disagree with the plain path")
            for p, g in g_off.items():
                if bool(g.abs().sum() > 0) != (p not in zero_grad):
                    raise AssertionError(f"LoRA layer {p}: gradient through the kernels "
                                         f"{'zero' if p not in zero_grad else 'nonzero'}")
        del runs, batch, noise
        torch.cuda.empty_cache()
    del lora

    # the main path: Trainer.fit, counts reset just before each run
    totals = [0] * len(per_step)
    for b in (1, 2):
        tt = make_trainer(EARLIER_TRAIN_STEPS)
        batches = [_qwen_train_batch(rng, cfg, gh, gw, b) for _ in range(EARLIER_TRAIN_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        fitted = _fit_in_tmp(tt, batches)
        launched = _launch_counts()
        totals = [t + c for t, c in zip(totals, launched)]
        peak = torch.cuda.max_memory_allocated()
        hist = tt.history
        ms = [1000 * h["step_s"] for h in hist]
        warm = ms[1:] if len(ms) > 1 else ms
        print(f"[qwen_train] fit bs={b}: {len(hist)} steps, ms/step "
              + ", ".join(f"{m:.1f}" for m in ms)
              + f" (median after the first {statistics.median(warm):.1f}, spread "
              f"{min(warm):.1f}-{max(warm):.1f}), peak mem {peak} bytes, loss "
              + ", ".join(f"{h['loss']:.5f}" for h in hist) + ", grad_norm "
              + ", ".join(f"{h['grad_norm']:.4e}" for h in hist) + ", lr "
              + ", ".join(f"{h['lr']:g}" for h in hist)
              + f", {COUNT_NAMES} launches {launched} [{card}]", flush=True)
        want = tuple(len(hist) * c for c in per_step)
        if len(hist) != EARLIER_TRAIN_STEPS or not all(np.isfinite(h["loss"]) for h in hist):
            raise AssertionError(f"Qwen fit bs={b}: {len(hist)} steps or non-finite losses")
        if launched != want:
            raise AssertionError(f"Qwen fit bs={b}: {COUNT_NAMES} launched {launched} times, "
                                 f"expected {want} ({per_step} per step)")
        for p, leaf in fitted.items():
            if bool(leaf["b"].abs().sum() > 0) != (p not in zero_grad):
                raise AssertionError(f"Qwen fit bs={b}: LoRA b of {p} "
                                     f"{'did not move' if p not in zero_grad else 'moved'}")
        del fitted, batches
        torch.cuda.empty_cache()

    # one bs=1 train step (forward, backward, clip, AdamW) under the profiler
    lora = mark_trainable(tt.build_lora())
    optimizer, schedule = tt.build_optimizer(lora_leaves(lora)[0])
    step = make_train_step(tt.adapter.predict_velocity, tt.build_criterion(), optimizer,
                           schedule, tt._build_step_config())
    batch = tt._device_batch(_qwen_train_batch(rng, cfg, gh, gw, 1))
    _profile(card, f"one Qwen train step, bs=1, S = {s}, remat flash_offload",
             lambda: step(dit, lora, batch, gen)["loss"].item())
    return tuple(totals), tt.lora


# The s_int8 mode of K1 / K2 (quantize.attention) on the card.  Cases: B, S,
# st, masked text tail.  The Qwen path at 512² (256 text tokens, the last 26
# padding: S = 2304, q tiles 256 forward / 128 backward), FLUX at 512²
# unmasked (S = 2560, 256 / 128) and S = 1024 (256 / 256); the first is the
# one the kernel table reports.
INT8_CASES = [("qwen_512sq", 1, 2304, 256, True), ("flux_512sq", 1, 2560, 512, False),
              ("s1024", 1, 1024, 256, False)]
# K1 s_int8 vs its plain version, relative L2 of out: the two quantize the
# same normed q / k to the same int8 values and scales (checked to the bit
# below), but a normed value that lands one bf16 ulp apart moves an int8
# step, and the kernel rounds p to bf16 before PV at other points than the
# plain version (as bf16 K1 does, ~1 bf16 ulp); 3e-2 is ~8 ulps and far
# below the O(1) error of a wrong scale or tile.
INT8_FWD_REL_TOL = 3e-2
# K2 s_int8 vs its plain version, relative L2 per gradient: bf16 K2 measured
# ~5e-3 against its f32 plain version; here the plain version rounds at the
# same points but recomputes p from the int8 scores, where one moved int8
# step shifts a whole score row, so 1e-1, far below the ~1 of a lost term.
INT8_BWD_REL_TOL = 1e-1
QWEN512 = 512  # path A: the published Qwen config at its 512² operating point


def _int8_seg(b, s, st, masked):
    """INT8_CASES' ids: the 26 text tokens before st padding, or None."""
    if not masked:
        return None
    seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
    seg[:, st - 26:st] = 0
    return seg


def _int8_bound(b, s, h=24, d=128, bwd=False) -> dict:
    """The least time for the s_int8 kernels' work on this card: the int8
    QK^T (2·S²·D per head) at the int8 peak plus the bf16 products (PV in
    the forward; dP, dV, dQ and dK in the backward) at the bf16 peak, or
    the bytes (q, k, v, out, do, dq, dk, dv bf16; lse f32; cos / sin f32)
    at the memory rate, whichever is larger."""
    gemm = 2.0 * b * h * s * s * d
    t_ops = gemm / PEAK_INT8_PER_MS + (4 if bwd else 1) * gemm / PEAK_BF16_PER_MS
    n_bytes = (8 if bwd else 4) * b * s * h * d * 2 + b * h * s * 4 + 2 * s * d * 4
    t_bytes = n_bytes / PEAK_BYTES_PER_MS
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "bytes" if t_bytes > t_ops
            else "operations"}


def phase_kernel_int8(card: str) -> tuple[dict, dict]:
    """K1's and K2's s_int8 modes against their plain versions at
    INT8_CASES (H = 24): the prep's int8 q / k and scales against
    quant_rows of its own normed q / k (to the bit), out and lse, the five
    gradients with do ~ N(0, 1) on every row (padded ones included), two
    calls of each kernel identical to the bit; times of each kernel alone
    (the prep apart: `_k1_int8_alone`, `_k2_int8_alone`) beside its bound
    and bf16 K1 / K2 alone, of the wrapper ("op"), of the plain versions and
    of SDPA flash at the same shape (context: no PyTorch call computes
    int8-score attention).  Returns the table entries of the first case."""
    from qflux_tpu_torch.ops import flash_nr

    gen = torch.Generator("cuda").manual_seed(11)
    main = None
    for name, b, s, st, masked in INT8_CASES:
        args = _attn_inputs(gen, b, s)
        seg = _int8_seg(b, s, st, masked)
        fwd_rows, bwd_rows = flash_nr.s_int8_tiles(s, 128)
        scale = 1.0 / 128 ** 0.5
        q, k, v, qs2, ks2, cos, sin = args
        exact = True
        for rows in sorted({fwd_rows, bwd_rows}):
            qn, kn, qq, kq, q_sc, k_sc = flash_nr._int8_operands_cuda(q, k, qs2, ks2, cos, sin,
                                                                      st, rows)
            wq, wqs = flash_nr.quant_rows(qn, rows)
            wk, wks = flash_nr.quant_rows(kn, s)
            exact = exact and torch.equal(qq, wq) and torch.equal(q_sc, wqs)
            exact = exact and torch.equal(kq, wk) and torch.equal(k_sc, wks[:, 0])
            del qn, kn, qq, kq, q_sc, k_sc, wq, wqs, wk, wks
        out, lse = flash_nr._flash_nr_cuda(*args, st, seg, scale, fwd_rows)
        out2, lse2 = flash_nr._flash_nr_cuda(*args, st, seg, scale, fwd_rows)
        do = torch.randn(out.shape, device="cuda", generator=gen).to(torch.bfloat16)
        got = flash_nr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do, bwd_rows)
        again = flash_nr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do, bwd_rows)
        torch.cuda.synchronize()
        same = (torch.equal(out, out2) and torch.equal(lse, lse2)
                and all(torch.equal(x, y) for x, y in zip(got, again)))
        del out2, lse2, again
        ref, ref_lse = flash_nr.flash_attention_nr_int8_reference(*args, st, fwd_rows,
                                                                  segment_ids=seg)
        rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        err = (out.float() - ref.float()).abs().max().item()
        valid = ref_lse > -1e29
        lse_err = (lse - ref_lse).abs()[valid].max().item()
        want = flash_nr.flash_attention_nr_int8_bwd_reference(*args, st, do, out, lse, bwd_rows,
                                                              segment_ids=seg)
        rels = [((g.float() - r).norm() / r.norm()).item() for g, r in zip(got, want)]
        bwd_err = max((g.float() - r).abs().max().item() for g, r in zip(got[:3], want[:3]))
        ok = (exact and same and rel <= INT8_FWD_REL_TOL and max(rels) <= INT8_BWD_REL_TOL
              and all(bool(torch.isfinite(t).all()) for t in (out, *got)))
        if masked:
            ok = ok and not out[:, st - 26:st].any()
            ok = ok and all(not g[:, st - 26:st].any() for g in got[:3])
        del got, want, ref, ref_lse
        torch.cuda.empty_cache()
        op_ms = _median_ms(lambda: flash_nr._flash_nr_cuda(*args, st, seg, scale, fwd_rows))
        op_bwd_ms = _median_ms(lambda: flash_nr._flash_nr_bwd_cuda(
            *args, st, seg, scale, out, lse, do, bwd_rows))
        fwd_alone = _k1_int8_alone(args, st, seg, scale, fwd_rows)
        bwd_alone = _k2_int8_alone(args, st, seg, scale, out, lse, do, bwd_rows)
        ms, bwd_ms = fwd_alone["ms"], bwd_alone["ms"]
        bf16_ms = _k1_alone(args, st, seg, scale)["ms"]
        out16, lse16 = flash_nr._flash_nr_cuda(*args, st, seg, scale)
        bf16_bwd_ms = _k2_alone(args, st, seg, scale, out16, lse16, do)["ms"]
        plain_ms = _median_ms(lambda: flash_nr.flash_attention_nr_int8_reference(
            *args, st, fwd_rows, segment_ids=seg), n=5)
        plain_bwd_ms = _median_ms(lambda: flash_nr.flash_attention_nr_int8_bwd_reference(
            *args, st, do, out, lse, bwd_rows, segment_ids=seg), n=5)
        qn = flash_nr.apply_qk_norm_rope(q, qs2, cos, sin, st)
        kn = flash_nr.apply_qk_norm_rope(k, ks2, cos, sin, st)
        sdpa_ms, sdpa_bwd_ms = _sdpa_flash_ms(qn, kn, v), _sdpa_flash_ms(qn, kn, v, do)
        fb, bb = _int8_bound(b, s), _int8_bound(b, s, bwd=True)
        print(f"[kernel_int8] {name}: B={b} S={s} H=24 D=128 st={st} "
              f"masked={'text tail' if masked else 'none'} q tiles {fwd_rows}/{bwd_rows}; prep "
              f"int8 q/k and scales = quant_rows of its normed q/k: {exact}; out rel L2 "
              f"{rel:.3e} (tol {INT8_FWD_REL_TOL}) max|err| {err:.3e}, lse max|err| "
              f"{lse_err:.3e}; grads rel L2 "
              + ", ".join(f"{n_} {r:.3e}" for n_, r in zip(("dq", "dk", "dv", "dqs", "dks"), rels))
              + f" (tol {INT8_BWD_REL_TOL}); two calls identical {same}; fwd: K1 s_int8 alone "
              f"{ms:.4f} ms (prep {fwd_alone['prep_ms']:.4f} ms, main kernel "
              f"{ms - fwd_alone['prep_ms']:.4f} ms; {100 * fb['bound_ms'] / ms:.1f}% of the bound "
              f"{fb['bound_ms']:.4f} ms, {fb['bound_by']}), op {op_ms:.3f} ms, wrapper host "
              f"{fwd_alone['wrapper_host_us']:.1f} us per call, K1 bf16 alone {bf16_ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, SDPA flash {sdpa_ms:.3f} ms; bwd: K2 s_int8 alone "
              f"{bwd_ms:.4f} ms (prep {bwd_alone['prep_ms']:.4f} ms, main kernels "
              f"{bwd_ms - bwd_alone['prep_ms']:.4f} ms; {100 * bb['bound_ms'] / bwd_ms:.1f}% of "
              f"the bound {bb['bound_ms']:.4f} ms, {bb['bound_by']}), op {op_bwd_ms:.3f} ms, "
              f"wrapper host {bwd_alone['wrapper_host_us']:.1f} us per call, K2 bf16 alone "
              f"{bf16_bwd_ms:.4f} ms, plain {plain_bwd_ms:.3f} ms, SDPA flash bwd "
              f"{sdpa_bwd_ms:.3f} ms [{card}]", flush=True)
        if not ok:
            raise AssertionError(f"K1/K2 s_int8 disagree with their plain versions in case {name}")
        if main is None:
            main = ({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "prep_ms": fwd_alone["prep_ms"], "op_ms": op_ms,
                     "wrapper_host_us": fwd_alone["wrapper_host_us"],
                     "bf16_kernel_ms": bf16_ms, "sdpa_flash_ms": sdpa_ms, **fb},
                    {"max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": plain_bwd_ms,
                     "library_ms": None, "prep_ms": bwd_alone["prep_ms"], "op_ms": op_bwd_ms,
                     "wrapper_host_us": bwd_alone["wrapper_host_us"],
                     "bf16_kernel_ms": bf16_bwd_ms, "sdpa_flash_ms": sdpa_bwd_ms, **bb})
        del args, out, lse, do, out16, lse16, qn, kn
        torch.cuda.empty_cache()
    return main


def phase_qwen512_predict(card: str, trainer) -> tuple[int, int, int]:
    """Path A, predict: path B's configuration (quantize.attention on; its
    own model, cut to AC_BLOCKS blocks by `_qwen_cut`) at
    512² with one control image and 256 text tokens (S = 2304), where the
    int8 score GEMM applies.  A full-width forward through K5a + K1 s_int8
    against K5a + the plain int8 attention ("int8_plain"); then two
    requests (bs 1, 2) through Trainer.predict_from_embeddings, each with
    exactly one K1 s_int8 a block and 12 K5a a block + 3 (and a
    row quantization each) per denoising step and no bf16 K1.  Returns the K1 s_int8, K5a and
    row-quantization launches of the requests."""
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.ops.layers import merge_lora

    dit, cfg = trainer.bundle.dit_params, trainer.bundle.dit_cfg
    n_blocks = cfg.num_layers
    per_forward = n_blocks * 12 + 3
    rng = np.random.default_rng(12)
    gen = torch.Generator("cuda").manual_seed(13)
    gh, gw = trainer.adapter.latent_grid(QWEN512, QWEN512)
    s = QWEN_TXT + 2 * gh * gw
    if trainer.adapter.attn_impl != "int8" or flash_nr.s_int8_tiles(s, 128) != (256, 128):
        raise AssertionError(f"path A: attn_impl {trainer.adapter.attn_impl}, S = {s}: the int8 "
                             "score GEMM does not apply")
    lora = trainer.build_lora()
    _perturb_b(lora, gen)
    batch = trainer._device_batch(_qwen_request(rng, cfg, gh, gw, 1))
    lat = torch.randn(1, gh * gw, cfg.in_channels, device="cuda", generator=gen).to(
        torch.bfloat16)
    sigma = torch.full((1,), 1.0, dtype=torch.bfloat16, device="cuda")
    plain = dataclasses.replace(trainer.adapter, attn_impl="int8_plain")
    merge_lora(dit, lora)
    with torch.inference_mode():
        c0 = _launch_counts()
        v_k = trainer.adapter.predict_velocity(dit, batch, lat, sigma).float()
        launched = tuple(b - a for a, b in zip(c0, _launch_counts()))
        v_p = plain.predict_velocity(dit, batch, lat, sigma).float()
    merge_lora(dit, None)
    rel = (torch.linalg.vector_norm(v_k - v_p) / torch.linalg.vector_norm(v_p)).item()
    print(f"[qwen512] full-width forward [1, {gh * gw}, {v_k.shape[-1]}], S = {s}: K5a + K1 "
          f"s_int8 vs K5a + plain int8 attention: rel L2 err {rel:.3e} (tol {FORWARD_REL_TOL}), "
          f"|v| rms {v_p.pow(2).mean().sqrt().item():.4f}; {COUNT_NAMES} launches {launched} "
          f"[{card}]", flush=True)
    if launched != _rq((0, 0, per_forward, 0, n_blocks, 0, 0, 0, 0, 0)):
        raise AssertionError(f"the 512² Qwen forward launched {COUNT_NAMES} {launched} times")
    if not (rel <= FORWARD_REL_TOL and bool(torch.isfinite(v_k).all())):
        raise AssertionError("the 512² Qwen forward through K1 s_int8 disagrees with the plain "
                             "int8 path")
    del v_k, v_p, batch
    torch.cuda.empty_cache()

    # the main path: two requests, counts reset just before
    _reset_counts()
    secs_by_b = {1: [], 2: []}
    for i, (b, seed) in enumerate([(1, 52), (2, 54)]):
        emb = _qwen_request(rng, cfg, gh, gw, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = _launch_counts()
        t0 = time.perf_counter()
        images = trainer.predict_from_embeddings(emb, QWEN512, QWEN512, lora=lora, seed=seed)
        secs = time.perf_counter() - t0
        stats = trainer.last_predict
        launched = tuple(b_ - a for a, b_ in zip(c0, _launch_counts()))
        step_ms = 1000 * stats["denoise_s"] / stats["steps"]
        secs_by_b[b].append(step_ms)
        print(f"[qwen512] request {i}: bs={b} seed={seed} {secs:.3f} s, {step_ms:.1f} "
              f"ms/denoising step ({stats['steps']} steps), VAE decode "
              f"{1000 * stats['decode_s']:.1f} ms, peak mem {torch.cuda.max_memory_allocated()} "
              f"bytes, {COUNT_NAMES} launches {launched}, images {images.dtype} "
              f"{list(images.shape)} mean {images.mean():.2f} [{card}]", flush=True)
        if images.dtype != np.uint8 or images.shape != (b, QWEN512, QWEN512, 3):
            raise AssertionError(f"Qwen 512² request {i}: images {images.dtype} {images.shape}")
        if not stats["latents_finite"]:
            raise AssertionError(f"Qwen 512² request {i}: non-finite latents")
        want = _rq((0, 0, STEPS * per_forward, 0, STEPS * n_blocks, 0, 0, 0, 0, 0))
        if launched != want:
            raise AssertionError(f"Qwen 512² request {i}: {COUNT_NAMES} launched {launched} "
                                 f"times, expected {want}")
    for b, ms in secs_by_b.items():
        print(f"[qwen512] predict bs={b}: ms/denoising step median {statistics.median(ms):.1f}, "
              f"spread {min(ms):.1f}-{max(ms):.1f} over {len(ms)} requests [{card}]", flush=True)
    counts = _launch_counts()
    batch = trainer._device_batch(_qwen_request(rng, cfg, gh, gw, 1))
    merge_lora(dit, lora)

    def denoising_step():
        with torch.inference_mode():
            trainer.adapter.predict_velocity(dit, batch, lat, sigma)

    _profile(card, f"one Qwen denoising step at 512², bs=1, S = {s}, int8 attention",
             denoising_step)
    merge_lora(dit, None)
    return counts[4], counts[2], counts[10]


def phase_qwen512_train(card: str, trainer) -> tuple[int, ...]:
    """Path A, train: the LoRA train step at 512² (S = 2304) on path A's
    model under remat "flash" (the config's 512² operating point).  One
    step's LoRA gradients through the kernels against the plain int8
    attention (remat "full"); then Trainer.fit, 3 steps at bs=1 and at
    bs=2, each step launching K1 and K2 s_int8 once a block (n blocks), K5a
    24n + 3 and K5b 12n − 8 times, and bf16 K1 / K2 never; then a profiled
    step.  Returns the
    launches of the fit runs (_launch_counts' order)."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.losses import MseLoss
    from qflux_tpu_torch.ops.layers import mark_trainable
    from qflux_tpu_torch.trainer.base import Trainer
    from qflux_tpu_torch.trainer.train_step import (TrainStepConfig, _loss_for_microbatch,
                                                    lora_leaves, make_train_step)

    dit, cfg = trainer.bundle.dit_params, trainer.bundle.dit_cfg
    n = cfg.num_layers
    per_step = _rq((0, 0, 2 * 12 * n + 3, 6 + 12 * (n - 2) + 9 + 1, n, n, 0, 0, 0, 0))
    zero_grad = {f"blocks/{n - 1}/attn/add_q", f"blocks/{n - 1}/attn/add_out"}
    rng = np.random.default_rng(14)
    gen = torch.Generator("cuda").manual_seed(15)
    gh, gw = trainer.adapter.latent_grid(QWEN512, QWEN512)
    flash = dataclasses.replace(trainer.adapter, remat_policy="flash")

    def make_trainer(steps):
        raw = copy.deepcopy(QWEN_832X576)
        raw["mesh"]["remat"] = "flash"
        raw["train"]["max_train_steps"] = steps
        tt = Trainer(config_from_dict(raw), device="cuda")
        tt.adapter, tt.bundle = flash, trainer.bundle
        return tt

    # one step's LoRA gradients, kernels (flash) vs plain int8 attention (full)
    tt = make_trainer(1)
    lora = tt.build_lora()
    _perturb_b(lora, gen)
    lora = mark_trainable(lora)
    batch = tt._device_batch(_qwen_train_batch(rng, cfg, gh, gw, 1))
    noise = torch.randn(batch["image_latents"].shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    sigma = torch.full((1,), 0.6, device="cuda", dtype=torch.bfloat16)
    grads = {}
    plain = dataclasses.replace(flash, attn_impl="int8_plain", remat_policy="full")
    for name, adapter in (("kernels", flash), ("plain", plain)):
        for leaf in lora.values():
            for t in leaf.values():
                t.grad = None
        torch.cuda.synchronize()
        c0 = _launch_counts()
        t0 = time.perf_counter()
        loss = _loss_for_microbatch(dit, lora, batch, noise, sigma, adapter.predict_velocity,
                                    MseLoss(), TrainStepConfig())
        loss.backward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = tuple(b - a for a, b in zip(c0, _launch_counts()))
        grads[name] = torch.cat([torch.zeros_like(leaf[k]).flatten() if leaf[k].grad is None
                                 else leaf[k].grad.flatten()
                                 for leaf in lora.values() for k in ("a", "b")])
        print(f"[qwen512_train] gradient check, {name}: loss {loss.item():.5f}, forward + "
              f"backward {secs:.3f} s, {COUNT_NAMES} launches {launched} [{card}]", flush=True)
        if name == "kernels" and launched != per_step:
            raise AssertionError(f"the 512² kernel step launched {COUNT_NAMES} {launched} "
                                 f"times, expected {per_step}")
    rel = ((grads["kernels"] - grads["plain"]).norm() / grads["plain"].norm()).item()
    print(f"[qwen512_train] full-width LoRA gradients, K5a + K5b + K1/K2 s_int8 vs K5a + K5b + "
          f"plain int8 attention: rel L2 err {rel:.3e} (tol {QWEN_GRAD_REL_TOL}) [{card}]",
          flush=True)
    if not (rel <= QWEN_GRAD_REL_TOL and bool(torch.isfinite(grads["kernels"]).all())):
        raise AssertionError("512² LoRA gradients through K1/K2 s_int8 disagree with the plain "
                             "int8 path")
    del grads, lora, batch, noise, loss
    torch.cuda.empty_cache()

    # the main path: Trainer.fit, counts reset just before each run
    totals = [0] * len(per_step)
    for b in (1, 2):
        tt = make_trainer(EARLIER_TRAIN_STEPS)
        batches = [_qwen_train_batch(rng, cfg, gh, gw, b) for _ in range(EARLIER_TRAIN_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        fitted = _fit_in_tmp(tt, batches)
        launched = _launch_counts()
        totals = [t + c for t, c in zip(totals, launched)]
        hist = tt.history
        ms = [1000 * h["step_s"] for h in hist]
        warm = ms[1:] if len(ms) > 1 else ms
        print(f"[qwen512_train] fit bs={b}: {len(hist)} steps, ms/step "
              + ", ".join(f"{m:.1f}" for m in ms)
              + f" (median after the first {statistics.median(warm):.1f}, spread "
              f"{min(warm):.1f}-{max(warm):.1f}), peak mem {torch.cuda.max_memory_allocated()} "
              "bytes, loss " + ", ".join(f"{h['loss']:.5f}" for h in hist)
              + f", {COUNT_NAMES} launches {launched} [{card}]", flush=True)
        want = tuple(len(hist) * c for c in per_step)
        if len(hist) != EARLIER_TRAIN_STEPS or not all(np.isfinite(h["loss"]) for h in hist):
            raise AssertionError(f"Qwen 512² fit bs={b}: {len(hist)} steps or non-finite losses")
        if launched != want:
            raise AssertionError(f"Qwen 512² fit bs={b}: {COUNT_NAMES} launched {launched} "
                                 f"times, expected {want} ({per_step} per step)")
        for p, leaf in fitted.items():
            if bool(leaf["b"].abs().sum() > 0) != (p not in zero_grad):
                raise AssertionError(f"Qwen 512² fit bs={b}: LoRA b of {p} "
                                     f"{'did not move' if p not in zero_grad else 'moved'}")
        del fitted, batches
        torch.cuda.empty_cache()

    # one bs=1 train step under the profiler: K1 / K2 s_int8 and their prep
    # by device time, inside the step
    lora = mark_trainable(tt.build_lora())
    optimizer, schedule = tt.build_optimizer(lora_leaves(lora)[0])
    step = make_train_step(tt.adapter.predict_velocity, tt.build_criterion(), optimizer,
                           schedule, tt._build_step_config())
    batch = tt._device_batch(_qwen_train_batch(rng, cfg, gh, gw, 1))
    _profile(card, f"one Qwen train step at 512², bs=1, S = {QWEN_TXT + 2 * gh * gw}, int8 "
             "attention, remat flash", lambda: step(dit, lora, batch, gen)["loss"].item())
    return tuple(totals)


# Path C: the same Qwen-Image-Edit 20B DiT over the W4A16 `int4` base
# (quantize.dtype int4, JAX's kernel_q4) at the 512² operating point, with
# QFLUX_FUSED_INT4=1: every GEMM of a shape JAX's fused kernel takes (K %
# 3072, N % 128, group 128) runs K6a, and its dx K6b.  The published config
# with two changes (dtype int4_requant → int4, attention dropped: bf16
# attention) and its 512² setting remat "flash".
QWEN_INT4 = copy.deepcopy(QWEN_832X576)
QWEN_INT4["model"]["quantize"] = {"enabled": True, "dtype": "int4"}
QWEN_INT4["mesh"]["remat"] = "flash"
FUSED_INT4 = "QFLUX_FUSED_INT4"  # JAX's opt-in (qflux_tpu/ops/layers.py:150), read at call time
# the K6 cases: M = 1 and 2 (the AdaLN mods and time_in at bs=1 / 2, f32 in
# and out), 256 (the text stream), 2048 and 4096 (the image stream at bs=1
# / 2, bf16) × every (K, N) of the Qwen DiT that `supports` admits
INT4_KN = [(3072, 3072), (3072, 12288), (12288, 3072), (3072, 18432)]
INT4_CASES = [(m, k, n) for m in (1, 2, 256, 2048, 4096) for k, n in INT4_KN]
INT4_MAIN = (2048, 3072, 12288)  # the MLP up-projection at bs=1: the case the table reports
# K6a / K6b against their plain versions: the same bf16 weights and
# activations on both sides (every product exact in f32), the f32 sums in
# another order, one rounding of each output: relative L2 4e-3 (one bf16 ulp
# is 2^-8 = 3.9e-3 relative) and max |diff| 2 bf16 ulps of max |ref| (2^-6 of
# it); a wrong nibble, plane or scale row gives O(1)
INT4_REL_TOL, INT4_MAX_TOL = 4e-3, 2 ** -6
# the L2 cache: each timed call reads another copy of the weight, so the
# weights timed together exceed it, as each GEMM of a forward finds its weight
# cold
L2_BYTES = 50e6


def _int4_case(gen, m, k_in, n):
    """Weights U(±1/sqrt(K)) quantized to int4 (group 128), enough copies of
    (q4, scale) to exceed the L2 cache three times, and x (f32 for M ≤ 2, as
    the mods' SiLU(temb), bf16 otherwise)."""
    from qflux_tpu_torch.ops import quant

    w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
    q4, scale = quant.quantize_kernel_int4(w, 128)
    copies = max(2, int(np.ceil(3 * L2_BYTES / (q4.numel() + scale.numel() * 4))))
    weights = [(q4.clone(), scale.clone()) for _ in range(copies)]
    dtype = torch.float32 if m <= 2 else torch.bfloat16
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(dtype)
    return weights, x


def _rotating_ms(fn, copies, reps=20, n=5) -> float:
    """Median over n windows of the mean device time of `reps` back-to-back
    calls fn(i), each on copy i % copies of the weights (CUDA events around
    the window)."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(reps):
            fn(i % copies)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def _int4_check(got, want) -> tuple[float, float, bool]:
    want = want.float()
    diff = got.float() - want
    rel = (diff.norm() / want.norm()).item()
    err = diff.abs().max().item()
    ok = (rel <= INT4_REL_TOL and err <= INT4_MAX_TOL * want.abs().max().item()
          and bool(torch.isfinite(got).all()))
    return rel, err, ok


def _host_us(fn, n=200) -> float:
    """Host time per call of `fn` (µs): the enqueue alone, without a
    synchronize inside the window (fn is timed after a warm-up, and the card
    works through the queue behind it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def _int4_phase(card: str, backward: bool) -> dict:
    """K6a (or, with `backward`, K6b) against its plain version at every
    INT4_CASES shape, through int4_matmul (the custom op) and its backward;
    two calls on the same inputs must agree to the bit.  Times (CUDA events,
    the weights rotated past the L2 cache): the kernel alone (the C entry
    point on pre-cast bf16 input into a preallocated output and workspace,
    with _int4_plan's tiling: the main kernel and, where the contraction is
    split, the reduction pass), the wrapper int4_fwd_cuda / int4_bwd_cuda
    (device time, and its host time per call), the plain version, cuBLAS bf16
    on the weight dequantized once (the library call; a yardstick only, the
    port never calls it), and JAX's default route as the port runs it.
    Prints each shape's share of the bound and factor against cuBLAS, and
    returns the main shape's numbers with every shape's rows."""
    from qflux_tpu_torch.ops import int4_matmul as ti4, quant
    from qflux_tpu_torch.ops.layers import _matmul_f32
    from qflux_tpu_torch.runtime.build import load_library

    lib = load_library().lib
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tag, name = ("int4_bwd", "K6b") if backward else ("int4", "K6a")
    entry = lib.qflux_int4_bwd if backward else lib.qflux_int4_fwd
    wrapper = ti4.int4_bwd_cuda if backward else ti4.int4_fwd_cuda
    plain = ti4.int4_matmul_dx_reference if backward else ti4.int4_matmul_reference
    gen = torch.Generator("cuda").manual_seed(17 if backward else 16)
    main, rows = None, []
    for m, k_in, n in INT4_CASES:
        weights, x = _int4_case(gen, m, k_in, n)
        q4, scale = weights[0]
        if backward:
            t = torch.randn(m, n, device="cuda", generator=gen).to(x.dtype)  # the cotangent g
            x.requires_grad_()
            ti4.int4_matmul(x, q4, scale).backward(t)
            got = x.grad
            x.grad = None
            ti4.int4_matmul(x, q4, scale).backward(t)
            again = x.grad
        else:
            t = x
            got = ti4.int4_matmul(x, q4, scale)
            again = ti4.int4_matmul(x, q4, scale)
        torch.cuda.synchronize()
        want = plain(t, q4, scale)
        rel, err, ok = _int4_check(got, want)
        same = torch.equal(got, again)
        if not (ok and got.dtype == t.dtype):
            raise AssertionError(f"{name} disagrees with its plain version at M={m} K={k_in} "
                                 f"N={n}: rel L2 {rel:.3e}, max |diff| {err:.3e}")
        if not same:
            raise AssertionError(f"{name} is not deterministic at M={m} K={k_in} N={n}: two "
                                 "calls on the same inputs differ")
        tb = t.detach().to(torch.bfloat16)
        out_cols = k_in if backward else n
        out = torch.empty(m, out_cols, device="cuda", dtype=t.dtype)
        plan = ti4._int4_plan(m, n, k_in, sms, backward)
        ws = torch.empty(max(plan.workspace, 1), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        f32 = int(t.dtype == torch.float32)
        c = len(weights)
        ms = _rotating_ms(lambda i: entry(
            tb.data_ptr(), weights[i][0].data_ptr(), weights[i][1].data_ptr(), out.data_ptr(),
            m, n, k_in, k_in // 128, f32, plan.mt, plan.splits, ws.data_ptr(), stream), c)
        wrap_ms = _rotating_ms(lambda i: wrapper(tb, *weights[i], t.dtype), c)
        wrap_us = _host_us(lambda: wrapper(tb, q4, scale, t.dtype))
        entry_us = _host_us(lambda: entry(
            tb.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k_in,
            k_in // 128, f32, plan.mt, plan.splits, ws.data_ptr(), stream))
        plain_ms = _rotating_ms(lambda i: plain(t, *weights[i]), c, reps=3, n=3)
        dq = [quant.dequantize_kernel_int4(*w, torch.bfloat16) for w in weights]
        if backward:
            lib_ms = _rotating_ms(lambda i: torch.mm(tb, dq[i].t()), c)
        else:
            lib_ms = _rotating_ms(lambda i: torch.mm(tb, dq[i]), c)
        del dq
        if backward:
            route_ms = _rotating_ms(lambda i: torch.mm(
                t, quant.dequantize_kernel_int4(*weights[i], t.dtype).t()), c)
        else:
            route_ms = _rotating_ms(lambda i: _matmul_f32(
                t, quant.dequantize_kernel_int4(*weights[i], t.dtype).t()), c)
        ops = 2.0 * m * k_in * n
        # the input (bf16, as the kernel reads it), q4, the scales read once; the output
        # written once
        n_bytes = (2 * m * (n if backward else k_in) + k_in * n // 2 + 4 * (k_in // 128) * n
                   + m * out_cols * t.element_size())
        bound = _bound(n_bytes, ops, PEAK_BF16_PER_MS)
        row = {"m": m, "k": k_in, "n": n, "ms": ms, "tflops": ops / ms / 1e9,
               "bound_share": bound["bound_ms"] / ms, "library_ms": lib_ms,
               "cublas_factor": ms / lib_ms, "wrapper_ms": wrap_ms, "wrapper_host_us": wrap_us,
               "entry_host_us": entry_us, "mt": plan.mt, "splits": plan.splits}
        rows.append(row)
        print(f"[{tag}] {'dx of ' if backward else ''}M={m} K={k_in} N={n} "
              f"{'g' if backward else 'x'} {str(t.dtype)[6:]}: rel L2 {rel:.3e} (tol "
              f"{INT4_REL_TOL}), max |kernel - plain| {err:.3e}, two calls identical {same}; "
              f"{name} {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s, {100 * row['bound_share']:.1f}% "
              f"of the bound, {row['cublas_factor']:.2f}x cuBLAS; mt {plan.mt}, splits "
              f"{plan.splits}, {plan.blocks} blocks), wrapper {wrap_ms:.4f} ms on the card and "
              f"{wrap_us:.1f} us host per call (C entry {entry_us:.1f} us), plain "
              f"{plain_ms:.3f} ms, cuBLAS bf16 on the dequantized weight {lib_ms:.4f} ms, "
              f"default route {route_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}) [{card}]", flush=True)
        if (m, k_in, n) == INT4_MAIN:
            main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "default_route_ms": route_ms, "wrapper_ms": wrap_ms,
                    "wrapper_host_us": wrap_us, **bound}
        del weights, x, t, got, again, want, tb, out, ws
        torch.cuda.empty_cache()
    return {**main, "shapes": rows}


def phase_int4_wrapper_host(card: str) -> dict:
    """The host time per call (µs) of the K6 wrappers, int4_fwd_cuda and
    int4_bwd_cuda, at the main shape and at M = 1 (K = 3072, N = 3072: a
    split contraction), median of 7 windows of 200 calls each, the two
    shapes in turns.  Uses only the wrappers' signature, so the same
    function times an earlier checkout's package put first on sys.path."""
    from qflux_tpu_torch.ops import int4_matmul as ti4, quant

    gen = torch.Generator("cuda").manual_seed(22)
    cases = {}
    for m, k_in, n in (INT4_MAIN, (1, 3072, 3072)):
        w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
        q4, scale = quant.quantize_kernel_int4(w, 128)
        dtype = torch.float32 if m <= 2 else torch.bfloat16
        xb = torch.randn(m, k_in, device="cuda", generator=gen).to(torch.bfloat16)
        gb = torch.randn(m, n, device="cuda", generator=gen).to(torch.bfloat16)
        cases[(m, k_in, n)] = (
            lambda xb=xb, q4=q4, scale=scale, dtype=dtype: ti4.int4_fwd_cuda(xb, q4, scale, dtype),
            lambda gb=gb, q4=q4, scale=scale, dtype=dtype: ti4.int4_bwd_cuda(gb, q4, scale, dtype))
    times = {(c, kind): [] for c in cases for kind in ("fwd", "bwd")}
    for _ in range(7):
        for c, (fwd, bwd) in cases.items():
            times[(c, "fwd")].append(_host_us(fwd))
            times[(c, "bwd")].append(_host_us(bwd))
    out = {f"{kind} M={c[0]} K={c[1]} N={c[2]}": statistics.median(v)
           for (c, kind), v in times.items()}
    print("[int4_host] wrapper host time per call, median of 7 windows of 200 calls: "
          + "; ".join(f"{k} {v:.1f} us" for k, v in out.items()) + f" [{card}]", flush=True)
    return out


def phase_int4_kernel(card: str) -> dict:
    """K6a at INT4_CASES (see _int4_phase)."""
    return _int4_phase(card, backward=False)


def phase_int4_bwd_kernel(card: str) -> dict:
    """K6b at the dx of every INT4_CASES case (g [M, N] in x's dtype → dx
    [M, K]), through int4_matmul's backward (see _int4_phase)."""
    return _int4_phase(card, backward=True)


class _CutDepth:
    """Inside the `with` block the config class `name` of `module` defaults
    to other block counts, so a Trainer (or the CLI) draws a DiT of the
    published width cut in depth: the blocks are those of the full draw
    (the same seed, the blocks drawn in order after the rest)."""

    def __init__(self, module, name: str, **depth):
        self.module, self.name, self.depth = module, name, depth

    def __enter__(self):
        full = self.orig = getattr(self.module, self.name)
        fields = [(k, int, dataclasses.field(default=v)) for k, v in self.depth.items()]
        setattr(self.module, self.name, dataclasses.make_dataclass(
            f"Cut{self.name}", fields, bases=(full,), frozen=True))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


# the published DiT at full width cut in depth to this many of its 60
# blocks: Qwen-Image-Edit-Plus (phase H) and the remat policies (phase I)
CUT_BLOCKS = 12
# and paths A and C to this many (the smoke's time budget, which phases I
# and J share: 20 and 10 before phase J)
AC_BLOCKS = 6


def _qwen_cut(raw: dict, num_layers: int = CUT_BLOCKS):
    """A Trainer of `raw` with its model loaded, the DiT drawn (and
    quantized) block by block at its first `num_layers` blocks only: the
    adapter's load runs with the Qwen DiT's config defaulting to that
    depth, so the Trainer, its bundle and its adapter hold one consistent
    cut config and the blocks are those of the full draw (the same seed,
    the blocks drawn in order after the rest).  Returns (trainer, load s)."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.models.qwen import transformer as qwen_dit
    from qflux_tpu_torch.trainer.base import Trainer

    trainer = Trainer(config_from_dict(raw), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _CutDepth(qwen_dit, "QwenImageConfig", num_layers=num_layers):
        trainer.load_model()
    if len(trainer.bundle.dit_params.blocks) != num_layers:
        raise AssertionError(f"the cut DiT has {len(trainer.bundle.dit_params.blocks)} blocks")
    torch.cuda.synchronize()
    return trainer, time.perf_counter() - t0


def phase_int4_predict(card: str):
    """Path C, predict: the 20B DiT over the `int4` base at 512² (S = 2304),
    QFLUX_FUSED_INT4=1.  One full-width forward through K6a + K1 against the
    plain W4A16 route (set_int4_impl "plain") and against JAX's default
    dequant route (the opt-in unset, which must launch no K6a); then three
    requests (bs 1, 1, 2) through Trainer.predict_from_embeddings, each with
    exactly 60 K1 and 841 K6a launches per denoising step and nothing else;
    then a profiled step.  Returns the trainer and the K1 and K6a launches
    of the requests."""
    from qflux_tpu_torch.ops.layers import iter_dense_paths, merge_lora, set_int4_impl

    trainer, load_s = _qwen_cut(QWEN_INT4, AC_BLOCKS)
    dit, cfg = trainer.bundle.dit_params, trainer.bundle.dit_cfg
    denses = [m for _, m in iter_dense_paths(dit)]
    quantized = [m for m in denses if m.q4 is not None]
    if {m.q_form for m in quantized} != {"int4"}:
        raise AssertionError("path C's base is not all W4A16")
    b_q = sum(m.q4.numel() + m.scale.numel() * 4 for m in quantized)
    b_full = sum(p.numel() * p.element_size() for p in dit.parameters())
    print(f"[int4] DiT {cfg.num_layers} blocks, dim {cfg.dim}, {len(quantized)} of "
          f"{len(denses)} dense layers W4A16 int4: {b_q} bytes of packed nibbles and group "
          f"scales, {b_full} bytes bf16; loaded in {load_s:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated()} bytes [{card}]", flush=True)
    n_blocks = cfg.num_layers
    # K6a per forward: per block the eight attention projections, the four
    # MLP GEMMs and the two AdaLN mods; time_in's second linear.  img_in (K =
    # 64), txt_in (K = 3584), time_in's first linear (K = 256) and proj_out
    # (N = 64) fail `supports` and take the dequant route
    per_forward = 14 * n_blocks + 1
    fwd_counts = _rq((n_blocks, 0, 0, 0, 0, 0, per_forward, 0, 0, 0))
    rng = np.random.default_rng(18)
    gen = torch.Generator("cuda").manual_seed(19)
    gh, gw = trainer.adapter.latent_grid(QWEN512, QWEN512)
    s = QWEN_TXT + 2 * gh * gw
    lora = trainer.build_lora()
    _perturb_b(lora, gen)
    batch = trainer._device_batch(_qwen_request(rng, cfg, gh, gw, 1))
    lat = torch.randn(1, gh * gw, cfg.in_channels, device="cuda", generator=gen).to(
        torch.bfloat16)
    sigma = torch.full((1,), 1.0, dtype=torch.bfloat16, device="cuda")
    merge_lora(dit, lora)
    try:
        with torch.inference_mode():
            os.environ[FUSED_INT4] = "1"
            c0 = _launch_counts()
            v_k = trainer.adapter.predict_velocity(dit, batch, lat, sigma).float()
            launched = tuple(b - a for a, b in zip(c0, _launch_counts()))
            set_int4_impl(dit, "plain")
            v_p = trainer.adapter.predict_velocity(dit, batch, lat, sigma).float()
            set_int4_impl(dit, "auto")
            del os.environ[FUSED_INT4]
            c0 = _launch_counts()
            v_d = trainer.adapter.predict_velocity(dit, batch, lat, sigma).float()
            launched_default = tuple(b - a for a, b in zip(c0, _launch_counts()))
    finally:
        set_int4_impl(dit, "auto")
        os.environ.pop(FUSED_INT4, None)
        merge_lora(dit, None)
    rel_p = (torch.linalg.vector_norm(v_k - v_p) / torch.linalg.vector_norm(v_p)).item()
    rel_d = (torch.linalg.vector_norm(v_k - v_d) / torch.linalg.vector_norm(v_d)).item()
    print(f"[int4] full-width forward [1, {gh * gw}, {v_k.shape[-1]}], S = {s}: K6a + K1 vs the "
          f"plain W4A16 route + K1: rel L2 err {rel_p:.3e} (tol {FORWARD_REL_TOL}); vs the "
          f"default dequant route (no opt-in; each GEMM output rounds to bf16 once more on the "
          f"fused route): {rel_d:.3e} (tol {FORWARD_REL_TOL}); |v| rms "
          f"{v_d.pow(2).mean().sqrt().item():.4f}; {COUNT_NAMES} launches {launched} with the "
          f"opt-in, {launched_default} without [{card}]", flush=True)
    if launched != fwd_counts:
        raise AssertionError(f"the int4 forward launched {COUNT_NAMES} {launched}, expected "
                             f"{fwd_counts}")
    if launched_default != _rq((n_blocks, 0, 0, 0, 0, 0, 0, 0, 0, 0)):
        raise AssertionError(f"the int4 forward without {FUSED_INT4} launched {COUNT_NAMES} "
                             f"{launched_default}: K6a must not run")
    if not (rel_p <= FORWARD_REL_TOL and rel_d <= FORWARD_REL_TOL
            and bool(torch.isfinite(v_k).all())):
        raise AssertionError("the int4 forward through K6a disagrees with the plain W4A16 or "
                             "the default route")
    del v_k, v_p, v_d, batch
    torch.cuda.empty_cache()

    # the main path: three requests with the opt-in, counts reset just before
    os.environ[FUSED_INT4] = "1"
    try:
        _reset_counts()
        secs_by_b = {1: [], 2: []}
        for i, (b, seed) in enumerate([(1, 62), (1, 63), (2, 64)]):
            emb = _qwen_request(rng, cfg, gh, gw, b)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            c0 = _launch_counts()
            t0 = time.perf_counter()
            images = trainer.predict_from_embeddings(emb, QWEN512, QWEN512, lora=lora, seed=seed)
            secs = time.perf_counter() - t0
            stats = trainer.last_predict
            launched = tuple(b_ - a for a, b_ in zip(c0, _launch_counts()))
            step_ms = 1000 * stats["denoise_s"] / stats["steps"]
            secs_by_b[b].append(step_ms)
            print(f"[int4] request {i}: bs={b} seed={seed} {secs:.3f} s, {step_ms:.1f} "
                  f"ms/denoising step ({stats['steps']} steps), VAE decode "
                  f"{1000 * stats['decode_s']:.1f} ms, peak mem "
                  f"{torch.cuda.max_memory_allocated()} bytes, {COUNT_NAMES} launches "
                  f"{launched}, images {images.dtype} {list(images.shape)} mean "
                  f"{images.mean():.2f} [{card}]", flush=True)
            if images.dtype != np.uint8 or images.shape != (b, QWEN512, QWEN512, 3):
                raise AssertionError(f"int4 request {i}: images {images.dtype} {images.shape}")
            if not stats["latents_finite"]:
                raise AssertionError(f"int4 request {i}: non-finite latents")
            want = tuple(STEPS * c for c in fwd_counts)
            if launched != want:
                raise AssertionError(f"int4 request {i}: {COUNT_NAMES} launched {launched} "
                                     f"times, expected {want}")
        counts = _launch_counts()
        for b, ms in secs_by_b.items():
            print(f"[int4] predict bs={b}: ms/denoising step median {statistics.median(ms):.1f}, "
                  f"spread {min(ms):.1f}-{max(ms):.1f} over {len(ms)} requests [{card}]",
                  flush=True)
        batch = trainer._device_batch(_qwen_request(rng, cfg, gh, gw, 1))
        merge_lora(dit, lora)

        def denoising_step():
            with torch.inference_mode():
                trainer.adapter.predict_velocity(dit, batch, lat, sigma)

        _profile(card, f"one Qwen denoising step over the int4 base at 512², bs=1, S = {s}",
                 denoising_step)
    finally:
        os.environ.pop(FUSED_INT4, None)
        merge_lora(dit, None)
    return trainer, counts[0], counts[6]


def phase_int4_train(card: str, trainer) -> tuple[int, ...]:
    """Path C, train: the LoRA train step over the `int4` base at 512² under
    remat "flash", QFLUX_FUSED_INT4=1, on the predict phase's model.  One
    step's LoRA gradients through K6a + K6b + K1 + K2 against the plain
    W4A16 route + plain attention (remat "full"); then Trainer.fit, 4 steps
    at bs=1 and at bs=2, each step launching K1 and K2 60 times, K6a 1,561
    and K6b 711 times and nothing else; then a profiled step.  Returns the
    launches of the fit runs (_launch_counts' order)."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.losses import MseLoss
    from qflux_tpu_torch.ops.layers import mark_trainable, set_int4_impl
    from qflux_tpu_torch.trainer.base import Trainer
    from qflux_tpu_torch.trainer.train_step import (TrainStepConfig, _loss_for_microbatch,
                                                    lora_leaves, make_train_step)

    dit, cfg = trainer.bundle.dit_params, trainer.bundle.dit_cfg
    n = cfg.num_layers
    # per step: K1 / K2 once a block; K6a 841 in the forward + 12 a block in
    # the recompute (the mods and time_in run outside the checkpointed
    # blocks, on σ alone); K6b wherever the GEMM's input needs a gradient and
    # its output reaches the loss: 6 in block 0 (its q/k/v inputs carry
    # none), 12 in each middle block, 9 in the last (its add_out and text MLP
    # feed only the dropped text stream); proj_out takes the dequant route
    per_step = _rq((n, n, 0, 0, 0, 0, 14 * n + 1 + 12 * n, 6 + 12 * (n - 2) + 9, 0, 0))
    zero_grad = {f"blocks/{n - 1}/attn/add_q", f"blocks/{n - 1}/attn/add_out"}
    rng = np.random.default_rng(20)
    gen = torch.Generator("cuda").manual_seed(21)
    gh, gw = trainer.adapter.latent_grid(QWEN512, QWEN512)
    s = QWEN_TXT + 2 * gh * gw

    def make_trainer(steps):
        raw = copy.deepcopy(QWEN_INT4)
        raw["train"]["max_train_steps"] = steps
        tt = Trainer(config_from_dict(raw), device="cuda")
        tt.adapter, tt.bundle = trainer.adapter, trainer.bundle
        return tt

    os.environ[FUSED_INT4] = "1"
    try:
        # one step's LoRA gradients: kernels (flash) vs plain W4A16 + plain attention (full)
        tt = make_trainer(1)
        lora = mark_trainable(tt.build_lora())
        _perturb_b(lora, gen)
        batch = tt._device_batch(_qwen_train_batch(rng, cfg, gh, gw, 1))
        noise = torch.randn(batch["image_latents"].shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        sigma = torch.full((1,), 0.6, device="cuda", dtype=torch.bfloat16)
        grads = {}
        plain = dataclasses.replace(trainer.adapter, attn_impl="plain", remat_policy="full")
        for name, adapter in (("kernels", trainer.adapter), ("plain", plain)):
            set_int4_impl(dit, "auto" if name == "kernels" else "plain")
            for leaf in lora.values():
                for t in leaf.values():
                    t.grad = None
            torch.cuda.synchronize()
            c0 = _launch_counts()
            t0 = time.perf_counter()
            loss = _loss_for_microbatch(dit, lora, batch, noise, sigma,
                                        adapter.predict_velocity, MseLoss(), TrainStepConfig())
            loss.backward()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launched = tuple(b - a for a, b in zip(c0, _launch_counts()))
            grads[name] = {p: torch.cat([torch.zeros_like(leaf[k]).flatten()
                                         if leaf[k].grad is None else leaf[k].grad.flatten()
                                         for k in ("a", "b")]) for p, leaf in lora.items()}
            print(f"[int4_train] gradient check, {name}: loss {loss.item():.5f}, forward + "
                  f"backward {secs:.3f} s, {COUNT_NAMES} launches {launched} [{card}]",
                  flush=True)
            if name == "kernels" and launched != per_step:
                raise AssertionError(f"the int4 kernel step launched {COUNT_NAMES} {launched} "
                                     f"times, expected {per_step}")
        set_int4_impl(dit, "auto")
        gk = torch.cat(list(grads["kernels"].values()))
        gp = torch.cat(list(grads["plain"].values()))
        rel = ((gk - gp).norm() / gp.norm()).item()
        print(f"[int4_train] full-width LoRA gradients, K6a + K6b + K1 + K2 vs the plain W4A16 "
              f"route + plain attention: rel L2 err {rel:.3e} (tol {QWEN_GRAD_REL_TOL}) "
              f"[{card}]", flush=True)
        if not (rel <= QWEN_GRAD_REL_TOL and bool(torch.isfinite(gk).all())):
            raise AssertionError("int4 LoRA gradients through K6a + K6b disagree with the plain "
                                 "path")
        for p, g in grads["kernels"].items():
            if bool(g.abs().sum() > 0) != (p not in zero_grad):
                raise AssertionError(f"LoRA layer {p}: gradient through the kernels "
                                     f"{'zero' if p not in zero_grad else 'nonzero'}")
        del grads, lora, batch, noise, loss, gk, gp
        torch.cuda.empty_cache()

        # the main path: Trainer.fit, counts reset just before each run
        totals = [0] * len(per_step)
        for b in (1, 2):
            tt = make_trainer(TRAIN_STEPS)
            batches = [_qwen_train_batch(rng, cfg, gh, gw, b) for _ in range(TRAIN_STEPS)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            fitted = _fit_in_tmp(tt, batches)
            launched = _launch_counts()
            totals = [t + c for t, c in zip(totals, launched)]
            hist = tt.history
            ms = [1000 * h["step_s"] for h in hist]
            warm = ms[1:] if len(ms) > 1 else ms
            print(f"[int4_train] fit bs={b}: {len(hist)} steps, ms/step "
                  + ", ".join(f"{m:.1f}" for m in ms)
                  + f" (median after the first {statistics.median(warm):.1f}, spread "
                  f"{min(warm):.1f}-{max(warm):.1f}), peak mem "
                  f"{torch.cuda.max_memory_allocated()} bytes, loss "
                  + ", ".join(f"{h['loss']:.5f}" for h in hist) + ", grad_norm "
                  + ", ".join(f"{h['grad_norm']:.4e}" for h in hist)
                  + f", {COUNT_NAMES} launches {launched} [{card}]", flush=True)
            want = tuple(len(hist) * c for c in per_step)
            if len(hist) != TRAIN_STEPS or not all(np.isfinite(h["loss"]) for h in hist):
                raise AssertionError(f"int4 fit bs={b}: {len(hist)} steps or non-finite losses")
            if launched != want:
                raise AssertionError(f"int4 fit bs={b}: {COUNT_NAMES} launched {launched} "
                                     f"times, expected {want} ({per_step} per step)")
            for p, leaf in fitted.items():
                if bool(leaf["b"].abs().sum() > 0) != (p not in zero_grad):
                    raise AssertionError(f"int4 fit bs={b}: LoRA b of {p} "
                                         f"{'did not move' if p not in zero_grad else 'moved'}")
            del fitted, batches
            torch.cuda.empty_cache()

        # one bs=1 train step under the profiler
        lora = mark_trainable(tt.build_lora())
        optimizer, schedule = tt.build_optimizer(lora_leaves(lora)[0])
        step = make_train_step(tt.adapter.predict_velocity, tt.build_criterion(), optimizer,
                               schedule, tt._build_step_config())
        batch = tt._device_batch(_qwen_train_batch(rng, cfg, gh, gw, 1))
        _profile(card, f"one Qwen train step over the int4 base at 512², bs=1, S = {s}, remat "
                 "flash", lambda: step(dit, lora, batch, gen)["loss"].item())
    finally:
        os.environ.pop(FUSED_INT4, None)
        set_int4_impl(dit, "auto")
    return tuple(totals)


# kernel-name fragments → the groups of the step profiles
# ---------------------------------------------------------------------------
# the file layer: checkpoints, resume, weights and LoRA files (phases A-C)

# ---------------------------------------------------------------------------
# the quantized bases that JAX runs in XLA (phase E)

# E(a)'s W8A8 GEMM cases: FLUX.1-Kontext-dev's projections, MLP up and MLP
# down at 512² (2048 image rows of target + control, 512 text rows, 2560
# joint rows of a single block), and two ragged row counts
W8_KN = [(3072, 3072), (3072, 12288), (12288, 3072)]
W8_CASES = ([(m, k, n) for m in (2048, 512, 2560) for k, n in W8_KN]
            + [(33, 3072, 12288), (1000, 12288, 3072)])
W8_MAIN = (2048, 3072, 12288)  # the case the kernel table reports (and its dx)
QUANT_FORMS = ("int8", "fp8_e4m3", "fp8_e5m2", "int8_dynamic", "int4", "int4_requant",
               "int4_dynamic")
E_FORMS = ("int8", "fp8_e4m3", "fp8_e5m2", "int4_dynamic")  # E(c): FLUX cut to 2 + 2 blocks
E_DEPTH = (2, 2)
E_QWEN_STEPS = 4
# the bf16 FLUX phases' numbers, printed beside phase E(b)'s
BF16_FLUX: dict = {}


def _qcfg(form: str):
    """A quantize section in `form` with the default group and skip patterns."""
    from qflux_tpu_torch.config import config_from_dict

    return config_from_dict({"model": {"quantize": {"enabled": True, "dtype": form}}}
                            ).model.quantize


def _bits(t) -> torch.Tensor:
    """A tensor's bytes on the host (fp8, int8 and f32 alike)."""
    return t.detach().contiguous().cpu().view(torch.uint8)


def _quant_cpu_check(card: str, label: str, block, qcfg, prefix: str) -> int:
    """Quantize `block` (full precision, on the card) in place on the card,
    and a copy of it on the CPU, each with quantize_tree: every quantized
    leaf (q or q4, scale, the requant factors) must be equal to the bit, and
    so must the set of layers quantized.  Returns the leaves compared."""
    from qflux_tpu_torch.ops.layers import iter_dense_paths
    from qflux_tpu_torch.ops.quant import quantize_tree

    cpu = copy.deepcopy(block).to("cpu")
    t0 = time.perf_counter()
    quantize_tree(block, qcfg, prefix=prefix)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    quantize_tree(cpu, qcfg, prefix=prefix)
    t_cpu = time.perf_counter() - t0
    n, bad = 0, []
    for (path, a), (_, b) in zip(iter_dense_paths(block), iter_dense_paths(cpu)):
        if a.q_form != b.q_form:
            raise AssertionError(f"{label}: {prefix}{path} is {a.q_form} on the card, "
                                 f"{b.q_form} on the CPU")
        for name in ("q4", "q", "scale", "rq_f", "rq_s_vec"):
            ta, tb = getattr(a, name), getattr(b, name)
            if ta is None and tb is None:
                continue
            n += 1
            if ta is None or tb is None or not torch.equal(_bits(ta), _bits(tb)):
                bad.append(f"{path}.{name}")
    print(f"{label} {qcfg.dtype}: {n} quantized leaves of {prefix} quantized on the card "
          f"({t_card:.2f} s) and on the CPU ({t_cpu:.2f} s): {n - len(bad)} equal to the bit "
          f"[{card}]", flush=True)
    if bad or n == 0:
        raise AssertionError(f"{label}: card and CPU quantization differ at {bad[:4]}")
    return n


def _w8_operands(gen, m, k_in, n):
    """A W8A8 case: a weight U(±1/sqrt(K)) quantized per channel to int8 (q
    [N, K], the port's layout, and s_w [N]), enough copies of (q, s_w) to
    exceed the L2 cache three times, and bf16 x [m, K] and g [m, N]."""
    from qflux_tpu_torch.ops import quant

    w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
    q, scale = quant.quantize_kernel(w, "int8")
    q, sw = q.t().contiguous(), scale[0].contiguous()
    copies = max(2, int(np.ceil(3 * L2_BYTES / (q.numel() + 4 * n))))
    weights = [(q.clone(), sw.clone()) for _ in range(copies)]
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn(m, n, device="cuda", generator=gen).to(torch.bfloat16)
    return weights, x, g


def _w8_gemm_alone(a, sr, bs, scols, out_dtype, reps=20) -> dict:
    """The W8A8 GEMM's C entry alone, back to back (CUDA events around the
    window) on `a` [M, Kc] int8 and its row scales `sr`, each call on the
    next of the B operands `bs` ([Nout, Kc] int8: q for the forward, qᵀ for
    the dx) past the L2 cache, with `_rq_plan`'s split and a preallocated
    workspace; `scols` the forward's column scales (None for the dx).
    Returns the median ms and the output of a first call."""
    from qflux_tpu_torch.ops import int4_matmul as ti4
    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    m, kc = a.shape
    nout = bs[0].shape[0]
    backward = scols is None
    k_in, n = (nout, kc) if backward else (kc, nout)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ti4._rq_plan(m, n, k_in, k_in, sms, backward)
    ws = torch.empty(max(plan.workspace, 1), device="cuda", dtype=torch.int32)
    out = torch.empty(m, nout, device="cuda", dtype=out_dtype)
    stream = torch.cuda.current_stream().cuda_stream
    f32 = int(out_dtype == torch.float32)

    def call(i):
        return kl.lib.qflux_int8_gemm(a.data_ptr(), bs[i].data_ptr(), sr.data_ptr(),
                                      None if backward else scols[i].data_ptr(), out.data_ptr(),
                                      m, nout, kc, f32, plan.splits, ws.data_ptr(), stream)

    kl.check(call(0), "W8A8 GEMM alone")
    first = out.clone()
    return {"ms": _rotating_ms(call, len(bs), reps=reps), "out": first, "splits": plan.splits}


def _transpose_alone(weights, reps=20) -> tuple[float, torch.Tensor]:
    """The transpose's C entry alone, back to back over the weight copies
    into a preallocated [K, N] output: (median ms, the first qᵀ)."""
    from qflux_tpu_torch.runtime.build import load_library

    kl = load_library()
    n, k_in = weights[0][0].shape
    out = torch.empty(k_in, n, device="cuda", dtype=torch.int8)
    stream = torch.cuda.current_stream().cuda_stream

    def call(i):
        return kl.lib.qflux_int8_transpose(weights[i][0].data_ptr(), out.data_ptr(), n, k_in,
                                           stream)

    kl.check(call(0), "transpose alone")
    first = out.clone()
    return _rotating_ms(call, len(weights), reps=reps), first


def phase_w8a8_kernel(card: str) -> tuple[dict, dict, dict]:
    """Phase E(a).  First the repair's probe: JAX's eager int4 scale
    amax / 7 on the card and on the CPU, as the port computed it before
    (a Python-scalar divisor, which CUDA turns into a product with the
    reciprocal), then as it does now (`quant._div`); then every quantized
    form's quantization on the card against the CPU's, to the bit, at one
    full-width FLUX dual block.  Then the W8A8 matmul (ops/int8_matmul.py:
    the row quantization, the GEMM of csrc/int8_gemm.cu, and in the
    backward the transpose and the dx GEMM) against its plain version
    (quant.dyn_int8_fwd / dyn_int8_dx) at W8_CASES, bf16: forward and dx
    equal to the bit, two calls identical.  Times (CUDA events, weights
    rotated past the L2 cache): the GEMM alone, forward and dx, the
    transpose alone, the wrapper (row quantization + GEMM), the plain
    version, torch._int_mm on the same int8 operands (q as the [K, N] view
    qᵀ and contiguous), and cuBLAS bf16 on the dequantized weight.  Returns
    the main case's numbers: (forward GEMM, dx GEMM, transpose)."""
    from qflux_tpu_torch.models.flux import transformer as flux
    from qflux_tpu_torch.ops import int4_matmul as ti4
    from qflux_tpu_torch.ops import int8_matmul as ti8
    from qflux_tpu_torch.ops import quant

    # the repair's probe
    gen = torch.Generator("cpu").manual_seed(60)
    w = (torch.rand(3072, 3072, generator=gen) * 2 - 1) / 3072 ** 0.5
    amax = w.reshape(24, 128, 3072).abs().amax(dim=1)
    old = (torch.clamp_min(amax.cuda() / 7.0, 1e-12).cpu() != torch.clamp_min(amax / 7.0, 1e-12))
    q_cpu, s_cpu = quant.quantize_kernel_int4(w, 128)
    q_card, s_card = quant.quantize_kernel_int4(w.cuda(), 128)
    same = torch.equal(s_card.cpu(), s_cpu) and torch.equal(q_card.cpu(), q_cpu)
    print(f"[w8a8] repair probe, a 3072 x 3072 weight's {amax.numel()} int4 group scales: "
          f"amax / 7.0 by a Python scalar differs between the card and the CPU in "
          f"{int(old.sum())}; quantize_kernel_int4 (a tensor divisor) on the card equals the "
          f"CPU's q4 and scales to the bit: {same} [{card}]", flush=True)
    if not same:
        raise AssertionError("quantize_kernel_int4 differs between the card and the CPU")
    cfg = flux.FluxConfig()
    g_block = torch.Generator("cuda").manual_seed(61)
    for form in QUANT_FORMS:
        block = flux.DualBlock(cfg, device="cuda", dtype=torch.bfloat16)
        with torch.no_grad():
            for _, d in block.named_modules():
                if hasattr(d, "init_") and d.weight is not None:
                    d.init_(g_block)
        _quant_cpu_check(card, "[w8a8] quantization", block, _qcfg(form), "dual/0/")
        del block
    torch.cuda.empty_cache()

    gen = torch.Generator("cuda").manual_seed(62)
    main = {}
    for m, k_in, n in W8_CASES:
        weights, x, g = _w8_operands(gen, m, k_in, n)
        q, sw = weights[0]
        got = ti8.dyn_int8_matmul(x, q, sw)
        again = ti8.dyn_int8_matmul(x, q, sw)
        want = quant.dyn_int8_fwd(x, q, sw)
        xr = x.clone().requires_grad_()
        ti8.dyn_int8_matmul(xr, q, sw).backward(g)
        dx = xr.grad
        xr.grad = None
        ti8.dyn_int8_matmul(xr, q, sw).backward(g)
        dx_again = xr.grad
        dx_want = quant.dyn_int8_dx(g, q, sw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        dx_err = (dx.float() - dx_want.float()).abs().max().item()
        if not (torch.equal(got, want) and torch.equal(dx, dx_want)
                and bool(torch.isfinite(got).all()) and bool(torch.isfinite(dx).all())):
            raise AssertionError(f"W8A8 differs from its plain version at M={m} K={k_in} N={n}: "
                                 f"max |diff| forward {err}, dx {dx_err}")
        if not (torch.equal(got, again) and torch.equal(dx, dx_again)):
            raise AssertionError(f"W8A8 is not deterministic at M={m} K={k_in} N={n}")
        xq, sx = quant._rowquant(x)
        gq, sg = quant._rowquant(g.float() * sw)
        c = len(weights)
        fwd = _w8_gemm_alone(xq, sx.reshape(m), [w_[0] for w_ in weights],
                             [w_[1] for w_ in weights], torch.bfloat16)
        t_ms, qt = _transpose_alone(weights)
        if not (torch.equal(fwd["out"], want) and torch.equal(qt, q.t())):
            raise AssertionError(f"the W8A8 GEMM or transpose alone differs at M={m} K={k_in} "
                                 f"N={n}")
        qts = [w_[0].t().contiguous() for w_ in weights]
        bwd = _w8_gemm_alone(gq, sg.reshape(m), qts, None, torch.bfloat16)
        if not torch.equal(bwd["out"], dx_want):
            raise AssertionError(f"the W8A8 dx GEMM alone differs at M={m} K={k_in} N={n}")
        wrapper_ms = _rotating_ms(lambda i: ti8.dyn_int8_matmul(x, *weights[i]), c)

        def dx_wrapper(i):
            gq_, sg_ = ti4.rowquant_cuda(g, weights[i][1])
            return ti8.int8_gemm_dx_cuda(gq_, ti8.int8_transpose_cuda(weights[i][0]), sg_,
                                         torch.bfloat16)

        dx_wrapper_ms = _rotating_ms(dx_wrapper, c)
        plain_ms = _rotating_ms(lambda i: quant.dyn_int8_fwd(x, *weights[i]), c, reps=3, n=3)
        dx_plain_ms = _rotating_ms(lambda i: quant.dyn_int8_dx(g, *weights[i]), c, reps=3, n=3)
        t_plain_ms = _rotating_ms(lambda i: weights[i][0].t().contiguous(), c)
        try:
            lib_ms = _rotating_ms(lambda i: torch._int_mm(xq, weights[i][0].t()), c)
            lib_kn = [w_[0].t().contiguous() for w_ in weights[:4]]
            lib_c_ms = _rotating_ms(lambda i: torch._int_mm(xq, lib_kn[i]), len(lib_kn))
            dx_lib_ms = _rotating_ms(lambda i: torch._int_mm(gq, weights[i][0]), c)
            del lib_kn
        except RuntimeError as e:  # a shape torch._int_mm refuses: no yardstick
            lib_ms = lib_c_ms = dx_lib_ms = None
            print(f"[w8a8] torch._int_mm refuses M={m} K={k_in} N={n}: {e}", flush=True)
        deq = [quant.dequantize_kernel(w_[0], w_[1][:, None], torch.bfloat16) for w_ in
               weights[:4]]
        bf16_ms = _rotating_ms(lambda i: torch.mm(x, deq[i].t()), len(deq))
        # the weight-only route (int8 / fp8, and W8A8's tiny-M calls): the
        # dequantize pass, and the whole product
        deq_ms = _rotating_ms(lambda i: quant.dequantize_kernel(
            weights[i][0], weights[i][1][:, None], torch.bfloat16), c)
        wo_ms = _rotating_ms(lambda i: quant.wo_matmul(x, *weights[i]), c)
        dx_bf16_ms = _rotating_ms(lambda i: torch.mm(g, deq[i]), len(deq))
        del deq, qts
        ops = 2.0 * m * k_in * n
        # the int8 input, the weight, the row and channel scales read once; the
        # bf16 output written once
        bound = _bound(m * k_in + k_in * n + 4 * m + 4 * n + 2 * m * n, ops, PEAK_INT8_PER_MS)
        dx_bound = _bound(m * n + k_in * n + 4 * m + 2 * m * k_in, ops, PEAK_INT8_PER_MS)
        t_bound = _bound(2 * k_in * n, 0, PEAK_INT8_PER_MS)

        def f(v):
            return "n/a" if v is None else f"{v:.4f} ms"

        print(f"[w8a8] M={m} K={k_in} N={n}: forward and dx equal to the plain version (max "
              f"|diff| {err} / {dx_err}, tol 0), two calls identical; GEMM alone "
              f"{fwd['ms']:.4f} ms ({ops / fwd['ms'] / 1e9:.1f} TOPS, "
              f"{100 * bound['bound_ms'] / fwd['ms']:.1f}% of the {bound['bound_ms']:.4f} ms "
              f"bound, splits {fwd['splits']}), wrapper {wrapper_ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, torch._int_mm {f(lib_ms)} (qT view) / {f(lib_c_ms)} "
              f"([K, N] contiguous), cuBLAS bf16 on the dequantized weight {bf16_ms:.4f} ms; "
              f"weight-only route {wo_ms:.4f} ms (its dequantize pass {deq_ms:.4f} ms); "
              f"dx GEMM alone {bwd['ms']:.4f} ms ({100 * dx_bound['bound_ms'] / bwd['ms']:.1f}% "
              f"of its bound, splits {bwd['splits']}), transpose alone {t_ms:.4f} ms "
              f"({100 * t_bound['bound_ms'] / t_ms:.1f}% of its {t_bound['bound_ms']:.4f} ms "
              f"bound; q.t().contiguous() {t_plain_ms:.4f} ms), dx wrapper (row quantization, "
              f"transpose, GEMM) {dx_wrapper_ms:.4f} ms, plain {dx_plain_ms:.3f} ms, "
              f"torch._int_mm {f(dx_lib_ms)}, cuBLAS bf16 {dx_bf16_ms:.4f} ms [{card}]",
              flush=True)
        if (m, k_in, n) == W8_MAIN:
            shape = {"shape": [m, k_in, n]}
            main = {
                "fwd": {"max_abs_err": err, "ms": fwd["ms"], "plain_ms": plain_ms,
                        "library_ms": lib_ms, "library_contiguous_ms": lib_c_ms,
                        "cublas_bf16_ms": bf16_ms, "wrapper_ms": wrapper_ms,
                        "weight_only_ms": wo_ms, "dequantize_ms": deq_ms, **bound, **shape},
                "dx": {"max_abs_err": dx_err, "ms": bwd["ms"], "plain_ms": dx_plain_ms,
                       "library_ms": dx_lib_ms, "cublas_bf16_ms": dx_bf16_ms,
                       "wrapper_ms": dx_wrapper_ms, **dx_bound, **shape},
                "transpose": {"max_abs_err": 0, "ms": t_ms, "plain_ms": t_plain_ms,
                              "library_ms": t_plain_ms, **t_bound, "shape": [n, k_in]}}
        del weights, x, g, got, again, want, xr, dx, dx_again, dx_want, fwd, bwd, qt
        torch.cuda.empty_cache()

    # int4_dynamic's product at the main shape: per-group bf16 products with
    # an f32 result (exact integers), the group sum, against the float64
    # products of the CPU's plain version
    m, k_in, n = W8_MAIN
    w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
    q4, gs = quant.quantize_kernel_int4(w, 128)
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(torch.bfloat16)
    q, n_g, gsz = quant._groups(q4, gs)
    xq, _ = quant._rowquant(x)
    xg = xq.reshape(m, n_g, gsz).transpose(0, 1)
    exact = torch.equal(quant._int_bmm(xg, q), torch.bmm(xg.double(), q.double()).float())
    bmm_ms = _median_ms(lambda: quant._int_bmm(xg, q))
    d4_ms = _median_ms(lambda: quant.dyn_int4_matmul(x, q4, gs))
    print(f"[w8a8] int4_dynamic at M={m} K={k_in} N={n}: the {n_g} group products (bf16 "
          f"operands, f32 result) {bmm_ms:.4f} ms, equal to float64 products: {exact}; the "
          f"whole forward {d4_ms:.4f} ms [{card}]", flush=True)
    if not exact:
        raise AssertionError("int4_dynamic's group products are not exact on the card")
    main["fwd"]["int4_dynamic_ms"] = d4_ms
    return main["fwd"], main["dx"], main["transpose"]


def _w8_counts() -> tuple[int, int, int, int]:
    """(W8A8 forward GEMM, dx GEMM, transpose, row quantization) launches."""
    from qflux_tpu_torch.ops import int4_matmul, int8_matmul

    return (int8_matmul.INT8_GEMM_LAUNCHES, int8_matmul.INT8_GEMM_DX_LAUNCHES,
            int8_matmul.INT8_TRANSPOSE_LAUNCHES, int4_matmul.ROWQUANT_LAUNCHES)


def _reset_w8_counts() -> None:
    from qflux_tpu_torch.ops import int4_matmul, int8_matmul

    _reset_counts()
    int8_matmul.INT8_GEMM_LAUNCHES = int8_matmul.INT8_GEMM_DX_LAUNCHES = 0
    int8_matmul.INT8_TRANSPOSE_LAUNCHES = int4_matmul.ROWQUANT_LAUNCHES = 0


def _flux_rows(path: str, b: int, s_img: int, s_txt: int) -> int:
    """The rows a FLUX dense layer multiplies in one forward of b samples of
    s_img image and s_txt text tokens: the image stream's (the dual blocks'
    to_* and img_mlp, proj_out), the text stream's (add_* and txt_mlp), the
    joint stream's (every single-block layer but its mod), or the
    conditioning's b (the AdaLN mods, norm_out and the time / guidance /
    pooled embedders)."""
    if path.endswith("mod/proj") or not path.startswith(("dual/", "single/", "proj_out")):
        return b
    if path.startswith("single/"):
        return b * (s_img + s_txt)
    if "/add_" in path or "/txt_mlp/" in path:
        return b * s_txt
    return b * s_img


def _flux_w8_counts(dit, b: int, s_img: int, s_txt: int) -> tuple[int, int, int]:
    """From the model and the batch's shape: the W8A8 products of one FLUX
    forward (every int8_dynamic layer called with more than 32 rows; the
    rest take the weight-only route, as JAX's tiny-M rule), those inside
    the checkpointed blocks (recomputed in a train step's backward), and
    those whose input carries no gradient (block 0's q / k / v and add_q /
    add_k / add_v read the embedders' frozen outputs: no dx)."""
    from qflux_tpu_torch.ops.layers import iter_dense_paths

    w8 = [p for p, m in iter_dense_paths(dit) if m.q_form == "int8_dynamic"
          and _flux_rows(p, b, s_img, s_txt) > 32]
    in_blocks = [p for p in w8 if p.startswith(("dual/", "single/"))]
    no_grad = [p for p in w8 if p.startswith("dual/0/attn/")
               and p.rsplit("/", 1)[1] in ("to_q", "to_k", "to_v", "add_q", "add_k", "add_v")]
    return len(w8), len(in_blocks), len(no_grad)


def _q_bytes(dit) -> tuple[int, int]:
    """(bytes of every quantized leaf and scale, bytes of the rest) of a DiT."""
    from qflux_tpu_torch.ops.layers import QUANT_LEAVES, iter_dense_paths

    quant = {id(t): name for _, m in iter_dense_paths(dit) for name in QUANT_LEAVES
             if (t := getattr(m, name)) is not None}
    qb = sum(t.numel() * t.element_size() for t in dit.parameters()
             if quant.get(id(t)) in ("q", "q4", "scale"))
    return qb, sum(p.numel() * p.element_size() for p in dit.parameters() if id(p) not in quant)


def phase_w8a8_flux(card: str) -> tuple[int, int, int, int]:
    """Phase E(b): FLUX.1-Kontext-dev at full width and depth over the W8A8
    (`int8_dynamic`) base, loaded by Trainer.load_model (drawn in bf16 from
    its seeds, then quantized on the card).  A forward through K1 and the
    W8A8 kernels against the plain W8A8 route (set_int4_impl "plain"),
    within FORWARD_REL_TOL; one 20-step bs=1 request through
    Trainer.predict_from_embeddings with exact K1, W8A8 and row-quantization
    counts (from `_flux_w8_counts`); one step's LoRA gradients through
    K1 + K2 and the W8A8 kernels (remat "flash") against the plain
    attention and the plain W8A8 route (remat "full"), within GRAD_REL_TOL;
    then Trainer.fit, TRAIN_STEPS steps at bs=1, with exact counts a step.
    Prints s/request, ms/step and peak memory beside the bf16 FLUX phases'.
    Returns the K1 and K2 launches and the W8A8 forward GEMM, dx GEMM,
    transpose and row-quantization launches of the request and the fit."""
    from qflux_tpu_torch.losses import MseLoss
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.ops.layers import iter_dense_paths, mark_trainable, merge_lora, \
        set_int4_impl
    from qflux_tpu_torch.trainer.base import Trainer, predict_config, train_config
    from qflux_tpu_torch.trainer.train_step import TrainStepConfig, _loss_for_microbatch

    config = predict_config(variant="full", num_inference_steps=STEPS)
    config.model.quantize = _qcfg("int8_dynamic")
    trainer = Trainer(config, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.load_model()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    dit, cfg = trainer.bundle.dit_params, trainer.bundle.dit_cfg
    n_blocks = cfg.num_layers + cfg.num_single_layers
    forms: dict = {}
    for _, m in iter_dense_paths(dit):
        forms[m.q_form] = forms.get(m.q_form, 0) + 1
    qb, rest = _q_bytes(dit)
    gh, gw = trainer.adapter.latent_grid(HEIGHT, WIDTH)
    per_fwd, in_blocks, no_grad = _flux_w8_counts(dit, 1, 2 * gh * gw, 512)
    print(f"[w8a8_flux] FLUX.1-Kontext-dev {cfg.num_layers} dual + {cfg.num_single_layers} "
          f"single blocks, dim {cfg.dim}, int8_dynamic: dense layers by form {forms}; "
          f"{qb} bytes of int8 weights and scales, {rest} bytes of full-precision parameters; "
          f"loaded and quantized in {load_s:.1f} s, peak {torch.cuda.max_memory_allocated()} "
          f"bytes; W8A8 products a forward {per_fwd} ({in_blocks} in the blocks, {no_grad} "
          f"with no dx) [{card}]", flush=True)
    lora = trainer.build_lora()
    gen = torch.Generator("cuda").manual_seed(63)
    _perturb_b(lora, gen)
    rng = np.random.default_rng(64)

    # a forward: the kernels against the plain W8A8 route
    emb = trainer.adapter.prepare_cached_embeddings(_request(rng, cfg, gh, gw, 1))
    batch = {k: torch.as_tensor(v).to("cuda", torch.bfloat16) for k, v in emb.items()}
    batch["guidance"] = torch.full((1,), 2.5, dtype=torch.bfloat16, device="cuda")
    lat = torch.randn(1, gh * gw, cfg.in_channels, device="cuda", generator=gen).to(torch.bfloat16)
    sigma = torch.full((1,), 1.0, dtype=torch.bfloat16, device="cuda")
    merge_lora(dit, lora)
    with torch.inference_mode():
        _reset_w8_counts()
        v_k = trainer.adapter.predict_velocity(dit, batch, lat, sigma).float()
        k1, w8 = flash_nr.KERNEL_LAUNCHES, _w8_counts()
        set_int4_impl(dit, "plain")
        v_p = trainer.adapter.predict_velocity(dit, batch, lat, sigma).float()
        set_int4_impl(dit, "auto")
    rel = (torch.linalg.vector_norm(v_k - v_p) / torch.linalg.vector_norm(v_p)).item()
    print(f"[w8a8_flux] full-width forward through K1 and the W8A8 kernels vs the plain W8A8 "
          f"route: rel L2 err {rel:.3e} (tol {FORWARD_REL_TOL}), |v| rms "
          f"{v_p.pow(2).mean().sqrt().item():.4f}; K1 {k1}, W8A8 forward/dx/transpose/row "
          f"quant {w8} [{card}]", flush=True)
    if (k1, w8) != (n_blocks, (per_fwd, 0, 0, per_fwd)):
        raise AssertionError(f"the W8A8 FLUX forward launched K1 {k1}, W8A8 {w8}; expected "
                             f"{n_blocks}, {(per_fwd, 0, 0, per_fwd)}")
    if not (rel <= FORWARD_REL_TOL and bool(torch.isfinite(v_k).all())):
        raise AssertionError("the W8A8 FLUX forward disagrees with the plain route")
    del v_k, v_p, batch
    torch.cuda.empty_cache()

    # the main path, predict: one bs=1 request, counts reset just before
    emb = _request(rng, cfg, gh, gw, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_w8_counts()
    t0 = time.perf_counter()
    images = trainer.predict_from_embeddings(emb, HEIGHT, WIDTH, lora=lora, seed=65)
    secs = time.perf_counter() - t0
    stats = trainer.last_predict
    k1, w8_predict = flash_nr.KERNEL_LAUNCHES, _w8_counts()
    k1_predict = k1
    step_ms = 1000 * stats["denoise_s"] / stats["steps"]
    peak = torch.cuda.max_memory_allocated()
    bf = BF16_FLUX.get("predict", {})
    print(f"[w8a8_flux] request bs=1: {secs:.3f} s, {step_ms:.1f} ms/denoising step "
          f"({stats['steps']} steps), VAE decode {1000 * stats['decode_s']:.1f} ms, peak mem "
          f"{peak} bytes; the bf16 base's bs=1 request (phase 5): {bf.get('s', 0):.3f} s, "
          f"{bf.get('ms_step', 0):.1f} ms/step, peak {bf.get('peak', 0)} bytes; K1 {k1}, W8A8 "
          f"forward/dx/transpose/row quant {w8_predict}, images {images.dtype} "
          f"{list(images.shape)} mean {images.mean():.2f} [{card}]", flush=True)
    want = (STEPS * per_fwd, 0, 0, STEPS * per_fwd)
    if images.dtype != np.uint8 or not stats["latents_finite"]:
        raise AssertionError("the W8A8 FLUX request gave no finite uint8 images")
    if (k1, w8_predict) != (STEPS * n_blocks, want):
        raise AssertionError(f"the W8A8 FLUX request launched K1 {k1}, W8A8 {w8_predict}; "
                             f"expected {STEPS * n_blocks}, {want}")
    emb = trainer.adapter.prepare_cached_embeddings(_request(rng, cfg, gh, gw, 1))
    batch = {k: torch.as_tensor(v).to("cuda", torch.bfloat16) for k, v in emb.items()}
    batch["guidance"] = torch.full((1,), 2.5, dtype=torch.bfloat16, device="cuda")
    merge_lora(dit, lora)

    def denoising_step():
        with torch.inference_mode():
            trainer.adapter.predict_velocity(dit, batch, lat, sigma)

    _profile(card, f"one FLUX denoising step over int8_dynamic, bs=1, S = {512 + 2 * gh * gw}",
             denoising_step)
    merge_lora(dit, None)
    del batch

    # one step's LoRA gradients: kernels (flash) vs plain attention + plain W8A8 (full)
    tt = Trainer(train_config(variant="full"), device="cuda")
    tt.adapter, tt.bundle = trainer.adapter, trainer.bundle
    tb = tt._device_batch(_train_batch(rng, cfg, gh, gw, 1))
    noise = torch.randn(tb["image_latents"].shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    sig = torch.full((1,), 0.6, device="cuda", dtype=torch.bfloat16)
    tl = mark_trainable(tt.build_lora())
    _perturb_b(tl, gen)
    plain = dataclasses.replace(trainer.adapter, attn_impl="plain", remat_policy="full")
    grads, counts = {}, {}
    for name, adapter in (("kernels", trainer.adapter), ("plain", plain)):
        set_int4_impl(dit, "auto" if name == "kernels" else "plain")
        for leaf in tl.values():
            for t in leaf.values():
                t.grad = None
        _reset_w8_counts()
        t0 = time.perf_counter()
        loss = _loss_for_microbatch(dit, tl, tb, noise, sig, adapter.predict_velocity, MseLoss(),
                                    TrainStepConfig())
        loss.backward()
        torch.cuda.synchronize()
        counts[name] = (flash_nr.KERNEL_LAUNCHES, flash_nr.BWD_KERNEL_LAUNCHES, *_w8_counts())
        print(f"[w8a8_flux] gradient check, {name}: loss {loss.item():.5f}, forward + backward "
              f"{time.perf_counter() - t0:.3f} s, K1/K2/W8A8 forward/dx/transpose/row quant "
              f"{counts[name]} [{card}]", flush=True)
        grads[name] = torch.cat([torch.cat([leaf["a"].grad.flatten(), leaf["b"].grad.flatten()])
                                 for leaf in tl.values()]).float()
    set_int4_impl(dit, "auto")
    grel = ((grads["kernels"] - grads["plain"]).norm() / grads["plain"].norm()).item()
    fwd_step = per_fwd + in_blocks
    dx_step = per_fwd - no_grad
    step_counts = (n_blocks, n_blocks, fwd_step, dx_step, dx_step, fwd_step + dx_step)
    print(f"[w8a8_flux] LoRA gradients through K1 + K2 and the W8A8 kernels vs the plain path: "
          f"rel L2 err {grel:.3e} (tol {GRAD_REL_TOL}) [{card}]", flush=True)
    if counts["kernels"] != step_counts or counts["plain"][2:] != (0, 0, 0, 0):
        raise AssertionError(f"the W8A8 gradient check launched {counts}; expected "
                             f"{step_counts} through the kernels and no W8A8 launch plain")
    if not (grel <= GRAD_REL_TOL and bool(torch.isfinite(grads["kernels"]).all())):
        raise AssertionError("the W8A8 FLUX LoRA gradients disagree with the plain path")
    del tl, tb, noise, grads
    torch.cuda.empty_cache()

    # the main path, fit: TRAIN_STEPS steps at bs=1, counts reset just before
    tt = Trainer(train_config(variant="full", max_train_steps=TRAIN_STEPS), device="cuda")
    tt.adapter, tt.bundle = trainer.adapter, trainer.bundle
    batches = [_train_batch(rng, cfg, gh, gw, 1) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_w8_counts()
    fl = _fit_in_tmp(tt, batches)
    fit = (flash_nr.KERNEL_LAUNCHES, flash_nr.BWD_KERNEL_LAUNCHES, *_w8_counts())
    peak = torch.cuda.max_memory_allocated()
    hist = tt.history
    ms = [1000 * h["step_s"] for h in hist]
    warm = ms[1:] if len(ms) > 1 else ms
    bf = BF16_FLUX.get("fit", {})
    print(f"[w8a8_flux] fit bs=1: {len(hist)} steps, ms/step "
          f"{', '.join(f'{v:.1f}' for v in ms)} (after the first: median "
          f"{statistics.median(warm):.1f}, spread {min(warm):.1f}-{max(warm):.1f}), peak mem "
          f"{peak} bytes, loss {', '.join(f'{h['loss']:.5f}' for h in hist)}; the bf16 base's "
          f"bs=1 fit (phase 6): median {bf.get('median', 0):.1f} ms, peak {bf.get('peak', 0)} "
          f"bytes; K1/K2/W8A8 forward/dx/transpose/row quant {fit} [{card}]", flush=True)
    want = tuple(len(hist) * c for c in step_counts)
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError("the W8A8 FLUX fit: too few steps or non-finite losses")
    if len({round(h["loss"], 6) for h in hist}) < 2:
        raise AssertionError("the W8A8 FLUX fit's losses do not move")
    if fit != want:
        raise AssertionError(f"the W8A8 FLUX fit launched {fit}; expected {want}")
    if not all(leaf["b"].abs().sum() > 0 for leaf in fl.values()):
        raise AssertionError("the W8A8 FLUX fit: a LoRA b did not move from zero")
    del trainer, tt, fl, lora, dit
    gc.collect()
    torch.cuda.empty_cache()
    return (k1_predict + fit[0], fit[1], *(a + b for a, b in zip(w8_predict, fit[2:])))


def _dequantized(model):
    """A copy of `model` whose quantized layers hold their dequantized
    weights as f32 full-precision weights (the base the quantized form
    stands for): the full-precision route casts a weight to x.dtype, so it
    multiplies the same weights as the weight-only route, which dequantizes
    to x.dtype (f32 for the AdaLN mods' f32 conditioning, bf16 elsewhere)."""
    from qflux_tpu_torch.ops import quant
    from qflux_tpu_torch.ops.layers import QUANT_LEAVES, iter_dense_paths

    ref = copy.deepcopy(model)
    for _, m in iter_dense_paths(ref):
        if m.q_form is None:
            continue
        if m.q4 is not None:
            w = quant.dequantize_kernel_int4(m.q4, m.scale, torch.float32).t()
        else:
            w = quant.dequantize_kernel(m.q, m.scale.reshape(-1, 1), torch.float32)
        for name in QUANT_LEAVES:
            setattr(m, name, None)
        m.weight = torch.nn.Parameter(w.contiguous(), requires_grad=False)
        m.q_form = None
    return ref


def phase_quant_forms(card: str) -> None:
    """Phase E(c): FLUX.1-Kontext-dev at full width, cut to E_DEPTH (dual,
    single) blocks, over each of E_FORMS.  The DiT is drawn in bf16 on the
    card; its first dual block is quantized on the card and on the CPU
    (equal to the bit), then the whole DiT on the card.  These forms have no
    kernel of their own (JAX leaves them to XLA), so the reference is the
    base they stand for: the same model with every quantized layer's
    dequantized weight as a full-precision weight (`_dequantized`).  A forward against it (weight-only
    forms: equal to the bit, the route being that dequantized product;
    int4_dynamic within FORWARD_REL_TOL, its activations quantized to int8)
    and one step's LoRA gradients (GRAD_REL_TOL), then Trainer.fit for one
    bs=1 step.  Prints ms for the forward and the fit step."""
    from qflux_tpu_torch.losses import MseLoss
    from qflux_tpu_torch.models.flux import transformer as flux
    from qflux_tpu_torch.ops.layers import mark_trainable, merge_lora
    from qflux_tpu_torch.ops.quant import quantize_tree
    from qflux_tpu_torch.trainer.base import Trainer, train_config
    from qflux_tpu_torch.trainer.flux_kontext import FluxKontextAdapter, ModelBundle
    from qflux_tpu_torch.trainer.train_step import TrainStepConfig, _loss_for_microbatch

    cfg = dataclasses.replace(flux.FluxConfig(), num_layers=E_DEPTH[0],
                              num_single_layers=E_DEPTH[1])
    adapter = FluxKontextAdapter(cfg)
    rng = np.random.default_rng(70)
    gh, gw = adapter.latent_grid(HEIGHT, WIDTH)
    for form in E_FORMS:
        gen = torch.Generator("cuda").manual_seed(71)
        dit = flux.init(gen, cfg, device="cuda", dtype=torch.bfloat16)
        qcfg = _qcfg(form)
        _quant_cpu_check(card, "[quant_forms] quantization", dit.dual[0], qcfg, "dual/0/")
        quantize_tree(dit, qcfg)
        ref = _dequantized(dit)
        tt = Trainer(train_config(variant="full", max_train_steps=1), device="cuda")
        tt.adapter = adapter
        tt.bundle = ModelBundle(dit_cfg=cfg, dit_params=dit, vae_cfg=None, vae_params=None)
        lora = mark_trainable(tt.build_lora())
        _perturb_b(lora, gen)
        emb = adapter.prepare_cached_embeddings(_request(rng, cfg, gh, gw, 1))
        batch = {k: torch.as_tensor(v).to("cuda", torch.bfloat16) for k, v in emb.items()}
        batch["guidance"] = torch.full((1,), 2.5, dtype=torch.bfloat16, device="cuda")
        lat = torch.randn(1, gh * gw, cfg.in_channels, device="cuda", generator=gen).to(
            torch.bfloat16)
        sigma = torch.full((1,), 1.0, dtype=torch.bfloat16, device="cuda")
        with torch.inference_mode():
            v = {}
            for name, model in (("quantized", dit), ("dequantized", ref)):
                merge_lora(model, lora)
                adapter.predict_velocity(model, batch, lat, sigma)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                v[name] = adapter.predict_velocity(model, batch, lat, sigma).float()
                torch.cuda.synchronize()
                v[name + "_ms"] = 1000 * (time.perf_counter() - t0)
        rel = (torch.linalg.vector_norm(v["quantized"] - v["dequantized"])
               / torch.linalg.vector_norm(v["dequantized"])).item()
        tb = tt._device_batch(_train_batch(rng, cfg, gh, gw, 1))
        noise = torch.randn(tb["image_latents"].shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        sig = torch.full((1,), 0.6, device="cuda", dtype=torch.bfloat16)
        grads = {}
        for name, model in (("quantized", dit), ("dequantized", ref)):
            for leaf in lora.values():
                for t in leaf.values():
                    t.grad = None
            _loss_for_microbatch(model, lora, tb, noise, sig, adapter.predict_velocity,
                                 MseLoss(), TrainStepConfig()).backward()
            grads[name] = torch.cat([torch.cat([leaf["a"].grad.flatten(),
                                                leaf["b"].grad.flatten()])
                                     for leaf in lora.values()]).float()
        grel = ((grads["quantized"] - grads["dequantized"]).norm()
                / grads["dequantized"].norm()).item()
        merge_lora(dit, None)
        del ref
        torch.cuda.empty_cache()
        fl = _fit_in_tmp(tt, [_train_batch(rng, cfg, gh, gw, 1)])
        hist = tt.history
        exact = form != "int4_dynamic"
        print(f"[quant_forms] {form}, FLUX full width, {E_DEPTH[0]} + {E_DEPTH[1]} blocks: "
              f"forward {v['quantized_ms']:.1f} ms (dequantized base "
              f"{v['dequantized_ms']:.1f} ms), rel L2 err against it {rel:.3e} (tol "
              f"{0 if exact else FORWARD_REL_TOL}); LoRA gradients rel L2 err {grel:.3e} (tol "
              f"{GRAD_REL_TOL}); fit bs=1 step {1000 * hist[0]['step_s']:.1f} ms, loss "
              f"{hist[0]['loss']:.5f} [{card}]", flush=True)
        if (rel > (0 if exact else FORWARD_REL_TOL) or grel > GRAD_REL_TOL
                or not bool(torch.isfinite(v["quantized"]).all())):
            raise AssertionError(f"{form}: the quantized FLUX disagrees with its dequantized "
                                 "base")
        if len(hist) != 1 or not np.isfinite(hist[0]["loss"]) or not all(
                leaf["b"].abs().sum() > 0 for leaf in fl.values()):
            raise AssertionError(f"{form}: the fit step did not train")
        del dit, tt, fl, lora, grads, v
        gc.collect()
        torch.cuda.empty_cache()


def phase_qwen_int8(card: str) -> int:
    """Phase E(d): the 20B Qwen-Image-Edit DiT at full width and depth (60
    blocks) over the int8 weight-only base (the dtype of
    configs/example_qwen_image_edit_plus_multicontrol.yaml; the published
    single-chip config with quantize {int8, attention off}), drawn and
    quantized block by block; one 512² request of E_QWEN_STEPS denoising
    steps at bs=1 through K1 (60 a step), printing its peak memory and
    s/request.  Returns the K1 launches."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.trainer.base import Trainer

    raw = copy.deepcopy(QWEN_832X576)
    raw["model"]["quantize"] = {"enabled": True, "dtype": "int8"}
    trainer = Trainer(config_from_dict(raw), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.load_model()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    dit, cfg = trainer.bundle.dit_params, trainer.bundle.dit_cfg
    qb, rest = _q_bytes(dit)
    print(f"[qwen_int8] Qwen-Image-Edit {cfg.num_layers} blocks, dim {cfg.dim}, int8 "
          f"weight-only: {qb} bytes of int8 weights and scales, {rest} bytes of "
          f"full-precision parameters; loaded in {load_s:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated()} bytes [{card}]", flush=True)
    rng = np.random.default_rng(72)
    gh, gw = trainer.adapter.latent_grid(QWEN512, QWEN512)
    emb = _qwen_request(rng, cfg, gh, gw, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_w8_counts()
    t0 = time.perf_counter()
    images = trainer.predict_from_embeddings(emb, QWEN512, QWEN512,
                                             num_inference_steps=E_QWEN_STEPS, seed=73)
    secs = time.perf_counter() - t0
    stats = trainer.last_predict
    k1 = flash_nr.KERNEL_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    print(f"[qwen_int8] request bs=1 at 512²: {secs:.3f} s, "
          f"{1000 * stats['denoise_s'] / stats['steps']:.1f} ms/denoising step "
          f"({stats['steps']} steps), VAE decode {1000 * stats['decode_s']:.1f} ms, peak mem "
          f"{peak} bytes, K1 launches {k1}, W8A8 {_w8_counts()}, images {images.dtype} "
          f"{list(images.shape)} [{card}]", flush=True)
    if images.dtype != np.uint8 or not stats["latents_finite"]:
        raise AssertionError("the int8 Qwen request gave no finite uint8 images")
    if k1 != E_QWEN_STEPS * cfg.num_layers or _w8_counts() != (0, 0, 0, 0):
        raise AssertionError(f"the int8 Qwen request launched K1 {k1}, W8A8 {_w8_counts()}")
    del trainer, dit
    gc.collect()
    torch.cuda.empty_cache()
    return k1


def _fit_in_tmp(tt, batches):
    """Trainer.fit with its run dir (checkpoints, config) in a temporary
    directory, removed after the run."""
    tmp = tempfile.mkdtemp(prefix="qflux_smoke_fit_")
    tt.config.logging.output_dir = tmp
    try:
        return tt.fit(batches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class _PeakRSS:
    """The process's resident set sampled every 2 ms in a thread: its peak
    inside the `with` block, and its size on entry."""

    def __enter__(self):
        self.start = self.peak = _rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, _rss_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, _rss_bytes())
        return False


class _Draw:
    """Tensors for a synthetic state dict, drawn on `device` (the card) from
    a seeded generator and handed out on the CPU in the file's dtype: dense
    and conv weights and biases U(±1/sqrt(fan_in)), norm scales
    U(0.9, 1.1)."""

    def __init__(self, seed: int, dtype, device="cuda"):
        self.gen = torch.Generator(device).manual_seed(seed)
        self.device = device
        self.dtype = dtype
        self.sd: dict = {}

    def _u(self, shape, lo, hi):
        t = torch.empty(shape, device=self.device).uniform_(lo, hi, generator=self.gen)
        return t.to(self.dtype).cpu()

    def weight(self, name, shape, bias=True):
        b = float(np.prod(shape[1:])) ** -0.5
        self.sd[f"{name}.weight"] = self._u(shape, -b, b)
        if bias:
            self.sd[f"{name}.bias"] = self._u((shape[0],), -b, b)

    def scale(self, name, shape, key="weight"):
        self.sd[f"{name}.{key}"] = self._u(shape, 0.9, 1.1)

    def group_norm(self, name, c):
        self.scale(name, (c,))
        self.sd[f"{name}.bias"] = self._u((c,), -0.05, 0.05)


def flux_state_dict(cfg, seed: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """A FLUX DiT state dict in the diffusers FluxTransformer2DModel names
    and shapes for `cfg` (FluxConfig() is FLUX.1-Kontext-dev's), drawn from
    `seed`."""
    d, dh, hidden = cfg.dim, cfg.attention_head_dim, int(cfg.dim * cfg.mlp_ratio)
    w = _Draw(seed, dtype, device)
    w.weight("x_embedder", (d, cfg.in_channels))
    w.weight("context_embedder", (d, cfg.joint_attention_dim))
    for emb, d_in in (("timestep_embedder", 256), ("text_embedder", cfg.pooled_projection_dim),
                      ("guidance_embedder", 256 if cfg.guidance_embeds else 0)):
        if d_in:
            w.weight(f"time_text_embed.{emb}.linear_1", (d, d_in))
            w.weight(f"time_text_embed.{emb}.linear_2", (d, d))
    for i in range(cfg.num_layers):
        b = f"transformer_blocks.{i}"
        w.weight(f"{b}.norm1.linear", (6 * d, d))
        w.weight(f"{b}.norm1_context.linear", (6 * d, d))
        for name in ("to_q", "to_k", "to_v", "to_out.0", "add_q_proj", "add_k_proj",
                     "add_v_proj", "to_add_out"):
            w.weight(f"{b}.attn.{name}", (d, d))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            w.scale(f"{b}.attn.{name}", (dh,))
        for ff in ("ff", "ff_context"):
            w.weight(f"{b}.{ff}.net.0.proj", (hidden, d))
            w.weight(f"{b}.{ff}.net.2", (d, hidden))
    for i in range(cfg.num_single_layers):
        b = f"single_transformer_blocks.{i}"
        w.weight(f"{b}.norm.linear", (3 * d, d))
        for name in ("to_q", "to_k", "to_v"):
            w.weight(f"{b}.attn.{name}", (d, d))
        for name in ("norm_q", "norm_k"):
            w.scale(f"{b}.attn.{name}", (dh,))
        w.weight(f"{b}.proj_mlp", (hidden, d))
        w.weight(f"{b}.proj_out", (d, d + hidden))
    w.weight("norm_out.linear", (2 * d, d))
    w.weight("proj_out", (cfg.patch_size ** 2 * cfg.out_channels, d))
    return w.sd


def qwen_state_dict(cfg, seed: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """A Qwen-Image DiT state dict in the diffusers
    QwenImageTransformer2DModel names and shapes for `cfg`."""
    d, dh, hidden = cfg.dim, cfg.attention_head_dim, int(cfg.dim * cfg.mlp_ratio)
    w = _Draw(seed, dtype, device)
    w.weight("img_in", (d, cfg.in_channels))
    w.scale("txt_norm", (cfg.joint_attention_dim,))
    w.weight("txt_in", (d, cfg.joint_attention_dim))
    w.weight("time_text_embed.timestep_embedder.linear_1", (d, 256))
    w.weight("time_text_embed.timestep_embedder.linear_2", (d, d))
    for i in range(cfg.num_layers):
        b = f"transformer_blocks.{i}"
        w.weight(f"{b}.img_mod.1", (6 * d, d))
        w.weight(f"{b}.txt_mod.1", (6 * d, d))
        for name in ("to_q", "to_k", "to_v", "to_out.0", "add_q_proj", "add_k_proj",
                     "add_v_proj", "to_add_out"):
            w.weight(f"{b}.attn.{name}", (d, d))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            w.scale(f"{b}.attn.{name}", (dh,))
        for mlp in ("img_mlp", "txt_mlp"):
            w.weight(f"{b}.{mlp}.net.0.proj", (hidden, d))
            w.weight(f"{b}.{mlp}.net.2", (d, hidden))
    w.weight("norm_out.linear", (2 * d, d))
    w.weight("proj_out", (cfg.patch_size ** 2 * cfg.out_channels, d))
    return w.sd


def flux_vae_state_dict(cfg, seed: int, device="cuda") -> dict:
    """A FLUX VAE (diffusers AutoencoderKL) state dict for `cfg`, f32."""
    w = _Draw(seed, torch.float32, device)

    def resnet(name, ci, co):
        w.group_norm(f"{name}.norm1", ci)
        w.weight(f"{name}.conv1", (co, ci, 3, 3))
        w.group_norm(f"{name}.norm2", co)
        w.weight(f"{name}.conv2", (co, co, 3, 3))
        if ci != co:
            w.weight(f"{name}.conv_shortcut", (co, ci, 1, 1))

    def mid(name, c):
        resnet(f"{name}.resnets.0", c, c)
        w.group_norm(f"{name}.attentions.0.group_norm", c)
        for m in ("to_q", "to_k", "to_v", "to_out.0"):
            w.weight(f"{name}.attentions.0.{m}", (c, c))
        resnet(f"{name}.resnets.1", c, c)

    ch = cfg.block_out_channels
    w.weight("encoder.conv_in", (ch[0], cfg.in_channels, 3, 3))
    cin = ch[0]
    for i, co in enumerate(ch):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else co, co)
        if i < len(ch) - 1:
            w.weight(f"encoder.down_blocks.{i}.downsamplers.0.conv", (co, co, 3, 3))
        cin = co
    mid("encoder.mid_block", ch[-1])
    w.group_norm("encoder.conv_norm_out", ch[-1])
    w.weight("encoder.conv_out", (2 * cfg.latent_channels, ch[-1], 3, 3))
    w.weight("decoder.conv_in", (ch[-1], cfg.latent_channels, 3, 3))
    mid("decoder.mid_block", ch[-1])
    cin = ch[-1]
    for i, co in enumerate(reversed(ch)):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else co, co)
        if i < len(ch) - 1:
            w.weight(f"decoder.up_blocks.{i}.upsamplers.0.conv", (co, co, 3, 3))
        cin = co
    w.group_norm("decoder.conv_norm_out", ch[0])
    w.weight("decoder.conv_out", (cfg.out_channels, ch[0], 3, 3))
    return w.sd


def qwen_vae_state_dict(cfg, seed: int, device="cuda") -> dict:
    """A Qwen VAE state dict in the WanVAE layout the converters read
    (flat down / up block lists, quant convs), f32."""
    w = _Draw(seed, torch.float32, device)

    def res(name, ci, co):
        w.scale(f"{name}.norm1", (ci, 1, 1), key="gamma")
        w.weight(f"{name}.conv1", (co, ci, 3, 3, 3))
        w.scale(f"{name}.norm2", (co, 1, 1), key="gamma")
        w.weight(f"{name}.conv2", (co, co, 3, 3, 3))
        if ci != co:
            w.weight(f"{name}.conv_shortcut", (co, ci, 1, 1, 1))

    def mid(name, c):
        res(f"{name}.resnets.0", c, c)
        w.scale(f"{name}.attentions.0.norm", (c, 1, 1), key="gamma")
        w.weight(f"{name}.attentions.0.to_qkv", (3 * c, c, 1, 1))
        w.weight(f"{name}.attentions.0.proj", (c, c, 1, 1))
        res(f"{name}.resnets.1", c, c)

    dims = [cfg.base_dim * m for m in cfg.dim_mult]
    w.weight("encoder.conv_in", (dims[0], 3, 3, 3, 3))
    k, cin = 0, dims[0]
    for i, co in enumerate(dims):
        for j in range(cfg.num_res_blocks):
            res(f"encoder.down_blocks.{k}", cin if j == 0 else co, co)
            k += 1
        if i < len(dims) - 1:
            w.weight(f"encoder.down_blocks.{k}.resample.1", (co, co, 3, 3))
            k += 1
        cin = co
    mid("encoder.mid_block", dims[-1])
    w.scale("encoder.norm_out", (dims[-1], 1, 1), key="gamma")
    w.weight("encoder.conv_out", (2 * cfg.z_dim, dims[-1], 3, 3, 3))
    w.weight("quant_conv", (2 * cfg.z_dim, 2 * cfg.z_dim, 1, 1, 1))
    w.weight("post_quant_conv", (cfg.z_dim, cfg.z_dim, 1, 1, 1))
    rev = dims[::-1]
    w.weight("decoder.conv_in", (rev[0], cfg.z_dim, 3, 3, 3))
    mid("decoder.mid_block", rev[0])
    k, cin = 0, rev[0]
    for i, co in enumerate(rev):
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.up_blocks.{k}", cin if j == 0 else co, co)
            k += 1
        cin = co
        if i < len(rev) - 1:
            w.weight(f"decoder.up_blocks.{k}.resample.1", (rev[i + 1], co, 3, 3))
            k += 1
            cin = rev[i + 1]
    w.scale("decoder.norm_out", (rev[-1], 1, 1), key="gamma")
    w.weight("decoder.conv_out", (3, rev[-1], 3, 3, 3))
    return w.sd


def write_checkpoint(root: Path, dit_sd: dict, vae_sd: dict, shards: int = 2) -> int:
    """A diffusers checkpoint directory: transformer/ as `shards` safetensors
    files with the index JSON, vae/ as one file.  Returns the bytes written."""
    from qflux_tpu_torch.utils.safetensors import save_file

    names = sorted(dit_sd)
    per = -(-len(names) // shards)
    (root / "transformer").mkdir(parents=True)
    (root / "vae").mkdir()
    weight_map = {}
    for i in range(shards):
        fname = f"diffusion_pytorch_model-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = names[i * per:(i + 1) * per]
        save_file({k: dit_sd[k] for k in part}, root / "transformer" / fname)
        weight_map.update({k: fname for k in part})
    total = sum(t.numel() * t.element_size() for t in dit_sd.values())
    (root / "transformer" / "diffusion_pytorch_model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}))
    save_file(vae_sd, root / "vae" / "diffusion_pytorch_model.safetensors")
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())


def _params_equal(got, want) -> int:
    """Raises unless two modules hold the same parameters and buffers, to the
    bit; returns how many tensors were compared."""
    a, b = got.state_dict(), want.state_dict()
    if sorted(a) != sorted(b):
        raise AssertionError(f"parameter names differ: {sorted(set(a) ^ set(b))[:5]}")
    for k in a:
        if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
            raise AssertionError(f"{k} differs from the in-memory conversion")
    return len(a)


def phase_files_flux_resume(card: str, trainer) -> tuple[int, int]:
    """Phase A: FLUX save / resume at full width and depth on the predict
    phase's model (rank-16 LoRA, remat "flash"): fit 4 identical bs=1
    steps with a checkpoint at 2; a second Trainer resumed from
    checkpoint-2 runs steps 3-4 and must end with run 1's LoRA and AdamW
    moments to the bit, with exactly 2 × 57 K1 and K2 launches; the file
    names and state.json as the JAX trainer writes them; then a third
    Trainer reads checkpoint-last-4's LoRA file, and a 20-step bs=1 predict
    with it equals the one with the in-memory LoRA, to the bit.  Returns
    the K1 and K2 launches of the whole phase (counts reset before run 1)."""
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.ops.layers import mark_trainable
    from qflux_tpu_torch.trainer.base import Trainer, predict_config, train_config
    from qflux_tpu_torch.trainer.train_step import lora_leaves
    from qflux_tpu_torch.utils import checkpoint
    from qflux_tpu_torch.utils.lora_io import LORA_FILE_BASE_NAME
    from qflux_tpu_torch.utils.safetensors import SafeTensors

    cfg = trainer.bundle.dit_cfg
    n_blocks = cfg.num_layers + cfg.num_single_layers
    gh, gw = trainer.adapter.latent_grid(HEIGHT, WIDTH)
    rng = np.random.default_rng(12)
    batches = [_train_batch(rng, cfg, gh, gw, 1)] * 4
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_a_"))

    def make(resume=None, steps=4):
        tcfg = train_config(variant="full", max_train_steps=steps)
        tcfg.train.checkpointing_steps = 2
        tcfg.logging.output_dir = str(tmp)
        tcfg.resume = resume
        tt = Trainer(tcfg, device="cuda")
        tt.adapter, tt.bundle = trainer.adapter, trainer.bundle
        return tt

    try:
        flash_nr.KERNEL_LAUNCHES = flash_nr.BWD_KERNEL_LAUNCHES = 0
        t1 = make()
        t0 = time.perf_counter()
        lora1 = t1.fit(batches)
        fit1_s = time.perf_counter() - t0
        run = t1.output_dir
        k1, k2 = flash_nr.KERNEL_LAUNCHES, flash_nr.BWD_KERNEL_LAUNCHES
        if (k1, k2) != (4 * n_blocks, 4 * n_blocks):
            raise AssertionError(f"run 1 launched K1/K2 {k1}/{k2} times, expected {4 * n_blocks}")
        names = sorted(p.name for p in run.iterdir())
        files = sorted(p.name for p in (run / "checkpoint-2").iterdir())
        state = json.loads((run / "checkpoint-2" / checkpoint.STATE_FILE).read_text())
        if (names != ["checkpoint-2", "checkpoint-4", "checkpoint-last-4", "logs",
                      "train_config.yaml"]
                or files != [checkpoint.GENERATOR_FILE, checkpoint.OPTIMIZER_FILE,
                             LORA_FILE_BASE_NAME, checkpoint.STATE_FILE]
                or sorted(state) != ["epoch", "git", "global_step", "is_last"]
                or (state["global_step"], state["epoch"], state["is_last"]) != (2, 0, False)):
            raise AssertionError(f"run 1's files are not the JAX trainer's: {names}, {files}, "
                                 f"{state}")

        t2 = make(resume=str(run / "checkpoint-2"))
        t0 = time.perf_counter()
        lora2 = t2.fit(batches)
        fit2_s = time.perf_counter() - t0
        r1, r2 = flash_nr.KERNEL_LAUNCHES - k1, flash_nr.BWD_KERNEL_LAUNCHES - k2
        if (r1, r2) != (2 * n_blocks, 2 * n_blocks):
            raise AssertionError(f"run 2 launched K1/K2 {r1}/{r2} times, expected "
                                 f"{2 * n_blocks} each")
        if [h["step"] for h in t2.history] != [3, 4]:
            raise AssertionError(f"run 2 ran steps {[h['step'] for h in t2.history]}")
        same_lora = all(torch.equal(lora1[p][k], lora2[p][k]) for p in lora1 for k in "ab")
        same_moments = all(
            torch.equal(t1.optimizer.state[lora1[p][k]][m], t2.optimizer.state[lora2[p][k]][m])
            for p in lora1 for k in "ab" for m in ("exp_avg", "exp_avg_sq"))
        same_loss = [h["loss"] for h in t2.history] == [h["loss"] for h in t1.history[2:]]
        print(f"[files_a] FLUX fit 4 steps bs=1 (checkpoint at 2) {fit1_s:.2f} s, resumed from "
              f"checkpoint-2: steps 3-4 in {fit2_s:.2f} s, losses "
              + ", ".join(f"{h['loss']:.6f}" for h in t1.history) + " / "
              + ", ".join(f"{h['loss']:.6f}" for h in t2.history)
              + f"; final LoRA equal to the bit {same_lora}, AdamW moments {same_moments}, "
              f"losses {same_loss}; K1/K2 launches {k1}/{k2} then {r1}/{r2} [{card}]",
              flush=True)
        if not (same_lora and same_moments and same_loss):
            raise AssertionError("the resumed run differs from the uninterrupted one")

        # the save and the resume's load, timed alone
        t1.output_dir = tmp / "timed"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saved = t1.save_checkpoint(last=True)
        save_s = time.perf_counter() - t0
        sizes = {p.name: p.stat().st_size for p in sorted(saved.iterdir())}
        t4 = make(resume=str(saved))
        t4.config.model.lora.pretrained_weight = str(saved)
        t0 = time.perf_counter()
        t4.lora = mark_trainable(t4.build_lora())
        t4.optimizer, _ = t4.build_optimizer(lora_leaves(t4.lora)[0])
        t4.generator = torch.Generator("cuda")
        t4._load_train_state(saved)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_keys = len(SafeTensors(saved / LORA_FILE_BASE_NAME))
        print(f"[files_a] checkpoint files {sizes} bytes; save {save_s:.3f} s, load (LoRA file, "
              f"AdamW state, generator) {load_s:.3f} s; LoRA file {n_keys} keys for "
              f"{len(lora1)} layers [{card}]", flush=True)

        # predict with the LoRA read from checkpoint-last-4's file
        t3 = Trainer(predict_config(variant="full", num_inference_steps=STEPS), device="cuda")
        t3.adapter, t3.bundle = trainer.adapter, trainer.bundle
        t3.config.model.lora.pretrained_weight = str(run / "checkpoint-last-4"
                                                     / LORA_FILE_BASE_NAME)
        lora3 = t3.build_lora()
        emb = _request(rng, cfg, gh, gw, 1)
        before = flash_nr.KERNEL_LAUNCHES
        img_file = t3.predict_from_embeddings(emb, HEIGHT, WIDTH, lora=lora3, seed=45)
        img_mem = t3.predict_from_embeddings(emb, HEIGHT, WIDTH, lora=lora1, seed=45)
        launched = flash_nr.KERNEL_LAUNCHES - before
        same = np.array_equal(img_file, img_mem)
        print(f"[files_a] 20-step bs=1 predict with the LoRA from the file vs in memory: "
              f"images {img_file.dtype} {list(img_file.shape)} equal to the bit {same}, "
              f"K1 launches {launched} [{card}]", flush=True)
        if not same or img_file.dtype != np.uint8 or launched != 2 * STEPS * n_blocks:
            raise AssertionError("the LoRA read from the file predicts other images")
        return flash_nr.KERNEL_LAUNCHES, flash_nr.BWD_KERNEL_LAUNCHES
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_files_flux_weights(card: str) -> int:
    """Phase B: FLUX.1-Kontext-dev weights from files at full width: a state
    dict drawn from a seed in the diffusers names and published shapes, cut
    to 2 dual + 2 single blocks (every tensor shape of the real file),
    written in bf16 as two shards with the index, and the VAE in f32; loaded
    through Trainer.load_model (pretrained_model_name_or_path), block by
    block.  Every parameter must equal the bridge's load of the whole
    dict's conversion to the bit, the DiT forward must be within
    FORWARD_REL_TOL of the plain attention, and a 4-step 512² predict must
    run K1 4 × 4 times and give finite uint8 images.  Returns the K1
    launches of the predict."""
    from qflux_tpu_torch.models import bridge, porting
    from qflux_tpu_torch.models.flux import transformer as flux
    from qflux_tpu_torch.models.flux import vae as flux_vae
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.trainer.base import Trainer, predict_config

    cfg = dataclasses.replace(flux.FluxConfig(), num_layers=2, num_single_layers=2)
    vcfg = flux_vae.VAEConfig()
    n_blocks = cfg.num_layers + cfg.num_single_layers
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_b_"))
    try:
        sd, vsd = flux_state_dict(cfg, seed=21), flux_vae_state_dict(vcfg, seed=22)
        t0 = time.perf_counter()
        n_bytes = write_checkpoint(tmp, sd, vsd)
        write_s = time.perf_counter() - t0
        tr = Trainer(predict_config(variant="full", num_inference_steps=4), device="cuda")
        tr.config.model.pretrained_model_name_or_path = str(tmp)
        with _PeakRSS() as rss:
            t0 = time.perf_counter()
            tr.load_model()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        dit = tr.bundle.dit_params
        dit_bytes = sum(t.numel() * t.element_size() for t in sd.values())
        block_f32 = 4 * sum(t.numel() for k, t in sd.items()
                            if k.startswith("transformer_blocks.0."))
        print(f"[files_b] FLUX {cfg.num_layers} dual + {cfg.num_single_layers} single at dim "
              f"{cfg.dim}: wrote {n_bytes} bytes (DiT {dit_bytes} bf16 in 2 shards, VAE f32) in "
              f"{write_s:.2f} s ({n_bytes / write_s / 1e9:.2f} GB/s); Trainer.load_model "
              f"{load_s:.2f} s ({n_bytes / load_s / 1e9:.2f} GB/s); host RSS {rss.start} bytes "
              f"before, peak {rss.peak} during the load (+{rss.peak - rss.start}; one dual "
              f"block in f32 is {block_f32} bytes, the whole DiT in f32 {2 * dit_bytes}) "
              f"[{card}]", flush=True)
        if tr.bundle.dit_cfg != cfg:
            raise AssertionError(f"loaded config {tr.bundle.dit_cfg}")
        want = bridge.load_params(flux.FluxTransformer(cfg, device="cuda", dtype=torch.bfloat16),
                                  porting.convert_flux_transformer(sd, cfg.num_layers,
                                                                   cfg.num_single_layers))
        n_dit = _params_equal(dit, want)
        del want
        want_vae = bridge.load_vae_params(flux_vae.VAE(vcfg, device="cuda"),
                                          porting.convert_flux_vae(vsd))
        n_vae = _params_equal(tr.bundle.vae_params, want_vae)
        del want_vae, sd, vsd
        print(f"[files_b] {n_dit} DiT and {n_vae} VAE tensors equal the in-memory conversion "
              f"to the bit [{card}]", flush=True)

        rng = np.random.default_rng(13)
        gh, gw = tr.adapter.latent_grid(HEIGHT, WIDTH)
        emb = tr.adapter.prepare_cached_embeddings(_request(rng, cfg, gh, gw, 1))
        batch = {k: torch.as_tensor(v).to("cuda", torch.bfloat16) for k, v in emb.items()}
        batch["guidance"] = torch.full((1,), 2.5, dtype=torch.bfloat16, device="cuda")
        gen = torch.Generator("cuda").manual_seed(14)
        lat = torch.randn(1, gh * gw, cfg.in_channels, device="cuda",
                          generator=gen).to(torch.bfloat16)
        sigma = torch.full((1,), 1.0, dtype=torch.bfloat16, device="cuda")
        plain = dataclasses.replace(tr.adapter, attn_impl="plain")
        with torch.inference_mode():
            v_k = tr.adapter.predict_velocity(dit, batch, lat, sigma).float()
            v_p = plain.predict_velocity(dit, batch, lat, sigma).float()
        rel = (torch.linalg.vector_norm(v_k - v_p) / torch.linalg.vector_norm(v_p)).item()
        flash_nr.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        images = tr.predict_from_embeddings(_request(rng, cfg, gh, gw, 1), HEIGHT, WIDTH, seed=46)
        secs = time.perf_counter() - t0
        launched = flash_nr.KERNEL_LAUNCHES
        print(f"[files_b] forward K1 vs plain attention rel L2 err {rel:.3e} (tol "
              f"{FORWARD_REL_TOL}); 4-step predict {secs:.2f} s, images {images.dtype} "
              f"{list(images.shape)} mean {images.mean():.2f}, latents finite "
              f"{tr.last_predict['latents_finite']}, K1 launches {launched} [{card}]", flush=True)
        if not rel <= FORWARD_REL_TOL:
            raise AssertionError("the DiT loaded from files disagrees with the plain path")
        if (images.dtype != np.uint8 or images.shape != (1, HEIGHT, WIDTH, 3)
                or not tr.last_predict["latents_finite"] or launched != 4 * n_blocks):
            raise AssertionError(f"files predict: {images.dtype} {images.shape}, K1 {launched}")
        return launched
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_files_qwen(card: str, qwen, lora) -> tuple[int, ...]:
    """Phase C: Qwen-Image-Edit weights from files over the int4-requant
    base at full width (4 of 60 blocks, the published config's quantize
    section), block 0 of the in-memory conversion quantized on the card
    equal to its quantization on the CPU (`_quant_cpu_check`), every
    quantized leaf equal to `quantize_tree` of the whole in-memory
    conversion to the bit, and a 2-step 832×576 predict through K3
    and K5a with exact counts; then the full-depth model's trained LoRA
    (`lora`, from the Qwen train phase) exported to a file and read back
    into a fresh LoRA, whose bs=1 2-step predict must equal the one with
    the in-memory LoRA, to the bit.  Returns the launches of both predicts
    (_launch_counts' order, with the row quantization)."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.models import bridge
    from qflux_tpu_torch.models.qwen import transformer as qwen_dit
    from qflux_tpu_torch.models.qwen import vae as qwen_vae
    from qflux_tpu_torch.models.qwen.porting import convert_qwen_image_transformer, convert_qwen_vae
    from qflux_tpu_torch.ops.quant import quantize_tree
    from qflux_tpu_torch.trainer.base import Trainer
    from qflux_tpu_torch.utils.lora_io import save_lora_safetensors

    cfg = dataclasses.replace(qwen_dit.QwenImageConfig(), num_layers=4)
    vcfg = qwen_vae.QwenVAEConfig()
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_c_"))
    try:
        sd, vsd = qwen_state_dict(cfg, seed=31), qwen_vae_state_dict(vcfg, seed=32)
        t0 = time.perf_counter()
        n_bytes = write_checkpoint(tmp, sd, vsd)
        write_s = time.perf_counter() - t0
        raw = copy.deepcopy(QWEN_832X576)
        raw["model"]["pretrained_model_name_or_path"] = str(tmp)
        tr = Trainer(config_from_dict(raw), device="cuda")
        with _PeakRSS() as rss:
            t0 = time.perf_counter()
            tr.load_model()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        dit = tr.bundle.dit_params
        print(f"[files_c] Qwen {cfg.num_layers} of 60 blocks at dim {cfg.dim}: wrote {n_bytes} "
              f"bytes in {write_s:.2f} s ({n_bytes / write_s / 1e9:.2f} GB/s); load_model with "
              f"int4_requant {load_s:.2f} s ({n_bytes / load_s / 1e9:.2f} GB/s); host RSS "
              f"{rss.start} bytes before, peak {rss.peak} during the load "
              f"(+{rss.peak - rss.start}); device {torch.cuda.memory_allocated()} bytes "
              f"allocated [{card}]", flush=True)
        want = bridge.load_params(
            qwen_dit.QwenImageTransformer(cfg, device="cuda", dtype=torch.bfloat16),
            convert_qwen_image_transformer(sd, cfg.num_layers))
        # block 0 quantized on the card and on the CPU: equal to the bit
        _quant_cpu_check(card, "[files_c] quantization", want.blocks[0],
                         tr.config.model.quantize, "blocks/0/")
        quantize_tree(want, tr.config.model.quantize)
        n_q = sum(1 for m in want.modules() if getattr(m, "q4", None) is not None)
        n_all = _params_equal(dit, want)
        del want
        vae_want = bridge.load_vae_params(
            qwen_vae.QwenVAE(vcfg, device="cuda", post_quant_conv=True),
            convert_qwen_vae(vsd, num_res_blocks=vcfg.num_res_blocks, levels=len(vcfg.dim_mult)))
        n_vae = _params_equal(tr.bundle.vae_params, vae_want)
        del vae_want, sd, vsd
        print(f"[files_c] {n_all} DiT tensors ({n_q} int4-requant layers: kernel_q4_rq, "
              f"kernel_scale and their factors) and {n_vae} VAE tensors equal quantize_tree of "
              f"the in-memory conversion to the bit [{card}]", flush=True)

        rng = np.random.default_rng(15)
        gh, gw = tr.adapter.latent_grid(QWEN_HEIGHT, QWEN_WIDTH)
        per_forward = cfg.num_layers * 12 + 3
        _reset_counts()
        t0 = time.perf_counter()
        images = tr.predict_from_embeddings(_qwen_request(rng, cfg, gh, gw, 1), QWEN_HEIGHT,
                                            QWEN_WIDTH, num_inference_steps=2, seed=47)
        secs = time.perf_counter() - t0
        cut = _launch_counts()
        want_counts = _rq((0, 0, 2 * per_forward, 0, 0, 0, 0, 0, 2 * cfg.num_layers, 0))
        print(f"[files_c] 2-step 832×576 predict {secs:.2f} s, images {images.dtype} "
              f"{list(images.shape)}, latents finite {tr.last_predict['latents_finite']}, "
              f"{COUNT_NAMES} launches {cut} [{card}]", flush=True)
        if (images.dtype != np.uint8 or not tr.last_predict["latents_finite"]
                or cut != want_counts):
            raise AssertionError(f"files predict launched {cut}, expected {want_counts}")
        del tr, dit
        torch.cuda.empty_cache()

        # the full-depth model's trained LoRA through a file
        t0 = time.perf_counter()
        path = save_lora_safetensors(lora, tmp / "qwen_lora.safetensors",
                                     qwen.adapter.lora_module_name_fn,
                                     head_dim=qwen.bundle.dit_cfg.attention_head_dim)
        save_s = time.perf_counter() - t0
        fresh = Trainer(config_from_dict(QWEN_832X576), device="cuda")
        fresh.adapter, fresh.bundle = qwen.adapter, qwen.bundle
        fresh.config.model.lora.pretrained_weight = str(path)
        t0 = time.perf_counter()
        lora_file = fresh.build_lora()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        emb = _qwen_request(rng, qwen.bundle.dit_cfg, gh, gw, 1)
        before = _launch_counts()
        img_file = qwen.predict_from_embeddings(emb, QWEN_HEIGHT, QWEN_WIDTH,
                                                num_inference_steps=2, lora=lora_file, seed=48)
        img_mem = qwen.predict_from_embeddings(emb, QWEN_HEIGHT, QWEN_WIDTH,
                                               num_inference_steps=2, lora=lora, seed=48)
        full = tuple(a - b for a, b in zip(_launch_counts(), before))
        same = np.array_equal(img_file, img_mem)
        moved = sum(bool(leaf["b"].abs().sum() > 0) for leaf in lora_file.values())
        print(f"[files_c] full-depth Qwen LoRA ({len(lora)} layers, {moved} with b moved) saved "
              f"in {save_s:.3f} s ({path.stat().st_size} bytes), read in {load_s:.3f} s; "
              f"2-step bs=1 predict with it vs in memory: equal to the bit {same}; "
              f"{COUNT_NAMES} launches {full} [{card}]", flush=True)
        if not same or sorted(lora_file) != sorted(lora) or moved == 0:
            raise AssertionError("the Qwen LoRA read from its file predicts other images")
        return tuple(a + b for a, b in zip(cut, full))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the data layer and the CLI (phase D)

# each embedding of a cached sample → the `file_hashes` entry that names its
# file, as the JAX package's cache pass keys them (`cache_embeddings` of
# qflux_tpu/trainer/flux_kontext.py and qwen_edit.py, for samples with a
# control image)
FLUX_HASH_KEYS = {"image_latents": "image_hash", "control_latents": "controls_sum_hash",
                  "prompt_embeds": "prompt_hash", "pooled_prompt_embeds": "prompt_hash",
                  "empty_prompt_embeds": "empty_prompt_hash",
                  "empty_pooled_prompt_embeds": "empty_prompt_hash",
                  "tgt_ids": "image_hash", "ctl_ids": "controls_sum_hash",
                  "txt_ids": "prompt_hash"}
QWEN_HASH_KEYS = {"image_latents": "image_hash", "control_latents": "controls_sum_hash",
                  "prompt_embeds": "control_prompt_hash",
                  "prompt_embeds_mask": "control_prompt_hash",
                  "empty_prompt_embeds": "control_empty_prompt_hash",
                  "empty_prompt_embeds_mask": "control_empty_prompt_hash",
                  "img_shapes_arr": "main_hash"}
# phase D's FLUX samples (H, W) in file order, in the buckets of
# configs/example_multiresolution.yaml.  With shuffle off and batch size 2
# the padded run pairs 512² with 768×512 and with 512×768 (S = 3584 with
# segment ids), then 768×512 with 512×768 (one latent shape, per-sample ids)
DATA_FLUX_SIZES = [(512, 512), (768, 512), (512, 512), (512, 768), (768, 512), (512, 768)]
DATA_FLUX_STEPS = 3
# phase D's Qwen samples: 832×576 and 512², one padded batch of S = 4000
DATA_QWEN_GRIDS = [(52, 36), (32, 32)]
DATA_QWEN_STEPS = 2


def flux_cache_item(rng, cfg, gh, gw, s_txt=512) -> dict:
    """One FLUX.1-Kontext sample as the cache pass stores it: target and
    control latents of gh×gw packed tokens, T5 and CLIP embeddings of the
    prompt and of the empty prompt, the target / control / text ids."""
    from qflux_tpu_torch.ops.rope import flux_image_ids, flux_text_ids

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"image_latents": normal(gh * gw, cfg.in_channels),
            "control_latents": normal(gh * gw, cfg.in_channels),
            "prompt_embeds": normal(s_txt, cfg.joint_attention_dim),
            "pooled_prompt_embeds": normal(cfg.pooled_projection_dim),
            "empty_prompt_embeds": normal(s_txt, cfg.joint_attention_dim),
            "empty_pooled_prompt_embeds": normal(cfg.pooled_projection_dim),
            "tgt_ids": flux_image_ids(gh, gw, 0), "ctl_ids": flux_image_ids(gh, gw, 1),
            "txt_ids": flux_text_ids(s_txt)}


def qwen_cache_item(rng, cfg, gh, gw, s_txt=QWEN_TXT, pad=QWEN_TXT_PAD) -> dict:
    """One Qwen-Image-Edit sample as the cache pass stores it: latents of
    gh×gw packed tokens, Qwen2.5-VL embeddings of the prompt and of the
    empty prompt with their masks (the last `pad` tokens padding), and the
    image shapes."""
    mask = np.ones(s_txt, np.int64)
    mask[s_txt - pad:] = 0

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"image_latents": normal(gh * gw, cfg.in_channels),
            "control_latents": normal(gh * gw, cfg.in_channels),
            "prompt_embeds": normal(s_txt, cfg.joint_attention_dim),
            "prompt_embeds_mask": mask,
            "empty_prompt_embeds": normal(s_txt, cfg.joint_attention_dim),
            "empty_prompt_embeds_mask": mask.copy(),
            "img_shapes_arr": np.asarray([(1, gh, gw), (1, gh, gw)], np.int32)}


def write_cached_dataset(root: Path, items: list, hash_keys: dict, seed: int = 0):
    """A local-folder dataset under root/data (training_images/ and
    control_images/: one 16×16 PNG each and the prompt file per sample,
    stems sample_000, …) whose i-th sample's embeddings are `items[i]`,
    saved with the port's EmbeddingCacheManager under root/cache by the
    content hashes the JAX cache pass uses (`hash_keys`).  Returns (data
    dir, cache dir)."""
    from qflux_tpu_torch.data.cache import EmbeddingCacheManager
    from qflux_tpu_torch.data.dataset import ImageDataset
    from qflux_tpu_torch.utils.png import encode_png

    rng = np.random.default_rng(seed)
    data, cache = root / "data", root / "cache"
    for d in ("training_images", "control_images"):
        (data / d).mkdir(parents=True)
    for i in range(len(items)):
        stem = f"sample_{i:03d}"
        for d in ("training_images", "control_images"):
            (data / d / f"{stem}.png").write_bytes(
                encode_png(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)))
        (data / "training_images" / f"{stem}.txt").write_text(f"edit number {i}")
    ds = ImageDataset(str(data))
    manager = EmbeddingCacheManager(cache)
    for sample, arrays in zip(ds.samples, items):
        h = ds.file_hashes(sample)
        manager.save(h["main_hash"], arrays, {k: h[v] for k, v in hash_keys.items()})
    return data, cache


def multires_config(data_dir, out_dir, bucket_by_shape: bool, variant: str = "full",
                    steps: int = DATA_FLUX_STEPS) -> dict:
    """configs/example_multiresolution.yaml as a JSON document (the card's
    machine has no PyYAML), with the dataset, the output dir, bf16 weights
    and `steps` steps of the smoke; the cache at ${logging.output_dir}/cache
    as there.  The padded run (bucket_by_shape false) does not shuffle, so
    its batches are DATA_FLUX_SIZES' pairs."""
    return {
        "trainer": "FluxKontextLoraTrainer",
        "mesh": {"dp": 1, "fsdp": -1, "tp": 1},
        "model": {"variant": variant, "lora": {"r": 16, "lora_alpha": 16}},
        "data": {"init_args": {"dataset_path": str(data_dir)},
                 "processor": {"multi_resolutions": {
                     "target": [[512, 512], [768, 512], [512, 768]],
                     "controls": [[[512, 512], [768, 512], [512, 768]]]},
                     "max_aspect_ratio": 4.0},
                 "batch_size": 2, "bucket_by_shape": bucket_by_shape,
                 "shuffle": bucket_by_shape},
        "cache": {"use_cache": True, "cache_dir": "${logging.output_dir}/cache"},
        "loss": {"class_path": "qflux_tpu.losses.AttentionMaskMseLoss"},
        "train": {"max_train_steps": steps, "weight_dtype": "bfloat16"},
        "logging": {"output_dir": str(out_dir), "project": "flux_multires",
                    "report_to": "tensorboard"},
    }


class _StepCounts:
    """Wraps trainer.base.make_train_step inside the `with` block: each step
    of a fit records its batch's latent shapes, whether it carries segment
    ids, the kernel launches it made (_launch_counts' order), the host
    seconds the step took to return (launch_s) and the peak of allocated
    device memory by then (with `step_peak`, the peak of that step alone:
    the stats are reset before it and read after it completes).  The step
    returns after its forward and backward are enqueued, so the counts
    need no synchronisation."""

    def __init__(self, step_peak: bool = False):
        self.step_peak = step_peak

    def __enter__(self):
        from qflux_tpu_torch.trainer import base

        self.base, self.orig, self.steps = base, base.make_train_step, []

        def make(*args, **kwargs):
            inner = self.orig(*args, **kwargs)

            def step(params, lora, batch, generator, **kw):
                if self.step_peak:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                before = _launch_counts()
                t0 = time.perf_counter()
                out = inner(params, lora, batch, generator, **kw)
                launch_s = time.perf_counter() - t0
                if self.step_peak:
                    torch.cuda.synchronize()
                self.steps.append({
                    "launch_s": launch_s,
                    "img": tuple(batch["image_latents"].shape),
                    "ctl": tuple(batch["control_latents"].shape),
                    "segments": "segment_ids" in batch,
                    "device": str(batch["image_latents"].device),
                    "counts": tuple(b - a for a, b in zip(before, _launch_counts())),
                    "peak": torch.cuda.max_memory_allocated()})
                return out

            return step

        base.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.base.make_train_step = self.orig
        return False


def _events(run_dir: Path) -> Path:
    files = sorted((run_dir / "logs").glob("events.out.tfevents.*"))
    if len(files) != 1:
        raise AssertionError(f"{run_dir / 'logs'}: {len(files)} events files")
    return files[0]


def _check_fit_run(card: str, label: str, trainer, steps, want_steps: int, per_step) -> None:
    """Finite losses, `want_steps` steps on the card, each with the launch
    counts `per_step(record)` gives, the events file's loss scalars equal
    to the history's, and checkpoint-last-N in the run dir."""
    hist = trainer.history
    if len(hist) != want_steps or len(steps) != want_steps:
        raise AssertionError(f"{label}: {len(hist)} steps ({len(steps)} recorded), "
                             f"expected {want_steps}")
    if not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"{label}: non-finite losses {[h['loss'] for h in hist]}")
    for i, rec in enumerate(steps):
        want = per_step(rec)
        if rec["device"] != "cuda:0" or rec["counts"] != want:
            raise AssertionError(f"{label} step {i + 1}: batch {rec}, {COUNT_NAMES} launches "
                                 f"{rec['counts']}, expected {want} on cuda:0")
    from qflux_tpu_torch.utils.logger import read_event_scalars

    events = _events(trainer.output_dir)
    scalars = read_event_scalars(events)
    logged = [v for _, v in scalars.get("loss", [])]
    if logged != [float(np.float32(h["loss"])) for h in hist]:
        raise AssertionError(f"{label}: events file losses {logged} against {hist}")
    if [s for s, _ in scalars.get("compile_s", [])] != [1]:
        raise AssertionError(f"{label}: compile_s {scalars.get('compile_s')}")
    if not (trainer.output_dir / f"checkpoint-last-{want_steps}").is_dir():
        raise AssertionError(f"{label}: no checkpoint-last-{want_steps}")
    print(f"[data] {label}: events file {events.stat().st_size} bytes, tags "
          f"{sorted(scalars)}, loss read back "
          + ", ".join(f"{v:.5f}" for v in logged) + f" [{card}]", flush=True)


def _step_line(label, hist, steps) -> str:
    return "; ".join(
        f"step {h['step']}: image {rec['img'][1]} + control {rec['ctl'][1]} tokens "
        f"(bs={rec['img'][0]}{', segment ids' if rec['segments'] else ''}) "
        f"{1000 * h['step_s']:.1f} ms (staging the next batch {1000 * h['stage_s']:.1f} ms "
        f"of it), waited {1000 * h['data_wait_s']:.2f} ms for the batch"
        for h, rec in zip(hist, steps))


def phase_data_flux_cli(card: str) -> tuple[int, ...]:
    """Phase D (a): FLUX.1-Kontext-dev at full width through
    `python -m qflux_tpu_torch.main` (in process), from a 6-sample embedding
    cache in example_multiresolution.yaml's buckets: bucketed, then padded
    with segment ids, each checked per step for its route's exact K1 / K2
    or K3 / K4 launches, then the padded run's mixed-batch forward against
    the plain attention and against each sample alone, and its LoRA
    gradients through K3 + K4 against the plain attention's.  Returns the
    launches of the two runs (_launch_counts' order)."""
    from qflux_tpu_torch import main as cli
    from qflux_tpu_torch.data.collate import collate
    from qflux_tpu_torch.data.dataset import ImageDataset
    from qflux_tpu_torch.data.loader import DataLoader
    from qflux_tpu_torch.models.flux.transformer import FluxConfig
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.ops.layers import mark_trainable, merge_lora

    cfg = FluxConfig()
    n_blocks = cfg.num_layers + cfg.num_single_layers
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_data_"))
    try:
        rng = np.random.default_rng(20)
        t0 = time.perf_counter()
        items = [flux_cache_item(rng, cfg, h // 16, w // 16) for h, w in DATA_FLUX_SIZES]
        data_dir, cache_dir = write_cached_dataset(tmp, items, FLUX_HASH_KEYS)
        write_s = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in cache_dir.rglob("*") if p.is_file())
        ds = ImageDataset(str(data_dir), cache_dir=str(cache_dir), use_cache=True)
        t0 = time.perf_counter()
        n = sum(1 for _ in DataLoader(ds, batch_size=2, shuffle=False, bucket_by_shape=False))
        per_batch = (time.perf_counter() - t0) / n
        print(f"[data] FLUX cache of {len(items)} samples {DATA_FLUX_SIZES} written in "
              f"{write_s:.2f} s ({nbytes} bytes); the loader alone: {1000 * per_batch:.1f} ms of "
              f"host time a bs=2 batch (cache read, fp16 → f32, collate) [{card}]", flush=True)

        def per_step(rec):
            # JAX's one-chip route: K1 / K2 where flash_nr.supports (S = 2560
            # at 512²), else K3 / K4 (S = 3584)
            s = 512 + rec["img"][1] + rec["ctl"][1]
            return _rq((n_blocks, n_blocks, 0, 0, 0, 0, 0, 0, 0, 0)
                       if flash_nr.supports(s, s, cfg.attention_head_dim)
                       else (0, 0, 0, 0, 0, 0, 0, 0, n_blocks, n_blocks))

        totals = [0] * 11
        for bucket in (True, False):
            label = f"CLI fit, bucket_by_shape {str(bucket).lower()}"
            path = tmp / f"multires_{'bucketed' if bucket else 'padded'}.json"
            path.write_text(json.dumps(multires_config(data_dir, tmp, bucket)))
            torch.cuda.synchronize()
            _reset_counts()
            with _StepCounts() as sc:
                t0 = time.perf_counter()
                trainer = cli.main(["--config", str(path)])
                wall = time.perf_counter() - t0
            launched = _launch_counts()
            totals = [t + c for t, c in zip(totals, launched)]
            hist = trainer.history
            print(f"[data] {label}: {wall:.1f} s in main() (model built, {len(hist)} steps, "
                  f"checkpoint); {_step_line(label, hist, sc.steps)}; loss "
                  + ", ".join(f"{h['loss']:.5f}" for h in hist)
                  + f"; {COUNT_NAMES} launches {launched} [{card}]", flush=True)
            _check_fit_run(card, label, trainer, sc.steps, DATA_FLUX_STEPS, per_step)
            if launched != tuple(map(sum, zip(*(r["counts"] for r in sc.steps)))):
                raise AssertionError(f"{label}: launches outside the steps {launched}")
            segs = [r["segments"] for r in sc.steps]
            if segs != ([False] * 3 if bucket else [True, True, False]):
                raise AssertionError(f"{label}: segment ids per step {segs}")
            if bucket:
                del trainer
                gc.collect()
                torch.cuda.empty_cache()

        # the padded run's model: a mixed batch (512² + 768×512, S = 3584)
        # through K3 with segment ids, against the plain attention and
        # against each sample alone (512² alone takes K1's route)
        adapter, dit = trainer.adapter, trainer.bundle.dit_params
        params = merge_lora(dit, trainer.lora)
        ds = ImageDataset(str(data_dir), cache_dir=str(cache_dir), use_cache=True)
        singles = [ds[0], ds[1]]
        emb = trainer._device_batch(trainer._embeddings_for_batch(collate(singles)))
        gen = torch.Generator("cuda").manual_seed(21)
        lat = torch.randn(emb["image_latents"].shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        sigma = torch.full((2,), 0.7, dtype=torch.bfloat16, device="cuda")
        plain = dataclasses.replace(adapter, attn_impl="plain")
        valid = emb["attention_mask"] > 0
        with torch.inference_mode():
            before = _launch_counts()
            v_k = adapter.predict_velocity(params, emb, lat, sigma).float()
            k3 = _launch_counts()[8] - before[8]
            v_p = plain.predict_velocity(params, emb, lat, sigma).float()
            alone = []
            for i, item in enumerate(singles):
                e = trainer._device_batch(trainer._embeddings_for_batch(collate([item])))
                s = e["image_latents"].shape[1]
                alone.append((s, adapter.predict_velocity(params, e, lat[i:i + 1, :s],
                                                          sigma[:1]).float()))

        def rel(a, b):
            return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

        rel_plain = rel(v_k[valid], v_p[valid])
        rel_alone = [rel(v_k[i, :s], v) for i, (s, v) in enumerate(alone)]
        print(f"[data] full-width mixed batch [2, {v_k.shape[1]}, {v_k.shape[2]}] (512² padded "
              f"to 768×512, S = {512 + 2 * v_k.shape[1]}, {k3} K3 launches with segment ids): "
              f"rel L2 err against the plain attention {rel_plain:.3e}, against each sample "
              f"alone {rel_alone[0]:.3e} (512², K1 route) / {rel_alone[1]:.3e} (768×512) "
              f"(tol {FORWARD_REL_TOL}) [{card}]", flush=True)
        if k3 != n_blocks or not bool(torch.isfinite(v_k).all()):
            raise AssertionError(f"the mixed-batch forward made {k3} K3 launches")
        if max([rel_plain] + rel_alone) > FORWARD_REL_TOL:
            raise AssertionError("the padded mixed-batch forward disagrees")
        del params, v_k, v_p, alone
        gc.collect()
        torch.cuda.empty_cache()

        # the same mixed batch's LoRA gradients: K3 + K4 with per-sample
        # segment ids (remat flash) against the plain attention (remat full)
        lora = mark_trainable(trainer.build_lora())
        _perturb_b(lora, gen)
        noise = torch.randn(emb["image_latents"].shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        _lora_grad_check(card, "[data] full-width mixed batch (segment ids)", "K3+K4", dit,
                         lora, emb, noise, sigma, adapter, trainer._criterion, (8, 9), n_blocks,
                         tuple(trainer.config.model.lora.target_modules))
        del trainer, lora, emb, noise
        gc.collect()
        torch.cuda.empty_cache()
        return tuple(totals)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_data_qwen_fit(card: str, qwen) -> tuple[int, ...]:
    """Phase D (b): the 20B Qwen-Image-Edit over the int4-requant base (path
    B's model) through Trainer.fit(DataLoader(...)) from a 2-sample
    embedding cache: one 832×576 sample and one 512² sample padded to S =
    4000, two steps at bs=2, each checked for its exact K3 / K4, K5a, K5b
    and row-quantization launches.  Returns the launches (_launch_counts'
    order)."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.data.dataset import ImageDataset
    from qflux_tpu_torch.data.loader import DataLoader
    from qflux_tpu_torch.trainer.base import Trainer

    cfg = qwen.bundle.dit_cfg
    n = cfg.num_layers
    # as path B's fit at bs=2 (phase_qwen_train)
    per_step = _rq((0, 0, 2 * 12 * n + 3, 6 + 12 * (n - 2) + 9 + 1, 0, 0, 0, 0, n, n))
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_data_"))
    try:
        rng = np.random.default_rng(22)
        t0 = time.perf_counter()
        items = [qwen_cache_item(rng, cfg, gh, gw) for gh, gw in DATA_QWEN_GRIDS]
        data_dir, cache_dir = write_cached_dataset(tmp, items, QWEN_HASH_KEYS)
        write_s = time.perf_counter() - t0
        raw = copy.deepcopy(QWEN_832X576)
        raw["loss"] = {"class_path": "qflux_tpu.losses.AttentionMaskMseLoss"}
        raw["train"]["max_train_steps"] = DATA_QWEN_STEPS
        raw["logging"]["output_dir"] = str(tmp / "out")
        tt = Trainer(config_from_dict(raw), device="cuda")
        tt.adapter, tt.bundle = qwen.adapter, qwen.bundle
        dl = DataLoader(ImageDataset(str(data_dir), cache_dir=str(cache_dir), use_cache=True),
                        batch_size=2, shuffle=False, bucket_by_shape=False)
        torch.cuda.synchronize()
        _reset_counts()
        with _StepCounts() as sc:
            tt.fit(dl)
        launched = _launch_counts()
        label = "Qwen fit(DataLoader), 832×576 + 512² padded"
        print(f"[data] Qwen cache of 2 samples written in {write_s:.2f} s; {label}: "
              f"{_step_line(label, tt.history, sc.steps)}; loss "
              + ", ".join(f"{h['loss']:.5f}" for h in tt.history)
              + f"; {COUNT_NAMES} launches {launched} [{card}]", flush=True)
        _check_fit_run(card, label, tt, sc.steps, DATA_QWEN_STEPS, lambda rec: per_step)
        s = QWEN_TXT + sc.steps[0]["img"][1] + sc.steps[0]["ctl"][1]
        if s != 4000 or not all(r["segments"] for r in sc.steps):
            raise AssertionError(f"{label}: S = {s}, segment ids {sc.steps}")
        if launched != tuple(DATA_QWEN_STEPS * c for c in per_step):
            raise AssertionError(f"{label}: launches outside the steps {launched}")
        del tt, dl
        torch.cuda.empty_cache()
        return launched
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase F: the FLUX.1-Kontext cache pass and the raw-image entry points

REPAIR_SHAPE = (33, 3072, 18432)  # the AdaLN mods at bs = 33: rows, K, N
# int4_dynamic's bf16 forward on the card against the CPU's: the f32 sum over
# the 24 groups is ordered by each device's torch.sum, a few f32 ulps apart,
# which moves a bf16 output by at most one ulp (2^-8 of its magnitude), as
# tests/test_torch_quant8.py holds the port to JAX
INT4_DYN_CPU_TOL = 2 ** -8
F_PAIRS = 4                       # target / control pairs the cache pass encodes
# the committed fixtures (scripts/make_image_fixtures.py) phase F reads
IMAGE_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "images"
F_TARGETS = ["target_0.jpg", "target_1.jpg", "target_2.bmp", "target_3.jpg"]
F_CONTROLS = ["control_0.jpg", "control_1.jpg", "control_2.png", "control_3.jpg"]
F_JPEGS = sum(n.endswith(".jpg") for n in F_TARGETS + F_CONTROLS)
# the host ms a native decode of the 512² baseline 4:2:0 JPEG may take: 5% of
# the 0.514 s a FLUX cache-pass sample takes (PERF.md §5)
DECODE_MS_BOUND = 25.0
F_FIT_STEPS = 3                   # fit steps from that cache, validation at the last
F_VALIDATION_STEPS = 4            # the validation sample's denoising steps
F_PROMPTS = ["turn the sky orange at sunset", "add a red hat to the person",
             "make it a watercolor painting", "remove the car from the street"]
# the card's f32 encoders (TF32 off) against the same modules on the CPU:
# the same f32 math, summed in other orders and by other conv algorithms
ENCODER_REL_TOL = 1e-4
# T5-XXL's prompt embeds, per block of its depth: each block's f32 sums over
# 4,096 and 10,240 terms, ordered differently on the two devices, move its
# output by a few 1e-6 relative (6.09e-6 measured over 2 blocks), and the
# blocks add their differences up (1.250e-4 measured over 24, above
# ENCODER_REL_TOL); a wrong operation moves it by 1e-2 or more
T5_BLOCK_REL_TOL = 1e-5
# the cached arrays against the CPU's f32: the cache holds fp16 (JAX's
# format), which alone puts each value within 2^-11 of its own magnitude,
# beside the card's own tolerance for that output
FP16_REL = 2 ** -11
F_CACHE_SHAPES = {"image_latents": (1024, 64), "control_latents": (1024, 64),
                  "prompt_embeds": (512, 4096), "pooled_prompt_embeds": (768,),
                  "empty_prompt_embeds": (512, 4096), "empty_pooled_prompt_embeds": (768,),
                  "tgt_ids": (1024, 3), "ctl_ids": (1024, 3), "txt_ids": (512, 3)}


def phase_repair_probe(card: str) -> None:
    """Phase F(a): the W8A8 matmul (row quantization, the GEMM, and in the
    backward the row quantization of g · s_w over N = 18,432, past the
    12,288 values it took before, the transpose and the dx GEMM) and int4_dynamic (whose dx contracts over N, past the
    16,513 terms one exact f32 product holds) at the AdaLN mods' shape
    with 33 rows: each equal to its plain version on the card (float64
    products) to the bit, forward and dx, two calls identical, each timed
    beside its plain version; int4_dynamic's dx also equals the CPU's to
    the bit, and its forward (whose group sum each device orders its own
    way) is within INT4_DYN_CPU_TOL of the CPU's."""
    from qflux_tpu_torch.ops import int8_matmul as ti8
    from qflux_tpu_torch.ops import quant

    m, k_in, n = REPAIR_SHAPE
    gen = torch.Generator("cuda").manual_seed(33)
    w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
    w[:64] = 0.37  # int4 group 0 at its amax everywhere: dx sums past 2^24
    q, scale = quant.quantize_kernel(w, "int8")
    q, sw = q.t().contiguous(), scale[0].contiguous()
    q4, gs = quant.quantize_kernel_int4(w, 128)
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn(m, n, device="cuda", generator=gen).to(torch.bfloat16)
    g[:16] = 1.0
    lines = []

    def vjp(fn, xx, *args):
        xx = xx.detach().requires_grad_()
        y = fn(xx, *args)
        y.backward(g.to(xx.device))
        return y.detach(), xx.grad

    for label, fn, args, plain in (
            ("W8A8 (int8_dynamic)", ti8.dyn_int8_matmul, (q, sw),
             lambda: (quant.dyn_int8_fwd(x, q, sw), quant.dyn_int8_dx(g, q, sw))),
            ("int4_dynamic", quant.dyn_int4_matmul, (q4, gs),
             lambda: (quant.dyn_int4_fwd(x, q4, gs, f64=True),
                      quant.dyn_int4_dx(g, q4, gs, f64=True)))):
        before = _w8_counts()
        y, dx = vjp(fn, x, *args)
        y2, dx2 = vjp(fn, x, *args)
        torch.cuda.synchronize()
        launched = tuple(b - a for a, b in zip(before, _w8_counts()))
        want_y, want_dx = plain()
        exact = (torch.equal(y.cpu(), want_y.cpu()) and torch.equal(dx.cpu(), want_dx.cpu())
                 and torch.equal(y, y2) and torch.equal(dx, dx2))
        xg = x.detach().requires_grad_()

        def fwd_bwd():
            fn(xg, *args).backward(g)

        fwd_ms = _median_ms(lambda: fn(x, *args), n=5)
        both_ms = _median_ms(fwd_bwd, n=5)
        lines.append(f"[repair] {label} {m}x{k_in}->{n}: forward {fwd_ms:.3f} ms, forward + dx "
                     f"{both_ms:.3f} ms, max |dx| {float(dx.float().abs().max()):.4g}; equal to "
                     f"its plain version (float64 products on the card) to the bit: {exact}; "
                     f"W8A8 launches (fwd GEMM, dx GEMM, transpose, row quant) for two calls "
                     f"{launched} [{card}]")
        if not exact:
            raise AssertionError(f"{label} at {REPAIR_SHAPE} differs from its plain version")
        if "int4" in label:
            cpu_y, cpu_dx = vjp(fn, x.cpu(), q4.cpu(), gs.cpu())
            cpu_y = cpu_y.float()
            err = float((y.cpu().float() - cpu_y).abs().max() / cpu_y.abs().max())
            lines.append(f"[repair] {label} against the CPU: dx equal to the bit "
                         f"{torch.equal(dx.cpu(), cpu_dx)}; forward max |diff| / max |y| "
                         f"{err:.3e} (tol {INT4_DYN_CPU_TOL})")
            if not torch.equal(dx.cpu(), cpu_dx) or err > INT4_DYN_CPU_TOL:
                raise AssertionError(f"{label} at {REPAIR_SHAPE} differs from the CPU's")
        if "W8" in label and launched != (2, 2, 2, 4):
            raise AssertionError(f"{label}: launches {launched}, expected (2, 2, 2, 4)")
    plain_ms = _median_ms(lambda: quant.dyn_int8_fwd(x, q, sw), n=3)
    lines.append(f"[repair] W8A8 plain forward (float64 products on the card) {plain_ms:.3f} ms "
                 f"[{card}]")
    print("\n".join(lines), flush=True)


def _f_config(csv_path: Path, out_dir: Path, **over) -> dict:
    """FLUX.1-Kontext-dev at full width (19 + 38 blocks, synthetic weights:
    no checkpoint) over a CSV of 512² target / control pairs, its cache in
    out_dir/cache, bf16 DiT, T5 at 512 tokens."""
    raw = {"trainer": "FluxKontextLoraTrainer", "mesh": {"dp": 1, "fsdp": 1, "tp": 1},
           "model": {"variant": "full", "lora": {"r": 16, "lora_alpha": 16}},
           "data": {"init_args": {"csv_path": str(csv_path)},
                    "processor": {"process_type": "resize", "target_size": [HEIGHT, WIDTH]},
                    "batch_size": 1, "shuffle": False},
           "cache": {"use_cache": True, "cache_dir": str(out_dir / "cache")},
           "predict": {"max_sequence_length": 512},
           "train": {"max_train_steps": F_FIT_STEPS, "weight_dtype": "bfloat16",
                     "checkpointing_steps": 1000},
           "logging": {"output_dir": str(out_dir), "project": "flux_pixels"}}
    for section, values in over.items():
        raw.setdefault(section, {}).update(values)
    return raw


def _rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _encoders_against_cpu(card: str, trainer, csv_path: Path) -> None:
    """The first sample of the cache pass, whole, on the CPU: its prompt
    through CLIP-L and all 24 T5-XXL blocks at 512 tokens, its 512² target
    and control through the VAE encoder, by the adapter's own
    `encode_prompt` / `encode_vae_image` on CPU copies of the modules.
    Against that: the card's f32 outputs of the same calls within
    ENCODER_REL_TOL (T5-XXL's within T5_BLOCK_REL_TOL a block), and the
    arrays `--cache` wrote for the sample (read back under the sample's
    hashes) within FP16_REL more.  Prints the CPU's
    seconds, and each encoder timed on the card."""
    from qflux_tpu_torch.data.cache import read_npz_data
    from qflux_tpu_torch.data.dataset import ImageDataset
    from qflux_tpu_torch.data.loader import DataLoader
    from qflux_tpu_torch.data.preprocess import ImageProcessor
    from qflux_tpu_torch.models.flux import text_encoders as te
    from qflux_tpu_torch.models.flux import vae as flux_vae
    from qflux_tpu_torch.trainer.flux_kontext import ModelBundle, text_encoders

    bundle, adapter, cfg = trainer.bundle, trainer.adapter, trainer.config
    enc = text_encoders(bundle)
    ds = ImageDataset(csv_path=str(csv_path), processor=ImageProcessor(cfg.data.processor))
    batch = next(iter(DataLoader(ds, batch_size=1, shuffle=False, drop_last=False,
                                 bucket_by_shape=False)))
    prompt = batch["prompt"][0]
    hashes = batch["file_hashes"]
    hashes = hashes[0] if isinstance(hashes, list) else hashes
    t5_cpu = te.T5Encoder(bundle.text_cfgs["t5"])
    t5_cpu.load_state_dict(enc["t5"].state_dict())
    cpu = ModelBundle(dit_cfg=bundle.dit_cfg, dit_params=None, vae_cfg=bundle.vae_cfg,
                      vae_params=copy.deepcopy(bundle.vae_params).cpu(),
                      text_cfgs=bundle.text_cfgs,
                      text_params={"clip": copy.deepcopy(enc["clip"]).cpu(), "t5": t5_cpu},
                      tokenizers=bundle.tokenizers)
    msl = cfg.predict.max_sequence_length

    def outputs(b):
        pe, pooled, _ = adapter.encode_prompt(b, [prompt], msl)
        return {"prompt_embeds": pe[0], "pooled_prompt_embeds": pooled[0],
                "image_latents": adapter.encode_vae_image(b, batch["image"])[0],
                "control_latents": adapter.encode_vae_image(b, batch["control"])[0]}

    t0 = time.perf_counter()
    want = outputs(cpu)
    cpu_s = time.perf_counter() - t0
    got = outputs(bundle)
    names = {"image_latents": hashes["image_hash"],
             "control_latents": hashes["controls_sum_hash"],
             "prompt_embeds": hashes["prompt_hash"],
             "pooled_prompt_embeds": hashes["prompt_hash"]}
    cache_root = Path(cfg.cache.cache_dir)
    tol = {k: ENCODER_REL_TOL for k in want}
    tol["prompt_embeds"] = T5_BLOCK_REL_TOL * bundle.text_cfgs["t5"].num_layers
    card_err = {k: _rel(got[k], want[k]) for k in want}
    cache_err = {k: _rel(torch.from_numpy(np.array(read_npz_data(cache_root / k / f"{h}.npz"))),
                         want[k])
                 for k, h in names.items()}
    clip_ids = bundle.tokenizers["clip"]([prompt])
    t5_ids = bundle.tokenizers["t5"]([prompt], max_length=msl)
    ccfg, tcfg = bundle.text_cfgs["clip"], bundle.text_cfgs["t5"]
    full = torch.from_numpy(np.asarray(batch["image"])).cuda().float() / 127.5 - 1
    with torch.no_grad():
        ms = {"CLIP-L": _median_ms(lambda: te.clip_encode(enc["clip"], ccfg, clip_ids), n=3),
              "T5-XXL (24 blocks, 512 tokens)": _median_ms(
                  lambda: te.t5_encode(enc["t5"], tcfg, t5_ids), n=3),
              "VAE encoder (512²)": _median_ms(
                  lambda: flux_vae.encode(bundle.vae_params, bundle.vae_cfg, full), n=3)}
    print(f"[cache] sample 0 on the CPU, whole (CLIP-L, T5-XXL "
          f"{bundle.text_cfgs['t5'].num_layers} blocks at {msl} tokens, the "
          f"VAE encoder on the 512² target and control) in {cpu_s:.1f} s; rel L2 err of the "
          f"card's f32 outputs: "
          + ", ".join(f"{k} {v:.3e} (tol {tol[k]:.2e})" for k, v in card_err.items())
          + "; of the fp16 arrays --cache wrote: "
          + ", ".join(f"{k} {v:.3e} (tol {tol[k] + FP16_REL:.2e})"
                      for k, v in cache_err.items())
          + "; on the card, f32, TF32 off: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items()) + f" [{card}]", flush=True)
    if (any(card_err[k] > tol[k] for k in card_err)
            or any(cache_err[k] > tol[k] + FP16_REL for k in cache_err)):
        raise AssertionError(f"the card's encoders or the cache disagree with the CPU's: "
                             f"{card_err}, {cache_err}")
    del cpu, t5_cpu, want, got


def phase_decoders(card: str) -> dict:
    """Phase F(a'): every fixture of tests/fixtures/images read as
    `_read_image` (cv2's IMREAD_UNCHANGED) and `_read_mask`
    (IMREAD_GRAYSCALE) read it: each JPEG by the native decoder
    (csrc/jpeg_decode.cu through utils/jpeg.py) and by the plain one, equal
    to the bit; every array's sha256 equal to the committed digest of
    cv2's decode (a colour PNG's mask excepted: the port's PNG gray
    conversion is within one step of cv2's libpng, by design).  Prints
    host ms a decode for each path (native: median of 20; plain: median of
    2), and fails if the native decode of the baseline 4:2:0 fixture takes
    more than DECODE_MS_BOUND.  Returns {fixture: {mode: {path: ms}}}."""
    import hashlib

    from qflux_tpu_torch.utils import bmp, jpeg
    from qflux_tpu_torch.utils.png import decode_png

    table = json.loads((IMAGE_FIXTURES / "digests.json").read_text())
    out, lines = {}, []
    for name, want in table.items():
        data = (IMAGE_FIXTURES / name).read_bytes()
        if hashlib.sha256(data).hexdigest() != want["file_sha256"]:
            raise AssertionError(f"fixture {name} differs from the one its digests were taken of")
        out[name] = {}
        for mode in ("unchanged", "grayscale"):
            gray = mode == "grayscale"
            if name.endswith(".jpg"):
                paths = {p: (lambda p=p: jpeg.decode_jpeg(data, gray, p))
                         for p in ("native", "plain")}
            elif name.endswith(".bmp"):
                paths = {"numpy": lambda: bmp.decode_bmp(data, gray)}
            elif gray:
                continue  # see the docstring
            else:
                paths = {"numpy": lambda: decode_png(data)}
            arrays, ms = {}, {}
            for path, fn in paths.items():
                arrays[path] = fn()
                n = 20 if path == "native" else 2
                times = []
                for _ in range(n):
                    t0 = time.perf_counter()
                    fn()
                    times.append(1000 * (time.perf_counter() - t0))
                ms[path] = statistics.median(times)
            first = next(iter(arrays.values()))
            same = all(np.array_equal(a, first) for a in arrays.values())
            digest = hashlib.sha256(np.ascontiguousarray(first).tobytes()).hexdigest()
            ok = (same and digest == want[f"{mode}_sha256"]
                  and list(first.shape) == want[f"{mode}_shape"])
            lines.append(f"[decode] {name} ({want['what']}, {want['bytes']} bytes) {mode}: "
                         + ", ".join(f"{p} {v:.3f} ms" for p, v in ms.items())
                         + f" host a decode; paths equal to the bit {same}, equal to cv2's "
                         f"digest {ok} {list(first.shape)} [{card}]")
            if not ok:
                print("\n".join(lines), flush=True)
                raise AssertionError(f"{name} ({mode}) decodes differ: paths equal {same}, "
                                     f"digest {digest} against cv2's {want[f'{mode}_sha256']}")
            out[name][mode] = ms
    base = out["target_0.jpg"]["unchanged"]["native"]
    lines.append(f"[decode] the native decode of the 512² baseline 4:2:0 JPEG: {base:.3f} ms "
                 f"host (bound {DECODE_MS_BOUND} ms); native decodes in this process "
                 f"{jpeg.NATIVE_DECODES} [{card}]")
    print("\n".join(lines), flush=True)
    if base > DECODE_MS_BOUND:
        raise AssertionError(f"the native JPEG decode took {base:.3f} ms > {DECODE_MS_BOUND}")
    return out


def decode_main() -> int:
    """`python3 chip_smoke.py --decode`: phase F(a') alone (the kernel
    library built first)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from qflux_tpu_torch.runtime.build import load_library

    smi = _nvidia_smi()
    print(smi, flush=True)
    card = ", ".join(x.strip() for x in smi.split(",", 1))
    kl = load_library()
    print(f"[build] {kl.path.name}, nvcc {kl.build_seconds:.2f} s [{card}]", flush=True)
    t0 = time.perf_counter()
    phase_decoders(card)
    print(f"[smoke] phase F(a'): {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return 0


def phase_cache_pass(card: str) -> dict:
    """Phase F(b)-(e), FLUX.1-Kontext-dev at full width (19 + 38 blocks, the
    full VAE, CLIP-L 12 × 768, T5-XXL 24 × 4096 at 512 tokens, synthetic
    weights drawn on the card from seeds) through `qflux_tpu_torch.main`
    in process: (b) `--cache` over F_PAIRS 512² target / control pairs of
    the committed fixtures (F_TARGETS / F_CONTROLS: JPEGs of five kinds, a
    BMP, a PNG) listed in a CSV with their prompts, each JPEG read through
    the native decoder (its count rises by F_JPEGS at least): the nine keys
    of cache_embeddings at JAX's shapes, s per sample, peak memory, the
    encoders against the CPU; (c) + (e) a fit of F_FIT_STEPS
    steps from that cache with exactly 57 K1 and 57 K2 launches a step,
    its validation section sampling once (one control image,
    F_VALIDATION_STEPS steps, 57 K1 a step) and logging the image; (d)
    `--predict` on the 4:2:2 JPEG control (one native decode): 20 steps at
    512², 57 K1 a step, the output PNG decoding to [512, 512, 3] uint8,
    finite latents.  Returns the K1 / K2 launches of each path."""
    from qflux_tpu_torch import main as cli
    from qflux_tpu_torch.data.dataset import _read_image
    from qflux_tpu_torch.models.flux.transformer import FluxConfig
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.utils import jpeg
    from qflux_tpu_torch.utils.png import read_png

    n_blocks = FluxConfig().num_layers + FluxConfig().num_single_layers
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_pixels_"))
    try:
        rows = ["path_target,path_control,prompt"]
        for i in range(F_PAIRS):
            for name in (F_TARGETS[i], F_CONTROLS[i]):
                shutil.copyfile(IMAGE_FIXTURES / name, tmp / name)
            rows.append(f"{F_TARGETS[i]},{F_CONTROLS[i]},{F_PROMPTS[i]}")
        csv_path = tmp / "pairs.csv"
        csv_path.write_text("\n".join(rows) + "\n")
        val = {"enabled": True, "steps": F_FIT_STEPS, "num_inference_steps": F_VALIDATION_STEPS,
               "samples": [{"prompt": F_PROMPTS[0], "images": [str(tmp / F_CONTROLS[0])]}]}
        path = tmp / "pixels.json"
        path.write_text(json.dumps(_f_config(csv_path, tmp, validation=val)))

        # (b) the cache pass
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        decodes = jpeg.NATIVE_DECODES
        t0 = time.perf_counter()
        trainer = cli.main(["--config", str(path), "--cache"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        decodes = jpeg.NATIVE_DECODES - decodes
        stats = trainer.last_cache
        peak = torch.cuda.max_memory_allocated()
        from qflux_tpu_torch.data.cache import EmbeddingCacheManager, read_npz_data

        metas = sorted((tmp / "cache" / "metadata").glob("*.json"))
        cm = EmbeddingCacheManager(tmp / "cache")
        shapes = {}
        for meta in metas:
            keys = json.loads(meta.read_text())["keys"]
            for k, h in keys.items():
                arr = read_npz_data(tmp / "cache" / k / f"{h}.npz")
                shapes[k] = tuple(arr.shape)
                if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                    raise AssertionError(f"cache {k}: non-finite values")
        enc, wr = stats["encode_s"], stats["write_s"]
        print(f"[cache] --cache over {F_PAIRS} 512² pairs: {wall:.1f} s in main() (DiT, VAE "
              f"built; CLIP-L and T5-XXL drawn on first use), the pass {stats['seconds']:.2f} s "
              f"(the loader's image reads inside); per sample encode "
              + ", ".join(f"{s:.3f}" for s in enc) + " s (the first draws T5-XXL), write "
              + ", ".join(f"{s:.3f}" for s in wr) + f" s; after the first "
              f"{statistics.median(a + b for a, b in zip(enc[1:], wr[1:])):.3f} s/sample "
              f"(median); peak mem {peak} bytes, {len(metas)} samples, keys {shapes}; K1/K2 "
              f"launches {_launch_counts()[:2]}; native JPEG decodes {decodes} (the pairs hold "
              f"{F_JPEGS} JPEGs) [{card}]", flush=True)
        if (stats["samples"] != F_PAIRS or len(metas) != F_PAIRS or shapes != F_CACHE_SHAPES
                or _launch_counts()[:2] != (0, 0) or not cm.exists(metas[0].stem)
                or decodes < F_JPEGS):
            raise AssertionError(f"the cache pass wrote {stats}, {len(metas)} metadata, "
                                 f"shapes {shapes}, {decodes} native JPEG decodes")
        _encoders_against_cpu(card, trainer, csv_path)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # (c) + (e): fit from that cache, validation sampling at the last step
        torch.cuda.synchronize()
        _reset_counts()
        with _StepCounts() as sc:
            t0 = time.perf_counter()
            trainer = cli.main(["--config", str(path)])
            wall = time.perf_counter() - t0
        fit_total = _launch_counts()
        label = "fit from the port's cache"
        hist = trainer.history
        print(f"[cache] {label}: {wall:.1f} s in main(), {len(hist)} steps: "
              + "; ".join(f"step {h['step']} {1000 * h['step_s']:.1f} ms, loss {h['loss']:.5f}"
                          for h in hist)
              + f"; launches {fit_total[:2]} (K1, K2) [{card}]", flush=True)
        _check_fit_run(card, label, trainer, sc.steps, F_FIT_STEPS,
                       lambda rec: _rq((n_blocks, n_blocks, 0, 0, 0, 0, 0, 0, 0, 0)))
        in_steps = tuple(map(sum, zip(*(r["counts"] for r in sc.steps))))
        val_k1 = fit_total[0] - in_steps[0]
        tag = b"validation/sample_0" in _events(trainer.output_dir).read_bytes()
        print(f"[cache] validation inside fit: one sample at step {F_FIT_STEPS}, "
              f"{F_VALIDATION_STEPS} steps, {val_k1} K1 launches, image logged: {tag} [{card}]",
              flush=True)
        if (val_k1 != F_VALIDATION_STEPS * n_blocks or fit_total[1] != in_steps[1]
                or not tag):
            raise AssertionError(f"validation launched K1 {val_k1}, logged {tag}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # (d) predict on a raw control image: a JPEG
        out = tmp / "edit.png"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        decodes = jpeg.NATIVE_DECODES
        t0 = time.perf_counter()
        trainer = cli.main(["--config", str(path), "--predict", "--control",
                            str(tmp / F_CONTROLS[1]), "--prompt", F_PROMPTS[1],
                            "--output", str(out)])
        wall = time.perf_counter() - t0
        decodes = jpeg.NATIVE_DECODES - decodes
        pred = trainer.last_predict
        k1 = flash_nr.KERNEL_LAUNCHES
        img = read_png(out)
        t0 = time.perf_counter()
        trainer.predict([_read_image(tmp / F_CONTROLS[2])], F_PROMPTS[2])
        torch.cuda.synchronize()
        again = time.perf_counter() - t0
        print(f"[cache] --predict from a 512² JPEG ({decodes} native decode): {wall:.1f} s in "
              f"main() (DiT, VAE built, T5-XXL drawn), {pred['steps']} steps "
              f"{1000 * pred['denoise_s'] / pred['steps']:.1f} ms/step, decode "
              f"{1000 * pred['decode_s']:.1f} ms; a second request on the loaded "
              f"model {again:.2f} s (encode, 20 steps, decode); peak mem "
              f"{torch.cuda.max_memory_allocated()} bytes; output {img.dtype} {list(img.shape)}, "
              f"latents finite {pred['latents_finite']}, K1 launches {k1} [{card}]", flush=True)
        if (img.dtype != np.uint8 or img.shape != (HEIGHT, WIDTH, 3)
                or not pred["latents_finite"] or k1 != pred["steps"] * n_blocks or decodes != 1):
            raise AssertionError(f"--predict gave {img.dtype} {img.shape}, K1 {k1}, "
                                 f"{decodes} native decodes")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return {"fit": in_steps[:2], "validation": val_k1, "predict": k1}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase G: the Qwen-Image-Edit cache pass and the raw-image entry points

G_PAIRS = 2                       # 832×576 target / control PNG pairs the cache pass encodes
G_FIT_STEPS = 2                   # fit steps from that cache (bs=1), validation after each
G_VALIDATION_STEPS = 2            # the validation sample's denoising steps
G_PREDICT_STEPS = 4               # --predict's denoising steps on a raw PNG
G_MULTIRES_STEPS = 2              # predict_multires' denoising steps, each family
G_PROMPTS = F_PROMPTS[:G_PAIRS]
# the card's f32 Qwen2.5-VL against the same modules on the CPU, per block or
# layer of its depth: each sums over 1,280 / 3,584 / 18,944 terms in other
# orders on the two devices and the blocks add their differences up; the
# LM's output carries the vision tower's difference in its image tokens too.
# Set from the VL's own readings on an H100 (the same in every call, the
# weights and images seeded): the vision tower's features 1.314e-6 against
# 32 · 2e-7 = 6.4e-6, the prompt embeds 5.414e-6 against 6.4e-6 + 28 · 5e-7
# = 2.04e-5, each about 4-5x its reading.  The check now runs a cut depth
# (VL_CHECK_BLOCKS, LM_CHECK_LAYERS) and scales the same per-block and
# per-layer bounds by it: 8 · 2e-7 = 1.6e-6 against a reading of 1.123e-6,
# 1.6e-6 + 4 · 5e-7 = 3.6e-6 against 3.289e-6
VL_BLOCK_REL_TOL = 2e-7
LM_LAYER_REL_TOL = 5e-7
QWEN_MSL = 512                    # predict.max_sequence_length, the config's default


def _g_config(csv_path: Path, out_dir: Path, **over) -> dict:
    """configs/example_qwen_single_chip_832x576.yaml as published (the
    20B DiT over int4_requant, attention: true, remat flash_offload, its
    832×576 center_crop processor; synthetic weights: no checkpoint) over a
    CSV of target / control pairs, bs=1, its cache in out_dir/cache."""
    raw = copy.deepcopy(QWEN_832X576)
    raw["data"] = {"init_args": {"csv_path": str(csv_path)},
                   "processor": {"process_type": "center_crop",
                                 "target_size": [QWEN_HEIGHT, QWEN_WIDTH]},
                   "batch_size": 1, "shuffle": False}
    raw["cache"] = {"use_cache": True, "cache_dir": str(out_dir / "cache")}
    raw["train"].update(max_train_steps=G_FIT_STEPS, checkpointing_steps=1000)
    raw["logging"] = {"output_dir": str(out_dir), "project": "qwen_pixels"}
    for section, values in over.items():
        raw.setdefault(section, {}).update(values)
    return raw


class _StreamedLM:
    """A language model on the card (Qwen2.5-VL's or Qwen3) seen from the
    CPU one layer at a time, its first `depth` layers: embed_tokens and the
    final norm copied once, each layer rebuilt as `layer_cls(lm.cfg)` when
    the forward reaches it and dropped after, so the host holds one layer's
    f32 copy (1.09 GB for the VL's) and not the LM's (30.5 GB)."""

    def __init__(self, lm, layer_cls, depth: int):
        self.lm, self.layer_cls, self.depth = lm, layer_cls, depth
        self.embed_tokens = lm.embed_tokens.detach().cpu()
        self.norm = copy.deepcopy(lm.norm).cpu()

    @property
    def layers(self):
        for lp in list(self.lm.layers)[:self.depth]:
            layer = self.layer_cls(self.lm.cfg)
            layer.load_state_dict(lp.state_dict())
            yield layer


# the depth at which the CPU checks the card's Qwen2.5-VL: the first 8 of the
# vision tower's 32 blocks (block 7 is the first full-attention one) and 4 of
# the LM's 28 layers (the whole depth took the CPU 68.5-77.8 s a call, time
# the smoke now gives phase H)
VL_CHECK_BLOCKS, LM_CHECK_LAYERS = 8, 4


def _qwen_encoders_against_cpu(card: str, trainer, csv_path: Path) -> None:
    """The first sample of the Qwen cache pass on the CPU: its prompt in the
    edit template with the control image's 630 tokens through the first
    VL_CHECK_BLOCKS vision blocks (and the merger) and the first
    LM_CHECK_LAYERS LM layers (streamed one layer at a time, `_StreamedLM`)
    and the final norm, its 832×576 target and control through the VAE
    encoder, by the adapter's own `encode_prompt` / `encode_vae_image` on
    CPU copies of the modules.  Against that: the card's f32 outputs of
    the same calls through the same cut modules, within the per-block and
    per-layer bounds times the depth checked (the vision features within
    VL_BLOCK_REL_TOL a block, the prompt embeds within that plus
    LM_LAYER_REL_TOL a layer, the latents within ENCODER_REL_TOL); the
    fp16 latents `--cache` wrote against the CPU's (within ENCODER_REL_TOL
    plus FP16_REL), and its full-depth prompt embeds of the sample for
    their shape and finiteness only (nothing at that depth ran on the
    CPU).  Prints the CPU's seconds and peak host
    memory, and on the card the host preprocessing, the vision tower, the
    LM at the sample's length and the VAE encoder, each timed."""
    from types import SimpleNamespace

    from qflux_tpu_torch.data.cache import read_npz_data
    from qflux_tpu_torch.data.dataset import ImageDataset
    from qflux_tpu_torch.data.loader import DataLoader
    from qflux_tpu_torch.data.preprocess import ImageProcessor
    from qflux_tpu_torch.models.qwen import vae as qwen_vae
    from qflux_tpu_torch.models.qwen import vl_encoder as tvl
    from qflux_tpu_torch.trainer.flux_kontext import ModelBundle
    from qflux_tpu_torch.trainer.qwen_edit import vl_encoder

    bundle, adapter, cfg = trainer.bundle, trainer.adapter, trainer.config
    enc = vl_encoder(bundle)
    vcfg, tcfg = bundle.text_cfgs["vision"], bundle.text_cfgs["text"]
    ds = ImageDataset(csv_path=str(csv_path), processor=ImageProcessor(cfg.data.processor))
    batch = next(iter(DataLoader(ds, batch_size=1, shuffle=False, drop_last=False,
                                 bucket_by_shape=False)))
    prompt, control = batch["prompt"][0], np.asarray(batch["control"][0])
    hashes = batch["file_hashes"]
    hashes = hashes[0] if isinstance(hashes, list) else hashes
    msl = cfg.predict.max_sequence_length
    vis, lm = enc["vision"], enc["text"]

    def cut(device_copy):
        return {"vision": SimpleNamespace(
                    patch_embed=device_copy(vis.patch_embed), merger=device_copy(vis.merger),
                    blocks=[device_copy(b) for b in list(vis.blocks)[:VL_CHECK_BLOCKS]]),
                "text": SimpleNamespace(embed_tokens=lm.embed_tokens, norm=lm.norm,
                                        layers=list(lm.layers)[:LM_CHECK_LAYERS])}

    card_cut = cut(lambda m: m)
    cpu_cut = cut(lambda m: copy.deepcopy(m).cpu())
    cpu_cut["text"] = _StreamedLM(lm, tvl.DecoderLayer, LM_CHECK_LAYERS)
    vae_cpu = copy.deepcopy(bundle.vae_params).cpu()

    def on(text_params, vae):
        return ModelBundle(dit_cfg=bundle.dit_cfg, dit_params=None, vae_cfg=bundle.vae_cfg,
                           vae_params=vae, text_cfgs=bundle.text_cfgs,
                           text_params=text_params, tokenizers=bundle.tokenizers)

    recorded = []
    real_vision = tvl.vision_forward

    def record(*args, **kw):
        recorded.append(real_vision(*args, **kw))
        return recorded[-1]

    def outputs(b, secs):
        recorded.clear()
        t0 = time.perf_counter()
        pe, _ = adapter.encode_prompt(b, [prompt], [[control]], msl)
        t1 = time.perf_counter()
        out = {"vision": recorded[0], "prompt_embeds": pe[0],
               "image_latents": adapter.encode_vae_image(b, batch["image"])[0],
               "control_latents": adapter.encode_vae_image(b, batch["control"])[0]}
        secs.update(prompt=t1 - t0, vae=time.perf_counter() - t1)
        return out

    tvl.vision_forward = record
    cpu_secs = {}
    try:
        with _PeakRSS() as rss:
            want = outputs(on(cpu_cut, vae_cpu), cpu_secs)
        got = outputs(on(card_cut, bundle.vae_params), {})
    finally:
        tvl.vision_forward = real_vision
    # the per-block / per-layer bounds times the depth checked, as the
    # whole depth was held to them times 32 / 28
    vis_tol = VL_BLOCK_REL_TOL * VL_CHECK_BLOCKS
    tol = {"vision": vis_tol, "prompt_embeds": vis_tol + LM_LAYER_REL_TOL * LM_CHECK_LAYERS,
           "image_latents": ENCODER_REL_TOL, "control_latents": ENCODER_REL_TOL}
    card_err = {k: _rel(got[k], want[k]) for k in want}
    cache_root = Path(cfg.cache.cache_dir)

    def cached(key, h):
        return torch.from_numpy(np.array(read_npz_data(cache_root / key / f"{h}.npz")))

    cache_tol = ENCODER_REL_TOL + FP16_REL
    cache_err = {"image_latents": _rel(cached("image_latents", hashes["image_hash"]),
                                       want["image_latents"]),
                 "control_latents": _rel(cached("control_latents", hashes["controls_sum_hash"]),
                                         want["control_latents"])}
    pe = cached("prompt_embeds", hashes.get("control_prompt_hash", hashes["prompt_hash"]))
    pe_ok = pe.shape == got["prompt_embeds"].shape and bool(torch.isfinite(pe).all())
    # the LM alone at the sample's length (its ids drawn; the cost is the same)
    n_tok = len(adapter._tokenize_with_images(bundle, adapter.format_prompt(prompt, 1),
                                              [int(recorded[0].shape[0])]))
    ids = np.random.default_rng(90).integers(0, tcfg.vocab_size, (1, n_tok))
    pos = tvl.get_rope_index(ids, [], vcfg.spatial_merge_size, bundle.text_cfgs["tokens"])
    embeds = lm.embed_tokens[torch.from_numpy(ids).cuda()]
    patches, grid = tvl.preprocess_image(control, vcfg)
    image = torch.from_numpy(np.asarray(batch["image"])).cuda().float() / 127.5 - 1
    with torch.no_grad():
        t0 = time.perf_counter()
        for _ in range(3):
            tvl.preprocess_image(control, vcfg)
        host_ms = 1000 * (time.perf_counter() - t0) / 3
        ms = {"vision tower (32 blocks, 2520 patches)": _median_ms(
                  lambda: tvl.vision_forward(vis, vcfg, patches, [grid]), n=3),
              f"LM (28 layers, {n_tok} tokens)": _median_ms(
                  lambda: tvl.text_forward(lm, tcfg, embeds, pos), n=3),
              "VAE encoder (832×576)": _median_ms(
                  lambda: qwen_vae.encode(bundle.vae_params, bundle.vae_cfg, image), n=3)}
    lm_params = sum(p.numel() for p in lm.layers.parameters())
    lm_ms = ms[f"LM (28 layers, {n_tok} tokens)"]
    print(f"[qwen_cache] sample 0 on the CPU (the vision tower's first {VL_CHECK_BLOCKS} of "
          f"{vcfg.depth} blocks at grid {grid}, the LM's first {LM_CHECK_LAYERS} of "
          f"{tcfg.num_layers} layers at {n_tok} tokens streamed one at a time, the VAE encoder "
          f"on the 832×576 target and control) in {cpu_secs['prompt'] + cpu_secs['vae']:.1f} s "
          f"(the prompt {cpu_secs['prompt']:.1f} s, the two VAE encodes {cpu_secs['vae']:.1f} "
          f"s), host RSS peak {rss.peak} bytes (from {rss.start}); rel L2 err of the card's "
          f"f32 outputs at that depth: "
          + ", ".join(f"{k} {v:.3e} (tol {tol[k]:.2e})" for k, v in card_err.items())
          + "; of the fp16 latents --cache wrote against the CPU's: "
          + ", ".join(f"{k} {v:.3e} (tol {cache_tol:.2e})" for k, v in cache_err.items())
          + f"; its full-depth prompt embeds {list(pe.shape)}, finite: {pe_ok}"
          + f"; on the card, f32, TF32 off: host preprocessing (PIL's bicubic in numpy, "
          f"patches) {host_ms:.1f} ms, "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
          + f" (LM {2 * lm_params * n_tok / lm_ms / 1e9:.1f} TFLOP/s) [{card}]", flush=True)
    if (any(card_err[k] > tol[k] for k in card_err)
            or any(v > cache_tol for v in cache_err.values()) or not pe_ok):
        raise AssertionError(f"the card's Qwen encoders or the cache disagree with the CPU: "
                             f"{card_err}, {cache_err}, prompt embeds {list(pe.shape)} "
                             f"finite/shape ok {pe_ok}")
    del cpu_cut, card_cut, vae_cpu, want, got, pe, embeds


class _VLBuilds:
    """Records the step counts of a fit (`_StepCounts`) at which the bundle
    built Qwen2.5-VL (`qwen_edit.vl_encoder` finding it unbuilt), and the
    bytes of its parameters."""

    def __init__(self, sc):
        self.sc, self.built_at, self.bytes = sc, [], 0

    def __enter__(self):
        from qflux_tpu_torch.trainer import qwen_edit

        self.mod, self.orig = qwen_edit, qwen_edit.vl_encoder

        def wrapped(bundle):
            built = not bundle.text_params
            enc = self.orig(bundle)
            if built:
                self.built_at.append(len(self.sc.steps))
                self.bytes = sum(p.numel() * p.element_size() for m in enc.values()
                                 for p in m.parameters())
            return enc

        qwen_edit.vl_encoder = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.vl_encoder = self.orig
        return False


def phase_qwen_cache_pass(card: str) -> dict:
    """Phase G, Qwen-Image-Edit at full width from raw images: the published
    832×576 config (`_g_config`: the 60-block DiT over int4_requant with
    attention: true, the full Qwen VAE, Qwen2.5-VL with 32 vision blocks ×
    1,280 and 28 LM layers × 3,584, synthetic weights drawn on the card from
    seeds, the hash tokenizer) through `qflux_tpu_torch.main` in process:
    (a) `--cache` over G_PAIRS 832×576 target / control PNG pairs (seeded
    numpy through encode_png) in a CSV: JAX's seven keys at JAX's shapes, s
    per sample (encode / write), peak memory, no kernel launched; then the
    first sample against the CPU (`_qwen_encoders_against_cpu`); (b) a fit
    of G_FIT_STEPS bs=1 steps from that cache (60 K3, 60 K4, 1,443 K5a and
    712 K5b a step at S = 512 + 2 · 1,872) whose validation section samples
    after every step (G_VALIDATION_STEPS steps, 60 K3 and 723 K5a a step)
    and logs the image: Qwen2.5-VL built once, for the validation set-up
    after step 1, and freed before step 2, whose own peak memory must stay
    below the VL's bytes; (c) `--predict` on a
    raw 832×576 PNG (G_PREDICT_STEPS steps), the PNG [832, 576, 3] uint8,
    finite latents, and a second request on the loaded model timed; (d)
    `predict_multires` on that model over an 832×576 and a 512² item in
    one padded batch (G_MULTIRES_STEPS steps).  Returns the launches of each
    path (`_launch_counts`' order)."""
    from qflux_tpu_torch import main as cli
    from qflux_tpu_torch.data.cache import EmbeddingCacheManager, read_npz_data
    from qflux_tpu_torch.models.qwen.transformer import QwenImageConfig
    from qflux_tpu_torch.utils.png import encode_png, read_png

    n = QwenImageConfig().num_layers
    fwd_k5a = 12 * n + 3  # a bs=1 forward: the block GEMMs, img_in, txt_in, proj_out
    per_step = _rq((0, 0, 2 * 12 * n + 3, 6 + 12 * (n - 2) + 9 + 1, 0, 0, 0, 0, n, n))
    gh, gw = QWEN_HEIGHT // 16, QWEN_WIDTH // 16
    shapes_want = {"image_latents": (gh * gw, 64), "control_latents": (gh * gw, 64),
                   "prompt_embeds": (QWEN_MSL, 3584), "prompt_embeds_mask": (QWEN_MSL,),
                   "empty_prompt_embeds": (QWEN_MSL, 3584),
                   "empty_prompt_embeds_mask": (QWEN_MSL,), "img_shapes_arr": (2, 3)}
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_qwen_pixels_"))
    try:
        rng = np.random.default_rng(91)
        rows = ["path_target,path_control,prompt"]
        for i in range(G_PAIRS + 1):  # the last pair is --predict's and the multires'
            for kind in ("target", "control"):
                img = rng.integers(0, 256, (QWEN_HEIGHT, QWEN_WIDTH, 3), dtype=np.uint8)
                (tmp / f"{kind}_{i}.png").write_bytes(encode_png(img))
            if i < G_PAIRS:
                rows.append(f"target_{i}.png,control_{i}.png,{G_PROMPTS[i]}")
        csv_path = tmp / "pairs.csv"
        csv_path.write_text("\n".join(rows) + "\n")
        val = {"enabled": True, "steps": 1, "num_inference_steps": G_VALIDATION_STEPS,
               "samples": [{"prompt": G_PROMPTS[0], "images": [str(tmp / "control_0.png")]}]}
        path = tmp / "qwen_pixels.json"
        path.write_text(json.dumps(_g_config(csv_path, tmp, validation=val)))

        # (a) the cache pass
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        trainer = cli.main(["--config", str(path), "--cache"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats, peak = trainer.last_cache, torch.cuda.max_memory_allocated()
        metas = sorted((tmp / "cache" / "metadata").glob("*.json"))
        shapes = {}
        for meta in metas:
            for k, h in json.loads(meta.read_text())["keys"].items():
                arr = read_npz_data(tmp / "cache" / k / f"{h}.npz")
                shapes[k] = tuple(arr.shape)
                if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                    raise AssertionError(f"cache {k}: non-finite values")
        enc, wr = stats["encode_s"], stats["write_s"]
        print(f"[qwen_cache] --cache over {G_PAIRS} 832×576 pairs: {wall:.1f} s in main() (the "
              f"DiT and VAE built; Qwen2.5-VL drawn on first use), the pass "
              f"{stats['seconds']:.2f} s (the loader's PNG reads inside); per sample encode "
              + ", ".join(f"{s:.3f}" for s in enc) + " s (the first draws Qwen2.5-VL; the VL "
              "runs twice a sample, the prompt and the empty prompt, each with the control), "
              "write " + ", ".join(f"{s:.3f}" for s in wr) + f" s; peak mem {peak} bytes, "
              f"{len(metas)} samples, keys {shapes}; {COUNT_NAMES} launches "
              f"{_launch_counts()} [{card}]", flush=True)
        if (stats["samples"] != G_PAIRS or len(metas) != G_PAIRS or shapes != shapes_want
                or any(_launch_counts()) or not EmbeddingCacheManager(tmp / "cache").exists(
                    metas[0].stem)):
            raise AssertionError(f"the Qwen cache pass wrote {stats}, {len(metas)} metadata, "
                                 f"shapes {shapes} (want {shapes_want}), launches "
                                 f"{_launch_counts()}")
        _qwen_encoders_against_cpu(card, trainer, csv_path)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # (b) fit from that cache, validation sampling after each step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        with _StepCounts(step_peak=True) as sc, _VLBuilds(sc) as vb:
            t0 = time.perf_counter()
            trainer = cli.main(["--config", str(path)])
            wall = time.perf_counter() - t0
        fit_total = _launch_counts()
        in_steps = tuple(map(sum, zip(*(r["counts"] for r in sc.steps))))
        val = tuple(a - b for a, b in zip(fit_total, in_steps))
        peaks = [r["peak"] for r in sc.steps]
        label = "Qwen fit from the port's cache"
        hist = trainer.history
        tag = b"validation/sample_0" in _events(trainer.output_dir).read_bytes()
        print(f"[qwen_cache] {label}: {wall:.1f} s in main(), {len(hist)} steps (S = "
              f"{QWEN_MSL} + 2 · {gh * gw}): "
              + "; ".join(f"step {h['step']} {1000 * h['step_s']:.1f} ms, loss {h['loss']:.5f}"
                          for h in hist)
              + f"; peak mem of each step {peaks} bytes (Qwen2.5-VL, {vb.bytes} bytes, built "
              f"after steps {vb.built_at} for the validation set-up and freed after it), from "
              f"step 2's start through its validation {torch.cuda.max_memory_allocated()} "
              f"bytes; validation after each step: {G_VALIDATION_STEPS} steps, image logged "
              f"{tag}, launches {val}; {COUNT_NAMES} launches in the steps {in_steps} [{card}]",
              flush=True)
        _check_fit_run(card, label, trainer, sc.steps, G_FIT_STEPS, lambda rec: per_step)
        n_val = G_FIT_STEPS * G_VALIDATION_STEPS
        val_want = _rq((0, 0, n_val * fwd_k5a, 0, 0, 0, 0, 0, n_val * n, 0))
        if vb.built_at != [1] or val != val_want or not tag:
            raise AssertionError(f"validation launched {val} (want {val_want}), logged {tag}, "
                                 f"the VL built after steps {vb.built_at} (want [1])")
        if not max(peaks[1:]) < vb.bytes:
            raise AssertionError(f"the steps after the validation set-up peaked at {peaks[1:]} "
                                 f"bytes, past the VL's {vb.bytes}: it was not freed")
        out["fit"], out["validation"] = in_steps, val
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # (c) predict on a raw control image
        png_out = tmp / "edit.png"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        trainer = cli.main(["--config", str(path), "--predict", "--control",
                            str(tmp / f"control_{G_PAIRS}.png"), "--prompt", F_PROMPTS[2],
                            "--output", str(png_out), "--steps", str(G_PREDICT_STEPS)])
        wall = time.perf_counter() - t0
        pred, launched = trainer.last_predict, _launch_counts()
        img = read_png(png_out)
        t0 = time.perf_counter()
        trainer.predict([read_png(tmp / "control_0.png")], F_PROMPTS[3],
                        num_inference_steps=G_PREDICT_STEPS)
        torch.cuda.synchronize()
        again = time.perf_counter() - t0
        want = _rq((0, 0, G_PREDICT_STEPS * fwd_k5a, 0, 0, 0, 0, 0, G_PREDICT_STEPS * n, 0))
        print(f"[qwen_cache] --predict from an 832×576 PNG: {wall:.1f} s in main() (DiT, VAE "
              f"built, Qwen2.5-VL drawn), {pred['steps']} steps "
              f"{1000 * pred['denoise_s'] / pred['steps']:.1f} ms/step, decode "
              f"{1000 * pred['decode_s']:.1f} ms; a second request on the loaded model "
              f"{again:.2f} s (encode, {G_PREDICT_STEPS} steps, decode); peak mem "
              f"{torch.cuda.max_memory_allocated()} bytes; output {img.dtype} {list(img.shape)}, "
              f"latents finite {pred['latents_finite']}; {COUNT_NAMES} launches {launched} "
              f"[{card}]", flush=True)
        if (img.dtype != np.uint8 or img.shape != (QWEN_HEIGHT, QWEN_WIDTH, 3)
                or not pred["latents_finite"] or launched != want):
            raise AssertionError(f"--predict gave {img.dtype} {img.shape}, launches {launched} "
                                 f"(want {want})")
        out["predict"] = launched

        # (d) mixed sizes in one padded batch, on the loaded model
        items = [{"prompt": F_PROMPTS[0], "images": [read_png(tmp / "control_0.png")]},
                 {"prompt": F_PROMPTS[1], "images": [read_png(tmp / "control_1.png")],
                  "height": QWEN512, "width": QWEN512}]
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        outs = trainer.predict_multires(items, num_inference_steps=G_MULTIRES_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = _launch_counts()
        want = _rq((0, 0, G_MULTIRES_STEPS * fwd_k5a, 0, 0, 0, 0, 0, G_MULTIRES_STEPS * n, 0))
        print(f"[qwen_cache] Qwen predict_multires, an 832×576 and a 512² item in one padded "
              f"batch, {G_MULTIRES_STEPS} steps: {secs:.2f} s (encode, steps, two decodes), "
              f"outputs " + ", ".join(f"{o.dtype} {list(o.shape)}" for o in outs)
              + f"; {COUNT_NAMES} launches {launched} [{card}]", flush=True)
        if ([o.shape for o in outs] != [(QWEN_HEIGHT, QWEN_WIDTH, 3), (QWEN512, QWEN512, 3)]
                or launched != want):
            raise AssertionError(f"Qwen predict_multires gave {[o.shape for o in outs]}, "
                                 f"launches {launched} (want {want})")
        out["multires"] = launched
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_flux_multires(card: str) -> tuple[int, ...]:
    """Phase G(d), FLUX.1-Kontext-dev at full width (the phase F config,
    synthetic weights): `Trainer.predict_multires` over a 512² and a
    768×512 item in one padded batch, G_MULTIRES_STEPS steps, one attention
    launch a block a step (K1 or K3, as S decides), outputs at each item's
    size.  Returns the launches (`_launch_counts`' order)."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.models.flux.transformer import FluxConfig
    from qflux_tpu_torch.trainer.base import Trainer

    n_blocks = FluxConfig().num_layers + FluxConfig().num_single_layers
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_flux_multires_"))
    try:
        trainer = Trainer(config_from_dict(_f_config(tmp / "unread.csv", tmp)), device="cuda")
        rng = np.random.default_rng(92)
        items = [{"prompt": F_PROMPTS[0],
                  "images": [rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)]},
                 {"prompt": F_PROMPTS[1],
                  "images": [rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)],
                  "height": 768, "width": 512}]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.load_model()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        _reset_counts()
        t0 = time.perf_counter()
        outs = trainer.predict_multires(items, num_inference_steps=G_MULTIRES_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = _launch_counts()
        print(f"[qwen_cache] FLUX predict_multires, a 512² and a 768×512 item in one padded "
              f"batch, {G_MULTIRES_STEPS} steps: model built in {load_s:.1f} s, {secs:.2f} s "
              f"(T5-XXL drawn, encode, steps, two decodes), outputs "
              + ", ".join(f"{o.dtype} {list(o.shape)}" for o in outs)
              + f"; {COUNT_NAMES} launches {launched} [{card}]", flush=True)
        if ([o.shape for o in outs] != [(HEIGHT, WIDTH, 3), (768, 512, 3)]
                or launched[0] + launched[8] != G_MULTIRES_STEPS * n_blocks
                or sum(launched) != launched[0] + launched[8]):
            raise AssertionError(f"FLUX predict_multires gave {[o.shape for o in outs]}, "
                                 f"launches {launched}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return launched
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class _PathShapes:
    """Inside the `with` block, records each distinct shape at which the
    launchers of K1, K2, K3, K4, K5a, K5b and the row quantization are
    called: K1 and K2 by q's shape, st, cos / sin's shape, whether
    segment ids are given, the s_int8 mode's q_rows and q's dtype, their ids
    copied at the first launch; K3 and K4 by q's and k's shapes, whether ids
    are given and q's dtype (bf16: the wgmma kernels; f32: K3 on
    csrc/flash_f32_fwd.cu, K4 on csrc/flash_f32_bwd.cu), their segment ids copied at the
    first launch; K5a and K5b by M, K, N, the weight's group count and the output
    dtype; the row quantization by its input's shape and dtype and whether
    s_vec multiplies it first.  Only shapes and ids are kept, so what the
    path measures is unchanged.  `phase_path_shapes` holds each kernel to
    its plain version there."""

    def __enter__(self):
        from qflux_tpu_torch.ops import flash_attention as fa
        from qflux_tpu_torch.ops import flash_nr as fnr
        from qflux_tpu_torch.ops import int4_matmul as ti4

        self.k1, self.k2, self.k3, self.k4, self.k5a, self.k5b, self.rq = ({} for _ in range(7))
        self.saved = [(fnr, "_flash_nr_cuda"), (fnr, "_flash_nr_bwd_cuda"),
                      (fa, "_flash_fwd_cuda"), (fa, "_flash_bwd_cuda"),
                      (ti4, "rq_int4_fwd_cuda"), (ti4, "rq_int4_bwd_cuda"),
                      (ti4, "rowquant_cuda")]
        f1, f2, f3, f4, f5a, f5b, frq = self.orig = [getattr(m, n) for m, n in self.saved]

        def nr_ids(table, q, cos, st, seg, q_rows):
            key = (tuple(q.shape), int(st), tuple(cos.shape), seg is not None, int(q_rows),
                   q.dtype)
            if key not in table:
                table[key] = None if seg is None else seg.clone()

        def k1(q, k, v, qs, ks, cos, sin, st, seg, scale, q_rows=0):
            nr_ids(self.k1, q, cos, st, seg, q_rows)
            return f1(q, k, v, qs, ks, cos, sin, st, seg, scale, q_rows)

        def k2(q, k, v, qs, ks, cos, sin, st, seg, scale, out, lse, do, q_rows=0):
            nr_ids(self.k2, q, cos, st, seg, q_rows)
            return f2(q, k, v, qs, ks, cos, sin, st, seg, scale, out, lse, do, q_rows)

        def ids(table, q, k, q_seg, kv_seg):
            key = (tuple(q.shape), tuple(k.shape), q_seg is not None, q.dtype)
            if key not in table:
                table[key] = tuple(None if t is None else t.clone() for t in (q_seg, kv_seg))

        def k3(q, k, v, q_seg, kv_seg, scale):
            ids(self.k3, q, k, q_seg, kv_seg)
            return f3(q, k, v, q_seg, kv_seg, scale)

        def k4(q, k, v, q_seg, kv_seg, out, lse, do, scale):
            ids(self.k4, q, k, q_seg, kv_seg)
            return f4(q, k, v, q_seg, kv_seg, out, lse, do, scale)

        def k5a(xq, q4, f, sx, s_vec, out_dtype):
            self.k5a[(xq.shape[0], xq.shape[1], q4.shape[1], f.shape[0], out_dtype)] = True
            return f5a(xq, q4, f, sx, s_vec, out_dtype)

        def k5b(gq, q4, f, sg, out_dtype):
            self.k5b[(gq.shape[0], 2 * q4.shape[0], gq.shape[1], f.shape[0], out_dtype)] = True
            return f5b(gq, q4, f, sg, out_dtype)

        def rq(x, s_vec=None):
            self.rq[(x.shape[0], x.shape[1], x.dtype, s_vec is not None)] = True
            return frq(x, s_vec)

        for (mod, name), fn in zip(self.saved, (k1, k2, k3, k4, k5a, k5b, rq)):
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.saved, self.orig):
            setattr(mod, name, fn)
        return False


def _nr_inputs(gen, q_shape, cos_shape, dtype=torch.bfloat16):
    """K1 / K2 inputs at a path's shapes: q, k, v ~ N(0, 1) in `dtype`, norm
    scales 1 + 0.1 · N, cos / sin of random angles [S, D] (or [B, S, D]:
    per-sample ids), as `_attn_inputs`."""
    q, k, v, qs2, ks2, _, _ = _attn_inputs(gen, q_shape[0], q_shape[1], q_shape[2],
                                           q_shape[3], dtype)
    ang = torch.rand(*cos_shape[:-1], cos_shape[-1] // 2, device="cuda", generator=gen) * 6.28
    return (q, k, v, qs2, ks2, torch.cat([ang.cos()] * 2, -1).contiguous(),
            torch.cat([ang.sin()] * 2, -1).contiguous())


def _f32_int8_prep(args, st, tiles) -> tuple[tuple, bool, str]:
    """The f32 s_int8 mode's prep alone (`_int8_operands_cuda`) at each q
    tile of `tiles`: its qn / kn within F32_REL_TOL of the plain norm +
    rope, its int8 operands and scales equal to the bit to `quant_rows` of
    that qn / kn.  Returns ((qn, kn), ok, text), the int8 values that the
    plain qn / kn would put on another step counted in the text: a qn an
    f32 ulp away from the plain one can cross a rounding midpoint, so the
    plain int8 versions are held to the kernel on the kernel's qn / kn."""
    from qflux_tpu_torch.ops import flash_nr as fnr

    q, k, _, qs2, ks2, cos, sin = args
    pq, pk = (fnr.apply_qk_norm_rope(x, s2, cos, sin, st) for x, s2 in ((q, qs2), (k, ks2)))
    ok, flips, s = True, 0, q.shape[1]
    for rows in sorted(set(tiles)):
        qn, kn, qq, kq, q_sc, k_sc = fnr._int8_operands_cuda(q, k, qs2, ks2, cos, sin, st, rows)
        wq, wqs = fnr.quant_rows(qn, rows)
        wk, wks = fnr.quant_rows(kn, s)
        ok = (ok and torch.equal(qq, wq) and torch.equal(q_sc, wqs) and torch.equal(kq, wk)
              and torch.equal(k_sc, wks[:, 0]))
        flips += int((fnr.quant_rows(pq, rows)[0] != qq).sum() + (fnr.quant_rows(pk, s)[0]
                                                                   != kq).sum())
    err = max(_rel(qn, pq), _rel(kn, pk))
    ok = ok and err <= F32_REL_TOL
    return (qn, kn), ok, (f"prep: qn / kn rel_err {err:.3e} (tol {F32_REL_TOL}), int8 operands "
                          f"and scales equal to quant_rows of them: {ok}; {flips} int8 values "
                          f"the plain qn / kn would round to the next step")


def _k1_k2_agree(gen, q_shape, st, cos_shape, seg, dtype=torch.bfloat16,
                 s_int8=False) -> tuple[bool, str]:
    """K1 (bf16 mode, or f32 through csrc/flash_f32_fwd.cu) at a path's shape,
    st and segment ids against flash_attention_nr_reference (bf16: out
    within OUT_ATOL, lse within LSE_ATOL; f32: both within F32_REL_TOL
    relative L2; finite), then K2 from K1's out / lse with do ~ N(0, 1)
    against flash_attention_nr_bwd_reference (bf16: each gradient within
    BWD_REL_TOL relative L2 and BWD_MAX_TOL × max |reference|; f32: within
    F32_GRAD_TOL relative L2; finite).  s_int8 (f32 only): both in their
    s_int8 mode at JAX's tiles for this S, the prep held by
    `_f32_int8_prep`, against the plain int8 versions on the prep's qn /
    kn.  Returns (ok, the errors as text)."""
    from qflux_tpu_torch.ops import flash_nr

    f32 = dtype == torch.float32
    args = _nr_inputs(gen, q_shape, cos_shape, dtype)
    scale = q_shape[-1] ** -0.5
    fwd_rows, bwd_rows = flash_nr.s_int8_tiles(q_shape[1], q_shape[-1]) if s_int8 else (0, 0)
    prep_ok, prep_text, normed = True, "", None
    if s_int8:  # held on the kernel's qn / kn (`_f32_int8_prep`)
        normed, prep_ok, prep_text = _f32_int8_prep(args, st, (fwd_rows, bwd_rows))
        prep_text += "; "
    out, lse = flash_nr._flash_nr_cuda(*args, st, seg, scale, fwd_rows)
    torch.cuda.synchronize()
    if s_int8:
        ref, ref_lse = flash_nr.flash_attention_nr_int8_reference(
            *args, st, fwd_rows, segment_ids=seg, scale=scale, normed=normed)
    else:
        ref, ref_lse = flash_nr.flash_attention_nr_reference(*args, st, segment_ids=seg)
    ok, errs = _fwd_agrees(out, lse, ref, ref_lse, f32)
    ok = ok and prep_ok
    errs = [prep_text + "K1 " + errs]
    del ref, ref_lse
    do = torch.randn(q_shape, device="cuda", generator=gen).to(dtype)
    got = flash_nr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do, bwd_rows)
    torch.cuda.synchronize()
    if s_int8:
        ref = flash_nr.flash_attention_nr_int8_bwd_reference(
            *args, st, do, out, lse, bwd_rows, segment_ids=seg, scale=scale, normed=normed)
    else:
        ref = flash_nr.flash_attention_nr_bwd_reference(*args, st, do, segment_ids=seg,
                                                        scale=scale)
    for gname, g, r in zip(("dq", "dk", "dv", "dqs", "dks"), got, ref):
        g_ok, text = _grad_agrees(g, r, f32)
        ok = ok and g_ok
        errs.append(f"K2 {gname} {text}")
    del args, out, lse, do, got, ref
    torch.cuda.empty_cache()
    return ok, "; ".join(errs) + f" ({_tol_text(f32)})"


def _fwd_agrees(out, lse, ref, ref_lse, f32) -> tuple[bool, str]:
    """An attention forward against its plain version: bf16, out within
    OUT_ATOL and lse within LSE_ATOL (max |error|); f32, both within
    F32_REL_TOL (relative L2); lse over the rows that attend anything, out
    finite.  Returns (ok, the errors as text)."""
    valid = ref_lse > -1e29
    if f32:
        err, lse_err = _rel(out, ref), _rel(lse[valid], ref_lse[valid])
        ok = err <= F32_REL_TOL and lse_err <= F32_REL_TOL
        text = f"rel_err(out) {err:.3e}, rel_err(lse) {lse_err:.3e} (tol {F32_REL_TOL})"
    else:
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs()[valid].max().item()
        ok = err <= OUT_ATOL and lse_err <= LSE_ATOL
        text = (f"max_abs_err(out) {err:.3e} (tol {OUT_ATOL}), max_abs_err(lse) "
                f"{lse_err:.3e} (tol {LSE_ATOL})")
    return ok and bool(torch.isfinite(out).all()), text


def _grad_agrees(g, r, f32) -> tuple[bool, str]:
    """A gradient against its plain (f32) version: bf16, within BWD_REL_TOL
    relative L2 and BWD_MAX_TOL × max |reference|; f32, within F32_GRAD_TOL
    relative L2; finite.  Returns (ok, the errors as text)."""
    diff = g.float() - r
    rel = (diff.norm() / r.norm()).item()
    mx = diff.abs().max().item()
    ok = rel <= (F32_GRAD_TOL if f32 else BWD_REL_TOL) and bool(torch.isfinite(g).all())
    if not f32:
        ok = ok and mx <= BWD_MAX_TOL * r.abs().max().item()
    return ok, f"rel {rel:.3e} max {mx:.3e}"


def _tol_text(f32) -> str:
    return (f"tol rel {F32_GRAD_TOL}" if f32
            else f"tol rel {BWD_REL_TOL}, max {BWD_MAX_TOL} x max|ref|")


def _rq_agrees(gen, m, k_in, n, n_groups, dtype, backward) -> tuple[bool, float]:
    """rq_fused_matmul (the row quantization and K5a; with `backward` its
    dx, the row quantization of g · s_vec and K5b) on seeded x [M, K] (g
    [M, N]) and weights U(±1/sqrt(K)) quantized to int4 in `n_groups`
    groups, against the plain requant_int4_matmul (its dx): equal to the
    bit and finite.  Returns (ok, max |difference|)."""
    from qflux_tpu_torch.ops import int4_matmul as ti4, quant

    w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
    q4, scale = quant.quantize_kernel_int4(w, k_in // n_groups)
    f, sv = quant._requant_factors(scale)
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(dtype)
    if backward:
        g = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
        x.requires_grad_()
        ti4.rq_fused_matmul(x, q4, scale, (f, sv)).backward(g)
        got, want = x.grad, quant.requant_int4_matmul_dx(g, q4, (f, sv))
    else:
        got = ti4.rq_fused_matmul(x, q4, scale, (f, sv))
        want = quant.requant_int4_matmul(x, q4, scale, (f, sv))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    return torch.equal(got, want) and bool(torch.isfinite(got).all()), err


def _dt(dtype) -> str:
    return str(dtype).split(".")[-1]


def _ids_text(q_seg) -> str:
    if q_seg is None:
        return "no ids"
    return f"the path's segment ids ({int((q_seg == 0).sum())} padding rows)"


def phase_path_shapes(card: str, rec: _PathShapes, label: str = "phase G") -> dict:
    """Every kernel a phase launched, held to its plain version at each
    shape the phase gave it (`_PathShapes`), on seeded inputs: K1 and K2
    (bf16) with the path's st and segment ids (`_k1_k2_agree`), K3 with the
    path's own segment ids (`_k3_agrees`: out within OUT_ATOL, lse within
    LSE_ATOL, the rows every head masks at 0), K4 from that K3's out / lse
    with do ~ N(0, 1) (`_k4_agrees`), K5a and K5b through rq_fused_matmul
    and its dx (`_rq_agrees`: to the bit), the row quantization against
    quant._rowquant (to the bit).  Returns the number of shapes checked per
    kernel."""
    from qflux_tpu_torch.ops import flash_attention as fa
    from qflux_tpu_torch.ops import int4_matmul as ti4, quant

    gen = torch.Generator("cuda").manual_seed(93)

    def qkv(q_shape, k_shape, dtype):
        return [torch.randn(sh, device="cuda", generator=gen).to(dtype)
                for sh in (q_shape, k_shape, k_shape)]

    bad = []
    for key in sorted(set(rec.k1) | set(rec.k2), key=str):
        q_shape, st, cos_shape, _, q_rows, dtype = key
        if q_rows and dtype != torch.float32:  # no such phase runs bf16 s_int8 attention
            raise AssertionError(f"a bf16 s_int8 launch at {key} has no shape check here")
        seg = rec.k1.get(key, rec.k2.get(key))
        ok, errs = _k1_k2_agree(gen, q_shape, st, cos_shape, seg, dtype, s_int8=bool(q_rows))
        print(f"[path_shapes] K1 / K2{' s_int8' if q_rows else ''} at q {list(q_shape)} "
              f"{_dt(dtype)}, st {st}, cos "
              f"{list(cos_shape)}, {_ids_text(seg)} (launched: K1 {key in rec.k1}, K2 "
              f"{key in rec.k2}): {errs}: {ok} [{card}]", flush=True)
        bad += [] if ok else [f"K1 / K2 {q_shape}"]
    for (q_shape, k_shape, _, dtype), (q_seg, kv_seg) in rec.k3.items():
        q, k, v = qkv(q_shape, k_shape, dtype)
        ok, err, lse_err, dead, _, _ = _k3_agrees(q, k, v, q_seg, kv_seg,
                                                  q_shape[-1] ** -0.5)
        f32 = dtype == torch.float32
        print(f"[path_shapes] K3 at q {list(q_shape)} {_dt(dtype)}, k {list(k_shape)}, "
              f"{_ids_text(q_seg)}: {'rel_err' if f32 else 'max_abs_err'}(out) {err:.3e} "
              f"(tol {F32_REL_TOL if f32 else OUT_ATOL}), "
              f"{'rel_err' if f32 else 'max_abs_err'}(lse) {lse_err:.3e} "
              f"(tol {F32_REL_TOL if f32 else LSE_ATOL}), {int(dead.sum())} fully masked rows "
              f"at 0: {ok} [{card}]", flush=True)
        bad += [] if ok else [f"K3 {q_shape}"]
        del q, k, v
        torch.cuda.empty_cache()
    for (q_shape, k_shape, _, dtype), (q_seg, kv_seg) in rec.k4.items():
        q, k, v = qkv(q_shape, k_shape, dtype)
        scale = q_shape[-1] ** -0.5
        out, lse = fa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
        do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        ok, errs, _, _ = _k4_agrees(q, k, v, q_seg, kv_seg, out, lse, do, scale)
        print(f"[path_shapes] K4 at q {list(q_shape)} {_dt(dtype)}, k {list(k_shape)}, "
              f"{_ids_text(q_seg)}: {errs} ({_tol_text(dtype == torch.float32)}), two calls "
              f"identical: {ok} [{card}]", flush=True)
        bad += [] if ok else [f"K4 {q_shape}"]
        del q, k, v, out, lse, do
        torch.cuda.empty_cache()
    for name, table, backward in (("K5a", rec.k5a, False), ("K5b", rec.k5b, True)):
        res = {key: _rq_agrees(gen, *key[:4], key[4], backward) for key in sorted(
            table, key=str)}
        print(f"[path_shapes] {name} (through rq_fused_matmul{' dx' if backward else ''}) at "
              f"(M, K, N, groups): " + ", ".join(f"{key[:4]} {'ok' if ok else f'err {e:.3e}'}"
                                                 for key, (ok, e) in res.items())
              + f"; max |kernel - plain| {max((e for _, e in res.values()), default=0.0)} "
              f"(tol 0) [{card}]", flush=True)
        bad += [f"{name} {key[:4]}" for key, (ok, _) in res.items() if not ok]
        torch.cuda.empty_cache()
    rq_res = {}
    for m, k_in, dtype, with_s in sorted(rec.rq, key=str):
        x = torch.randn(m, k_in, device="cuda", generator=gen).to(dtype)
        s_vec = (torch.rand(k_in, device="cuda", generator=gen) + 0.5) if with_s else None
        got = ti4.rowquant_cuda(x, s_vec)
        want = quant._rowquant(x if s_vec is None else x.float() * s_vec)
        rq_res[(m, k_in, str(dtype).split(".")[-1], with_s)] = (
            torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    print(f"[path_shapes] row quantization against quant._rowquant to the bit at (M, K, dtype, "
          f"x s_vec): " + ", ".join(f"{key} {ok}" for key, ok in rq_res.items())
          + f" [{card}]", flush=True)
    bad += [f"row quantization {key}" for key, ok in rq_res.items() if not ok]
    if bad:
        raise AssertionError(f"at the shapes {label} gave them, these disagree with their "
                             f"plain versions: {bad}")
    return {"K1": len(rec.k1), "K2": len(rec.k2), "K3": len(rec.k3), "K4": len(rec.k4),
            "K5a": len(rec.k5a), "K5b": len(rec.k5b), "row quant": len(rq_res)}


# ---------------------------------------------------------------------------
# phase H: the remaining families (FLUX.2-Klein, Qwen-Image-Edit-Plus,
# DreamOmni2) from raw images, through qflux_tpu_torch.main

H_PROMPTS = F_PROMPTS[:2]
H_KLEIN_FIT_STEPS = 3             # Klein fit steps at bs 2 from its cache
H_KLEIN_PREDICT_STEPS = 8         # Klein --predict's denoising steps
H_PLUS_FIT_STEPS = 2              # Qwen-Image-Edit-Plus fit steps at bs 1
H_PLUS_PREDICT_STEPS = 4
H_D2_FIT_STEPS = 2                # DreamOmni2 fit steps at bs 1
H_D2_PREDICT_STEPS = 4
H_D2_DEPTH = (4, 8)               # FLUX.1-Kontext cut to 4 dual + 8 single blocks
H_NEW_TOKENS = 128                # the prompt enhancer's greedy tokens (JAX's default)
H_Q3_LAYER = 9                    # the Qwen3 layer the CPU check reaches (Klein picks 9, 18, 27)
# Qwen3-4B on the card against the same layers on the CPU, per layer of the
# depth checked: each layer sums over 2,560 / 4,096 / 9,728 terms in other
# orders on the two devices (T5-XXL's blocks moved by ~3e-6 each), and
# the layers add their differences up; a wrong operation moves it by 1e-2
Q3_LAYER_REL_TOL = 2e-6
# the cached decode's hidden states against one uncached text_forward over
# the whole generated sequence, both f32 on the card with TF32 off: the same
# layers, whose attention multiplies matrices of other shapes (one query row
# against the cache, or every row at once), so cuBLAS sums in other orders;
# relative L2 over every compared row (the prefill's and each step's), far
# below the O(1) error of a stale or misplaced cache slot
KV_REL_TOL = 1e-4


def _pairs_csv(tmp: Path, rows: list, size: int, seed: int) -> Path:
    """PNGs of `size`² from a seeded stream and a CSV of them: each row
    (prompt, number of controls) gets target_i.png and control_i_j.png."""
    from qflux_tpu_torch.utils.png import encode_png

    rng = np.random.default_rng(seed)
    n_ctl = max(n for _, n in rows)
    head = ["path_target"] + [f"path_control{'' if j == 0 else f'_{j}'}" for j in range(n_ctl)]
    lines = [",".join(head + ["prompt"])]
    for i, (prompt, n) in enumerate(rows):
        names = [f"target_{i}.png"] + [f"control_{i}_{j}.png" for j in range(n)]
        for name in names:
            (tmp / name).write_bytes(encode_png(rng.integers(0, 256, (size, size, 3),
                                                             dtype=np.uint8)))
        lines.append(",".join(names + [""] * (n_ctl - n) + [prompt]))
    path = tmp / "pairs.csv"
    path.write_text("\n".join(lines) + "\n")
    return path


def _h_config(trainer: str, csv_path: Path, out_dir: Path, processor: dict, **over) -> dict:
    """A family's config at full width (synthetic weights: no checkpoint)
    over `csv_path`, bs 1, its cache in out_dir/cache, bf16 DiT."""
    raw = {"trainer": trainer, "mesh": {"dp": 1, "fsdp": 1, "tp": 1},
           "model": {"variant": "full", "lora": {"r": 16, "lora_alpha": 16}},
           "data": {"init_args": {"csv_path": str(csv_path)}, "processor": processor,
                    "batch_size": 1, "shuffle": False},
           "cache": {"use_cache": True, "cache_dir": str(out_dir / "cache")},
           "predict": {"max_sequence_length": 512},
           "train": {"weight_dtype": "bfloat16", "checkpointing_steps": 1000},
           "logging": {"output_dir": str(out_dir), "project": trainer}}
    for section, values in over.items():
        raw.setdefault(section, {}).update(values)
    return raw


def _shapes_match(shapes: dict, want: dict) -> bool:
    """The cache's keys are `want`'s, each at its shape (-1: any size)."""
    return sorted(shapes) == sorted(want) and all(
        len(shapes[k]) == len(w) and all(b in (-1, a) for a, b in zip(shapes[k], w))
        for k, w in want.items())


def _h_cache(card: str, label: str, argv: list, want_shapes: dict, n: int):
    """`--cache` through main(): n samples, every array finite, the keys at
    `want_shapes` (`_shapes_match`), no kernel launched.  Returns (trainer,
    seconds, peak)."""
    from qflux_tpu_torch import main as cli
    from qflux_tpu_torch.data.cache import read_npz_data

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(argv + ["--cache"])
    torch.cuda.synchronize()
    wall, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    cache = Path(trainer.config.cache.cache_dir)
    metas = sorted((cache / "metadata").glob("*.json"))
    shapes = {}
    for meta in metas:
        for k, h in json.loads(meta.read_text())["keys"].items():
            arr = read_npz_data(cache / k / f"{h}.npz")
            shapes.setdefault(k, tuple(arr.shape))
            if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                raise AssertionError(f"{label} cache {k}: non-finite values")
    st = trainer.last_cache
    print(f"[{label}] --cache over {n} samples: {wall:.1f} s in main() (the models drawn), "
          f"per sample encode " + ", ".join(f"{x:.3f}" for x in st["encode_s"]) + " s, write "
          + ", ".join(f"{x:.3f}" for x in st["write_s"]) + f" s; peak mem {peak} bytes; keys "
          f"{shapes}; {COUNT_NAMES} launches {_launch_counts()} [{card}]", flush=True)
    if (st["samples"] != n or len(metas) != n or not _shapes_match(shapes, want_shapes)
            or any(_launch_counts())):
        raise AssertionError(f"{label} cache pass: {st}, {len(metas)} metadata, shapes {shapes} "
                             f"(want {want_shapes}), launches {_launch_counts()}")
    return trainer, wall, peak


def _h_fit(card: str, label: str, argv: list, steps: int, per_step: tuple) -> tuple:
    """A fit from the cache through main(): `steps` finite steps on the
    card with exactly `per_step` launches each.  Returns (launches in the
    steps, median ms a step, peak)."""
    from qflux_tpu_torch import main as cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with _StepCounts() as sc:
        t0 = time.perf_counter()
        trainer = cli.main(argv)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    ms = statistics.median(1000 * h["step_s"] for h in hist)
    print(f"[{label}] fit from the cache: {wall:.1f} s in main(), {len(hist)} steps: "
          + "; ".join(f"step {h['step']} (bs {r['img'][0]}, image {r['img'][1]} + control "
                      f"{r['ctl'][1]} tokens) {1000 * h['step_s']:.1f} ms, loss {h['loss']:.5f}"
                      for h, r in zip(hist, sc.steps))
          + f"; median {ms:.1f} ms/step; peak mem {peak} bytes; {COUNT_NAMES} launches a step "
          f"{[r['counts'] for r in sc.steps]} [{card}]", flush=True)
    _check_fit_run(card, f"{label} fit", trainer, sc.steps, steps, lambda rec: per_step)
    in_steps = tuple(map(sum, zip(*(r["counts"] for r in sc.steps))))
    if _launch_counts() != in_steps:
        raise AssertionError(f"{label} fit launched {_launch_counts()} outside its steps "
                             f"{in_steps}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return in_steps, ms, peak


def _h_predict(card: str, label: str, argv: list, controls: list, steps: int, per_step: tuple,
               size: int) -> tuple:
    """--predict through main() on raw control PNGs: a [size, size, 3]
    uint8 PNG, finite latents, exactly `per_step` launches a denoising
    step.  Returns (launches, s a request, peak)."""
    from qflux_tpu_torch import main as cli
    from qflux_tpu_torch.utils.png import read_png

    out = Path(argv[1]).parent / "edit.png"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    flags = [x for c in controls for x in ("--control", str(c))]
    trainer = cli.main(argv + ["--predict", *flags, "--prompt", F_PROMPTS[2], "--output",
                               str(out), "--steps", str(steps)])
    torch.cuda.synchronize()
    wall, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    pred, launched, img = trainer.last_predict, _launch_counts(), read_png(out)
    want = tuple(steps * c for c in per_step)
    print(f"[{label}] --predict on {len(controls)} control PNG(s): {wall:.1f} s in main() (the "
          f"models drawn, the request), {pred['steps']} steps "
          f"{1000 * pred['denoise_s'] / pred['steps']:.1f} ms/step, decode "
          f"{1000 * pred['decode_s']:.1f} ms; peak mem {peak} bytes; output {img.dtype} "
          f"{list(img.shape)}, latents finite {pred['latents_finite']}; {COUNT_NAMES} launches "
          f"{launched} [{card}]", flush=True)
    if (img.dtype != np.uint8 or img.shape != (size, size, 3) or not pred["latents_finite"]
            or launched != want):
        raise AssertionError(f"{label} --predict gave {img.dtype} {img.shape}, launches "
                             f"{launched} (want {want})")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launched, wall, peak


def _qwen3_against_cpu(card: str, trainer, csv_path: Path) -> None:
    """The first sample's prompt through Qwen3-4B's first H_Q3_LAYER layers
    on the CPU (streamed, `_StreamedLM`), against the card's f32 run of
    the same layers (within Q3_LAYER_REL_TOL a layer) and against the first
    2,560 channels (layer 9's state) of the fp16 prompt_embeds --cache
    wrote for that prompt (its prompt_hash; within that plus FP16_REL); the CPU's seconds and the card's
    time for all 27 layers Klein runs."""
    from qflux_tpu_torch.data.cache import read_npz_data
    from qflux_tpu_torch.data.dataset import read_csv
    from qflux_tpu_torch.models.flux2 import text_encoder as tq3
    from qflux_tpu_torch.trainer.flux2_klein import qwen3_encoder
    from qflux_tpu_torch.utils.hashing import md5_string

    bundle = trainer.bundle
    enc, tcfg = qwen3_encoder(bundle), bundle.text_cfgs["qwen3"]
    prompt = str(read_csv(str(csv_path))[1][0]["prompt"])
    tok = bundle.tokenizers["qwen3"]  # the hash tokenizer, as the adapter calls it
    ids = tok([prompt], max_length=min(trainer.config.predict.max_sequence_length,
                                       tok.max_length))
    mask = (ids != 0).astype(np.int64)
    t0 = time.perf_counter()
    want = tq3.encode(_StreamedLM(enc, tq3.Qwen3Layer, H_Q3_LAYER), tcfg, ids,
                      attention_mask=mask, hidden_states_layers=(H_Q3_LAYER,))
    cpu_s = time.perf_counter() - t0
    got = tq3.encode(enc, tcfg, ids, attention_mask=mask, hidden_states_layers=(H_Q3_LAYER,))
    cached = read_npz_data(Path(trainer.config.cache.cache_dir) / "prompt_embeds"
                           / f"{md5_string(prompt)}.npz")  # the sample's prompt_hash
    tol = Q3_LAYER_REL_TOL * H_Q3_LAYER
    card_err = _rel(got[0], want[0])
    layers = bundle.text_cfgs["hidden_states_layers"]
    d, at = tcfg.hidden_size, layers.index(H_Q3_LAYER)
    cache_err = _rel(torch.from_numpy(np.array(cached[:, at * d:(at + 1) * d])).float(),
                     want[0])
    ms = _median_ms(lambda: tq3.encode(enc, tcfg, ids, attention_mask=mask,
                                       hidden_states_layers=layers), n=3)
    print(f"[klein] sample 0's prompt through Qwen3-4B layers 1-{H_Q3_LAYER} at {ids.shape[1]} "
          f"tokens on the CPU (streamed) in {cpu_s:.1f} s: rel L2 err of the card's f32 state "
          f"{card_err:.3e} (tol {tol:.2e}), of the cache's fp16 layer-{H_Q3_LAYER} channels "
          f"{cache_err:.3e} (tol {tol + FP16_REL:.2e}); on the card, f32, TF32 off: the "
          f"{max(layers)} layers Klein runs at {ids.shape[1]} tokens {ms:.2f} ms [{card}]",
          flush=True)
    if card_err > tol or cache_err > tol + FP16_REL:
        raise AssertionError(f"Qwen3 on the card or the cache disagrees with the CPU: "
                             f"{card_err}, {cache_err}")


def phase_klein(card: str) -> dict:
    """Phase H(a), FLUX.2-Klein at full width and depth (`flux2_config()`:
    8 dual + 24 single blocks, 24 heads × 128; the FLUX VAE; Qwen3-4B in
    f32 picked at layers 9, 18, 27; synthetic weights drawn on the card)
    through main(): `--cache` over H_PROMPTS' two 512² target / control
    pairs (JAX's eight keys; the first prompt's Qwen3 states against the
    CPU, `_qwen3_against_cpu`), a fit of H_KLEIN_FIT_STEPS steps at bs 2
    from that cache (S = 512 + 1,024 + 1,024 = 2,560, where JAX runs the
    fused K1 / K2: 32 K1 and 32 K2 a step), `--predict` on a raw control
    PNG (H_KLEIN_PREDICT_STEPS steps, 32 K1 a step).  Returns the launches
    of each path (_launch_counts' order)."""
    from qflux_tpu_torch.trainer.flux2_klein import flux2_config

    n = flux2_config().num_layers + flux2_config().num_single_layers
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_klein_"))
    try:
        csv_path = _pairs_csv(tmp, [(p, 1) for p in H_PROMPTS], HEIGHT, 94)
        raw = _h_config("Flux2KleinLoraTrainer", csv_path, tmp,
                        {"process_type": "resize", "target_size": [HEIGHT, WIDTH]},
                        train={"max_train_steps": H_KLEIN_FIT_STEPS}, data={"batch_size": 2})
        path = tmp / "klein.json"
        path.write_text(json.dumps(raw))
        argv = ["--config", str(path)]
        want = {"image_latents": (1024, 64), "control_latents": (1024, 64),
                "prompt_embeds": (512, 7680), "pooled_prompt_embeds": (7680,),
                "empty_prompt_embeds": (512, 7680), "empty_pooled_prompt_embeds": (7680,),
                "img_ids": (2048, 4), "txt_ids": (512, 4)}
        trainer, cache_s, cache_peak = _h_cache(card, "klein", argv, want, len(H_PROMPTS))
        _qwen3_against_cpu(card, trainer, csv_path)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        fit, fit_ms, fit_peak = _h_fit(card, "klein", argv, H_KLEIN_FIT_STEPS,
                                       _rq((n, n, 0, 0, 0, 0, 0, 0, 0, 0)))
        pred, pred_s, pred_peak = _h_predict(card, "klein", argv, [tmp / "control_0_0.png"],
                                             H_KLEIN_PREDICT_STEPS,
                                             _rq((n, 0, 0, 0, 0, 0, 0, 0, 0, 0)), HEIGHT)
        print(f"[klein] summary: cache {cache_s / len(H_PROMPTS):.2f} s a sample (main() "
              f"included), fit {fit_ms:.1f} ms a step (bs 2), predict {pred_s:.2f} s "
              f"({H_KLEIN_PREDICT_STEPS} steps, main() included), peaks {cache_peak} / "
              f"{fit_peak} / {pred_peak} bytes [{card}]", flush=True)
        return {"klein_fit": fit, "klein_predict": pred}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_qwen_plus(card: str) -> dict:
    """Phase H(b), Qwen-Image-Edit-Plus at full width: the 20B DiT cut to
    CUT_BLOCKS of its 60 blocks over the example config's `int8`
    weight-only base (quantized block by block as drawn), the Qwen VAE and
    Qwen2.5-VL (32 vision blocks, 28 LM layers, f32), through main():
    `--cache` on one sample with a target and two controls at fixed_pixels
    512·512 (the VL sees ≤ 384² condition copies; three image planes),
    a fit of H_PLUS_FIT_STEPS steps at bs 1 (S = text + 3 · 1,024, past
    where JAX runs K1: K3 / K4, one each a block a step), `--predict` with
    two --control images (H_PLUS_PREDICT_STEPS steps, one K3 a block a
    step).  Returns the launches of each path."""
    from qflux_tpu_torch.models.qwen import transformer as qwen_dit

    n = CUT_BLOCKS
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_qwen_plus_"))
    try:
        csv_path = _pairs_csv(tmp, [(H_PROMPTS[0], 2)], HEIGHT, 95)
        raw = _h_config("QwenImageEditPlusTrainer", csv_path, tmp,
                        {"process_type": "fixed_pixels", "target_pixels": HEIGHT * WIDTH},
                        model={"variant": "full", "lora": {"r": 16, "lora_alpha": 16},
                               "quantize": {"enabled": True, "dtype": "int8"}},
                        train={"max_train_steps": H_PLUS_FIT_STEPS})
        path = tmp / "plus.json"
        path.write_text(json.dumps(raw))
        argv = ["--config", str(path)]
        # the prompt's length is the VL's: the template, the instruction and
        # two 384² condition copies of 196 tokens each, the template's first
        # tokens dropped
        want = {"image_latents": (1024, 64), "control_latents": (2048, 64),
                "prompt_embeds": (-1, 3584), "prompt_embeds_mask": (-1,),
                "empty_prompt_embeds": (-1, 3584), "empty_prompt_embeds_mask": (-1,),
                "img_shapes_arr": (3, 3)}
        with _CutDepth(qwen_dit, "QwenImageConfig", num_layers=n):
            trainer, cache_s, cache_peak = _h_cache(card, "qwen_plus", argv, want, 1)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            per_step = _rq((0, 0, 0, 0, 0, 0, 0, 0, n, n))
            fit, fit_ms, fit_peak = _h_fit(card, "qwen_plus", argv, H_PLUS_FIT_STEPS, per_step)
            pred, pred_s, pred_peak = _h_predict(
                card, "qwen_plus", argv, [tmp / "control_0_0.png", tmp / "control_0_1.png"],
                H_PLUS_PREDICT_STEPS, _rq((0, 0, 0, 0, 0, 0, 0, 0, n, 0)), HEIGHT)
        print(f"[qwen_plus] summary: cache {cache_s:.2f} s a sample (main() included), fit "
              f"{fit_ms:.1f} ms a step (bs 1), predict {pred_s:.2f} s ({H_PLUS_PREDICT_STEPS} "
              f"steps, main() included), peaks {cache_peak} / {fit_peak} / {pred_peak} bytes "
              f"[{card}]", flush=True)
        return {"qwen_plus_fit": fit, "qwen_plus_predict": pred}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class _KVRecord:
    """Inside the `with` block: the first prompt enhancement's prefill and
    decode steps (vl_encoder.text_prefill / text_decode_step, as
    DreamOmni2's enhance_prompt calls them), their inputs and hidden
    states, kept on the card, and the host clock at the prefill's launch
    and at each step's launch.  The loop reads the argmax of the head
    product after the prefill and after each step, so the device has
    finished all earlier work when a step launches: the prefill takes
    (first step's launch - prefill's launch), a token (last step's launch -
    first step's launch) / (steps - 1)."""

    def __enter__(self):
        from qflux_tpu_torch.models.qwen import vl_encoder as tvl

        self.tvl, self.orig = tvl, (tvl.text_prefill, tvl.text_decode_step)
        self.prefill, self.steps, self.step_t, self.calls = None, [], [], 0
        real_prefill, real_step = self.orig

        def prefill(params, cfg, embeds, pos, cache):
            t0 = time.perf_counter()
            h, cache = real_prefill(params, cfg, embeds, pos, cache)
            self.calls += 1
            if self.calls == 1:
                self.t0 = t0
                self.prefill = (embeds.clone(), np.asarray(pos), h.clone())
            return h, cache

        def step(params, cfg, embed, pos, cache, cache_len):
            t = time.perf_counter()
            h, cache = real_step(params, cfg, embed, pos, cache, cache_len)
            if self.calls == 1:
                self.step_t.append(t)
                self.steps.append((embed.clone(), np.asarray(pos), h.clone()))
            return h, cache

        tvl.text_prefill, tvl.text_decode_step = prefill, step
        return self

    def __exit__(self, *exc):
        self.tvl.text_prefill, self.tvl.text_decode_step = self.orig
        return False


def _kv_against_full_forward(card: str, trainer, rec: _KVRecord) -> None:
    """The recorded greedy decode held to one uncached text_forward over the
    prompt and every generated token (their embeddings and M-RoPE positions
    as the decode loop fed them): the prefill's hidden states and each
    step's within KV_REL_TOL in relative L2 over all of them."""
    lm, tcfg = trainer.bundle.text_params["text"], trainer.bundle.text_cfgs["text"]
    embeds, pos, h_pre = rec.prefill
    full_embeds = torch.cat([embeds] + [e for e, _, _ in rec.steps], dim=1)
    full_pos = np.concatenate([pos] + [p for _, p, _ in rec.steps], axis=-1)
    from qflux_tpu_torch.models.qwen import vl_encoder as tvl

    with torch.no_grad():
        t0 = time.perf_counter()
        full = tvl.text_forward(lm, tcfg, full_embeds, full_pos)
        torch.cuda.synchronize()
        full_ms = 1000 * (time.perf_counter() - t0)
    n = embeds.shape[1]
    got = torch.cat([h_pre[0]] + [h for _, _, h in rec.steps], dim=0)
    err = _rel(got, full[0, :n + len(rec.steps)])
    prefill_ms = 1000 * (rec.step_t[0] - rec.t0) if rec.step_t else float("nan")
    token_ms = (1000 * (rec.step_t[-1] - rec.step_t[0]) / (len(rec.step_t) - 1)
                if len(rec.step_t) > 1 else float("nan"))
    print(f"[dreamomni2] KV-cached greedy decode: prefill {n} tokens (two 512² references "
          f"in the chat template) {prefill_ms:.2f} ms, then {len(rec.steps)} cached steps "
          f"(of {H_NEW_TOKENS}) at {token_ms:.2f} ms a token (steps 1 to {len(rec.steps) - 1}, "
          f"each with its LM head product and argmax; the prefill's time apart); their "
          f"hidden states against one text_forward over all {n + len(rec.steps)} tokens "
          f"({full_ms:.1f} ms): rel L2 err {err:.3e} (tol {KV_REL_TOL}) [{card}]", flush=True)
    if not len(rec.steps) or err > KV_REL_TOL:
        raise AssertionError(f"the cached decode disagrees with the full forward: {err} "
                             f"({len(rec.steps)} steps)")


def _edit_lora_file(path: Path, cfg, device="cuda") -> tuple[Path, set]:
    """A rank-16 LoRA over every attention projection of `cfg`'s blocks
    (a ~ N(0, 1/in), b ~ N(0, 0.01²), alpha 16), drawn on `device` from a
    seed and written by save_lora_safetensors.  Returns (file, paths)."""
    from qflux_tpu_torch.utils.lora_io import save_lora_safetensors

    gen = torch.Generator(device).manual_seed(96)
    d, r = cfg.dim, 16
    names = [(f"dual/{i}/attn/{m}", d, d) for i in range(cfg.num_layers)
             for m in ("to_q", "to_k", "to_v", "to_out", "add_q", "add_k", "add_v", "add_out")]
    names += [(f"single/{i}/attn/{m}", d, d) for i in range(cfg.num_single_layers)
              for m in ("to_q", "to_k", "to_v")]
    lora = {p: {"a": torch.randn(i, r, device=device, generator=gen) * i ** -0.5,
                "b": torch.randn(r, o, device=device, generator=gen) * 0.01,
                "scaling": torch.tensor(1.0, device=device)} for p, i, o in names}
    return (save_lora_safetensors(lora, path, head_dim=cfg.attention_head_dim),
            {p for p, _, _ in names})


def _drawn_vlm(config, device):
    """`dreamomni2.vlm_factory`'s stand-in for phase H(c): Qwen2.5-VL (32
    vision blocks × 1,280, 28 LM layers × 3,584) and its LM head at full
    width, drawn on `device` from seeds 11 / 12 / 13 when first used, the
    special tokens of the published checkpoint, the hash tokenizer at the
    LM's vocabulary."""
    from qflux_tpu_torch.models.qwen import vl_encoder as tvl
    from qflux_tpu_torch.trainer import dreamomni2 as td2
    from qflux_tpu_torch.trainer.flux_kontext import SimpleTokenizer

    vcfg, tcfg = tvl.VLVisionConfig(), tvl.VLTextConfig()

    def factory():
        return {"vision": tvl.vision_init(torch.Generator(device).manual_seed(11), vcfg, device),
                "text": tvl.text_init(torch.Generator(device).manual_seed(12), tcfg, device),
                "lm_head": td2.lm_head_init(torch.Generator(device).manual_seed(13), tcfg,
                                            device)}

    return ({"vision": vcfg, "text": tcfg, "tokens": tvl.VLSpecialTokens()},
            SimpleTokenizer(tcfg.vocab_size, 1024), factory)


def phase_dreamomni2(card: str) -> dict:
    """Phase H(c), DreamOmni2 at full width: FLUX.1-Kontext cut to 4 dual +
    8 single of its blocks (so that the DiT, T5-XXL's 19 GB and the VL's
    35 GB of f32 fit together), its edit-LoRA fused at load from a file
    written here (`_edit_lora_file`; every LoRA'd weight moved, every other
    equal to a fresh draw), and the VLM prompt enhancer on: Qwen2.5-VL and
    its LM head at full width drawn on the card and attached in process
    (`dreamomni2.vlm_factory` replaced: no config names a VL checkpoint),
    128 greedy tokens.  Through main(): `--cache` on one sample with two
    512² references (the prompt rewritten; the KV-cached decode held to
    one full forward, `_kv_against_full_forward`), a fit of H_D2_FIT_STEPS
    steps at bs 1 (S = 512 + 3 · 1,024 = 3,584: K3 / K4, one each a block
    a step), `--predict` with the two references (H_D2_PREDICT_STEPS
    steps, one K3 a block a step).  Returns the launches of each path."""
    from qflux_tpu_torch.models.flux import transformer as tflux
    from qflux_tpu_torch.trainer import dreamomni2 as td2

    n = sum(H_D2_DEPTH)
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_dreamomni2_"))
    real_factory = td2.vlm_factory
    try:
        with _CutDepth(tflux, "FluxConfig", num_layers=H_D2_DEPTH[0],
                       num_single_layers=H_D2_DEPTH[1]):
            cfg = tflux.FluxConfig()
            lora_file, lora_paths = _edit_lora_file(tmp / "edit_lora.safetensors", cfg)
            csv_path = _pairs_csv(tmp, [(H_PROMPTS[1], 2)], HEIGHT, 97)
            raw = _h_config("DreamOmni2Trainer", csv_path, tmp,
                            {"process_type": "resize", "target_size": [HEIGHT, WIDTH]},
                            model={"variant": "full", "lora": {"r": 16, "lora_alpha": 16},
                                   "pretrained_embeddings": str(lora_file),
                                   "use_vlm_prompt_enhancer": True},
                            train={"max_train_steps": H_D2_FIT_STEPS})
            path = tmp / "dreamomni2.json"
            path.write_text(json.dumps(raw))
            argv = ["--config", str(path)]
            want = {"image_latents": (1024, 64), "control_latents": (2048, 64),
                    "prompt_embeds": (512, 4096), "pooled_prompt_embeds": (768,),
                    "empty_prompt_embeds": (512, 4096), "empty_pooled_prompt_embeds": (768,),
                    "tgt_ids": (1024, 3), "ctl_ids": (2048, 3), "txt_ids": (512, 3)}
            td2.vlm_factory = _drawn_vlm
            with _KVRecord() as kv:
                trainer, cache_s, cache_peak = _h_cache(card, "dreamomni2", argv, want, 1)
            if not trainer.adapter.use_vlm_prompt_enhancer or kv.calls != 1:
                raise AssertionError(f"the enhancer ran {kv.calls} times in the cache pass")
            _kv_against_full_forward(card, trainer, kv)
            dev = trainer.device
            fresh = tflux.init(torch.Generator(dev).manual_seed(0), trainer.bundle.dit_cfg, dev,
                               trainer.dtype)
            from qflux_tpu_torch.ops.layers import iter_dense_paths

            base = dict(iter_dense_paths(fresh))
            moved = {p for p, node in iter_dense_paths(trainer.bundle.dit_params)
                     if not torch.equal(node.weight, base[p].weight)}
            print(f"[dreamomni2] the edit-LoRA fused at load: {len(moved)} weights moved, "
                  f"{len(base) - len(moved)} equal to a fresh draw; the DiT "
                  f"{H_D2_DEPTH[0]} + {H_D2_DEPTH[1]} blocks [{card}]", flush=True)
            if moved != lora_paths:
                raise AssertionError(f"the fused weights are not the LoRA's: "
                                     f"{sorted(moved ^ lora_paths)[:6]}")
            del trainer, fresh, base
            gc.collect()
            torch.cuda.empty_cache()
            fit, fit_ms, fit_peak = _h_fit(card, "dreamomni2", argv, H_D2_FIT_STEPS,
                                           _rq((0, 0, 0, 0, 0, 0, 0, 0, n, n)))
            pred, pred_s, pred_peak = _h_predict(
                card, "dreamomni2", argv, [tmp / "control_0_0.png", tmp / "control_0_1.png"],
                H_D2_PREDICT_STEPS, _rq((0, 0, 0, 0, 0, 0, 0, 0, n, 0)), HEIGHT)
        print(f"[dreamomni2] summary: cache {cache_s:.2f} s a sample (main() and the prompt's "
              f"{H_NEW_TOKENS}-token rewrite included), fit {fit_ms:.1f} ms a step (bs 1), "
              f"predict {pred_s:.2f} s ({H_D2_PREDICT_STEPS} steps, main() and a rewrite "
              f"included), peaks {cache_peak} / {fit_peak} / {pred_peak} bytes [{card}]",
              flush=True)
        return {"dreamomni2_fit": fit, "dreamomni2_predict": pred}
    finally:
        td2.vlm_factory = real_factory
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase I: the remat policies, the out-of-memory fallback and adamw8bit

# the policies timed at bs=1 and bs=2 ("flash", the config default, runs in
# phases A-H); every policy's bs=1
# gradients are checked against "full"'s
I_POLICIES = ("full", "dots", "dots_all", "flash_qkv", "flash_mlp", "flash_single")
I_GRAD_POLICIES = I_POLICIES + ("flash", "flash_offload")
I_STEPS = 3                        # one warm step, then the timed ones
I_QWEN_POLICIES = ("full", "dots", "flash_mlp")
I_OOM_STEPS = 2
I_ADAM_STEPS = 4
ADAM8BIT = "qflux_tpu.ops.adam8bit.adamw8bit"


def _flux_k1_per_step(policy: str, n_dual: int, n_single: int) -> int:
    """K1 launches a FLUX step: once a block in the forward, again in the
    recompute unless the block keeps K1's out / lse (`remat.names`)."""
    from qflux_tpu_torch.ops import remat

    kept = sum(n for n, kind in ((n_dual, "flux_dual"), (n_single, "flux_single"))
               if remat.FLASH in remat.names(policy, kind))
    return 2 * (n_dual + n_single) - kept


def _qwen_rq_per_step(policy: str, n: int) -> int:
    """K5a launches a Qwen step at S = 4000 (K3's route): the 12 block GEMMs
    and img_in / txt_in / proj_out in the forward, and again in the
    recompute each block GEMM the policy does not keep ("dots" keeps them
    all, "flash_mlp" the two MLP up-projections)."""
    return 12 * n + 3 + {"dots": 0, "dots_all": 0, "flash_mlp": 10 * n}.get(policy, 12 * n)


def _grads_at(dit, lora, batch, noise, sigma, adapter):
    """One microbatch's loss and LoRA gradients (a, b; zeros where the loss
    does not reach) at the given noise and σ."""
    from qflux_tpu_torch.losses import MseLoss
    from qflux_tpu_torch.trainer.train_step import TrainStepConfig, _loss_for_microbatch

    for leaf in lora.values():
        for t in leaf.values():
            t.grad = None
    loss = _loss_for_microbatch(dit, lora, batch, noise, sigma, adapter.predict_velocity,
                                MseLoss(), TrainStepConfig())
    loss.backward()
    grads = {p: torch.cat([torch.zeros_like(leaf[k]).flatten() if leaf[k].grad is None
                           else leaf[k].grad.flatten() for k in ("a", "b")])
             for p, leaf in lora.items()}
    for leaf in lora.values():
        for t in leaf.values():
            t.grad = None
    return loss.item(), grads


def _log_records():
    """A handler on the root logger that keeps the messages of the records
    it sees (WARNING and up)."""
    import logging

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    return Keep()


def phase_remat_flux(card: str) -> dict:
    """Phase I (a), (c), (d) on FLUX.1-Kontext at full width (19 + 38
    blocks, bf16, 512² with one control: S = 2,560).  (a) At bs=1 one
    step's LoRA gradients at a fixed noise and σ under every policy of
    I_GRAD_POLICIES, each equal to "full"'s to the bit; then, at bs=1 and bs=2,
    each policy's own train step (`make_train_step`, AdamW): one warm step
    and I_STEPS - 1 timed ones, ms per step, the peak device memory, and K1
    / K2 launches per step as `_flux_k1_per_step` says.  (c) The process
    capped (`set_per_process_memory_fraction`) between the bs=2 peaks of
    "full" and "dots": `Trainer.fit` under mesh.remat: minimal at bs=2 runs
    out of memory in its first step, warns, degrades to "full" and finishes
    its steps; the cap is lifted after.  (d) `Trainer.fit` with
    optimizer.class_path qflux_tpu.ops.adam8bit.adamw8bit, I_ADAM_STEPS
    steps at bs=1: finite losses that move, the moments' bytes beside
    AdamW's after one step on the same gradients, and one more update on
    the card against the same update on the CPU from the same state and
    gradients (codes, scales and parameters to the bit).  Returns each
    path's (K1, K2) launches."""
    import logging

    from qflux_tpu_torch.losses import MseLoss
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.ops.adam8bit import AdamW8bit
    from qflux_tpu_torch.ops.layers import mark_trainable
    from qflux_tpu_torch.trainer.base import Trainer, train_config
    from qflux_tpu_torch.trainer.train_step import (TrainStepConfig, _loss_for_microbatch,
                                                    lora_leaves, make_train_step)
    from qflux_tpu_torch.utils.checkpoint import lora_stacks

    tt = Trainer(train_config(variant="full"), device="cuda")
    t0 = time.perf_counter()
    tt.load_model()
    dit, cfg = tt.bundle.dit_params, tt.bundle.dit_cfg
    n_dual, n_single = cfg.num_layers, cfg.num_single_layers
    gh, gw = tt.adapter.latent_grid(HEIGHT, WIDTH)
    s = 512 + 2 * gh * gw
    print(f"[remat] FLUX.1-Kontext {n_dual} + {n_single} blocks, dim {cfg.dim}, bf16, S = {s}, "
          f"built in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    rng = np.random.default_rng(19)
    gen = torch.Generator("cuda").manual_seed(19)
    base = tt.adapter
    launches = {}

    def fresh_lora():
        lora = mark_trainable(tt.build_lora())
        _perturb_b(lora, torch.Generator("cuda").manual_seed(20))
        return lora

    # (a) bs=1 gradients at a fixed noise and σ, every policy against "full"
    batch1 = tt._device_batch(_train_batch(rng, cfg, gh, gw, 1))
    noise = torch.randn(batch1["image_latents"].shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    sigma = torch.full((1,), 0.6, device="cuda", dtype=torch.bfloat16)
    lora = fresh_lora()
    grads = {p: _grads_at(dit, lora, batch1, noise, sigma,
                          dataclasses.replace(base, remat_policy=p)) for p in I_GRAD_POLICIES}
    want_loss, want = grads["full"]
    for policy, (loss, got) in grads.items():
        same = loss == want_loss and all(torch.equal(got[p], want[p]) for p in want)
        print(f"[remat] bs=1 {policy}: loss {loss:.6f}, LoRA gradients equal to full's to the "
              f"bit: {same} [{card}]", flush=True)
        if not same:
            raise AssertionError(f"remat {policy}: bs=1 LoRA gradients differ from full's")
    del lora, grads, want
    torch.cuda.empty_cache()

    # (a) each policy's train step at bs=1 and bs=2
    peaks = {}
    criterion, step_cfg = tt.build_criterion(), tt._build_step_config()
    for b in (1, 2):
        batch = batch1 if b == 1 else tt._device_batch(_train_batch(rng, cfg, gh, gw, b))
        for policy in I_POLICIES:
            adapter = dataclasses.replace(base, remat_policy=policy)
            lora = fresh_lora()
            optimizer, schedule = tt.build_optimizer(lora_leaves(lora)[0])
            step = make_train_step(adapter.predict_velocity, criterion, optimizer, schedule,
                                   step_cfg)
            step_gen = torch.Generator("cuda").manual_seed(21)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            ms = []
            for _ in range(I_STEPS):
                t1 = time.perf_counter()
                loss = float(step(dit, lora, batch, step_gen)["loss"])
                ms.append(1000 * (time.perf_counter() - t1))
            k1, k2 = flash_nr.KERNEL_LAUNCHES, flash_nr.BWD_KERNEL_LAUNCHES
            peak = peaks[b, policy] = torch.cuda.max_memory_allocated()
            want_k1 = _flux_k1_per_step(policy, n_dual, n_single) * I_STEPS
            want_k2 = (n_dual + n_single) * I_STEPS
            print(f"[remat] bs={b} {policy}: ms/step {', '.join(f'{m:.1f}' for m in ms)} "
                  f"(median of the timed {statistics.median(ms[1:]):.1f}), peak mem {peak} "
                  f"bytes ({peak / 2**30:.2f} GiB), K1 {k1 // I_STEPS} / K2 {k2 // I_STEPS} "
                  f"a step, loss {loss:.5f} [{card}]", flush=True)
            if (k1, k2) != (want_k1, want_k2) or not np.isfinite(loss):
                raise AssertionError(f"remat {policy} bs={b}: K1/K2 launched {k1}/{k2} over "
                                     f"{I_STEPS} steps, expected {want_k1}/{want_k2}")
            launches[f"remat_bs{b}_{policy}"] = (k1, k2)
            del lora, optimizer, step
        del batch
    torch.cuda.empty_cache()

    # (c) the out-of-memory fallback under a cap between full's and dots's bs=2 peaks
    total = torch.cuda.get_device_properties(0).total_memory
    cap = (peaks[2, "full"] + peaks[2, "dots"]) // 2
    print(f"[remat] out-of-memory fallback: cap {cap} bytes ({cap / 2**30:.2f} GiB, fraction "
          f"{cap / total:.4f} of {total}) between the bs=2 peaks of full "
          f"({peaks[2, 'full']}) and dots ({peaks[2, 'dots']}) [{card}]", flush=True)
    if not peaks[2, "full"] < cap < peaks[2, "dots"]:
        raise AssertionError("no room for a cap between full's and dots's bs=2 peaks")
    config = train_config(variant="full", max_train_steps=I_OOM_STEPS)
    config.mesh.remat = "minimal"
    oom = Trainer(config, device="cuda")
    oom.adapter, oom.bundle = dataclasses.replace(base, remat_policy="dots"), tt.bundle
    batches = [_train_batch(rng, cfg, gh, gw, 2) for _ in range(I_OOM_STEPS)]
    keep = _log_records()
    logging.getLogger().addHandler(keep)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        _reset_counts()
        _fit_in_tmp(oom, batches)
        k1, k2 = flash_nr.KERNEL_LAUNCHES, flash_nr.BWD_KERNEL_LAUNCHES
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        logging.getLogger().removeHandler(keep)
    warned = [m for m in keep.messages if "ran out of memory under remat policy 'dots'" in m]
    hist = oom.history
    print(f"[remat] fit under mesh.remat: minimal, bs=2, capped: warned {len(warned)} "
          f"({warned[0][:160] if warned else ''}...), policy after {oom.adapter.remat_policy!r}, "
          f"{len(hist)} steps, ms/step {', '.join(f'{1000 * h['step_s']:.1f}' for h in hist)}, "
          f"loss {', '.join(f'{h['loss']:.5f}' for h in hist)}, K1 {k1} / K2 {k2} "
          f"(the failed attempt's forward K1 launches included) [{card}]", flush=True)
    if (len(warned) != 1 or oom.adapter.remat_policy != "full" or len(hist) != I_OOM_STEPS
            or not all(np.isfinite(h["loss"]) for h in hist)):
        raise AssertionError("the out-of-memory fallback did not degrade once and finish")
    launches["remat_oom_fallback"] = (k1, k2)
    del oom, batches
    gc.collect()
    torch.cuda.empty_cache()

    # (d) adamw8bit: Trainer.fit, the state's bytes, one update card vs CPU
    config = train_config(variant="full", max_train_steps=I_ADAM_STEPS)
    config.optimizer.class_path = ADAM8BIT
    at = Trainer(config, device="cuda")
    at.adapter, at.bundle = base, tt.bundle
    batches = [_train_batch(rng, cfg, gh, gw, 1) for _ in range(I_ADAM_STEPS)]
    _reset_counts()
    lora = _fit_in_tmp(at, batches)
    k1, k2 = flash_nr.KERNEL_LAUNCHES, flash_nr.BWD_KERNEL_LAUNCHES
    launches["adam8bit_fit"] = (k1, k2)
    hist, opt = at.history, at.optimizer
    losses = [h["loss"] for h in hist]
    print(f"[adam8bit] fit {len(hist)} steps at bs=1 (remat {base.remat_policy}): ms/step "
          f"{', '.join(f'{1000 * h['step_s']:.1f}' for h in hist)}, loss "
          f"{', '.join(f'{x:.5f}' for x in losses)}, grad_norm "
          f"{', '.join(f'{h['grad_norm']:.4e}' for h in hist)}, K1 {k1} / K2 {k2} [{card}]",
          flush=True)
    want = (_flux_k1_per_step(base.remat_policy, n_dual, n_single) * I_ADAM_STEPS,
            (n_dual + n_single) * I_ADAM_STEPS)
    if (type(opt) is not AdamW8bit or len(hist) != I_ADAM_STEPS
            or not all(np.isfinite(losses)) or len(set(losses)) < 2 or (k1, k2) != want):
        raise AssertionError(f"the adamw8bit fit: {len(hist)} steps, losses {losses}, K1 / K2 "
                             f"{(k1, k2)} (expected {want})")
    params = lora_leaves(lora)[0]
    # one more update: the gradients of one microbatch on the card, then the
    # same update on the card and, from copies of the same state, on the CPU
    batch = at._device_batch(batches[0])
    loss_step = _loss_for_microbatch(dit, lora, batch, noise, sigma, base.predict_velocity,
                                     MseLoss(), TrainStepConfig())
    loss_step.backward()
    cpu_params = [p.detach().cpu().requires_grad_() for p in params]
    for c, p in zip(cpu_params, params):
        c.grad = p.grad.detach().cpu()
    index = {id(p): i for i, p in enumerate(params)}
    cpu_stacks = [[cpu_params[index[id(p)]] for p in st] for st in lora_stacks(lora)]
    cpu_opt = AdamW8bit(cpu_params, lr=opt.param_groups[0]["lr"], stacks=cpu_stacks)
    for st, cst in zip(opt.stacks, cpu_opt.stacks):
        cpu_opt.state[cst[0]] = {k: tuple(t.cpu() for t in v) if isinstance(v, tuple) else v
                                 for k, v in opt.state[st[0]].items()}
    opt.step()
    cpu_opt.step()
    same_params = all(torch.equal(p.detach().cpu(), c.detach()) for p, c in zip(params,
                                                                                cpu_params))
    same_state = all(
        torch.equal(opt.state[st[0]][m][0].view(torch.uint8).cpu(),
                    cpu_opt.state[cst[0]][m][0].view(torch.uint8))
        and torch.equal(opt.state[st[0]][m][1].cpu(), cpu_opt.state[cst[0]][m][1])
        for st, cst in zip(opt.stacks, cpu_opt.stacks) for m in ("m", "v"))
    state8 = opt.state_bytes()
    adamw = torch.optim.AdamW([p.detach().clone().requires_grad_() for p in params], lr=1e-4)
    for q, p in zip(adamw.param_groups[0]["params"], params):
        q.grad = p.grad.detach().clone()
    adamw.step()
    state32 = sum(t.numel() * t.element_size() for st in adamw.state.values()
                  for t in st.values() if torch.is_tensor(t) and t.dim() > 0)
    n_params = sum(p.numel() for p in params)
    print(f"[adam8bit] state after {I_ADAM_STEPS + 1} updates: {state8} bytes (fp8 codes + f32 "
          f"scales over {n_params} LoRA elements in {len(opt.stacks)} JAX leaves) against "
          f"AdamW's {state32} bytes ({state32 / state8:.2f}x); one more update on the card "
          f"vs the same on the CPU (tolerance: to the bit): codes and scales equal "
          f"{same_state}, parameters equal {same_params} [{card}]", flush=True)
    if not (same_state and same_params):
        raise AssertionError("adamw8bit: the card's update differs from the CPU's")
    del at, lora, batches, batch, loss_step, adamw, cpu_opt, cpu_params, tt, dit
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_remat_qwen(card: str) -> dict:
    """Phase I (b): the 20B Qwen-Image-Edit DiT over int4_requant cut to
    CUT_BLOCKS blocks (configs/example_qwen_single_chip_832x576.yaml, S =
    4,000: the norm + rope, then K3 / K4), bs=1: one step's LoRA gradients
    at a fixed noise and σ under each of I_QWEN_POLICIES, equal to "full"'s
    to the bit, with K3 / K4, K5a (`_qwen_rq_per_step`), K5b and the row
    quantization launched per step as counted, and each step's time and
    peak memory.  Returns each policy's launches (_launch_counts' order)."""
    qwen, load_s = _qwen_cut(QWEN_832X576)
    dit, cfg = qwen.bundle.dit_params, qwen.bundle.dit_cfg
    n = cfg.num_layers
    gh, gw = qwen.adapter.latent_grid(QWEN_HEIGHT, QWEN_WIDTH)
    rng = np.random.default_rng(22)
    gen = torch.Generator("cuda").manual_seed(22)
    batch = qwen._device_batch(_qwen_train_batch(rng, cfg, gh, gw, 1))
    noise = torch.randn(batch["image_latents"].shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    sigma = torch.full((1,), 0.6, device="cuda", dtype=torch.bfloat16)
    lora = qwen.build_lora()
    _perturb_b(lora, gen)
    from qflux_tpu_torch.ops.layers import mark_trainable

    lora = mark_trainable(lora)
    print(f"[remat_qwen] Qwen-Image-Edit {n} of 60 blocks over int4_requant, S = "
          f"{QWEN_TXT + 2 * gh * gw}, built in {load_s:.1f} s [{card}]", flush=True)
    runs, launches = {}, {}
    for policy in I_QWEN_POLICIES:
        adapter = dataclasses.replace(qwen.adapter, remat_policy=policy)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        runs[policy] = _grads_at(dit, lora, batch, noise, sigma, adapter)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = launches[f"remat_qwen_{policy}"] = _launch_counts()
        want = _rq((0, 0, _qwen_rq_per_step(policy, n), 6 + 12 * (n - 2) + 9 + 1, 0, 0, 0, 0,
                    2 * n - (0 if policy in ("full", "dots") else n), n))
        print(f"[remat_qwen] bs=1 {policy}: loss {runs[policy][0]:.5f}, forward + backward "
              f"{secs:.3f} s, peak mem {torch.cuda.max_memory_allocated()} bytes, "
              f"{COUNT_NAMES} launches {got} [{card}]", flush=True)
        if got != want:
            raise AssertionError(f"remat_qwen {policy}: {COUNT_NAMES} launched {got}, "
                                 f"expected {want}")
    want_loss, want = runs["full"]
    for policy, (loss, got) in runs.items():
        same = loss == want_loss and all(torch.equal(got[p], want[p]) for p in want)
        print(f"[remat_qwen] {policy}: LoRA gradients equal to full's to the bit: {same} "
              f"[{card}]", flush=True)
        if not same:
            raise AssertionError(f"remat_qwen {policy}: LoRA gradients differ from full's")
    del qwen, dit, lora, batch, runs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def remat_main() -> int:
    """`python3 chip_smoke.py --remat`: phase I alone (its kernels built
    first), for iterating on it; the smoke runs it after phase H."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from qflux_tpu_torch.runtime.build import load_library

    smi = _nvidia_smi()
    print(smi, flush=True)
    card = ", ".join(x.strip() for x in smi.split(",", 1))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    load_library()
    t0 = time.perf_counter()
    phase_remat_flux(card)
    with _PathShapes() as rec:
        phase_remat_qwen(card)
    print(f"[smoke] phase I: {time.perf_counter() - t0:.1f} s; shapes checked "
          f"{phase_path_shapes(card, rec, 'phase I')} [{card}]", flush=True)
    return 0


J_UPDATES = 5                      # optimizer updates on the card against the CPU
J_FIT_STEPS = 3                    # fit steps under each of J_FIT_OPTIMIZERS
J_CKPT_STEPS = 4                   # the checkpointing fits' steps, a checkpoint every 2
J_OPTIMIZERS = [("optax.adamw", {}), ("optax.adamw", {"nesterov": True, "eps_root": 1e-8,
                                                      "mu_dtype": "bfloat16"}),
                ("optax.adam", {}), ("optax.lion", {}),
                ("optax.sgd", {"momentum": 0.9, "nesterov": True}),
                ("optax.contrib.prodigy", {})]
# class path → (learning rate, init_args) of the phase J(b) fits: Prodigy at
# its own lr 1.0 (the lr it scales by its estimate), Lion at the lr its
# sign update wants
J_FIT_OPTIMIZERS = {"optax.contrib.prodigy": (1.0, {}), "optax.lion": (1e-5, {})}
OPTIM_REL_TOL = 1e-5               # Prodigy's card vs CPU: its two f32 sums' order


def _rel_max(got, want) -> float:
    """The largest relative L2 error over pairs of tensors (on any device)."""
    out = 0.0
    for g, w in zip(got, want):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        out = max(out, ((g - w).norm() / w.norm().clamp_min(1e-30)).item())
    return out


def _optim_state(opt, params) -> list:
    """The optimizer's state tensors over `params` in a fixed order, and
    Prodigy's tree-wide scalars."""
    group = opt.param_groups[0]
    out = [t for p in params for _, t in sorted(opt.state[p].items())
           if torch.is_tensor(t) and t.dim()]
    return out + [group[k] for k in ("estim_lr", "numerator_weighted") if k in group]


def phase_optim_updates(card: str, lora) -> None:
    """Phase J (a): every optimizer of J_OPTIMIZERS over the full-width
    FLUX.1-Kontext LoRA (the adapter's to_q / to_k / to_v / to_out at rank
    16 in all 57 blocks, and its scaling leaves, which Prodigy holds),
    J_UPDATES updates on the card and on the CPU from the same tensors and
    the same seeded gradients (a drift shared by the updates plus noise,
    the scaling leaves' included): the largest relative error of the
    parameters and of the state, each elementwise optimizer's equal to the
    bit, Prodigy's within OPTIM_REL_TOL, and the card's ms per update
    (CUDA events, the median of the updates after the first)."""
    from qflux_tpu_torch.trainer import optimizers
    from qflux_tpu_torch.trainer.train_step import lora_leaves

    params, scalings = lora_leaves(lora)
    n = sum(p.numel() for p in params)
    gen = torch.Generator("cuda").manual_seed(31)
    drift = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-3 for p in params + scalings]
    grads = [[d * (1 + torch.randn(d.shape, generator=gen, device="cuda")) for d in drift]
             for _ in range(J_UPDATES)]
    for class_path, args in J_OPTIMIZERS:
        lr = 1.0 if class_path == "optax.contrib.prodigy" else 1e-4
        runs, ms = {}, []
        for device in ("cuda", "cpu"):
            ps = [p.detach().to(device).clone().requires_grad_() for p in params]
            ss = [s.detach().to(device).clone().requires_grad_() for s in scalings]
            opt = optimizers.build(class_path, ps, lr, args, frozen=ss)
            for g in grads:
                for t, gt in zip(ps + ss, g):
                    t.grad = gt.to(device)
                if device == "cuda":
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    start.record()
                    opt.step()
                    end.record()
                    end.synchronize()
                    ms.append(start.elapsed_time(end))
                else:
                    opt.step()
            runs[device] = (ps + ss, _optim_state(opt, ps + ss))
        err_p = _rel_max(runs["cuda"][0], runs["cpu"][0])
        err_s = _rel_max(runs["cuda"][1], runs["cpu"][1])
        exact = all(torch.equal(a.detach().cpu(), b.detach())
                    for a, b in zip(runs["cuda"][0] + runs["cuda"][1],
                                    runs["cpu"][0] + runs["cpu"][1]))
        prodigy = class_path == "optax.contrib.prodigy"
        print(f"[optim] {class_path} {args}: {J_UPDATES} updates of {n} LoRA elements in "
              f"{len(params)} tensors (+ {len(scalings)} scalings{' held' if prodigy else ''}) "
              f"on the card against the CPU: largest relative error parameters {err_p:.3e}, "
              f"state {err_s:.3e}, equal to the bit {exact} (tolerance: "
              f"{OPTIM_REL_TOL if prodigy else 'to the bit'}); ms per update on the card "
              f"{', '.join(f'{m:.3f}' for m in ms)} (median after the first "
              f"{statistics.median(ms[1:]):.3f}) [{card}]", flush=True)
        if not (max(err_p, err_s) <= OPTIM_REL_TOL if prodigy else exact):
            raise AssertionError(f"{class_path} {args}: the card's updates differ from the CPU's")
        del runs, opt
    del grads, drift
    gc.collect()
    torch.cuda.empty_cache()


def _files(run: Path, names) -> dict:
    return {f"{d}/{f.name}": f.read_bytes() for d in names for f in sorted((run / d).iterdir())}


def phase_optim(card: str) -> dict:
    """Phase J on FLUX.1-Kontext-dev at full width (19 + 38 blocks, bf16,
    512² with one control, S = 2,560, the adapter's default remat), from
    seeded weights: (a) `phase_optim_updates`; (b) `Trainer.fit` for
    J_FIT_STEPS bs=1 steps under optax.contrib.prodigy and under optax.lion
    (J_FIT_OPTIMIZERS): finite losses, a LoRA that moved, K1 / K2 a step as
    `_flux_k1_per_step` says; (c) a J_CKPT_STEPS-step fit with
    train.checkpointing_steps 2, synchronous and then with
    train.async_checkpointing: the three checkpoints' files equal byte for
    byte, the train thread's ms blocked in each save, and a run resumed
    from the async checkpoint-2 whose steps 3–4 end with the uninterrupted
    run's LoRA and losses to the bit.  Returns each path's (K1, K2)
    launches."""
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.ops.layers import mark_trainable
    from qflux_tpu_torch.trainer.base import Trainer, train_config

    tt = Trainer(train_config(variant="full"), device="cuda")
    t0 = time.perf_counter()
    tt.load_model()
    dit, cfg = tt.bundle.dit_params, tt.bundle.dit_cfg
    n_dual, n_single = cfg.num_layers, cfg.num_single_layers
    gh, gw = tt.adapter.latent_grid(HEIGHT, WIDTH)
    print(f"[optim] FLUX.1-Kontext {n_dual} + {n_single} blocks, bf16, S = "
          f"{512 + 2 * gh * gw}, remat {tt.adapter.remat_policy}, built in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    lora0 = mark_trainable(tt.build_lora())
    _perturb_b(lora0, torch.Generator("cuda").manual_seed(32))
    t0 = time.perf_counter()
    phase_optim_updates(card, lora0)
    print(f"[optim] (a) {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    del lora0
    rng = np.random.default_rng(33)
    per_step = (_flux_k1_per_step(tt.adapter.remat_policy, n_dual, n_single), n_dual + n_single)
    launches = {}

    def trainer(steps, **train):
        config = train_config(variant="full", max_train_steps=steps)
        for k, v in train.items():
            setattr(config.train, k, v)
        tr = Trainer(config, device="cuda")
        tr.adapter, tr.bundle = tt.adapter, tt.bundle
        return tr

    # (b) fits under Prodigy and Lion
    t0 = time.perf_counter()
    batches = [_train_batch(rng, cfg, gh, gw, 1) for _ in range(J_FIT_STEPS)]
    for class_path, (lr, args) in J_FIT_OPTIMIZERS.items():
        tr = trainer(J_FIT_STEPS)
        tr.config.optimizer.class_path, tr.config.optimizer.init_args = class_path, args
        tr.config.optimizer.learning_rate = lr
        start = {p: {k: leaf[k].detach().clone() for k in ("a", "b")}
                 for p, leaf in tr.build_lora().items()}
        _reset_counts()
        lora = _fit_in_tmp(tr, batches)
        got = (flash_nr.KERNEL_LAUNCHES, flash_nr.BWD_KERNEL_LAUNCHES)
        launches[f"optim_fit_{class_path.rsplit('.', 1)[1]}"] = got
        hist = tr.history
        moved = sum(not torch.equal(lora[p][k], start[p][k]) for p in lora for k in ("a", "b"))
        extra = (f", estim_lr {float(tr.optimizer.param_groups[0]['estim_lr']):.4e}"
                 if "estim_lr" in tr.optimizer.param_groups[0] else "")
        print(f"[optim] fit under {class_path} (lr {lr}): {len(hist)} bs=1 steps, ms/step "
              f"{', '.join(f'{1000 * h['step_s']:.1f}' for h in hist)}, loss "
              f"{', '.join(f'{h['loss']:.5f}' for h in hist)}{extra}, LoRA tensors moved "
              f"{moved} of {2 * len(lora)}, K1 {got[0] // J_FIT_STEPS} / K2 "
              f"{got[1] // J_FIT_STEPS} a step [{card}]", flush=True)
        want = tuple(c * J_FIT_STEPS for c in per_step)
        if (len(hist) != J_FIT_STEPS or not all(np.isfinite(h["loss"]) for h in hist)
                or moved != 2 * len(lora) or got != want):
            raise AssertionError(f"fit under {class_path}: {len(hist)} steps, moved {moved}, "
                                 f"K1 / K2 {got} (expected {want})")
        del tr, lora, start
        gc.collect()
        torch.cuda.empty_cache()

    print(f"[optim] (b) {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    # (c) checkpoints, synchronous and async
    t0 = time.perf_counter()
    batches = [_train_batch(rng, cfg, gh, gw, 1) for _ in range(J_CKPT_STEPS)]
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_ckpt_"))
    names = ["checkpoint-2", "checkpoint-4", f"checkpoint-last-{J_CKPT_STEPS}"]
    try:
        runs = {}
        for mode, flag in (("sync", False), ("async", True)):
            tr = trainer(J_CKPT_STEPS, checkpointing_steps=2, async_checkpointing=flag)
            tr.config.logging.output_dir = str(tmp / mode)
            _reset_counts()
            tr.fit(batches)
            launches[f"checkpoint_{mode}"] = (flash_nr.KERNEL_LAUNCHES,
                                              flash_nr.BWD_KERNEL_LAUNCHES)
            runs[mode] = tr
            sizes = sum(len(v) for v in _files(tr.output_dir, names[:1]).values())
            print(f"[optim] {mode} checkpoints: {len(tr.history)} steps, ms/step "
                  f"{', '.join(f'{1000 * h['step_s']:.1f}' for h in tr.history)}, train thread "
                  f"blocked per save {', '.join(f'{1000 * s:.1f}' for s in tr.save_blocked_s)} "
                  f"ms ({sizes} bytes a checkpoint) [{card}]", flush=True)
        sync, run = runs["sync"], runs["async"]
        a, b = _files(sync.output_dir, names), _files(run.output_dir, names)
        same = sorted(a) == sorted(b) and all(a[k] == b[k] for k in a)
        print(f"[optim] the async checkpoints' {len(b)} files equal the synchronous ones' byte "
              f"for byte: {same} [{card}]", flush=True)
        if not same:
            raise AssertionError("async checkpoint files differ from the synchronous ones")
        tr = trainer(J_CKPT_STEPS, async_checkpointing=True, checkpointing_steps=2)
        tr.config.logging.output_dir = str(tmp / "resumed")
        tr.config.resume = str(run.output_dir / "checkpoint-2")
        _reset_counts()
        lora = tr.fit(batches[2:])
        launches["checkpoint_resume"] = (flash_nr.KERNEL_LAUNCHES, flash_nr.BWD_KERNEL_LAUNCHES)
        equal = ([h["loss"] for h in tr.history] == [h["loss"] for h in sync.history[2:]]
                 and all(torch.equal(lora[p][k], sync.lora[p][k])
                         for p in lora for k in ("a", "b")))
        print(f"[optim] resumed from the async checkpoint-2: steps "
              f"{[h['step'] for h in tr.history]}, losses and LoRA equal to the uninterrupted "
              f"run's to the bit: {equal} [{card}]", flush=True)
        if not equal or [h["step"] for h in tr.history] != [3, 4]:
            raise AssertionError("the resume from the async checkpoint differs")
        for key, (k1, k2) in launches.items():
            steps = {"checkpoint_resume": 2}.get(key, J_CKPT_STEPS if "checkpoint" in key
                                                 else J_FIT_STEPS)
            if (k1, k2) != tuple(c * steps for c in per_step):
                raise AssertionError(f"{key}: K1 / K2 {(k1, k2)} over {steps} steps")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[optim] (c) {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    del tt, dit, runs, sync, run, tr, lora
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def optim_main() -> int:
    """`python3 chip_smoke.py --optim`: phase J alone (its kernels built
    first), for iterating on it; the smoke runs it after phase I."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from qflux_tpu_torch.runtime.build import load_library

    smi = _nvidia_smi()
    print(smi, flush=True)
    card = ", ".join(x.strip() for x in smi.split(",", 1))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    load_library()
    t0 = time.perf_counter()
    phase_optim(card)
    print(f"[smoke] phase J: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase K: attention in f32 (the 3xTF32 forwards of csrc/flash_f32_fwd.cu and
# backwards of csrc/flash_f32_bwd.cu, with int8 wgmma scores in the s_int8
# modes), in bf16 at head dims 32 / 64 (the narrow mode of the
# wgmma K3 / K4), at a head dim no kernel takes (zero-padded), and the
# first-party tokenizers

K_F32_CASES = [  # name, B, S, H, D, ids: K3 / K4 in f32; the first is the table's
    ("qwen_832x576_f32", 1, 4000, 24, 128, "text_pad"),
    ("hop_d64_f32", 1, 2000, 48, 64, "hop"),
    ("ragged_d32_f32", 2, 777, 8, 32, None)]
K_NARROW_CASES = [  # bf16 at D = 64 / 32 (the wgmma K3 / K4); the first is the table's
    ("s4000_d64_bf16", 1, 4000, 48, 64, "text_pad"),
    ("hop_d32_bf16", 1, 2000, 8, 32, "hop")]
K_NR_CASES = [2560, 2304]  # K1 / K2 in f32: FLUX 512² (the table's) and path A's S
K_PAD_CASE = ("pad_d96", 1, 1000, 8, 96, "text_pad")  # a head dim no kernel takes
K_INT8_S = 2304            # the f32 s_int8 mode (forward tiles 256 rows, backward 128)
K_INT8_CASES = [K_INT8_S, 2560]  # it alone: path A's S (the table's), the FLUX fit's S
K_DEPTH = (4, 8)           # the f32 FLUX.1-Kontext fit: 57 f32 blocks hold ~48 GB
K_FIT_STEPS = 3            # its fit steps, then K_INT8_STEPS with int8 attention
K_INT8_STEPS = 2
K_FLUX_GRAD_TOL = 1e-3     # its LoRA gradients, kernels vs the plain route (relative L2):
                           # F32_GRAD_TOL per call, carried through 12 blocks
K_VARIANT_STEPS = 2        # variant `test`'s fit and predict steps


def _sdpa_ms(q, k, v, do=None) -> float:
    """One PyTorch call for the same attention on already normed and roped
    [B, S, H, D] inputs of any dtype: scaled_dot_product_attention on the
    backend PyTorch picks (its flash backend takes no f32), its backward
    with `do`.  Unmasked; a yardstick only: the port never calls it."""
    import torch.nn.functional as F

    q, k, vv = (t.transpose(1, 2) for t in (q, k, v))
    if do is None:
        with torch.no_grad():
            return _median_ms(lambda: F.scaled_dot_product_attention(q, k, vv), n=3)
    q, k, vv = (t.detach().requires_grad_() for t in (q, k, vv))
    out = F.scaled_dot_product_attention(q, k, vv)
    g = do.transpose(1, 2)
    return _median_ms(lambda: torch.autograd.grad(out, (q, k, vv), g, retain_graph=True), n=3)


def _f32_bound(q, k, q_seg, kv_seg, bwd=False, nr=False, int8=False) -> dict:
    """The least time the card could take for an f32 mode's work, whatever
    design runs it, from the pairs that attend: the products, K3 4·D·H
    operations a pair (QK^T and PV) and K4 10·D·H (five products), as
    f32-accurate products on the tensor cores (PEAK_F32_SPLIT_PER_MS: three
    TF32 products a product); the s_int8 mode's 2·D·H score operations a
    pair at the int8 tensor-core rate instead; the exponentials, one an
    attending pair either way, at the SFU's PEAK_EXP_PER_MS; the bytes, each
    input read once and each output written once (q, k, v, out, lse; the
    backward also do, dq, dk, dv; the fused modes also cos / sin).  The
    larger of the three; "operations" when the products or the exponentials
    bound it.  (The CUDA cores' 67 TFLOP/s of FFMA, and the __dp4a rate for
    the s_int8 scores, would give one design's floor, not the card's.)"""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    pairs = _attending_pairs(q, k, q_seg, kv_seg)
    n_bytes = (((4 * sq + 4 * sk) if bwd else (2 * sq + 2 * sk)) * b * h * d * q.element_size()
               + b * h * sq * 4 + (2 * sq * d * 4 if nr else 0))
    total = (10 if bwd else 4) * d * h * pairs
    scores = 2 * d * h * pairs if int8 else 0
    t_mma = scores / PEAK_INT8_PER_MS + (total - scores) / PEAK_F32_SPLIT_PER_MS
    t_exp = h * pairs / PEAK_EXP_PER_MS
    t_ops, t_bytes = max(t_mma, t_exp), n_bytes / PEAK_BYTES_PER_MS
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "tensor_core_ms": t_mma, "exp_ms": t_exp}


def _sdpa_kernels(q, k, v, do=None) -> str:
    """Which backend one `_sdpa_ms` forward call takes (its backward with
    `do`): PyTorch's own choice (`torch._fused_sdp_choice`) and the names of
    the CUDA kernels the call launched under torch.profiler (which, late in
    a long process, can record the launches and not the kernels)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    from torch.profiler import ProfilerActivity, profile

    q, k, vv = (t.transpose(1, 2) for t in (q, k, v))
    choice = SDPBackend(torch._fused_sdp_choice(q, k, vv)).name
    if do is not None:
        q, k, vv = (t.detach().requires_grad_() for t in (q, k, vv))
        out = F.scaled_dot_product_attention(q, k, vv)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, (q, k, vv), do.transpose(1, 2))
            torch.cuda.synchronize()
        names = [e.key[:60] for e in prof.key_averages()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
        return f"backend {choice}; backward kernels: {', '.join(names) or 'none recorded'}"
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, vv)
        torch.cuda.synchronize()
    names = [e.key[:60] for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return f"backend {choice}; kernels: {', '.join(names) or 'none recorded'}"


def _narrow_bound(q, k, q_seg, kv_seg, bwd=False) -> dict:
    """The narrow mode's (bf16 at D = 32 / 64, the wgmma K3 / K4) least time:
    the larger of the bytes (`_f32_bound`'s count), the tensor cores' time
    for the function's products (4·D·H operations an attending pair forward,
    10·D·H backward, at the bf16 peak) and the SFU's time for its
    exponentials (one an attending pair, forward and backward: the function
    needs p once; the kernels' recomputing it in both backward loops is the
    design's cost, not the function's) at PEAK_EXP_PER_MS; "operations" when
    either of the last two is the larger.  The exponentials bound only the
    forward at D = 32 (1.85x the products); elsewhere the tensor cores do
    (the exponentials 0.92x the products in the forward at D = 64, 0.37x /
    0.74x in the backward at 64 / 32)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    pairs = _attending_pairs(q, k, q_seg, kv_seg)
    n_bytes = ((4 * sq + 4 * sk) if bwd else (2 * sq + 2 * sk)) * b * h * d * 2 + b * h * sq * 4
    t_mma = (10 if bwd else 4) * d * h * pairs / PEAK_BF16_PER_MS
    t_exp = h * pairs / PEAK_EXP_PER_MS
    t_ops, t_bytes = max(t_mma, t_exp), n_bytes / PEAK_BYTES_PER_MS
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "tensor_core_ms": t_mma, "exp_ms": t_exp}


def _k_entry(ms, plain_ms, lib_ms, max_abs_err, bound, **extra) -> dict:
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            **bound, **extra}


def _k_flash_case(card, gen, name, b, s, h, d, ids, dtype) -> tuple[dict, dict]:
    """K3 then K4 in the f32 mode (the 3xTF32 loops of csrc/flash_f32_fwd.cu
    and csrc/flash_f32_bwd.cu) or the narrow mode (bf16 at D = 32 / 64: the
    wgmma kernels) at one shape: against their plain
    versions (`_fwd_agrees` / `_grad_agrees`: f32 within F32_REL_TOL /
    F32_GRAD_TOL, bf16 within the bf16 kernels' bounds), two calls identical
    to the bit, each timed alone (the C call on checked arguments, back to
    back; narrow: into preallocated outputs, `_k3_alone` / `_k4_alone`, as
    the bf16 K3 / K4 at D = 128) beside the plain version, SDPA (unmasked;
    in f32 the kernels it ran, `_sdpa_kernels`) and the bound (`_f32_bound`,
    narrow `_narrow_bound`).  Returns their table entries."""
    from qflux_tpu_torch.ops import flash_attention as fa
    from qflux_tpu_torch.runtime.build import load_library

    f32 = dtype == torch.float32
    q, k, v, q_seg, kv_seg = _flash_case(gen, b, s, ids, h, d, dtype)
    scale = d ** -0.5
    _, _, _, _, qs32, ks32 = fa._kernel_args(q, k, v, q_seg, kv_seg)
    kl, stream = load_library(), torch.cuda.current_stream().cuda_stream
    out, lse = fa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
    out2, lse2 = fa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
    torch.cuda.synchronize()
    same = torch.equal(out, out2) and torch.equal(lse, lse2)
    del out2, lse2
    ref, ref_lse = fa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
    ok, text = _fwd_agrees(out, lse, ref, ref_lse, f32)
    dead = (ref_lse <= -1e29).permute(0, 2, 1).all(-1)
    ok = ok and same and not out[dead].any() and bool((lse[ref_lse <= -1e29] == -1e30).all())
    err = (out.float() - ref.float()).abs().max().item()
    del ref, ref_lse
    tag = "f32" if f32 else "narrow"
    if f32:
        ms = _window_ms(lambda: fa._launch_fwd(kl, stream, q, k, v, qs32, ks32, scale), 3, 3)
    else:
        ms = _k3_alone(q, k, v, q_seg, kv_seg, scale)["ms"]
    plain_ms = _median_ms(lambda: fa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale), n=3)
    lib_ms = _sdpa_ms(q, k, v)
    sdpa_ran = f" ({_sdpa_kernels(q, k, v)})" if f32 else ""
    bound = (_f32_bound if f32 else _narrow_bound)(q, k, q_seg, kv_seg)
    print(f"[{tag}] K3 {name}: {_dt(dtype)} B={b} S={s} H={h} D={d} ids={ids or 'none'}: {text}; "
          f"max_abs_err(out) {err:.3e}; {int(dead.sum())} fully masked rows at 0; two calls "
          f"identical {same}; alone {ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}; {100 * bound['bound_ms'] / ms:.1f}% of it), plain "
          f"{plain_ms:.3f} ms, SDPA (unmasked) {lib_ms:.3f} ms{sdpa_ran} [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"K3 in its {_dt(dtype)} mode disagrees with its plain version "
                             f"(or with itself) at {name}")
    case = f"{name}: B={b} S={s} H={h} D={d}"
    fwd = _k_entry(ms, plain_ms, lib_ms, err, bound, case=case)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
    ok, errs, err, _ = _k4_agrees(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    if f32:
        ms = _window_ms(lambda: fa._launch_bwd(kl, stream, q, k, v, qs32, ks32, out, lse, do,
                                               scale), 3, 3)
    else:
        ms = _k4_alone(q, k, v, q_seg, kv_seg, out, lse, do, scale)["ms"]
    plain_ms = _median_ms(lambda: fa.flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do,
                                                         scale), n=3)
    lib_ms = _sdpa_ms(q, k, v, do)
    sdpa_ran = f" ({_sdpa_kernels(q, k, v, do)})" if f32 else ""
    bound = (_f32_bound if f32 else _narrow_bound)(q, k, q_seg, kv_seg, bwd=True)
    print(f"[{tag}] K4 {name}: {errs} ({_tol_text(f32)}), two calls "
          f"identical; alone {ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
          f"{100 * bound['bound_ms'] / ms:.1f}% of it), plain {plain_ms:.3f} ms, SDPA backward "
          f"(unmasked) {lib_ms:.3f} ms{sdpa_ran} [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"K4 in its {_dt(dtype)} mode disagrees with its plain version "
                             f"(or with itself) at {name}")
    del q, k, v, out, lse, do
    torch.cuda.empty_cache()
    return fwd, _k_entry(ms, plain_ms, lib_ms, err, bound, case=case)


def _k_nr_case(card, gen, s, s_int8) -> tuple[dict, dict]:
    """K1 then K2 in f32 (their s_int8 mode where asked) at the FLUX layout
    (B = 1, H = 24, D = 128, st = 512 with 20 padding text rows; K1 / K2 on
    the 3xTF32 loops of csrc/flash_f32_fwd.cu / flash_f32_bwd.cu, in the
    s_int8 mode with int8 wgmma scores): against
    the plain versions (f32 within F32_REL_TOL / F32_GRAD_TOL; the s_int8
    mode's prep held by `_f32_int8_prep` and the plain versions run on its
    qn / kn, the end-to-end error printed), two calls
    identical to the bit, each timed alone (prep included) beside the plain
    version, SDPA on the plain normed q / k (the kernels it ran) and the
    bound (`_f32_bound`)."""
    from qflux_tpu_torch.ops import flash_nr as fnr
    from qflux_tpu_torch.runtime.build import load_library

    args = _attn_inputs(gen, 1, s, 24, 128, torch.float32)
    q, k, v, qs2, ks2, cos, sin = args
    st, scale = 512, 128 ** -0.5
    seg = torch.ones(1, s, dtype=torch.int32, device="cuda")
    seg[0, 492:512] = 0
    fwd_rows, bwd_rows = fnr.s_int8_tiles(s, 128) if s_int8 else (0, 0)
    label = f"S={s}" + (f" s_int8 (q tiles {fwd_rows} / {bwd_rows})" if s_int8 else "")
    qs, ks, csb, seg32 = fnr._kernel_args(q, k, v, qs2, ks2, cos, sin, seg)
    kl, stream = load_library(), torch.cuda.current_stream().cuda_stream
    normed, prep_ok, prep_text = (_f32_int8_prep(args, st, (fwd_rows, bwd_rows)) if s_int8
                                  else (None, True, ""))
    out, lse = fnr._flash_nr_cuda(*args, st, seg, scale, fwd_rows)
    out2, lse2 = fnr._flash_nr_cuda(*args, st, seg, scale, fwd_rows)
    torch.cuda.synchronize()
    same = torch.equal(out, out2) and torch.equal(lse, lse2)
    del out2, lse2
    if s_int8:  # on the kernel's qn / kn, and end to end for the record
        ref, ref_lse = fnr.flash_attention_nr_int8_reference(*args, st, fwd_rows,
                                                             segment_ids=seg, scale=scale)
        prep_text += f"; end to end rel_err(out) {_rel(out, ref):.3e}; "
        ref, ref_lse = fnr.flash_attention_nr_int8_reference(
            *args, st, fwd_rows, segment_ids=seg, scale=scale, normed=normed)
    else:
        ref, ref_lse = fnr.flash_attention_nr_reference(*args, st, segment_ids=seg, scale=scale)
    ok, text = _fwd_agrees(out, lse, ref, ref_lse, True)
    text = prep_text + text
    ok = ok and same and prep_ok and not out[0, 492:512].any()
    err = (out - ref).abs().max().item()
    del ref, ref_lse
    ms = _window_ms(lambda: fnr._launch_fwd(kl, stream, q, k, v, qs, ks, cos, sin, csb, seg32,
                                            st, scale, fwd_rows), 3, 3)
    if s_int8:
        plain_ms = _median_ms(lambda: fnr.flash_attention_nr_int8_reference(
            *args, st, fwd_rows, segment_ids=seg, scale=scale), n=3)
    else:
        plain_ms = _median_ms(lambda: fnr.flash_attention_nr_reference(
            *args, st, segment_ids=seg, scale=scale), n=3)
    qn = fnr.apply_qk_norm_rope(q, qs2, cos, sin, st)
    kn = fnr.apply_qk_norm_rope(k, ks2, cos, sin, st)
    lib_ms = _sdpa_ms(qn, kn, v)
    bound = _f32_bound(q, k, seg, seg, nr=True, int8=s_int8)
    print(f"[f32] K1 f32 {label}: {text}; max_abs_err(out) "
          f"{err:.3e}; padded rows at 0; two calls identical {same}; alone {ms:.4f} ms (prep "
          f"included), bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
          f"{100 * bound['bound_ms'] / ms:.1f}% of it), plain {plain_ms:.3f} ms, SDPA on the "
          f"plain normed q / k {lib_ms:.3f} ms ({_sdpa_kernels(qn, kn, v)}) [{card}]",
          flush=True)
    if not ok:
        raise AssertionError(f"K1 in f32 disagrees with its plain version at {label}")
    case = f"B=1 S={s} H=24 D=128, st=512, 20 padding text rows, {label}"
    # no PyTorch call computes attention over int8 scores: SDPA's f32 time is for scale
    lib = {"library_ms": None, "sdpa_f32_ms": lib_ms} if s_int8 else {}
    fwd = {**_k_entry(ms, plain_ms, lib_ms, err, bound, case=case), **lib}
    do = torch.randn(q.shape, device="cuda", generator=gen)
    got = fnr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do, bwd_rows)
    again = fnr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do, bwd_rows)
    torch.cuda.synchronize()
    ok = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    if s_int8:
        ref = fnr.flash_attention_nr_int8_bwd_reference(*args, st, do, out, lse, bwd_rows,
                                                        segment_ids=seg, scale=scale,
                                                        normed=normed)
    else:
        ref = fnr.flash_attention_nr_bwd_reference(*args, st, do, segment_ids=seg, scale=scale)
    errs, err = [], 0.0
    for gname, g, r in zip(("dq", "dk", "dv", "dqs", "dks"), got, ref):
        g_ok, t = _grad_agrees(g, r, True)
        ok = ok and g_ok
        err = max(err, (g - r).abs().max().item())
        errs.append(f"{gname} {t}")
    del got, ref
    ms = _window_ms(lambda: fnr._launch_bwd(kl, stream, q, k, v, qs, ks, cos, sin, csb, seg32,
                                            st, scale, out, lse, do, bwd_rows), 3, 3)
    if s_int8:
        plain_ms = _median_ms(lambda: fnr.flash_attention_nr_int8_bwd_reference(
            *args, st, do, out, lse, bwd_rows, segment_ids=seg, scale=scale), n=3)
    else:
        plain_ms = _median_ms(lambda: fnr.flash_attention_nr_bwd_reference(
            *args, st, do, segment_ids=seg, scale=scale), n=3)
    lib_ms = _sdpa_ms(qn, kn, v, do)
    sdpa_ran = "" if s_int8 else f" ({_sdpa_kernels(qn, kn, v, do)})"
    bound = _f32_bound(q, k, seg, seg, bwd=True, nr=True, int8=s_int8)
    print(f"[f32] K2 f32 {label}: {'; '.join(errs)} "
          f"({_tol_text(True)}), two calls identical; "
          f"alone {ms:.4f} ms (prep and rope + norm backward included), bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
          f"{100 * bound['bound_ms'] / ms:.1f}% of it), plain {plain_ms:.3f} ms, SDPA backward "
          f"on the plain normed q / k {lib_ms:.3f} ms{sdpa_ran} [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"K2 in f32 disagrees with its plain version (or with itself) at "
                             f"{label}")
    del args, q, k, v, out, lse, do, qn, kn
    torch.cuda.empty_cache()
    lib = {"library_ms": None, "sdpa_f32_ms": lib_ms} if s_int8 else {}
    return fwd, {**_k_entry(ms, plain_ms, lib_ms, err, bound, case=case), **lib}


def _k_pad_case(card, gen) -> None:
    """The head-dim repair at K_PAD_CASE: attention at D = 96, which no kernel
    takes, through the CUDA launchers (zero-padded to 128, the caller's
    scale), in f32 and in bf16: K3 and K4 against their plain versions at D
    = 96 (`_fwd_agrees`, `_k4_agrees`: f32 within F32_REL_TOL /
    F32_GRAD_TOL, bf16 within the bf16 kernels' bounds; K4's two calls
    identical)."""
    from qflux_tpu_torch.ops import flash_attention as fa

    name, b, s, h, d, ids = K_PAD_CASE
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        q, k, v, q_seg, kv_seg = _flash_case(gen, b, s, ids, h, d, dtype)
        scale = d ** -0.5
        out, lse = fa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
        ref, ref_lse = fa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
        ok, text = _fwd_agrees(out, lse, ref, ref_lse, f32)
        do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        g_ok, errs, _, _ = _k4_agrees(q, k, v, q_seg, kv_seg, out, lse, do, scale)
        print(f"[pad] K3 / K4 {name}: {_dt(dtype)} B={b} S={s} H={h} D={d} ids={ids}, run at "
              f"D={fa.run_head_dim(d)} zero-padded: K3 {text}; K4 {errs} ({_tol_text(f32)}) "
              f"[{card}]", flush=True)
        if not (ok and g_ok):
            raise AssertionError(f"K3 / K4 at head dim {d} in {_dt(dtype)} disagree with their "
                                 f"plain versions")
        del q, k, v, out, lse, ref, ref_lse, do
        torch.cuda.empty_cache()


def phase_simt_kernels(card: str) -> dict:
    """Phase K(a): every f32 mode (the 3xTF32 forwards and backwards, their
    s_int8 modes with int8 scores) and the narrow mode alone against its
    plain version (`_k_flash_case`, `_k_nr_case`), the s_int8 modes' times
    beside the plain f32 modes' at K_INT8_S, the s_int8 modes also at the
    f32 FLUX fit's S (K_INT8_CASES), and a head dim no kernel takes
    (`_k_pad_case`); returns the table's entries by name."""
    gen = torch.Generator("cuda").manual_seed(41)
    table = {}
    for cases, mode in ((K_F32_CASES, torch.float32), (K_NARROW_CASES, torch.bfloat16)):
        tag = "f32" if mode == torch.float32 else "narrow"
        for i, (name, b, s, h, d, ids) in enumerate(cases):
            fwd, bwd = _k_flash_case(card, gen, name, b, s, h, d, ids, mode)
            if i == 0:
                table[f"flash_fwd {tag}"], table[f"flash_bwd {tag}"] = fwd, bwd
    plain_at = {}
    for i, s in enumerate(K_NR_CASES):
        fwd, bwd = _k_nr_case(card, gen, s, False)
        if i == 0:
            table["flash_nr_fwd f32"], table["flash_nr_bwd f32"] = fwd, bwd
        plain_at[s] = (fwd["ms"], bwd["ms"])
    fwd, bwd = [_k_nr_case(card, gen, s, True) for s in K_INT8_CASES][0]
    table["flash_nr_fwd f32 s_int8"], table["flash_nr_bwd f32 s_int8"] = fwd, bwd
    if K_INT8_S in plain_at:
        (pf, pb), s = plain_at[K_INT8_S], K_INT8_S
        print(f"[f32] at S={s}: K1 f32 s_int8 {fwd['ms']:.4f} ms against K1 f32 {pf:.4f} ms "
              f"({pf / fwd['ms']:.2f}x); K2 f32 s_int8 {bwd['ms']:.4f} ms against K2 f32 "
              f"{pb:.4f} ms ({pb / bwd['ms']:.2f}x) [{card}]", flush=True)
    _k_pad_case(card, gen)
    return table


def _simt_counts() -> dict:
    from qflux_tpu_torch.ops import flash_attention as fa
    from qflux_tpu_torch.ops import flash_nr as fnr

    return {"flash_fwd f32": fa.F32_KERNEL_LAUNCHES, "flash_bwd f32": fa.F32_BWD_KERNEL_LAUNCHES,
            "flash_fwd narrow": fa.NARROW_KERNEL_LAUNCHES,
            "flash_bwd narrow": fa.NARROW_BWD_KERNEL_LAUNCHES,
            "flash_nr_fwd f32": fnr.F32_KERNEL_LAUNCHES,
            "flash_nr_bwd f32": fnr.F32_BWD_KERNEL_LAUNCHES,
            "flash_nr_fwd f32 s_int8": fnr.F32_INT8_KERNEL_LAUNCHES,
            "flash_nr_bwd f32 s_int8": fnr.F32_INT8_BWD_KERNEL_LAUNCHES}


def _reset_simt_counts() -> None:
    from qflux_tpu_torch.ops import flash_attention as fa
    from qflux_tpu_torch.ops import flash_nr as fnr

    for mod, names in ((fa, ("F32_KERNEL_LAUNCHES", "F32_BWD_KERNEL_LAUNCHES",
                             "NARROW_KERNEL_LAUNCHES", "NARROW_BWD_KERNEL_LAUNCHES")),
                       (fnr, ("F32_KERNEL_LAUNCHES", "F32_BWD_KERNEL_LAUNCHES",
                              "F32_INT8_KERNEL_LAUNCHES", "F32_INT8_BWD_KERNEL_LAUNCHES"))):
        for n in names:
            setattr(mod, n, 0)


def _k_fit(card, label, trainer, batches, want_k1, want_k2, k1_name, k2_name) -> dict:
    """Trainer.fit with the f32 and narrow counts set to 0 just before it and
    read just after: finite losses, every LoRA b moved, the kernels launched
    as `want_k1` / `want_k2` a step.  Returns the two launch counts by
    kernel name."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_simt_counts()
    lora = _fit_in_tmp(trainer, batches)
    torch.cuda.synchronize()
    counts = _simt_counts()
    hist = trainer.history
    k1, k2 = counts[k1_name], counts[k2_name]
    ms = ", ".join(f"{1000 * h['step_s']:.1f}" for h in hist)
    med = 1000 * statistics.median(h["step_s"] for h in hist) if hist else float("nan")
    losses = ", ".join(f"{h['loss']:.5f}" for h in hist)
    print(f"[f32] {label}: {len(hist)} steps, ms/step {ms} (median {med:.1f}), loss {losses}, "
          f"peak mem {torch.cuda.max_memory_allocated()} bytes, {k1_name} {k1}, {k2_name} {k2}, "
          f"every mode: {counts} [{card}]", flush=True)
    n = len(hist)
    if n != len(batches) or not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"{label}: {n} steps or non-finite losses")
    if (k1, k2) != (want_k1 * n, want_k2 * n):
        raise AssertionError(f"{label}: {k1_name} / {k2_name} launched {k1} / {k2} times, "
                             f"expected {want_k1} / {want_k2} a step")
    if not all(leaf["b"].abs().sum() > 0 for leaf in lora.values()):
        raise AssertionError(f"{label}: a LoRA b did not move from zero")
    return {k1_name: k1, k2_name: k2}


def phase_f32_flux(card: str) -> dict:
    """Phase K(b): FLUX.1-Kontext-dev at full width, f32 weights
    (train.weight_dtype: float32), cut to K_DEPTH blocks, 512² with one
    control (S = 2,560): one step's LoRA gradients through the f32 K1 / K2
    against the plain route, and through their s_int8 mode against the
    plain int8 route (each within K_FLUX_GRAD_TOL), a K_FIT_STEPS fit through
    them (one K1 and one K2 a block a step under remat "flash"), then
    K_INT8_STEPS with quantize.attention (the f32 s_int8 mode).  Returns
    {path: {kernel name: launches}} of the two fits."""
    from qflux_tpu_torch.losses import MseLoss
    from qflux_tpu_torch.models.flux import transformer as tflux
    from qflux_tpu_torch.ops.layers import mark_trainable
    from qflux_tpu_torch.trainer.base import Trainer, train_config

    with _CutDepth(tflux, "FluxConfig", num_layers=K_DEPTH[0], num_single_layers=K_DEPTH[1]):
        cfg_t = train_config(variant="full", max_train_steps=K_FIT_STEPS)
        cfg_t.train.weight_dtype = "float32"
        trainer = Trainer(cfg_t, device="cuda")
        trainer.load_model()
    dit, cfg = trainer.bundle.dit_params, trainer.bundle.dit_cfg
    n_blocks = cfg.num_layers + cfg.num_single_layers
    b_dit = sum(p.numel() * p.element_size() for p in dit.parameters())
    print(f"[f32] FLUX.1-Kontext-dev dim {cfg.dim}, {cfg.num_layers} dual + "
          f"{cfg.num_single_layers} single blocks, f32: {b_dit} bytes [{card}]", flush=True)
    rng = np.random.default_rng(21)
    gh, gw = trainer.adapter.latent_grid(HEIGHT, WIDTH)
    batch = trainer._device_batch(_train_batch(rng, cfg, gh, gw, 1))
    gen = torch.Generator("cuda").manual_seed(22)
    noise = torch.randn(batch["image_latents"].shape, device="cuda", generator=gen)
    sigma = torch.full((1,), 0.6, device="cuda")
    lora = mark_trainable(trainer.build_lora())
    _perturb_b(lora, gen)
    c0 = _simt_counts()
    _lora_grad_check(card, "[f32] FLUX 4 + 8 blocks", "f32 K1+K2", dit, lora, batch, noise,
                     sigma, trainer.adapter, MseLoss(), (0, 1), n_blocks,
                     ("to_q", "to_k", "to_v", "to_out"), tol=K_FLUX_GRAD_TOL)
    c1 = _simt_counts()
    if (c1["flash_nr_fwd f32"] - c0["flash_nr_fwd f32"],
            c1["flash_nr_bwd f32"] - c0["flash_nr_bwd f32"]) != (n_blocks, n_blocks):
        raise AssertionError("the f32 gradient check did not run the f32 K1 / K2 once a block")
    # the same step with quantize.attention: the f32 s_int8 K1 / K2 against the
    # plain int8 attention
    int8 = dataclasses.replace(trainer.adapter, attn_impl="int8")
    _lora_grad_check(card, "[f32] FLUX 4 + 8 blocks, int8 attention", "f32 K1+K2 s_int8", dit,
                     lora, batch, noise, sigma, int8, MseLoss(), (4, 5), n_blocks,
                     ("to_q", "to_k", "to_v", "to_out"), tol=K_FLUX_GRAD_TOL,
                     plain_impl="int8_plain")
    c2 = _simt_counts()
    if (c2["flash_nr_fwd f32 s_int8"] - c1["flash_nr_fwd f32 s_int8"],
            c2["flash_nr_bwd f32 s_int8"] - c1["flash_nr_bwd f32 s_int8"]) != (n_blocks,
                                                                             n_blocks):
        raise AssertionError("the int8 gradient check did not run the f32 s_int8 K1 / K2 once "
                             "a block")
    del lora, batch, noise
    torch.cuda.empty_cache()
    paths = {}
    batches = [_train_batch(rng, cfg, gh, gw, 1) for _ in range(K_FIT_STEPS)]
    paths["f32_flux_fit"] = _k_fit(card, f"FLUX f32 fit, {n_blocks} blocks", trainer, batches,
                                   n_blocks, n_blocks, "flash_nr_fwd f32", "flash_nr_bwd f32")
    trainer.adapter = int8
    trainer.config.train.max_train_steps = K_INT8_STEPS
    batches = [_train_batch(rng, cfg, gh, gw, 1) for _ in range(K_INT8_STEPS)]
    paths["f32_flux_fit_int8_attention"] = _k_fit(
        card, f"FLUX f32 fit with quantize.attention, {n_blocks} blocks", trainer, batches,
        n_blocks, n_blocks, "flash_nr_fwd f32 s_int8", "flash_nr_bwd f32 s_int8")
    del trainer, dit
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def _variant_test_emb(rng, family) -> tuple[dict, int, int]:
    """Cached embeddings at variant `test`'s widths (as the CPU tests'
    tiny slices): (embeddings, image size, latent tokens)."""
    from qflux_tpu_torch.ops.rope import flux_image_ids, flux_text_ids

    f32 = np.float32
    if family == "flux":
        return ({"control_latents": rng.standard_normal((1, 64, 16)).astype(f32),
                 "prompt_embeds": rng.standard_normal((1, 8, 64)).astype(f32),
                 "pooled_prompt_embeds": rng.standard_normal((1, 32)).astype(f32),
                 "tgt_ids": flux_image_ids(8, 8, 0), "ctl_ids": flux_image_ids(8, 8, 1),
                 "txt_ids": flux_text_ids(8)}, 32, 64)
    return ({"control_latents": rng.standard_normal((1, 16, 16)).astype(f32),
             "prompt_embeds": rng.standard_normal((1, 8, 48)).astype(f32),
             "prompt_embeds_mask": np.array([[1] * 6 + [0] * 2]),
             "img_shapes_arr": np.array([[1, 4, 4], [1, 4, 4]], np.int32)}, 16, 16)


def phase_variant_test(card: str) -> dict:
    """Phase K(c): variant `test` (head dim 32) of FLUX.1-Kontext and
    Qwen-Image-Edit on the card, in bf16 (the narrow mode) and f32: a
    K_VARIANT_STEPS predict from cached embeddings (K3 a whole number of
    times a block, uint8 images) and a K_VARIANT_STEPS fit (K4 once a block
    a step, K3 once or twice under the remat policy, finite losses), each
    with the counts set to 0 just before it.  Returns {path: {kernel name:
    launches}}."""
    from qflux_tpu_torch.trainer.base import Trainer, train_config

    paths = {}
    for trainer_name, family in (("FluxKontextLoraTrainer", "flux"),
                                 ("QwenImageEditTrainer", "qwen")):
        for dtype in ("bfloat16", "float32"):
            tag = "f32" if dtype == "float32" else "narrow"
            rng = np.random.default_rng(31)
            cfg = train_config(variant="test", max_train_steps=K_VARIANT_STEPS)
            cfg.trainer.value = trainer_name
            cfg.train.weight_dtype = dtype
            cfg.predict.num_inference_steps = K_VARIANT_STEPS
            tr = Trainer(cfg, device="cuda")
            tr.load_model()
            dcfg = tr.bundle.dit_cfg
            n_blocks = dcfg.num_layers + getattr(dcfg, "num_single_layers", 0)
            emb, size, n_lat = _variant_test_emb(rng, family)
            tr.lora = tr.build_lora()
            _reset_simt_counts()
            img = tr.predict_from_embeddings(emb, size, size)
            torch.cuda.synchronize()
            k3 = _simt_counts()[f"flash_fwd {tag}"]
            print(f"[variant_test] {family} {dtype} predict ({K_VARIANT_STEPS} steps, head dim "
                  f"{dcfg.attention_head_dim}, {n_blocks} blocks): image {img.shape} "
                  f"{img.dtype}, K3 {tag} {k3} [{card}]", flush=True)
            if img.shape != (1, size, size, 3) or img.dtype != np.uint8 or not k3 or k3 % n_blocks:
                raise AssertionError(f"variant test {family} {dtype} predict: image {img.shape} "
                                     f"{img.dtype}, K3 {k3} launches")
            paths[f"variant_test_{family}_{tag}_predict"] = {f"flash_fwd {tag}": k3}
            emb["image_latents"] = rng.standard_normal((1, n_lat, 16)).astype(np.float32)
            _reset_simt_counts()
            tr.fit([emb] * (K_VARIANT_STEPS + 1))
            torch.cuda.synchronize()
            c = _simt_counts()
            k3, k4 = c[f"flash_fwd {tag}"], c[f"flash_bwd {tag}"]
            hist = tr.history
            losses = ", ".join(f"{h['loss']:.5f}" for h in hist)
            print(f"[variant_test] {family} {dtype} fit: {len(hist)} steps, loss {losses}, K3 "
                  f"{tag} {k3}, K4 {tag} {k4} [{card}]", flush=True)
            want = n_blocks * len(hist)
            if (len(hist) != K_VARIANT_STEPS or not all(np.isfinite(h["loss"]) for h in hist)
                    or k4 != want or k3 not in (want, 2 * want)):
                raise AssertionError(f"variant test {family} {dtype} fit: {len(hist)} steps, "
                                     f"K3 / K4 {k3} / {k4}, expected K4 {want}")
            paths[f"variant_test_{family}_{tag}_fit"] = {f"flash_fwd {tag}": k3,
                                                         f"flash_bwd {tag}": k4}
            del tr
            torch.cuda.empty_cache()
    return paths


def phase_f32(card: str) -> tuple[dict, dict]:
    """Phase K: (a) the f32 modes and the narrow mode alone, (b) the
    f32 FLUX fit, (c) variant `test` on the card, every kernel (b) and (c)
    launched then held to its plain version at their shapes, (d) the
    tokenizers.  Returns the table's entries and the launches by path."""
    t0 = time.perf_counter()
    table = phase_simt_kernels(card)
    print(f"[smoke] phase K(a): {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    with _PathShapes() as rec:
        paths = phase_f32_flux(card)
        paths.update(phase_variant_test(card))
    checked = phase_path_shapes(card, rec, "phase K")
    print(f"[smoke] phase K(b, c) shapes checked {checked} [{card}]", flush=True)
    phase_tokenizers(card)
    return table, paths


def f32_main() -> int:
    """`python3 chip_smoke.py --f32`: phase K alone (its kernels built
    first), for iterating on it; the smoke runs it after phase J."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from qflux_tpu_torch.runtime.build import load_library

    smi = _nvidia_smi()
    print(smi, flush=True)
    card = ", ".join(x.strip() for x in smi.split(",", 1))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    load_library()
    t0 = time.perf_counter()
    table, paths = phase_f32(card)
    print(json.dumps({"phase_k": table, "launches_by_path": paths}), flush=True)
    print(f"[smoke] phase K: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return 0


K_TOKENIZER_PROMPTS = ["turn the sky orange at sunset", "add a red hat to the person", "",
                       "it's a café, ＡＢＣ ﬁne 東京 😀 12345 ①  -- done"]
K_WORDS = ["the", "sky", "orange", "sunset", "add", "red", "hat", "person", "turn", "image"]
K_QWEN3_TEMPLATE = (
    "{%- for message in messages %}{{- '<|im_start|>' + message.role + '\\n' + "
    "message.content + '<|im_end|>\\n' }}{%- endfor %}{%- if add_generation_prompt %}"
    "{{- '<|im_start|>assistant\\n' }}{%- if enable_thinking is defined and enable_thinking "
    "is false %}{{- '<think>\\n\\n</think>\\n\\n' }}{%- endif %}{%- endif %}")
QWEN_SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|vision_start|>",
                 "<|vision_end|>", "<|image_pad|>"]


def _bpe_vocab(words, space: str, suffix: str) -> tuple[dict, list]:
    """A byte-level BPE vocabulary: the 256 byte symbols (and with `suffix`),
    then each word built left to right by merges (`space` + word for
    Qwen's leading-space pieces, the last symbol with `suffix` for CLIP)."""
    from qflux_tpu_torch.models.tokenizers import bytes_to_unicode

    base = sorted(bytes_to_unicode().values())
    vocab = {}
    for sym in base + ([b + suffix for b in base] if suffix else []):
        vocab.setdefault(sym, len(vocab))
    merges = []
    for word in words:
        syms = list(space + word) if space else list(word)
        syms[-1] += suffix
        cur = syms[0]
        for nxt in syms[1:]:
            if (cur, nxt) not in merges:
                merges.append((cur, nxt))
            cur += nxt
            vocab.setdefault(cur, len(vocab))
    return vocab, merges


def write_tokenizer_dirs(root: Path) -> dict:
    """Tokenizer directories written with the standard library alone, in
    the checkpoints' layouts: FLUX's tokenizer/ (CLIP vocab.json +
    merges.txt, tokenizer_config.json) and tokenizer_2/ (a T5 Unigram
    tokenizer.json with a Precompiled charsmap: full-width, ligature and
    compatibility folds), Qwen2.5-VL's tokenizer/ and Klein's Qwen3
    tokenizer/ (byte-level BPE tokenizer.json with the special tokens, the
    latter with a chat template).  Returns {family: checkpoint root}."""
    from qflux_tpu_torch.models.tokenizers import _QWEN2_RE, build_precompiled_charsmap

    flux, qwen, klein = (root / n for n in ("flux", "qwen", "klein"))
    clip_dir = flux / "tokenizer"
    clip_dir.mkdir(parents=True)
    vocab, merges = _bpe_vocab(K_WORDS, "", "</w>")
    for sym in ("<|startoftext|>", "<|endoftext|>"):
        vocab[sym] = len(vocab)
    (clip_dir / "vocab.json").write_text(json.dumps(vocab))
    (clip_dir / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    (clip_dir / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "CLIPTokenizer", "bos_token": "<|startoftext|>",
        "eos_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
        "unk_token": "<|endoftext|>", "model_max_length": 77}))
    t5_dir = flux / "tokenizer_2"
    t5_dir.mkdir()
    charsmap = build_precompiled_charsmap({"Ａ": "A", "Ｂ": "B", "Ｃ": "C", "ﬁ": "fi",
                                           "①": "1", "　": " "})
    pieces = ([["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0], ["▁", -2.0]]
              + [["▁" + w, -4.0 - 0.1 * i] for i, w in enumerate(K_WORDS)]
              + [[c, -8.0] for c in "abcdefghijklmnopqrstuvwxyz0123456789.,'-"])
    extra = [f"<extra_id_{i}>" for i in range(99, -1, -1)]
    pieces += [[t, 0.0] for t in extra]
    specials = ["<pad>", "</s>", "<unk>"] + extra
    (t5_dir / "tokenizer.json").write_text(json.dumps({
        "added_tokens": [{"id": [p for p, _ in pieces].index(t), "content": t, "special": True}
                         for t in specials],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled",
             "precompiled_charsmap": __import__("base64").b64encode(charsmap).decode()},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "WhitespaceSplit"},
            {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
             "split": True}]},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"Sequence": {"id": "A", "type_id": 0}},
                                      {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                           "special_tokens": {"</s>": {"id": "</s>", "ids": [1],
                                                       "tokens": ["</s>"]}}},
        "decoder": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always"},
        "model": {"type": "Unigram", "unk_id": 2, "vocab": pieces, "byte_fallback": False}}))
    (t5_dir / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "T5Tokenizer", "eos_token": "</s>", "pad_token": "<pad>",
        "unk_token": "<unk>", "model_max_length": 512}))
    for ckpt, template in ((qwen, None), (klein, K_QWEN3_TEMPLATE)):
        tok_dir = ckpt / "tokenizer"
        tok_dir.mkdir(parents=True)
        vocab, merges = _bpe_vocab(K_WORDS, "Ġ", "")
        added = QWEN_SPECIALS + ["<think>", "</think>"]
        (tok_dir / "tokenizer.json").write_text(json.dumps({
            "added_tokens": [{"id": len(vocab) + i, "content": t,
                              "special": t in QWEN_SPECIALS, "normalized": False}
                             for i, t in enumerate(added)],
            "normalizer": {"type": "NFC"},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": _QWEN2_RE}, "behavior": "Isolated",
                 "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False, "use_regex": False}]},
            "post_processor": {"type": "ByteLevel"}, "decoder": {"type": "ByteLevel"},
            "model": {"type": "BPE", "vocab": vocab, "merges": [" ".join(m) for m in merges],
                      "unk_token": None}}))
        config = {"tokenizer_class": "Qwen2Tokenizer", "eos_token": "<|im_end|>",
                  "pad_token": "<|endoftext|>", "padding_side": "right"}
        if template:
            config["chat_template"] = template
        (tok_dir / "tokenizer_config.json").write_text(json.dumps(config))
    return {"flux": flux, "qwen": qwen, "klein": klein}


def phase_tokenizers(card: str) -> None:
    """Phase K(d): the first-party tokenizers on the card's machine, which
    has neither transformers nor tokenizers: each family's loader reads a
    directory this smoke writes (`write_tokenizer_dirs`), and the adapters'
    calls tokenize K_TOKENIZER_PROMPTS: FLUX's CLIP at 77 and T5 at 512
    positions, Qwen-Image-Edit's EDIT_TEMPLATE parts, Klein's chat template
    at 512, DreamOmni2's decode.  Prints the load time and the host ms per
    prompt of each; checks shapes, masks and a decode round trip."""
    from qflux_tpu_torch.models.tokenizers import Tokenizer
    from qflux_tpu_torch.trainer import flux2_klein, flux_kontext, qwen_edit

    for mod in ("transformers", "tokenizers"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported by the port")
    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_tokenizers_"))
    try:
        roots = write_tokenizer_dirs(tmp)
        n = len(K_TOKENIZER_PROMPTS)
        t0 = time.perf_counter()
        toks = flux_kontext.load_tokenizers(roots["flux"])
        vl = qwen_edit.load_vl_tokenizer(roots["qwen"])
        q3 = flux2_klein.load_qwen3_tokenizer(roots["klein"])
        load_s = time.perf_counter() - t0
        if not all(isinstance(t, Tokenizer) for t in (*toks.values(), vl, q3)):
            raise AssertionError("a loader fell back to the hash tokenizer")
        t0 = time.perf_counter()
        clip = toks["clip"](K_TOKENIZER_PROMPTS, padding="max_length", truncation=True,
                            max_length=77, return_tensors="np")
        t5 = toks["t5"](K_TOKENIZER_PROMPTS, padding="max_length", truncation=True,
                        max_length=512, return_tensors="np")
        flux_ms = 1000 * (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        parts = [qwen_edit._VISION_MARKERS.split(qwen_edit.EDIT_TEMPLATE.format(p))
                 for p in K_TOKENIZER_PROMPTS]
        vl_ids = [[i for part in ps if part and part not in (
            "<|vision_start|>", "<|image_pad|>", "<|vision_end|>")
            for i in vl(part, add_special_tokens=False)["input_ids"]] for ps in parts]
        qwen_ms = 1000 * (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        texts = [q3.apply_chat_template([{"role": "user", "content": p}], tokenize=False,
                                        add_generation_prompt=True, enable_thinking=False)
                 for p in K_TOKENIZER_PROMPTS]
        klein = q3(texts, padding="max_length", truncation=True, max_length=512,
                   return_tensors="np")
        klein_ms = 1000 * (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        decoded = [vl.decode(ids, skip_special_tokens=True) for ids in vl_ids]
        decode_ms = 1000 * (time.perf_counter() - t0) / n
        ok = (clip["input_ids"].shape == (n, 77) and t5["input_ids"].shape == (n, 512)
              and klein["input_ids"].shape == (n, 512)
              and bool((clip["attention_mask"].sum(1) >= 2).all())
              and bool((t5["attention_mask"].sum(1) >= 1).all())
              and all(texts[i].endswith("</think>\n\n") for i in range(n))
              and decoded[0].startswith("<|im_start|>") is False
              and K_TOKENIZER_PROMPTS[0] in decoded[0])
        print(f"[tokenizers] loaded FLUX's CLIP + T5, Qwen2.5-VL's and Klein's Qwen3 from "
              f"directories written here in {1000 * load_s:.1f} ms (the \\p{{L}} / \\p{{N}} "
              f"classes built once); host ms per prompt over {n}: FLUX CLIP 77 + T5 512 "
              f"{flux_ms:.3f}, Qwen-Image-Edit template parts {qwen_ms:.3f}, Klein chat "
              f"template + 512 {klein_ms:.3f}, DreamOmni2 decode {decode_ms:.3f}; tokens: CLIP "
              f"{clip['attention_mask'].sum(1).tolist()}, T5 "
              f"{t5['attention_mask'].sum(1).tolist()}, "
              f"Qwen {[len(i) for i in vl_ids]}, Klein {klein['attention_mask'].sum(1).tolist()}; "
              f"neither transformers nor tokenizers imported: {ok} [{card}]", flush=True)
        if not ok:
            raise AssertionError("the first-party tokenizers gave wrong shapes or text")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


PROFILE_GROUPS = [("K5a rq_int4_fwd", ("rq_int4_fwd",)), ("K5b rq_int4_bwd", ("rq_int4_bwd",)),
                  ("row quant", ("rowquant",)),
                  ("W8A8 int8_gemm", ("int8_gemm",)), ("W8A8 transpose", ("int8_transpose",)),
                  # after K5's: "rq_int4_fwd_kernel" contains "int4_fwd_kernel"
                  ("K6a int4_fwd", ("int4_fwd_kernel",)), ("K6b int4_bwd", ("int4_bwd_kernel",)),
                  ("K1 flash_nr_fwd", ("flash_nr_fwd",)),
                  ("K2 flash_nr_bwd", ("flash_nr_dkv", "flash_nr_dq")),
                  ("K3 flash_fwd", ("flash_fwd_kernel",)),
                  ("K4 flash_bwd", ("flash_dkv_kernel", "flash_dq_kernel", "flash_delta_kernel")),
                  ("K1/K2 prep", ("flash_nr_prep", "flash_nr_quant", "flash_nr_kn")),
                  ("cuBLAS GEMM/GEMV", ("gemm", "gemv", "nvjet", "cutlass", "sm90_")),
                  ("reductions", ("reduce",)), ("copies and casts", ("copy", "cast", "memcpy")),
                  ("elementwise", ("elementwise", "vectorized", "unrolled"))]


# ---------------------------------------------------------------------------
# phase L: multi-GPU distribution on one card — a world of one under NCCL,
# the frozen base sharded by FSDP2 over the one-rank fsdp group, the ring's
# one-hop path over K3 / K4 at path B's width, and the --distributed CLI

L_FIT_STEPS = 2     # FLUX.1-Kontext fit steps, bs = 2, sharded and not
L_RING = (1, 4000, 24, 128, 26)  # the ring: B, S, H, D, masked rows (K3's row)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _l_shard(card: str, label: str, model, mesh) -> None:
    """`shard_base` of `model` over `mesh`'s one-rank fsdp group (a world
    of one under NCCL; the Trainer shards only where fsdp > 1, so phase L
    calls it itself), then
    checked: the root and every block are FSDPModules, and the parameters
    that `param_specs` puts on the fsdp axis, and no others, are DTensors."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    from qflux_tpu_torch.parallel.partitioning import block_lists, param_specs, shard_base

    want = {n for n, (_, _, d) in param_specs(model, mesh.shape).items() if d is not None}
    shard_base(model, mesh)
    blocks = [b for _, bl in block_lists(model) for b in bl]
    got = {n for n, p in model.named_parameters() if isinstance(p, DTensor)}
    n_params = len(list(model.parameters()))
    wrapped = isinstance(model, FSDPModule) and all(isinstance(b, FSDPModule) for b in blocks)
    print(f"[dist] {label}: FSDP2 over the root and {len(blocks)} blocks: {wrapped}; "
          f"{len(got)} parameters sharded (DTensors), {n_params - len(got)} left whole "
          f"[{card}]", flush=True)
    if not (wrapped and blocks and got and got == want):
        raise AssertionError(f"{label}: the base is not sharded as the rules say: wrapped "
                             f"{wrapped}, {len(got)} DTensors, {len(want)} expected, "
                             f"{len(got ^ want)} differ")


def _l_flux_fit(card: str, label: str, shard: bool = False) -> dict:
    """FLUX.1-Kontext-dev at full width (synthetic weights from its seeds),
    Trainer.fit L_FIT_STEPS steps at bs = 2: its losses, grad norms, LoRA
    (on the host) and K1 / K2 launches, counted from just before the fit to
    just after it.  With `shard` the base is sharded over the Trainer's
    mesh (`_l_shard`)."""
    from qflux_tpu_torch.trainer.base import Trainer, train_config

    tt = Trainer(train_config(variant="full", max_train_steps=L_FIT_STEPS), device="cuda")
    t0 = time.perf_counter()
    tt.load_model()
    if shard:
        _l_shard(card, label, tt.bundle.dit_params, tt.mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = tt.bundle.dit_cfg
    gh, gw = tt.adapter.latent_grid(HEIGHT, WIDTH)
    rng = np.random.default_rng(30)
    batches = [_train_batch(rng, cfg, gh, gw, 2) for _ in range(L_FIT_STEPS)]
    _reset_counts()
    lora = _fit_in_tmp(tt, batches)
    counts = _launch_counts()
    hist = tt.history
    step_ms = ", ".join(f"{1000 * h['step_s']:.1f}" for h in hist)
    out = {"loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
           "lora": {p: {k: leaf[k].detach().cpu() for k in ("a", "b")}
                    for p, leaf in lora.items()},
           "counts": counts, "blocks": cfg.num_layers + cfg.num_single_layers}
    print(f"[dist] {label}: FLUX.1-Kontext-dev {cfg.num_layers} + {cfg.num_single_layers} "
          f"blocks loaded in {load_s:.1f} s, fit bs=2 ms/step {step_ms}, loss "
          f"{', '.join(f'{v:.6f}' for v in out['loss'])}, K1 / K2 launches {counts[0]} / "
          f"{counts[1]} [{card}]", flush=True)
    del tt, lora, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _l_qwen_fit(card: str, label: str, shard: bool = False) -> dict:
    """Path A's model (the 20B Qwen over int4_requant, cut to AC_BLOCKS)
    at 512², one Trainer.fit step at bs = 1 under remat "flash": its loss,
    LoRA and launches (_launch_counts' order).  With `shard` the quantized
    base is sharded over the Trainer's mesh (`_l_shard`)."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.trainer.base import Trainer

    raw = copy.deepcopy(QWEN_832X576)
    raw["mesh"]["remat"] = "flash"
    raw["train"]["max_train_steps"] = 1
    trainer, load_s = _qwen_cut(raw, AC_BLOCKS)
    if shard:
        _l_shard(card, label, trainer.bundle.dit_params, trainer.mesh)
    cfg = trainer.bundle.dit_cfg
    gh, gw = trainer.adapter.latent_grid(QWEN512, QWEN512)
    batches = [_qwen_train_batch(np.random.default_rng(31), cfg, gh, gw, 1)]
    tt = Trainer(config_from_dict(raw), device="cuda")
    tt.adapter = dataclasses.replace(trainer.adapter, remat_policy="flash")
    tt.bundle = trainer.bundle
    _reset_counts()
    lora = _fit_in_tmp(tt, batches)
    counts = _launch_counts()
    out = {"loss": [h["loss"] for h in tt.history],
           "lora": {p: {k: leaf[k].detach().cpu() for k in ("a", "b")}
                    for p, leaf in lora.items()}, "counts": counts, "blocks": cfg.num_layers}
    print(f"[dist] {label}: the 20B Qwen over int4_requant, {cfg.num_layers} blocks, loaded in "
          f"{load_s:.1f} s, one fit step at 512² bs=1 in {1000 * tt.history[0]['step_s']:.1f} "
          f"ms, loss {out['loss'][0]:.6f}, launches ({COUNT_NAMES}) {counts} [{card}]",
          flush=True)
    del tt, trainer, lora
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _l_compare(card: str, label: str, plain: dict, sharded: dict) -> None:
    """The sharded run against the unsharded one: prints the largest
    difference of the losses and of the LoRA after the steps (0 where equal
    to the bit); raises past 1e-3 of their size."""
    d_loss = max(abs(a - b) for a, b in zip(plain["loss"], sharded["loss"]))
    d_lora = max(float((plain["lora"][p][k] - sharded["lora"][p][k]).abs().max())
                 for p in plain["lora"] for k in ("a", "b"))
    scale = max(float(plain["lora"][p][k].abs().max()) for p in plain["lora"] for k in "ab")

    def said(d):
        return "equal to the bit" if d == 0 else f"max diff {d:.3e}"

    why = ("" if d_loss == d_lora == 0 else " (FSDP2 hands the kernels copies of the same "
           "weights, so a difference is an algorithm choice that depends on the pointers, "
           "not different numbers)")
    print(f"[dist] {label}: sharded (FSDP2 over the one-rank fsdp group, NCCL) against no "
          f"process group: losses {said(d_loss)}, LoRA {said(d_lora)} (LoRA max |x| "
          f"{scale:.3e}){why} [{card}]", flush=True)
    if len(plain["loss"]) != len(sharded["loss"]) or not (
            d_loss <= 1e-3 * max(abs(v) for v in plain["loss"]) and d_lora <= 1e-3 * scale):
        raise AssertionError(f"{label}: the sharded run left the unsharded one: loss "
                             f"{d_loss:.3e}, LoRA {d_lora:.3e}")


def _l_ring(card: str, mesh) -> dict:
    """`ring_attention_sharded` over the one-rank sp group at path B's
    width, bf16, forward and backward: one hop merges with weights 0 and 1,
    so out, dq, dk and dv must equal `flash_attention`'s K3 / K4 on the same
    inputs to the bit; one K3 and one K4 launch in the ring; the ring's ms
    against K3 + K4 alone (CUDA events, forward and backward)."""
    from qflux_tpu_torch.ops import flash_attention
    from qflux_tpu_torch.ops.ring_attention import ring_attention_sharded

    b, s, h, d, masked = L_RING
    gen = torch.Generator("cuda").manual_seed(32)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
    seg[:, s - masked:] = 0

    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        return [out.detach()] + [t.grad for t in leaves]

    def ring(q_, k_, v_):
        return ring_attention_sharded(q_, k_, v_, mesh, segment_ids=seg)

    def k3k4(q_, k_, v_):
        return flash_attention.flash_attention(q_, k_, v_, segment_ids=seg)

    _reset_counts()
    got = run(ring)
    torch.cuda.synchronize()
    launches = (flash_attention.KERNEL_LAUNCHES, flash_attention.BWD_KERNEL_LAUNCHES)
    want = run(k3k4)
    diffs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
    ring_ms = _rotating_ms(lambda i: run(ring), 1, reps=5)
    k_ms = _rotating_ms(lambda i: run(k3k4), 1, reps=5)
    print(f"[dist] ring over the one-rank sp group, B={b} S={s} H={h} D={d} bf16, {masked} "
          f"masked rows: out / dq / dk / dv max diff against K3 / K4 {diffs} (expected 0: "
          f"one hop, weights 0 and 1); K3 / K4 launches in the ring {launches}; ring fwd+bwd "
          f"{ring_ms:.4f} ms against K3 + K4 alone {k_ms:.4f} ms (overhead "
          f"{ring_ms - k_ms:.4f} ms: the merge, the sp group's gather and chunk copies) "
          f"[{card}]", flush=True)
    if any(x != 0 for x in diffs) or launches != (1, 1):
        raise AssertionError(f"the one-hop ring left K3 / K4: {diffs}, launches {launches}")
    return {"launches": launches, "ring_ms": ring_ms, "k3k4_ms": k_ms}


def _l_cli(card: str) -> None:
    """`python -m qflux_tpu_torch.main --distributed` as a subprocess with
    torchrun's variables for a world of one (NCCL on cuda:0), variant test
    from a cached folder, 2 steps: one run dir and one checkpoint."""
    from qflux_tpu_torch.models.flux.transformer import FluxConfig

    tmp = Path(tempfile.mkdtemp(prefix="qflux_smoke_dist_"))
    try:
        rng = np.random.default_rng(33)
        items = [flux_cache_item(rng, FluxConfig.tiny(), 4, 4, s_txt=8) for _ in range(4)]
        data, _ = write_cached_dataset(tmp, items, FLUX_HASH_KEYS)
        raw = multires_config(data, tmp, True, variant="test", steps=2)
        path = tmp / "dist.json"
        path.write_text(json.dumps(raw))
        env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
               "PYTHONPATH": str(Path(__file__).resolve().parent)}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "qflux_tpu_torch.main", "--config",
                               str(path), "--distributed"], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        runs = sorted((tmp / "flux_multires").glob("v*"))
        ckpts = sorted(c.name for r in runs for c in r.glob("checkpoint*"))
        print(f"[dist] python -m qflux_tpu_torch.main --distributed (RANK 0 of WORLD_SIZE 1, "
              f"NCCL): exit {proc.returncode} in {wall:.1f} s, run dirs "
              f"{[r.name for r in runs]}, checkpoints {ckpts} [{card}]", flush=True)
        if proc.returncode != 0 or [r.name for r in runs] != ["v0"] or ckpts != [
                "checkpoint-last-2"]:
            raise AssertionError(f"--distributed run failed:\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_distributed(card: str) -> dict:
    """Phase L.  (a) FLUX.1-Kontext-dev's fit, then (a′) path A's int4-requant
    step, each first with no process group, then inside
    init_process_group("nccl", world_size=1) with the base sharded by FSDP2
    over the one-rank fsdp group (`_l_shard`: the Trainer itself shards
    only where fsdp > 1; here the kernels read what FSDP2 unshards), held
    to each other; (b) the ring at path B's width over the one-rank sp
    group against K3 / K4; then the --distributed CLI.  Returns the launches
    of the sharded runs ({path: _launch_counts' order})."""
    import torch.distributed as dist

    from qflux_tpu_torch.parallel.mesh import MeshConfig, build_mesh, set_active_mesh

    flux_plain = _l_flux_fit(card, "(a) unsharded")
    qwen_plain = _l_qwen_fit(card, "(a') unsharded")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        flux = _l_flux_fit(card, "(a) sharded", shard=True)
        _l_compare(card, "(a) FLUX.1-Kontext-dev fit", flux_plain, flux)
        n = flux["blocks"]
        want = (n * L_FIT_STEPS, n * L_FIT_STEPS)
        print(f"[dist] (a) K1 / K2 launches {flux['counts'][:2]}, {n} / {n} a step [{card}]",
              flush=True)
        if flux["counts"][:2] != want or flux_plain["counts"][:2] != want:
            raise AssertionError(f"(a) K1 / K2 launched {flux['counts'][:2]}, expected {want}")
        qwen = _l_qwen_fit(card, "(a') sharded", shard=True)
        _l_compare(card, "(a') int4-requant Qwen step", qwen_plain, qwen)
        nq = qwen["blocks"]
        want_q = (2 * 12 * nq + 3, 6 + 12 * (nq - 2) + 9 + 1)
        if qwen["counts"] != qwen_plain["counts"] or qwen["counts"][2:4] != want_q:
            raise AssertionError(f"(a') launches {qwen['counts']} (unsharded "
                                 f"{qwen_plain['counts']}), K5a / K5b expected {want_q}")
        ring = _l_ring(card, build_mesh(MeshConfig(dp=1, fsdp=1, sp=1)))
    finally:
        set_active_mesh(None)
        dist.destroy_process_group()
    _l_cli(card)
    return {"distributed_fit": flux["counts"], "distributed_int4": qwen["counts"],
            "ring": (0,) * 8 + ring["launches"] + (0,)}


def dist_main() -> int:
    """`python3 chip_smoke.py --dist`: phase L alone (its kernels built
    first), for iterating on it; the smoke runs it after phase K."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from qflux_tpu_torch.runtime.build import load_library

    smi = _nvidia_smi()
    print(smi, flush=True)
    card = ", ".join(x.strip() for x in smi.split(",", 1))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    load_library()
    t0 = time.perf_counter()
    phase_distributed(card)
    print(f"[smoke] phase L: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return 0


def _profile(card: str, label: str, fn) -> None:
    """`fn` once to warm up, then once under torch.profiler: wall time,
    device busy time and share, and device time by kernel group, by kernel
    and by aten op.  Informational: it checks nothing, and the callers run
    it outside the windows in which the main paths' launches are counted."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1000 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1000
    groups = {name: [0.0, 0] for name, _ in PROFILE_GROUPS}
    groups["other"] = [0.0, 0]
    for e in kernels:
        key = e.key.lower()
        name = next((g for g, frags in PROFILE_GROUPS if any(f in key for f in frags)), "other")
        groups[name][0] += e.self_device_time_total / 1000
        groups[name][1] += e.count
    print(f"[profile] {label}: wall {wall_ms:.1f} ms under the profiler, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%); by group: "
          + "; ".join(f"{g} {ms:.1f} ms ({100 * ms / busy_ms:.1f}%, {n} launches)"
                      for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]))
          + f" [{card}]", flush=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print("[profile] top kernels: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1000:.2f} ms x{e.count}" for e in top)
        + f" [{card}]", flush=True)
    # the aten ops by the device time of the kernels they launched (the row
    # quantization before each K5a / K5b launch is abs, amax, div, round and
    # a cast)
    ops = sorted((e for e in prof.key_averages() if e.device_type ==
                  torch.autograd.DeviceType.CPU and e.key.startswith("aten::")
                  and e.device_time_total > 0), key=lambda e: -e.device_time_total)[:15]
    print("[profile] aten ops by device time (inclusive): " + "; ".join(
        f"{e.key} {e.device_time_total / 1000:.2f} ms x{e.count}" for e in ops)
        + f" [{card}]", flush=True)


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def _median_run(fn, n=3) -> dict:
    """Of n calls of `fn` (a `_k*_alone` timing), the result with the median
    `ms`: the first timing at a new shape can run several percent slow, on
    either side of `--ab`, more than the 3% two builds are held within."""
    return sorted((fn() for _ in range(n)), key=lambda r: r["ms"])[n // 2]


def _ab_child() -> None:
    """One side of `--ab`, in a process of its own whose sys.path puts one
    checkout's package first, on inputs drawn from fixed seeds (each time
    the median of three, `_median_run`):
      * at every CASES entry, K1 (bf16) alone (`_k1_alone`) and the digest
        of its out / lse; K2 (bf16) alone (`_k2_alone`), and whether two
        calls give the same bits;
      * at every FLASH_CASES entry, K3 alone (`_k3_alone`) and whether two
        calls give the same bits; K4 alone (`_k4_alone`) and the digests of
        its dq / dk / dv, from the plain forward's out / lse (so that both
        sides' K4 see the same residuals);
      * the digests of K6a's and K6b's outputs at every INT4_CASES shape, and
        of K2's (bf16) dq / dk / dv / scale gradients and K3's out / lse at
        every case above;
      * at every INT8_CASES entry, K1 and K2 s_int8 alone (`_k1_int8_alone`,
        `_k2_int8_alone`), the digests of the s_int8 prep's operands
        (`_int8_operands_cuda` at the forward's and the backward's q tiles),
        whether two calls of each kernel give the same bits, and the
        relative L2 errors of out and the five gradients against the plain
        versions;
      * at every AB_RQ_CASES entry, K5a and K5b alone (`_k5_alone`, weights
        rotated past the L2 cache) and the digests of their outputs;
      * at every K_NARROW_CASES entry (bf16 at D = 64 / 32), K3 and K4 through
        `_launch_fwd` / `_launch_bwd` (whichever kernel the checkout sends the
        narrow mode to), timed back to back;
      * the f32 modes (`_ab_f32`): at every K_F32_CASES entry K3 and K4, at
        every K_NR_CASES entry K1 and K2, and K1 / K2's s_int8 mode at
        K_INT8_S, timed back to back; the relative L2 errors against their
        plain versions (the s_int8 modes on the prep's own qn / kn), and
        the digests of the forwards and of the s_int8 K2 fed the plain
        forward's out / lse.
    Prints one line, AB_RESULT and a JSON object."""
    from qflux_tpu_torch.ops import flash_attention as fa
    from qflux_tpu_torch.ops import flash_nr
    from qflux_tpu_torch.ops import int4_matmul as ti4, quant

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"card": _nvidia_smi(), "k1": {}, "k2": {}, "k3": {}, "k4": {}, "k6": {},
           "k1_digest": {}, "k4_digest": {}, "k2_same": {}, "k3_same": {}, "k2_digest": {},
           "k3_digest": {}, "k5a": {}, "k5b": {}, "k5_digest": {}, "k1_int8": {},
           "k2_int8": {}, "int8_prep_digest": {}, "int8_same": {}, "int8_rel": {},
           "k3_narrow": {}, "k4_narrow": {}}
    scale = 128 ** -0.5
    gen = torch.Generator("cuda").manual_seed(0)
    for name, b, s, st, seg_kind in CASES:
        args = _attn_inputs(gen, b, s)
        seg = _segments(seg_kind, b, s)
        res["k1"][name] = _median_run(lambda: _k1_alone(args, st, seg, scale))
        out, lse = flash_nr._flash_nr_cuda(*args, st, seg, scale)
        res["k1_digest"][name] = [_digest(out), _digest(lse)]
        do = torch.randn(out.shape, device="cuda", generator=gen).to(torch.bfloat16)
        res["k2"][name] = _median_run(
            lambda: _k2_alone(args, st, seg, scale, out, lse, do))
        g1 = flash_nr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do)
        g2 = flash_nr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do)
        res["k2_same"][name] = all(torch.equal(x, y) for x, y in zip(g1, g2))
        res["k2_digest"][name] = [_digest(x) for x in g1]
        del args, out, lse, do, g1, g2
        torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(13)
    for name, b, s, ids in FLASH_CASES:
        q, k, v, q_seg, kv_seg = _flash_case(gen, b, s, ids)
        do = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
        res["k3"][name] = _median_run(lambda: _k3_alone(q, k, v, q_seg, kv_seg, scale))
        o1, l1 = fa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
        o2, l2 = fa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
        res["k3_same"][name] = torch.equal(o1, o2) and torch.equal(l1, l2)
        res["k3_digest"][name] = [_digest(o1), _digest(l1)]
        del o1, o2, l1, l2
        out, lse = (t.contiguous() for t in fa.flash_fwd_reference(q, k, v, q_seg, kv_seg,
                                                                    scale))
        torch.cuda.empty_cache()
        res["k4"][name] = _median_run(
            lambda: _k4_alone(q, k, v, q_seg, kv_seg, out, lse, do, scale))
        res["k4_digest"][name] = [_digest(g) for g in fa._flash_bwd_cuda(
            q, k, v, q_seg, kv_seg, out, lse, do, scale)]
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(16)
    for m, k_in, n in INT4_CASES:
        w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
        q4, sc = quant.quantize_kernel_int4(w, 128)
        dtype = torch.float32 if m <= 2 else torch.bfloat16
        x = torch.randn(m, k_in, device="cuda", generator=gen).to(torch.bfloat16)
        g = torch.randn(m, n, device="cuda", generator=gen).to(torch.bfloat16)
        res["k6"][f"{m}x{k_in}x{n}"] = [_digest(ti4.int4_fwd_cuda(x, q4, sc, dtype)),
                                        _digest(ti4.int4_bwd_cuda(g, q4, sc, dtype))]
        del w, q4, sc, x, g
    gen = torch.Generator("cuda").manual_seed(11)
    for name, b, s, st, masked in INT8_CASES:
        args = _attn_inputs(gen, b, s)
        q, k, v, qs2, ks2, cos, sin = args
        seg = _int8_seg(b, s, st, masked)
        fwd_rows, bwd_rows = flash_nr.s_int8_tiles(s, 128)
        res["int8_prep_digest"][name] = [
            _digest(x) for rows in sorted({fwd_rows, bwd_rows})
            for x in flash_nr._int8_operands_cuda(q, k, qs2, ks2, cos, sin, st, rows)]
        res["k1_int8"][name] = _median_run(
            lambda: _k1_int8_alone(args, st, seg, scale, fwd_rows))
        out, lse = flash_nr._flash_nr_cuda(*args, st, seg, scale, fwd_rows)
        out2, lse2 = flash_nr._flash_nr_cuda(*args, st, seg, scale, fwd_rows)
        do = torch.randn(out.shape, device="cuda", generator=gen).to(torch.bfloat16)
        res["k2_int8"][name] = _median_run(
            lambda: _k2_int8_alone(args, st, seg, scale, out, lse, do, bwd_rows))
        g1 = flash_nr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do, bwd_rows)
        g2 = flash_nr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do, bwd_rows)
        res["int8_same"][name] = (torch.equal(out, out2) and torch.equal(lse, lse2)
                                  and all(torch.equal(x, y) for x, y in zip(g1, g2)))
        ref, _ = flash_nr.flash_attention_nr_int8_reference(*args, st, fwd_rows,
                                                            segment_ids=seg)
        want = flash_nr.flash_attention_nr_int8_bwd_reference(*args, st, do, out, lse,
                                                              bwd_rows, segment_ids=seg)
        res["int8_rel"][name] = [((x.float() - r.float()).norm() / r.float().norm()).item()
                                 for x, r in zip((out, *g1), (ref, *want))]
        del args, q, k, v, out, lse, out2, lse2, do, g1, g2, ref, want
        torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(21)
    for m, k_in, n in AB_RQ_CASES:
        _, _, weights, x, g = _rq_operands(gen, m, k_in, n)
        xq, sx = quant._rowquant(x)
        gq, sg = quant._rowquant(g.float() * weights[0][2])
        key = f"{m}x{k_in}x{n}"
        fw = _median_run(lambda: _k5_alone(ti4, False, xq, sx.reshape(m), weights,
                                           torch.bfloat16))
        bw = _median_run(lambda: _k5_alone(ti4, True, gq, sg.reshape(m), weights,
                                           torch.bfloat16))
        res["k5a"][key], res["k5b"][key] = {"ms": fw["ms"]}, {"ms": bw["ms"]}
        res["k5_digest"][key] = [_digest(fw["out"]), _digest(bw["out"])]
        del weights, x, g, xq, gq, fw, bw
        torch.cuda.empty_cache()
    from qflux_tpu_torch.runtime.build import load_library

    kl, stream = load_library(), torch.cuda.current_stream().cuda_stream
    gen = torch.Generator("cuda").manual_seed(17)
    for name, b, s, h, d, ids in K_NARROW_CASES:
        q, k, v, q_seg, kv_seg = _flash_case(gen, b, s, ids, h, d)
        _, _, _, _, qs32, ks32 = fa._kernel_args(q, k, v, q_seg, kv_seg)
        sc_n = d ** -0.5
        res["k3_narrow"][name] = _median_run(lambda: {"ms": _window_ms(
            lambda: fa._launch_fwd(kl, stream, q, k, v, qs32, ks32, sc_n), 5, 3)})
        out, lse = fa._launch_fwd(kl, stream, q, k, v, qs32, ks32, sc_n)
        do = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
        res["k4_narrow"][name] = _median_run(lambda: {"ms": _window_ms(
            lambda: fa._launch_bwd(kl, stream, q, k, v, qs32, ks32, out, lse, do, sc_n), 3, 3)})
        del q, k, v, out, lse, do
        torch.cuda.empty_cache()
    res.update(_ab_f32(kl, stream))
    print("AB_RESULT " + json.dumps(res), flush=True)


def _f32_rels(out, lse, ref, ref_lse) -> list:
    """Relative L2 errors of an f32 forward's out and lse (over the rows
    that attend) against its plain version."""
    live = ref_lse > -1e29
    return [_rel(out, ref), _rel(lse[live], ref_lse[live])]


def _ab_f32(kl, stream) -> dict:
    """`_ab_child`'s f32 part, through the checkout's launchers on checked
    arguments (`_launch_fwd` / `_launch_bwd` of both modules), on inputs from
    fixed seeds: "k3_f32" / "k4_f32" at K_F32_CASES, "k1_f32" / "k2_f32" at
    K_NR_CASES (FLUX's layout, as `_k_nr_case`), "k1_f32_int8" / "k2_f32_int8"
    at K_INT8_S, each the median of three timings; "f32_rel", the forwards'
    errors against their plain versions; "f32_grad_rel", the errors of K4 /
    K2 (fed the plain forward's out / lse) against theirs (the 3xTF32
    backwards are held to those, not to the parent's bits), the s_int8
    modes on the prep's own qn / kn (`_int8_operands_cuda`: an f32 ulp from
    the plain ones can cross an int8 rounding midpoint); "f32_digest", the
    digests of the f32 K3 / K1 forwards, which this comparison holds to the
    bit, and of the s_int8 K1 / K2 (fed the plain forward's out / lse),
    which it reports."""
    from qflux_tpu_torch.ops import flash_attention as fa
    from qflux_tpu_torch.ops import flash_nr as fnr

    res = {key: {} for key in ("k3_f32", "k4_f32", "k1_f32", "k2_f32", "k1_f32_int8",
                               "k2_f32_int8", "f32_rel", "f32_grad_rel", "f32_digest")}
    gen = torch.Generator("cuda").manual_seed(19)
    for name, b, s, h, d, ids in K_F32_CASES:
        q, k, v, q_seg, kv_seg = _flash_case(gen, b, s, ids, h, d, torch.float32)
        _, _, _, _, qs32, ks32 = fa._kernel_args(q, k, v, q_seg, kv_seg)
        sc = d ** -0.5
        res["k3_f32"][name] = _median_run(lambda: {"ms": _window_ms(
            lambda: fa._launch_fwd(kl, stream, q, k, v, qs32, ks32, sc), 3, 3)})
        out, lse = fa._launch_fwd(kl, stream, q, k, v, qs32, ks32, sc)
        ref, ref_lse = (t.contiguous() for t in fa.flash_fwd_reference(q, k, v, q_seg, kv_seg,
                                                                      sc))
        res["f32_rel"][f"K3 {name}"] = _f32_rels(out, lse, ref, ref_lse)
        res["f32_digest"][f"K3 {name}"] = [_digest(out), _digest(lse)]
        do = torch.randn(q.shape, device="cuda", generator=gen)
        res["k4_f32"][name] = _median_run(lambda: {"ms": _window_ms(
            lambda: fa._launch_bwd(kl, stream, q, k, v, qs32, ks32, ref, ref_lse, do, sc),
            3, 3)})
        got = fa._launch_bwd(kl, stream, q, k, v, qs32, ks32, ref, ref_lse, do, sc)
        want = fa.flash_bwd_reference(q, k, v, q_seg, kv_seg, ref, ref_lse, do, sc)
        res["f32_grad_rel"][f"K4 {name}"] = [_rel(g, r) for g, r in zip(got, want)]
        del got, want
        del q, k, v, out, lse, ref, ref_lse, do
        torch.cuda.empty_cache()
    st, sc = 512, 128 ** -0.5
    for s, rows in [(s, 0) for s in K_NR_CASES] + [(K_INT8_S, -1)]:
        args = _attn_inputs(gen, 1, s, 24, 128, torch.float32)
        q, k, v, qs2, ks2, cos, sin = args
        seg = torch.ones(1, s, dtype=torch.int32, device="cuda")
        seg[0, 492:512] = 0
        fwd_rows, bwd_rows = fnr.s_int8_tiles(s, 128) if rows else (0, 0)
        qs, ks, csb, seg32 = fnr._kernel_args(q, k, v, qs2, ks2, cos, sin, seg)
        name, tag = f"S={s}", "_int8" if rows else ""
        res[f"k1_f32{tag}"][name] = _median_run(lambda: {"ms": _window_ms(
            lambda: fnr._launch_fwd(kl, stream, q, k, v, qs, ks, cos, sin, csb, seg32, st, sc,
                                    fwd_rows), 3, 3)})
        out, lse = fnr._launch_fwd(kl, stream, q, k, v, qs, ks, cos, sin, csb, seg32, st, sc,
                                   fwd_rows)
        res["f32_digest"][f"K1{' s_int8' if rows else ''} {name}"] = [_digest(out), _digest(lse)]
        if rows:
            normed = fnr._int8_operands_cuda(q, k, qs2, ks2, cos, sin, st, fwd_rows)[:2]
            ref, ref_lse = fnr.flash_attention_nr_int8_reference(*args, st, fwd_rows,
                                                                 segment_ids=seg, scale=sc,
                                                                 normed=normed)
            res["f32_rel"][f"K1 s_int8 {name}"] = _f32_rels(out, lse, ref, ref_lse)
            ref, ref_lse = fnr.flash_attention_nr_int8_reference(*args, st, fwd_rows,
                                                                 segment_ids=seg, scale=sc)
        else:
            ref, ref_lse = fnr.flash_attention_nr_reference(*args, st, segment_ids=seg, scale=sc)
            res["f32_rel"][f"K1 {name}"] = _f32_rels(out, lse, ref, ref_lse)
        ref, ref_lse = ref.contiguous(), ref_lse.contiguous()
        do = torch.randn(q.shape, device="cuda", generator=gen)
        res[f"k2_f32{tag}"][name] = _median_run(lambda: {"ms": _window_ms(
            lambda: fnr._launch_bwd(kl, stream, q, k, v, qs, ks, cos, sin, csb, seg32, st, sc,
                                    ref, ref_lse, do, bwd_rows), 3, 3)})
        got = fnr._launch_bwd(kl, stream, q, k, v, qs, ks, cos, sin, csb, seg32, st, sc, ref,
                              ref_lse, do, bwd_rows)
        if rows:
            res["f32_digest"][f"K2 s_int8 {name}"] = [_digest(g) for g in got]
            want = fnr.flash_attention_nr_int8_bwd_reference(*args, st, do, ref, ref_lse,
                                                             bwd_rows, segment_ids=seg,
                                                             scale=sc, normed=normed)
            res["f32_grad_rel"][f"K2 s_int8 {name}"] = [_rel(g, r) for g, r in zip(got, want)]
            del want, normed
        else:
            want = fnr.flash_attention_nr_bwd_reference(*args, st, do, segment_ids=seg, scale=sc)
            res["f32_grad_rel"][f"K2 {name}"] = [_rel(g, r) for g, r in zip(got, want)]
            del want
        del got
        del args, q, k, v, out, lse, ref, ref_lse, do
        torch.cuda.empty_cache()
    return res


# `--data-ab`: the FLUX fit through the data layer against the same batches
# handed to fit as a list; one epoch of 2 * DATA_AB_STEPS cached 512²
# samples at bs=2 a fit, each variant run DATA_AB_ROUNDS times, in turns
DATA_AB_STEPS = 10
DATA_AB_ROUNDS = 3
DATA_AB_TARGETS = {"8": None, "4": ["to_q", "to_k", "to_v", "to_out"]}


def _trace_busy(path: Path) -> tuple[float, float]:
    """(device kernel ms, window ms) of a torch.profiler chrome trace: the
    kernels' summed durations and the span of all its events."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    busy = sum(e["dur"] for e in events if e.get("cat") == "kernel")
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return busy / 1000, span / 1000


def data_ab_main() -> int:
    """`python3 chip_smoke.py --data-ab`: whether a FLUX fit fed by the data
    layer loses time against one fed a list.  One full-width FLUX model
    (configs/example_multiresolution.yaml's settings, bucketed, no shuffle)
    and 2 * DATA_AB_STEPS cached 512² samples (one epoch a fit); then, in
    turns, DATA_AB_ROUNDS times each: Trainer.fit over the DataLoader
    ("loader"); over it with the cache's npz members read by np.load, as
    before `data.cache.read_npz_data` ("loader, np.load reads"); over a
    DataLoader of the items read beforehand, so that its thread only
    collates ("loader, in memory"); over the same collated batches held in
    a list ("list"); and over the list with the LoRA on the four
    image-stream projections of the smoke's other fits ("list, 4 targets";
    the config's default is eight, the text stream's add_q / add_k / add_v
    / add_out as well).  Per
    variant, over steps 2-DATA_AB_STEPS of every run: the median, and the
    mean with its standard error, of step_s (launch to loss read), launch_s
    (the step's host time to enqueue its forward and backward), stage_s and
    data_wait_s; then one more fit of "loader" and "list" each with
    logging.profile_dir, whose chrome trace of steps 2-4 gives the device's
    busy share.  Writes data_ab.json to the output directory beside this
    file.  A measurement: it checks only that every step's loss is
    finite."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.data import cache as cache_mod
    from qflux_tpu_torch.data.dataset import ImageDataset
    from qflux_tpu_torch.data.loader import DataLoader
    from qflux_tpu_torch.models.flux.transformer import FluxConfig
    from qflux_tpu_torch.runtime.build import load_library
    from qflux_tpu_torch.trainer.base import Trainer

    smi = _nvidia_smi()
    print(smi, flush=True)
    card = ", ".join(x.strip() for x in smi.split(",", 1))
    load_library()
    cfg = FluxConfig()
    tmp = Path(tempfile.mkdtemp(prefix="qflux_data_ab_"))
    try:
        rng = np.random.default_rng(30)
        items = [flux_cache_item(rng, cfg, 32, 32) for _ in range(2 * DATA_AB_STEPS)]
        data_dir, cache_dir = write_cached_dataset(tmp, items, FLUX_HASH_KEYS)
        del items
        raw = multires_config(data_dir, tmp / "out", True, steps=DATA_AB_STEPS)
        raw["data"]["shuffle"] = False
        raw["train"]["checkpointing_steps"] = 10 ** 6

        def loader():
            return DataLoader(ImageDataset(str(data_dir), cache_dir=str(cache_dir),
                                           use_cache=True), batch_size=2, shuffle=False)

        class InMemory:
            """The dataset's items, read once: the loader's thread then only
            collates."""

            def __init__(self, ds):
                self.items = [ds[i] for i in range(len(ds))]
                self.samples = [{} for _ in self.items]

            def __len__(self):
                return len(self.items)

            def __getitem__(self, i):
                return dict(self.items[i])

        def np_load_data(path):  # how the cache was read before read_npz_data
            with np.load(path) as z:
                return z["data"]

        batches = list(loader())
        in_memory = InMemory(ImageDataset(str(data_dir), cache_dir=str(cache_dir),
                                          use_cache=True))
        base = Trainer(config_from_dict(copy.deepcopy(raw)), device="cuda")
        base.load_model()

        def fit(variant, profile_dir=None):
            r = copy.deepcopy(raw)
            targets = DATA_AB_TARGETS["4" if variant.endswith("4 targets") else "8"]
            if targets:
                r["model"]["lora"]["target_modules"] = targets
            if profile_dir:
                r["logging"]["profile_dir"] = str(profile_dir)
            tt = Trainer(config_from_dict(r), device="cuda")
            tt.adapter, tt.bundle = base.adapter, base.bundle
            source = {"loader": loader, "loader, np.load reads": loader,
                      "loader, in memory": lambda: DataLoader(in_memory, batch_size=2,
                                                              shuffle=False,
                                                              bucket_by_shape=False)
                      }.get(variant, lambda: batches)()
            reader = cache_mod.read_npz_data
            if variant == "loader, np.load reads":
                cache_mod.read_npz_data = np_load_data
            torch.cuda.synchronize()
            try:
                with _StepCounts() as sc:
                    tt.fit(source)
            finally:
                cache_mod.read_npz_data = reader
            torch.cuda.synchronize()
            hist = tt.history
            if len(hist) != DATA_AB_STEPS or not all(np.isfinite(h["loss"]) for h in hist):
                raise AssertionError(f"{variant}: {hist}")
            shutil.rmtree(tt.output_dir, ignore_errors=True)
            return [{**h, "launch_s": rec["launch_s"]} for h, rec in zip(hist, sc.steps)]

        variants = ("loader", "loader, np.load reads", "loader, in memory", "list",
                    "list, 4 targets")
        runs = {v: [] for v in variants}
        for _ in range(DATA_AB_ROUNDS):
            for v in variants:
                steps = fit(v)
                runs[v].append(steps)
                print(f"[data-ab] {v}: ms/step " + ", ".join(
                    f"{1000 * h['step_s']:.1f} (launch {1000 * h['launch_s']:.1f}, staging "
                    f"{1000 * h['stage_s']:.1f}, wait {1000 * h['data_wait_s']:.2f})"
                    for h in steps) + f" [{card}]", flush=True)
        summary = {}
        for v in variants:
            warm = [h for run in runs[v] for h in run[1:]]
            summary[v] = {}
            for k in ("step_s", "launch_s", "stage_s", "data_wait_s"):
                ms = [1000 * h[k] for h in warm]
                summary[v][k] = {"median": statistics.median(ms), "mean": statistics.mean(ms),
                                 "sem": statistics.stdev(ms) / len(ms) ** 0.5, "n": len(ms)}
            print(f"[data-ab] {v}: over steps 2-{DATA_AB_STEPS} of {DATA_AB_ROUNDS} fits, "
                  "median / mean ± standard error: " + ", ".join(
                      f"{k} {m['median']:.1f} / {m['mean']:.1f} ± {m['sem']:.1f} ms"
                      for k, m in summary[v].items()) + f" [{card}]", flush=True)
        profiles = {}
        for v in ("loader", "list"):
            prof = tmp / f"prof_{v}"
            steps = fit(v, prof)
            (trace,) = prof.glob("*.trace.json")
            busy, span = _trace_busy(trace)
            profiles[v] = {"busy_ms": busy, "window_ms": span,
                           "step_ms": [1000 * h["step_s"] for h in steps]}
            print(f"[data-ab] {v}, steps 2-4 under the profiler: device busy {busy:.1f} ms of "
                  f"{span:.1f} ms ({100 * busy / span:.1f}%), ms/step "
                  + ", ".join(f"{1000 * h['step_s']:.1f}" for h in steps) + f" [{card}]",
                  flush=True)
        out_dir = Path(__file__).resolve().parent / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "data_ab.json").write_text(json.dumps(
            {"card": card, "runs": runs, "summary": summary, "profiles": profiles}, indent=1))
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ab_main(parent: str) -> int:
    """`python3 chip_smoke.py --ab PARENT`: K1, K2 (bf16 and s_int8), K3, K4
    (at D = 128, and in the narrow mode at K_NARROW_CASES), K5a and K5b
    alone, and K1–K4 in f32 (`_ab_f32`), before and after, on one card.  PARENT is an unpacked
    checkout of an earlier commit (git archive); each side runs `_ab_child` from this file
    in its own process with its own package first on sys.path, in turns
    parent, change, change, parent.  Prints each case's times (mean of the
    two runs of each side), whether the change's K2, K3 and K1 / K2 s_int8
    gave the same bits on two calls, the digests (K1 and K2 bf16, K3, K4,
    K5a / K5b, K6a / K6b, the s_int8 prep's operands; the f32 K3 / K1,
    `_ab_f32`) compared across all four runs (the f32 s_int8 K1 / K2's
    reported: their loops changed), every run's f32 K3 / K1 and f32 s_int8
    K1 against their plain versions (F32_REL_TOL) and f32 K4 / K2 and f32
    s_int8 K2 (F32_GRAD_TOL: the 3xTF32 backwards are not held to the
    parent's bits), and the change's K1 / K2
    s_int8 against their plain versions
    (INT8_FWD_REL_TOL / INT8_BWD_REL_TOL: their outputs are not compared
    across the trees, because the redesign moved their online softmax into
    log2 units and the scale inside the exponent); writes the runs to
    ab.json in the output directory beside this file.
    Exits non-zero if a digest differs, a change's call did not repeat its
    bits or a change's s_int8 output is outside its tolerance."""
    here = Path(__file__).resolve()
    trees = {"parent": Path(parent).resolve(), "change": here.parent}
    runs = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent"):
        tree = trees[tag]
        code = ("import importlib.util, sys; sys.path.insert(0, %r); "
                "spec = importlib.util.spec_from_file_location('smoke_ab', %r); "
                "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
                "m._ab_child()" % (str(tree), str(here)))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=tree, timeout=1500)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs[tag].append(json.loads(lines[-1][len("AB_RESULT "):]))
        print(f"[ab] {tag} ({tree}) in {time.perf_counter() - t0:.1f} s [{runs[tag][-1]['card']}]",
              flush=True)
    card = runs["change"][0]["card"]
    mean = statistics.mean
    for kern, label, cases in (("k1", "K1", CASES), ("k2", "K2", CASES), ("k3", "K3", FLASH_CASES),
                               ("k4", "K4", FLASH_CASES), ("k1_int8", "K1 s_int8", INT8_CASES),
                               ("k2_int8", "K2 s_int8", INT8_CASES)):
        for case in cases:
            name = case[0]
            p = [r[kern][name] for r in runs["parent"]]
            c = [r[kern][name] for r in runs["change"]]
            pm, cm = mean(x["ms"] for x in p), mean(x["ms"] for x in c)
            prep = c[0].get("prep_ms")
            print(f"[ab] {label} {name}: parent {pm:.4f} ms "
                  f"({', '.join(f'{x['ms']:.4f}' for x in p)}), change {cm:.4f} ms "
                  f"({', '.join(f'{x['ms']:.4f}' for x in c)}), {pm / cm:.2f}x"
                  + (f"; change's prep {mean(x['prep_ms'] for x in c):.4f} ms, main kernel "
                     f"{cm - mean(x['prep_ms'] for x in c):.4f} ms" if prep is not None else "")
                  + f"; wrapper host {mean(x['wrapper_host_us'] for x in p):.1f} -> "
                  f"{mean(x['wrapper_host_us'] for x in c):.1f} us per call [{card}]",
                  flush=True)
    for kern, label, backward in (("k5a", "K5a", False), ("k5b", "K5b", True)):
        for m, k_in, n in AB_RQ_CASES:
            key = f"{m}x{k_in}x{n}"
            p = [r[kern][key]["ms"] for r in runs["parent"]]
            c = [r[kern][key]["ms"] for r in runs["change"]]
            pm, cm = mean(p), mean(c)
            print(f"[ab] {label} {'dx of ' if backward else ''}M={m} K={k_in} N={n}: parent "
                  f"{pm:.4f} ms ({', '.join(f'{x:.4f}' for x in p)}), change {cm:.4f} ms "
                  f"({', '.join(f'{x:.4f}' for x in c)}), {pm / cm:.2f}x; change "
                  f"{2.0 * m * k_in * n / cm / 1e9:.1f} TOPS [{card}]", flush=True)
    for kern, label in (("k3_narrow", "K3 narrow"), ("k4_narrow", "K4 narrow")):
        for case in K_NARROW_CASES:
            p = [r[kern][case[0]]["ms"] for r in runs["parent"]]
            c = [r[kern][case[0]]["ms"] for r in runs["change"]]
            print(f"[ab] {label} {case[0]} (B={case[1]} S={case[2]} H={case[3]} D={case[4]}): "
                  f"parent {mean(p):.4f} ms ({', '.join(f'{x:.4f}' for x in p)}), change "
                  f"{mean(c):.4f} ms ({', '.join(f'{x:.4f}' for x in c)}), "
                  f"{mean(p) / mean(c):.2f}x [{card}]", flush=True)
    f32_cases = ([("k3_f32", "K3 f32", c[0]) for c in K_F32_CASES]
                 + [("k4_f32", "K4 f32", c[0]) for c in K_F32_CASES]
                 + [(kern, label, f"S={s}") for kern, label in (("k1_f32", "K1 f32"),
                                                                ("k2_f32", "K2 f32"))
                    for s in K_NR_CASES]
                 + [(kern, label, f"S={K_INT8_S}") for kern, label in
                    (("k1_f32_int8", "K1 f32 s_int8"), ("k2_f32_int8", "K2 f32 s_int8"))])
    for kern, label, name in f32_cases:
        p = [r[kern][name]["ms"] for r in runs["parent"]]
        c = [r[kern][name]["ms"] for r in runs["change"]]
        print(f"[ab] {label} {name}: parent {mean(p):.4f} ms ({', '.join(f'{x:.4f}' for x in p)}), "
              f"change {mean(c):.4f} ms ({', '.join(f'{x:.4f}' for x in c)}), "
              f"{mean(p) / mean(c):.2f}x [{card}]", flush=True)
    every = runs["parent"] + runs["change"]
    f32_close = {}
    for name in every[0]["f32_rel"]:
        errs = [r["f32_rel"][name] for r in every]
        f32_close[name] = all(max(e) <= F32_REL_TOL for e in errs)
        print(f"[ab] f32 {name} against its plain version, rel L2 (out, lse): parent "
              + ", ".join(f"{e[0]:.2e} / {e[1]:.2e}" for e in errs[:2]) + "; change "
              + ", ".join(f"{e[0]:.2e} / {e[1]:.2e}" for e in errs[2:])
              + f" (tol {F32_REL_TOL}) [{card}]", flush=True)
    for name in every[0]["f32_grad_rel"]:
        errs = [r["f32_grad_rel"][name] for r in every]
        f32_close[name] = all(max(e) <= F32_GRAD_TOL for e in errs)
        print(f"[ab] f32 {name} against its plain version, rel L2 of the gradients: parent "
              + ", ".join(" / ".join(f"{x:.2e}" for x in e) for e in errs[:2]) + "; change "
              + ", ".join(" / ".join(f"{x:.2e}" for x in e) for e in errs[2:])
              + f" (tol {F32_GRAD_TOL}) [{card}]", flush=True)

    def same_across(key):
        return {case: all(r[key][case] == every[0][key][case] for r in every)
                for case in every[0][key]}

    k6_same, k1_same, k4_same = same_across("k6"), same_across("k1_digest"), \
        same_across("k4_digest")
    k2_same, k3_same, k5_same = same_across("k2_digest"), same_across("k3_digest"), \
        same_across("k5_digest")
    prep_same = same_across("int8_prep_digest")
    f32_same = same_across("f32_digest")
    # the f32 s_int8 K1 / K2 run other loops than the parent's (int8 wgmma scores in
    # the 3xTF32 loops): their sums run in another order, so their bits may differ, and
    # they are held to their plain versions (f32_close) instead
    s_int8_moved = {n: ok for n, ok in f32_same.items() if "s_int8" in n}
    f32_same = {n: ok for n, ok in f32_same.items() if n not in s_int8_moved}
    f32_differ = ", ".join(n for n, ok in f32_same.items() if not ok) or "none differ"
    repeat = {key: all(all(r[key].values()) for r in runs["change"])
              for key in ("k2_same", "k3_same", "int8_same")}
    int8_rel = {name: max(r["int8_rel"][name][0] for r in runs["change"])
                for name in runs["change"][0]["int8_rel"]}
    int8_bwd_rel = {name: max(max(r["int8_rel"][name][1:]) for r in runs["change"])
                    for name in runs["change"][0]["int8_rel"]}
    int8_close = {name: int8_rel[name] <= INT8_FWD_REL_TOL
                  and int8_bwd_rel[name] <= INT8_BWD_REL_TOL for name in int8_rel}
    print(f"[ab] identical to the bit across the four runs: K6a / K6b outputs at "
          f"{sum(k6_same.values())} of {len(k6_same)} shapes; K1 bf16 out / lse at "
          f"{sum(k1_same.values())} of {len(k1_same)} cases; K2 bf16 grads at "
          f"{sum(k2_same.values())} of {len(k2_same)} cases; K3 out / lse at "
          f"{sum(k3_same.values())} of {len(k3_same)} cases; K4 dq / dk / dv at "
          f"{sum(k4_same.values())} of {len(k4_same)} cases; K5a / K5b outputs at "
          f"{sum(k5_same.values())} of {len(k5_same)} cases; the s_int8 prep's qn / kn / qq / "
          f"kq / scales at {sum(prep_same.values())} of {len(prep_same)} cases; the f32 K3 / K1 "
          f"outputs at {sum(f32_same.values())} of {len(f32_same)} cases ({f32_differ}); the "
          f"f32 s_int8 K1 / K2 (redesigned, held to their plain versions above) identical at "
          f"{sum(s_int8_moved.values())} of {len(s_int8_moved)}. The change's "
          f"two calls identical: K2 bf16 {repeat['k2_same']}, K3 {repeat['k3_same']}, K1 / K2 "
          f"s_int8 {repeat['int8_same']}. The change's K1 / K2 s_int8 against their plain "
          f"versions: " + "; ".join(
              f"{name} out rel L2 {int8_rel[name]:.3e} (tol {INT8_FWD_REL_TOL}), grads max "
              f"{int8_bwd_rel[name]:.3e} (tol {INT8_BWD_REL_TOL})" for name in int8_rel)
          + f" [{card}]", flush=True)
    out_dir = here.parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab.json").write_text(json.dumps(runs, indent=1))
    checks = [*k6_same.values(), *k1_same.values(), *k2_same.values(), *k3_same.values(),
              *k4_same.values(), *k5_same.values(), *prep_same.values(), *repeat.values(),
              *int8_close.values(), *f32_same.values(), *f32_close.values()]
    return 0 if all(checks) else 1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this smoke runs only on a "
              "CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from qflux_tpu_torch.runtime.build import load_library

    smi = _nvidia_smi()
    print(smi, flush=True)
    name, limit = (x.strip() for x in smi.split(",", 1))
    card = f"{name}, {limit}"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}, count {torch.cuda.device_count()}, torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; TF32 off [{card}]", flush=True)

    t_start = t0 = time.perf_counter()
    kl = load_library()
    ptxas = [ln.strip() for ln in kl.log.splitlines() if "registers" in ln or "spill" in ln]
    # ptxas's notes that it serialized a wgmma (PERF.md §6)
    serial = [ln.strip() for ln in kl.log.splitlines()
              if any(f"(C75{n})" in ln for n in ("14", "15", "18", "20"))]
    print(f"[build] {kl.path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kl.build_seconds:.2f} s): {' | '.join(ptxas)}; wgmma serialization notes "
          f"(C7514 / C7515 / C7518 / C7520): {len(serial)} {serial[:4]} [{card}]", flush=True)

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(card, *args)
        print(f"[smoke] {phase.__name__}: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
        return out

    k1_case = timed(phase_kernel)
    k2_case = timed(phase_kernel_bwd)
    k3_case = timed(phase_flash_kernel)
    k4_case = timed(phase_flash_bwd_kernel)
    trainer, k1_predict = timed(phase_predict)
    k1_train, k2_train = timed(phase_train, trainer)
    k1_fa, k2_fa = timed(phase_files_flux_resume, trainer)
    k1_fb = timed(phase_files_flux_weights)
    del trainer  # free the FLUX model: the CLI loads its own, then the Qwen one loads
    gc.collect()
    torch.cuda.empty_cache()
    t_d = time.perf_counter()
    d_flux = timed(phase_data_flux_cli)
    t_d = time.perf_counter() - t_d
    k5_case = timed(phase_rq_kernel)
    rowquant_case = k5_case.pop("rowquant")
    qwen, (k3_qwen, k5_qwen, rq_qwen) = timed(phase_qwen_predict)
    k5b_case = timed(phase_rq_bwd_kernel)
    rowquant_g_case = k5b_case.pop("rowquant")
    b_fit, qwen_lora = timed(phase_qwen_train, qwen)
    k5_qt, k5b_qt, k3_qt, k4_qt, rq_qt = b_fit[2], b_fit[3], b_fit[8], b_fit[9], b_fit[10]
    k1_int8_case, k2_int8_case = timed(phase_kernel_int8)
    qwen_a, _ = _qwen_cut(QWEN_832X576, AC_BLOCKS)  # path A: path B's config, cut in depth
    k1_a, k5_a, rq_a = timed(phase_qwen512_predict, qwen_a)
    a_fit = timed(phase_qwen512_train, qwen_a)
    del qwen_a
    gc.collect()
    torch.cuda.empty_cache()
    k5_at, k5b_at, k1_at, k2_at, rq_at = a_fit[2], a_fit[3], a_fit[4], a_fit[5], a_fit[10]
    fc = timed(phase_files_qwen, qwen, qwen_lora)
    k5_fc, k3_fc, rq_fc = fc[2], fc[8], fc[10]
    t0 = time.perf_counter()
    d_qwen = timed(phase_data_qwen_fit, qwen)
    t_d += time.perf_counter() - t0
    print(f"[smoke] phase D (data layer and CLI, a + b): {t_d:.1f} s [{card}]", flush=True)
    del qwen, qwen_lora  # free the int4-requant model before path C's loads
    gc.collect()
    torch.cuda.empty_cache()
    k6_case = timed(phase_int4_kernel)
    k6b_case = timed(phase_int4_bwd_kernel)
    timed(phase_int4_wrapper_host)
    k6_case.pop("shapes"), k6b_case.pop("shapes")  # printed per shape above
    qwen_c, k1_c, k6_c = timed(phase_int4_predict)
    c_fit = timed(phase_int4_train, qwen_c)
    k1_ct, k2_ct, k6_ct, k6b_ct = c_fit[0], c_fit[1], c_fit[6], c_fit[7]
    del qwen_c  # free the int4 model before phase E's loads
    gc.collect()
    torch.cuda.empty_cache()
    t_e = time.perf_counter()
    w8_case, w8_dx_case, w8_t_case = timed(phase_w8a8_kernel)
    k1_e, k2_e, w8_e, w8_dx_e, w8_t_e, rq_e = timed(phase_w8a8_flux)
    timed(phase_quant_forms)
    k1_eq = timed(phase_qwen_int8)
    print(f"[smoke] phase E (the quantized bases JAX runs in XLA): "
          f"{time.perf_counter() - t_e:.1f} s [{card}]", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t_f = time.perf_counter()
    timed(phase_repair_probe)
    timed(phase_decoders)
    f = timed(phase_cache_pass)
    print(f"[smoke] phase F (the FLUX.1-Kontext cache pass and raw-image entry points): "
          f"{time.perf_counter() - t_f:.1f} s [{card}]", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t_g = time.perf_counter()
    with _PathShapes() as g_shapes:
        g = timed(phase_qwen_cache_pass)
        g["flux_multires"] = timed(phase_flux_multires)
    g_checked = timed(phase_path_shapes, g_shapes)
    g_all = tuple(map(sum, zip(*g.values())))  # _launch_counts' order, over phase G's paths
    print(f"[smoke] phase G (the Qwen-Image-Edit cache pass and raw-image entry points, "
          f"predict_multires for both families; each kernel then held to its plain version "
          f"at the shapes they gave it: {g_checked}): {time.perf_counter() - t_g:.1f} s "
          f"[{card}]", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    t_h = time.perf_counter()
    with _PathShapes() as h_shapes:
        h = timed(phase_klein)
        h.update(timed(phase_qwen_plus))
        h.update(timed(phase_dreamomni2))
    h_checked = timed(phase_path_shapes, h_shapes, "phase H")
    h_all = tuple(map(sum, zip(*h.values())))
    print(f"[smoke] phase H (FLUX.2-Klein, Qwen-Image-Edit-Plus and DreamOmni2 from raw "
          f"images; each kernel then held to its plain version at the shapes they gave it: "
          f"{h_checked}): {time.perf_counter() - t_h:.1f} s [{card}]", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    t_i = time.perf_counter()
    i_paths = {k: (k1, k2) + (0,) * 9 for k, (k1, k2) in timed(phase_remat_flux).items()}
    with _PathShapes() as i_shapes:
        i_paths.update(timed(phase_remat_qwen))
    i_checked = timed(phase_path_shapes, i_shapes, "phase I")
    i_all = tuple(map(sum, zip(*i_paths.values())))
    print(f"[smoke] phase I (the remat policies on FLUX.1-Kontext and the 12-block Qwen, the "
          f"out-of-memory fallback, adamw8bit; each kernel the Qwen steps launched then held "
          f"to its plain version at their shapes: {i_checked}): "
          f"{time.perf_counter() - t_i:.1f} s [{card}]", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    t_j = time.perf_counter()
    j_paths = {k: (k1, k2) + (0,) * 9 for k, (k1, k2) in timed(phase_optim).items()}
    j_all = tuple(map(sum, zip(*j_paths.values())))
    print(f"[smoke] phase J (the optax optimizers on the card against the CPU, FLUX fits under "
          f"Prodigy and Lion, async checkpoints against synchronous ones and a resume from "
          f"them): {time.perf_counter() - t_j:.1f} s [{card}]", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    t_k = time.perf_counter()
    k_table, k_paths = timed(phase_f32)
    print(f"[smoke] phase K (attention in f32 through csrc/flash_f32_fwd.cu and "
          f"csrc/flash_f32_bwd.cu, int8 scores in the s_int8 modes, in bf16 at head dims 32 / 64 "
          f"through the wgmma K3 / K4 and at head dim 96 zero-padded, the f32 FLUX fit, variant "
          f"test on the card, the first-party tokenizers): "
          f"{time.perf_counter() - t_k:.1f} s [{card}]", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    t_l = time.perf_counter()
    l_paths = timed(phase_distributed)
    l_all = tuple(map(sum, zip(*l_paths.values())))
    print(f"[smoke] phase L (a world of one under NCCL: FLUX.1-Kontext-dev's fit and path A's "
          f"int4-requant step over the FSDP2-sharded base against the unsharded runs, the "
          f"one-hop ring at path B's width against K3 / K4, the --distributed CLI): "
          f"{time.perf_counter() - t_l:.1f} s [{card}]", flush=True)

    def simt_entry(name, replaces, mode, source):
        by = {path: d[name] for path, d in k_paths.items() if d.get(name)}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "mode": mode, "launches": sum(by.values()),
                "launches_by_path": by, **k_table[name]}

    def by_path(i):
        return {**{f"qwen_pixels_{k}": v[i] for k, v in g.items() if v[i]},
                **{k: v[i] for k, v in h.items() if v[i]},
                **{k: v[i] for k, v in i_paths.items() if v[i]},
                **{k: v[i] for k, v in j_paths.items() if v[i]},
                **{k: v[i] for k, v in l_paths.items() if v[i]}}

    print(f"[smoke] wall time {time.perf_counter() - t_start:.1f} s (build included) [{card}]",
          flush=True)
    print(json.dumps({"kernels": [
        {"name": "flash_nr_fwd", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/flash_nr_fwd.cu",
         "replaces": "qflux_tpu/ops/flash_nr.py:192",
         "launches": (k1_predict + k1_train + k1_fa + k1_fb + d_flux[0] + k1_c + k1_ct + k1_e
                      + k1_eq + f["fit"][0] + f["validation"] + f["predict"] + g_all[0]
                      + h_all[0] + i_all[0] + j_all[0] + l_all[0]),
         "launches_by_path": {"predict": k1_predict, "train": k1_train,
                              "files_flux_resume": k1_fa, "files_flux_weights": k1_fb,
                              "data_flux_cli": d_flux[0],
                              "int4_predict": k1_c, "int4_train": k1_ct, "w8a8_flux": k1_e,
                              "qwen_int8": k1_eq, "cache_pass_fit": f["fit"][0],
                              "cache_pass_validation": f["validation"],
                              "cache_pass_predict": f["predict"], **by_path(0)}, **k1_case},
        {"name": "flash_nr_bwd", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/flash_nr_bwd.cu",
         "replaces": "qflux_tpu/ops/flash_nr.py:311",
         "launches": (k2_train + k2_fa + d_flux[1] + k2_ct + k2_e + f["fit"][1] + h_all[1]
                      + i_all[1] + j_all[1] + l_all[1]),
         "launches_by_path": {"train": k2_train, "files_flux_resume": k2_fa,
                              "data_flux_cli": d_flux[1], "int4_train": k2_ct,
                              "w8a8_flux": k2_e, "cache_pass_fit": f["fit"][1],
                              **by_path(1)}, **k2_case},
        {"name": "flash_fwd", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "qflux_tpu/ops/flash_attention.py:105",
         "launches": (k3_qwen + k3_qt + k3_fc + d_flux[8] + d_qwen[8] + g_all[8] + h_all[8]
                      + i_all[8] + l_all[8]),
         "launches_by_path": {"qwen_predict": k3_qwen, "qwen_train": k3_qt,
                              "files_qwen": k3_fc, "data_flux_cli": d_flux[8],
                              "data_qwen_fit": d_qwen[8], **by_path(8)}, **k3_case},
        {"name": "flash_bwd", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "qflux_tpu/ops/flash_attention.py:288, :215, :251",
         "launches": (k4_qt + d_flux[9] + d_qwen[9] + g_all[9] + h_all[9] + i_all[9]
                      + l_all[9]),
         "launches_by_path": {"qwen_train": k4_qt, "data_flux_cli": d_flux[9],
                              "data_qwen_fit": d_qwen[9], **by_path(9)}, **k4_case},
        {"name": "rq_int4_fwd", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/rq_int4_fwd.cu",
         "replaces": "qflux_tpu/ops/int4_matmul.py:268",
         "launches": (k5_qwen + k5_qt + k5_a + k5_at + k5_fc + d_qwen[2] + g_all[2] + i_all[2]
                      + l_all[2]),
         "launches_by_path": {"qwen_predict": k5_qwen, "qwen_train": k5_qt,
                              "qwen512_predict": k5_a, "qwen512_train": k5_at,
                              "files_qwen": k5_fc, "data_qwen_fit": d_qwen[2],
                              **by_path(2)}, **k5_case},
        {"name": "rq_int4_bwd", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/rq_int4_bwd.cu",
         "replaces": "qflux_tpu/ops/int4_matmul.py:286",
         "launches": k5b_qt + k5b_at + d_qwen[3] + g_all[3] + i_all[3] + l_all[3],
         "launches_by_path": {"qwen_train": k5b_qt, "qwen512_train": k5b_at,
                              "data_qwen_fit": d_qwen[3], **by_path(3)}, **k5b_case},
        {"name": "rowquant", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/rowquant.cu",
         "replaces": "not a TPU kernel: qflux_tpu/ops/quant.py:144 _rowquant, left to XLA",
         "launches": (rq_qwen + rq_qt + rq_a + rq_at + rq_fc + d_qwen[10] + rq_e + g_all[10]
                      + i_all[10] + l_all[10]),
         "launches_by_path": {"qwen_predict": rq_qwen, "qwen_train": rq_qt,
                              "qwen512_predict": rq_a, "qwen512_train": rq_at,
                              "files_qwen": rq_fc, "data_qwen_fit": d_qwen[10],
                              "w8a8_flux": rq_e, **by_path(10)},
         "g_times_s_vec": rowquant_g_case, **rowquant_case},
        {"name": "flash_nr_fwd s_int8", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/flash_nr_fwd.cu",
         "replaces": "qflux_tpu/ops/flash_nr.py:192", "mode": "s_int8",
         "launches": k1_a + k1_at + l_all[4],
         "launches_by_path": {"qwen512_predict": k1_a, "qwen512_train": k1_at,
                              **{k: v[4] for k, v in l_paths.items() if v[4]}}, **k1_int8_case},
        {"name": "flash_nr_bwd s_int8", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/flash_nr_bwd.cu",
         "replaces": "qflux_tpu/ops/flash_nr.py:311", "mode": "s_int8",
         "launches": k2_at + l_all[5],
         "launches_by_path": {"qwen512_train": k2_at,
                              **{k: v[5] for k, v in l_paths.items() if v[5]}}, **k2_int8_case},
        {"name": "int4_fwd", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/int4_fwd.cu",
         "replaces": "qflux_tpu/ops/int4_matmul.py:59",
         "launches": k6_c + k6_ct,
         "launches_by_path": {"int4_predict": k6_c, "int4_train": k6_ct}, **k6_case},
        {"name": "int4_bwd", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/int4_bwd.cu",
         "replaces": "qflux_tpu/ops/int4_matmul.py:75",
         "launches": k6b_ct, "launches_by_path": {"int4_train": k6b_ct}, **k6b_case},
        {"name": "int8_gemm", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/int8_gemm.cu",
         "replaces": "not a TPU kernel: qflux_tpu/ops/quant.py:157 dyn_int8_matmul, left to XLA",
         "launches": w8_e, "launches_by_path": {"w8a8_flux": w8_e}, **w8_case},
        {"name": "int8_gemm dx", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/int8_gemm.cu",
         "replaces": "not a TPU kernel: qflux_tpu/ops/quant.py:182 _dyn_vjp_bwd, left to XLA",
         "launches": w8_dx_e, "launches_by_path": {"w8a8_flux": w8_dx_e}, **w8_dx_case},
        {"name": "int8_transpose", "route": "cuda",
         "source": "qflux_tpu_torch/csrc/int8_gemm.cu",
         "replaces": "not a TPU kernel: the weight transpose before the W8A8 dx (XLA lays out "
                     "qflux_tpu/ops/quant.py:186's operand itself)",
         "launches": w8_t_e, "launches_by_path": {"w8a8_flux": w8_t_e}, **w8_t_case},
        simt_entry("flash_fwd f32", "qflux_tpu/ops/flash_attention.py:105",
                   "f32, head dims 32 / 64 / 128", "qflux_tpu_torch/csrc/flash_f32_fwd.cu"),
        simt_entry("flash_bwd f32", "qflux_tpu/ops/flash_attention.py:288, :215, :251",
                   "f32, head dims 32 / 64 / 128", "qflux_tpu_torch/csrc/flash_f32_bwd.cu"),
        simt_entry("flash_fwd narrow", "qflux_tpu/ops/flash_attention.py:105",
                   "bf16, head dims 32 / 64", "qflux_tpu_torch/csrc/flash_fwd.cu"),
        simt_entry("flash_bwd narrow", "qflux_tpu/ops/flash_attention.py:288, :215, :251",
                   "bf16, head dims 32 / 64", "qflux_tpu_torch/csrc/flash_bwd.cu"),
        simt_entry("flash_nr_fwd f32", "qflux_tpu/ops/flash_nr.py:192", "f32",
                   "qflux_tpu_torch/csrc/flash_f32_fwd.cu"),
        simt_entry("flash_nr_bwd f32", "qflux_tpu/ops/flash_nr.py:311", "f32",
                   "qflux_tpu_torch/csrc/flash_f32_bwd.cu"),
        simt_entry("flash_nr_fwd f32 s_int8", "qflux_tpu/ops/flash_nr.py:192", "f32 s_int8",
                   "qflux_tpu_torch/csrc/flash_f32_fwd.cu"),
        simt_entry("flash_nr_bwd f32 s_int8", "qflux_tpu/ops/flash_nr.py:311", "f32 s_int8",
                   "qflux_tpu_torch/csrc/flash_f32_bwd.cu"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        sys.exit(ab_main(sys.argv[2]) if torch.cuda.is_available() else 1)
    if len(sys.argv) == 2 and sys.argv[1] == "--data-ab":
        sys.exit(data_ab_main() if torch.cuda.is_available() else 1)
    if len(sys.argv) == 2 and sys.argv[1] == "--remat":
        sys.exit(remat_main() if torch.cuda.is_available() else 1)
    if len(sys.argv) == 2 and sys.argv[1] == "--optim":
        sys.exit(optim_main() if torch.cuda.is_available() else 1)
    if len(sys.argv) == 2 and sys.argv[1] == "--dist":
        sys.exit(dist_main() if torch.cuda.is_available() else 1)
    if len(sys.argv) == 2 and sys.argv[1] == "--f32":
        sys.exit(f32_main() if torch.cuda.is_available() else 1)
    if len(sys.argv) == 2 and sys.argv[1] == "--decode":
        sys.exit(decode_main() if torch.cuda.is_available() else 1)
    sys.exit(main())
