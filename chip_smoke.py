#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qflux_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — FLUX.1-Kontext-dev predict from cached
embeddings at 512² with one 512² control image, full width (19 dual + 38
single blocks, synthetic bf16 weights from a seed), a rank-16 LoRA on
to_q/to_k/to_v/to_out, 20 Euler steps, full f32 VAE decode — in phases:

  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: the hand-written kernels from qflux_tpu_torch/csrc;
  3. kernel K1 (csrc/flash_nr_fwd.cu) against its plain PyTorch version on
     the card, at the main path's shapes and at longer/masked ones, with
     median times over 10 runs;
  4. the slice: one full-width forward through K1 and through the plain
     attention (relative L2 error), then three requests through
     Trainer.predict_from_embeddings, each checked for uint8 images, finite
     latents and exactly 57 × 20 kernel launches.

Prints the kernel table as one JSON line before the last, and as the last
line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, without that line, if there is no CUDA device or any phase
fails.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
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
STEPS = 20
HEIGHT = WIDTH = 512


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


def _attn_inputs(gen, b, s, h=24, d=128):
    dev = "cuda"
    q, k, v = (torch.randn(b, s, h, d, device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    qs2 = (1 + 0.1 * torch.randn(2, d, device=dev, generator=gen)).to(torch.bfloat16)
    ks2 = (1 + 0.1 * torch.randn(2, d, device=dev, generator=gen)).to(torch.bfloat16)
    ang = torch.rand(s, d // 2, device=dev, generator=gen) * 6.28
    cos = torch.cat([ang.cos()] * 2, -1).contiguous()
    sin = torch.cat([ang.sin()] * 2, -1).contiguous()
    return q, k, v, qs2, ks2, cos, sin


def phase_kernel(card: str) -> dict:
    from qflux_tpu_torch.ops import flash_nr

    gen = torch.Generator("cuda").manual_seed(0)
    cases = [  # name, B, S, st, segment ids
        ("dual_512sq", 1, 2560, 512, None),
        ("single_512sq", 1, 2560, 0, None),
        ("masked_bs2", 2, 2560, 512, "masked"),
        ("832x576", 1, 4256, 512, None),
        ("s8192", 1, 8192, 512, None),
    ]
    main = None
    for name, b, s, st, seg_kind in cases:
        args = _attn_inputs(gen, b, s)
        seg = None
        if seg_kind:
            seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
            seg[0, 2100:] = 0          # sample 0 padded from token 2100
            seg[1, 1300:] = 2          # sample 1: two segments
        out, lse = flash_nr.flash_attention_nr(*args, st, segment_ids=seg)
        torch.cuda.synchronize()
        ref, ref_lse = flash_nr.flash_attention_nr_reference(*args, st, segment_ids=seg)
        err = (out.float() - ref.float()).abs().max().item()
        valid = ref_lse > -1e29
        lse_err = (lse - ref_lse).abs()[valid].max().item()
        ok = err <= OUT_ATOL and lse_err <= LSE_ATOL and bool(torch.isfinite(out).all())
        if seg_kind:
            ok = ok and bool((out[0, 2100:] == 0).all())
        ms = _median_ms(lambda: flash_nr.flash_attention_nr(*args, st, segment_ids=seg))
        plain_ms = _median_ms(
            lambda: flash_nr.flash_attention_nr_reference(*args, st, segment_ids=seg))
        gflop = 4.0 * b * 24 * s * s * 128 / 1e9
        print(f"[kernel] {name}: B={b} S={s} H=24 D=128 st={st} seg={seg_kind or 'none'} "
              f"max_abs_err(out)={err:.3e} (tol {OUT_ATOL}) max_abs_err(lse)={lse_err:.3e} "
              f"(tol {LSE_ATOL}) kernel {ms:.3f} ms ({gflop / ms:.1f} TFLOP/s) "
              f"plain {plain_ms:.3f} ms [{card}]", flush=True)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version in case {name}")
        if main is None:
            main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del args, out, lse, ref, ref_lse
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


def phase_slice(card: str) -> int:
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
    for leaf in lora.values():
        # b ~ N(0, 0.005²): the LoRA delta is then about a tenth of the base
        # projection, so the adapter visibly changes the output
        leaf["b"].normal_(0.0, 0.005, generator=gen)
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
        if images.dtype != np.uint8 or images.shape != (b, HEIGHT, WIDTH, 3):
            raise AssertionError(f"request {i}: images {images.dtype} {images.shape}")
        if not stats["latents_finite"]:
            raise AssertionError(f"request {i}: non-finite latents")
        if launched != per_request:
            raise AssertionError(f"request {i}: {launched} K1 launches, expected {per_request}")
    return flash_nr.KERNEL_LAUNCHES


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

    t0 = time.perf_counter()
    kl = load_library()
    ptxas = [ln.strip() for ln in kl.log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"[build] {kl.path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kl.build_seconds:.2f} s): {' | '.join(ptxas)} [{card}]", flush=True)

    main_case = phase_kernel(card)
    launches = phase_slice(card)

    print(json.dumps({"kernels": [{
        "name": "flash_nr_fwd", "route": "cuda",
        "source": "qflux_tpu_torch/csrc/flash_nr_fwd.cu",
        "replaces": "qflux_tpu/ops/flash_nr.py:192",
        "launches": launches, **main_case}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
