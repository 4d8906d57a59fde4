"""A/B on one card of the "flash" remat policy's two mechanisms in the
PyTorch port: the block's store (ops/remat.py: K1's op body keeps its out
and lse in the block's forward and returns them in the recompute) against
torch's selective checkpoint (`create_selective_checkpoint_contexts` with a
policy that must-saves K1's and K3's custom ops, a dispatch mode over every
op of every block), on FLUX.1-Kontext at full width (19 + 38 blocks, bf16,
512² with one control, S = 2,560).

    python3 scripts/ab_remat_flash_torch.py

The record of the measurement that moved "flash" onto the store (PERF.md
§6): the selective-checkpoint policy it re-creates is no path of the
package, and nothing maintains this script beyond that record.

One process, one model.  At bs=1 and bs=2, the train step of
`make_train_step` (AdamW, a rank-16 LoRA) runs under each mechanism in
turns store, selective, selective, store: WARM steps, then STEPS timed
ones each turn (host clock, the step ending in its loss read), with the
peak device memory of the turn.  First, at bs=1, one step's LoRA gradients
at a fixed noise and σ under both, compared to the bit.  Prints the
card's name and power limit, each turn's ms per step, the medians per
mechanism and their ratio; writes everything to
chiprun_out/ab_remat_flash.json.  Exits non-zero when the gradients differ
or the card is missing.  Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

WARM, STEPS = 1, 4


def _selective_remat(orig):
    """`_remat` with "flash" as torch's selective checkpoint of K1's and K3's
    custom ops (the mechanism the port used before the store)."""
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)

    from qflux_tpu_torch.ops import flash_attention, flash_nr

    def policy(ctx, op, *args, **kwargs):
        if op is flash_nr.FWD_OP or op is flash_attention.FWD_OP:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    def remat(fn, name):
        if name != "flash":
            return orig(fn, name)
        ctx = functools.partial(create_selective_checkpoint_contexts, policy)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=ctx)

    return remat


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_remat_flash_torch.py needs a CUDA GPU", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import chip_smoke as smoke
    from qflux_tpu_torch.models.flux import transformer as tflux
    from qflux_tpu_torch.ops.layers import mark_trainable
    from qflux_tpu_torch.trainer.base import Trainer, train_config
    from qflux_tpu_torch.trainer.train_step import lora_leaves, make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tt = Trainer(train_config(variant="full"), device="cuda")
    tt.load_model()
    dit, cfg = tt.bundle.dit_params, tt.bundle.dit_cfg
    gh, gw = tt.adapter.latent_grid(smoke.HEIGHT, smoke.WIDTH)
    adapter = dataclasses.replace(tt.adapter, remat_policy="flash")
    rng = np.random.default_rng(23)
    store_remat = tflux._remat
    mechanisms = {"store": store_remat, "selective": _selective_remat(store_remat)}

    def fresh_lora():
        lora = mark_trainable(tt.build_lora())
        smoke._perturb_b(lora, torch.Generator("cuda").manual_seed(24))
        return lora

    # the gradients at a fixed noise and σ
    batch = tt._device_batch(smoke._train_batch(rng, cfg, gh, gw, 1))
    gen = torch.Generator("cuda").manual_seed(25)
    noise = torch.randn(batch["image_latents"].shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    sigma = torch.full((1,), 0.6, device="cuda", dtype=torch.bfloat16)
    grads = {}
    for name, remat in mechanisms.items():
        tflux._remat = remat
        lora = fresh_lora()
        grads[name] = smoke._grads_at(dit, lora, batch, noise, sigma, adapter)
    tflux._remat = store_remat
    same = grads["store"][0] == grads["selective"][0] and all(
        torch.equal(grads["store"][1][p], grads["selective"][1][p]) for p in grads["store"][1])
    print(f"[ab_remat_flash] bs=1 LoRA gradients, store vs selective checkpoint, equal to the "
          f"bit: {same} [{card}]", flush=True)
    del grads

    out = {"card": card, "gradients_equal": same, "turns": []}
    criterion, step_cfg = tt.build_criterion(), tt._build_step_config()
    for b in (1, 2):
        batch = tt._device_batch(smoke._train_batch(rng, cfg, gh, gw, b))
        for name in ("store", "selective", "selective", "store"):
            tflux._remat = mechanisms[name]
            lora = fresh_lora()
            opt, schedule = tt.build_optimizer(lora_leaves(lora)[0])
            step = make_train_step(adapter.predict_velocity, criterion, opt, schedule, step_cfg)
            step_gen = torch.Generator("cuda").manual_seed(26)
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for i in range(WARM + STEPS):
                t0 = time.perf_counter()
                float(step(dit, lora, batch, step_gen)["loss"])
                if i >= WARM:
                    ms.append(1000 * (time.perf_counter() - t0))
            peak = torch.cuda.max_memory_allocated()
            tflux._remat = store_remat
            out["turns"].append({"bs": b, "mechanism": name, "ms": ms, "peak_bytes": peak})
            print(f"[ab_remat_flash] bs={b} {name}: ms/step {', '.join(f'{m:.1f}' for m in ms)}, "
                  f"peak mem {peak} bytes [{card}]", flush=True)
            del lora, opt, step
        for_b = [t for t in out["turns"] if t["bs"] == b]
        med = {n: statistics.median(m for t in for_b if t["mechanism"] == n for m in t["ms"])
               for n in ("store", "selective")}
        out[f"median_ms_bs{b}"] = med
        print(f"[ab_remat_flash] bs={b} median ms/step: store {med['store']:.1f}, selective "
              f"{med['selective']:.1f} (store / selective {med['store'] / med['selective']:.3f}) "
              f"[{card}]", flush=True)
    dest = root / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "ab_remat_flash.json").write_text(json.dumps(out, indent=1))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
