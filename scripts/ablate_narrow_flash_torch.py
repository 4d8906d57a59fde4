"""Where the narrow K3 / K4 (bf16 at head dims 32 / 64, the wgmma loops of
qflux_tpu_torch/csrc/flash_fwd_hopper.cuh and flash_bwd_hopper.cuh) spend
their time on one card.  Each ablation is a copy of csrc/ under
build/narrow_ablation/<name>/ with one text substitution, built into a
library of its own by scripts/ablate_common.py (flash_fwd.cu and flash_bwd.cu
only), and timed at the narrow shapes beside the unchanged copy ("base"):

    python3 scripts/ablate_narrow_flash_torch.py

  no_ahead    the narrow forward without its look-ahead (tile i + 1's scores
              issued before tile i's softmax): the D = 128 loop;
  no_turns    the narrow forward without the warpgroups' turns;
  no_uniform  the forward and backward without the tile-uniform mask skip
              (every tile of a masked call takes the per-score mask);
  stages2     the narrow forward with a K/V ring of two stages, as at D = 128,
              instead of four.

Each leaves the outputs as they were; only the times are compared.
Every build's ptxas log is searched for the notes by which ptxas says it
serialized wgmmas (C7514, C7515, C7518, C7520) and for spills, printed per
build.  Times of K3 and
K4 are CUDA-event medians of 5 windows of back-to-back calls into
preallocated outputs (10 calls forward, 5 backward), in turns base,
variants, base.  The base's K4 is also split by kernel (delta, dk / dv, dq)
under torch.profiler.
Prints the card's name and power limit; writes chiprun_out/ablate_narrow.json.
Exits non-zero without a card or when a build fails.  Imports no JAX.
"""

from __future__ import annotations

import json
import sys

import torch

import ablate_common as ab
from ablate_common import ROOT

OUT = ROOT / "build" / "narrow_ablation"
FWD = "flash_fwd_hopper.cuh"
BWD = "flash_bwd_hopper.cuh"
VARIANTS = {
    "base": [],
    "no_ahead": [(FWD, "  if constexpr (NARROW) {\n    // One tile further ahead",
                  "  if constexpr (false) {\n    // One tile further ahead")],
    "no_turns": [(FWD, "    if constexpr (NARROW) turn_take(c);", ""),
                 (FWD, "    if constexpr (NARROW) turn_pass(c, last);", ""),
                 (FWD, "  if constexpr (NARROW) turns_start(c);", "")],
    "no_uniform": [(FWD, "UNIFORM = NARROW && SEG;", "UNIFORM = false;"),
                   (BWD, "    if constexpr (HD < 128) {\n      const int u =",
                    "    if constexpr (false) {\n      const int u =")],
    "stages2": [(FWD, "STAGES = HD == 128 ? 2 : 4;", "STAGES = 2;")],
}
# B, S, H, D, ids: the smoke's narrow cases (text padding as path B's, a ring
# hop), the table's shape unmasked, and D = 128 for reference
CASES = [(1, 4000, 48, 64, "text_pad"), (1, 4000, 48, 64, None), (1, 2000, 8, 32, "hop"),
         (1, 4000, 24, 128, "text_pad")]


def _inputs(gen, b, s, h, d, ids):
    q, k, v, q_seg, kv_seg = ab.flash_inputs(gen, b, s, s, h, d, ids)
    do = torch.randn(q.shape, device="cuda", generator=gen)
    return (*(t.bfloat16() for t in (q, k, v, do)), q_seg, kv_seg)


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_narrow_flash_torch.py needs a CUDA card", file=sys.stderr)
        return 1
    card = ab.card()
    print(card, flush=True)
    built = ab.build(OUT, VARIANTS, ("flash_fwd.cu", "flash_bwd.cu"),
                     ("qflux_flash_fwd", "qflux_flash_bwd"))
    libs, notes = {}, {}
    for name, (lib, log) in built.items():
        notes[name] = ab.ptxas_notes(log)
        print(f"[ablate] {name}: ptxas {notes[name]}", flush=True)
        libs[name] = lib
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator("cuda").manual_seed(0)
    res = {"card": card, "notes": notes, "cases": []}
    order = ["base", *[n for n in VARIANTS if n != "base"], "base"]
    for b, s, h, d, ids in CASES:
        q, k, v, do, q_seg, kv_seg = _inputs(gen, b, s, h, d, ids)
        qp = None if q_seg is None else q_seg.data_ptr()
        kp = None if kv_seg is None else kv_seg.data_ptr()
        out, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        lse, delta = (torch.empty(b, h, s, device="cuda") for _ in range(2))
        scale = d ** -0.5
        base = libs["base"]
        base.qflux_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp, kp, out.data_ptr(),
                             lse.data_ptr(), b, s, s, h, d, scale, stream)
        o2 = torch.empty_like(q)

        def fwd(lib):
            return lambda: lib.qflux_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp, kp,
                                               o2.data_ptr(), delta.data_ptr(), b, s, s, h, d,
                                               scale, stream)

        def bwd(lib):
            return lambda: lib.qflux_flash_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), qp, kp, out.data_ptr(), lse.data_ptr(),
                do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
                s, s, h, d, scale, stream)

        k3 = [(n, ab.ms(fwd(libs[n]), 10)) for n in order]
        k4 = [(n, ab.ms(bwd(libs[n]), 5)) for n in order]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                bwd(base)()
            torch.cuda.synchronize()
        split = {key: round(sum(e.device_time_total for e in prof.key_averages()
                                if key in e.key) / 3000, 4)
                 for key in ("flash_delta", "flash_dkv", "flash_dq")}
        label = f"B={b} S={s} H={h} D={d} ids={ids or 'none'}"
        print(f"[ablate] {label}: K3 " + ", ".join(f"{n} {t:.4f}" for n, t in k3)
              + " ms; K4 " + ", ".join(f"{n} {t:.4f}" for n, t in k4) + f" ms, split {split} "
              f"[{card}]", flush=True)
        res["cases"].append({"case": label, "k3": k3, "k4": k4, "k4_split_ms": split})
        del q, k, v, do, out, dq, dk, dv, o2
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ablate_narrow.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
