"""What two choices of the f32 K3 (the 3xTF32 loop of
qflux_tpu_torch/csrc/flash_f32_fwd.cu) buy, in accuracy and time, on one card.
Each ablation is a copy of csrc/ under build/f32_ablation/<name>/ with text
substitutions, built into a library of its own by scripts/ablate_common.py
(flash_f32_fwd.cu and flash_simt.cu, whose prep the K1 entry calls), and run
beside the unchanged copy ("base"):

    python3 scripts/ablate_f32_flash_torch.py

  accumulate  P V accumulated in O across the key tiles by the tensor cores
              (O rescaled by alpha first), as the bf16 loop does, instead of
              a fresh accumulator a tile added to O on the CUDA cores;
  pv_n64      P V in chunks of 64 columns of O (wgmma m64n64k8, the shape
              of S's lo_q hi_k product) instead of 32, at D = 64 and 128.

At every case each build's out and lse are held to the plain version
(`flash_fwd_reference`, relative L2; the f32 modes' bound is 2e-5) and timed
(CUDA-event median of 5 windows of 10 back-to-back calls into preallocated
outputs), in turns base, variants, base.  The cases: the smoke's f32 K3
cases (phase K(a)) and, for the error alone, Sq = 256 against Sk = 4000 at
each head dim.  Prints the card's name and power limit; writes
chiprun_out/ablate_f32.json.  Exits non-zero without a card or when a build
fails.  Imports no JAX.
"""

from __future__ import annotations

import json
import sys

import torch

import ablate_common as ab
from ablate_common import ROOT
from qflux_tpu_torch.ops.flash_attention import flash_fwd_reference

OUT = ROOT / "build" / "f32_ablation"
SRC = "flash_f32_fwd.cu"
VARIANTS = {
    "base": [],
    "accumulate": [
        ("        wgmma_tf32_rs<PV_N>(pv, phi[kk], desc_f32(vhc, HD, 0, kk), kk > 0);",
         "        wgmma_tf32_rs<PV_N>(pv, phi[kk], desc_f32(vhc, HD, 0, kk), 1);"),
        ("      float pv[PV_N / 2];\n",
         "      float (&pv)[PV_N / 2] = reinterpret_cast<float(&)[PV_N / 2]>(o[PV_N / 2 * ch]);\n"),
        ("        o[PV_N / 2 * ch + x] = fmaf(o[PV_N / 2 * ch + x], alpha[(x >> 1) & 1], pv[x]);",
         "        (void)x;"),
        ("    mbar_wait(&full_v[s], use);\n",
         "#pragma unroll\n    for (int x = 0; x < HD / 2; ++x) o[x] *= alpha[(x >> 1) & 1];\n"
         "    mbar_wait(&full_v[s], use);\n")],
    "pv_n64": [("constexpr int PV_N = I8 ? HD : 32;",
                "constexpr int PV_N = I8 ? HD : HD == 32 ? 32 : 64;")],
}
# B, Sq, Sk, H, D, ids, timed: the smoke's f32 K3 cases, then long key ranges
CASES = [(1, 4000, 4000, 24, 128, "text_pad", True), (1, 2000, 2000, 48, 64, "hop", True),
         (2, 777, 777, 8, 32, None, True)] + [(1, 256, 4000, 4, d, None, False)
                                              for d in (128, 64, 32)]


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_f32_flash_torch.py needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = ab.card()
    print(card, flush=True)
    built = ab.build(OUT, {n: [(SRC, old, new) for old, new in patches]
                           for n, patches in VARIANTS.items()},
                     (SRC, "flash_simt.cu"), ("qflux_f32_fwd",))
    libs = {}
    for name, (lib, log) in built.items():
        print(f"[ablate] {name} ptxas: {ab.ptxas_notes(log)}", flush=True)
        libs[name] = lib
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator("cuda").manual_seed(0)
    res = {"card": card, "cases": []}
    order = ["base", *[n for n in VARIANTS if n != "base"], "base"]
    for b, sq, sk, h, d, ids, timed in CASES:
        q, k, v, q_seg, kv_seg = ab.flash_inputs(gen, b, sq, sk, h, d, ids)
        qp = None if q_seg is None else q_seg.data_ptr()
        kp = None if kv_seg is None else kv_seg.data_ptr()
        scale = d ** -0.5
        ref, ref_lse = flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
        live = ref_lse > -1e29
        out = torch.empty_like(q)
        lse = torch.empty(b, h, sq, device="cuda")

        def fwd(lib):
            return lambda: lib.qflux_f32_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp, kp,
                                             out.data_ptr(), lse.data_ptr(), b, sq, sk, h, d,
                                             scale, stream)

        errs = {}
        for name in VARIANTS:
            if fwd(libs[name])() != 0:
                raise SystemExit(f"{name}: a launch returned a CUDA error")
            torch.cuda.synchronize()
            errs[name] = [ab.rel(out, ref), ab.rel(lse[live], ref_lse[live])]
        times = [(n, ab.ms(fwd(libs[n]), 10)) for n in order] if timed else []
        label = f"B={b} Sq={sq} Sk={sk} H={h} D={d} ids={ids or 'none'}"
        print(f"[ablate] {label}: rel L2 out / lse " + ", ".join(
            f"{n} {e[0]:.2e} / {e[1]:.2e}" for n, e in errs.items())
            + ("; K3 " + ", ".join(f"{n} {t:.4f}" for n, t in times) + " ms" if times else "")
            + f" [{card}]", flush=True)
        res["cases"].append({"case": label, "rel_l2_out_lse": errs, "k3_ms": times})
        del q, k, v, ref, ref_lse, out, lse
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ablate_f32.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
