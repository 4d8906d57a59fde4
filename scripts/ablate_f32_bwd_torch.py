"""What two choices of the f32 K4 / K2 backward (the 3xTF32 loops of
qflux_tpu_torch/csrc/flash_f32_bwd.cu) buy, in accuracy and time, on one card:
the accumulation of the gradients and the streamed rows a step.  Each build is
a copy of csrc/ under build/f32_bwd_ablation/<name>/ with text substitutions,
built into a library of its own by scripts/ablate_common.py (flash_f32_bwd.cu
and flash_simt.cu, whose prep and rope + norm backward the K2 entry calls):

    python3 scripts/ablate_f32_bwd_torch.py [--variants base,r64] [--head-dims 64]

  base        each step's gradient products into a fresh accumulator, added to
              the gradient by an FADD on the CUDA cores (FRESH = true);
  accumulate  the gradients accumulated across the steps by the tensor cores;
  r32         32 streamed rows a step at every head dim;
  r64         64 at D = 32 and 64 (base takes 32 in the D = 64 dk / dv pass,
              where 64 goes wrong);
  r64_no_grad_lo  r64 without the gradients' hi lo and lo hi products.

Every build's ptxas log is searched for the notes by which ptxas says it
serialized wgmmas (C7514, C7515, C7518, C7520) and for spills, printed per build with
the registers of the loop kernels.  At every case each build's dq, dk and dv
(and each one's two head-dim halves) are held to the plain version
(`flash_bwd_reference`, relative L2; the f32 gradients' bound is 1e-4,
chip_smoke.py's F32_GRAD_TOL) and timed (CUDA-event median of 5 windows of 5
back-to-back calls into preallocated outputs, the delta pass included), in
turns the first build, the others, the first.  The cases: the smoke's f32 K4
cases (phase K(a)), then, for the error alone, Sq = 256 against Sk = 4000 (dq
sums over 4000 keys) and Sq = 4000 against Sk = 256 (dk / dv over 4000 q rows)
at each head dim; then K2 in f32 at FLUX's S = 2560 (`qflux_f32_nr_bwd`, prep
and rope + norm backward included) against `flash_attention_nr_bwd_reference`.
Prints the card's name and power limit; writes chiprun_out/ablate_f32_bwd.json.
Exits non-zero without a card, when a build fails or a launch errs.  Imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

import ablate_common as ab
from ablate_common import ROOT
from qflux_tpu_torch.ops import flash_nr as fnr
from qflux_tpu_torch.ops.flash_attention import flash_bwd_reference, flash_fwd_reference

OUT = ROOT / "build" / "f32_bwd_ablation"
SRC = "flash_f32_bwd.cu"
VARIANTS = {
    "base": [],
    "accumulate": [("constexpr bool FRESH = true;", "constexpr bool FRESH = false;")],
    "r32": [("static constexpr int R = HD == 128 || (HD == 64 && !DQ) ? 32 : 64;",
             "static constexpr int R = 32;")],
    "r64": [("static constexpr int R = HD == 128 || (HD == 64 && !DQ) ? 32 : 64;",
             "static constexpr int R = HD == 128 ? 32 : 64;")],
}
# r64 without the gradients' two correction products (hi lo, lo hi): at D = 64 its
# wrong gradients are not a missing correction
VARIANTS["r64_no_grad_lo"] = VARIANTS["r64"] + [
    ("        wgmma_tf32_rs<JN>(acc, ahi[kk], desc_f32(el, OWN, nbase, kk), 1);",
     "        (void)el;"),
    ("        wgmma_tf32_rs<JN>(acc, alo[kk], desc_f32(eh, OWN, nbase, kk), 1);", "        ;")]
ENTRIES = ("qflux_f32_bwd", "qflux_f32_nr_bwd")
# B, Sq, Sk, H, D, ids, timed: the smoke's f32 K4 cases, then long sums
CASES = ([(1, 4000, 4000, 24, 128, "text_pad", True), (1, 2000, 2000, 48, 64, "hop", True),
          (2, 777, 777, 8, 32, None, True)]
         + [(1, 256, 4000, 4, d, None, False) for d in (128, 64, 32)]
         + [(1, 4000, 256, 4, d, None, False) for d in (128, 64, 32)])
K2_S = 2560


def _k4_case(libs, order, gen, stream, card, b, sq, sk, h, d, ids, timed) -> dict:
    q, k, v, q_seg, kv_seg = ab.flash_inputs(gen, b, sq, sk, h, d, ids)
    qp = None if q_seg is None else q_seg.data_ptr()
    kp = None if kv_seg is None else kv_seg.data_ptr()
    scale = d ** -0.5
    out, lse = flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
    out = out.contiguous()  # the plain version's out is a permuted view
    do = torch.randn(q.shape, device="cuda", generator=gen)
    ref = flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    delta = torch.empty(b, h, sq, device="cuda")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def bwd(lib):
        return lambda: lib.qflux_f32_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp, kp,
                                         out.data_ptr(), lse.data_ptr(), do.data_ptr(),
                                         delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                         dv.data_ptr(), b, sq, sk, h, d, scale, stream)

    errs, same = {}, {}
    for name in libs:
        if bwd(libs[name])() != 0:
            raise SystemExit(f"{name}: a launch returned a CUDA error")
        torch.cuda.synchronize()
        got = [t.clone() for t in (dq, dk, dv)]
        # by gradient, then by halves of the head dim
        errs[name] = [ab.rel(g, r) for g, r in zip(got, ref)] + [
            ab.rel(g[..., hf * d // 2:(hf + 1) * d // 2], r[..., hf * d // 2:(hf + 1) * d // 2])
            for g, r in zip(got, ref) for hf in (0, 1)]
        bwd(libs[name])()
        torch.cuda.synchronize()
        same[name] = all(torch.equal(g, t) for g, t in zip(got, (dq, dk, dv)))
    times = [(n, ab.ms(bwd(libs[n]))) for n in order] if timed else []
    label = f"B={b} Sq={sq} Sk={sk} H={h} D={d} ids={ids or 'none'}"
    print(f"[ablate] K4 f32 {label}: rel L2 dq / dk / dv " + ", ".join(
        f"{n} {e[0]:.2e} / {e[1]:.2e} / {e[2]:.2e} (halves " + " ".join(f"{x:.1e}" for x in e[3:])
        + f"; two calls identical {same[n]})"
        for n, e in errs.items())
        + ("; K4 " + ", ".join(f"{n} {t:.4f}" for n, t in times) + " ms" if times else "")
        + f" [{card}]", flush=True)
    return {"case": label, "rel_l2_dq_dk_dv": errs, "identical": same, "k4_ms": times}


def _k2_case(libs, order, gen, stream, card, s) -> dict:
    b, h, d, st = 1, 24, 128, 512
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen) for _ in range(3))
    qs2, ks2 = (1 + 0.1 * torch.randn(2, d, device="cuda", generator=gen) for _ in range(2))
    pos = torch.arange(s, device="cuda", dtype=torch.float32)[:, None]
    freq = torch.arange(d, device="cuda", dtype=torch.float32)[None] / d
    cos, sin = torch.cos(pos * freq).contiguous(), torch.sin(pos * freq).contiguous()
    seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
    seg[0, 492:512] = 0
    scale = d ** -0.5
    args = (q, k, v, qs2, ks2, cos, sin)
    out, lse = fnr.flash_attention_nr_reference(*args, st, segment_ids=seg, scale=scale)
    out = out.contiguous()
    do = torch.randn(q.shape, device="cuda", generator=gen)
    ref = fnr.flash_attention_nr_bwd_reference(*args, st, do, segment_ids=seg, scale=scale)
    n_tiles = -(-s // 64)  # qflux_flash_nr_bwd_tiles
    qn, kn, dqn, dkn = (torch.empty_like(q) for _ in range(4))
    delta = torch.empty(b, h, s, device="cuda")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dqs, dks = (torch.empty(b, h, n_tiles, 2, d, device="cuda") for _ in range(2))

    def bwd(lib):
        return lambda: lib.qflux_f32_nr_bwd(
            *(t.data_ptr() for t in args), 0, seg.data_ptr(), out.data_ptr(), lse.data_ptr(),
            do.data_ptr(), qn.data_ptr(), kn.data_ptr(), delta.data_ptr(), dqn.data_ptr(),
            dkn.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dqs.data_ptr(),
            dks.data_ptr(), b, s, h, st, scale, stream)

    errs = {}
    for name in libs:
        if bwd(libs[name])() != 0:
            raise SystemExit(f"{name}: a K2 launch returned a CUDA error")
        torch.cuda.synchronize()
        got = (dq, dk, dv, dqs.sum(dim=(0, 1, 2)), dks.sum(dim=(0, 1, 2)))
        errs[name] = [ab.rel(g, r) for g, r in zip(got, ref)]
    times = [(n, ab.ms(bwd(libs[n]))) for n in order]
    print(f"[ablate] K2 f32 B=1 S={s} H=24 D=128 st=512: rel L2 dq / dk / dv / dqs / dks "
          + ", ".join(f"{n} " + " / ".join(f"{x:.2e}" for x in e) for n, e in errs.items())
          + "; K2 " + ", ".join(f"{n} {t:.4f}" for n, t in times) + " ms (prep and rope + "
          f"norm backward included) [{card}]", flush=True)
    return {"case": f"K2 S={s}", "rel_l2": errs, "k2_ms": times}


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_f32_bwd_torch.py needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = ab.card()
    print(card, flush=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="base,accumulate,r32,r64",
                    help=f"comma-separated builds among {', '.join(VARIANTS)} (base first)")
    ap.add_argument("--head-dims", default="128,64,32", help="the K4 cases' head dims")
    opts = ap.parse_args()
    names = opts.variants.split(",")
    dims = {int(x) for x in opts.head_dims.split(",")}
    built = ab.build(OUT, {n: [(SRC, old, new) for old, new in VARIANTS[n]] for n in names},
                     (SRC, "flash_simt.cu"), ENTRIES)
    libs = {}
    for name, (lib, log) in built.items():
        print(f"[ablate] {name} ptxas: {ab.ptxas_notes(log, 'flash_f32_bwd_kernel')}",
              flush=True)
        libs[name] = lib
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator("cuda").manual_seed(0)
    res = {"card": card, "cases": []}
    order = [names[0], *names[1:], names[0]]
    for case in CASES:
        if case[4] in dims:
            res["cases"].append(_k4_case(libs, order, gen, stream, card, *case))
            torch.cuda.empty_cache()
    if 128 in dims:
        res["cases"].append(_k2_case(libs, order, gen, stream, card, K2_S))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ablate_f32_bwd.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
