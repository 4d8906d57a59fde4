"""What the choices of the f32 s_int8 loops (K1 / K2 in f32 with
`quantize.attention`: qflux_f32_nr_int8_fwd / _bwd of
qflux_tpu_torch/csrc/flash_f32_fwd.cu / flash_f32_bwd.cu) buy in time on one
card, each checked to leave every value as it was.  Each build is a copy of
csrc/ under build/f32_int8_ablation/<name>/ with text substitutions, built
into a library of its own by scripts/ablate_common.py (the two loop files and
flash_simt.cu, whose prep and rope + norm backward the entries call):

    python3 scripts/ablate_f32_int8_torch.py [--variants base,pv_chunks]

  base         the tree as it is;
  pv_chunks    the forward's P V in four m64n32k8 chunks, each waited for (the
               plain f32 loop's form), not one m64n128k8;
  s1_split     the backward's producer also splits S1 (q in dk / dv, k in dq)
               into hi / lo tiles, which the consumers read, where base keeps
               it raw and the consumers split its fragments as they load them;
  own_hi_smem  dp's own hi operand from shared memory (two of its three
               products ss), not from registers.

Every build's ptxas log is searched for the notes by which ptxas says it
serialized wgmmas (C7514, C7515, C7518, C7520) and for spills.  At S = 2304
and 2560 (FLUX's layout: B = 1, H = 24, D = 128, st = 512 with 20 padding
text rows; the q tiles of `s_int8_tiles`) each build's out / lse (K1) and dq /
dk / dv / scale gradients (K2, from base's out / lse) are compared with base's
bit for bit and with the plain versions on the prep's own qn / kn (relative
L2; chip_smoke.py's F32_REL_TOL 2e-5 and F32_GRAD_TOL 1e-4), and K1 and K2 are
timed, prep included (CUDA-event median of 5 windows of 5 back-to-back calls
into preallocated outputs), in turns: base, the others, base.  Prints the
card's name and power limit; writes chiprun_out/ablate_f32_int8.json.  Exits
non-zero without a card, when a build fails or a launch errs, or when a build's
values differ from base's.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

import ablate_common as ab
from ablate_common import ROOT
from qflux_tpu_torch.ops import flash_nr as fnr

OUT = ROOT / "build" / "f32_int8_ablation"
SOURCES = ("flash_f32_fwd.cu", "flash_f32_bwd.cu", "flash_simt.cu")
FWD, BWD = "flash_f32_fwd.cu", "flash_f32_bwd.cu"
VARIANTS = {
    "base": [],
    "pv_chunks": [(FWD, "  constexpr int PV_N = I8 ? HD : 32;", "  constexpr int PV_N = 32;")],
    "s1_split": [
        (BWD, "      for (int j = I8 ? 1 : 0; j < 2; ++j) {", "      for (int j = 0; j < 2; ++j) {"),
        (BWD, "          if (I8 && pr != 0) {  // the raw S1 tile", "          if (false) {")],
    "own_hi_smem": [
        (BWD, "      if constexpr (I8)\n        ohi[kk][e] = hi;\n      else\n"
              "        *reinterpret_cast<uint32_t*>(ot + off) = hi;",
         "      if constexpr (I8) ohi[kk][e] = hi;\n"
         "      *reinterpret_cast<uint32_t*>(ot + off) = hi;"),
        (BWD, "  if constexpr (!I8) {\n    fence_proxy_async();\n    warpgroup_sync(c);\n  }",
         "  fence_proxy_async();\n  warpgroup_sync(c);"),
        (BWD, "wgmma_tf32_rs<R>(x, ohi[kk], desc_f32(sh, R, 0, kk0 + kk), kk > 0);",
         "wgmma_tf32_ss<R>(x, desc_f32(oh, OWN, 0, kk0 + kk), desc_f32(sh, R, 0, kk0 + kk), "
         "kk > 0);"),
        (BWD, "wgmma_tf32_rs<R>(x, ohi[kk], desc_f32(sl, R, 0, kk0 + kk), 1);",
         "wgmma_tf32_ss<R>(x, desc_f32(oh, OWN, 0, kk0 + kk), desc_f32(sl, R, 0, kk0 + kk), 1);")],
}
ENTRIES = ("qflux_f32_nr_int8_fwd", "qflux_f32_nr_int8_bwd", "qflux_simt_nr_prep")
CASES = (2304, 2560)
F32_REL_TOL, F32_GRAD_TOL = 2e-5, 1e-4


def _case(libs, order, gen, stream, card, s) -> tuple[dict, bool]:
    b, h, d, st = 1, 24, 128, 512
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen) for _ in range(3))
    qs2, ks2 = (1 + 0.1 * torch.randn(2, d, device="cuda", generator=gen) for _ in range(2))
    ang = torch.rand(s, d // 2, device="cuda", generator=gen) * 6.28
    cos = torch.cat([ang.cos()] * 2, -1).contiguous()
    sin = torch.cat([ang.sin()] * 2, -1).contiguous()
    seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
    seg[0, 492:512] = 0
    scale = d ** -0.5
    args = (q, k, v, qs2, ks2, cos, sin)
    fwd_rows, bwd_rows = fnr.s_int8_tiles(s, d)
    qs, ks, csb, seg32 = fnr._kernel_args(q, k, v, qs2, ks2, cos, sin, seg)
    qn, kn, dqn, dkn = (torch.empty_like(q) for _ in range(4))
    qq, kq = (torch.empty(q.shape, device="cuda", dtype=torch.int8) for _ in range(2))
    amax = {r: torch.empty(b, h, 1 + -(-s // r), device="cuda", dtype=torch.int32)
            for r in (fwd_rows, bwd_rows)}
    out, lse = torch.empty_like(q), torch.empty(b, h, s, device="cuda")
    delta = torch.empty(b, h, s, device="cuda")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    parts = [torch.empty(b, h, -(-s // 64), 2, d, device="cuda") for _ in range(2)]
    p = [t.data_ptr() for t in (q, k, v, qs, ks, cos, sin)]

    def fwd(lib):
        return lambda: lib.qflux_f32_nr_int8_fwd(
            *p, csb, seg32.data_ptr(), qn.data_ptr(), kn.data_ptr(), qq.data_ptr(), kq.data_ptr(),
            amax[fwd_rows].data_ptr(), fwd_rows, out.data_ptr(), lse.data_ptr(), b, s, h, st,
            scale, stream)

    def bwd(lib, o, ls):
        return lambda: lib.qflux_f32_nr_int8_bwd(
            *p, csb, seg32.data_ptr(), o.data_ptr(), ls.data_ptr(), do.data_ptr(), qn.data_ptr(),
            kn.data_ptr(), delta.data_ptr(), dqn.data_ptr(), dkn.data_ptr(), qq.data_ptr(),
            kq.data_ptr(), amax[bwd_rows].data_ptr(), bwd_rows, dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *(t.data_ptr() for t in parts), b, s, h, st, scale, stream)

    do = torch.randn(q.shape, device="cuda", generator=gen)
    got = {}
    for name in libs:
        if fwd(libs[name])() != 0:
            raise SystemExit(f"{name}: a launch returned a CUDA error")
        torch.cuda.synchronize()
        got[name] = [out.clone(), lse.clone()]
        if name == "base":
            normed = (qn.clone(), kn.clone())
    o_base, l_base = got["base"]
    for name in libs:
        if bwd(libs[name], o_base, l_base)() != 0:
            raise SystemExit(f"{name}: a launch returned a CUDA error")
        torch.cuda.synchronize()
        got[name] += [dq.clone(), dk.clone(), dv.clone(), *(t.sum(dim=(0, 1, 2)) for t in parts)]
    ref, ref_lse = fnr.flash_attention_nr_int8_reference(*args, st, fwd_rows, segment_ids=seg,
                                                         scale=scale, normed=normed)
    live = ref_lse > -1e29
    want = fnr.flash_attention_nr_int8_bwd_reference(*args, st, do, o_base, l_base, bwd_rows,
                                                     segment_ids=seg, scale=scale, normed=normed)
    errs = {n: [ab.rel(g[0], ref), ab.rel(g[1][live], ref_lse[live])]
            + [ab.rel(x, w) for x, w in zip(g[2:], want)] for n, g in got.items()}
    same = {n: all(torch.equal(x, y) for x, y in zip(g, got["base"])) for n, g in got.items()}
    k1 = [(n, ab.ms(fwd(libs[n]))) for n in order]
    k2 = [(n, ab.ms(bwd(libs[n], o_base, l_base))) for n in order]
    label = f"B={b} S={s} H={h} D={d} st={st}, q tiles {fwd_rows} / {bwd_rows}"
    print(f"[ablate] f32 s_int8 {label}: rel L2 against the plain versions (out, lse; dq, dk, dv, "
          f"dqs, dks) " + "; ".join(f"{n} " + " ".join(f"{x:.2e}" for x in e)
                                    + f" (equal to base: {same[n]})" for n, e in errs.items())
          + "; K1 " + ", ".join(f"{n} {t:.4f}" for n, t in k1) + " ms; K2 "
          + ", ".join(f"{n} {t:.4f}" for n, t in k2) + f" ms [{card}]", flush=True)
    ok = all(same.values()) and all(e[0] <= F32_REL_TOL and e[1] <= F32_REL_TOL
                                    and max(e[2:]) <= F32_GRAD_TOL for e in errs.values())
    return {"case": label, "rel_l2": errs, "equal_to_base": same, "k1_ms": k1, "k2_ms": k2}, ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    names = ap.parse_args().variants.split(",")
    if "base" not in names:
        names = ["base"] + names
    if not torch.cuda.is_available():
        print("ablate_f32_int8_torch.py: no CUDA device", file=sys.stderr)
        return 1
    card = ab.card()
    print(card, flush=True)
    built = ab.build(OUT, {n: VARIANTS[n] for n in names}, SOURCES, ENTRIES)
    libs, builds = {}, {}
    for n, (lib, log) in built.items():
        builds[n] = ab.ptxas_notes(log)
        print(f"[ablate] build {n}: {builds[n]} [{card}]", flush=True)
        libs[n] = lib
    order = names + ["base"]
    gen = torch.Generator("cuda").manual_seed(25)
    stream = torch.cuda.current_stream().cuda_stream
    cases, ok = [], True
    for s in CASES:
        res, case_ok = _case(libs, order, gen, stream, card, s)
        cases.append(res)
        ok = ok and case_ok
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ablate_f32_int8.json").write_text(json.dumps(
        {"card": card, "builds": builds, "cases": cases}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
