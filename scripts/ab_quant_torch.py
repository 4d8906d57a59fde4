"""A/B of two checkouts of the PyTorch port on one card: the row quantization
(csrc/rowquant.cu through ops/int4_matmul.rowquant_cuda) at K5a's and K5b's
shapes, and int4_dynamic's forward (ops/quant.dyn_int4_matmul) at the MLP
up-projection of a bs=1 512² FLUX step.

    python3 scripts/ab_quant_torch.py PARENT [CHANGE]

PARENT and CHANGE are unpacked checkouts (git archive); CHANGE defaults to
the checkout holding this script.  Each side runs in a process of its own
with its checkout first on sys.path, in turns parent, change, change,
parent.  Times are CUDA-event medians over ROUNDS rounds of CALLS calls;
the row quantization's CALLS launches are captured in a CUDA graph and
replayed, so that the wrapper's host time (tens of us, as long as the
kernel) does not enter, and its inputs rotate over COPIES buffers so that
no call reads a row it read the call before from L2.  Prints each case's times,
and whether every case's outputs are identical to the bit across the four
runs; writes the runs to chiprun_out/ab_quant.json.  Exits non-zero when
an output differs or the card is missing.  Imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

# (rows, K, with s_vec): K5a quantizes x over K, K5b g · s_vec over N
ROWQUANT_CASES = [(3744, 3072, False), (3744, 12288, False),
                  (3744, 3072, True), (3744, 12288, True)]
INT4_DYN_CASE = (2048, 3072, 12288)  # rows, K, N; group 128, bf16 activations
ROUNDS, CALLS, COPIES = 11, 40, 4


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _time_ms(fn, graph=False) -> float:
    """Median over ROUNDS of the mean of CALLS calls of fn(i), in ms; with
    `graph`, the CALLS calls are one CUDA graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    run = lambda: [fn(i) for i in range(CALLS)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
    out = []
    for _ in range(ROUNDS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / CALLS)
    return statistics.median(out)


def child() -> None:
    from qflux_tpu_torch.ops import int4_matmul as ti4
    from qflux_tpu_torch.ops import quant

    res = {"rowquant": {}, "int4_dynamic": {}}
    gen = torch.Generator("cuda").manual_seed(7)
    for m, k, with_sv in ROWQUANT_CASES:
        xs = [torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
              for _ in range(COPIES)]
        sv = (torch.rand(k, device="cuda", generator=gen) + 0.5) if with_sv else None
        ms = _time_ms(lambda i: ti4.rowquant_cuda(xs[i % COPIES], sv), graph=True)
        res["rowquant"][f"{m}x{k}{' s_vec' if with_sv else ''}"] = {
            "ms": ms, "digest": _digest(*ti4.rowquant_cuda(xs[0], sv))}
        del xs
    m, k, n = INT4_DYN_CASE
    w = (torch.rand(k, n, device="cuda", generator=gen) * 2 - 1) / k ** 0.5
    q4, gs = quant.quantize_kernel_int4(w, 128)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        ms = _time_ms(lambda i: quant.dyn_int4_matmul(x, q4, gs))
        res["int4_dynamic"][f"{m}x{k}x{n} forward"] = {
            "ms": ms, "digest": _digest(quant.dyn_int4_matmul(x, q4, gs))}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    res["card"] = card.stdout.strip().splitlines()[0]
    print("AB_QUANT " + json.dumps(res), flush=True)


def main(parent: str, change: str) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    here = Path(__file__).resolve()
    trees = {"parent": Path(parent).resolve(), "change": Path(change).resolve()}
    runs = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent"):
        code = ("import importlib.util, sys; sys.path.insert(0, %r); "
                "spec = importlib.util.spec_from_file_location('ab_quant', %r); "
                "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
                "m.child()" % (str(trees[tag]), str(here)))
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=trees[tag], timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_QUANT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs[tag].append(json.loads(lines[-1][len("AB_QUANT "):]))
    card = runs["change"][0]["card"]
    every = runs["parent"] + runs["change"]
    same = True
    for group in ("rowquant", "int4_dynamic"):
        for case in every[0][group]:
            p = [r[group][case]["ms"] for r in runs["parent"]]
            c = [r[group][case]["ms"] for r in runs["change"]]
            ident = all(r[group][case]["digest"] == every[0][group][case]["digest"]
                        for r in every)
            same &= ident
            print(f"[ab_quant] {group} {case}: parent {statistics.mean(p):.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in p)}), change {statistics.mean(c):.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in c)}), parent / change "
                  f"{statistics.mean(p) / statistics.mean(c):.3f}; outputs identical across "
                  f"the four runs: {ident} [{card}]", flush=True)
    out = here.parent.parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_quant.json").write_text(json.dumps(runs, indent=1))
    return 0 if same else 1


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2] if len(sys.argv) == 3 else
                  str(Path(__file__).resolve().parent.parent)))
