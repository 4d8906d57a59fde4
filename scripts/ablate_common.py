"""What the kernel ablation scripts (scripts/ablate_*_torch.py) share: a copy
of qflux_tpu_torch/csrc/ under build/<script's folder>/<variant>/ with text
substitutions, built by nvcc into a library of its own with the port's nvcc
flags, its entries bound by the C signatures of
qflux_tpu_torch/runtime/build.py; ptxas's notes; CUDA-event timing; the
relative L2 error; attention inputs.  Every variant is built at once, one
nvcc each.  Imports no JAX and builds nothing on import.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from qflux_tpu_torch.runtime.build import NVCC_FLAGS, _SIGNATURES  # noqa: E402

CSRC = ROOT / "qflux_tpu_torch" / "csrc"


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def _start(out: Path, name: str, patches, sources) -> subprocess.Popen:
    d = out / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(CSRC, d)
    for file, old, new in patches:
        text = (d / file).read_text()
        if old not in text:
            raise SystemExit(f"{name}: the text to substitute is not in {file}: {old!r}")
        (d / file).write_text(text.replace(old, new))
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return subprocess.Popen([nvcc, *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
                             *(str(d / s) for s in sources)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(out: Path, variants: dict, sources, entries) -> dict:
    """Builds every variant of `variants` ({name: [(file, old, new), ...]},
    each `old` required in its file) from `sources` under out/<name>/, all
    nvcc processes started together; returns {name: (library with `entries`
    bound, nvcc's log)}.  Exits when a build fails."""
    procs = {name: _start(out, name, patches, sources) for name, patches in variants.items()}
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            raise SystemExit(f"{name}: nvcc failed")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        for entry in entries:
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = _SIGNATURES[entry]
        built[name] = (lib, log)
    return built


def ptxas_notes(log: str, kernel: str | None = None) -> str:
    """ptxas's notes that it serialized a wgmma (C7514, C7515, C7518, C7520)
    and its spill lines; where `kernel` is given, also the registers and
    spills of each kernel whose name holds it."""
    notes = sorted(set(re.findall(r"C75(?:14|15|18|20)[^\n]*", log)))
    spills = sorted(set(ln.strip() for ln in log.splitlines()
                        if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln))
    text = f"{len(notes)} serialization notes {notes[:3]}, {len(spills)} spill lines {spills[:3]}"
    if kernel:
        lines, fn = [], None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
            if fn and kernel in fn and re.search(r"registers|spill", line):
                lines.append(f"{fn[-40:]}: {line.split(':', 1)[-1].strip()}")
        text += " | " + " | ".join(lines)
    return text


def ms(call, reps: int = 5) -> float:
    """The median of 5 CUDA-event windows of `reps` back-to-back calls, after
    one call that must return 0 (no CUDA error)."""
    if call() != 0:
        raise SystemExit("a launch returned a CUDA error")
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            call()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return sorted(times)[2]


def flash_inputs(gen, b, sq, sk, h, d, ids):
    """f32 q [b, sq, h, d], k and v [b, sk, h, d] ~ N(0, 1) on the card, and
    segment ids: none, "text_pad" (path B's 26 padding rows at the end of 512
    text rows, the same ids for k) or "hop" (those q ids; k's last 400 rows
    another segment, as a ring hop)."""
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen)
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen) for _ in range(2))
    q_seg = kv_seg = None
    if ids:
        q_seg = torch.ones(b, sq, dtype=torch.int32, device="cuda")
        q_seg[:, 486:512] = 0
        kv_seg = q_seg
        if ids == "hop":
            kv_seg = torch.ones(b, sk, dtype=torch.int32, device="cuda")
            kv_seg[:, sk - 400:] = 2
    return q, k, v, q_seg, kv_seg


def rel(a, b) -> float:
    """Relative L2 error of a against b, in f64."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()
