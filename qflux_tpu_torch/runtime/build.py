"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Every `qflux_tpu_torch/csrc/*.cu` file is compiled for Hopper (`sm_90a`), one
nvcc process per source, all started together, and the objects are linked
into ONE shared library with a plain C interface: no PyTorch headers, so the
build takes seconds.  The library lands in `build/qflux_tpu_torch/` at the
root of the checkout (listed in .gitignore), named by a hash of the sources,
the shared headers (`*.cuh`) and the flags, so a changed kernel is rebuilt
and an unchanged one is loaded as it is.

The build happens at first use (`load_library()`), never at import: the CPU
test suite imports every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "qflux_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> (restype, argtypes) of every C entry point the library exports;
# pointers and the stream go as c_void_p (a bare Python int would be cut to
# 32 bits)
_SIGNATURES = {
    "qflux_flash_nr_fwd": (_I, [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                                _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, ctypes.c_float,
                                _P]),
    "qflux_flash_nr_bwd": (_I, [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                                _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]),
    "qflux_flash_nr_int8_prep": (_I, [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P,
                                      _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "qflux_flash_nr_kn_prep": (_I, [_P, _P, _P, _P, ctypes.c_longlong, _P, _I, _I, _I, _I, _P]),
    "qflux_flash_nr_bwd_prep": (_I, [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P, _P,
                                     _P, _I, _I, _I, _I, _P]),
    "qflux_flash_nr_bwd_tiles": (_I, [_I]),
    "qflux_flash_fwd": (_I, [_P] * 7 + [_I] * 5 + [ctypes.c_float, _P]),
    "qflux_flash_bwd": (_I, [_P] * 12 + [_I] * 5 + [ctypes.c_float, _P]),
    "qflux_f32_fwd": (_I, [_P] * 7 + [_I] * 5 + [ctypes.c_float, _P]),
    "qflux_f32_nr_fwd": (_I, [_P] * 7 + [ctypes.c_longlong] + [_P] * 5 + [_I] * 4
                         + [ctypes.c_float, _P]),
    "qflux_f32_bwd": (_I, [_P] * 12 + [_I] * 5 + [ctypes.c_float, _P]),
    "qflux_f32_nr_bwd": (_I, [_P] * 7 + [ctypes.c_longlong] + [_P] * 14 + [_I] * 4
                         + [ctypes.c_float, _P]),
    "qflux_f32_nr_int8_fwd": (_I, [_P] * 7 + [ctypes.c_longlong] + [_P] * 6 + [_I]
                              + [_P] * 2 + [_I] * 4 + [ctypes.c_float, _P]),
    "qflux_f32_nr_int8_bwd": (_I, [_P] * 7 + [ctypes.c_longlong] + [_P] * 12 + [_I]
                              + [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P]),
    "qflux_simt_nr_prep": (_I, [_P] * 6 + [ctypes.c_longlong] + [_P] * 5 + [_I] * 5 + [_P]),
    "qflux_rq_int4_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    "qflux_rq_int4_bwd": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    "qflux_rowquant": (_I, [_P, _P, _P, _P, _I, _I, _I, _P]),
    "qflux_int8_gemm": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]),
    "qflux_int8_transpose": (_I, [_P, _P, _I, _I, _P]),
    "qflux_int4_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    "qflux_int4_bwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    "qflux_cuda_error_string": (ctypes.c_char_p, [_I]),
    # host code (csrc/jpeg_decode.cu): utils/jpeg.py's native decoder
    "qflux_jpeg_decode": (_I, [_P, _P, _I, _P, _P, _P, _P] + [_I] * 7 + [_P]),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was loaded
    log: str              # nvcc/ptxas output (registers, shared memory, spills)

    def check(self, code: int, what: str) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if code != 0:
            msg = self.lib.qflux_cuda_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels cannot be built on this machine")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libqflux_kernels-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises if nvcc is
    missing or the build fails.  Cached for the life of the process."""
    path = library_path()
    seconds, log = 0.0, ""
    if not path.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            objs = [Path(tmpdir) / f"{src.stem}.o" for src in _sources()]
            procs = [(src, subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
                     for src, obj in zip(_sources(), objs)]
            failed = []
            for src, proc in procs:
                out, _ = proc.communicate()
                log += f"== {src.name}\n{out}"
                if proc.returncode != 0:
                    failed.append(src.name)
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
            tmp = Path(tmpdir) / path.name
            link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{log}")
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds, log=log)
