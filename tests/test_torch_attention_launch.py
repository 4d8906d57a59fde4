"""The host side of kernels K1 (bf16 and s_int8) and K4 (qflux_tpu_torch/ops/
flash_nr.py, ops/flash_attention.py): the scratch each mode allocates and the
arguments each wrapper passes to the C entry points, checked on CPU tensors
against a stand-in library that records its calls.  The kernels themselves
run only on the card (tests/test_torch_card.py).

K1's prep norms and ropes k into the scratch kn in both modes, so kn is
always passed; kq and amax only in the s_int8 mode.  K4 takes an f32 delta
scratch [B, H, Sq].
"""

import ctypes

import numpy as np
import pytest
import torch

from qflux_tpu_torch.ops import flash_attention as tfa
from qflux_tpu_torch.ops import flash_nr as tnr
from qflux_tpu_torch.runtime import build

D = 128


class _RecordingLib:
    """Stands in for the ctypes library: every entry point records its
    arguments and returns `code`."""

    def __init__(self, code=0):
        self.calls = []
        self.code = code

    def qflux_cuda_error_string(self, code):
        return f"stand-in error {code}".encode()

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.code
        return entry


def _library(code=0):
    return build.KernelLibrary(lib=_RecordingLib(code), path=None, build_seconds=0.0, log="")


def _k1_args(b, s, h, seg, per_sample_rope, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, D)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    qs2, ks2 = (torch.from_numpy((1 + 0.1 * rng.standard_normal((2, D))).astype(np.float32))
                for _ in range(2))
    shape = (b, s, D) if per_sample_rope else (s, D)
    cos, sin = (torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
                for _ in range(2))
    ids = None
    if seg:
        ids = torch.ones(b, s, dtype=torch.int64)
        ids[:, s // 2:] = 0
    return q, k, v, qs2, ks2, cos, sin, ids


@pytest.mark.parametrize("q_rows", [0, 128, 256])
@pytest.mark.parametrize("s", [77, 300])
def test_fwd_scratch_per_mode(q_rows, s):
    """kn has k's shape and dtype in both modes; the s_int8 mode adds the
    int8 k and one amax slot per (b, h) for k and one per q tile."""
    k = torch.zeros(2, s, 3, D, dtype=torch.bfloat16)
    kn, kq, amax = tnr._fwd_scratch(k, q_rows)
    assert kn.shape == k.shape and kn.dtype == torch.bfloat16
    if not q_rows:
        assert kq is None and amax is None
        return
    assert kq.shape == k.shape and kq.dtype == torch.int8
    assert amax.shape == (2, 3, 1 + -(-s // q_rows)) and amax.dtype == torch.int32


@pytest.mark.parametrize("q_rows", [0, 128])
@pytest.mark.parametrize("seg,per_sample_rope", [(False, False), (True, True)])
def test_fwd_launch_arguments(monkeypatch, q_rows, seg, per_sample_rope):
    """`_launch_fwd` hands qflux_flash_nr_fwd the inputs, the cos / sin
    batch stride, the int32 ids (or None), the kn scratch it allocated (in
    both modes), kq / amax only in the s_int8 mode, the mode's q_rows, out,
    lse and the shape, st and scale; it returns out [B, S, H, D] bf16 and
    lse [B, H, S] f32."""
    b, s, h, st, scale = 2, 77, 3, 20, 0.125
    q, k, v, qs2, ks2, cos, sin, ids = _k1_args(b, s, h, seg, per_sample_rope)
    qs, ks, cs_bstride, seg32 = tnr._kernel_args(q, k, v, qs2, ks2, cos, sin, ids)
    made = []
    real = tnr._fwd_scratch
    monkeypatch.setattr(tnr, "_fwd_scratch", lambda kk, rows: made.append(real(kk, rows))
                        or made[-1])
    kl = _library()
    out, lse = tnr._launch_fwd(kl, 1234, q, k, v, qs, ks, cos, sin, cs_bstride, seg32, st,
                               scale, q_rows)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    (name, args), = kl.lib.calls
    assert name == "qflux_flash_nr_fwd"
    assert len(args) == len(build._SIGNATURES[name][1])
    kn, kq, amax = made[0]
    assert args[:7] == tuple(t.data_ptr() for t in (q, k, v, qs, ks, cos, sin))
    assert args[7] == (s * D if per_sample_rope else 0)
    assert args[8] == (None if seg32 is None else seg32.data_ptr())
    assert seg32 is None or seg32.dtype == torch.int32
    assert args[9] == kn.data_ptr() and kn.shape == k.shape
    assert args[10:13] == ((None, None, 0) if not q_rows
                           else (kq.data_ptr(), amax.data_ptr(), q_rows))
    assert args[13:15] == (out.data_ptr(), lse.data_ptr())
    assert args[15:20] == (b, s, h, st, scale) and args[20] == 1234


def test_fwd_launch_raises_on_a_cuda_error():
    """A nonzero code from the C entry point raises with its message; no
    output is returned."""
    q, k, v, qs2, ks2, cos, sin, _ = _k1_args(1, 40, 2, False, False)
    qs, ks, cs_bstride, seg32 = tnr._kernel_args(q, k, v, qs2, ks2, cos, sin, None)
    with pytest.raises(RuntimeError, match="flash_nr_fwd launch: CUDA error 98"):
        tnr._launch_fwd(_library(98), 0, q, k, v, qs, ks, cos, sin, cs_bstride, seg32, 0,
                        0.1, 0)


@pytest.mark.parametrize("sq,sk,ids", [(300, 300, True), (200, 520, True), (64, 64, False)])
def test_bwd_launch_arguments(sq, sk, ids):
    """`_launch_bwd` hands qflux_flash_bwd the inputs, the ids (or None),
    out / lse / do, an f32 delta scratch [B, H, Sq] and dq / dk / dv, then
    B, Sq, Sk, H and the scale; it returns the three gradients in the
    inputs' shapes and dtype."""
    b, h, scale = 2, 3, 0.0625
    rng = np.random.default_rng(sq + sk)
    q = torch.from_numpy(rng.standard_normal((b, sq, h, D)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((b, sk, h, D)).astype(np.float32)).bfloat16()
            for _ in range(2))
    q_seg = kv_seg = None
    if ids:
        q_seg = torch.ones(b, sq, dtype=torch.int32)
        kv_seg = torch.ones(b, sk, dtype=torch.int32)
    out, do = torch.zeros_like(q), torch.ones_like(q)
    lse = torch.zeros(b, h, sq)
    kl = _library()
    dq, dk, dv = tfa._launch_bwd(kl, 77, q, k, v, q_seg, kv_seg, out, lse, do, scale)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert all(t.dtype == torch.bfloat16 for t in (dq, dk, dv))
    (name, args), = kl.lib.calls
    assert name == "qflux_flash_bwd" and len(args) == len(build._SIGNATURES[name][1])
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[3:5] == ((None, None) if not ids else (q_seg.data_ptr(), kv_seg.data_ptr()))
    assert args[5:8] == (out.data_ptr(), lse.data_ptr(), do.data_ptr())
    assert isinstance(args[8], int) and args[8] not in (q.data_ptr(), out.data_ptr())
    assert args[9:12] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert args[12:17] == (b, sq, sk, h, scale) and args[17] == 77


def test_kn_prep_entry_point_is_declared():
    """The bf16 prep's C entry point (timed apart by the smoke) takes the
    cos / sin batch stride as a 64-bit integer, as the main entry does."""
    restype, argtypes = build._SIGNATURES["qflux_flash_nr_kn_prep"]
    assert restype is ctypes.c_int and len(argtypes) == 11
    assert argtypes[4] is ctypes.c_longlong
    assert build._SIGNATURES["qflux_flash_nr_fwd"][1][7] is ctypes.c_longlong


def test_cpu_tensors_never_reach_the_kn_prep():
    """The prep alone is a card entry point: CPU tensors are refused before
    the library is loaded."""
    q, k, v, qs2, ks2, cos, sin, _ = _k1_args(1, 40, 2, False, False)
    with pytest.raises(ValueError):
        tnr._kn_prep_cuda(k, ks2, cos, sin, 0)
