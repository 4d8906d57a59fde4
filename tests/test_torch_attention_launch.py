"""The host side of kernels K1, K2 (bf16 and s_int8), K3 and K4
(qflux_tpu_torch/ops/flash_nr.py, ops/flash_attention.py): the scratch each
mode allocates and the arguments each wrapper passes to the C entry points,
checked on CPU tensors against a stand-in library that records its calls.
The kernels themselves run only on the card (tests/test_torch_card.py).

K1's prep norms and ropes k into the scratch kn in both modes, so kn is
always passed; kq and amax only in the s_int8 mode.  K2's prep writes qn, kn
and delta in both modes; qq, kq and amax only in the s_int8 mode; its
scale-gradient partials are one [2, D] per (b, h, 64-row tile) in both.  The
s_int8 modes take q tiles of a multiple of 128 rows (a K1 or dq block's
rows lie in one tile); the s_int8 prep alone (`_launch_int8_prep`) is the
entry that times it apart.  K3 reads q, k and v by TMA (16-byte aligned,
contiguous), at head dim 128 and in the narrow mode (bf16 at 32 / 64)
alike, with the head dim as an argument.  K4 takes an f32 delta scratch
[B, H, Sq].  In f32, K3 and K1 take the 3xTF32 tensor-core loop of
csrc/flash_f32_fwd.cu and K4 and K2 that of csrc/flash_f32_bwd.cu (16-byte
aligned, the backward's out and do too), the s_int8 modes of K1 / K2 the
same loops with int8 scores (qflux_f32_nr_int8_fwd / _bwd); torch
emulations of the split (below) show why three TF32 products and not one,
and that the int8-score loops' order meets the f32 tolerances.  A head dim below 128
that no kernel takes runs zero-padded to the next one they take.
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
    arguments, runs the hook `on[name]` on them where there is one, and
    returns `code`; `qflux_flash_nr_bwd_tiles` answers as the C one does."""

    def __init__(self, code=0):
        self.calls = []
        self.code = code
        self.on = {}

    def qflux_cuda_error_string(self, code):
        return f"stand-in error {code}".encode()

    def qflux_flash_nr_bwd_tiles(self, s):
        return -(-s // 64)

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            if name in self.on:
                self.on[name](*args)
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
    B, Sq, Sk, H, the head dim and the scale; it returns the three
    gradients in the inputs' shapes and dtype."""
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
    assert args[12:18] == (b, sq, sk, h, D, scale) and args[18] == 77


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


# ---------------------------------------------------------------------------
# K2: the backward of K1, bf16 and s_int8

@pytest.mark.parametrize("q_rows", [0, 64, 128])
@pytest.mark.parametrize("s", [77, 300])
def test_bwd_nr_scratch_per_mode(q_rows, s):
    """qn, kn have q's shape and dtype and delta is f32 [B, H, S] in both
    modes; the s_int8 mode adds the int8 q and k and one amax slot per (b,
    h) for k and one per q tile."""
    q = torch.zeros(2, s, 3, D, dtype=torch.bfloat16)
    qn, kn, delta, qq, kq, amax = tnr._bwd_scratch(q, q_rows)
    assert qn.shape == kn.shape == q.shape and qn.dtype == kn.dtype == torch.bfloat16
    assert delta.shape == (2, 3, s) and delta.dtype == torch.float32
    if not q_rows:
        assert qq is None and kq is None and amax is None
        return
    assert qq.shape == kq.shape == q.shape and qq.dtype == kq.dtype == torch.int8
    assert amax.shape == (2, 3, 1 + -(-s // q_rows)) and amax.dtype == torch.int32


def _fill_partials(b, s, h):
    """A stand-in for the kernel's partial writes: every [2, D] partial of
    dq_scale2 gets 1 and of dk_scale2 gets 2, over [B, H, ceil(S / 64), 2,
    D] f32 at the pointers the C entry is given."""
    n = b * h * -(-s // 64) * 2 * D

    def fill(*args):
        for ptr, val in ((args[22], 1.0), (args[23], 2.0)):
            src = np.full(n, val, np.float32)
            ctypes.memmove(ptr, src.ctypes.data, 4 * n)
    return fill


@pytest.mark.parametrize("q_rows", [0, 64])
@pytest.mark.parametrize("s,seg,per_sample_rope", [(77, False, False), (300, True, True)])
def test_bwd_nr_launch_arguments(monkeypatch, q_rows, s, seg, per_sample_rope):
    """`_launch_bwd` hands qflux_flash_nr_bwd the inputs, the cos / sin batch
    stride, the int32 ids (or None), out / lse / do, the qn / kn / delta
    scratch it allocated (both modes), qq / kq / amax only in the s_int8
    mode, the mode's q_rows, dq / dk / dv, the two partial buffers, the shape,
    st and scale; it returns dq / dk / dv in the inputs' shapes and the
    partials summed over [B, H, ceil(S / 64)]."""
    b, h, st, scale = 2, 3, 20, 0.125
    q, k, v, qs2, ks2, cos, sin, ids = _k1_args(b, s, h, seg, per_sample_rope, seed=s)
    qs, ks, cs_bstride, seg32 = tnr._kernel_args(q, k, v, qs2, ks2, cos, sin, ids)
    out, do = torch.zeros_like(q), torch.ones_like(q)
    lse = torch.zeros(b, h, s)
    made = []
    real = tnr._bwd_scratch
    monkeypatch.setattr(tnr, "_bwd_scratch", lambda qq_, rows: made.append(real(qq_, rows))
                        or made[-1])
    kl = _library()
    kl.lib.on["qflux_flash_nr_bwd"] = _fill_partials(b, s, h)
    dq, dk, dv, dqs, dks = tnr._launch_bwd(kl, 4321, q, k, v, qs, ks, cos, sin, cs_bstride,
                                           seg32, st, scale, out, lse, do, q_rows)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert all(t.dtype == torch.bfloat16 for t in (dq, dk, dv))
    n_tiles = -(-s // 64)
    assert dqs.shape == dks.shape == (2, D)
    assert bool((dqs == b * h * n_tiles).all()) and bool((dks == 2 * b * h * n_tiles).all())
    name, args = kl.lib.calls[-1]
    assert name == "qflux_flash_nr_bwd" and len(args) == len(build._SIGNATURES[name][1])
    qn, kn, delta, qq, kq, amax = made[0]
    assert args[:7] == tuple(t.data_ptr() for t in (q, k, v, qs, ks, cos, sin))
    assert args[7] == (s * D if per_sample_rope else 0)
    assert args[8] == (None if seg32 is None else seg32.data_ptr())
    assert args[9:12] == (out.data_ptr(), lse.data_ptr(), do.data_ptr())
    assert args[12:15] == (qn.data_ptr(), kn.data_ptr(), delta.data_ptr())
    assert args[15:19] == ((None, None, None, 0) if not q_rows
                           else (qq.data_ptr(), kq.data_ptr(), amax.data_ptr(), q_rows))
    assert args[19:22] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert args[22] != args[23] and all(isinstance(a, int) for a in args[22:24])
    assert args[24:29] == (b, s, h, st, scale) and args[29] == 4321


def test_bwd_nr_launch_raises_on_a_cuda_error():
    """A nonzero code from K2's C entry point raises with its message."""
    q, k, v, qs2, ks2, cos, sin, _ = _k1_args(1, 40, 2, False, False)
    qs, ks, cs_bstride, seg32 = tnr._kernel_args(q, k, v, qs2, ks2, cos, sin, None)
    with pytest.raises(RuntimeError, match="flash_nr_bwd launch: CUDA error 700"):
        tnr._launch_bwd(_library(700), 0, q, k, v, qs, ks, cos, sin, cs_bstride, seg32, 0,
                        0.1, q, torch.zeros(1, 2, 40), q, 0)


def test_bwd_nr_prep_entry_point_is_declared():
    """The bf16 backward's prep (timed apart by the smoke) takes the cos /
    sin batch stride as a 64-bit integer, as the main entry does."""
    restype, argtypes = build._SIGNATURES["qflux_flash_nr_bwd_prep"]
    assert restype is ctypes.c_int and len(argtypes) == 17
    assert argtypes[6] is ctypes.c_longlong
    assert build._SIGNATURES["qflux_flash_nr_bwd"][1][7] is ctypes.c_longlong


# ---------------------------------------------------------------------------
# K1 and K2 in their s_int8 mode: the wgmma loops' int8 score path

@pytest.mark.parametrize("bwd", [False, True], ids=["k1", "k2"])
@pytest.mark.parametrize("q_rows", [64, 192, 320, -128])
def test_s_int8_q_tiles_off_128_rows_are_refused(bwd, q_rows):
    """Both s_int8 wrappers refuse q tiles that are not a multiple of 128
    rows (a K1 block's and a dq block's 128 rows must lie in one tile, so a
    64-row tile, which the backward took before, is refused too), before
    they look at the device; a multiple of 128 reaches the device check."""
    q, k, v, qs2, ks2, cos, sin, _ = _k1_args(1, 300, 2, False, False)
    lse = torch.zeros(1, 2, 300)

    def call(rows):
        if bwd:
            return tnr._flash_nr_bwd_cuda(q, k, v, qs2, ks2, cos, sin, 8, None, 0.1, q, lse, q,
                                          rows)
        return tnr._flash_nr_cuda(q, k, v, qs2, ks2, cos, sin, 8, None, 0.1, rows)

    with pytest.raises(ValueError, match="multiples of 128"):
        call(q_rows)
    for rows in (128, 256):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(rows)


@pytest.mark.parametrize("s", [300, 2304, 2560])
def test_s_int8_tiles_reach_the_kernels(s):
    """Where JAX applies the int8 score GEMM, both of its q tiles are
    multiples of 128 rows, which the kernels take."""
    fwd_rows, bwd_rows = tnr.s_int8_tiles(s, D)
    assert fwd_rows % 128 == 0 and bwd_rows % 128 == 0
    tnr._check_rows(fwd_rows, 128, "")
    tnr._check_rows(bwd_rows, 128, " backward")


@pytest.mark.parametrize("q_rows", [128, 256])
@pytest.mark.parametrize("s", [300, 2304])
def test_fwd_s_int8_launch_at_the_forward_tiles(q_rows, s):
    """K1's s_int8 mode hands its C entry the kn scratch, the int8 k scratch
    [B, S, H, D] and amax [B, H, 1 + ceil(S / q_rows)] (k's slot and one per
    q tile) with the tile's rows."""
    b, h, st, scale = 2, 3, 20, 0.125
    q, k, v, qs2, ks2, cos, sin, ids = _k1_args(b, s, h, True, False, seed=s)
    qs, ks, cs_bstride, seg32 = tnr._kernel_args(q, k, v, qs2, ks2, cos, sin, ids)
    kl = _library()
    out, lse = tnr._launch_fwd(kl, 9, q, k, v, qs, ks, cos, sin, cs_bstride, seg32, st, scale,
                               q_rows)
    (name, args), = kl.lib.calls
    assert name == "qflux_flash_nr_fwd" and len(args) == len(build._SIGNATURES[name][1])
    assert all(isinstance(a, int) for a in args[9:12]) and len(set(args[9:12])) == 3
    assert args[12] == q_rows and args[13:15] == (out.data_ptr(), lse.data_ptr())
    kn, kq, amax = tnr._fwd_scratch(k, q_rows)
    assert kq.shape == k.shape and kq.dtype == torch.int8
    assert amax.shape == (b, h, 1 + -(-s // q_rows)) and amax.dtype == torch.int32


@pytest.mark.parametrize("q_rows", [128, 256])
@pytest.mark.parametrize("s", [300, 2304])
def test_bwd_nr_s_int8_launch_at_the_backward_tiles(monkeypatch, q_rows, s):
    """K2's s_int8 mode at the backward's q tiles hands its C entry the qn /
    kn / delta scratch, qq / kq (int8 [B, S, H, D]), amax [B, H, 1 +
    ceil(S / q_rows)] and q_rows, and sums the same 64-row partials as the
    bf16 mode."""
    b, h, st, scale = 1, 2, 64, 0.125
    q, k, v, qs2, ks2, cos, sin, ids = _k1_args(b, s, h, True, False, seed=3 * s)
    qs, ks, cs_bstride, seg32 = tnr._kernel_args(q, k, v, qs2, ks2, cos, sin, ids)
    out, do, lse = torch.zeros_like(q), torch.ones_like(q), torch.zeros(b, h, s)
    made = []
    real = tnr._bwd_scratch
    monkeypatch.setattr(tnr, "_bwd_scratch", lambda qq_, rows: made.append(real(qq_, rows))
                        or made[-1])
    kl = _library()
    kl.lib.on["qflux_flash_nr_bwd"] = _fill_partials(b, s, h)
    dq, dk, dv, dqs, dks = tnr._launch_bwd(kl, 5, q, k, v, qs, ks, cos, sin, cs_bstride, seg32,
                                           st, scale, out, lse, do, q_rows)
    n_tiles = -(-s // 64)
    assert bool((dqs == b * h * n_tiles).all()) and bool((dks == 2 * b * h * n_tiles).all())
    (name, args), = kl.lib.calls
    qn, kn, delta, qq, kq, amax = made[0]
    assert args[12:15] == (qn.data_ptr(), kn.data_ptr(), delta.data_ptr())
    assert args[15:19] == (qq.data_ptr(), kq.data_ptr(), amax.data_ptr(), q_rows)
    assert qq.shape == kq.shape == q.shape and qq.dtype == kq.dtype == torch.int8
    assert amax.shape == (b, h, 1 + -(-s // q_rows)) and amax.dtype == torch.int32


def test_int8_prep_launch_arguments():
    """The s_int8 prep alone (`_launch_int8_prep`, K2's form without delta)
    passes null out, do and delta, then qn, kn, qq, kq and amax [B, H, 1 +
    ceil(S / q_rows)] it allocated, the shape, st and q_rows."""
    b, s, h, st, q_rows = 2, 300, 3, 40, 128
    q, k, v, qs2, ks2, cos, sin, _ = _k1_args(b, s, h, False, True, seed=7)
    qs, ks, cs_bstride, _ = tnr._kernel_args(q, k, v, qs2, ks2, cos, sin, None)
    kl = _library()
    qn, kn, qq, kq, amax = tnr._launch_int8_prep(kl, 17, q, k, qs, ks, cos, sin, cs_bstride, st,
                                                 q_rows)
    (name, args), = kl.lib.calls
    assert name == "qflux_flash_nr_int8_prep" and len(args) == len(build._SIGNATURES[name][1])
    assert args[:6] == tuple(t.data_ptr() for t in (q, k, qs, ks, cos, sin))
    assert args[6] == s * D and args[7:9] == (None, None) and args[11] is None
    assert args[9:11] == (qn.data_ptr(), kn.data_ptr())
    assert args[12:15] == (qq.data_ptr(), kq.data_ptr(), amax.data_ptr())
    assert args[15:21] == (b, s, h, st, q_rows, 17)
    assert amax.shape == (b, h, 1 + -(-s // q_rows)) and amax.dtype == torch.int32
    assert qq.dtype == kq.dtype == torch.int8 and qn.dtype == kn.dtype == torch.bfloat16


def test_int8_prep_entry_point_is_declared():
    """The s_int8 prep alone takes the cos / sin batch stride as a 64-bit
    integer and out / do / delta beside the scratch: 21 arguments."""
    restype, argtypes = build._SIGNATURES["qflux_flash_nr_int8_prep"]
    assert restype is ctypes.c_int and len(argtypes) == 21
    assert argtypes[6] is ctypes.c_longlong
    assert argtypes[15:20] == [ctypes.c_int] * 5


def test_cpu_tensors_never_reach_the_int8_prep(monkeypatch):
    """The s_int8 prep alone is a card entry point: CPU tensors are refused
    before the library is loaded."""
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "load_library", refuse)
    q, k, v, qs2, ks2, cos, sin, _ = _k1_args(1, 40, 2, False, False)
    with pytest.raises(ValueError, match="CUDA"):
        tnr._int8_operands_cuda(q, k, qs2, ks2, cos, sin, 0, 128)


# ---------------------------------------------------------------------------
# K3: the plain flash forward

def _k3_args(sq, sk, ids, b=2, h=3):
    rng = np.random.default_rng(sq + 3 * sk)
    q = torch.from_numpy(rng.standard_normal((b, sq, h, D)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((b, sk, h, D)).astype(np.float32)).bfloat16()
            for _ in range(2))
    q_seg = kv_seg = None
    if ids:
        q_seg = torch.ones(b, sq, dtype=torch.int64)
        kv_seg = torch.ones(b, sk, dtype=torch.int64)
        q_seg[:, sq // 2:] = 2
        kv_seg[:, sk // 3:] = 0
    return q, k, v, q_seg, kv_seg


@pytest.mark.parametrize("sq,sk,ids", [(300, 520, True), (520, 300, True), (77, 77, False),
                                       (4000, 2000, False)])
def test_fwd_launch_arguments_k3(sq, sk, ids):
    """`_launch_fwd` hands qflux_flash_fwd q, k, v, the int32 ids (or None),
    out and lse, then B, Sq, Sk, H, the head dim, the scale and the stream;
    it returns out [B, Sq, H, D] bf16 and lse [B, H, Sq] f32."""
    b, h, scale = 2, 3, 0.0625
    q, k, v, q_seg, kv_seg = _k3_args(sq, sk, ids, b, h)
    _, _, _, _, qs32, ks32 = tfa._kernel_args(q, k, v, q_seg, kv_seg)
    assert (qs32 is None) == (not ids) and (qs32 is None or qs32.dtype == torch.int32)
    kl = _library()
    out, lse = tfa._launch_fwd(kl, 55, q, k, v, qs32, ks32, scale)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    (name, args), = kl.lib.calls
    assert name == "qflux_flash_fwd" and len(args) == len(build._SIGNATURES[name][1])
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[3:5] == ((None, None) if not ids else (qs32.data_ptr(), ks32.data_ptr()))
    assert args[5:7] == (out.data_ptr(), lse.data_ptr())
    assert args[7:13] == (b, sq, sk, h, D, scale) and args[13] == 55


def test_fwd_launch_raises_on_a_cuda_error_k3():
    """A nonzero code from K3's C entry point (also what a tensor map that
    cannot be encoded returns) raises with its message."""
    q, k, v, _, _ = _k3_args(64, 64, False)
    with pytest.raises(RuntimeError, match="flash_fwd launch: CUDA error 1"):
        tfa._launch_fwd(_library(1), 0, q, k, v, None, None, 0.1)


def test_k3_refuses_misaligned_or_non_contiguous_inputs():
    """K3 reads q, k and v by TMA: a q / k / v that is not 16-byte aligned
    or not contiguous is refused before a launch."""
    q, k, v, _, _ = _k3_args(64, 64, False, b=1, h=2)
    n = q.numel()
    shifted = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(q.shape)  # 2-byte offset
    assert shifted.data_ptr() % 16
    strided = torch.zeros(1, 2, 64, D, dtype=torch.bfloat16).transpose(1, 2)  # [B, S, H, D]
    assert strided.shape == q.shape and not strided.is_contiguous()
    for args, what in [((shifted, k, v), "q is not 16-byte aligned"),
                       ((strided, k, v), "q is not contiguous"),
                       ((q, shifted, v), "k is not 16-byte aligned"),
                       ((q, k, strided), "v is not contiguous")]:
        with pytest.raises(ValueError, match=what):
            tfa._kernel_args(*args, None, None)


def test_cpu_tensors_never_reach_the_k2_or_k3_entries(monkeypatch):
    """CPU tensors never load the library: K2's and K3's launchers refuse
    them, and the public entry points send them to the plain versions (a
    forward and a backward through each), counting no launch."""
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "load_library", refuse)
    q, k, v, qs2, ks2, cos, sin, ids = _k1_args(1, 40, 2, True, False)
    before = (tnr.KERNEL_LAUNCHES, tnr.BWD_KERNEL_LAUNCHES, tfa.KERNEL_LAUNCHES,
              tfa.BWD_KERNEL_LAUNCHES)
    lse = torch.zeros(1, 2, 40)
    with pytest.raises(ValueError, match="CUDA"):
        tnr._flash_nr_bwd_cuda(q, k, v, qs2, ks2, cos, sin, 8, ids, 0.1, q, lse, q)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._flash_fwd_cuda(q, k, v, ids, ids, 0.1)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    out, _ = tnr.flash_attention_nr(*leaves, qs2, ks2, cos, sin, 8, segment_ids=ids)
    out.square().sum().backward()
    o3 = tfa.flash_attention(*leaves, segment_ids=ids)
    o3.square().sum().backward()
    o, lse3 = tfa.flash_fwd_with_lse(q, k, v, ids, ids, 0.1)
    g = tfa.flash_bwd_from_residuals(q, k, v, ids, ids, o, lse3, o, 0.1)
    assert all(bool(torch.isfinite(x.grad).all()) for x in leaves)
    assert all(t.dtype == torch.bfloat16 for t in g)
    assert (tnr.KERNEL_LAUNCHES, tnr.BWD_KERNEL_LAUNCHES, tfa.KERNEL_LAUNCHES,
            tfa.BWD_KERNEL_LAUNCHES) == before


# ---------------------------------------------------------------------------
# the modes off bf16 at D = 128: K3 / K4 in f32 (D = 32, 64, 128) on the
# 3xTF32 loops of csrc/flash_f32_fwd.cu / flash_f32_bwd.cu; K3 / K4 in bf16
# at D = 32, 64 (the narrow mode) on the wgmma kernels; K1 / K2 in f32 (and
# their s_int8 mode on csrc/flash_simt.cu)

SIMT_MODES = [(torch.float32, 32), (torch.float32, 64), (torch.float32, 128),
              (torch.bfloat16, 32), (torch.bfloat16, 64)]
SIMT_IDS = [f"{'f32' if t == torch.float32 else 'bf16'}_d{d}" for t, d in SIMT_MODES]


def _simt_qkv(sq, sk, d, dtype, ids, b=2, h=3):
    rng = np.random.default_rng(sq + sk + d)
    q = torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((b, sk, h, d)).astype(np.float32)).to(dtype)
            for _ in range(2))
    q_seg = kv_seg = None
    if ids:
        q_seg, kv_seg = torch.ones(b, sq, dtype=torch.int32), torch.ones(b, sk, dtype=torch.int32)
    return q, k, v, q_seg, kv_seg


@pytest.mark.parametrize("dtype,d", SIMT_MODES, ids=SIMT_IDS)
@pytest.mark.parametrize("sq,sk,ids", [(300, 520, True), (77, 77, False)])
def test_simt_fwd_launch_arguments(sq, sk, ids, dtype, d):
    """K3 in f32 calls the 3xTF32 qflux_f32_fwd (never qflux_flash_fwd or a
    qflux_simt_* entry) with q, k, v, the int32 ids (or None), out and lse,
    then B, Sq, Sk, H, the head dim, the scale and the stream; in the narrow
    mode (bf16 at D = 32, 64) it calls the wgmma qflux_flash_fwd with the
    same arguments.  out has q's dtype and lse is f32 [B, H, Sq]."""
    b, h, scale = 2, 3, 0.0625
    q, k, v, q_seg, kv_seg = _simt_qkv(sq, sk, d, dtype, ids, b, h)
    _, _, _, _, qs32, ks32 = tfa._kernel_args(q, k, v, q_seg, kv_seg)
    kl = _library()
    out, lse = tfa._launch_fwd(kl, 66, q, k, v, qs32, ks32, scale)
    assert out.shape == q.shape and out.dtype == dtype
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    (name, args), = kl.lib.calls
    f32 = dtype == torch.float32
    assert name == ("qflux_f32_fwd" if f32 else "qflux_flash_fwd")
    assert len(args) == len(build._SIGNATURES[name][1])
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[3:5] == ((None, None) if not ids else (qs32.data_ptr(), ks32.data_ptr()))
    assert args[5:7] == (out.data_ptr(), lse.data_ptr())
    assert args[7:12] == (b, sq, sk, h, d)
    assert args[12:] == (scale, 66)


@pytest.mark.parametrize("dtype,d", SIMT_MODES, ids=SIMT_IDS)
def test_simt_bwd_launch_arguments(dtype, d):
    """K4 in f32 calls the 3xTF32 qflux_f32_bwd (never a qflux_simt_*
    entry) with the inputs, ids, out / lse / do, an f32 delta scratch [B,
    H, Sq] and dq / dk / dv in the inputs' dtype, then B, Sq, Sk, H, the
    head dim, the scale and the stream; in the narrow mode it calls the
    wgmma qflux_flash_bwd with the same arguments."""
    b, h, sq, sk, scale = 2, 3, 200, 320, 0.125
    q, k, v, q_seg, kv_seg = _simt_qkv(sq, sk, d, dtype, True, b, h)
    out, do, lse = torch.zeros_like(q), torch.ones_like(q), torch.zeros(b, h, sq)
    kl = _library()
    dq, dk, dv = tfa._launch_bwd(kl, 88, q, k, v, q_seg, kv_seg, out, lse, do, scale)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert all(t.dtype == dtype for t in (dq, dk, dv))
    (name, args), = kl.lib.calls
    f32 = dtype == torch.float32
    assert name == ("qflux_f32_bwd" if f32 else "qflux_flash_bwd")
    assert len(args) == len(build._SIGNATURES[name][1])
    assert args[:8] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(),
                        kv_seg.data_ptr(), out.data_ptr(), lse.data_ptr(), do.data_ptr())
    assert isinstance(args[8], int) and args[8] not in args[:8]
    assert args[9:12] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert args[12:17] == (b, sq, sk, h, d)
    assert args[17:] == (scale, 88)


@pytest.mark.parametrize("d", [32, 64])
def test_narrow_refuses_misaligned_or_non_contiguous_inputs(monkeypatch, d):
    """The narrow mode reads q, k, v (and the backward's out and do) by TMA,
    as bf16 at D = 128: any of them off 16-byte alignment, or not
    contiguous, is refused before the library is loaded (the launchers run
    here with their device check lifted)."""
    def refuse():
        raise AssertionError("refused inputs reached the kernel library")

    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(tfa, "_on_cuda", lambda what, q: None)
    q, k, v, q_seg, kv_seg = _simt_qkv(64, 64, d, torch.bfloat16, True, 1, 2)
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    assert shifted.data_ptr() % 16
    strided = torch.zeros(1, 2, 64, d, dtype=torch.bfloat16).transpose(1, 2)
    assert strided.shape == q.shape and not strided.is_contiguous()
    for args, what in [((shifted, k, v), "q is not 16-byte aligned"),
                       ((q, shifted, v), "k is not 16-byte aligned"),
                       ((q, k, shifted), "v is not 16-byte aligned"),
                       ((strided, k, v), "q is not contiguous")]:
        with pytest.raises(ValueError, match=what):
            tfa._flash_fwd_cuda(*args, q_seg, kv_seg, 0.125)
    lse = torch.zeros(1, 2, 64)
    for out, do, what in [(shifted, q, "out is not 16-byte aligned"),
                          (q, shifted, "do is not 16-byte aligned")]:
        with pytest.raises(ValueError, match=what):
            tfa._flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do, 0.125)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_f32_refuses_misaligned_inputs(monkeypatch, d):
    """The f32 K3 reads q, k and v by TMA too: any of them off 16-byte
    alignment is refused before the library is loaded, through the
    forward's launcher and `_kernel_args` (which K4 shares); K1 in f32
    refuses them as in bf16."""
    def refuse():
        raise AssertionError("refused inputs reached the kernel library")

    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(tfa, "_on_cuda", lambda what, q: None)
    q, k, v, q_seg, kv_seg = _simt_qkv(64, 96, d, torch.float32, True, 1, 2)
    for t, i in ((q, 0), (k, 1), (v, 2)):
        shifted = torch.zeros(t.numel() + 1)[1:].view(t.shape)  # a 4-byte offset
        assert shifted.data_ptr() % 16
        args = [q, k, v]
        args[i] = shifted
        what = f"{'qkv'[i]} is not 16-byte aligned"
        with pytest.raises(ValueError, match=what):
            tfa._flash_fwd_cuda(*args, q_seg, kv_seg, 0.125)
        with pytest.raises(ValueError, match=what):
            tfa._kernel_args(*args, None, None)
    if d == 128:
        args = list(_f32_k1_args(1, 64, 2, True))
        args[0] = torch.zeros(args[0].numel() + 1)[1:].view(args[0].shape)
        with pytest.raises(ValueError, match="q is not 16-byte aligned"):
            tnr._kernel_args(*args)


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to the nearest value with
    10 stored mantissa bits, ties away from zero (the sign-magnitude bits
    plus half the dropped ulp, then the 13 low bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm3(a, b, split=True):
    """a @ b as the f32 loops run it: hi_a hi_b + hi_a lo_b + lo_a hi_b of
    TF32 pieces (each product exact in f32, the sums f32), or one TF32
    product (split=False)."""
    if not split:
        return _tf32(a) @ _tf32(b)
    (ah, al), (bh, bl) = _split(a), _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _stepped(a, b, step, split=True):
    """a [.., M, K] @ b [.., K, N], the K rows streamed `step` at a time:
    each step's `_mm3` into a fresh f32 partial added to the sum in order."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], step):
        acc = acc + _mm3(a[..., k0:k0 + step].contiguous(), b[..., k0:k0 + step, :], split)
    return acc


def _emulated_fwd(q, k, v, scale, split=True):
    """csrc/flash_f32_fwd.cu's arithmetic in torch on [B, S, H, D] f32, the
    unmasked case: every product of S = q k^T and of P V as hi_a hi_b +
    hi_a lo_b + lo_a hi_b of TF32 pieces (each product exact in f32, the
    sums f32), p = exp(s - m) split the same way, the sum divided by l at
    the end; split=False takes one TF32 product instead (TF32 operands).
    Returns (out, lse [B, H, Sq])."""
    qf, kf, vf = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # [B, H, S, D]
    s = _mm3(qf, kf.transpose(-1, -2), split)
    m = s.amax(-1, keepdim=True)
    p = torch.exp((s - m) * scale)
    l = p.sum(-1, keepdim=True)
    out = (_mm3(p, vf, split) / l).permute(0, 2, 1, 3)
    return out, (m * scale + l.log()).squeeze(-1)


@pytest.mark.parametrize("d", [32, 128])
def test_tf32_split_arithmetic_meets_the_f32_tolerance(d):
    """Why the f32 K3 runs three TF32 products a product: in a torch
    emulation of its arithmetic (TF32 rounding by mantissa masking with
    round-to-nearest, hi_a hi_b + hi_a lo_b + lo_a hi_b, f32 sums; the
    emulation lives here and on no path) out and lse are within the f32
    modes' 2e-5 relative L2 (chip_smoke.py's F32_REL_TOL) of
    `flash_fwd_reference`, while one TF32 product misses it by more than
    an order of magnitude.  The rounding is cvt.rna's: 1 + 2^-11 (a tie)
    rounds away from zero, 1 + 2^-12 to 1."""
    one = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 3.0], dtype=torch.float32)
    assert _tf32(one).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 3.0]
    rng = np.random.default_rng(23 + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 96, 2, d)).astype(np.float32))
               for _ in range(3))
    scale = d ** -0.5
    ref, ref_lse = tfa.flash_fwd_reference(q, k, v, None, None, scale)

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    out, lse = _emulated_fwd(q, k, v, scale)
    assert rel(out, ref) <= 2e-5 and rel(lse, ref_lse) <= 2e-5
    hi, lo = _split(q)  # what the split drops: lo's own rounding, at most 2^-22 of |x|
    assert bool(((hi + lo - q).abs() <= 2.0 ** -22 * q.abs()).all())
    out1, lse1 = _emulated_fwd(q, k, v, scale, split=False)
    assert rel(out1, ref) > 10 * 2e-5


def _emulated_bwd(q, k, v, out, lse, do, scale, split=True, step=32):
    """csrc/flash_f32_bwd.cu's arithmetic in torch on [B, S, H, D] f32, the
    unmasked case: every one of the seven products (s and dp in both
    passes) as hi_a hi_b + hi_a lo_b + lo_a hi_b of TF32 pieces, p and ds
    split as operands; each gradient summed over `step`-row steps of the
    streamed rows, each step's products into a fresh f32 partial that is
    added to the gradient in order (the kernel's fresh accumulator: R = 32
    rows a step at D = 128, 64 at 32 / 64).  split=False takes one TF32
    product each.  Returns (dq, dk, dv)."""
    qf, kf, vf, dof, of = (t.permute(0, 2, 1, 3) for t in (q, k, v, do, out))
    p = torch.exp(_mm3(qf, kf.transpose(-1, -2), split) * scale - lse[..., None])
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (_mm3(dof, vf.transpose(-1, -2), split) - delta) * scale
    pt, dst = p.transpose(-1, -2).contiguous(), ds.transpose(-1, -2).contiguous()
    grads = _stepped(ds, kf, step, split), _stepped(dst, qf, step, split), _stepped(pt, dof, step,
                                                                                   split)
    return tuple(g.permute(0, 2, 1, 3) for g in grads)


@pytest.mark.parametrize("d", [32, 128])
def test_tf32_split_backward_arithmetic_meets_the_f32_tolerance(d):
    """Why the f32 K4 / K2 run three TF32 products a product and sum the
    gradients in a fresh accumulator a step: in a torch emulation of
    csrc/flash_f32_bwd.cu's arithmetic (`_emulated_bwd`; it lives here and
    on no path) dq, dk and dv are within the f32 gradients' 1e-4 relative
    L2 (chip_smoke.py's F32_GRAD_TOL) of `flash_bwd_reference`, while one
    TF32 product each misses it."""
    rng = np.random.default_rng(29 + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 96, 2, d)).astype(np.float32))
                   for _ in range(4))
    scale = d ** -0.5
    out, lse = tfa.flash_fwd_reference(q, k, v, None, None, scale)
    out = out.contiguous()
    ref = tfa.flash_bwd_reference(q, k, v, None, None, out, lse, do, scale)

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    step = 32 if d == 128 else 64
    got = _emulated_bwd(q, k, v, out, lse, do, scale, step=step)
    assert max(rel(g, r) for g, r in zip(got, ref)) <= 1e-4
    one = _emulated_bwd(q, k, v, out, lse, do, scale, split=False, step=step)
    assert min(rel(g, r) for g, r in zip(one, ref)) > 1e-4


def _int8_nr_inputs(s, seed):
    """f32 q / k / v [1, S, 1, 128], scale pairs and [S, 128] rope tables."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, 1, D)).astype(np.float32))
               for _ in range(3))
    qs2, ks2 = (torch.from_numpy((1 + 0.1 * rng.standard_normal((2, D))).astype(np.float32))
                for _ in range(2))
    ang = rng.uniform(0, 6.28, (s, D // 2)).astype(np.float32)
    cos, sin = (torch.from_numpy(np.concatenate([f(ang)] * 2, -1)) for f in (np.cos, np.sin))
    return q, k, v, qs2, ks2, cos, sin


def _int8_score_exp2(q, k, qs2, ks2, cos, sin, st, rows, scale, shift):
    """p of the f32 s_int8 loops: the exact integer scores of the prep's
    int8 operands (q in `rows`-row tiles), the factor (q tile scale * k
    scale) * scale as f32 products in that order, times log2 e, and 2^(acc
    * that + shift) with the sum rounded once (the kernels' fmaf; float64
    exp2 stands in for ex2.approx).  shift(acc, fl2) gives the [B, H, S, 1]
    offset in log2 units.  Returns (p, the factor) [B, H, S, S], [B, H, S, 1]."""
    qn = tnr.apply_qk_norm_rope(q, qs2, cos, sin, st)
    kn = tnr.apply_qk_norm_rope(k, ks2, cos, sin, st)
    qq, q_sc = tnr.quant_rows(qn, rows)
    kq, k_sc = tnr.quant_rows(kn, k.shape[1])
    acc = torch.einsum("bqhd,bkhd->bhqk", qq.double(), kq.double()).float()
    fac = ((q_sc.permute(0, 2, 1) * k_sc[:, 0][:, :, None]) * scale)[..., None]
    fl2 = fac * 1.4426950408889634
    arg = (acc.double() * fl2.double() + shift(acc, fl2).double()).float()
    return torch.exp2(arg.double()).float(), fac


def _emulated_int8_fwd(q, k, v, qs2, ks2, cos, sin, st, rows, scale, split=True):
    """csrc/flash_f32_fwd.cu's s_int8 loop (I8) in torch, unmasked: the
    exact int8 scores and factor of `_int8_score_exp2` (the softmax in
    log2 units against the row max m), P V 3xTF32 into a fresh accumulator
    each 64-key tile added in order, the sum divided by l, lse = m factor +
    log l.  Returns (out [B, S, H, D], lse [B, H, S])."""
    m = {}

    def shift(acc, fl2):
        m["raw"] = acc.amax(-1, keepdim=True)
        return -(m["raw"] * fl2)

    p, fac = _int8_score_exp2(q, k, qs2, ks2, cos, sin, st, rows, scale, shift)
    l = p.sum(-1, keepdim=True)
    o = _stepped(p, v.permute(0, 2, 1, 3), 64, split)
    return (o / l).permute(0, 2, 1, 3), (m["raw"] * fac + l.log()).squeeze(-1)


def _emulated_int8_bwd(q, k, v, qs2, ks2, cos, sin, st, do, out, lse, rows, scale, split=True):
    """csrc/flash_f32_bwd.cu's s_int8 loops (I8) in torch, unmasked: p from
    the exact int8 scores of the backward's `rows`-row q tiles against the
    forward's lse (`_int8_score_exp2`); dp = do v^T as the two warpgroups'
    halves of the head dims, each 3xTF32, added; ds = p (dp - delta)
    scale; dqn = ds kn, dkn = ds^T qn and dv = p^T do 3xTF32 over 32-row
    steps, each into a fresh accumulator; then the plain rope + norm
    backward.  Returns (dq, dk, dv, dq_scale2, dk_scale2)."""
    p, _ = _int8_score_exp2(q, k, qs2, ks2, cos, sin, st, rows, scale,
                            lambda acc, fl2: -(lse[..., None] * 1.4426950408889634))
    qn = tnr.apply_qk_norm_rope(q, qs2, cos, sin, st)
    kn = tnr.apply_qk_norm_rope(k, ks2, cos, sin, st)
    qf, kf, vf, dof, of = (t.permute(0, 2, 1, 3) for t in (qn, kn, v, do, out))
    delta = (dof * of).sum(-1, keepdim=True)
    h = D // 2
    dp = (_mm3(dof[..., :h], vf[..., :h].transpose(-1, -2), split)
          + _mm3(dof[..., h:], vf[..., h:].transpose(-1, -2), split))
    ds = p * (dp - delta) * scale
    pt, dst = p.transpose(-1, -2).contiguous(), ds.transpose(-1, -2).contiguous()
    dqn, dkn, dv = (_stepped(a, b, 32, split).permute(0, 2, 1, 3)
                    for a, b in ((ds, kf), (dst, qf), (pt, dof)))
    dq, dqs = tnr._rope_norm_bwd(dqn, q, qs2, cos, sin, st)
    dk, dks = tnr._rope_norm_bwd(dkn, k, ks2, cos, sin, st)
    return dq, dk, dv, dqs, dks


def _rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def test_int8_score_forward_arithmetic_meets_the_f32_tolerance():
    """Why K1's f32 s_int8 loop (csrc/flash_f32_fwd.cu, I8) may take its
    order: in a torch emulation (`_emulated_int8_fwd`: exact int32 scores
    times the factor inside the log2-unit exponent, P V 3xTF32 into a fresh
    accumulator each 64-key tile; it lives here and on no path) at S =
    2304 with the forward's 256-row q tiles, out and lse are within the
    f32 modes' 2e-5 relative L2 of `flash_attention_nr_int8_reference`,
    while P V as one TF32 product misses it."""
    s, st, scale = 2304, 512, D ** -0.5
    args = _int8_nr_inputs(s, 31)
    fwd_rows, _ = tnr.s_int8_tiles(s, D)
    assert fwd_rows == 256
    ref, ref_lse = tnr.flash_attention_nr_int8_reference(*args, st, fwd_rows, scale=scale)
    out, lse = _emulated_int8_fwd(*args, st, fwd_rows, scale)
    assert _rel(out, ref) <= 2e-5 and _rel(lse, ref_lse) <= 2e-5
    out1, _ = _emulated_int8_fwd(*args, st, fwd_rows, scale, split=False)
    assert _rel(out1, ref) > 2e-5


def test_int8_score_backward_arithmetic_meets_the_f32_tolerance():
    """Why K2's f32 s_int8 loops (csrc/flash_f32_bwd.cu, I8) may take their
    order: in a torch emulation (`_emulated_int8_bwd`: the backward's
    128-row q tiles against the forward's lse, dp as two added halves of
    the head dims, every other product 3xTF32 with a fresh accumulator a
    32-row step; it lives here and on no path) at S = 2304, dq, dk, dv and
    both scale-pair gradients are within the f32 gradients' 1e-4 relative
    L2 of `flash_attention_nr_int8_bwd_reference`, while one TF32 product
    each misses it on dq, dk and dv."""
    s, st, scale = 2304, 512, D ** -0.5
    args = _int8_nr_inputs(s, 37)
    fwd_rows, bwd_rows = tnr.s_int8_tiles(s, D)
    assert (fwd_rows, bwd_rows) == (256, 128)
    out, lse = tnr.flash_attention_nr_int8_reference(*args, st, fwd_rows, scale=scale)
    do = torch.from_numpy(np.random.default_rng(38).standard_normal(out.shape).astype(np.float32))
    want = tnr.flash_attention_nr_int8_bwd_reference(*args, st, do, out, lse, bwd_rows,
                                                     scale=scale)
    got = _emulated_int8_bwd(*args, st, do, out, lse, bwd_rows, scale)
    assert max(_rel(g, w) for g, w in zip(got, want)) <= 1e-4
    one = _emulated_int8_bwd(*args, st, do, out, lse, bwd_rows, scale, split=False)
    assert min(_rel(g, w) for g, w in zip(one[:3], want[:3])) > 1e-4


@pytest.mark.parametrize("d", [32, 64, 128])
def test_f32_bwd_refuses_misaligned_out_or_do(monkeypatch, d):
    """The f32 K4 reads do by TMA and its delta pass reads out: either off
    16-byte alignment is refused before the library is loaded, as in bf16
    (the launcher runs here with its device check lifted)."""
    def refuse():
        raise AssertionError("refused inputs reached the kernel library")

    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(tfa, "_on_cuda", lambda what, q: None)
    q, k, v, q_seg, kv_seg = _simt_qkv(64, 96, d, torch.float32, True, 1, 2)
    shifted = torch.zeros(q.numel() + 1)[1:].view(q.shape)  # a 4-byte offset
    assert shifted.data_ptr() % 16
    lse = torch.zeros(1, 2, 64)
    for out, do, what in [(shifted, q, "out is not 16-byte aligned"),
                          (q, shifted, "do is not 16-byte aligned")]:
        with pytest.raises(ValueError, match=what):
            tfa._flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do, 0.125)


PAD_CASES = [(d, t) for d in (16, 48, 96) for t in (torch.float32, torch.bfloat16)]
PAD_IDS = [f"{'f32' if t == torch.float32 else 'bf16'}_d{d}" for d, t in PAD_CASES]


@pytest.mark.parametrize("d,dtype", PAD_CASES, ids=PAD_IDS)
def test_padded_head_dims_launch_at_a_taken_dim(monkeypatch, d, dtype):
    """A head dim below 128 that no kernel takes (16, 48, 96) reaches the C
    entries zero-padded to the next one they take (32, 64, 128), with the
    caller's scale (the original head dim's, never the padded one's): K3
    and K4 alike, out and dq / dk / dv sliced back to D, lse as it is.  A
    launch counts under the head dim it ran at (bf16 at 96 is not
    "narrow").  Above 128 the launchers still raise, naming the head dims
    the kernels take."""
    import types

    kl = _library()
    monkeypatch.setattr(build, "load_library", lambda: kl)
    monkeypatch.setattr(tfa, "_on_cuda", lambda what, q: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    b, sq, sk, h = 1, 70, 90, 2
    q, k, v, q_seg, kv_seg = _simt_qkv(sq, sk, d, dtype, True, b, h)
    scale = d ** -0.5
    dp = tfa.run_head_dim(d)
    assert dp == {16: 32, 48: 64, 96: 128}[d]
    out, lse = tfa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    assert lse.shape == (b, h, sq)
    dq, dk, dv = tfa._flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, torch.ones_like(q), scale)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert all(t.dtype == dtype and t.is_contiguous() for t in (dq, dk, dv))
    (fname, fargs), (bname, bargs) = kl.lib.calls
    f32 = dtype == torch.float32
    assert (fname, bname) == (("qflux_f32_fwd", "qflux_f32_bwd") if f32
                              else ("qflux_flash_fwd", "qflux_flash_bwd"))
    assert fargs[7:13] == (b, sq, sk, h, dp, scale) and bargs[12:18] == (b, sq, sk, h, dp, scale)
    assert q.data_ptr() not in fargs[:3] and q.data_ptr() not in bargs[:3]  # padded copies
    assert bargs[6] == lse.data_ptr()
    names = ("KERNEL_LAUNCHES", "F32_KERNEL_LAUNCHES", "NARROW_KERNEL_LAUNCHES")
    before = [getattr(tfa, n) for n in names]
    tfa._count(q, bwd=False)
    grew = [getattr(tfa, n) - x for n, x in zip(names, before)]
    assert grew == [1, int(f32), int(not f32 and dp != 128)]
    if d == 96:
        wide = torch.zeros(1, 8, 2, 160, dtype=dtype)
        with pytest.raises(ValueError, match=r"head dims \(32, 64, 128\)"):
            tfa._flash_fwd_cuda(wide, wide, wide, None, None, 0.1)


@pytest.mark.parametrize("d,dtype", PAD_CASES, ids=PAD_IDS)
def test_padded_plain_versions_equal_the_unpadded(d, dtype):
    """Why the padding is exact: the plain K3 and K4 over q / k / v (and
    out / do) zero-padded to the head dim the kernels run, with the
    original scale, give the unpadded plain versions' out, lse and dq / dk
    / dv in the first D columns and zeros in the padded ones (masked rows
    included): zero columns add nothing to a score, and delta = rowsum(do
    out) is unchanged."""
    q, k, v, q_seg, kv_seg = _simt_qkv(70, 90, d, dtype, True, 1, 2)
    q_seg[:, -6:] = 0  # fully masked q rows
    kv_seg[:, :5] = 2
    scale = d ** -0.5
    dp = tfa.run_head_dim(d)
    pq, pk, pv = (tfa.pad_head(t, dp) for t in (q, k, v))
    out, lse = tfa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
    pout, plse = tfa.flash_fwd_reference(pq, pk, pv, q_seg, kv_seg, scale)
    tol = {"rtol": 1e-5, "atol": 1e-6} if dtype == torch.float32 else {}
    torch.testing.assert_close(pout[..., :d], out, **tol)
    torch.testing.assert_close(plse, lse, rtol=1e-5, atol=1e-6)
    assert not pout[..., d:].any()
    do = torch.from_numpy(np.random.default_rng(d).standard_normal(q.shape).astype(np.float32)
                          ).to(dtype)
    grads = tfa.flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    pgrads = tfa.flash_bwd_reference(pq, pk, pv, q_seg, kv_seg, tfa.pad_head(out, dp), lse,
                                     tfa.pad_head(do, dp), scale)
    for g, pg in zip(grads, pgrads):
        torch.testing.assert_close(pg[..., :d], g, rtol=1e-5, atol=1e-5)
        assert not pg[..., d:].any()


@pytest.mark.parametrize("d", [32, 64, 128])
def test_modes_take_their_entries(d):
    """bf16 at every head dim takes the wgmma K3 / K4 (mode "bf16" at 128,
    "narrow" at 32 / 64, the head dim passed to qflux_flash_fwd / _bwd),
    f32 the 3xTF32 K3 and K4 (qflux_f32_fwd / qflux_f32_bwd with the head
    dim): one call each way, no other."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, q_seg, kv_seg = _simt_qkv(77, 130, d, dtype, True, 1, 2)
        kl = _library()
        out, lse = tfa._launch_fwd(kl, 5, q, k, v, q_seg, kv_seg, 0.25)
        tfa._launch_bwd(kl, 5, q, k, v, q_seg, kv_seg, out, lse, torch.ones_like(q), 0.25)
        names = [name for name, _ in kl.lib.calls]
        if dtype == torch.bfloat16:
            assert tfa.mode(q) == ("bf16" if d == 128 else "narrow")
            assert names == ["qflux_flash_fwd", "qflux_flash_bwd"]
            assert [args[11] for _, args in kl.lib.calls[:1]] == [d]
            assert kl.lib.calls[1][1][16] == d
        else:
            assert tfa.mode(q) == "f32"
            assert names == ["qflux_f32_fwd", "qflux_f32_bwd"]
            assert kl.lib.calls[0][1][11] == d and kl.lib.calls[1][1][16] == d


def test_simt_entries_take_f32_only():
    """csrc/flash_simt.cu holds the f32 modes' prep and rope + norm backward
    alone: no bf16 instance, no attention loop (K3 / K1 and K4 / K2 in f32,
    their s_int8 modes included, run the tensor-core loops of
    csrc/flash_f32_fwd.cu / flash_f32_bwd.cu), and no entry but those two.
    The s_int8 modes' entries there refuse q_rows <= 0 (the plain f32
    modes).  (The card test
    `test_f32_s_int8_entries_refuse_untaken_q_tiles_on_card` runs the
    refusals.)"""
    import re

    src = (build.CSRC / "flash_simt.cu").read_text()
    assert "Elem<bf16>" not in src and "<bf16>" not in src
    for gone in ("qflux_simt_bwd", "bwd_by_dim", "simt_delta_kernel", "qflux_simt_fwd",
                 "fwd_by_dim", "template <int HD, bool SEG, bool INT8>", "launch_bwd<",
                 "qflux_simt_nr_fwd", "qflux_simt_nr_bwd", "__dp4a", "simt_fwd_int8_kernel",
                 "simt_dkv_kernel", "simt_dq_kernel", "struct Args", "pv_tile", "load_tile"):
        assert gone not in src, gone
    assert re.findall(r'extern "C" int (\w+)\(', src) == ["qflux_simt_nr_prep",
                                                           "qflux_simt_nr_rope_norm_bwd"]
    for gone in ("qflux_simt_fwd", "qflux_simt_bwd", "qflux_simt_nr_fwd", "qflux_simt_nr_bwd"):
        assert gone not in build._SIGNATURES, gone
    assert not hasattr(tfa, "SIMT_F32")
    for file, entry in (("flash_f32_fwd.cu", "qflux_f32_nr_int8_fwd"),
                        ("flash_f32_bwd.cu", "qflux_f32_nr_int8_bwd")):
        body = (build.CSRC / file).read_text()
        body = body[body.index(f'extern "C" int {entry}('):]
        assert "q_rows <= 0" in body[:body.index("return (int)cudaErrorInvalidValue;")], entry


def test_wgmma_entry_points_take_the_head_dim():
    """K3's and K4's C entries take the head dim as an int before the scale:
    14 and 19 arguments, pointers as 64-bit."""
    for name, n, n_ptr in (("qflux_flash_fwd", 14, 7), ("qflux_flash_bwd", 19, 12)):
        restype, argtypes = build._SIGNATURES[name]
        assert restype is ctypes.c_int and len(argtypes) == n, name
        assert argtypes[:n_ptr] == [ctypes.c_void_p] * n_ptr
        assert argtypes[n_ptr:n - 2] == [ctypes.c_int] * 5
        assert argtypes[-2] is ctypes.c_float and argtypes[-1] is ctypes.c_void_p


@pytest.mark.parametrize("d", [16, 96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_untaken_head_dims_and_dtypes_raise(dtype, d):
    """No card is needed to refuse what no kernel takes: a head dim off 32,
    64, 128 or a dtype other than f32 / bf16 raises in the argument check
    (and so in the CUDA launcher, before any library), naming the head dims
    the kernels take; bf16 at 128 names the wgmma kernels."""
    q = torch.zeros(1, 8, 2, d, dtype=dtype)
    with pytest.raises(ValueError, match=r"head dims \(32, 64, 128\)"):
        tfa._kernel_args(q, q, q, None, None)
    with pytest.raises(ValueError, match="head dims"):
        tfa.mode(q)
    assert tfa.mode(torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)) == "bf16"
    if dtype == torch.float16:
        q64 = torch.zeros(1, 8, 2, 64, dtype=dtype)
        with pytest.raises(ValueError, match="head dims"):
            tfa._kernel_args(q64, q64, q64, None, None)


def _f32_k1_args(b, s, h, seg, seed=0):
    q, k, v, qs2, ks2, cos, sin, ids = _k1_args(b, s, h, seg, False, seed)
    return (q.float(), k.float(), v.float(), qs2, ks2, cos, sin, ids)


@pytest.mark.parametrize("q_rows", [0, 128, 256])
@pytest.mark.parametrize("seg", [False, True])
def test_simt_nr_fwd_launch_arguments(monkeypatch, q_rows, seg):
    """K1 in f32 (never qflux_flash_nr_fwd) calls the 3xTF32
    qflux_f32_nr_fwd with the inputs, the cos / sin batch stride, the ids,
    its scratch (qn, kn f32 [B, S, H, D]), out (f32), lse, the shape, st,
    the scale and the stream; in the s_int8 mode it calls the int8-score
    qflux_f32_nr_int8_fwd with qq, kq int8, amax [B, H, 1 + ceil(S /
    q_rows)] and q_rows after qn / kn."""
    b, s, h, st, scale = 2, 300, 3, 40, 0.125
    q, k, v, qs2, ks2, cos, sin, ids = _f32_k1_args(b, s, h, seg)
    qs, ks, cs_bstride, seg32 = tnr._kernel_args(q, k, v, qs2, ks2, cos, sin, ids)
    made = []
    real = tnr._simt_fwd_scratch
    monkeypatch.setattr(tnr, "_simt_fwd_scratch",
                        lambda qq_, rows: made.append(real(qq_, rows)) or made[-1])
    kl = _library()
    out, lse = tnr._launch_fwd(kl, 31, q, k, v, qs, ks, cos, sin, cs_bstride, seg32, st, scale,
                               q_rows)
    assert out.dtype == torch.float32 and lse.shape == (b, h, s)
    (name, args), = kl.lib.calls
    assert name == ("qflux_f32_nr_int8_fwd" if q_rows else "qflux_f32_nr_fwd")
    assert len(args) == len(build._SIGNATURES[name][1])
    qn, kn, qq, kq, amax = made[0]
    assert args[:7] == tuple(t.data_ptr() for t in (q, k, v, qs, ks, cos, sin))
    assert args[7] == cs_bstride and args[8] == (None if seg32 is None else seg32.data_ptr())
    assert args[9:11] == (qn.data_ptr(), kn.data_ptr())
    assert qn.shape == kn.shape == q.shape and qn.dtype == kn.dtype == torch.float32
    if q_rows:
        assert args[11:15] == (qq.data_ptr(), kq.data_ptr(), amax.data_ptr(), q_rows)
        assert qq.dtype == kq.dtype == torch.int8 and qq.shape == q.shape
        assert amax.shape == (b, h, 1 + -(-s // q_rows)) and amax.dtype == torch.int32
        args = args[:11] + args[15:]
    else:
        assert qq is None and kq is None and amax is None
    assert args[11:13] == (out.data_ptr(), lse.data_ptr())
    assert args[13:19] == (b, s, h, st, scale, 31)


@pytest.mark.parametrize("q_rows", [0, 128])
def test_simt_nr_bwd_launch_arguments(monkeypatch, q_rows):
    """K2 in f32 calls the 3xTF32 qflux_f32_nr_bwd (its s_int8 mode the
    int8-score qflux_f32_nr_int8_bwd) with the inputs, out / lse / do, the
    prep's scratch (qn, kn f32, delta f32 [B, H, S]), the f32 dqn / dkn
    scratch the rope + norm backward reads, in the s_int8 mode qq / kq /
    amax and q_rows, then dq / dk / dv (f32), the two [B, H, ceil(S / 64),
    2, D] partial buffers, the shape, st, scale and stream; it returns the
    partials summed."""
    b, s, h, st, scale = 2, 300, 3, 40, 0.125
    q, k, v, qs2, ks2, cos, sin, ids = _f32_k1_args(b, s, h, True, seed=4)
    qs, ks, cs_bstride, seg32 = tnr._kernel_args(q, k, v, qs2, ks2, cos, sin, ids)
    out, do, lse = torch.zeros_like(q), torch.ones_like(q), torch.zeros(b, h, s)
    made = []
    real = tnr._bwd_scratch
    monkeypatch.setattr(tnr, "_bwd_scratch", lambda qq_, rows: made.append(real(qq_, rows))
                        or made[-1])
    kl = _library()
    fill = _fill_partials(b, s, h)
    kl.lib.on["qflux_f32_nr_int8_bwd"] = lambda *a: fill(*a[:22], a[24], a[25])
    kl.lib.on["qflux_f32_nr_bwd"] = lambda *a: fill(*a[:22], a[20], a[21])
    dq, dk, dv, dqs, dks = tnr._launch_bwd(kl, 12, q, k, v, qs, ks, cos, sin, cs_bstride, seg32,
                                           st, scale, out, lse, do, q_rows)
    assert all(t.dtype == torch.float32 and t.shape == q.shape for t in (dq, dk, dv))
    n_tiles = -(-s // 64)
    assert bool((dqs == b * h * n_tiles).all()) and bool((dks == 2 * b * h * n_tiles).all())
    (name, args), = kl.lib.calls
    assert name == ("qflux_f32_nr_int8_bwd" if q_rows else "qflux_f32_nr_bwd")
    assert len(args) == len(build._SIGNATURES[name][1])
    qn, kn, delta, qq, kq, amax = made[0]
    assert args[:7] == tuple(t.data_ptr() for t in (q, k, v, qs, ks, cos, sin))
    assert args[7] == cs_bstride and args[8] == seg32.data_ptr()
    assert args[9:12] == (out.data_ptr(), lse.data_ptr(), do.data_ptr())
    assert args[12:15] == (qn.data_ptr(), kn.data_ptr(), delta.data_ptr())
    assert qn.dtype == torch.float32 and delta.shape == (b, h, s)
    assert all(isinstance(a, int) for a in args[15:17]) and len(set(args[12:17])) == 5
    if q_rows:
        assert args[17:21] == (qq.data_ptr(), kq.data_ptr(), amax.data_ptr(), q_rows)
        args = args[:17] + args[21:]
    else:
        assert qq is None and kq is None and amax is None
    assert args[17:20] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert args[20] != args[21] and args[22:28] == (b, s, h, st, scale, 12)


def test_simt_entry_points_are_declared():
    """The f32 modes' C entries take 64-bit pointers and the cos / sin batch
    stride as a 64-bit integer, as the bf16 ones; the 3xTF32 K3 / K4 entries
    take qflux_flash_fwd's / qflux_flash_bwd's arguments, and the 3xTF32 K1
    / K2 entries their s_int8 ones' without qq, kq, amax and q_rows."""
    assert build._SIGNATURES["qflux_f32_fwd"] == build._SIGNATURES["qflux_flash_fwd"]
    assert build._SIGNATURES["qflux_f32_bwd"] == build._SIGNATURES["qflux_flash_bwd"]
    nr = build._SIGNATURES["qflux_f32_nr_int8_bwd"][1]
    assert build._SIGNATURES["qflux_f32_nr_bwd"][1] == nr[:17] + nr[21:]
    nf = build._SIGNATURES["qflux_f32_nr_int8_fwd"][1]
    assert build._SIGNATURES["qflux_f32_nr_fwd"][1] == nf[:11] + nf[15:]
    for name, n, stride_at in (("qflux_f32_fwd", 14, None), ("qflux_f32_bwd", 19, None),
                               ("qflux_f32_nr_fwd", 19, 7), ("qflux_f32_nr_int8_fwd", 23, 7),
                               ("qflux_f32_nr_bwd", 28, 7), ("qflux_f32_nr_int8_bwd", 32, 7)):
        restype, argtypes = build._SIGNATURES[name]
        assert restype is ctypes.c_int and len(argtypes) == n, name
        if stride_at is not None:
            assert argtypes[stride_at] is ctypes.c_longlong
        assert argtypes[-2] is ctypes.c_float and argtypes[-1] is ctypes.c_void_p


def test_cpu_tensors_never_reach_the_simt_entries(monkeypatch):
    """f32 and narrow bf16 CPU tensors go to the plain versions through the
    public entry points (counting no launch), and the launchers refuse them
    before any library is loaded."""
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "load_library", refuse)
    before = (tfa.F32_KERNEL_LAUNCHES, tfa.NARROW_KERNEL_LAUNCHES, tnr.F32_KERNEL_LAUNCHES)
    for dtype, d in SIMT_MODES:
        q, k, v, q_seg, kv_seg = _simt_qkv(40, 40, d, dtype, True, 1, 2)
        with pytest.raises(ValueError, match="CUDA"):
            tfa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, 0.1)
        assert tfa.flash_attention(q, k, v, q_seg).dtype == dtype
    q, k, v, qs2, ks2, cos, sin, ids = _f32_k1_args(1, 40, 2, True)
    with pytest.raises(ValueError, match="CUDA"):
        tnr._flash_nr_cuda(q, k, v, qs2, ks2, cos, sin, 8, ids, 0.1)
    assert tnr.flash_attention_nr(q, k, v, qs2, ks2, cos, sin, 8, segment_ids=ids)[0].dtype == \
        torch.float32
    assert (tfa.F32_KERNEL_LAUNCHES, tfa.NARROW_KERNEL_LAUNCHES,
            tnr.F32_KERNEL_LAUNCHES) == before


def test_simt_prep_launch_arguments():
    """The f32 mode's prep alone (`_launch_simt_prep`, what
    `_int8_operands_cuda` runs for f32 q) passes the inputs, the cos / sin
    batch stride, its scratch (qn, kn f32; qq, kq int8 and amax at q_rows >
    0), q_rows, the shape, st and the stream."""
    b, s, h, st, q_rows = 2, 300, 3, 40, 128
    q, k, v, qs2, ks2, cos, sin, _ = _f32_k1_args(b, s, h, False, seed=9)
    qs, ks, cs_bstride, _ = tnr._kernel_args(q, k, v, qs2, ks2, cos, sin, None)
    kl = _library()
    qn, kn, qq, kq, amax = tnr._launch_simt_prep(kl, 23, q, k, qs, ks, cos, sin, cs_bstride, st,
                                                 q_rows)
    (name, args), = kl.lib.calls
    assert name == "qflux_simt_nr_prep" and len(args) == len(build._SIGNATURES[name][1])
    assert args[:6] == tuple(t.data_ptr() for t in (q, k, qs, ks, cos, sin))
    assert args[6] == cs_bstride
    assert args[7:12] == tuple(t.data_ptr() for t in (qn, kn, qq, kq, amax))
    assert args[12:18] == (q_rows, b, s, h, st, 23)
    assert qn.dtype == kn.dtype == torch.float32 and qq.dtype == kq.dtype == torch.int8
    assert amax.shape == (b, h, 1 + -(-s // q_rows))


@pytest.mark.parametrize("masked", [False, True])
def test_int8_references_on_given_normed_operands(masked):
    """The plain s_int8 versions on `normed` = their own plain qn / kn equal
    the default call to the bit (the card's checks pass the f32 prep's qn /
    kn there), and on a qn one f32 ulp away they quantize that qn."""
    b, s, h, st = 1, 300, 2, 40
    q, k, v, qs2, ks2, cos, sin, ids = _f32_k1_args(b, s, h, masked, seed=5)
    qn = tnr.apply_qk_norm_rope(q, qs2, cos, sin, st)
    kn = tnr.apply_qk_norm_rope(k, ks2, cos, sin, st)
    out, lse = tnr.flash_attention_nr_int8_reference(q, k, v, qs2, ks2, cos, sin, st, 128,
                                                     segment_ids=ids)
    got = tnr.flash_attention_nr_int8_reference(q, k, v, qs2, ks2, cos, sin, st, 128,
                                                segment_ids=ids, normed=(qn, kn))
    assert torch.equal(got[0], out) and torch.equal(got[1], lse)
    do = torch.ones_like(q)
    want = tnr.flash_attention_nr_int8_bwd_reference(q, k, v, qs2, ks2, cos, sin, st, do, out,
                                                     lse, 128, segment_ids=ids)
    grads = tnr.flash_attention_nr_int8_bwd_reference(q, k, v, qs2, ks2, cos, sin, st, do, out,
                                                      lse, 128, segment_ids=ids,
                                                      normed=(qn, kn))
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    nudged = torch.nextafter(qn, torch.full_like(qn, float("inf")))
    _, _, (qq, _), _ = tnr._int8_operands(q, k, qs2, ks2, cos, sin, st, 128, (nudged, kn))
    assert torch.equal(qq, tnr.quant_rows(nudged, 128)[0])
