"""The host side of kernels K5a and K5b and of the row quantization before
them (qflux_tpu_torch/ops/int4_matmul.py): `_rq_plan`'s tiling at every
shape the smoke runs, the scratch and workspace the wrappers hand the C
entry points, and the arguments of those entry points, checked on CPU
tensors against a stand-in library that records its calls.  The kernels
themselves run only on the card (tests/test_torch_card.py).

K5a and K5b are each a regrid pass (the int4 weight onto the int8 grid,
into a K·N-byte scratch) and an int8 GEMM over 256 x 128 output tiles that
walks its contraction in 128-byte stages; where the tiles fill less than a
wave of the card, the contraction is split on whole stages into an int32
workspace that a reduction pass adds.
"""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from qflux_tpu_torch.ops import int4_matmul as ti4
from qflux_tpu_torch.ops import quant as tquant
from qflux_tpu_torch.runtime import build

SMS = 132  # an H100 SXM's SMs
CASES = sorted(set(chip_smoke.RQ_CASES) | set(chip_smoke.RQ_BWD_CASES))


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


def _stage_ranges(chunks, splits):
    """The stages [begin, end) split z walks: the kernels' formula
    (csrc/rq_int4_common.cuh:gemm_body)."""
    return [(z * chunks // splits, (z + 1) * chunks // splits) for z in range(splits)]


@pytest.mark.parametrize("backward", [False, True], ids=["k5a", "k5b"])
@pytest.mark.parametrize("m,k_in,n", CASES, ids=[f"{m}x{k}x{n}" for m, k, n in CASES])
def test_plan_at_every_smoke_shape(m, k_in, n, backward):
    """Every (M, K, N) the smoke runs (chip_smoke.RQ_CASES, RQ_BWD_CASES)
    gets a plan the kernels take: the shape passes the entry points' rules,
    the splits cover the contraction in non-empty ranges of whole 128-byte
    stages, a split grid stays within one wave, a grid that fills the card
    is not split, and the workspace and scratch are the sizes the kernels
    write."""
    gsz = min(128, k_in)
    plan = ti4._rq_plan(m, n, k_in, gsz, SMS, backward)
    assert ti4.kernel_group_size(k_in, n, k_in // gsz) == gsz
    out_cols, contraction = (k_in, n) if backward else (n, k_in)
    tiles = -(-m // ti4.RQ_BM) * -(-out_cols // ti4.RQ_BN)
    chunks = -(-contraction // ti4.RQ_BK)
    assert 1 <= plan.splits <= chunks
    ranges = _stage_ranges(chunks, plan.splits)
    assert all(b < e for b, e in ranges) and ranges[0][0] == 0 and ranges[-1][1] == chunks
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    if tiles >= SMS:
        assert plan.splits == 1
    if plan.splits > 1:
        assert tiles * plan.splits <= SMS
        assert plan.workspace == plan.splits * m * out_cols
    else:
        assert plan.workspace == 0
    assert plan.scratch == k_in * n


def test_plan_splits_the_narrow_grids():
    """The text stream's 256 rows split (K5a over K, K5b over N); the image
    stream's 3,744 rows fill the card and do not; proj_out's N = 64 (one
    column tile) splits its K."""
    assert ti4._rq_plan(256, 3072, 3072, 128, SMS).splits == 5
    assert ti4._rq_plan(256, 12288, 3072, 128, SMS, backward=True).splits == 5
    assert ti4._rq_plan(3744, 12288, 3072, 128, SMS).splits == 1
    assert ti4._rq_plan(3744, 3072, 12288, 128, SMS, backward=True).splits == 1
    assert ti4._rq_plan(3744, 64, 3072, 128, SMS).splits == 8


@pytest.mark.parametrize("k_in,n", chip_smoke.RQ_KN)
def test_every_model_shape_takes_the_new_kernels(k_in, n):
    """Every int4-requant GEMM of the Qwen DiT, img_in's K = 64 (one group
    straddling both nibble planes) and proj_out's N = 64 included, passes
    the entry points' rules, forward and backward; there is no second route."""
    for backward in (False, True):
        assert ti4._rq_plan(3744, n, k_in, min(128, k_in), SMS, backward).splits >= 1


@pytest.mark.parametrize("k_in,n,groups", [(96, 16, 1), (128, 24, 1), (128, 16, 3),
                                           (128, 16, 64)],
                         ids=["k_not_64", "n_not_16", "k_not_groups", "group_2"])
def test_plan_refuses_what_the_kernels_do_not_take(k_in, n, groups):
    with pytest.raises(ValueError, match="kernel takes"):
        ti4._rq_plan(300, n, k_in, k_in // groups)


def _rq_tensors(m=300, k_in=256, n=48, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.uniform(-1, 1, (k_in, n)) / np.sqrt(k_in)).astype(np.float32)
    q4, scale = tquant.quantize_kernel_int4(torch.from_numpy(w), 128)
    f, sv = tquant._requant_factors(scale)
    x = torch.from_numpy(rng.standard_normal((m, k_in)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    return q4, scale, f, sv, x.to(torch.bfloat16), g.to(torch.bfloat16)


def _signature_ok(name, args):
    argtypes = build._SIGNATURES[name][1]
    assert len(args) == len(argtypes)
    for a, t in zip(args, argtypes):
        if t is ctypes.c_void_p:
            assert a is None or (isinstance(a, int) and a >= 0), (name, a)
        else:
            assert isinstance(a, int), (name, a)


@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
def test_fwd_launch_arguments(split):
    """`_rq_fwd_launch` hands qflux_rq_int4_fwd xq, q4, f, sx, s_vec and out,
    the shape, the group size, the output type, the plan's split count, the
    q8 scratch and the workspace (None unsplit), and the stream."""
    q4, _, f, sv, x, _ = _rq_tensors()
    xq, sx = tquant._rowquant(x)
    sx = sx.reshape(-1)
    m, k_in = xq.shape
    n = q4.shape[1]
    plan = ti4.RqPlan(splits=3 if split else 1, workspace=3 * m * n if split else 0,
                      scratch=k_in * n)
    out = torch.empty(m, n, dtype=torch.float32)
    kl = _library()
    ti4._rq_fwd_launch(kl, 77, xq, q4, f, sx, sv, out, 128, plan, 1024, 4096 if split else None)
    (name, args), = kl.lib.calls
    assert name == "qflux_rq_int4_fwd"
    _signature_ok(name, args)
    assert args[:6] == tuple(t.data_ptr() for t in (xq, q4, f, sx, sv, out))
    assert args[6:11] == (m, n, k_in, 128, 1)
    assert args[11:] == (plan.splits, 1024, 4096 if split else None, 77)


@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
def test_bwd_launch_arguments(split):
    """`_rq_bwd_launch` hands qflux_rq_int4_bwd gq, q4, f, sg and dx, M, N,
    K, the group size, the output type, the split count, the q8 scratch,
    the workspace and the stream."""
    q4, _, f, sv, _, g = _rq_tensors()
    gq, sg = tquant._rowquant(g.float() * sv)
    sg = sg.reshape(-1)
    m, n = gq.shape
    k_in = 2 * q4.shape[0]
    plan = ti4.RqPlan(splits=2 if split else 1, workspace=2 * m * k_in if split else 0,
                      scratch=k_in * n)
    dx = torch.empty(m, k_in, dtype=torch.bfloat16)
    kl = _library()
    ti4._rq_bwd_launch(kl, 5, gq, q4, f, sg, dx, 128, plan, 2048, 8192 if split else None)
    (name, args), = kl.lib.calls
    assert name == "qflux_rq_int4_bwd"
    _signature_ok(name, args)
    assert args[:5] == tuple(t.data_ptr() for t in (gq, q4, f, sg, dx))
    assert args[5:10] == (m, n, k_in, 128, 0)
    assert args[10:] == (plan.splits, 2048, 8192 if split else None, 5)


@pytest.mark.parametrize("s_vec", [False, True], ids=["x", "g_times_s_vec"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rowquant_launch_arguments(s_vec, dtype):
    """`_rowquant_launch` hands qflux_rowquant x, s_vec (or None), xq, s, M,
    K, whether x is f32, and the stream."""
    x = torch.zeros(40, 96, dtype=dtype)
    sv = torch.ones(96) if s_vec else None
    xq = torch.empty(40, 96, dtype=torch.int8)
    s = torch.empty(40, 1)
    kl = _library()
    ti4._rowquant_launch(kl, 9, x, sv, xq, s)
    (name, args), = kl.lib.calls
    assert name == "qflux_rowquant"
    _signature_ok(name, args)
    assert args == (x.data_ptr(), sv.data_ptr() if s_vec else None, xq.data_ptr(), s.data_ptr(),
                    40, 96, int(dtype == torch.float32), 9)


@pytest.mark.parametrize("which", ["fwd", "bwd", "rowquant"])
def test_launch_raises_on_a_cuda_error(which):
    """A nonzero code from a C entry point raises with its message."""
    q4, _, f, sv, x, g = _rq_tensors(m=40)
    kl = _library(98)
    plan = ti4.RqPlan(splits=1, workspace=0, scratch=q4.numel() * 2)
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        if which == "fwd":
            xq, sx = tquant._rowquant(x)
            ti4._rq_fwd_launch(kl, 0, xq, q4, f, sx, sv, torch.empty(40, 48), 128, plan, 16,
                               None)
        elif which == "bwd":
            gq, sg = tquant._rowquant(g.float() * sv)
            ti4._rq_bwd_launch(kl, 0, gq, q4, f, sg, torch.empty(40, 256), 128, plan, 16, None)
        else:
            ti4._rowquant_launch(kl, 0, x, None, torch.empty(40, 256, dtype=torch.int8),
                                 torch.empty(40, 1))


def test_scratch_and_workspace_sizes(monkeypatch):
    """`_rq_buffers` keeps one byte buffer per (device, stream): the q8
    scratch (K·N bytes, rounded up to 256) at its start and, split, the int32
    workspace after it; it grows to the largest need and is reused."""
    monkeypatch.setattr(ti4, "_RQ_SCRATCH", {})
    cpu = torch.device("cpu")
    unsplit = ti4._rq_plan(3744, 12288, 3072, 128, SMS)
    q8, ws = ti4._rq_buffers(cpu, 3, unsplit)
    buf = ti4._RQ_SCRATCH[(None, 3)]
    assert ws is None and q8 == buf.data_ptr() and buf.numel() == 3072 * 12288
    split = ti4._rq_plan(256, 3072, 12288, 128, SMS)
    assert split.splits == 5
    q8, ws = ti4._rq_buffers(cpu, 3, split)
    buf = ti4._RQ_SCRATCH[(None, 3)]
    assert ws == q8 + 12288 * 3072 and buf.numel() == 12288 * 3072 + 4 * 5 * 256 * 3072
    small = ti4._rq_plan(300, 48, 256, 128, SMS)
    assert ti4._rq_buffers(cpu, 3, small)[0] == buf.data_ptr()  # reused, not shrunk
    assert ti4._RQ_SCRATCH[(None, 3)] is buf
    ti4._rq_buffers(cpu, 4, small)
    assert len(ti4._RQ_SCRATCH) == 2  # one buffer per stream


def test_cpu_tensors_never_reach_a_launcher(monkeypatch):
    """CPU tensors never load the library: the three launchers refuse them
    before any launch, and the public entry points send them to the plain
    versions (a forward and a backward through rq_fused_matmul, the row
    quantization in both forms), counting no launch."""
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "load_library", refuse)
    q4, scale, f, sv, x, g = _rq_tensors(m=40)
    before = (ti4.RQ_KERNEL_LAUNCHES, ti4.RQ_BWD_KERNEL_LAUNCHES, ti4.ROWQUANT_LAUNCHES)
    xq, sx = tquant._rowquant(x)
    with pytest.raises(ValueError, match="CUDA"):
        ti4.rowquant_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        ti4.rq_int4_fwd_cuda(xq, q4, f, sx, sv, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ti4.rq_int4_bwd_cuda(xq[:, :48].contiguous(), q4, f, sx, torch.bfloat16)
    xx = x.clone().requires_grad_()
    y = ti4.rq_fused_matmul(xx, q4, scale, (f, sv))
    y.backward(g)
    assert torch.equal(y, tquant.requant_int4_matmul(x, q4, scale, (f, sv)))
    assert torch.equal(xx.grad, tquant.requant_int4_matmul_dx(g, q4, (f, sv)))
    a, s = ti4.rowquant(x)
    assert torch.equal(a, xq) and torch.equal(s, sx)
    a, s = ti4.rowquant(g, sv)
    want = tquant._rowquant(g.float() * sv)
    assert torch.equal(a, want[0]) and torch.equal(s, want[1])
    assert (ti4.RQ_KERNEL_LAUNCHES, ti4.RQ_BWD_KERNEL_LAUNCHES,
            ti4.ROWQUANT_LAUNCHES) == before


@pytest.mark.parametrize("shape,dtype", [((40, 100), torch.bfloat16),
                                         ((40, 12296), torch.bfloat16),
                                         ((0, 64), torch.float32), ((40, 64), torch.float16)],
                         ids=["k_not_8", "k_past_12288", "no_rows", "float16"])
def test_rowquant_refuses_what_it_does_not_take(shape, dtype):
    """The row-quantization launcher's shape and type rules (checked before
    the library is loaded): K % 8 == 0, M > 0, bf16 or f32.  A row past
    12,288 values is taken (the two-sweep kernel for rows longer than the
    registers hold), as the AdaLN mods' dx needs at N = 18,432."""
    x = torch.zeros(shape, dtype=dtype)
    if shape[1] > 12288:
        ti4._rowquant_checks(x, None)
        ti4._rowquant_checks(torch.zeros(33, 18432, dtype=torch.float32), torch.ones(18432))
    else:
        with pytest.raises(ValueError, match="kernel takes"):
            ti4._rowquant_checks(x, None)
    ti4._rowquant_checks(torch.zeros(40, 12288, dtype=torch.float32), torch.ones(12288))
