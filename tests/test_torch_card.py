"""The port's CUDA kernels on the card: K1, K2, K3, K4, K5a, K5b, K6a and K6b
against their plain versions, LoRA gradients through K1 and K2 inside a
small DiT, and two-block, full-width Qwen-Image forwards and train steps
over an int4-requant base (through K5a, K5b, K1 and K2, and at path B's S =
4000 through K3 and K4) and over the W4A16 `int4` base (through K6a, K6b,
K1 and K2), the W8A8 matmul's kernels (csrc/int8_gemm.cu) against its
plain version, and every quantized form's quantization on the card
against the CPU's.

This file imports neither jax nor the JAX package, so it runs on a machine
with a card and without JAX:

    python3 -m pytest --noconftest -m cuda tests/test_torch_card.py

Every test is marked `cuda` and skips where torch sees no CUDA device.
Bounds are the ones chip_smoke.py states and explains.
"""

import dataclasses

import numpy as np
import pytest
import torch

from qflux_tpu_torch.ops import flash_nr as tnr

B, H, D = 2, 4, 128
ST = 96
pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (and nvcc) to build and run qflux_tpu_torch/csrc")


def _inputs(seed, s, per_sample_rope=False):
    """q/k/v bf16, scale pairs, cos/sin f32 ([S, D], or [B, S, D] per
    sample) on the card; S=300 is not a multiple of the kernels' 64- and
    128-row tiles."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, s, H, D)).astype(np.float32) for _ in range(3))
    qs2, ks2 = ((1 + 0.1 * rng.standard_normal((2, D))).astype(np.float32) for _ in range(2))
    ang = rng.uniform(0, 6.28, ((B, s) if per_sample_rope else (s,)) + (D // 2,))
    ang = ang.astype(np.float32)
    cos, sin = np.concatenate([np.cos(ang)] * 2, -1), np.concatenate([np.sin(ang)] * 2, -1)
    args = [torch.from_numpy(a).cuda() for a in (q, k, v, qs2, ks2, cos, sin)]
    return [a.to(torch.bfloat16) for a in args[:3]] + args[3:]


def _segments(kind, s):
    if kind is None:
        return None
    seg = np.ones((B, s), np.int32)
    seg[0, 230:] = 0      # sample 0 padded from token 230
    seg[1, ST:] = 2       # sample 1: two segments
    return torch.from_numpy(seg).cuda()


@pytest.mark.parametrize("seg_kind", [None, "masked"])
def test_kernel_matches_plain_on_card(seg_kind):
    """K1: out within 4 bf16 ulps at magnitude 1 (1.6e-2), lse within 1e-4."""
    args = _inputs(11, 300)
    seg = _segments(seg_kind, 300)
    out, lse = tnr.flash_attention_nr(*args, ST, segment_ids=seg)
    torch.cuda.synchronize()
    ref, ref_lse = tnr.flash_attention_nr_reference(*args, ST, segment_ids=seg)
    assert (out.float() - ref.float()).abs().max().item() <= 1.6e-2
    valid = ref_lse > -1e29
    assert (lse - ref_lse).abs()[valid].max().item() <= 1e-4
    if seg is not None:
        assert bool((out[0, 230:] == 0).all())


@pytest.mark.parametrize("s,seg_kind,per_sample_rope", [(300, None, False),
                                                        (300, "masked", False),
                                                        (40, None, True)])
def test_k2_matches_plain_on_card(s, seg_kind, per_sample_rope):
    """K2 with nonzero do on the padded rows: relative L2 error 1.5e-2 per
    gradient, and the padded rows' dq / dk / dv exactly 0.  S=40 is below
    one tile, with per-sample [B, S, D] rope tables (the multi-resolution
    layout, a nonzero cos/sin batch stride)."""
    args = _inputs(16, s, per_sample_rope)
    seg = _segments(seg_kind, s)
    do = torch.randn(B, s, H, D, device="cuda").to(torch.bfloat16)
    out, lse = tnr._flash_nr_cuda(*args, ST, seg, D ** -0.5)
    got = tnr._flash_nr_bwd_cuda(*args, ST, seg, D ** -0.5, out, lse, do)
    torch.cuda.synchronize()
    ref = tnr.flash_attention_nr_bwd_reference(*args, ST, do, segment_ids=seg)
    for g, r in zip(got, ref):
        assert ((g.float() - r).norm() / r.norm()).item() <= 1.5e-2
    if seg is not None:
        assert all(not g[0, 230:].any() for g in got[:3])


def test_lora_grads_reach_qkv_through_kernels_on_card():
    """A two-block DiT at head dim 128, bf16, remat "flash": backward
    through K1 (forward) and K2 (backward) gives every to_q / to_k / to_v
    LoRA a nonzero gradient, close to the one through the plain attention
    (relative L2 error 5e-2: bf16 rounding at different points on the two
    paths), with one K1 and one K2 launch per block."""
    from qflux_tpu_torch.models.flux import transformer as tflux
    from qflux_tpu_torch.ops.layers import build_lora_tree, mark_trainable, merge_lora
    from qflux_tpu_torch.ops.rope import flux_image_ids, flux_text_ids

    cfg = dataclasses.replace(tflux.FluxConfig.tiny(), num_layers=1, num_single_layers=1,
                              attention_head_dim=128, num_attention_heads=2,
                              axes_dims_rope=(16, 56, 56))
    gen = torch.Generator("cuda").manual_seed(0)
    model = tflux.init(gen, cfg, "cuda", torch.bfloat16)
    lora = mark_trainable(build_lora_tree(gen, model, [r"attn/(to_q|to_k|to_v)"], 4, 4.0))
    with torch.no_grad():
        for leaf in lora.values():
            leaf["b"].normal_(0.0, 0.05, generator=gen)
    merge_lora(model, lora)
    ids = torch.from_numpy(np.concatenate([flux_image_ids(8, 8, 0),
                                           flux_image_ids(8, 8, 1)])).cuda()
    txt_ids = torch.from_numpy(flux_text_ids(16)).cuda()
    bf = torch.bfloat16
    x = torch.randn(1, 128, cfg.in_channels, device="cuda", generator=gen).to(bf)
    txt = torch.randn(1, 16, cfg.joint_attention_dim, device="cuda", generator=gen).to(bf)
    pooled = torch.randn(1, cfg.pooled_projection_dim, device="cuda", generator=gen).to(bf)
    t = torch.full((1,), 0.5, device="cuda")

    def grads(attn_impl):
        for leaf in lora.values():
            leaf["a"].grad = leaf["b"].grad = None
        y = tflux.forward(model, cfg, x, txt, pooled, t, ids, txt_ids, guidance=t,
                          attn_impl=attn_impl, remat_policy="flash")
        y.float().pow(2).mean().backward()
        for leaf in lora.values():
            assert leaf["a"].grad.abs().sum() > 0 and leaf["b"].grad.abs().sum() > 0
        return torch.cat([leaf[k].grad.flatten() for leaf in lora.values() for k in ("a", "b")])

    k1, k2 = tnr.KERNEL_LAUNCHES, tnr.BWD_KERNEL_LAUNCHES
    g_kernel = grads("auto")
    assert tnr.KERNEL_LAUNCHES - k1 == 2 and tnr.BWD_KERNEL_LAUNCHES - k2 == 2
    g_plain = grads("plain")
    assert ((g_kernel - g_plain).norm() / g_plain.norm()).item() <= 5e-2


@pytest.mark.parametrize("m,k_in,n,dtype", [(300, 3072, 64, torch.bfloat16),
                                            (77, 64, 256, torch.float32),
                                            (129, 3584, 144, torch.bfloat16)],
                         ids=["proj_out_n64", "img_in_k64_straddling_group", "ragged_m_n"])
def test_rq_kernel_bit_exact_on_card(m, k_in, n, dtype):
    """K5a equals the plain requant matmul to the bit: ragged M and N, N=64,
    and K=64 with one group over both nibble planes (group size min(128,
    K)), in bf16 and f32."""
    from qflux_tpu_torch.ops import int4_matmul, quant

    gen = torch.Generator("cuda").manual_seed(m)
    w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
    q4, scale = quant.quantize_kernel_int4(w, 128)
    factors = quant._requant_factors(scale)
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(dtype)
    before = int4_matmul.RQ_KERNEL_LAUNCHES
    got = int4_matmul.rq_fused_matmul(x, q4, scale, factors)
    torch.cuda.synchronize()
    assert int4_matmul.RQ_KERNEL_LAUNCHES == before + 1
    want = quant.requant_int4_matmul(x, q4, scale, factors)
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, want)


def test_qwen_forward_through_k5a_and_k1_on_card():
    """Two blocks of the 20B Qwen-Image DiT at full width (dim 3072, 24 heads
    × 128, joint dim 3584) over an int4-requant base, bf16: one forward
    launches K5a 2·12 + 3 times (the block projections and MLPs, img_in,
    txt_in, proj_out; the mods and time_in take the dequantized product) and
    K1 twice, and equals the plain requant route to the bit."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.models.qwen import transformer as tqwen
    from qflux_tpu_torch.ops import int4_matmul
    from qflux_tpu_torch.ops.layers import set_int4_impl
    from qflux_tpu_torch.ops.quant import quantize_tree

    qcfg = config_from_dict({"model": {"quantize": {"enabled": True,
                                                    "dtype": "int4_requant"}}}).model.quantize
    cfg = dataclasses.replace(tqwen.QwenImageConfig(), num_layers=2)
    gen = torch.Generator("cuda").manual_seed(0)
    model = quantize_tree(tqwen.init(gen, cfg, "cuda", torch.bfloat16, quantize=qcfg), qcfg)
    shapes = [(1, 8, 8), (1, 8, 8)]
    x = torch.randn(1, 128, cfg.in_channels, device="cuda", generator=gen).to(torch.bfloat16)
    txt = torch.randn(1, 40, cfg.joint_attention_dim, device="cuda",
                      generator=gen).to(torch.bfloat16)
    seg = torch.ones(1, 40 + 128, dtype=torch.int32, device="cuda")
    seg[0, 33:40] = 0
    t = torch.full((1,), 0.5, device="cuda", dtype=torch.bfloat16)
    with torch.inference_mode():
        k5, k1 = int4_matmul.RQ_KERNEL_LAUNCHES, tnr.KERNEL_LAUNCHES
        y = tqwen.forward(model, cfg, x, txt, t, shapes, segment_ids=seg)
        torch.cuda.synchronize()
        assert int4_matmul.RQ_KERNEL_LAUNCHES - k5 == 2 * 12 + 3
        assert tnr.KERNEL_LAUNCHES - k1 == 2
        set_int4_impl(model, "plain")
        y_plain = tqwen.forward(model, cfg, x, txt, t, shapes, segment_ids=seg)
        assert int4_matmul.RQ_KERNEL_LAUNCHES - k5 == 2 * 12 + 3
    assert y.shape == (1, 128, 64) and bool(torch.isfinite(y).all())
    assert torch.equal(y, y_plain)


@pytest.mark.parametrize("m,k_in,n,dtype", [(300, 3072, 64, torch.bfloat16),
                                            (77, 64, 256, torch.float32),
                                            (129, 3584, 144, torch.bfloat16)],
                         ids=["proj_out_n64", "img_in_k64_straddling_group", "ragged_m_n_k"])
def test_rq_bwd_kernel_bit_exact_on_card(m, k_in, n, dtype):
    """K5b, through rq_fused_matmul's backward, equals the plain backward
    (quant.requant_int4_matmul_dx) to the bit: ragged M, a contraction N
    that ends inside a 128-wide stage (144; the kernels take N % 16 == 0),
    K = 64 (one group over both nibble planes) and K = 3584, in bf16 and
    f32."""
    from qflux_tpu_torch.ops import int4_matmul, quant

    gen = torch.Generator("cuda").manual_seed(m + 1)
    w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
    q4, scale = quant.quantize_kernel_int4(w, 128)
    factors = quant._requant_factors(scale)
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(dtype).requires_grad_()
    g = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    before = (int4_matmul.RQ_KERNEL_LAUNCHES, int4_matmul.RQ_BWD_KERNEL_LAUNCHES)
    int4_matmul.rq_fused_matmul(x, q4, scale, factors).backward(g)
    torch.cuda.synchronize()
    assert (int4_matmul.RQ_KERNEL_LAUNCHES, int4_matmul.RQ_BWD_KERNEL_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = quant.requant_int4_matmul_dx(g, q4, factors)
    assert x.grad.dtype == dtype and x.grad.shape == (m, k_in)
    assert torch.equal(x.grad, want)


# the int4-requant GEMM shapes of the Qwen DiT (chip_smoke.py:RQ_KN): block
# projections, MLP up / down, txt_in, img_in, proj_out
RQ_KN = [(3072, 3072), (3072, 12288), (12288, 3072), (3584, 3072), (64, 3072), (3072, 64)]
RQ_BIT_CASES = ([(m, k, n, torch.bfloat16) for m in (33, 256, 3744) for k, n in RQ_KN]
                + [(3744, 3072, 12288, torch.float32), (256, 3072, 3072, torch.float32),
                   (7488, 3072, 12288, torch.bfloat16)])


def _rq_weights(gen, k_in, n):
    from qflux_tpu_torch.ops import quant

    w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
    q4, scale = quant.quantize_kernel_int4(w, 128)
    return q4, scale, quant._requant_factors(scale)


@pytest.mark.parametrize("m,k_in,n,dtype", RQ_BIT_CASES,
                         ids=[f"{m}x{k}x{n}_{str(d)[6:]}" for m, k, n, d in RQ_BIT_CASES])
def test_rq_fwd_every_model_shape_bit_exact(m, k_in, n, dtype):
    """K5a (the regrid pass, the int8 GEMM and, split, its reduction) equals
    the plain requant matmul to the bit at every int4-requant GEMM shape of
    the Qwen DiT, at ragged M (33, 3744, 7488), split (the text stream's 256
    rows, proj_out) and unsplit, bf16 and f32 outputs; two calls give the
    same bits."""
    from qflux_tpu_torch.ops import int4_matmul, quant

    gen = torch.Generator("cuda").manual_seed(m + k_in + n)
    q4, scale, factors = _rq_weights(gen, k_in, n)
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(dtype)
    got = int4_matmul.rq_fused_matmul(x, q4, scale, factors)
    again = int4_matmul.rq_fused_matmul(x, q4, scale, factors)
    torch.cuda.synchronize()
    want = quant.requant_int4_matmul(x, q4, scale, factors)
    assert got.dtype == dtype and torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.parametrize("m,k_in,n,dtype", RQ_BIT_CASES,
                         ids=[f"{m}x{k}x{n}_{str(d)[6:]}" for m, k, n, d in RQ_BIT_CASES])
def test_rq_bwd_every_model_shape_bit_exact(m, k_in, n, dtype):
    """K5b, through rq_fused_matmul's backward (the row quantization of
    g · s_vec, the regrid pass, the int8 GEMM and, split, its reduction),
    equals the plain backward to the bit at the dx of every case above; two
    backward calls give the same bits."""
    from qflux_tpu_torch.ops import int4_matmul, quant

    gen = torch.Generator("cuda").manual_seed(m + k_in + n + 1)
    q4, scale, factors = _rq_weights(gen, k_in, n)
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(dtype).requires_grad_()
    g = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    int4_matmul.rq_fused_matmul(x, q4, scale, factors).backward(g)
    got = x.grad
    x.grad = None
    int4_matmul.rq_fused_matmul(x, q4, scale, factors).backward(g)
    torch.cuda.synchronize()
    want = quant.requant_int4_matmul_dx(g, q4, factors)
    assert got.dtype == dtype and torch.equal(got, want) and torch.equal(got, x.grad)


def test_rq_split_and_unsplit_agree_on_card():
    """The same K5a / K5b call at every split count the plan allows up to
    8 (the int32 partial sums added by the reduction pass) gives the
    unsplit bits: the split changes no result."""
    from qflux_tpu_torch.ops import int4_matmul
    from qflux_tpu_torch.runtime.build import load_library

    gen = torch.Generator("cuda").manual_seed(5)
    m, k_in, n = 256, 3072, 3072
    q4, _, (f, sv) = _rq_weights(gen, k_in, n)
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(torch.bfloat16)
    xq, sx = int4_matmul.rowquant_cuda(x)
    kl, stream = load_library(), torch.cuda.current_stream().cuda_stream
    outs = []
    for backward in (False, True):
        for splits in (1, 2, 5, 8):
            plan = int4_matmul.RqPlan(splits=splits,
                                      workspace=splits * m * (k_in if backward else n),
                                      scratch=k_in * n)
            q8 = torch.empty(plan.scratch, device="cuda", dtype=torch.uint8)
            ws = torch.empty(max(plan.workspace, 1), device="cuda", dtype=torch.int32)
            if backward:
                out = torch.empty(m, k_in, device="cuda", dtype=torch.bfloat16)
                int4_matmul._rq_bwd_launch(kl, stream, xq[:, :n].contiguous(), q4, f, sx, out,
                                           128, plan, q8.data_ptr(), ws.data_ptr())
            else:
                out = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
                int4_matmul._rq_fwd_launch(kl, stream, xq, q4, f, sx, sv, out, 128, plan,
                                           q8.data_ptr(), ws.data_ptr())
            outs.append(out)
    torch.cuda.synchronize()
    for out in outs[1:4]:
        assert torch.equal(out, outs[0])
    for out in outs[5:]:
        assert torch.equal(out, outs[4])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [64, 3072, 12288, 136, 12296, 18432])
def test_rowquant_kernel_bit_exact_on_card(k, dtype):
    """The row-quantization kernel equals quant._rowquant to the bit, for
    bf16 and f32 rows of 64 to 18,432 values (lengths that are not a
    multiple of the block's 2,048-value sweep; past 12,288 the two-sweep
    kernel for rows longer than the registers hold): an all-zero row (scale
    clamped to 1e-12, values 0), a row whose amax is 127 (scale exactly 1)
    with exact half-way quotients (±0.5, ±2.5, 126.5: half to even), and
    random rows; and in K5b's form, g · s_vec, against
    quant._rowquant(g.float() * s_vec).  The launch counter moves once a
    call through `rowquant`."""
    from qflux_tpu_torch.ops import int4_matmul, quant

    gen = torch.Generator("cuda").manual_seed(k)
    x = torch.randn(300, k, device="cuda", generator=gen) * 3
    x[7] = 0.0
    x[8] = 0.0
    x[8, :6] = torch.tensor([127.0, 0.5, -0.5, 2.5, -2.5, 126.5])
    x = x.to(dtype)
    sv = torch.rand(k, device="cuda", generator=gen) + 0.5
    before = int4_matmul.ROWQUANT_LAUNCHES
    xq, s = int4_matmul.rowquant(x)
    gq, sg = int4_matmul.rowquant(x, sv)
    torch.cuda.synchronize()
    assert int4_matmul.ROWQUANT_LAUNCHES == before + 2
    want_q, want_s = quant._rowquant(x)
    assert xq.dtype == torch.int8 and s.shape == (300, 1)
    assert torch.equal(xq, want_q) and torch.equal(s, want_s)
    assert s[7].item() == np.float32(1e-12) and not xq[7].any() and s[8].item() == 1.0
    assert xq[8, :6].tolist() == [127, 0, 0, 2, -2, 126]
    want_gq, want_sg = quant._rowquant(x.float() * sv)
    assert torch.equal(gq, want_gq) and torch.equal(sg, want_sg)


def test_rowquant_scale_is_the_jitted_product_on_card():
    """`quant._rowquant`'s scale on the card is amax · fl32(1/127), the
    product JAX computes under `jit`, not a true division by 127: on rows
    whose amax is chosen where the two round apart, it equals numpy's
    a * np.float32(1/127) and differs from a / np.float32(127)."""
    from qflux_tpu_torch.ops import quant

    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 8.0, 200_000).astype(np.float32)
    prod = a * np.float32(1 / 127)
    apart = a[prod != a / np.float32(127)][:64]
    assert len(apart) == 64
    x = torch.zeros(64, 96, device="cuda")
    x[:, 5] = torch.from_numpy(apart).cuda()
    _, s = quant._rowquant(x)
    np.testing.assert_array_equal(s[:, 0].cpu().numpy(), apart * np.float32(1 / 127))
    assert (s[:, 0].cpu().numpy() != apart / np.float32(127)).all()


def test_qwen_train_step_through_kernels_on_card():
    """Two blocks of the 20B Qwen-Image DiT at full width over an
    int4-requant base, bf16, a rank-16 LoRA on the eight attention
    projections: one forward + backward under "flash_offload" launches K1
    and K2 once a block, K5a 2·12 + 3 times in the forward and 2·12 again in
    the recompute, and K5b 6 + 9 + 1 times (block 0's q/k/v inputs carry no
    gradient; the last block's add_out and text MLP feed only the dropped
    text stream); under "flash" the same counts; the LoRA gradients of the
    two policies are identical to the bit, and every LoRA layer but the
    last block's add_q and add_out gets a nonzero one."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.models.qwen import transformer as tqwen
    from qflux_tpu_torch.ops import int4_matmul
    from qflux_tpu_torch.ops.layers import build_lora_tree, mark_trainable, merge_lora
    from qflux_tpu_torch.ops.quant import quantize_tree

    qcfg = config_from_dict({"model": {"quantize": {"enabled": True,
                                                    "dtype": "int4_requant"}}}).model.quantize
    cfg = dataclasses.replace(tqwen.QwenImageConfig(), num_layers=2)
    gen = torch.Generator("cuda").manual_seed(1)
    model = quantize_tree(tqwen.init(gen, cfg, "cuda", torch.bfloat16, quantize=qcfg), qcfg)
    lora = build_lora_tree(gen, model, [r"attn/(to_q|to_k|to_v|to_out|add_q|add_k|add_v|add_out)"],
                           16, 16.0)
    with torch.no_grad():
        for leaf in lora.values():
            leaf["b"].normal_(0.0, 0.005, generator=gen)
    mark_trainable(lora)
    merge_lora(model, lora)
    shapes = [(1, 8, 8), (1, 8, 8)]
    x = torch.randn(1, 128, cfg.in_channels, device="cuda", generator=gen).to(torch.bfloat16)
    txt = torch.randn(1, 40, cfg.joint_attention_dim, device="cuda",
                      generator=gen).to(torch.bfloat16)
    seg = torch.ones(1, 40 + 128, dtype=torch.int32, device="cuda")
    seg[0, 33:40] = 0
    t = torch.full((1,), 0.5, device="cuda", dtype=torch.bfloat16)
    target = torch.randn(1, 128, 64, device="cuda", generator=gen)
    grads = {}
    for policy in ("flash_offload", "flash"):
        for leaf in lora.values():
            for v in leaf.values():
                v.grad = None
        counts = (tnr.KERNEL_LAUNCHES, tnr.BWD_KERNEL_LAUNCHES, int4_matmul.RQ_KERNEL_LAUNCHES,
                  int4_matmul.RQ_BWD_KERNEL_LAUNCHES)
        y = tqwen.forward(model, cfg, x, txt, t, shapes, segment_ids=seg, remat_policy=policy)
        (y.float() - target).square().mean().backward()
        torch.cuda.synchronize()
        launched = (tnr.KERNEL_LAUNCHES - counts[0], tnr.BWD_KERNEL_LAUNCHES - counts[1],
                    int4_matmul.RQ_KERNEL_LAUNCHES - counts[2],
                    int4_matmul.RQ_BWD_KERNEL_LAUNCHES - counts[3])
        assert launched == (2, 2, 2 * 12 + 3 + 2 * 12, 6 + 9 + 1), (policy, launched)
        grads[policy] = {p: [None if leaf[k].grad is None else leaf[k].grad.clone()
                             for k in ("a", "b")] for p, leaf in lora.items()}
    merge_lora(model, None)
    for path, (ga, gb) in grads["flash"].items():
        oa, ob = grads["flash_offload"][path]
        if path in ("blocks/1/attn/add_q", "blocks/1/attn/add_out"):
            assert all(g is None or not g.any() for g in (ga, gb, oa, ob)), path
            continue
        assert torch.equal(ga, oa) and torch.equal(gb, ob), path
        assert ga.abs().sum() > 0 and gb.abs().sum() > 0, path


# ---------------------------------------------------------------------------
# the s_int8 mode of K1 and K2 (quantize.attention)

# S, st, masked text tail: the Qwen path at 512² (256 text tokens, the last
# 26 padding; q tiles 256 forward, 128 backward), FLUX at 512² unmasked
# (256 / 128), and S = 1024 (256 / 256)
INT8_CASES = [(2304, 256, True), (2560, 512, False), (1024, 256, False)]
# chip_smoke.py's bounds (relative L2), and why: K1 and the plain version
# quantize the same normed q / k to the same int8 values (the prep test
# below holds that to the bit), but a normed value that lands one bf16 ulp
# apart (f32 sums in another order before the round) moves one int8 step,
# and the kernel rounds p to bf16 before PV as K1 does
INT8_FWD_REL, INT8_BWD_REL = 3e-2, 1e-1


def _int8_inputs(seed, s, h=4):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, s, h, D)).astype(np.float32) for _ in range(3))
    qs2, ks2 = ((1 + 0.1 * rng.standard_normal((2, D))).astype(np.float32) for _ in range(2))
    ang = rng.uniform(0, 6.28, (s, D // 2)).astype(np.float32)
    cos, sin = np.concatenate([np.cos(ang)] * 2, -1), np.concatenate([np.sin(ang)] * 2, -1)
    args = [torch.from_numpy(a).cuda() for a in (q, k, v, qs2, ks2, cos, sin)]
    return [a.to(torch.bfloat16) for a in args[:3]] + args[3:]


def _int8_seg(s, st, masked):
    if not masked:
        return None
    seg = torch.ones(1, s, dtype=torch.int32, device="cuda")
    seg[0, st - 26:st] = 0
    return seg


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("s,st,masked", INT8_CASES)
def test_int8_prep_bit_identical_to_quant_tile(s, st, masked):
    """The prep's int8 q (the backward's tiles) and k and their scales equal
    quant_rows (JAX's `_quant_tile` per tile) of the prep's own normed q / k
    to the bit, and those normed q / k are K1's bf16 normed values (the plain
    apply_qk_norm_rope to within one bf16 ulp)."""
    q, k, _, qs2, ks2, cos, sin = _int8_inputs(21, s)
    fwd_rows, bwd_rows = tnr.s_int8_tiles(s, D)
    for rows in {fwd_rows, bwd_rows}:
        qn, kn, qq, kq, q_sc, k_sc = tnr._int8_operands_cuda(q, k, qs2, ks2, cos, sin, st, rows)
        torch.cuda.synchronize()
        want_qq, want_qsc = tnr.quant_rows(qn, rows)
        want_kq, want_ksc = tnr.quant_rows(kn, s)
        assert torch.equal(qq, want_qq) and torch.equal(q_sc, want_qsc)
        assert torch.equal(kq, want_kq) and torch.equal(k_sc, want_ksc[:, 0])
        ref = tnr.apply_qk_norm_rope(q, qs2, cos, sin, st)
        assert (qn.float() - ref.float()).abs().max().item() <= 2 ** -8 * 8


@pytest.mark.parametrize("s,st,masked", INT8_CASES)
def test_k1_k2_s_int8_match_plain_on_card(s, st, masked):
    """K1's and K2's s_int8 modes against their plain versions (the
    backward over its own q tiles, against the kernel's lse), with nonzero
    do on the padded rows: out within INT8_FWD_REL, lse within 1e-2
    absolute, each gradient within INT8_BWD_REL, the padded rows' out and
    gradients exactly 0."""
    args = _int8_inputs(22, s)
    seg = _int8_seg(s, st, masked)
    fwd_rows, bwd_rows = tnr.s_int8_tiles(s, D)
    scale = 1.0 / D ** 0.5
    do = torch.randn(args[0].shape, device="cuda").to(torch.bfloat16)
    out, lse = tnr._flash_nr_cuda(*args, st, seg, scale, fwd_rows)
    got = tnr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do, bwd_rows)
    torch.cuda.synchronize()
    ref, ref_lse = tnr.flash_attention_nr_int8_reference(*args, st, fwd_rows, segment_ids=seg)
    assert _rel(out, ref) <= INT8_FWD_REL and bool(torch.isfinite(out).all())
    valid = ref_lse > -1e29
    assert (lse - ref_lse).abs()[valid].max().item() <= 1e-2
    want = tnr.flash_attention_nr_int8_bwd_reference(*args, st, do, out, lse, bwd_rows,
                                                     segment_ids=seg)
    for g, r in zip(got, want):
        assert _rel(g, r) <= INT8_BWD_REL and bool(torch.isfinite(g).all())
    if masked:
        assert not out[0, st - 26:st].any()
        assert all(not g[0, st - 26:st].any() for g in got[:3])


def test_s_int8_on_cuda_never_reaches_the_plain_version(monkeypatch):
    """With the plain versions replaced by a raising double, a forward and
    backward of flash_attention_nr(s_int8=True) on CUDA tensors still runs:
    one K1 and one K2 s_int8 launch, no bf16 launch."""
    def boom(*a, **k):
        raise AssertionError("the plain version was called on CUDA tensors")

    for name in ("flash_attention_nr_int8_reference", "flash_attention_nr_int8_bwd_reference",
                 "flash_attention_nr_reference", "flash_attention_nr_bwd_reference"):
        monkeypatch.setattr(tnr, name, boom)
    q, k, v, qs2, ks2, cos, sin = _int8_inputs(23, 1024)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, qs2, ks2)]
    counts = (tnr.KERNEL_LAUNCHES, tnr.BWD_KERNEL_LAUNCHES, tnr.INT8_KERNEL_LAUNCHES,
              tnr.INT8_BWD_KERNEL_LAUNCHES)
    out, _ = tnr.flash_attention_nr(*leaves, cos, sin, 256, s_int8=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (tnr.KERNEL_LAUNCHES, tnr.BWD_KERNEL_LAUNCHES, tnr.INT8_KERNEL_LAUNCHES,
            tnr.INT8_BWD_KERNEL_LAUNCHES) == (counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in leaves)


def test_qwen_train_step_int8_attention_on_card():
    """Two blocks of the 20B Qwen-Image DiT at full width over an
    int4-requant base with attn_impl="int8" (S = 40 + 128 = 168: q tiles
    256 / 256), remat "flash": one forward + backward launches K1's and
    K2's s_int8 modes once a block and their bf16 modes never, K5a 2·12 +
    3 + 2·12 and K5b 16 times; the LoRA gradients are close to those of the
    plain int8 path ("int8_plain", relative L2 INT8_BWD_REL over all) and
    every LoRA layer but the last block's add_q and add_out gets one."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.models.qwen import transformer as tqwen
    from qflux_tpu_torch.ops import int4_matmul
    from qflux_tpu_torch.ops.layers import build_lora_tree, mark_trainable, merge_lora
    from qflux_tpu_torch.ops.quant import quantize_tree

    qcfg = config_from_dict({"model": {"quantize": {"enabled": True, "dtype": "int4_requant",
                                                    "attention": True}}}).model.quantize
    cfg = dataclasses.replace(tqwen.QwenImageConfig(), num_layers=2)
    gen = torch.Generator("cuda").manual_seed(2)
    model = quantize_tree(tqwen.init(gen, cfg, "cuda", torch.bfloat16, quantize=qcfg), qcfg)
    lora = build_lora_tree(gen, model, [r"attn/(to_q|to_k|to_v|to_out|add_q|add_k|add_v|add_out)"],
                           16, 16.0)
    with torch.no_grad():
        for leaf in lora.values():
            leaf["b"].normal_(0.0, 0.005, generator=gen)
    mark_trainable(lora)
    merge_lora(model, lora)
    shapes = [(1, 8, 8), (1, 8, 8)]
    x = torch.randn(1, 128, cfg.in_channels, device="cuda", generator=gen).to(torch.bfloat16)
    txt = torch.randn(1, 40, cfg.joint_attention_dim, device="cuda",
                      generator=gen).to(torch.bfloat16)
    seg = torch.ones(1, 40 + 128, dtype=torch.int32, device="cuda")
    seg[0, 33:40] = 0
    t = torch.full((1,), 0.5, device="cuda", dtype=torch.bfloat16)
    target = torch.randn(1, 128, 64, device="cuda", generator=gen)
    grads = {}
    for impl, policy in (("int8", "flash"), ("int8_plain", "full")):
        for leaf in lora.values():
            for v in leaf.values():
                v.grad = None
        counts = (tnr.KERNEL_LAUNCHES, tnr.BWD_KERNEL_LAUNCHES, tnr.INT8_KERNEL_LAUNCHES,
                  tnr.INT8_BWD_KERNEL_LAUNCHES, int4_matmul.RQ_KERNEL_LAUNCHES,
                  int4_matmul.RQ_BWD_KERNEL_LAUNCHES)
        y = tqwen.forward(model, cfg, x, txt, t, shapes, segment_ids=seg, attn_impl=impl,
                          remat_policy=policy)
        (y.float() - target).square().mean().backward()
        torch.cuda.synchronize()
        launched = tuple(b - a for a, b in zip(counts, (
            tnr.KERNEL_LAUNCHES, tnr.BWD_KERNEL_LAUNCHES, tnr.INT8_KERNEL_LAUNCHES,
            tnr.INT8_BWD_KERNEL_LAUNCHES, int4_matmul.RQ_KERNEL_LAUNCHES,
            int4_matmul.RQ_BWD_KERNEL_LAUNCHES)))
        if impl == "int8":
            assert launched == (0, 0, 2, 2, 2 * 12 + 3 + 2 * 12, 6 + 9 + 1), launched
        else:
            assert launched[:4] == (0, 0, 0, 0), launched
        grads[impl] = {p: torch.cat([torch.zeros_like(leaf[k]).flatten() if leaf[k].grad is None
                                     else leaf[k].grad.flatten() for k in ("a", "b")])
                       for p, leaf in lora.items()}
    merge_lora(model, None)
    gk, gp = (torch.cat(list(g.values())) for g in (grads["int8"], grads["int8_plain"]))
    assert _rel(gk, gp) <= INT8_BWD_REL
    for path, g in grads["int8"].items():
        zero = path in ("blocks/1/attn/add_q", "blocks/1/attn/add_out")
        assert bool(g.abs().sum() > 0) != zero, path


# ---------------------------------------------------------------------------
# the W4A16 int4 base (quantize.dtype int4): K6a and K6b

# chip_smoke.py's bounds, and why: the kernel and the plain version multiply
# the same bf16 weights and activations (every product exact in f32) and sum
# in f32 in another order, so their outputs round to bf16 at the same point
# and land at most an ulp or two apart: relative L2 4e-3 (one bf16 ulp is
# 2^-8 = 3.9e-3 relative) and max |diff| 2 bf16 ulps of max |ref| (2^-6 of it)
K6_REL, K6_MAX = 4e-3, 2 ** -6
# (M, K, N, x dtype): an AdaLN mod (one row, f32 in and out), a ragged M at
# the block projections' width, and the MLP down-projection's K; then path
# C's main shape (the MLP up-projection at bs=1, 256-row blocks), the text
# stream's MLP down-projection (M = 256, K = 12288: the contraction split
# across blocks and reduced in a second pass), the block projections at bs=2
# and the mods at bs=2 (M = 2, f32)
K6_CASES = [(1, 3072, 18432, torch.float32), (300, 3072, 384, torch.bfloat16),
            (129, 12288, 256, torch.bfloat16), (2048, 3072, 12288, torch.bfloat16),
            (256, 12288, 3072, torch.bfloat16), (4096, 3072, 3072, torch.bfloat16),
            (2, 3072, 18432, torch.float32)]
K6_IDS = ["mod_m1_f32", "ragged_m", "k12288", "main", "split_k", "bs2", "mod_m2_f32"]


def _int4_weight(gen, k_in, n):
    from qflux_tpu_torch.ops import quant

    w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
    return quant.quantize_kernel_int4(w, 128)


def _k6_close(got, want):
    want = want.float()
    diff = got.float() - want
    return ((diff.norm() / want.norm()).item() <= K6_REL
            and diff.abs().max().item() <= K6_MAX * want.abs().max().item())


@pytest.mark.parametrize("m,k_in,n,dtype", K6_CASES, ids=K6_IDS)
def test_k6a_matches_plain_on_card(m, k_in, n, dtype):
    """K6a, through int4_matmul (the custom op), against int4_matmul_reference:
    the output in x's dtype within K6_REL / K6_MAX, one launch."""
    from qflux_tpu_torch.ops import int4_matmul

    gen = torch.Generator("cuda").manual_seed(m)
    q4, scale = _int4_weight(gen, k_in, n)
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(dtype)
    before = int4_matmul.INT4_KERNEL_LAUNCHES
    got = int4_matmul.int4_matmul(x, q4, scale)
    torch.cuda.synchronize()
    assert int4_matmul.INT4_KERNEL_LAUNCHES == before + 1
    want = int4_matmul.int4_matmul_reference(x, q4, scale)
    assert got.dtype == dtype and got.shape == (m, n) and bool(torch.isfinite(got).all())
    assert _k6_close(got, want)


@pytest.mark.parametrize("m,k_in,n,dtype", K6_CASES, ids=K6_IDS)
def test_k6b_matches_plain_on_card(m, k_in, n, dtype):
    """K6b, through int4_matmul's backward, against int4_matmul_dx_reference:
    dx in g's dtype within K6_REL / K6_MAX, one forward and one backward
    launch."""
    from qflux_tpu_torch.ops import int4_matmul

    gen = torch.Generator("cuda").manual_seed(m + 1)
    q4, scale = _int4_weight(gen, k_in, n)
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(dtype).requires_grad_()
    g = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    before = (int4_matmul.INT4_KERNEL_LAUNCHES, int4_matmul.INT4_BWD_KERNEL_LAUNCHES)
    int4_matmul.int4_matmul(x, q4, scale).backward(g)
    torch.cuda.synchronize()
    assert (int4_matmul.INT4_KERNEL_LAUNCHES, int4_matmul.INT4_BWD_KERNEL_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = int4_matmul.int4_matmul_dx_reference(g, q4, scale)
    assert x.grad.dtype == dtype and x.grad.shape == (m, k_in)
    assert bool(torch.isfinite(x.grad).all()) and _k6_close(x.grad, want)


# (M, K, N): split contractions (the text stream's down-projection, a mod)
# and an unsplit grid
K6_DET = [(256, 12288, 3072), (1, 3072, 3072), (2048, 3072, 3072)]


@pytest.mark.parametrize("backward", [False, True], ids=["k6a", "k6b"])
@pytest.mark.parametrize("m,k_in,n", K6_DET, ids=["split_k", "mod_split", "unsplit"])
def test_k6_is_deterministic_on_card(m, k_in, n, backward):
    """K6a (or K6b) twice on the same inputs gives the same bits: each
    output is one fixed sequence of f32 sums, and a split contraction's
    partial sums are added in split order by the reduction pass (no
    atomics)."""
    from qflux_tpu_torch.ops import int4_matmul

    gen = torch.Generator("cuda").manual_seed(m + n)
    q4, scale = _int4_weight(gen, k_in, n)
    dtype = torch.float32 if m <= 2 else torch.bfloat16
    t = torch.randn(m, n if backward else k_in, device="cuda", generator=gen).to(torch.bfloat16)
    fn = int4_matmul.int4_bwd_cuda if backward else int4_matmul.int4_fwd_cuda
    a = fn(t, q4, scale, dtype)
    b = fn(t, q4, scale, dtype)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_k6_split_calls_in_sequence_on_card():
    """Split contractions of growing tile counts and workspace sizes (9, then
    24, then 48 tiles), K6a and K6b in turns, one after another through the
    wrappers' shared workspace: each result within K6_REL / K6_MAX of the
    plain version."""
    from qflux_tpu_torch.ops import int4_matmul

    gen = torch.Generator("cuda").manual_seed(11)
    for m, k_in, n in [(300, 3072, 384), (1, 3072, 3072), (2, 12288, 6144), (1, 3072, 3072)]:
        q4, scale = _int4_weight(gen, k_in, n)
        for backward in (False, True):
            plan = int4_matmul._int4_plan(m, n, k_in, 132, backward)
            t = torch.randn(m, n if backward else k_in, device="cuda", generator=gen).to(
                torch.bfloat16)
            fn = int4_matmul.int4_bwd_cuda if backward else int4_matmul.int4_fwd_cuda
            ref = (int4_matmul.int4_matmul_dx_reference if backward
                   else int4_matmul.int4_matmul_reference)
            got = fn(t, q4, scale, torch.float32)
            torch.cuda.synchronize()
            assert _k6_close(got, ref(t.float(), q4, scale)), (m, k_in, n, backward, plan)


def test_int4_on_cuda_never_reaches_the_plain_version(monkeypatch):
    """With the plain W4A16 versions replaced by a raising double, a forward
    and backward of int4_matmul on CUDA tensors still runs, through one K6a
    and one K6b launch; a shape `supports` refuses raises."""
    from qflux_tpu_torch.ops import int4_matmul

    def boom(*a, **k):
        raise AssertionError("the plain version was called on CUDA tensors")

    for name in ("int4_matmul_reference", "int4_matmul_dx_reference"):
        monkeypatch.setattr(int4_matmul, name, boom)
    gen = torch.Generator("cuda").manual_seed(5)
    q4, scale = _int4_weight(gen, 3072, 128)
    x = torch.randn(7, 3072, device="cuda", generator=gen).to(torch.bfloat16).requires_grad_()
    before = (int4_matmul.INT4_KERNEL_LAUNCHES, int4_matmul.INT4_BWD_KERNEL_LAUNCHES)
    int4_matmul.int4_matmul(x, q4, scale).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (int4_matmul.INT4_KERNEL_LAUNCHES, int4_matmul.INT4_BWD_KERNEL_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert x.grad.abs().sum() > 0
    q4b, scale_b = _int4_weight(gen, 256, 128)
    with pytest.raises(ValueError, match="supports"):
        int4_matmul.int4_matmul(torch.zeros(4, 256, device="cuda"), q4b, scale_b)


def _qwen_int4(seed, lora=False):
    """Two blocks of the 20B Qwen-Image DiT at full width over the `int4`
    base, bf16, with a rank-16 LoRA on the eight attention projections
    (b ~ N(0, 0.005²)) if asked, and its inputs (40 text tokens, the last 7
    padding, and two 8 x 8 image planes)."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.models.qwen import transformer as tqwen
    from qflux_tpu_torch.ops.layers import build_lora_tree, mark_trainable, merge_lora
    from qflux_tpu_torch.ops.quant import quantize_tree

    qcfg = config_from_dict({"model": {"quantize": {"enabled": True, "dtype": "int4"}}}
                            ).model.quantize
    cfg = dataclasses.replace(tqwen.QwenImageConfig(), num_layers=2)
    gen = torch.Generator("cuda").manual_seed(seed)
    model = quantize_tree(tqwen.init(gen, cfg, "cuda", torch.bfloat16, quantize=qcfg), qcfg)
    tree = None
    if lora:
        tree = build_lora_tree(gen, model,
                               [r"attn/(to_q|to_k|to_v|to_out|add_q|add_k|add_v|add_out)"],
                               16, 16.0)
        with torch.no_grad():
            for leaf in tree.values():
                leaf["b"].normal_(0.0, 0.005, generator=gen)
        merge_lora(model, mark_trainable(tree))
    x = torch.randn(1, 128, cfg.in_channels, device="cuda", generator=gen).to(torch.bfloat16)
    txt = torch.randn(1, 40, cfg.joint_attention_dim, device="cuda",
                      generator=gen).to(torch.bfloat16)
    seg = torch.ones(1, 40 + 128, dtype=torch.int32, device="cuda")
    seg[0, 33:40] = 0
    t = torch.full((1,), 0.5, device="cuda", dtype=torch.bfloat16)
    return tqwen, cfg, model, tree, (x, txt, t, [(1, 8, 8), (1, 8, 8)], seg)


def _k6_counts():
    from qflux_tpu_torch.ops import int4_matmul

    return (tnr.KERNEL_LAUNCHES, tnr.BWD_KERNEL_LAUNCHES, int4_matmul.INT4_KERNEL_LAUNCHES,
            int4_matmul.INT4_BWD_KERNEL_LAUNCHES, int4_matmul.RQ_KERNEL_LAUNCHES)


def test_qwen_forward_through_k6a_and_k1_on_card(monkeypatch):
    """Two full-width Qwen blocks over the `int4` base: with QFLUX_FUSED_INT4=1
    one forward launches K1 twice and K6a 2·14 + 1 times (the eight
    attention projections, the four MLP GEMMs and the two AdaLN mods a
    block, and time_in's second linear; img_in, txt_in, time_in's first
    linear and proj_out take the dequant route, as in JAX) and no K5a, within
    3e-2 relative L2 of the plain W4A16 route (chip_smoke.py's
    FORWARD_REL_TOL); without the opt-in it launches no K6a."""
    from qflux_tpu_torch.ops.layers import set_int4_impl

    tqwen, cfg, model, _, (x, txt, t, shapes, seg) = _qwen_int4(3)
    monkeypatch.setenv("QFLUX_FUSED_INT4", "1")
    with torch.inference_mode():
        c0 = _k6_counts()
        y = tqwen.forward(model, cfg, x, txt, t, shapes, segment_ids=seg)
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(c0, _k6_counts())) == (2, 0, 2 * 14 + 1, 0, 0)
        set_int4_impl(model, "plain")
        y_plain = tqwen.forward(model, cfg, x, txt, t, shapes, segment_ids=seg)
        set_int4_impl(model, "auto")
        monkeypatch.delenv("QFLUX_FUSED_INT4")
        c0 = _k6_counts()
        y_default = tqwen.forward(model, cfg, x, txt, t, shapes, segment_ids=seg)
        assert tuple(b - a for a, b in zip(c0, _k6_counts())) == (2, 0, 0, 0, 0)
    assert y.shape == (1, 128, 64) and bool(torch.isfinite(y).all())
    assert _rel(y, y_plain) <= 3e-2 and _rel(y, y_default) <= 3e-2


def test_qwen_train_step_through_k6_on_card(monkeypatch):
    """Two full-width Qwen blocks over the `int4` base with a LoRA, remat
    "flash", QFLUX_FUSED_INT4=1: one forward + backward launches K1 and K2
    once a block, K6a 2·14 + 1 times in the forward and 2·12 again in the
    recompute (the mods run outside the checkpointed block), and K6b 6 + 9
    times (block 0's q/k/v inputs carry no gradient; the last block's
    add_out and text MLP feed only the dropped text stream; the mods' and
    time_in's inputs need none); the LoRA gradients are within 1e-1
    relative L2 of the plain W4A16 route's (chip_smoke.py's
    QWEN_GRAD_REL_TOL) and every LoRA layer but the last block's add_q and
    add_out gets one."""
    from qflux_tpu_torch.ops.layers import merge_lora, set_int4_impl

    tqwen, cfg, model, lora, (x, txt, t, shapes, seg) = _qwen_int4(4, lora=True)
    target = torch.randn(1, 128, 64, device="cuda")
    monkeypatch.setenv("QFLUX_FUSED_INT4", "1")
    grads = {}
    for impl in ("auto", "plain"):
        set_int4_impl(model, impl)
        for leaf in lora.values():
            for v in leaf.values():
                v.grad = None
        c0 = _k6_counts()
        y = tqwen.forward(model, cfg, x, txt, t, shapes, segment_ids=seg, remat_policy="flash")
        (y.float() - target).square().mean().backward()
        torch.cuda.synchronize()
        launched = tuple(b - a for a, b in zip(c0, _k6_counts()))
        if impl == "auto":
            assert launched == (2, 2, 2 * 14 + 1 + 2 * 12, 6 + 9, 0), launched
        grads[impl] = {p: torch.cat([torch.zeros_like(leaf[k]).flatten() if leaf[k].grad is None
                                     else leaf[k].grad.flatten() for k in ("a", "b")])
                       for p, leaf in lora.items()}
    set_int4_impl(model, "auto")
    merge_lora(model, None)
    gk = torch.cat(list(grads["auto"].values()))
    gp = torch.cat(list(grads["plain"].values()))
    assert bool(torch.isfinite(gk).all()) and _rel(gk, gp) <= 1e-1
    for path, g in grads["auto"].items():
        zero = path in ("blocks/1/attn/add_q", "blocks/1/attn/add_out")
        assert bool(g.abs().sum() > 0) != zero, path


# ---------------------------------------------------------------------------
# K3 / K4: the plain flash forward over normed and roped q / k, and its
# backward (ops/flash_attention.py), where JAX's one-chip dispatch runs them

# Sq, Sk, masked: ragged in one K tile's reach; a ring hop's Sq != Sk with
# other kv ids over several K tiles; S = 40 below one tile
K3_CASES = [(300, 300, False), (300, 300, True), (200, 520, True), (40, 40, False)]


def _k3_inputs(seed, sq, sk, masked):
    """bf16 q [B, Sq, H, D], k / v [B, Sk, H, D] on the card, and the ids:
    sample 0's q rows padded from 150 and its keys from Sk - 60, sample 1 in
    two segments split at 96 (q) and Sk // 3 (keys)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, sk, H, D)).astype(np.float32) for _ in range(2))
    qkv = [torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (q, k, v)]
    if not masked:
        return qkv + [None, None]
    q_seg, kv_seg = np.ones((B, sq), np.int32), np.ones((B, sk), np.int32)
    q_seg[0, 150:], q_seg[1, 96:] = 0, 2
    kv_seg[0, sk - 60:], kv_seg[1, sk // 3:] = 0, 2
    return qkv + [torch.from_numpy(a).cuda() for a in (q_seg, kv_seg)]


def _dead_rows(q_seg, kv_seg):
    """[B, Sq] bool: q rows whose every key is masked."""
    return ~((q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg[:, :, None] != 0)).any(-1)


@pytest.mark.parametrize("sq,sk,masked", K3_CASES)
def test_k3_k4_match_plain_on_card(sq, sk, masked):
    """K3: out within 4 bf16 ulps at magnitude 1 (1.6e-2), lse within 1e-4
    (chip_smoke.py's K1 bounds: the same rounding points); fully masked rows
    output 0 with lse = -1e30.  K4 with nonzero do on every row: relative L2
    1.5e-2 per gradient against the plain f32 formula, and the fully masked
    rows' dq exactly 0."""
    from qflux_tpu_torch.ops import flash_attention as tfa

    q, k, v, q_seg, kv_seg = _k3_inputs(21 + sq, sq, sk, masked)
    scale = D ** -0.5
    out, lse = tfa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
    do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
    got = tfa._flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    torch.cuda.synchronize()
    ref, ref_lse = tfa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
    assert (out.float() - ref.float()).abs().max().item() <= 1.6e-2
    valid = ref_lse > -1e29
    assert (lse - ref_lse).abs()[valid].max().item() <= 1e-4
    assert bool((lse[~valid] == -1e30).all())
    want = tfa.flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert ((g.float() - w).norm() / w.norm()).item() <= 1.5e-2
    if masked:
        dead = _dead_rows(q_seg, kv_seg)
        assert bool(dead.any()) and not out[dead].any() and not got[0][dead].any()


def test_k3_k4_on_cuda_never_reach_the_plain_version(monkeypatch):
    """On CUDA tensors `flash_attention` (forward and autograd), the ring
    hop's `flash_fwd_with_lse` and `flash_bwd_from_residuals` launch K3 / K4
    once each and never call the plain versions (replaced here by functions
    that raise)."""
    from qflux_tpu_torch.ops import flash_attention as tfa

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    q, k, v, q_seg, kv_seg = _k3_inputs(5, 200, 200, True)
    monkeypatch.setattr(tfa, "flash_fwd_reference", refuse)
    monkeypatch.setattr(tfa, "flash_bwd_reference", refuse)
    before = (tfa.KERNEL_LAUNCHES, tfa.BWD_KERNEL_LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, segment_ids=q_seg, kv_segment_ids=kv_seg)
    out.float().square().sum().backward()
    assert (tfa.KERNEL_LAUNCHES, tfa.BWD_KERNEL_LAUNCHES) == (before[0] + 1, before[1] + 1)
    o, lse = tfa.flash_fwd_with_lse(q, k, v, q_seg, kv_seg, D ** -0.5)
    g = tfa.flash_bwd_from_residuals(q, k, v, q_seg, kv_seg, o, lse, o, D ** -0.5)
    torch.cuda.synchronize()
    assert (tfa.KERNEL_LAUNCHES, tfa.BWD_KERNEL_LAUNCHES) == (before[0] + 2, before[1] + 2)
    assert torch.equal(o, out.detach()) and all(x.dtype == torch.bfloat16 for x in g)


def test_qwen_two_blocks_at_832x576_run_k3_k4_on_card():
    """Two blocks of the 20B Qwen-Image DiT at full width over an
    int4-requant base at path B's S = 256 + 2 · 1872 = 4000 (26 padding
    text tokens), where JAX on one chip runs K3 / K4: a forward launches K3
    twice and no K1, within 3e-2 (relative L2, chip_smoke.py's
    FORWARD_REL_TOL) of the plain attention; a LoRA train step under
    "flash_offload" and under "flash" launches K3 and K4 once a block and
    neither K1 nor K2, with gradients identical to the bit."""
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.models.qwen import transformer as tqwen
    from qflux_tpu_torch.ops import flash_attention as tfa
    from qflux_tpu_torch.ops.layers import build_lora_tree, mark_trainable, merge_lora
    from qflux_tpu_torch.ops.quant import quantize_tree

    def counts():
        return (tfa.KERNEL_LAUNCHES, tfa.BWD_KERNEL_LAUNCHES, tnr.KERNEL_LAUNCHES,
                tnr.BWD_KERNEL_LAUNCHES)

    qcfg = config_from_dict({"model": {"quantize": {"enabled": True,
                                                    "dtype": "int4_requant"}}}).model.quantize
    cfg = dataclasses.replace(tqwen.QwenImageConfig(), num_layers=2)
    gen = torch.Generator("cuda").manual_seed(3)
    model = quantize_tree(tqwen.init(gen, cfg, "cuda", torch.bfloat16, quantize=qcfg), qcfg)
    shapes = [(1, 52, 36), (1, 52, 36)]
    n_img = 2 * 52 * 36
    bf = torch.bfloat16
    x = torch.randn(1, n_img, cfg.in_channels, device="cuda", generator=gen).to(bf)
    txt = torch.randn(1, 256, cfg.joint_attention_dim, device="cuda", generator=gen).to(bf)
    seg = torch.ones(1, 256 + n_img, dtype=torch.int32, device="cuda")
    seg[0, 230:256] = 0
    t = torch.full((1,), 0.5, device="cuda", dtype=bf)
    with torch.inference_mode():
        c0 = counts()
        y = tqwen.forward(model, cfg, x, txt, t, shapes, segment_ids=seg)
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(c0, counts())) == (2, 0, 0, 0)
        y_plain = tqwen.forward(model, cfg, x, txt, t, shapes, segment_ids=seg,
                                attn_impl="plain")
    rel = ((y.float() - y_plain.float()).norm() / y_plain.float().norm()).item()
    assert bool(torch.isfinite(y).all()) and rel <= 3e-2
    lora = mark_trainable(build_lora_tree(gen, model, [r"attn/(to_q|to_k|to_v|to_out)"], 16,
                                          16.0))
    with torch.no_grad():
        for leaf in lora.values():
            leaf["b"].normal_(0.0, 0.005, generator=gen)
    merge_lora(model, lora)
    target = torch.randn(1, n_img, 64, device="cuda", generator=gen)
    grads = {}
    for policy in ("flash_offload", "flash"):
        for leaf in lora.values():
            for p in leaf.values():
                p.grad = None
        c0 = counts()
        y = tqwen.forward(model, cfg, x, txt, t, shapes, segment_ids=seg, remat_policy=policy)
        (y.float() - target).square().mean().backward()
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(c0, counts())) == (2, 2, 0, 0), policy
        grads[policy] = torch.cat([leaf[k].grad.flatten() for leaf in lora.values()
                                   for k in ("a", "b")])
    merge_lora(model, None)
    assert torch.equal(grads["flash"], grads["flash_offload"])
    assert bool(grads["flash"].abs().sum() > 0)


# The redesigned bf16 K1 (kn prep + wgmma over a TMA ring) and K4 (wgmma dk/dv
# and dq kernels over TMA rings): ragged S, fully masked rows, Sq != Sk with
# text padding, and two calls identical to the bit

def _k1_segments(b, s, st):
    """Sample 0: padding from 4 s / 5 (fully masked rows); sample 1: a second
    segment from max(st, 1)."""
    seg = np.ones((b, s), np.int32)
    seg[0, 4 * s // 5:] = 0
    seg[1, max(st, 1):] = 2
    return torch.from_numpy(seg).cuda()


@pytest.mark.parametrize("s", [77, 2304, 4000])
@pytest.mark.parametrize("st_at", ["zero", "inside"])
def test_k1_bf16_ragged_and_masked_on_card(s, st_at):
    """K1's bf16 mode at B = 2 and S not a multiple of its 128-row q or
    64-key tiles, with st at 0 and inside S: out within 4 bf16 ulps at
    magnitude 1 (1.6e-2), lse within 1e-4, the fully masked rows at 0 with
    lse = -1e30, and a second call identical to the bit."""
    st = 0 if st_at == "zero" else s // 3
    args = _inputs(31 + s, s)
    seg = _k1_segments(B, s, st)
    out, lse = tnr._flash_nr_cuda(*args, st, seg, D ** -0.5)
    out2, lse2 = tnr._flash_nr_cuda(*args, st, seg, D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref, ref_lse = tnr.flash_attention_nr_reference(*args, st, segment_ids=seg)
    assert (out.float() - ref.float()).abs().max().item() <= 1.6e-2
    valid = ref_lse > -1e29
    assert (lse - ref_lse).abs()[valid].max().item() <= 1e-4
    assert bool((lse[~valid] == -1e30).all())
    assert not out[0, 4 * s // 5:].any() and bool(out[0, :4 * s // 5].any())


def test_k1_kn_prep_is_the_s_int8_preps_kn_on_card():
    """The bf16 mode's prep writes kn with the s_int8 prep's cast chain: the
    two normed and roped k are identical to the bit (both modes'
    `norm_rope_row`)."""
    q, k, _, qs2, ks2, cos, sin = _inputs(41, 300)
    kn = tnr._kn_prep_cuda(k, ks2, cos, sin, ST)
    _, kn8, *_ = tnr._int8_operands_cuda(q, k, qs2, ks2, cos, sin, ST, 128)
    torch.cuda.synchronize()
    assert torch.equal(kn, kn8)


def test_k1_s_int8_deterministic_and_apart_from_bf16_on_card():
    """K1's s_int8 mode (the shared wgmma loop with int8 score products)
    gives the same bits on two calls, and the bf16 mode on the same inputs
    stays within the int8 scores' error of it."""
    args = _int8_inputs(42, 1024)
    fwd_rows, _ = tnr.s_int8_tiles(1024, D)
    out, lse = tnr._flash_nr_cuda(*args, 256, None, D ** -0.5, fwd_rows)
    out2, lse2 = tnr._flash_nr_cuda(*args, 256, None, D ** -0.5, fwd_rows)
    bf, _ = tnr._flash_nr_cuda(*args, 256, None, D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert _rel(out, bf) <= INT8_FWD_REL


K4_TEXT_CASES = [(300, 520), (520, 300), (2304, 2304)]


@pytest.mark.parametrize("sq,sk", K4_TEXT_CASES)
def test_k4_text_padding_sq_ne_sk_on_card(sq, sk):
    """K4 with Qwen's text padding (tokens 230..255 of q and of k segment 0)
    at Sq != Sk and at path C's S, nonzero do on every row: relative L2
    1.5e-2 and max 2e-2 x max|ref| per gradient against the plain formula,
    the padded rows' dq / dk / dv exactly 0, a second call identical to the
    bit."""
    from qflux_tpu_torch.ops import flash_attention as tfa

    rng = np.random.default_rng(sq + 7 * sk)
    q = torch.from_numpy(rng.standard_normal((B, sq, H, D)).astype(np.float32)).cuda()
    k, v = (torch.from_numpy(rng.standard_normal((B, sk, H, D)).astype(np.float32)).cuda()
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    q_seg = torch.ones(B, sq, dtype=torch.int32, device="cuda")
    kv_seg = torch.ones(B, sk, dtype=torch.int32, device="cuda")
    q_seg[:, 230:256] = 0
    kv_seg[:, 230:256] = 0
    scale = D ** -0.5
    out, lse = tfa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
    do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
    got = tfa._flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    again = tfa._flash_bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = tfa.flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rel(g, w) <= 1.5e-2
        assert (g.float() - w).abs().max().item() <= 2e-2 * w.abs().max().item()
    assert not got[0][:, 230:256].any()
    assert not got[1][:, 230:256].any() and not got[2][:, 230:256].any()


# The redesigned bf16 K2 (the prep, then K4's Hopper loops with the rope + norm
# backward as their epilogue) and K3 (K1's Hopper loop with q by TMA): ragged S,
# st inside a 64-row tile, text padding, a fully masked sample, rows with no key
# of their segment, and two calls identical to the bit

def _k2_segments(s):
    """Sample 0: Qwen's text padding (rows 230..255, or the last third of a
    shorter S) at segment 0; sample 1: every row at segment 0 (a fully
    masked sample)."""
    seg = np.ones((B, s), np.int32)
    lo, hi = (230, 256) if s >= 256 else (2 * s // 3, s)
    seg[0, lo:hi] = 0
    seg[1] = 0
    return torch.from_numpy(seg).cuda(), (lo, hi)


@pytest.mark.parametrize("s", [77, 2304, 2560])
@pytest.mark.parametrize("st", [0, 64, 100])
def test_k2_bf16_ragged_st_and_masked_on_card(s, st):
    """K2's bf16 mode at B = 2, S not a multiple of its 128-row blocks (77,
    path C's 2304) and FLUX's 2560, st at 0, at a 64-row tile edge and inside
    a tile, nonzero do on every row: each of dq / dk / dv / dq_scale2 /
    dk_scale2 within chip_smoke.py's BWD_REL_TOL (1.5e-2 relative L2) and
    BWD_MAX_TOL (2e-2 x max|ref|) of the plain version; the padded rows' and
    the fully masked sample's dq / dk / dv exactly 0; a second call
    identical to the bit."""
    args = _inputs(51 + s + st, s)
    seg, (lo, hi) = _k2_segments(s)
    do = torch.randn(B, s, H, D, device="cuda").to(torch.bfloat16)
    out, lse = tnr._flash_nr_cuda(*args, st, seg, D ** -0.5)
    got = tnr._flash_nr_bwd_cuda(*args, st, seg, D ** -0.5, out, lse, do)
    again = tnr._flash_nr_bwd_cuda(*args, st, seg, D ** -0.5, out, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = tnr.flash_attention_nr_bwd_reference(*args, st, do, segment_ids=seg)
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, r) <= 1.5e-2
        assert (g.float() - r).abs().max().item() <= 2e-2 * r.abs().max().item()
    for g in got[:3]:
        assert not g[0, lo:hi].any() and not g[1].any() and bool(g[0, :lo].any())


def _k3_hop_inputs(seed):
    """A ring hop at Sq = 300 != Sk = 520: sample 0's q rows 0..149 at
    segment 1, 150..199 at segment 3 (no key of this shard has it), the rest
    padding; its keys at 1 then 2; sample 1 at segment 1 with its last 100
    keys padding."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 300, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, 520, H, D)).astype(np.float32) for _ in range(2))
    q_seg, kv_seg = np.ones((B, 300), np.int32), np.ones((B, 520), np.int32)
    q_seg[0, 150:200], q_seg[0, 200:] = 3, 0
    kv_seg[0, 260:], kv_seg[1, 420:] = 2, 0
    return ([torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (q, k, v)]
            + [torch.from_numpy(a).cuda() for a in (q_seg, kv_seg)])


@pytest.mark.parametrize("case", ["s77_unmasked", "s4000_text_pad", "hop_300x520"])
def test_k3_redesign_on_card(case):
    """K3 at B = 2: S = 77 unmasked (one partial q tile and key tile), path
    B's S = 4000 with Qwen's text padding, and a ring hop with Sq != Sk whose
    rows 150..199 of sample 0 have no key of their segment: out within 4 bf16
    ulps at magnitude 1 (1.6e-2) and lse within 1e-4 of the plain version,
    every row that attends nothing at out = 0 and lse = -1e30, and a second
    call identical to the bit."""
    from qflux_tpu_torch.ops import flash_attention as tfa

    if case == "hop_300x520":
        q, k, v, q_seg, kv_seg = _k3_hop_inputs(61)
    else:
        s = 77 if case == "s77_unmasked" else 4000
        rng = np.random.default_rng(s)
        q, k, v = (torch.from_numpy(rng.standard_normal((B, s, H, D)).astype(np.float32))
                   .cuda().to(torch.bfloat16) for _ in range(3))
        q_seg = kv_seg = None
        if s == 4000:
            q_seg = torch.ones(B, s, dtype=torch.int32, device="cuda")
            q_seg[:, 230:256] = 0
            kv_seg = q_seg
    scale = D ** -0.5
    out, lse = tfa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
    out2, lse2 = tfa._flash_fwd_cuda(q, k, v, q_seg, kv_seg, scale)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref, ref_lse = tfa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
    assert (out.float() - ref.float()).abs().max().item() <= 1.6e-2
    valid = ref_lse > -1e29
    assert (lse - ref_lse).abs()[valid].max().item() <= 1e-4
    assert bool((lse[~valid] == -1e30).all())
    if q_seg is not None:
        dead = _dead_rows(q_seg, kv_seg)
        assert bool(dead.any()) and not out[dead].any()
        assert bool((lse.permute(0, 2, 1)[dead] == -1e30).all())
    if case == "hop_300x520":
        assert not out[0, 150:200].any() and bool(out[0, :150].any())


# The redesigned s_int8 modes of K1 and K2 (int8 wgmma score products inside the
# shared loops): ragged S, st at 0, at a 64-row edge and at the end of a 256-row
# tile, Qwen's text padding and a fully masked sample, two calls identical

# S and the (forward, backward) q tile rows: a ragged S with 128-row tiles (which
# the kernels take at any S), and S = 1024, 2304 and 2560 at s_int8_tiles' rows
INT8_RAGGED_CASES = [(300, (128, 128)), (1024, None), (2304, None), (2560, None)]


@pytest.mark.parametrize("s,rows", INT8_RAGGED_CASES, ids=[str(c[0]) for c in INT8_RAGGED_CASES])
@pytest.mark.parametrize("st", [0, 64, 256])
def test_k1_k2_s_int8_ragged_st_and_masked_on_card(s, rows, st):
    """K1's and K2's s_int8 modes at B = 2 (sample 0 with Qwen's text
    padding, sample 1 fully masked), nonzero do on every row: out within
    INT8_FWD_REL and lse within 1e-2 of the plain version (the masked rows'
    lse exactly -1e30), each gradient within INT8_BWD_REL, the padded rows'
    and the masked sample's out / dq / dk / dv exactly 0, and a second call
    of each kernel identical to the bit."""
    fwd_rows, bwd_rows = rows or tnr.s_int8_tiles(s, D)
    args = _inputs(61 + s + st, s)
    seg, (lo, hi) = _k2_segments(s)
    scale = D ** -0.5
    do = torch.randn(B, s, H, D, device="cuda").to(torch.bfloat16)
    out, lse = tnr._flash_nr_cuda(*args, st, seg, scale, fwd_rows)
    out2, lse2 = tnr._flash_nr_cuda(*args, st, seg, scale, fwd_rows)
    got = tnr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do, bwd_rows)
    again = tnr._flash_nr_bwd_cuda(*args, st, seg, scale, out, lse, do, bwd_rows)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref, ref_lse = tnr.flash_attention_nr_int8_reference(*args, st, fwd_rows, segment_ids=seg)
    assert bool(torch.isfinite(out).all()) and _rel(out, ref) <= INT8_FWD_REL
    valid = ref_lse > -1e29
    assert (lse - ref_lse).abs()[valid].max().item() <= 1e-2
    assert bool((lse[~valid] == -1e30).all())
    want = tnr.flash_attention_nr_int8_bwd_reference(*args, st, do, out, lse, bwd_rows,
                                                     segment_ids=seg)
    for g, r in zip(got, want):
        assert bool(torch.isfinite(g).all()) and _rel(g, r) <= INT8_BWD_REL
    for t in (out, *got[:3]):
        assert not t[0, lo:hi].any() and not t[1].any() and bool(t[0, :lo].any())


@pytest.mark.parametrize("h", [1, 5])
def test_s_int8_at_head_counts_off_the_prep_groups_on_card(h):
    """The s_int8 prep takes the heads of a position in groups of four (at H
    = 5 the last group holds one head, at H = 1 the only one) and S = 300 in
    blocks of 16 positions (the last one ragged): its int8 q / k and scales
    equal quant_rows of its own normed q / k to the bit at 128- and 256-row
    tiles, and K1 / K2 s_int8 stay within INT8_FWD_REL / INT8_BWD_REL of
    their plain versions."""
    s, st, scale = 300, 64, D ** -0.5
    args = _int8_inputs(71 + h, s, h=h)
    q, k, _, qs2, ks2, cos, sin = args
    for rows in (128, 256):
        qn, kn, qq, kq, q_sc, k_sc = tnr._int8_operands_cuda(q, k, qs2, ks2, cos, sin, st, rows)
        torch.cuda.synchronize()
        want_qq, want_qsc = tnr.quant_rows(qn, rows)
        want_kq, want_ksc = tnr.quant_rows(kn, s)
        assert torch.equal(qq, want_qq) and torch.equal(q_sc, want_qsc)
        assert torch.equal(kq, want_kq) and torch.equal(k_sc, want_ksc[:, 0])
    do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
    out, lse = tnr._flash_nr_cuda(*args, st, None, scale, 128)
    got = tnr._flash_nr_bwd_cuda(*args, st, None, scale, out, lse, do, 128)
    torch.cuda.synchronize()
    ref, ref_lse = tnr.flash_attention_nr_int8_reference(*args, st, 128)
    assert _rel(out, ref) <= INT8_FWD_REL and (lse - ref_lse).abs().max().item() <= 1e-2
    want = tnr.flash_attention_nr_int8_bwd_reference(*args, st, do, out, lse, 128)
    for g, r in zip(got, want):
        assert bool(torch.isfinite(g).all()) and _rel(g, r) <= INT8_BWD_REL


@pytest.mark.parametrize("family", ["flux", "qwen"])
def test_block_by_block_load_on_card(tmp_path, family):
    """A full-width diffusers checkpoint (chip_smoke.py's synthetic one: FLUX
    1 dual + 1 single block, Qwen 2 blocks over the int4-requant base),
    written in bf16 and loaded through Trainer.load_model onto the card one
    block at a time, equals the bridge's load of the whole dict's
    conversion on the card (then `quantize_tree` for Qwen), to the bit."""
    import chip_smoke
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.models import bridge, porting
    from qflux_tpu_torch.models.flux import transformer as tflux
    from qflux_tpu_torch.models.flux import vae as tflux_vae
    from qflux_tpu_torch.models.qwen import porting as qporting
    from qflux_tpu_torch.models.qwen import transformer as tqwen
    from qflux_tpu_torch.models.qwen import vae as tqvae
    from qflux_tpu_torch.ops.quant import quantize_tree
    from qflux_tpu_torch.trainer.base import Trainer

    if family == "flux":
        cfg = dataclasses.replace(tflux.FluxConfig(), num_layers=1, num_single_layers=1)
        sd = chip_smoke.flux_state_dict(cfg, seed=3)
        vsd = chip_smoke.flux_vae_state_dict(tflux_vae.VAEConfig(), seed=4)
        raw = {"model": {"variant": "full"}}
        want = bridge.load_params(tflux.FluxTransformer(cfg, device="cuda", dtype=torch.bfloat16),
                                  porting.convert_flux_transformer(sd, 1, 1))
    else:
        cfg = dataclasses.replace(tqwen.QwenImageConfig(), num_layers=2)
        sd = chip_smoke.qwen_state_dict(cfg, seed=3)
        vsd = chip_smoke.qwen_vae_state_dict(tqvae.QwenVAEConfig(), seed=4)
        raw = {"trainer": "QwenImageEditTrainer",
               "model": {"variant": "full",
                         "quantize": {"enabled": True, "dtype": "int4_requant"}}}
        want = bridge.load_params(
            tqwen.QwenImageTransformer(cfg, device="cuda", dtype=torch.bfloat16),
            qporting.convert_qwen_image_transformer(sd, 2))
    chip_smoke.write_checkpoint(tmp_path, sd, vsd)
    raw["model"]["pretrained_model_name_or_path"] = str(tmp_path)
    tr = Trainer(config_from_dict(raw), device="cuda")
    tr.load_model()
    if family == "qwen":
        quantize_tree(want, tr.config.model.quantize)
        assert tr.bundle.dit_params.blocks[1].img_mlp.lin_in.q4 is not None
    assert tr.bundle.dit_cfg == cfg
    assert next(tr.bundle.dit_params.parameters()).is_cuda
    assert chip_smoke._params_equal(tr.bundle.dit_params, want) > 0


@pytest.mark.parametrize("bucket", [True, False])
def test_fit_through_dataloader_equals_in_memory_batches_on_card(tmp_path, bucket):
    """A two-block DiT at head dim 128 on the card, trained through
    Trainer.fit(DataLoader(...)) over a cached folder dataset (4×4 and 6×4
    latent grids; bucketed, or padded with segment ids), gives the same
    losses, to the bit, as the same fit over the same collated batches
    handed in from memory: the generator seeded the same, the loader's
    threads only reading and collating numpy.  Every step ran K1 (S = 48 or
    64; the padded batches with segment ids), twice a block: the adapter's
    default remat policy is JAX's "dots", which keeps no attention output."""
    import chip_smoke
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.data.dataset import ImageDataset
    from qflux_tpu_torch.data.loader import DataLoader
    from qflux_tpu_torch.models.flux import transformer as tflux
    from qflux_tpu_torch.trainer.base import Trainer
    from qflux_tpu_torch.trainer.flux_kontext import FluxKontextAdapter, ModelBundle

    cfg = dataclasses.replace(tflux.FluxConfig.tiny(), num_layers=1, num_single_layers=1,
                              attention_head_dim=128, num_attention_heads=2,
                              axes_dims_rope=(16, 56, 56))
    rng = np.random.default_rng(0)
    grids = [(4, 4), (6, 4), (4, 4), (6, 4)]
    items = [chip_smoke.flux_cache_item(rng, cfg, gh, gw, s_txt=16) for gh, gw in grids]
    data, cache = chip_smoke.write_cached_dataset(tmp_path, items, chip_smoke.FLUX_HASH_KEYS)
    model = tflux.init(torch.Generator("cuda").manual_seed(0), cfg, "cuda", torch.bfloat16)

    def trainer():
        t = Trainer(config_from_dict({
            "model": {"variant": "test"}, "train": {"max_train_steps": 4},
            "loss": {"class_path": "qflux_tpu.losses.AttentionMaskMseLoss"},
            "logging": {"output_dir": str(tmp_path / "out")}}), device="cuda")
        t.adapter, t.bundle = FluxKontextAdapter(cfg), ModelBundle(dit_cfg=cfg, dit_params=model)
        return t

    def loader():
        return DataLoader(ImageDataset(str(data), cache_dir=str(cache), use_cache=True),
                          batch_size=2, shuffle=True, seed=1234, bucket_by_shape=bucket,
                          num_workers=2)

    k1 = tnr.KERNEL_LAUNCHES
    a = trainer()
    a.fit(loader())
    assert tnr.KERNEL_LAUNCHES - k1 == 4 * 2 * 2  # two a block, two blocks, four steps
    dl = loader()
    epochs = iter([list(dl), list(dl)])

    class Epochs:
        def __iter__(self):
            return iter(next(epochs))

    b = trainer()
    b.fit(Epochs())
    assert len(a.history) == 4 and all(np.isfinite(h["loss"]) for h in a.history)
    assert [h["loss"] for h in b.history] == [h["loss"] for h in a.history]


# ---------------------------------------------------------------------------
# the quantized bases that JAX runs in XLA

W8_CARD_CASES = [(33, 3072, 12288, torch.bfloat16), (1000, 12288, 3072, torch.bfloat16),
                 (2048, 3072, 3072, torch.bfloat16), (300, 3072, 64, torch.float32),
                 (512, 256, 3072, torch.bfloat16), (33, 3072, 18432, torch.bfloat16),
                 (40, 18432, 3072, torch.float32)]


@pytest.mark.parametrize("m,k_in,n,dtype", W8_CARD_CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}" for c in W8_CARD_CASES])
def test_w8a8_fwd_and_dx_bit_exact_on_card(m, k_in, n, dtype):
    """The W8A8 matmul on the card (row quantization, the GEMM of
    csrc/int8_gemm.cu, and in the backward the transpose and the dx GEMM)
    equals its plain version (quant.dyn_int8_fwd / dyn_int8_dx, exact
    float64 products) to the bit at ragged M, split and unsplit grids, bf16
    and f32; two calls give the same bits; each launch is counted once."""
    from qflux_tpu_torch.ops import int8_matmul as ti8
    from qflux_tpu_torch.ops import quant

    gen = torch.Generator("cuda").manual_seed(k_in + n)
    w = (torch.rand(k_in, n, device="cuda", generator=gen) * 2 - 1) / k_in ** 0.5
    q, scale = quant.quantize_kernel(w, "int8")
    q, sw = q.t().contiguous(), scale[0].contiguous()
    x = torch.randn(m, k_in, device="cuda", generator=gen).to(dtype).requires_grad_()
    g = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    before = (ti8.INT8_GEMM_LAUNCHES, ti8.INT8_GEMM_DX_LAUNCHES, ti8.INT8_TRANSPOSE_LAUNCHES)
    y = ti8.dyn_int8_matmul(x, q, sw)
    y.backward(g)
    dx = x.grad
    x.grad = None
    y2 = ti8.dyn_int8_matmul(x, q, sw)
    y2.backward(g)
    torch.cuda.synchronize()
    assert (ti8.INT8_GEMM_LAUNCHES - before[0], ti8.INT8_GEMM_DX_LAUNCHES - before[1],
            ti8.INT8_TRANSPOSE_LAUNCHES - before[2]) == (2, 2, 2)
    assert y.dtype == dx.dtype == dtype
    assert torch.equal(y, quant.dyn_int8_fwd(x.detach(), q, sw))
    assert torch.equal(dx, quant.dyn_int8_dx(g, q, sw))
    assert torch.equal(y, y2) and torch.equal(dx, x.grad)
    assert torch.equal(ti8.int8_transpose_cuda(q), q.t())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_dynamic_past_the_exact_length_on_card(dtype):
    """int4_dynamic at the AdaLN mods' shape, 33 rows × 3072 → 18432: the
    forward and the dx (a contraction over N = 18,432, past the 16,513
    terms one exact f32 product holds, so added in int32 pieces) on the
    card equal the plain version (float64 products on the card) to the
    bit, including rows whose dx sums pass 2^24; the dx equals the CPU's
    to the bit, and the forward, whose f32 sum over the groups each device
    orders its own way, is within rel 1e-6 of its largest element in f32,
    one bf16 ulp (2^-8) in bf16, as tests/test_torch_quant8.py holds it to
    JAX."""
    from qflux_tpu_torch.ops import quant

    gen = torch.Generator("cpu").manual_seed(18432)
    w = (torch.rand(3072, 18432, generator=gen) * 2 - 1) / 3072 ** 0.5
    w[:64] = 0.37
    q4, gs = quant.quantize_kernel_int4(w, 128)
    x = torch.randn(33, 3072, generator=gen).to(dtype)
    g = torch.randn(33, 18432, generator=gen).to(dtype)
    g[:16] = 1.0
    ys, dxs = [], []
    for dev in ("cpu", "cuda"):
        xd = x.to(dev).detach().requires_grad_()
        y = quant.dyn_int4_matmul(xd, q4.to(dev), gs.to(dev))
        y.backward(g.to(dev))
        ys.append(y.detach())
        dxs.append(xd.grad)
    args = (q4.cuda(), gs.cuda())
    assert torch.equal(ys[1], quant.dyn_int4_fwd(x.cuda(), *args, f64=True))
    assert torch.equal(dxs[1], quant.dyn_int4_dx(g.cuda(), *args, f64=True))
    assert torch.equal(dxs[0], dxs[1].cpu())
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    want = ys[0].float()
    assert float((ys[1].cpu().float() - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("form", ["int8", "fp8_e4m3", "fp8_e5m2", "int8_dynamic", "int4",
                                  "int4_requant", "int4_dynamic"])
def test_card_quantization_equals_cpu(form):
    """Every quantized form's leaves quantized on the card (q or q4, scale,
    the requant factors) equal those quantized on the CPU from the same
    weight, to the bit: every scale is a true division on both devices.  The
    weights are FLUX's AdaLN mod and MLP shapes, with a zero column."""
    import types

    from qflux_tpu_torch.ops import layers as tlayers
    from qflux_tpu_torch.ops import quant

    gen = torch.Generator("cpu").manual_seed(5)
    qcfg = types.SimpleNamespace(dtype=form, skip_patterns=[], group_size=128)
    for k_in, n in ((3072, 18432), (12288, 3072)):
        w = ((torch.rand(n, k_in, generator=gen) * 2 - 1) / k_in ** 0.5).to(torch.bfloat16)
        w[7] = 0
        mods = []
        for dev in ("cpu", "cuda"):
            mod = tlayers.Dense(k_in, n, bias=False, device=dev, dtype=torch.bfloat16)
            with torch.no_grad():
                mod.weight.copy_(w)
            mods.append(quant.quantize_tree(mod, qcfg))
        cpu, card = mods
        assert cpu.q_form == card.q_form == form
        for name in ("q4", "q", "scale", "rq_f", "rq_s_vec"):
            a, b = getattr(cpu, name), getattr(card, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert torch.equal(a.view(torch.uint8), b.cpu().view(torch.uint8)), name


def test_qwen_encoders_on_card_match_cpu(monkeypatch):
    """Qwen-Image-Edit's encoders at tiny width (the VL vision tower over
    two images, the LM over a padded batch of two, the 3D VAE encoder at
    40×56) on the card with TF32 off, against the same modules on the
    CPU: within chip_smoke.py's ENCODER_REL_TOL (the same f32 arithmetic
    summed in other orders)."""
    import copy

    import chip_smoke
    from qflux_tpu_torch.models.qwen import vae as tqvae
    from qflux_tpu_torch.models.qwen import vl_encoder as tvl

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    vcfg, tcfg = tvl.VLVisionConfig.tiny(), tvl.VLTextConfig.tiny()
    cpu = {"vision": tvl.vision_init(torch.Generator().manual_seed(2), vcfg),
           "text": tvl.text_init(torch.Generator().manual_seed(3), tcfg),
           "vae": tqvae.init(torch.Generator().manual_seed(1), tqvae.QwenVAEConfig.tiny())}
    card = {k: copy.deepcopy(m).cuda() for k, m in cpu.items()}
    rng = np.random.default_rng(0)
    pre = [tvl.preprocess_image(rng.integers(0, 256, hw + (3,), dtype=np.uint8), vcfg)
           for hw in ((61, 93), (56, 140))]
    patches, grids = np.concatenate([p for p, _ in pre]), [g for _, g in pre]
    ids = rng.integers(1, 480, (2, 24))
    mask = np.ones((2, 24), np.int64)
    mask[1, 17:] = 0
    pos = tvl.get_rope_index(ids, [], 2, tvl.VLSpecialTokens(500, 502, 503), mask)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 40, 56, 3)).astype(np.float32))
    with torch.no_grad():
        outs = {dev: (tvl.vision_forward(m["vision"], vcfg, patches, grids),
                      tvl.text_forward(m["text"], tcfg, m["text"].embed_tokens[
                          torch.from_numpy(ids).to(dev)], pos, attention_mask=mask),
                      tqvae.encode(m["vae"], tqvae.QwenVAEConfig.tiny(), x.to(dev)))
                for dev, m in (("cpu", cpu), ("cuda", card))}
    for name, got, want in zip(("vision", "lm", "vae"), outs["cuda"], outs["cpu"]):
        assert got.is_cuda, name
        got, want = got.cpu().double(), want.double()
        err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        assert err < chip_smoke.ENCODER_REL_TOL, (name, err)


def test_klein_dit_through_k1_k2_on_card_matches_cpu():
    """FLUX.2-Klein's DiT (flux2_config: 4-axis RoPE, no pooled projection,
    guidance embeds) cut to 1 + 1 blocks of 2 heads × 128, bf16, through
    the Klein adapter's predict_velocity: on the card every block's
    attention is K1 and its backward K2 (one launch each a block), and the
    output and the LoRA gradients are within relative L2 5e-2 of the same
    model on the CPU (bf16 rounding at other points on the two paths)."""
    import copy

    from qflux_tpu_torch.ops.layers import build_lora_tree, mark_trainable, merge_lora
    from qflux_tpu_torch.trainer import flux2_klein as tklein

    cfg = tklein.flux2_config(num_layers=1, num_single_layers=1, attention_head_dim=128,
                              num_attention_heads=2, joint_attention_dim=3 * 48,
                              in_channels=16, out_channels=16)
    cpu = tklein.flux.init(torch.Generator().manual_seed(0), cfg, "cpu", torch.bfloat16)
    card = copy.deepcopy(cpu).cuda()
    adapter = tklein.Flux2KleinAdapter(cfg, remat=True, remat_policy="flash")
    rng = np.random.default_rng(0)
    gh = gw = 8
    batch = {"control_latents": rng.standard_normal((1, gh * gw, 16)),
             "prompt_embeds": rng.standard_normal((1, 32, 3 * 48)),
             "img_ids": np.concatenate([tklein.latent_ids_4d(gh, gw, 0),
                                        tklein.latent_ids_4d(gh, gw, 1)]),
             "txt_ids": tklein.text_ids_4d(32)}
    lat = rng.standard_normal((1, gh * gw, 16))
    lora0 = build_lora_tree(torch.Generator().manual_seed(1), cpu, [r"attn/(to_q|to_k|to_v)"],
                            4, 4.0)
    for i, leaf in enumerate(lora0.values()):
        leaf["b"] = torch.full_like(leaf["b"], 0.01 * (i + 1))
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        b = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev) for k, v in batch.items()}
        for k in ("control_latents", "prompt_embeds"):
            b[k] = b[k].to(torch.bfloat16)
        lora = mark_trainable({p: {k: v.clone().to(dev) for k, v in leaf.items()}
                               for p, leaf in lora0.items()})
        merge_lora(model, lora)
        k1, k2 = tnr.KERNEL_LAUNCHES, tnr.BWD_KERNEL_LAUNCHES
        y = adapter.predict_velocity(model, b, torch.from_numpy(lat.astype(np.float32)).to(
            dev, torch.bfloat16), torch.full((1,), 0.5, device=dev))
        y.float().pow(2).mean().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert tnr.KERNEL_LAUNCHES - k1 == 2 and tnr.BWD_KERNEL_LAUNCHES - k2 == 2
        out[dev] = (y.detach().float().cpu(),
                    torch.cat([leaf[k].grad.flatten().cpu()
                               for leaf in lora.values() for k in ("a", "b")]))
    for got, want in zip(out["cuda"], out["cpu"]):
        assert ((got - want).norm() / want.norm()).item() <= 5e-2


def test_adam8bit_step_on_card_equals_cpu():
    """One AdamW8bit update on the card against the same update on the CPU,
    from the same parameters and moments (two earlier updates on the CPU)
    and the same gradients, over a stack of two tensors whose size is no
    multiple of the block and a tensor of its own: the codes, the block
    scales and the parameters equal to the bit (the update is elementwise
    f32 arithmetic and an exact amax; the bias corrections divide by a 0-dim
    tensor on the moments' device, a true division on both)."""
    from qflux_tpu_torch.ops.adam8bit import AdamW8bit

    rng = np.random.default_rng(70)
    shapes = [(37, 5), (37, 5), (5, 3072)]
    init = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.uniform(-6, 0, s)).astype(np.float32)
              for s in shapes] for _ in range(3)]

    def optimizer(device, values):
        params = [torch.tensor(a, device=device, requires_grad=True) for a in values]
        return params, AdamW8bit(params, lr=1e-2, stacks=[params[:2], params[2:]])

    def update(params, opt, g):
        for p, a in zip(params, g):
            p.grad = torch.tensor(a, device=p.device)
        opt.step()

    cpu_params, cpu_opt = optimizer("cpu", init)
    for g in grads[:2]:
        update(cpu_params, cpu_opt, g)
    card_params, card_opt = optimizer("cuda", [p.detach().numpy() for p in cpu_params])
    for cpu_stack, card_stack in zip(cpu_opt.stacks, card_opt.stacks):
        card_opt.state[card_stack[0]] = {
            k: tuple(t.cuda() for t in v) if isinstance(v, tuple) else v
            for k, v in cpu_opt.state[cpu_stack[0]].items()}
    update(cpu_params, cpu_opt, grads[2])
    update(card_params, card_opt, grads[2])
    for a, b in zip(cpu_params, card_params):
        assert torch.equal(a.detach(), b.detach().cpu())
    for cpu_stack, card_stack in zip(cpu_opt.stacks, card_opt.stacks):
        sa, sb = cpu_opt.state[cpu_stack[0]], card_opt.state[card_stack[0]]
        assert sa["count"] == sb["count"] == 3
        for mom in ("m", "v"):
            assert torch.equal(sa[mom][0].view(torch.uint8), sb[mom][0].cpu().view(torch.uint8))
            assert torch.equal(sa[mom][1], sb[mom][1].cpu())


OPTAX_CASES = [("optax.adamw", {}), ("optax.adamw", {"nesterov": True, "mu_dtype": "bfloat16"}),
               ("optax.adam", {"eps_root": 1e-8}), ("optax.lion", {}),
               ("optax.lion", {"mu_dtype": "bfloat16"}),
               ("optax.sgd", {"momentum": 0.9, "nesterov": True}),
               ("optax.sgd", {"momentum": 0.9, "accumulator_dtype": "bfloat16"}),
               ("optax.contrib.prodigy", {"weight_decay": 0.01})]


@pytest.mark.parametrize("class_path,args", OPTAX_CASES)
def test_optimizers_on_card_equal_cpu(class_path, args):
    """Five updates of each optax optimizer of trainer/optimizers.py on the
    card and on the CPU from the same LoRA-shaped tensors (a / b, and
    scaling leaves Prodigy holds as `frozen`) and the same gradients, which
    share a drift: the elementwise optimizers' parameters and state equal
    to the bit (separate f32 ops, true divisions by a 0-dim tensor on the
    device, square roots and the fused moment update in f64); Prodigy's
    within 1e-5 relative (its two tree-wide f32 sums add in another order
    on the card, the bound tests/test_torch_optimizers.py holds it to
    against optax for the same reason)."""
    from qflux_tpu_torch.trainer import optimizers

    rng = np.random.default_rng(71)
    shapes = [(64, 16), (16, 3072), (3072, 16), (16, 64)]
    init = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    drift = [rng.standard_normal(s) * 10.0 ** rng.uniform(-3, 0, s) for s in shapes + [()] * 2]
    grads = [[(d * (1 + rng.standard_normal(np.shape(d)))).astype(np.float32) for d in drift]
             for _ in range(5)]
    lr = 1.0 if class_path == "optax.contrib.prodigy" else 1e-2
    out = {}
    for device in ("cpu", "cuda"):
        params = [torch.tensor(a, device=device, requires_grad=True) for a in init]
        scalings = [torch.tensor(1.0, device=device, requires_grad=True) for _ in range(2)]
        opt = optimizers.build(class_path, params, lr, args, frozen=scalings)
        for g in grads:
            for p, a in zip(params + scalings, g):
                p.grad = torch.tensor(a, device=device)
            opt.step()
        state = [t.float().cpu() for p in params for _, t in sorted(opt.state[p].items())
                 if torch.is_tensor(t) and t.dim()]
        out[device] = [p.detach().cpu() for p in params + scalings] + state
    for a, b in zip(out["cpu"], out["cuda"]):
        if class_path == "optax.contrib.prodigy":
            assert ((a - b).norm() / a.norm().clamp_min(1e-30)).item() <= 1e-5
        else:
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The modes off bf16 at D = 128: the f32 modes (K3 and K1 on the 3xTF32
# tensor-core loop of csrc/flash_f32_fwd.cu, K4 at head dims 32, 64 and 128 and
# K2 on that of csrc/flash_f32_bwd.cu; K1 / K2's s_int8 mode on the CUDA-core
# kernels of csrc/flash_simt.cu), the narrow mode (K3 / K4 in bf16 at 32 and
# 64, the wgmma kernels templated on the head dim) and the head dims below 128
# no kernel takes (zero-padded to the next one).  The f32 bounds are
# chip_smoke.py's phase K ones: out and lse within 2e-5, the gradients within
# 1e-4 (relative L2: the kernels and the plain
# versions sum in other orders, and exp / rsqrt differ by an ulp); the narrow
# mode is held to the bf16 K3 / K4 bounds above.

F32_REL_TOL = 2e-5
F32_GRAD_TOL = 1e-4
SIMT_CASES = [(300, 520, True), (520, 300, True), (200, 200, False)]


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _simt_inputs(seed, sq, sk, d, dtype, masked):
    """q [B, Sq, H, d], k / v [B, Sk, H, d] of `dtype` on the card and the
    ids of `_k3_inputs` (sample 0's q rows padded from 150, its keys from Sk
    - 60; sample 1 in two segments)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, sk, H, d)).astype(np.float32) for _ in range(2))
    qkv = [torch.from_numpy(a).cuda().to(dtype) for a in (q, k, v)]
    if not masked:
        return qkv + [None, None]
    q_seg, kv_seg = np.ones((B, sq), np.int32), np.ones((B, sk), np.int32)
    q_seg[0, 150:], q_seg[1, 96:] = 0, 2
    kv_seg[0, sk - 60:], kv_seg[1, sk // 3:] = 0, 2
    return qkv + [torch.from_numpy(a).cuda() for a in (q_seg, kv_seg)]


def _simt_counts():
    from qflux_tpu_torch.ops import flash_attention as tfa

    return (tfa.F32_KERNEL_LAUNCHES, tfa.F32_BWD_KERNEL_LAUNCHES, tfa.NARROW_KERNEL_LAUNCHES,
            tfa.NARROW_BWD_KERNEL_LAUNCHES, tnr.F32_KERNEL_LAUNCHES, tnr.F32_BWD_KERNEL_LAUNCHES,
            tnr.F32_INT8_KERNEL_LAUNCHES, tnr.F32_INT8_BWD_KERNEL_LAUNCHES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,masked", SIMT_CASES)
def test_f32_and_narrow_k3_k4_match_plain_on_card(sq, sk, masked, d, dtype):
    """K3 / K4 through the ring hop's entry points in the f32 mode (D = 32,
    64, 128: out and lse within 2e-5, every gradient within 1e-4, relative
    L2) and the narrow mode (bf16 at D = 32, 64: the bf16 K3 / K4 bounds);
    fully masked rows output 0 with lse = -1e30 and a zero dq; one launch of
    the mode's counter each way, and bf16 at D = 128 is the "bf16" mode."""
    from qflux_tpu_torch.ops import flash_attention as tfa

    if dtype == torch.bfloat16 and d == 128:
        assert tfa.mode(torch.empty(1, 1, 1, d, dtype=dtype)) == "bf16"
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, q_seg, kv_seg = _simt_inputs(41 + sq + d, sq, sk, d, dtype, masked)
    scale = d ** -0.5
    c0 = _simt_counts()
    out, lse = tfa.flash_fwd_with_lse(q, k, v, q_seg, kv_seg, scale)
    do = torch.randn(q.shape, device="cuda").to(dtype)
    got = tfa.flash_bwd_from_residuals(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    torch.cuda.synchronize()
    moved = [b - a for a, b in zip(c0, _simt_counts())]
    assert moved[:4] == ([1, 1, 0, 0] if dtype == torch.float32 else [0, 0, 1, 1])
    ref, ref_lse = tfa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
    valid = ref_lse > -1e29
    assert bool((lse[~valid] == -1e30).all())
    want = tfa.flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    if dtype == torch.float32:
        assert _rel_l2(out, ref) <= F32_REL_TOL
        assert _rel_l2(lse[valid], ref_lse[valid]) <= F32_REL_TOL
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and _rel_l2(g, w) <= F32_GRAD_TOL
    else:
        assert (out.float() - ref.float()).abs().max().item() <= 1.6e-2
        assert (lse - ref_lse).abs()[valid].max().item() <= 1e-4
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16 and _rel_l2(g, w) <= 1.5e-2
    if masked:
        dead = _dead_rows(q_seg, kv_seg)
        assert bool(dead.any()) and not out[dead].any() and not got[0][dead].any()


class _EntrySpy:
    """Stands in for the ctypes library: forwards every call and records
    the names of the C entry points called."""

    def __init__(self, lib):
        self._lib, self.names = lib, []

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.startswith("qflux_") or name == "qflux_cuda_error_string":
            return fn

        def call(*args):
            self.names.append(name)
            return fn(*args)
        return call


def test_f32_and_narrow_modes_never_reach_the_plain_version(monkeypatch):
    """f32 attention on CUDA tensors launches the 3xTF32 K3 and K4 of
    csrc/flash_f32_fwd.cu / flash_f32_bwd.cu, and bf16 at D = 32 / 64 the
    wgmma K3 / K4 (qflux_flash_fwd / _bwd, never a qflux_simt_* entry),
    through `flash_attention` (forward and autograd); the fused K1 / K2 in
    f32 launch qflux_f32_nr_fwd / qflux_f32_nr_bwd (never the s_int8
    modes' qflux_f32_nr_int8_*), and none calls the plain versions
    (replaced by functions that raise).  f32 at head dim 96 runs the kernels
    zero-padded to 128 (qflux_f32_fwd / _bwd) and matches the plain
    version forward and backward (2e-5 / 1e-4); an f16 q raises, naming
    what the kernels take."""
    from qflux_tpu_torch.ops import flash_attention as tfa
    from qflux_tpu_torch.runtime import build

    plain_fwd, plain_bwd = tfa.flash_fwd_reference, tfa.flash_bwd_reference

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("flash_fwd_reference", "flash_bwd_reference"):
        monkeypatch.setattr(tfa, name, refuse)
    for name in ("flash_attention_nr_reference", "flash_attention_nr_bwd_reference"):
        monkeypatch.setattr(tnr, name, refuse)
    kl = build.load_library()
    spy = _EntrySpy(kl.lib)
    monkeypatch.setattr(build, "load_library", lambda: dataclasses.replace(kl, lib=spy))
    for dtype, d in ((torch.float32, 32), (torch.bfloat16, 64), (torch.bfloat16, 32),
                     (torch.float32, 128)):
        q, k, v, q_seg, kv_seg = _simt_inputs(7, 200, 200, d, dtype, True)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        spy.names.clear()
        tfa.flash_attention(*leaves, segment_ids=q_seg).float().square().sum().backward()
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(x.grad).all()) for x in leaves)
        assert spy.names == (["qflux_f32_fwd", "qflux_f32_bwd"] if dtype == torch.float32
                             else ["qflux_flash_fwd", "qflux_flash_bwd"]), (dtype, d)
    args = _inputs(8, 300)
    args = [a.float() for a in args[:3]] + args[3:]
    leaves = [a.clone().requires_grad_() for a in args[:3]]
    c0 = _simt_counts()
    spy.names.clear()
    out, _ = tnr.flash_attention_nr(*leaves, *args[3:], ST)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(c0, _simt_counts())][4:6] == [1, 1]
    assert [n for n in spy.names if n != "qflux_flash_nr_bwd_tiles"] == [
        "qflux_f32_nr_fwd", "qflux_f32_nr_bwd"]
    q, k, v, q_seg, kv_seg = _simt_inputs(9, 200, 200, 96, torch.float32, True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    do = torch.randn(q.shape, device="cuda")
    spy.names.clear()
    out = tfa.flash_attention(*leaves, segment_ids=q_seg, kv_segment_ids=kv_seg)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert spy.names == ["qflux_f32_fwd", "qflux_f32_bwd"]
    scale = 96 ** -0.5
    ref, lse = plain_fwd(q, k, v, q_seg, kv_seg, scale)
    assert out.shape == q.shape and _rel_l2(out, ref) <= F32_REL_TOL
    for g, w in zip(got, plain_bwd(q, k, v, q_seg, kv_seg, ref, lse, do, scale)):
        assert g.shape == w.shape and _rel_l2(g, w) <= F32_GRAD_TOL
    q = torch.zeros(1, 8, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q, q, q)


# the narrow mode at the edges TMA creates: S below one 64-row tile, S off the
# 64- and 128-row tiles, Sq != Sk, fully masked rows, the unmasked case
NARROW_EDGE_CASES = [(40, 40, True), (40, 40, False), (300, 520, True), (520, 300, False),
                     (129, 777, True), (777, 129, True), (1, 130, True)]


def _narrow_edge_inputs(seed, sq, sk, d, masked, dtype=torch.bfloat16):
    """q [2, Sq, H, d] and k / v [2, Sk, H, d] of `dtype` on the card; with ids,
    sample 0's last quarter of q rows is padding (segment 0) and its last
    third of keys too, sample 1 is two segments, and its last q row is
    segment 3, which no key has: two kinds of fully masked row."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, sk, H, d)).astype(np.float32) for _ in range(2))
    qkv = [torch.from_numpy(a).cuda().to(dtype) for a in (q, k, v)]
    if not masked:
        return qkv + [None, None]
    q_seg, kv_seg = np.ones((B, sq), np.int32), np.ones((B, sk), np.int32)
    q_seg[0, sq - sq // 4:], kv_seg[0, sk - sk // 3:] = 0, 0
    q_seg[1, sq // 2:], kv_seg[1, sk // 2:] = 2, 2
    q_seg[1, -1] = 3
    return qkv + [torch.from_numpy(a).cuda() for a in (q_seg, kv_seg)]


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("sq,sk,masked", NARROW_EDGE_CASES)
def test_narrow_k3_k4_edges_match_plain_on_card(sq, sk, masked, d):
    """The narrow wgmma K3 / K4 (bf16 at D = 32, 64) at the edges of their
    TMA tiles, through `flash_fwd_with_lse` / `flash_bwd_from_residuals`:
    out within 1.6e-2 and lse within 1e-4 of the plain version, every
    gradient within 1.5e-2 relative L2 of the plain formula with nonzero do
    on every row, fully masked rows at 0 with lse = -1e30 and a zero dq,
    two calls identical to the bit, one narrow launch each way."""
    from qflux_tpu_torch.ops import flash_attention as tfa

    q, k, v, q_seg, kv_seg = _narrow_edge_inputs(sq + 7 * sk + d, sq, sk, d, masked)
    scale = d ** -0.5
    c0 = _simt_counts()
    out, lse = tfa.flash_fwd_with_lse(q, k, v, q_seg, kv_seg, scale)
    do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
    got = tfa.flash_bwd_from_residuals(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(c0, _simt_counts())][:4] == [0, 0, 1, 1]
    out2, lse2 = tfa.flash_fwd_with_lse(q, k, v, q_seg, kv_seg, scale)
    again = tfa.flash_bwd_from_residuals(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    ref, ref_lse = tfa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
    valid = ref_lse > -1e29
    assert (out.float() - ref.float()).abs().max().item() <= 1.6e-2
    assert (lse - ref_lse).abs()[valid].max().item() <= 1e-4
    assert bool((lse[~valid] == -1e30).all())
    want = tfa.flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape and _rel_l2(g, w) <= 1.5e-2
    if masked:
        dead = _dead_rows(q_seg, kv_seg)
        assert bool(dead[1, -1]) and not out[dead].any() and not got[0][dead].any()


# the f32 K3 at the edges its tiles (128 q rows, 64 keys) and TMA create: S
# below one tile, S off the tiles, Sq != Sk, B = 2 with fully masked rows, the
# unmasked case, one q row
F32_EDGE_CASES = NARROW_EDGE_CASES + [(256, 256, False)]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,masked", F32_EDGE_CASES)
def test_f32_k3_edges_match_plain_on_card(sq, sk, masked, d):
    """The 3xTF32 K3 (csrc/flash_f32_fwd.cu) at the edges of its tiles,
    through `flash_fwd_with_lse`: out and lse within 2e-5 relative L2 of
    the plain version, fully masked rows at exactly 0 with lse = -1e30, two
    calls identical to the bit, one f32 K3 launch a call."""
    from qflux_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, q_seg, kv_seg = _narrow_edge_inputs(3 * sq + sk + d, sq, sk, d, masked,
                                                 torch.float32)
    scale = d ** -0.5
    c0 = _simt_counts()
    out, lse = tfa.flash_fwd_with_lse(q, k, v, q_seg, kv_seg, scale)
    out2, lse2 = tfa.flash_fwd_with_lse(q, k, v, q_seg, kv_seg, scale)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(c0, _simt_counts())][:4] == [2, 0, 0, 0]
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref, ref_lse = tfa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
    valid = ref_lse > -1e29
    assert out.dtype == torch.float32 and _rel_l2(out, ref) <= F32_REL_TOL
    assert _rel_l2(lse[valid], ref_lse[valid]) <= F32_REL_TOL
    assert bool((lse[~valid] == -1e30).all())
    if masked:
        dead = _dead_rows(q_seg, kv_seg)
        assert bool(dead[1, -1]) and bool((out[dead] == 0).all())


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,masked", F32_EDGE_CASES)
def test_f32_k4_edges_match_plain_on_card(sq, sk, masked, d):
    """The 3xTF32 K4 (csrc/flash_f32_bwd.cu) at the edges of its tiles (64
    own rows, 32 or 64 streamed ones) and TMA's, through
    `flash_bwd_from_residuals` fed the plain forward's out / lse with
    nonzero do on every row: dq, dk and dv within 1e-4 relative L2 of the
    plain formula, the fully masked rows' dq exactly 0 (and with them their
    keys' dk / dv where no row attends), two calls identical to the bit, one
    f32 K4 launch a call."""
    from qflux_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, q_seg, kv_seg = _narrow_edge_inputs(5 * sq + sk + d, sq, sk, d, masked,
                                                 torch.float32)
    scale = d ** -0.5
    out, lse = (t.contiguous() for t in tfa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale))
    do = torch.randn(q.shape, device="cuda")
    c0 = _simt_counts()
    got = tfa.flash_bwd_from_residuals(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    again = tfa.flash_bwd_from_residuals(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(c0, _simt_counts())][:4] == [0, 2, 0, 0]
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = tfa.flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape and _rel_l2(g, w) <= F32_GRAD_TOL
    if masked:
        dead = _dead_rows(q_seg, kv_seg)
        assert bool(dead[1, -1]) and bool((got[0][dead] == 0).all())
        lone = _dead_rows(kv_seg, q_seg)  # keys no q row attends
        assert bool((got[1][lone] == 0).all()) and bool((got[2][lone] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 48, 96])
def test_padded_head_dims_match_plain_on_card(d, dtype):
    """A head dim below 128 that no kernel takes runs K3 / K4 zero-padded to
    the next one (32, 64, 128) with the caller's scale, through the ring
    hop's entry points: out, lse and the gradients at D against the plain
    version (f32 within 2e-5 / 1e-4 relative L2, bf16 within the bf16 K3 /
    K4 bounds), fully masked rows at 0; one launch of the mode's counter
    each way (bf16 at 96 runs the D = 128 kernels, not the narrow ones)."""
    from qflux_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, q_seg, kv_seg = _narrow_edge_inputs(11 * d, 300, 520, d, True, dtype)
    scale = d ** -0.5
    c0 = _simt_counts()
    out, lse = tfa.flash_fwd_with_lse(q, k, v, q_seg, kv_seg, scale)
    do = torch.randn(q.shape, device="cuda").to(dtype)
    got = tfa.flash_bwd_from_residuals(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    torch.cuda.synchronize()
    moved = [b - a for a, b in zip(c0, _simt_counts())][:4]
    narrow = dtype == torch.bfloat16 and tfa.run_head_dim(d) < 128
    assert moved == ([1, 1, 0, 0] if dtype == torch.float32 else [0, 0, int(narrow), int(narrow)])
    ref, ref_lse = tfa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)
    valid = ref_lse > -1e29
    want = tfa.flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
    assert out.shape == q.shape and all(g.shape == w.shape for g, w in zip(got, want))
    if dtype == torch.float32:
        assert _rel_l2(out, ref) <= F32_REL_TOL
        assert _rel_l2(lse[valid], ref_lse[valid]) <= F32_REL_TOL
        assert all(_rel_l2(g, w) <= F32_GRAD_TOL for g, w in zip(got, want))
    else:
        assert (out.float() - ref.float()).abs().max().item() <= 1.6e-2
        assert (lse - ref_lse).abs()[valid].max().item() <= 1e-4
        assert all(_rel_l2(g, w) <= 1.5e-2 for g, w in zip(got, want))
    dead = _dead_rows(q_seg, kv_seg)
    assert not out[dead].any() and not got[0][dead].any()


def test_f32_s_int8_entries_refuse_untaken_q_tiles_on_card():
    """csrc/flash_simt.cu exports no attention loop (no qflux_simt_nr_fwd /
    _bwd); the f32 s_int8 modes' entries, qflux_f32_nr_int8_fwd / _bwd in
    csrc/flash_f32_fwd.cu / flash_f32_bwd.cu, refuse q_rows = 0 (K1's and
    K2's plain f32 modes run qflux_f32_nr_fwd / _bwd) and q tiles a block's
    rows would straddle (the forward's 128 rows: 64 and 96; the backward's
    64: 96) with cudaErrorInvalidValue (1) from the argument check,
    launching nothing."""
    from qflux_tpu_torch.runtime.build import load_library

    lib = load_library().lib
    assert not hasattr(lib, "qflux_simt_nr_fwd") and not hasattr(lib, "qflux_simt_nr_bwd")
    b, s, h = 1, 64, 2
    z = torch.zeros(b, s, h, D, device="cuda")
    out = torch.zeros_like(z)
    lse, delta = (torch.zeros(b, h, s, device="cuda") for _ in range(2))
    grads = [torch.zeros_like(z) for _ in range(3)]
    parts = [torch.zeros(b, h, 1, 2, D, device="cuda") for _ in range(2)]
    stream = torch.cuda.current_stream().cuda_stream
    zp = z.data_ptr()
    for rows in (0, 64, 96):
        assert lib.qflux_f32_nr_int8_fwd(zp, zp, zp, None, None, None, None, 0, None, zp, zp,
                                         zp, zp, zp, rows, out.data_ptr(), lse.data_ptr(), b, s,
                                         h, 0, 0.125, stream) == 1, rows
    for rows in (0, 96):
        assert lib.qflux_f32_nr_int8_bwd(zp, zp, zp, None, None, None, None, 0, None, zp, zp, zp,
                                         zp, zp, delta.data_ptr(), zp, zp, zp, zp, zp, rows,
                                         *(g.data_ptr() for g in grads),
                                         *(t.data_ptr() for t in parts), b, s, h, 0, 0.125,
                                         stream) == 1, rows
    torch.cuda.synchronize()
    assert not any(g.any() for g in grads) and not out.any()


def _nr_f32_inputs(seed, s, h=4):
    """f32 q / k / v [1, S, h, 128], scale pairs and [S, 128] rope tables on
    the card, and the FLUX text layout: 512 text rows (st), the last 20 of
    them padding."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, s, h, D)).astype(np.float32) for _ in range(3))
    qs2, ks2 = ((1 + 0.1 * rng.standard_normal((2, D))).astype(np.float32) for _ in range(2))
    ang = rng.uniform(0, 6.28, (s, D // 2)).astype(np.float32)
    cos, sin = np.concatenate([np.cos(ang)] * 2, -1), np.concatenate([np.sin(ang)] * 2, -1)
    seg = np.ones((1, s), np.int32)
    seg[0, 492:512] = 0
    return ([torch.from_numpy(a).cuda() for a in (q, k, v, qs2, ks2, cos, sin)],
            torch.from_numpy(seg).cuda())


@pytest.mark.parametrize("s", [2304, 2560])
def test_f32_k1_k2_match_plain_on_card(s):
    """K1 / K2 in f32 at FLUX's S = 2560 and path A's 2304 with text
    padding, through the custom op and its autograd: out and lse within
    2e-5, dq / dk / dv and both scale-pair gradients within 1e-4 of the
    plain versions (f32 autograd through the plain forward); one f32 launch
    each way."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args, seg = _nr_f32_inputs(s, s)
    do = torch.randn(args[0].shape, device="cuda")
    leaves = [a.clone().requires_grad_() for a in args[:5]]
    c0 = _simt_counts()
    out, lse = tnr.flash_attention_nr(*leaves, *args[5:], 512, segment_ids=seg)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(c0, _simt_counts())][4:8] == [1, 1, 0, 0]
    ref, ref_lse = tnr.flash_attention_nr_reference(*args, 512, segment_ids=seg)
    valid = ref_lse > -1e29
    assert _rel_l2(out, ref) <= F32_REL_TOL
    assert _rel_l2(lse[valid], ref_lse[valid]) <= F32_REL_TOL
    want = tnr.flash_attention_nr_bwd_reference(*args, 512, do, segment_ids=seg)
    for name, g, w in zip(("dq", "dk", "dv", "dqs", "dks"), got, want):
        assert _rel_l2(g, w) <= F32_GRAD_TOL, name
    assert not got[0][0, 492:512].any()


# the f32 s_int8 cases: S (q tiles from s_int8_tiles), B, H, st, the id layout:
# FLUX's text padding (rows 492..511 at segment 0); "qwen": B = 2, sample 0 with
# Qwen's text padding (`_f32_int8_ids`), sample 1 fully masked; H = 5 and 3 are off
# the bf16 prep's groups of four heads
F32_INT8_CASES = [(2304, 1, 4, 512, "flux"), (2560, 1, 4, 512, "flux"),
                  (1024, 1, 4, 512, "flux"), (2304, 2, 5, 64, "qwen"),
                  (2560, 2, 3, 300, "qwen")]


def _f32_int8_ids(s, b, layout):
    """[B, S] int32 ids on the card and the [B, S] bool rows that attend nothing."""
    seg = np.ones((b, s), np.int32)
    if layout == "flux":
        seg[:, 492:512] = 0
    else:
        seg[0, 230:256] = 0
        seg[1] = 0
    return torch.from_numpy(seg).cuda(), torch.from_numpy(seg == 0).cuda()


@pytest.mark.parametrize("s,b,h,st,layout", F32_INT8_CASES,
                         ids=[f"s{c[0]}_b{c[1]}_h{c[2]}_st{c[3]}" for c in F32_INT8_CASES])
def test_f32_s_int8_matches_plain_on_card(monkeypatch, s, b, h, st, layout):
    """K1 / K2's s_int8 mode in f32, the int8-score wgmma loops of
    csrc/flash_f32_fwd.cu / flash_f32_bwd.cu, at S = 1024, 2304 and 2560 with
    s_int8_tiles' rows (F32_INT8_CASES: B = 2 with Qwen's text padding and a
    fully masked sample, st at 64 and ragged, H off the groups of four):
    the prep's qn / kn within 2e-5 of the plain norm + rope and its int8
    operands equal to `quant_rows` of them to the bit; on those qn / kn (an
    f32 ulp from the plain ones can cross an int8 rounding midpoint) out and
    lse within 2e-5 of the plain int8 versions and the straight-through
    gradients within 1e-4 (relative L2), the rows that attend nothing 0 in
    out, dq, dk and dv with lse -1e30.  Through flash_attention_nr(s_int8=
    True) and autograd, twice: identical to the bit, one
    qflux_f32_nr_int8_fwd and one qflux_f32_nr_int8_bwd a call and no other
    entry, no plain version called (replaced by functions that raise)."""
    from qflux_tpu_torch.runtime import build

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(9 + s + b)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, D)).astype(np.float32)).cuda()
               for _ in range(3))
    qs2, ks2 = (torch.from_numpy((1 + 0.1 * rng.standard_normal((2, D))).astype(np.float32))
                .cuda() for _ in range(2))
    ang = rng.uniform(0, 6.28, (s, D // 2)).astype(np.float32)
    cos, sin = (torch.from_numpy(np.concatenate([f(ang)] * 2, -1)).cuda() for f in (np.cos, np.sin))
    args = [q, k, v, qs2, ks2, cos, sin]
    seg, dead = _f32_int8_ids(s, b, layout)
    fwd_rows, bwd_rows = tnr.s_int8_tiles(s, D)
    for rows in (fwd_rows, bwd_rows):
        qn, kn, qq, kq, q_sc, k_sc = tnr._int8_operands_cuda(q, k, qs2, ks2, cos, sin, st, rows)
        assert _rel_l2(qn, tnr.apply_qk_norm_rope(q, qs2, cos, sin, st)) <= F32_REL_TOL
        assert _rel_l2(kn, tnr.apply_qk_norm_rope(k, ks2, cos, sin, st)) <= F32_REL_TOL
        wq, wqs = tnr.quant_rows(qn, rows)
        wk, wks = tnr.quant_rows(kn, s)
        assert torch.equal(qq, wq) and torch.equal(q_sc, wqs)
        assert torch.equal(kq, wk) and torch.equal(k_sc, wks[:, 0])
    plain_fwd = tnr.flash_attention_nr_int8_reference
    plain_bwd = tnr.flash_attention_nr_int8_bwd_reference

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("flash_attention_nr_int8_reference", "flash_attention_nr_int8_bwd_reference",
                 "flash_attention_nr_reference", "flash_attention_nr_bwd_reference"):
        monkeypatch.setattr(tnr, name, refuse)
    kl = build.load_library()
    spy = _EntrySpy(kl.lib)
    monkeypatch.setattr(build, "load_library", lambda: dataclasses.replace(kl, lib=spy))
    do = torch.randn(q.shape, device="cuda")
    c0 = _simt_counts()
    runs = []
    for _ in range(2):
        leaves = [a.clone().requires_grad_() for a in args[:5]]
        out, lse = tnr.flash_attention_nr(*leaves, cos, sin, st, segment_ids=seg, s_int8=True)
        runs.append((out.detach(), lse, *torch.autograd.grad(out, leaves, do)))
    torch.cuda.synchronize()
    assert [y - x for x, y in zip(c0, _simt_counts())][4:8] == [0, 0, 2, 2]
    assert [n for n in spy.names if n != "qflux_flash_nr_bwd_tiles"] == [
        "qflux_f32_nr_int8_fwd", "qflux_f32_nr_int8_bwd"] * 2
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    out, lse, *got = runs[0]
    ref, ref_lse = plain_fwd(*args, st, fwd_rows, segment_ids=seg, normed=(qn, kn))
    valid = ref_lse > -1e29
    assert _rel_l2(out, ref) <= F32_REL_TOL
    assert _rel_l2(lse[valid], ref_lse[valid]) <= F32_REL_TOL
    assert bool((lse[~valid] == -1e30).all()) and not out[dead].any()
    want = plain_bwd(*args, st, do, out, lse, bwd_rows, segment_ids=seg, normed=(qn, kn))
    for name, g, w in zip(("dq", "dk", "dv", "dqs", "dks"), got, want):
        assert bool(torch.isfinite(g).all()) and _rel_l2(g, w) <= F32_GRAD_TOL, name
    assert all(not g[dead].any() for g in got[:3])


def test_flux_block_f32_forward_and_lora_grads_on_card():
    """One dual and one single FLUX.1 block at full width (3072, 24 heads ×
    128), f32, at the 512² shape with one control (S = 512 + 2 · 1024):
    the forward runs the f32 K1 once a block and the backward the f32 K2,
    and the output and the to_q / to_k / to_v / to_out LoRA gradients are
    within 1e-4 (relative L2) of the plain attention's."""
    from qflux_tpu_torch.models.flux import transformer as tflux
    from qflux_tpu_torch.ops.layers import build_lora_tree, mark_trainable, merge_lora
    from qflux_tpu_torch.ops.rope import flux_image_ids, flux_text_ids

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(tflux.FluxConfig(), num_layers=1, num_single_layers=1)
    gen = torch.Generator("cuda").manual_seed(0)
    model = tflux.init(gen, cfg, "cuda", torch.float32)
    lora = mark_trainable(build_lora_tree(gen, model, [r"attn/(to_q|to_k|to_v|to_out)"], 16,
                                          16.0))
    with torch.no_grad():
        for leaf in lora.values():
            leaf["b"].normal_(0.0, 0.01, generator=gen)
    merge_lora(model, lora)
    ids = torch.from_numpy(np.concatenate([flux_image_ids(32, 32, 0),
                                           flux_image_ids(32, 32, 1)])).cuda()
    txt_ids = torch.from_numpy(flux_text_ids(512)).cuda()
    x = torch.randn(1, 2048, cfg.in_channels, device="cuda", generator=gen)
    txt = torch.randn(1, 512, cfg.joint_attention_dim, device="cuda", generator=gen)
    pooled = torch.randn(1, cfg.pooled_projection_dim, device="cuda", generator=gen)
    t = torch.full((1,), 0.5, device="cuda")

    def run(attn_impl):
        for leaf in lora.values():
            leaf["a"].grad = leaf["b"].grad = None
        y = tflux.forward(model, cfg, x, txt, pooled, t, ids, txt_ids, guidance=t,
                          attn_impl=attn_impl, remat_policy="flash")
        y.pow(2).mean().backward()
        return y.detach(), torch.cat([leaf[k].grad.flatten() for leaf in lora.values()
                                      for k in ("a", "b")])

    c0 = _simt_counts()
    y_k, g_k = run("auto")
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(c0, _simt_counts())][4:6] == [2, 2]
    y_p, g_p = run("plain")
    assert _rel_l2(y_k, y_p) <= F32_GRAD_TOL and _rel_l2(g_k, g_p) <= F32_GRAD_TOL
    assert bool(g_k.abs().sum() > 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("trainer", ["FluxKontextLoraTrainer", "QwenImageEditTrainer"])
def test_variant_test_fit_and_predict_on_card(trainer, dtype):
    """Variant `test` (head dim 32) on the card: a two-step fit and a
    two-step predict from cached embeddings, their attention through K3 /
    K4 in the narrow bf16 mode or the f32 mode (K3 on every block of every
    forward, K4 on every block of every step), finite losses and uint8
    images."""
    from qflux_tpu_torch.ops import flash_attention as tfa
    from qflux_tpu_torch.ops.rope import flux_image_ids, flux_text_ids
    from qflux_tpu_torch.trainer.base import Trainer, train_config

    cfg = train_config(variant="test", max_train_steps=2)
    cfg.trainer.value = trainer
    cfg.train.weight_dtype = dtype
    tr = Trainer(cfg, device="cuda")
    tr.load_model()
    rng = np.random.default_rng(0)
    if trainer == "FluxKontextLoraTrainer":
        emb = {"control_latents": rng.standard_normal((1, 64, 16)).astype(np.float32),
               "prompt_embeds": rng.standard_normal((1, 8, 64)).astype(np.float32),
               "pooled_prompt_embeds": rng.standard_normal((1, 32)).astype(np.float32),
               "tgt_ids": flux_image_ids(8, 8, 0), "ctl_ids": flux_image_ids(8, 8, 1),
               "txt_ids": flux_text_ids(8)}
        size, n_lat = 32, 64
    else:
        emb = {"control_latents": rng.standard_normal((1, 16, 16)).astype(np.float32),
               "prompt_embeds": rng.standard_normal((1, 8, 48)).astype(np.float32),
               "prompt_embeds_mask": np.array([[1] * 6 + [0] * 2]),
               "img_shapes_arr": np.array([[1, 4, 4], [1, 4, 4]], np.int32)}
        size, n_lat = 16, 16
    mode = "F32_" if dtype == "float32" else "NARROW_"
    c0 = {n: getattr(tfa, mode + n) for n in ("KERNEL_LAUNCHES", "BWD_KERNEL_LAUNCHES")}
    tr.lora = tr.build_lora()
    img = tr.predict_from_embeddings(emb, size, size)
    assert img.shape == (1, size, size, 3) and img.dtype == np.uint8
    emb["image_latents"] = rng.standard_normal((1, n_lat, 16)).astype(np.float32)
    tr.fit([emb] * 3)
    torch.cuda.synchronize()
    assert len(tr.history) == 2 and all(np.isfinite(h["loss"]) for h in tr.history)
    assert getattr(tfa, mode + "KERNEL_LAUNCHES") > c0["KERNEL_LAUNCHES"]
    assert getattr(tfa, mode + "BWD_KERNEL_LAUNCHES") > c0["BWD_KERNEL_LAUNCHES"]
