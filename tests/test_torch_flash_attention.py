"""Kernels K3 and K4 of the port (qflux_tpu_torch/ops/flash_attention.py:
the plain flash forward over normed and roped q / k, and its backward)
against the JAX package's `flash_attention`, `flash_fwd_with_lse`,
`flash_bwd_from_residuals` and `jax.vjp(flash_attention)`, run as
tests/ops/test_attention.py runs them on the CPU (the Pallas kernels K3,
K4a and K4b + K4c in interpret mode); the one-chip dispatch of
`qk_norm_rope_attention` (`flash_nr.supports` against JAX's); a two-block
Qwen DiT through the K3 route against JAX's TPU route; and the custom op's
autograd and remat wiring with plain-math doubles for the launchers.

Tolerances, float32 throughout.  The plain versions and the interpret-mode
kernels do the same f32 arithmetic in another order (the kernels' online
softmax over K blocks, their tiled sums): measured at most 7e-7 absolute on
out, lse and the gradients at unit-scale inputs, so ATOL = 2e-5 (and the
DiT's relative L2 2e-5, the bound of tests/test_torch_s_int8.py) sits well
above that and far below what a wrong mask, scale or residual gives.

The CUDA kernels cannot run here; tests/test_torch_card.py holds them
against these plain versions where a card is present.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from qflux_tpu.losses import losses as jlosses
from qflux_tpu.models.qwen import transformer as jqwen
from qflux_tpu.ops import flash_attention as jfa
from qflux_tpu.ops import flash_nr as jnr
from qflux_tpu.trainer import qwen_edit as jqe
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.qwen import transformer as tqwen
from qflux_tpu_torch.ops import attention as tattn
from qflux_tpu_torch.ops import flash_attention as tfa
from qflux_tpu_torch.ops import flash_nr as tnr
from qflux_tpu_torch.ops import remat as tremat
from qflux_tpu_torch.trainer import qwen_edit as tqe
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err
from tests.test_torch_qwen import _lora, _np_tree
from tests.test_torch_qwen_train import _batch, _noise_sigma
from tests.test_torch_s_int8 import JCFG8, TCFG8, _port_lora_grads
from tests.test_torch_train import _jax_step

B, H, D = 2, 2, 128
ATOL = 2e-5
SCALE = D ** -0.5


def _qkv(seed, sq, sk=None):
    rng = np.random.default_rng(seed)
    sk = sq if sk is None else sk
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, sk, H, D)).astype(np.float32) for _ in range(2))
    return q, k, v


def _seg(s, pad_from=None, split=None):
    """[B, s] ids: sample 0 padded (0) from `pad_from`, sample 1 in two
    segments split at `split`."""
    seg = np.ones((B, s), np.int32)
    if pad_from is not None:
        seg[0, pad_from:] = 0
    if split is not None:
        seg[1, split:] = 2
    return seg


# name: (sq, sk, q ids, kv ids); "aligned" is JAX's unmasked specialisation
# (no ids, K a multiple of its block), "ragged" pads K with segment 0, "cross"
# hands in different q / kv id vectors over Sq != Sk, where rows 100.. of
# sample 1 find no key of their segment (fully masked, as the padded rows)
CASES = {
    "masked": (300, 300, _seg(300, 230, 96), _seg(300, 230, 96)),
    "aligned": (256, 256, None, None),
    "ragged": (200, 200, None, None),
    "cross": (200, 320, _seg(200, 170, 100), _seg(320, 250, 500)),
}


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _masked_rows(q_seg, kv_seg):
    """[B, Sq] bool: rows whose every key is masked."""
    if q_seg is None:
        return None
    return ~((q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg[:, :, None] != 0)).any(-1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k3_matches_jax(case):
    """flash_fwd_reference against JAX's `flash_fwd_with_lse` (out, lse) and
    `flash_attention` (out), the Pallas K3 in interpret mode: fully masked
    rows output 0 with lse = -1e30 on both sides; the public entry points
    take the plain version for CPU tensors."""
    sq, sk, qs, ks = CASES[case]
    q, k, v = _qkv(1, sq, sk)
    out, lse = tfa.flash_fwd_reference(*_t(q, k, v, qs, ks), SCALE)
    assert out.shape == (B, sq, H, D) and lse.shape == (B, H, sq)
    j_out = jfa.flash_attention(*_j(q, k, v), segment_ids=_j(qs)[0], kv_segment_ids=_j(ks)[0])
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL)
    assert torch.equal(tfa.flash_attention(*_t(q, k, v), *_t(qs, ks)), out)
    if qs is not None:
        jw_out, jw_lse = jfa.flash_fwd_with_lse(*_j(q, k, v, qs, ks), SCALE)
        np.testing.assert_allclose(out.numpy(), np.asarray(jw_out), atol=ATOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jw_lse), atol=ATOL, rtol=1e-6)
        dead = _masked_rows(qs, ks)
        assert dead.any() and not out.numpy()[dead].any()
        assert np.all(lse.numpy().transpose(0, 2, 1)[dead] == -1e30)
        got = tfa.flash_fwd_with_lse(*_t(q, k, v, qs, ks), SCALE)
        assert torch.equal(got[0], out) and torch.equal(got[1], lse)


def _jax_grads(q, k, v, qs, ks, do, **blocks):
    def loss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, segment_ids=_j(qs)[0],
                                           kv_segment_ids=_j(ks)[0], **blocks) * jnp.asarray(do))

    return jax.grad(loss, argnums=(0, 1, 2))(*_j(q, k, v))


@pytest.mark.parametrize("case,regime", [("masked", "merged"), ("aligned", "merged"),
                                         ("cross", "merged"), ("masked384", "split"),
                                         ("aligned384", "split")])
def test_plain_k4_matches_jax_vjp(case, regime):
    """flash_bwd_reference against jax.vjp of `flash_attention`: its merged
    backward (K4a) at the default blocks, and the split one (K4b + K4c) at
    JAX's block_q = block_k = 128 over S = 384 (K in three blocks).  The
    cotangent is nonzero on every row, padded ones included: their
    gradients, and what they could leak into valid keys' dk / dv, stay
    0."""
    if case.endswith("384"):
        s = 384
        seg = _seg(s, 300, 130) if case.startswith("masked") else None
        sq, sk, qs, ks = s, s, seg, seg
    else:
        sq, sk, qs, ks = CASES[case]
    q, k, v = _qkv(2, sq, sk)
    do = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    out, lse = tfa.flash_fwd_reference(*_t(q, k, v, qs, ks), SCALE)
    got = tfa.flash_bwd_reference(*_t(q, k, v, qs, ks), out, lse, torch.from_numpy(do), SCALE)
    blocks = {"block_q": 128, "block_k": 128} if regime == "split" else {}
    if regime == "split":
        assert jfa._auto_block(sk, jfa.BLOCK_K_CAP) != 128  # the blocks are not the default
    want = _jax_grads(q, k, v, qs, ks, do, **blocks)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)
    if qs is not None:
        dead = _masked_rows(qs, ks)
        assert not got[0].numpy()[dead].any()
        # the same through the public entry point's autograd on CPU tensors
        leaves = [t.requires_grad_() for t in _t(q, k, v)]
        auto = torch.autograd.grad(tfa.flash_attention(*leaves, *_t(qs, ks)), leaves,
                                   torch.from_numpy(do))
        for g, a in zip(got, auto):
            np.testing.assert_allclose(a.numpy(), g.numpy(), atol=ATOL)


def test_plain_k4_from_global_residuals_as_a_ring_hop():
    """A ring hop's backward: q against one shard of K / V (its own kv ids),
    with the GLOBAL out / lse of attention over both shards.  The plain K4
    matches JAX's `flash_bwd_from_residuals` (the Pallas kernels in interpret
    mode, lse padded with 0 there), and the two hops' dq sum, and their dk /
    dv concatenated, are the gradients of attention over the whole K."""
    sq, sk = 200, 320
    qs, ks = _seg(sq, 170, 150), _seg(2 * sk, 600, 430)
    q, k, v = _qkv(4, sq, 2 * sk)
    do = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    out, lse = tfa.flash_fwd_reference(*_t(q, k, v, qs, ks), SCALE)
    full = tfa.flash_bwd_reference(*_t(q, k, v, qs, ks), out, lse, torch.from_numpy(do), SCALE)
    hops = []
    for h in range(2):
        sl = slice(h * sk, (h + 1) * sk)
        hk, hv, hks = k[:, sl], v[:, sl], ks[:, sl]
        got = tfa.flash_bwd_from_residuals(*_t(q, hk, hv, qs, hks), out, lse,
                                           torch.from_numpy(do), SCALE)
        want = jfa.flash_bwd_from_residuals(*_j(q, hk, hv, qs, hks), jnp.asarray(out.numpy()),
                                            jnp.asarray(lse.numpy()), jnp.asarray(do), SCALE)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=f"hop {h} {name}")
        hops.append(got)
    np.testing.assert_allclose((hops[0][0] + hops[1][0]).numpy(), full[0].numpy(), atol=ATOL)
    for i in (1, 2):
        np.testing.assert_allclose(torch.cat([hops[0][i], hops[1][i]], 1).numpy(),
                                   full[i].numpy(), atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("s_int8", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_supports_matches_jax(s_int8, d, dtype):
    """`flash_nr.supports` = JAX's `flash_nr.supports` at its defaults, on
    both sides of each boundary (padded S 2688 in bf16, 2560 in int8), and
    cross attention; `s_int8_tiles` is None exactly where the int8 route
    does not apply.  JAX routes by shape alone, so the dtype changes
    nothing: the port's `fused_route` is JAX's choice in f32 and bf16, and
    a kernel takes each route's inputs on the card (K1 / K2 at D = 128 in
    both dtypes; `flash_attention.mode` names K3 / K4's mode at every head
    dim: "bf16" at 128 and "narrow" at 32 / 64 for the wgmma kernels, "f32"
    for the CUDA-core ones)."""
    impl = "int8" if s_int8 else "auto"
    for s in (2304, 2560, 2561, 2688, 2689, 4000, 4256):
        assert tnr.supports(s, s, d, s_int8) == jnr.supports(s, s, d, s_int8), s
        assert tattn.fused_route(s, s, d, impl) == jnr.supports(s, s, d, s_int8), s
        assert (tnr.s_int8_tiles(s, d) is not None) == jnr.supports(s, s, d, True), s
    assert not tnr.supports(256, 512, d, s_int8) and not jnr.supports(256, 512, d, s_int8)
    if d == 128:
        assert tnr.supports(2688, 2688, d, s_int8) == (not s_int8)
        q = torch.zeros(1, 64, 2, d, dtype=dtype)
        cos = torch.zeros(64, d)
        assert tnr._kernel_args(q, q, q, cos[:2], cos[:2], cos, cos, None)[2] == 0
    want = {(torch.bfloat16, 128): "bf16"}.get((dtype, d),
                                               "f32" if dtype == torch.float32 else "narrow")
    assert tfa.mode(torch.zeros(1, 8, 2, d, dtype=dtype)) == want


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("case", ["cross", "ragged"])
def test_plain_k3_k4_narrow_heads_match_jax(case, d):
    """At head dims 32 and 64 (variant `test`'s DiTs, and what the card's
    narrow and f32 modes take), f32: the plain K3 / K4 against JAX's Pallas
    `flash_fwd_with_lse` / `flash_attention` and jax.grad of it in
    interpret mode, out, lse and the three gradients within 2e-5 relative
    L2 (measured ~4e-7: the same f32 arithmetic in another order)."""
    tol = 2e-5
    sq, sk, qs, ks = CASES[case]
    rng = np.random.default_rng(d + sq)
    q = rng.standard_normal((B, sq, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, sk, H, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)
    scale = d ** -0.5
    out, lse = tfa.flash_fwd_reference(*_t(q, k, v, qs, ks), scale)
    j_out = jfa.flash_attention(*_j(q, k, v), segment_ids=_j(qs)[0], kv_segment_ids=_j(ks)[0])
    assert _rel_err(out.numpy(), np.asarray(j_out)) < tol
    if qs is not None:
        _, j_lse = jfa.flash_fwd_with_lse(*_j(q, k, v, qs, ks), scale)
        valid = np.asarray(j_lse) > -1e29
        assert _rel_err(lse.numpy()[valid], np.asarray(j_lse)[valid]) < tol
    got = tfa.flash_bwd_reference(*_t(q, k, v, qs, ks), out, lse, torch.from_numpy(do), scale)
    want = _jax_grads(q, k, v, qs, ks, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g.numpy(), np.asarray(w)) < tol, name


@pytest.mark.parametrize("s", [2560, 2688, 4000])
def test_dispatch_follows_jax_on_one_chip(monkeypatch, s):
    """qk_norm_rope_attention routes "auto" and "int8" as JAX's TPU
    dispatch (qflux_tpu/ops/attention.py:112-121): the fused K1 (int8 mode
    where asked) wherever JAX's `supports` holds, else the norm + rope and
    K3's `flash_attention`, once per call; and both routes give the plain
    composition's numbers here."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, 1, D)).astype(np.float32))
               for _ in range(3))
    qs2, ks2 = (torch.from_numpy((1 + 0.1 * rng.standard_normal((2, D))).astype(np.float32))
                for _ in range(2))
    ang = rng.uniform(0, 6.28, (s, D // 2)).astype(np.float32)
    cos, sin = (torch.from_numpy(np.concatenate([f(ang)] * 2, -1)) for f in (np.cos, np.sin))
    seg = torch.ones(1, s, dtype=torch.int32)
    seg[0, 230:256] = 0
    calls = []
    nr, fa = tnr.flash_attention_nr, tfa.flash_attention
    monkeypatch.setattr(tnr, "flash_attention_nr",
                        lambda *a, **kw: calls.append(("K1", kw["s_int8"])) or nr(*a, **kw))
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **kw: calls.append(("K3", False)) or fa(*a, **kw))
    args = (q, k, v, qs2, ks2, cos, sin, 256)
    with torch.no_grad():
        outs = {impl: tattn.qk_norm_rope_attention(*args, segment_ids=seg, impl=impl)
                for impl in ("auto", "int8")}
    want = [("K1", s_int8) if jnr.supports(s, s, D, s_int8) else ("K3", False)
            for s_int8 in (False, True)]
    assert calls == want
    with torch.no_grad():
        plain = tattn.qk_norm_rope_attention(*args, segment_ids=seg, impl="plain")
    assert torch.equal(outs["auto"], plain)
    if not jnr.supports(s, s, D, True):
        assert torch.equal(outs["int8"], plain)


def test_dot_product_attention_impls():
    """`dot_product_attention`: "auto" is K3's `flash_attention` (its plain
    version on CPU tensors), "plain" `sdpa_reference`, the same numbers;
    "ring" without an active mesh whose sp axis is > 1 raises JAX's
    ValueError, and "stub" (JAX's planning stub) raises naming ROADMAP.md's
    "Do not port" list."""
    q, k, v = _t(*_qkv(7, 64))
    seg = torch.from_numpy(_seg(64, 40, 20))
    auto = tattn.dot_product_attention(q, k, v, segment_ids=seg)
    assert torch.equal(auto, tfa.flash_attention(q, k, v, segment_ids=seg))
    assert torch.equal(auto, tattn.dot_product_attention(q, k, v, segment_ids=seg, impl="plain"))
    with pytest.raises(ValueError, match="sp > 1"):
        tattn.dot_product_attention(q, k, v, impl="ring")
    with pytest.raises(NotImplementedError, match="ROADMAP.md's \"Do not port\""):
        tattn.dot_product_attention(q, k, v, impl="stub")
    with pytest.raises(ValueError):
        tattn.dot_product_attention(q, k, v, impl="pallas")


def test_cuda_entry_points_raise_instead_of_falling_back():
    """K3's and K4's launchers refuse tensors that are not on a CUDA device,
    and count nothing: there is no path from them to the plain versions."""
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(8, 64)))
    lse = torch.zeros(B, H, 64)
    before = (tfa.KERNEL_LAUNCHES, tfa.BWD_KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._flash_fwd_cuda(q, k, v, None, None, SCALE)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._flash_bwd_cuda(q, k, v, None, None, q, lse, q, SCALE)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._flash_fwd_op(q, k, v, None, None, SCALE)
    assert (tfa.KERNEL_LAUNCHES, tfa.BWD_KERNEL_LAUNCHES) == before


# ---------------------------------------------------------------------------
# the custom op under autograd and remat, with the launchers as test doubles

def _plain_flash_launchers(monkeypatch):
    """Test doubles: K3's and K4's launchers replaced by their plain versions,
    and `flash_attention` sending CPU tensors to the custom op instead of
    the plain version, so the op, its autograd formula and the checkpoint
    policies run here; the counts at 0, moving as the real launches
    would."""
    def fwd(q, k, v, q_seg, kv_seg, scale):
        with torch.no_grad():
            return tfa.flash_fwd_reference(q, k, v, q_seg, kv_seg, scale)

    def bwd(q, k, v, q_seg, kv_seg, out, lse, do, scale):
        g = tfa.flash_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
        return tuple(x.to(t.dtype) for x, t in zip(g, (q, k, v)))

    def dispatch(q, k, v, segment_ids=None, kv_segment_ids=None, scale=None):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        q_seg, kv_seg = tfa._segment_pair(q, segment_ids, kv_segment_ids)
        return tfa._flash_fwd_op(q, k, v, q_seg, kv_seg, float(scale))[0]

    monkeypatch.setattr(tfa, "_flash_fwd_cuda", fwd)
    monkeypatch.setattr(tfa, "_flash_bwd_cuda", bwd)
    monkeypatch.setattr(tfa, "flash_attention", dispatch)
    monkeypatch.setattr(tfa, "KERNEL_LAUNCHES", 0)
    monkeypatch.setattr(tfa, "BWD_KERNEL_LAUNCHES", 0)


def _remat(fn, remat):
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    ctx = functools.partial(tremat.contexts, tremat.POLICY_NAMES[remat],
                            offload=remat == "flash_offload")
    return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=ctx)


@pytest.mark.parametrize("remat", ["none", "full", "flash", "flash_offload"])
def test_custom_op_autograd_and_remat_policies(monkeypatch, remat):
    """The custom op `qflux::flash_fwd` with its registered autograd gives
    the plain gradients of q, k and v (the same under every policy); "flash"
    keeps its out / lse in the block's store and "flash_offload" parks them
    in host memory, and either replays them in the recompute, so a forward + backward launches K3 once
    (twice under "full") and K4 once, and the recompute re-runs the norm +
    rope before it (as JAX recomputes its XLA norm + rope)."""
    _plain_flash_launchers(monkeypatch)
    q, k, v = _t(*_qkv(9, 96))
    seg = torch.from_numpy(_seg(96, 70, 30))
    rng = np.random.default_rng(10)
    s2 = torch.from_numpy((1 + 0.1 * rng.standard_normal((2, D))).astype(np.float32))
    ang = rng.uniform(0, 6.28, (96, D // 2)).astype(np.float32)
    cos, sin = (torch.from_numpy(np.concatenate([f(ang)] * 2, -1)) for f in (np.cos, np.sin))
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    norms = []
    norm = tnr.apply_qk_norm_rope
    monkeypatch.setattr(tnr, "apply_qk_norm_rope", lambda *a: norms.append(1) or norm(*a))
    monkeypatch.setattr(tnr, "supports", lambda *a, **kw: False)  # the K3 route at S = 96
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def fn(*xs):
        o = tattn.qk_norm_rope_attention(*xs, s2, s2, cos, sin, 16, segment_ids=seg)
        return (o * do).sum()

    loss = _remat(fn, remat)(*leaves)
    assert (tfa.KERNEL_LAUNCHES, tfa.BWD_KERNEL_LAUNCHES, len(norms)) == (1, 0, 2)
    grads = torch.autograd.grad(loss, leaves)
    assert tfa.KERNEL_LAUNCHES == (2 if remat == "full" else 1)
    assert tfa.BWD_KERNEL_LAUNCHES == 1
    assert len(norms) == (2 if remat == "none" else 4)
    with torch.enable_grad():
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        qn, kn = (norm(x, s2, cos, sin, 16) for x in ref_leaves[:2])
        ref = torch.autograd.grad(
            (tfa.flash_fwd_reference(qn, kn, ref_leaves[2], seg, seg, SCALE)[0] * do).sum(),
            ref_leaves)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# a Qwen DiT with one 128-wide head through the K3 route, against JAX's TPU route

@pytest.fixture(scope="module")
def qwen_k3_reference():
    """JAX's tiny DiT (two blocks, one head of 128, f32) with its attention
    replaced, here, by its TPU route at this shape once `supports` is off:
    the XLA norm + rope, then the Pallas `flash_attention` (interpret mode).
    Returns the weights, the LoRA, the inputs, the forward's velocity and
    one train step's loss and LoRA gradients (MseLoss)."""
    calls = []

    def tpu_route(q, k, v, qs2, ks2, cos, sin, st, segment_ids=None, impl="auto"):
        calls.append(1)
        qn = jnr.apply_qk_norm_rope(q, qs2, cos, sin, st)
        kn = jnr.apply_qk_norm_rope(k, ks2, cos, sin, st)
        return jfa.flash_attention(qn, kn, v, segment_ids=segment_ids)

    mp = pytest.MonkeyPatch()
    mp.setattr(jqwen, "qk_norm_rope_attention", tpu_route)
    try:
        jp = _random_tree(lambda: jqwen.init(jax.random.PRNGKey(0), JCFG8, jnp.float32), 31)
        jl = _lora(jp, 32)
        raw = _batch(33, 2)
        noise, sigma = _noise_sigma(34, 2)
        jadapter = jqe.QwenImageEditAdapter(JCFG8, attn_impl="auto", remat=False)
        jbatch = jadapter.prepare_cached_embeddings(raw)
        j_v = jadapter.predict_velocity(jp, {k: jnp.asarray(v) for k, v in jbatch.items()},
                                        jnp.asarray(noise), jnp.asarray(sigma))
        j_loss, j_grads, _, _ = _jax_step(JCFG8, jp, jl, jbatch, noise, sigma,
                                          jlosses.MseLoss(), 1, 1e9, optax.sgd(0.0),
                                          adapter=jadapter)
    finally:
        mp.undo()
    assert calls  # JAX traced its blocks through the TPU route
    return jp, jl, raw, noise, sigma, np.asarray(j_v), float(j_loss), j_grads


@pytest.mark.parametrize("policy", ["full", "flash", "flash_offload"])
def test_qwen_dit_k3_route_matches_jax_tpu_route(monkeypatch, qwen_k3_reference, policy):
    """Two blocks, dim 128 = one head of 128, f32, at S = 8 + 2 · 16 = 40,
    with the port's `supports` off so that this S takes the K3 route (as S
    = 4000 does at full width), and the launchers as plain-math doubles so
    that the custom op, K4's formula and the remat policy run: the forward
    (2 K3) and one train step's loss and LoRA gradients (K3 once a block
    under "flash" / "flash_offload", twice under "full"; K4 once a block)
    match JAX's TPU route within 2e-5 (relative L2)."""
    tol = 2e-5
    jp, jl, raw, noise, sigma, j_v, j_loss, j_grads = qwen_k3_reference
    _plain_flash_launchers(monkeypatch)
    monkeypatch.setattr(tnr, "supports", lambda *a, **kw: False)
    k1 = tnr.KERNEL_LAUNCHES
    model = bridge.load_params(tqwen.QwenImageTransformer(TCFG8, dtype=torch.float32),
                               _np_tree(jp))
    tadapter = tqe.QwenImageEditAdapter(TCFG8, attn_impl="auto", remat_policy=policy)
    tbatch = {k: torch.as_tensor(np.asarray(v))
              for k, v in tadapter.prepare_cached_embeddings(raw).items()}
    with torch.inference_mode():
        t_v = tadapter.predict_velocity(model, tbatch, torch.from_numpy(noise),
                                        torch.from_numpy(sigma))
    assert (tfa.KERNEL_LAUNCHES, tfa.BWD_KERNEL_LAUNCHES) == (2, 0)
    assert _rel_err(t_v.numpy(), j_v) < tol
    loss, got = _port_lora_grads(model, jl, tadapter, tbatch, noise, sigma)
    n = TCFG8.num_layers
    assert (tfa.KERNEL_LAUNCHES - 2, tfa.BWD_KERNEL_LAUNCHES) == (
        (2 if policy == "full" else 1) * n, n)
    assert tnr.KERNEL_LAUNCHES == k1  # no K1 on this route
    assert loss == pytest.approx(j_loss, rel=tol)
    j_np = bridge.lora_to_numpy(bridge.lora_from_tree(model, _np_tree(j_grads)))
    last = n - 1
    for path, want in j_np.items():
        if path in (f"blocks/{last}/attn/add_q", f"blocks/{last}/attn/add_out"):
            continue  # no gradient reaches them, in either package
        for key in ("a", "b"):
            assert _rel_err(got[path][key], want[key]) < tol, (path, key)
    assert all(np.abs(got[f"blocks/0/attn/{p}"]["b"]).sum() > 0 for p in ("to_q", "to_k"))
