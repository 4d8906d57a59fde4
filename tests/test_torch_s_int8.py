"""The s_int8 mode of kernels K1 and K2 (`quantize.attention: true`: QK^T
as an int8 x int8 product with one scale per q tile and one per (b, h) for
K) in the port (qflux_tpu_torch/ops/flash_nr.py) against the JAX package,
on the CPU: the quantizer, the rule for where and over which tiles it
applies, the plain forward and straight-through backward against the
Pallas kernels in interpret mode, the dispatch, and a two-block Qwen DiT
with one 128-wide head against JAX's TPU dispatch.

Tolerances.  Given the same normed q / k the int8 operands, the scales and
the scores are identical to the bit (asserted).  End to end the two
packages' normed q / k differ by an f32 ulp in places (their norms sum in
other orders), and now and then such an element sits on a rounding
boundary of the quantizer and moves one int8 step: measured 1 of 2304 q
values at S = 2304, which puts the outputs and gradients 6e-5 apart
(relative L2; 6e-7 where no value flips).  TOL = 1e-3 allows a dozen such
flips, and is asserted to lie below a fifth of each gradient's distance to
the backward recomputed over the other q tiles (~1e-2: what a port that
reused the forward's tiles would give) and to the bf16 gradient (~1.4e-2).

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

from qflux_tpu.losses import losses as jlosses
from qflux_tpu.models.qwen import transformer as jqwen
from qflux_tpu.ops import flash_nr as jnr
from qflux_tpu.ops.flash_attention import BLOCK_Q_TARGET, _auto_block, _pad_len
from qflux_tpu.trainer import qwen_edit as jqe
from qflux_tpu_torch import losses as tlosses
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.qwen import transformer as tqwen
from qflux_tpu_torch.ops import attention as tattn
from qflux_tpu_torch.ops import flash_attention as tfa
from qflux_tpu_torch.ops import flash_nr as tnr
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.trainer import qwen_edit as tqe
from qflux_tpu_torch.trainer import train_step as tts
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err
from tests.test_torch_qwen import _lora, _np_tree
from tests.test_torch_qwen_train import _batch, _noise_sigma
from tests.test_torch_train import _jax_step

D = 128
ST = 256  # 256 text tokens, the last 26 padding, as the Qwen path at 512²
TOL = 1e-3


def _inputs(seed, s, d=D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, s, 1, d)).astype(np.float32) for _ in range(3))
    qs2, ks2 = ((1 + 0.1 * rng.standard_normal((2, d))).astype(np.float32) for _ in range(2))
    ang = rng.uniform(0, 6.28, (s, d // 2)).astype(np.float32)
    cos, sin = np.concatenate([np.cos(ang)] * 2, -1), np.concatenate([np.sin(ang)] * 2, -1)
    return q, k, v, qs2, ks2, cos, sin


def _dist(a, ref):
    """relative L2 distance of a from ref"""
    return np.linalg.norm(np.asarray(a, np.float64) - ref) / np.linalg.norm(np.asarray(ref))


def _text_tail(s):
    seg = np.ones((1, s), np.int32)
    seg[0, ST - 26:ST] = 0
    return seg


def _jax_tiles(s, d):
    """JAX's choice, through its own pickers (flash_attention_nr's lines)."""
    if not jnr.supports(s, s, d, s_int8=True):
        return None
    sk_pad = _auto_block(s, 1 << 30)
    block_q = min(_auto_block(s, BLOCK_Q_TARGET), jnr._nr_block_q(sk_pad, d, True))
    bq_fwd = min(_auto_block(s, BLOCK_Q_TARGET), jnr._nr_fwd_block_q(sk_pad, d, True))
    if bq_fwd < block_q or _pad_len(s, bq_fwd) != _pad_len(s, block_q):
        bq_fwd = block_q
    return bq_fwd, block_q


# ---------------------------------------------------------------------------
# (a) the quantizer

@pytest.mark.parametrize("kind", ["normal", "tiny", "zeros", "rows_of_300"])
def test_quant_tile_matches_jax(kind):
    """quant_tile against `_quant_tile` to the bit (int8 values and scale),
    an all-zero tile (scale 1e-6, all 0) and one whose amax is below
    127e-6 included; quant_rows against `_quant_tile` per tile, the last
    one ragged."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((256, D)) * 3).astype(np.float32)
    if kind == "tiny":
        x *= 1e-5
    elif kind == "zeros":
        x[:] = 0.0
    if kind != "rows_of_300":
        jq, js = jnr._quant_tile(jnp.asarray(x))
        tq, ts = tnr.quant_tile(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.item() == float(js)
        if kind == "zeros":
            assert ts.item() == np.float32(1e-6) and not tq.any()
        return
    x = (rng.standard_normal((1, 300, 2, D)) * np.array([1.0, 5.0])[:, None]).astype(np.float32)
    tq, ts = tnr.quant_rows(torch.from_numpy(x), 128)
    for h in range(2):
        for r0 in (0, 128, 256):
            jq, js = jnr._quant_tile(jnp.asarray(x[0, r0:r0 + 128, h]))
            np.testing.assert_array_equal(tq.numpy()[0, r0:r0 + 128, h], np.asarray(jq))
            assert np.all(ts.numpy()[0, r0:r0 + 128, h] == float(js))


# ---------------------------------------------------------------------------
# (b) where the int8 score GEMM applies, and over which q tiles

@pytest.mark.parametrize("s,d", [(s, D) for s in (128, 384, 1024, 2048, 2176, 2304, 2560,
                                                   2688, 4000)] + [(1024, 32), (2304, 256)])
def test_s_int8_tiles_match_jax_pickers(s, d):
    want = {2176: (128, 128), 2304: (256, 128), 2560: (256, 128), 2688: None, 4000: None}
    got = tnr.s_int8_tiles(s, d)
    assert got == _jax_tiles(s, d)
    if d == 32:
        assert got is None
    elif d == D and s in want:
        assert got == want[s]


# ---------------------------------------------------------------------------
# (c) forward and backward against the Pallas kernels in interpret mode

def _jax_out_lse(args, seg, fwd_rows):
    """The TPU forward kernel `_fwd_nr` (s_int8, interpret mode) on the
    unfolded layout: (out [1, S, 1, D], lse [1, 1, S])."""
    q, k, v, qs2, ks2, cos, sin = map(jnp.asarray, args)
    t4 = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    qseg = jnp.asarray(seg)[:, None, :]
    out, lse = jnr._fwd_nr(t4(q), t4(k), t4(v), qs2, ks2, cos[None], sin[None], qseg, qseg,
                           1.0 / D ** 0.5, fwd_rows, ST, s_int8=True, folded=False)
    return np.asarray(t4(out)), np.asarray(lse[:, :, 0])


@pytest.mark.parametrize("s", [1024, 2304])
def test_int8_fwd_bwd_match_jax_kernels(s):
    """At S = 1024 (q tiles 256 / 256) and S = 2304 (256 forward, 128
    backward), B = H = 1, a masked text tail: the int8 operands and scores
    from the same normed q / k are identical; out and lse match `_fwd_nr`;
    the five gradients match jax.vjp of `flash_attention_nr(s_int8=True)`
    within TOL, which is below a fifth of their distance to the backward
    over the other tile size and to the bf16 gradient."""
    args = _inputs(1, s)
    seg = _text_tail(s)
    do = np.random.default_rng(2).standard_normal((1, s, 1, D)).astype(np.float32)
    fwd_rows, bwd_rows = tnr.s_int8_tiles(s, D)
    assert (fwd_rows, bwd_rows) == {1024: (256, 256), 2304: (256, 128)}[s]
    scale = 1.0 / D ** 0.5

    # the same normed q / k → identical int8 operands, scales and scores
    q, k, _, qs2, ks2, cos, sin = args
    jqn, jkn = (np.asarray(jnr.apply_qk_norm_rope(*map(jnp.asarray, (x, s2, cos, sin)), ST))
                for x, s2 in ((q, qs2), (k, ks2)))
    jkq, jksc = jnr._quant_tile(jnp.asarray(jkn[0, :, 0]))
    tqq, tqsc = tnr.quant_rows(torch.from_numpy(jqn), fwd_rows)
    tkq, tksc = tnr.quant_rows(torch.from_numpy(jkn), s)
    np.testing.assert_array_equal(tkq.numpy()[0, :, 0], np.asarray(jkq))
    assert np.all(tksc.numpy() == float(jksc))
    t_s = tnr.int8_scores(tqq, tqsc, tkq, tksc, scale).numpy()[0, 0]
    for r0 in range(0, s, fwd_rows):
        jqq, jqsc = jnr._quant_tile(jnp.asarray(jqn[0, r0:r0 + fwd_rows, 0]))
        np.testing.assert_array_equal(tqq.numpy()[0, r0:r0 + fwd_rows, 0], np.asarray(jqq))
        j_s = jax.lax.dot_general(jqq, jkq, (((1,), (1,)), ((), ())),
                                  preferred_element_type=jnp.int32
                                  ).astype(jnp.float32) * (jqsc * jksc * scale)
        np.testing.assert_array_equal(t_s[r0:r0 + fwd_rows], np.asarray(j_s))

    # forward: the plain version against the TPU kernel
    t_args = [torch.from_numpy(a) for a in args]
    t_seg = torch.from_numpy(seg)
    out, lse = tnr.flash_attention_nr_int8_reference(*t_args, ST, fwd_rows, segment_ids=t_seg)
    j_out, j_lse = _jax_out_lse(args, seg, fwd_rows)
    assert _rel_err(out.numpy(), j_out) < TOL
    valid = lse.numpy() > -1e29
    assert np.array_equal(valid, j_lse > -1e29)
    assert _rel_err(lse.numpy()[valid], j_lse[valid]) < TOL
    assert not out.numpy()[0, ST - 26:ST].any()

    # backward: through the public entry point (the autograd.Function)
    def jfn(*xs):
        return jnr.flash_attention_nr(*xs, jnp.asarray(cos), jnp.asarray(sin), ST,
                                      segment_ids=jnp.asarray(seg), s_int8=True)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, args[:5]))
    j_grads = vjp(jnp.asarray(do))
    leaves = [t.clone().requires_grad_() for t in t_args[:5]]
    t_out, _ = tnr.flash_attention_nr(*leaves, t_args[5], t_args[6], ST, segment_ids=t_seg,
                                      s_int8=True)
    assert torch.equal(t_out, out)
    t_grads = torch.autograd.grad(t_out, leaves, torch.from_numpy(do))
    other = tnr.flash_attention_nr_int8_bwd_reference(
        *t_args, ST, torch.from_numpy(do), out, lse, 384 - bwd_rows, segment_ids=t_seg)
    bf16 = tnr.flash_attention_nr_bwd_reference(*t_args, ST, torch.from_numpy(do),
                                                segment_ids=t_seg)
    for name, t, j, o, b in zip(("dq", "dk", "dv", "dqs", "dks"), t_grads, j_grads, other,
                                bf16):
        err = _rel_err(t.numpy(), j)
        assert err < TOL, (name, err)
        assert 5 * TOL < _dist(o.numpy(), j), (name, "other tiles")
        assert 5 * TOL < _dist(b.numpy(), j), (name, "bf16")
        assert t[0, ST - 26:ST].abs().sum() == 0 if name in ("dq", "dk", "dv") else True


# ---------------------------------------------------------------------------
# (d) the dispatch

@pytest.mark.parametrize("s,d", [(2560, D), (2688, D), (1024, 32)])
def test_dispatch_int8_where_jax_applies_it(s, d):
    """qk_norm_rope_attention(impl="int8"): the s_int8 result where
    s_int8_tiles applies (S ≤ 2560 at head dim 128; here with its own q
    tiles, 256 forward); elsewhere (S = 2688, d = 32) the bf16 route JAX's
    TPU dispatch takes there, the plain norm + rope and then K3
    (`flash_attention`, whose plain version runs on CPU tensors), to the
    bit, and on the CPU equal to "auto" (K1's plain version at S = 2688:
    the same math).  Its q / k gradients are the straight-through ones:
    nonzero, and the plain backward's."""
    args = [torch.from_numpy(a) for a in _inputs(4, s, d)]
    leaves = [t.clone().requires_grad_() for t in args[:5]]
    got = tattn.qk_norm_rope_attention(*leaves, args[5], args[6], 64, impl="int8")
    auto = tattn.qk_norm_rope_attention(*args, 64, impl="auto")
    tiles = tnr.s_int8_tiles(s, d)
    if s > 2560 or d != D:
        k3 = tfa.flash_attention(tnr.apply_qk_norm_rope(args[0], args[3], args[5], args[6], 64),
                                 tnr.apply_qk_norm_rope(args[1], args[4], args[5], args[6], 64),
                                 args[2])
        assert tiles is None and torch.equal(got, k3) and torch.equal(got, auto)
        return
    assert tiles == (256, 128)
    want, lse = tnr.flash_attention_nr_int8_reference(*args, 64, 256)
    assert torch.equal(got, want) and not torch.equal(got, auto)
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(got.shape).astype(np.float32))
    grads = torch.autograd.grad(got, leaves, do)
    ref = tnr.flash_attention_nr_int8_bwd_reference(*args, 64, do, want, lse, 128)
    for g, r in zip(grads, ref):
        assert g.abs().sum() > 0
        torch.testing.assert_close(g, r, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (e) a Qwen DiT with one 128-wide head, against JAX's TPU dispatch

JCFG8 = dataclasses.replace(jqwen.QwenImageConfig.tiny(), attention_head_dim=D,
                            num_attention_heads=1, axes_dims_rope=(16, 56, 56))
TCFG8 = dataclasses.replace(tqwen.QwenImageConfig.tiny(), attention_head_dim=D,
                            num_attention_heads=1, axes_dims_rope=(16, 56, 56))


def _port_lora_grads(model, jl, adapter, batch, noise, sigma):
    """One microbatch's loss and LoRA a / b gradients through the port,
    zeros where the loss does not reach (as the train step fills them)."""
    lora = tlayers.mark_trainable(bridge.lora_from_tree(model, _np_tree(jl)))
    loss = tts._loss_for_microbatch(model, lora, batch, torch.from_numpy(noise),
                                    torch.from_numpy(sigma), adapter.predict_velocity,
                                    tlosses.MseLoss(), tts.TrainStepConfig())
    loss.backward()
    for leaf in lora.values():
        for t in leaf.values():
            if t.grad is None:
                t.grad = torch.zeros_like(t)
    return float(loss), bridge.lora_to_numpy(lora, grads=True)


def test_qwen_dit_int8_matches_jax_tpu_dispatch(monkeypatch):
    """Two blocks, dim 128 = one head of 128, f32, at S = 8 + 2 · 16 = 40:
    the port with attn_impl="int8" against JAX with its attention replaced,
    in this test, by JAX's TPU dispatch (`flash_attention_nr(s_int8=True)`
    where `supports` holds; on the CPU JAX always degrades to bf16).  The
    DiT forward, and one train step's loss and LoRA gradients (MseLoss),
    within 2e-5 (relative L2, the f32 bound of tests/test_torch_qwen.py;
    measured 2.3e-6: no q / k value of this input moves an int8 step);
    both sides ran the int8 path in every block.  The port's bf16 path
    ("auto") gives gradients at least 2e-3 from JAX's int8 ones, so the
    bound tells the two apart."""
    tol = 2e-5
    calls = {"jax": 0, "port": 0}
    orig = jqwen.qk_norm_rope_attention

    def tpu_dispatch(q, k, v, qs2, ks2, cos, sin, st, segment_ids=None, impl="auto"):
        if impl == "int8" and jnr.supports(q.shape[1], k.shape[1], q.shape[-1], s_int8=True):
            calls["jax"] += 1
            return jnr.flash_attention_nr(q, k, v, qs2, ks2, cos, sin, st,
                                          segment_ids=segment_ids, s_int8=True)
        return orig(q, k, v, qs2, ks2, cos, sin, st, segment_ids=segment_ids, impl=impl)

    monkeypatch.setattr(jqwen, "qk_norm_rope_attention", tpu_dispatch)
    t_ref = tnr.flash_attention_nr_int8_reference

    def counted(*a, **k):
        calls["port"] += 1
        return t_ref(*a, **k)

    monkeypatch.setattr(tnr, "flash_attention_nr_int8_reference", counted)

    jp = _random_tree(lambda: jqwen.init(jax.random.PRNGKey(0), JCFG8, jnp.float32), 21)
    model = bridge.load_params(tqwen.QwenImageTransformer(TCFG8, dtype=torch.float32),
                               _np_tree(jp))
    jl = _lora(jp, 22)
    raw = _batch(23, 2)
    noise, sigma = _noise_sigma(24, 2)
    jadapter = jqe.QwenImageEditAdapter(JCFG8, attn_impl="int8", remat=False)
    tadapter = tqe.QwenImageEditAdapter(TCFG8, attn_impl="int8", remat_policy="flash")
    jbatch = jadapter.prepare_cached_embeddings(raw)
    tbatch = {k: torch.as_tensor(np.asarray(v))
              for k, v in tadapter.prepare_cached_embeddings(raw).items()}

    # the forward
    j_v = jadapter.predict_velocity(jp, {k: jnp.asarray(v) for k, v in jbatch.items()},
                                    jnp.asarray(noise), jnp.asarray(sigma))
    with torch.inference_mode():
        t_v = tadapter.predict_velocity(model, tbatch, torch.from_numpy(noise),
                                        torch.from_numpy(sigma))
    assert calls["jax"] >= 1 and calls["port"] == 2  # JAX traces its scan over blocks once
    assert _rel_err(t_v.numpy(), np.asarray(j_v)) < tol

    # one train step's loss and LoRA gradients
    j_loss, j_grads, _, _ = _jax_step(JCFG8, jp, jl, jbatch, noise, sigma, jlosses.MseLoss(), 1,
                                      1e9, optax.sgd(0.0), adapter=jadapter)
    loss, got = _port_lora_grads(model, jl, tadapter, tbatch, noise, sigma)
    assert calls["jax"] >= 2 and calls["port"] >= 4
    assert loss == pytest.approx(j_loss, rel=tol)
    _, bf16 = _port_lora_grads(model, jl, dataclasses.replace(tadapter, attn_impl="auto"),
                               tbatch, noise, sigma)
    j_np = bridge.lora_to_numpy(bridge.lora_from_tree(model, _np_tree(j_grads)))
    last = TCFG8.num_layers - 1
    for path, want in j_np.items():
        if path in (f"blocks/{last}/attn/add_q", f"blocks/{last}/attn/add_out"):
            continue  # no gradient reaches them, in either package
        for key in ("a", "b"):
            assert _rel_err(got[path][key], want[key]) < tol, (path, key)
            assert _rel_err(bf16[path][key], want[key]) > 50 * tol, (path, key)
    # the straight-through gradient reaches q and k: their LoRA b moved
    assert all(np.abs(got[f"blocks/0/attn/{p}"]["b"]).sum() > 0 for p in ("to_q", "to_k"))


# ---------------------------------------------------------------------------
# the custom op's s_int8 wiring, with the launchers as test doubles

def _plain_int8_launchers(monkeypatch):
    """The launchers as plain-math doubles (tests/test_torch_flash_nr.py:
    _plain_launchers, which takes the s_int8 mode too), the counts at 0."""
    from tests.test_torch_flash_nr import _plain_launchers

    _plain_launchers(monkeypatch)
    for name in ("KERNEL_LAUNCHES", "BWD_KERNEL_LAUNCHES", "INT8_KERNEL_LAUNCHES",
                 "INT8_BWD_KERNEL_LAUNCHES"):
        monkeypatch.setattr(tnr, name, 0)


def _counts():
    return (tnr.KERNEL_LAUNCHES, tnr.BWD_KERNEL_LAUNCHES, tnr.INT8_KERNEL_LAUNCHES,
            tnr.INT8_BWD_KERNEL_LAUNCHES)


@pytest.mark.parametrize("remat", ["none", "full", "flash", "flash_offload"])
def test_custom_op_int8_mode_autograd_and_policies(monkeypatch, remat):
    """The custom op with (fwd_rows, bwd_rows) set: its autograd formula
    gives the plain straight-through gradients of q, k, v and both scale
    pairs (the backward over its own q tiles); "flash" keeps its out / lse
    in the block's store (ops/remat.py) and "flash_offload" parks them in
    host memory, and either replays them, so K1's s_int8 mode launches once
    (twice under "full") and K2's once; the bf16 modes never."""
    from torch.utils.checkpoint import checkpoint

    from qflux_tpu_torch.ops import remat as tremat

    _plain_int8_launchers(monkeypatch)
    s = 384  # q tiles 256 / 256, the last one ragged
    q, k, v, qs2, ks2, cos, sin = (torch.from_numpy(a) for a in _inputs(30, s))
    do = torch.from_numpy(np.random.default_rng(31).standard_normal(q.shape).astype(np.float32))
    seg = torch.from_numpy(_text_tail(s))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, qs2, ks2)]

    def fn(*xs):
        return (tnr.flash_attention_nr(*xs, cos, sin, ST, segment_ids=seg, s_int8=True)[0]
                * do).sum()

    if remat == "none":
        loss = fn(*leaves)
    elif remat == "full":
        loss = checkpoint(fn, *leaves, use_reentrant=False)
    else:
        ctx = functools.partial(tremat.contexts, tremat.POLICY_NAMES[remat],
                                offload=remat == "flash_offload")
        loss = checkpoint(fn, *leaves, use_reentrant=False, context_fn=ctx)
    assert _counts() == (0, 0, 1, 0)
    grads = torch.autograd.grad(loss, leaves)
    assert _counts() == (0, 0, 2 if remat == "full" else 1, 1)
    out, lse = tnr.flash_attention_nr_int8_reference(q, k, v, qs2, ks2, cos, sin, ST, 256,
                                                     segment_ids=seg)
    ref = tnr.flash_attention_nr_int8_bwd_reference(q, k, v, qs2, ks2, cos, sin, ST, do, out,
                                                    lse, 256, segment_ids=seg)
    for g, r in zip(grads, ref):
        assert g.abs().sum() > 0
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6, rtol=1e-6)


def test_int8_launchers_refuse_cpu_tensors():
    """The s_int8 launchers refuse CPU tensors and count nothing: there is
    no path from them to the plain version."""
    q, k, v, qs2, ks2, cos, sin = (torch.from_numpy(a) for a in _inputs(32, 64))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    before = _counts()
    with pytest.raises(ValueError, match="CUDA"):
        tnr._flash_nr_cuda(q, k, v, qs2, ks2, cos, sin, 8, None, D ** -0.5, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tnr._flash_nr_bwd_cuda(q, k, v, qs2, ks2, cos, sin, 8, None, D ** -0.5, q,
                               torch.zeros(1, 1, 64), q, 128)
    assert _counts() == before


@pytest.mark.parametrize("policy,k1_per_step", [("flash", 1), ("full", 2), ("flash_offload", 1)])
def test_qwen_int8_launch_counts_per_step(monkeypatch, policy, k1_per_step):
    """The two-block, one-head Qwen DiT with attn_impl="int8" under each
    remat policy, the launchers as doubles: per step K1's s_int8 mode once
    a block ("flash", "flash_offload") or twice ("full"), K2's once a
    block, the bf16 modes never; the LoRA gradients equal those without
    the doubles (the CPU path, `_Int8Attention`) to the bit."""
    jp = _random_tree(lambda: jqwen.init(jax.random.PRNGKey(0), JCFG8, jnp.float32), 33)
    model = bridge.load_params(tqwen.QwenImageTransformer(TCFG8, dtype=torch.float32),
                               _np_tree(jp))
    jl = _lora(jp, 34)
    raw = _batch(35, 2)
    noise, sigma = _noise_sigma(36, 2)
    adapter = tqe.QwenImageEditAdapter(TCFG8, attn_impl="int8", remat_policy=policy)
    batch = {k: torch.as_tensor(np.asarray(v))
             for k, v in adapter.prepare_cached_embeddings(raw).items()}
    _, want = _port_lora_grads(model, jl, adapter, batch, noise, sigma)
    _plain_int8_launchers(monkeypatch)
    _, got = _port_lora_grads(model, jl, adapter, batch, noise, sigma)
    n = TCFG8.num_layers
    assert _counts() == (0, 0, k1_per_step * n, n)
    for path, w in want.items():
        for key in ("a", "b", "scaling"):
            np.testing.assert_array_equal(got[path][key], w[key], err_msg=f"{path}/{key}")
