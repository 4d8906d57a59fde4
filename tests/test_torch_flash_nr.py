"""Kernels K1 and K2 of the port (qflux_tpu_torch/ops/flash_nr.py): their
plain PyTorch versions against the JAX package's `flash_attention_nr` and
its gradients, run as tests/ops/test_flash_nr.py runs them on the CPU (the
Pallas kernels in interpret mode); the custom op's autograd wiring; and the
wrappers' refusals.

Shapes and tolerances are those of tests/ops/test_flash_nr.py: B=2, S=256,
H=2, D=128, the txt/img boundary at 96, float32; atol 3e-5 on the forward
(the two sides differ only in the order of the f32 softmax sums) and
atol = rtol = 2e-3 on the gradients (the JAX backward kernel runs its own
f32 chain, tiled and in another order, against autograd of the plain
composition here).

The CUDA kernels cannot run here; tests/test_torch_card.py holds them
against the plain versions where a card is present.
"""

import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu.ops import attention as jattn
from qflux_tpu.ops import flash_nr as jnr
from qflux_tpu_torch.ops import attention as tattn
from qflux_tpu_torch.ops import flash_nr as tnr
from qflux_tpu_torch.runtime import build

B, S, H, D = 2, 256, 2, 128
ST = 96
ATOL = 3e-5
GRAD_TOL = 2e-3
REPO = Path(__file__).resolve().parent.parent


def _inputs(seed, s=S, b=B, h=H, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, D)).astype(dtype) for _ in range(3))
    qs2 = (1 + 0.1 * rng.standard_normal((2, D))).astype(dtype)
    ks2 = (1 + 0.1 * rng.standard_normal((2, D))).astype(dtype)
    ang = rng.uniform(0, 6.28, (s, D // 2)).astype(np.float32)
    cos = np.concatenate([np.cos(ang)] * 2, -1)
    sin = np.concatenate([np.sin(ang)] * 2, -1)
    return q, k, v, qs2, ks2, cos, sin


def _jax_lse(q, k, qs2, ks2, cos, sin, st, seg):
    """logsumexp of the scaled, masked logits, from the JAX composition."""
    qn = jnr.apply_qk_norm_rope(jnp.asarray(q), jnp.asarray(qs2), jnp.asarray(cos),
                                jnp.asarray(sin), st)
    kn = jnr.apply_qk_norm_rope(jnp.asarray(k), jnp.asarray(ks2), jnp.asarray(cos),
                                jnp.asarray(sin), st)
    logits = jnp.einsum("bqhd,bkhd->bhqk", qn, kn) / np.sqrt(D)
    if seg is not None:
        logits = jnp.where(jattn.segment_mask(jnp.asarray(seg), jnp.asarray(seg)),
                           logits, jattn.NEG_INF)
    return np.asarray(jax.nn.logsumexp(logits, axis=-1))


def _segments(kind, s):
    if kind is None:
        return None
    seg = np.ones((B, s), np.int32)
    seg[0, 230:] = 0      # sample 0 padded from token 230
    seg[1, ST:] = 2       # sample 1: two segments
    return seg


@pytest.mark.parametrize("s,seg_kind", [(S, None), (S, "masked"), (300, None)],
                         ids=["unmasked", "masked", "s300_unaligned"])
def test_plain_k1_matches_jax_flash_nr(s, seg_kind):
    q, k, v, qs2, ks2, cos, sin = _inputs({None: 0, "masked": 1}.get(seg_kind, 3), s=s)
    seg = _segments(seg_kind, s)
    j_out = jnr.flash_attention_nr(*map(jnp.asarray, (q, k, v, qs2, ks2, cos, sin)), ST,
                                   segment_ids=None if seg is None else jnp.asarray(seg))
    t_args = [torch.from_numpy(a) for a in (q, k, v, qs2, ks2, cos, sin)]
    t_seg = None if seg is None else torch.from_numpy(seg)
    out, lse = tnr.flash_attention_nr_reference(*t_args, ST, segment_ids=t_seg)
    assert out.shape == (B, s, H, D) and lse.shape == (B, H, s)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL)
    j_lse = _jax_lse(q, k, qs2, ks2, cos, sin, ST, seg)
    valid = j_lse > -1e29
    np.testing.assert_allclose(lse.numpy()[valid], j_lse[valid], atol=ATOL, rtol=1e-6)
    if seg is not None:
        assert np.all(out.numpy()[0, 230:] == 0.0)        # padded rows output 0
        assert np.all(lse.numpy()[0, :, 230:] <= -1e29)   # and carry lse = NEG_INF
    # the public entry point takes the plain version for CPU tensors
    out2, lse2 = tnr.flash_attention_nr(*t_args, ST, segment_ids=t_seg)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_plain_k2_matches_jax_flash_nr_grads(masked):
    """flash_attention_nr_bwd_reference against jax.grad of the JAX
    `flash_attention_nr` (its `_bwd_nr` Pallas kernel in interpret mode):
    dq, dk, dv and both scale-pair gradients.  The masked case pads sample 0
    from row 239 and gives those rows a nonzero cotangent: their gradients
    must still be 0."""
    q, k, v, qs2, ks2, cos, sin = _inputs(2)
    do = np.random.default_rng(12).standard_normal((B, S, H, D)).astype(np.float32)
    seg = None
    if masked:
        seg = np.ones((B, S), np.int32)
        seg[0, 239:] = 0

    def loss(q_, k_, v_, a_, b_):
        out = jnr.flash_attention_nr(q_, k_, v_, a_, b_, jnp.asarray(cos), jnp.asarray(sin), ST,
                                     segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(out * jnp.asarray(do))

    j_grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (q, k, v, qs2, ks2)))
    t_grads = tnr.flash_attention_nr_bwd_reference(
        *[torch.from_numpy(a) for a in (q, k, v, qs2, ks2, cos, sin)], ST, torch.from_numpy(do),
        segment_ids=None if seg is None else torch.from_numpy(seg))
    for t, j, name in zip(t_grads, j_grads, ("dq", "dk", "dv", "dqs", "dks")):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    if masked:
        for t in t_grads[:3]:
            assert not t[0, 239:].any()


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_plain_k1_k2_f32_relative_error_vs_jax(masked):
    """What the card's f32 K1 / K2 are held to, held to JAX here: the plain
    versions against JAX's `flash_attention_nr` and jax.grad of it (the
    Pallas kernels in interpret mode), f32, out and every gradient within
    2e-5 relative L2 (measured ~4e-7)."""
    tol = 2e-5
    q, k, v, qs2, ks2, cos, sin = _inputs(20)
    do = np.random.default_rng(21).standard_normal((B, S, H, D)).astype(np.float32)
    seg = _segments("masked" if masked else None, S)
    j_seg = None if seg is None else jnp.asarray(seg)
    t_seg = None if seg is None else torch.from_numpy(seg)

    def jfn(*xs):
        return jnr.flash_attention_nr(*xs, jnp.asarray(cos), jnp.asarray(sin), ST,
                                      segment_ids=j_seg)

    j_out, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v, qs2, ks2)))
    t_args = [torch.from_numpy(a) for a in (q, k, v, qs2, ks2, cos, sin)]
    out, _ = tnr.flash_attention_nr_reference(*t_args, ST, segment_ids=t_seg)
    assert _rel(out.numpy(), np.asarray(j_out)) < tol
    t_grads = tnr.flash_attention_nr_bwd_reference(*t_args, ST, torch.from_numpy(do),
                                                   segment_ids=t_seg)
    for name, t, j in zip(("dq", "dk", "dv", "dqs", "dks"), t_grads, vjp(jnp.asarray(do))):
        assert _rel(t.numpy(), np.asarray(j)) < tol, name


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _plain_launchers(monkeypatch):
    """Test doubles: the two low-level launchers replaced by plain math (the
    s_int8 mode's where q_rows is set), the dispatch sending CPU tensors to
    the custom op instead of the plain version, so the op, its autograd
    formula and the checkpoint policy run here, and `supports` widened to
    every self-attention shape, so that the tiny models (head dim 32) take
    K1's route as JAX on a TPU takes it at FLUX's 512² shape.  Returns
    nothing; the counts move as the real launches would."""
    def fwd(q, k, v, qs, ks, cos, sin, st, seg, scale, q_rows=0):
        with torch.no_grad():
            if q_rows:
                return tnr.flash_attention_nr_int8_reference(q, k, v, qs, ks, cos, sin, st,
                                                             q_rows, seg, scale)
            return tnr.flash_attention_nr_reference(q, k, v, qs, ks, cos, sin, st, seg, scale)

    def bwd(q, k, v, qs, ks, cos, sin, st, seg, scale, out, lse, do, q_rows=0):
        if q_rows:
            g = tnr.flash_attention_nr_int8_bwd_reference(q, k, v, qs, ks, cos, sin, st, do, out,
                                                          lse, q_rows, seg, scale)
        else:
            g = tnr.flash_attention_nr_bwd_reference(q, k, v, qs, ks, cos, sin, st, do, seg,
                                                     scale)
        return tuple(x.to(q.dtype) for x in g[:3]) + tuple(g[3:])

    monkeypatch.setattr(tnr, "_flash_nr_cuda", fwd)
    monkeypatch.setattr(tnr, "_flash_nr_bwd_cuda", bwd)

    def dispatch(q, k, v, q_scale2, k_scale2, cos, sin, st, segment_ids=None, scale=None,
                 s_int8=False):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        tiles = tnr.s_int8_tiles(q.shape[1], q.shape[-1]) if s_int8 else None
        return tnr._flash_attention_nr_op(q, k, v, q_scale2, k_scale2, cos, sin, st,
                                          segment_ids, scale, tiles or (0, 0))

    monkeypatch.setattr(tnr, "flash_attention_nr", dispatch)
    monkeypatch.setattr(tnr, "supports", lambda sq, sk, d, s_int8=False: sq == sk)


@pytest.mark.parametrize("remat", ["none", "full", "flash"])
def test_custom_op_autograd_and_checkpoint_policy(monkeypatch, remat):
    """The custom op `qflux::flash_nr_fwd` with its registered autograd gives
    the plain gradients of q, k, v and both scale pairs; under the "flash"
    policy its out / lse are kept in the block's store (ops/remat.py) and
    replayed in the recompute, so a forward + backward launches K1 once
    (twice under "full") and K2 once."""
    from torch.utils.checkpoint import checkpoint

    from qflux_tpu_torch.ops import remat as tremat

    _plain_launchers(monkeypatch)
    q, k, v, qs2, ks2, cos, sin = (torch.from_numpy(a) for a in _inputs(13, s=64))
    do = torch.from_numpy(np.random.default_rng(14).standard_normal((B, 64, H, D))
                          .astype(np.float32))
    seg = torch.from_numpy(_segments("masked", 64))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, qs2, ks2)]

    def fn(*xs):
        return (tnr.flash_attention_nr(*xs, cos, sin, 16, segment_ids=seg)[0] * do).sum()

    monkeypatch.setattr(tnr, "KERNEL_LAUNCHES", 0)
    monkeypatch.setattr(tnr, "BWD_KERNEL_LAUNCHES", 0)
    if remat == "none":
        loss = fn(*leaves)
    elif remat == "full":
        loss = checkpoint(fn, *leaves, use_reentrant=False)
    else:
        ctx = functools.partial(tremat.contexts, tremat.POLICY_NAMES["flash"])
        loss = checkpoint(fn, *leaves, use_reentrant=False, context_fn=ctx)
    assert tnr.KERNEL_LAUNCHES == 1 and tnr.BWD_KERNEL_LAUNCHES == 0
    grads = torch.autograd.grad(loss, leaves)
    assert tnr.KERNEL_LAUNCHES == (2 if remat == "full" else 1)
    assert tnr.BWD_KERNEL_LAUNCHES == 1
    ref = tnr.flash_attention_nr_bwd_reference(q, k, v, qs2, ks2, cos, sin, 16, do,
                                               segment_ids=seg)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=1e-5)


def test_apply_qk_norm_rope_bf16_matches_jax():
    """bf16 inputs: the two intermediate bf16 rounds (after the norm scale and
    after rope) sit where JAX puts them, so the outputs agree to one bf16 ulp
    at the largest |y| (~4 here), i.e. 2^-8 · 4."""
    q, _, _, qs2, _, cos, sin = _inputs(5)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    j = jnr.apply_qk_norm_rope(jq, jnp.asarray(qs2).astype(jnp.bfloat16),
                               jnp.asarray(cos), jnp.asarray(sin), ST)
    t = tnr.apply_qk_norm_rope(torch.from_numpy(q).to(torch.bfloat16),
                               torch.from_numpy(qs2).to(torch.bfloat16),
                               torch.from_numpy(cos), torch.from_numpy(sin), ST)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j.astype(jnp.float32)),
                               atol=2 ** -8 * 4, rtol=0)


@pytest.mark.parametrize("st", [0, ST])
def test_dispatch_auto_and_plain_agree_on_cpu(st):
    """qk_norm_rope_attention: impl="auto" (K1's entry point) and "plain"
    (the composition) compute the same thing on CPU tensors, and match the
    JAX dispatcher."""
    q, k, v, qs2, ks2, cos, sin = _inputs(6)
    seg = _segments("masked", S)
    t_args = [torch.from_numpy(a) for a in (q, k, v, qs2, ks2, cos, sin)]
    auto = tattn.qk_norm_rope_attention(*t_args, st, segment_ids=torch.from_numpy(seg))
    plain = tattn.qk_norm_rope_attention(*t_args, st, segment_ids=torch.from_numpy(seg),
                                         impl="plain")
    assert torch.equal(auto, plain)
    j = jattn.qk_norm_rope_attention(*map(jnp.asarray, (q, k, v, qs2, ks2, cos, sin)), st,
                                     segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(auto.numpy(), np.asarray(j), atol=ATOL)


def test_sdpa_reference_matches_jax():
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((B, 40, H, 16)).astype(np.float32) for _ in range(3))
    seg = np.ones((B, 40), np.int32)
    seg[0, 30:] = 0
    seg[1, 10:] = 3
    for s in (None, seg):
        j = jattn.sdpa_reference(*map(jnp.asarray, (q, k, v)),
                                 segment_ids=None if s is None else jnp.asarray(s))
        t = tattn.sdpa_reference(*map(torch.from_numpy, (q, k, v)),
                                 segment_ids=None if s is None else torch.from_numpy(s))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


# ---------------------------------------------------------------------------
# what is not ported raises; nothing falls back

def test_unported_modes_raise():
    """ring raises JAX's ValueError without an active mesh whose sp axis is
    > 1 (tests/test_torch_parallel.py runs it with one), stub raises naming
    ROADMAP.md's "Do not port" list; int8 (the s_int8 mode) now runs, and
    its output is the s_int8 entry point's."""
    t_args = [torch.from_numpy(a) for a in _inputs(8, s=16)]
    out, _ = tnr.flash_attention_nr(*t_args, 4, s_int8=True)
    assert torch.equal(tattn.qk_norm_rope_attention(*t_args, 4, impl="int8"), out)
    with pytest.raises(ValueError, match="sp > 1"):
        tattn.qk_norm_rope_attention(*t_args, 4, impl="ring")
    with pytest.raises(NotImplementedError, match="ROADMAP.md's \"Do not port\""):
        tattn.qk_norm_rope_attention(*t_args, 4, impl="stub")
    with pytest.raises(ValueError):
        tattn.qk_norm_rope_attention(*t_args, 4, impl="pallas")


def test_cuda_entry_point_raises_instead_of_falling_back():
    """The kernel's launcher refuses a tensor that is not on a CUDA device:
    there is no path from it to the plain version."""
    q, k, v, qs2, ks2, cos, sin = (torch.from_numpy(a) for a in _inputs(9, s=64))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    before = tnr.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tnr._flash_nr_cuda(q, k, v, qs2, ks2, cos, sin, 8, None, D ** -0.5)
    assert tnr.KERNEL_LAUNCHES == before


def test_bwd_entry_point_raises_instead_of_falling_back():
    """K2's launcher refuses CPU tensors too, and counts nothing."""
    q, k, v, qs2, ks2, cos, sin = (torch.from_numpy(a) for a in _inputs(15, s=64))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    lse = torch.zeros(B, H, 64)
    before = tnr.BWD_KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tnr._flash_nr_bwd_cuda(q, k, v, qs2, ks2, cos, sin, 8, None, D ** -0.5, q, lse, q)
    assert tnr.BWD_KERNEL_LAUNCHES == before


def test_c_signatures_match_sources():
    """Every C entry point of runtime/build.py's table exists in csrc/ with
    as many parameters as the ctypes signature declares (ctypes cannot check
    this, and a missing argument would be read as garbage on the card)."""
    sources = "".join(p.read_text() for p in sorted(build.CSRC.glob("*.cu")))
    for name, (_, argtypes) in build._SIGNATURES.items():
        m = re.search(r'extern "C" [^(]*\b' + name + r"\(([^)]*)\)", sources)
        assert m, f"{name} is not defined in csrc/"
        params = [a for a in m.group(1).split(",") if a.strip()]
        assert len(params) == len(argtypes), name


def test_kernel_arg_checks():
    """What the kernels (csrc/flash_nr_fwd.cu, csrc/flash_simt.cu) do not take is
    refused before a launch."""
    q, k, v, qs2, ks2, cos, sin = (torch.from_numpy(a) for a in _inputs(10, s=64))
    bq, bk, bv = (x.to(torch.bfloat16) for x in (q, k, v))
    qs, ks, stride, seg = tnr._kernel_args(bq, bk, bv, qs2, ks2, cos, sin, None)
    assert stride == 0 and seg is None and qs.dtype == torch.float32
    _, _, stride, seg = tnr._kernel_args(bq, bk, bv, qs2, ks2, cos[None].expand(B, -1, -1)
                                         .contiguous(), sin[None].expand(B, -1, -1)
                                         .contiguous(), torch.ones(B, 64, dtype=torch.int64))
    assert stride == 64 * D and seg.dtype == torch.int32
    bad = [
        ((q.half(), k.half(), v.half(), qs2, ks2, cos, sin, None), "bfloat16"),  # f16 q/k/v
        ((bq[..., :64], bk[..., :64], bv[..., :64], qs2[:, :64], ks2[:, :64],
          cos[:, :64], sin[:, :64], None), "head dim"),                    # D = 64
        ((bq, bk[:, :32], bv[:, :32], qs2, ks2, cos, sin, None), "sk"),    # cross attention
        ((bq.transpose(1, 2).contiguous().transpose(1, 2), bk, bv, qs2, ks2, cos, sin, None),
         "contiguous"),
        ((bq, bk, bv, qs2, ks2, cos[:32], sin[:32], None), "cos/sin"),
        ((bq, bk, bv, qs2, ks2, *[torch.zeros(64 * D + 1)[1:].view(64, D)] * 2, None),
         "aligned"),                                                       # 4-byte offset
        ((bq, bk, bv, qs2, ks2, cos, sin, torch.ones(B, 32, dtype=torch.int32)), "shape"),
    ]
    for args, what in bad:
        with pytest.raises(ValueError, match=what):
            tnr._kernel_args(*args)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No nvcc: the build raises; it never returns a stand-in."""
    from qflux_tpu_torch.runtime import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.load_library()
    finally:
        build.load_library.cache_clear()
    # the library's name is keyed by the sources and flags
    name = build.library_path().name
    assert name.startswith("libqflux_kernels-") and name.endswith(".so")


def test_port_never_imports_jax(tmp_path):
    """Importing every module of qflux_tpu_torch (ops/flash_attention.py, K3
    / K4's, among them) and running the tiny slices end to end (a FLUX
    predict request, two Trainer.fit steps with their checkpoint, a Qwen
    predict request over an int4-requant base loaded through
    Trainer.from_yaml, and the file layer: the tiny FLUX DiT loaded block by
    block from a safetensors file, the fit's LoRA file read back, and a run
    resumed from its checkpoint; at head dim 32 their attention takes the
    K3 route's plain version; `python -m qflux_tpu_torch.main` in
    process on a cached folder dataset, one padded mixed-resolution step;
    and Qwen-Image-Edit-Plus, FLUX.2-Klein and DreamOmni2 with its prompt
    enhancer, each a predict request on two raw control images and a fit
    step on a batch of pixels; the tooling: every model config dumped, a
    two-step Prodigy fit with async checkpoints, and its two LoRA files
    compared)
    leaves jax (and the JAX package, its config included), optax, orbax
    and huggingface_hub out of sys.modules, and the data layer, the CLI and
    its logging import none of cv2, PIL, pandas, tensorboardX, tensorboard
    or datasets."""
    script = tmp_path / "no_jax.py"
    script.write_text(
        "import importlib, pkgutil, sys\n"
        "import numpy as np\n"
        "import qflux_tpu_torch\n"
        "for m in pkgutil.walk_packages(qflux_tpu_torch.__path__, 'qflux_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from qflux_tpu_torch.ops.rope import flux_image_ids, flux_text_ids\n"
        "from qflux_tpu_torch.trainer.base import Trainer, predict_config\n"
        "tr = Trainer(predict_config(variant='test', num_inference_steps=2), device='cpu')\n"
        "tr.load_model()\n"
        "tr.lora = tr.build_lora()\n"
        "rng = np.random.default_rng(0)\n"
        "emb = {'control_latents': rng.standard_normal((1, 64, 16)).astype(np.float32),\n"
        "       'prompt_embeds': rng.standard_normal((1, 8, 64)).astype(np.float32),\n"
        "       'pooled_prompt_embeds': rng.standard_normal((1, 32)).astype(np.float32),\n"
        "       'tgt_ids': flux_image_ids(8, 8, 0), 'ctl_ids': flux_image_ids(8, 8, 1),\n"
        "       'txt_ids': flux_text_ids(8)}\n"
        "img = tr.predict_from_embeddings(emb, 32, 32)\n"
        "assert img.shape == (1, 32, 32, 3) and img.dtype == np.uint8\n"
        "from qflux_tpu_torch.trainer.base import train_config\n"
        "tt = Trainer(train_config(variant='test', max_train_steps=2), device='cpu')\n"
        "emb['image_latents'] = rng.standard_normal((1, 64, 16)).astype(np.float32)\n"
        "tt.fit([emb] * 3)\n"
        "assert len(tt.history) == 2 and all(np.isfinite(h['loss']) for h in tt.history)\n"
        "from qflux_tpu_torch.ops import int4_matmul\n"
        "cfg = open('qwen.yaml', 'w')\n"
        "cfg.write('trainer: QwenImageEditTrainer\\nmodel:\\n  variant: test\\n'\n"
        "          '  quantize: {enabled: true, dtype: int4_requant}\\n'\n"
        "          'predict: {num_inference_steps: 2}\\n')\n"
        "cfg.close()\n"
        "qt = Trainer.from_yaml('qwen.yaml', device='cpu')\n"
        "qt.load_model()\n"
        "assert qt.bundle.dit_params.blocks[0].attn.to_q.q4 is not None\n"
        "qemb = {'control_latents': rng.standard_normal((1, 16, 16)).astype(np.float32),\n"
        "        'prompt_embeds': rng.standard_normal((1, 8, 48)).astype(np.float32),\n"
        "        'prompt_embeds_mask': np.array([[1] * 6 + [0] * 2]),\n"
        "        'img_shapes_arr': np.array([[1, 4, 4], [1, 4, 4]], np.int32)}\n"
        "img = qt.predict_from_embeddings(qemb, 16, 16, lora=qt.build_lora())\n"
        "assert img.shape == (1, 16, 16, 3) and int4_matmul.RQ_KERNEL_LAUNCHES == 0\n"
        "assert 'qflux_tpu_torch.ops.flash_attention' in sys.modules\n"
        "from qflux_tpu_torch.ops import flash_attention\n"
        "assert flash_attention.KERNEL_LAUNCHES == 0\n"
        "from qflux_tpu_torch.utils.safetensors import save_file\n"
        f"z = np.load({str(REPO / 'tests' / 'fixtures' / 'dit_goldens' / 'flux_tiny.npz')!r})\n"
        "save_file({k[3:]: z[k] for k in z.files if k.startswith('sd.')}, 'dit.safetensors')\n"
        "ft = Trainer(predict_config(variant='test'), device='cpu')\n"
        "ft.config.model.dit_path = 'dit.safetensors'\n"
        "ft.config.model.lora.pretrained_weight = str(tt.output_dir / 'checkpoint-last-2')\n"
        "ft.load_model()\n"
        "back = ft.build_lora()\n"
        "assert all(np.array_equal(back[p]['b'].numpy(), tt.lora[p]['b'].detach().numpy())\n"
        "           for p in tt.lora)\n"
        "rt = Trainer(train_config(variant='test', max_train_steps=3), device='cpu')\n"
        "rt.config.resume = str(tt.output_dir / 'checkpoint-last-2')\n"
        "rt.fit([emb])\n"
        "assert [h['step'] for h in rt.history] == [3]\n"
        "import json\n"
        "from pathlib import Path\n"
        "import chip_smoke\n"
        "from qflux_tpu_torch import main as cli\n"
        "from qflux_tpu_torch.models.flux.transformer import FluxConfig\n"
        "items = [chip_smoke.flux_cache_item(rng, FluxConfig.tiny(), gh, gw, s_txt=8)\n"
        "         for gh, gw in [(4, 4), (6, 4)]]\n"
        "data, _ = chip_smoke.write_cached_dataset(Path('cli'), items, chip_smoke.FLUX_HASH_KEYS)\n"
        "raw = chip_smoke.multires_config(data, Path('cli'), False, variant='test', steps=1)\n"
        "Path('cli.json').write_text(json.dumps(raw))\n"
        "ct = cli.main(['--config', 'cli.json', '--device', 'cpu'])\n"
        "assert ct.global_step == 1 and np.isfinite(ct.history[0]['loss'])\n"
        "from qflux_tpu_torch.config import config_from_dict\n"
        "img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)\n"
        "for kind in ('QwenImageEditPlusTrainer', 'Flux2KleinLoraTrainer', 'DreamOmni2Trainer'):\n"
        "    ft = Trainer(config_from_dict({'trainer': kind, 'model': {\n"
        "        'variant': 'test', 'use_vlm_prompt_enhancer': kind == 'DreamOmni2Trainer'},\n"
        "        'train': {'weight_dtype': 'float32', 'max_train_steps': 1,\n"
        "                  'checkpointing_steps': 100},\n"
        "        'logging': {'output_dir': 'fam', 'project': kind},\n"
        "        'data': {'processor': {'target_size': [32, 32]}},\n"
        "        'predict': {'num_inference_steps': 1, 'max_sequence_length': 16}}), device='cpu')\n"
        "    out = ft.predict([img, img], 'add a hat')\n"
        "    assert out.shape == (1, 32, 32, 3) and ft.last_predict['latents_finite']\n"
        "    ft.fit([{'image': img[None], 'control': img[None], 'prompt': ['add a hat']}])\n"
        "    assert ft.global_step == 1 and np.isfinite(ft.history[0]['loss'])\n"
        "from qflux_tpu_torch.utils import get_model_config, model_compare, seed\n"
        "for name in get_model_config.KNOWN_CONFIGS:\n"
        "    assert get_model_config.dump_model_config(name).startswith('{')\n"
        "ot = Trainer(train_config(variant='test', max_train_steps=2), device='cpu')\n"
        "ot.config.optimizer.class_path = 'optax.contrib.prodigy'\n"
        "ot.config.optimizer.init_args = {}\n"
        "ot.config.train.async_checkpointing = True\n"
        "ot.config.train.checkpointing_steps = 1\n"
        "ot.fit([emb] * 2)\n"
        "files = [str(ot.output_dir / d / 'pytorch_lora_weights.safetensors')\n"
        "         for d in ('checkpoint-1', 'checkpoint-last-2')]\n"
        "assert model_compare.summarize(model_compare.compare_lora_files(*files))[\n"
        "    'value_mismatch']\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in (\n"
        "    'cv2', 'PIL', 'pandas', 'tensorboardX', 'tensorboard', 'tensorflow', 'datasets'))\n"
        "assert not heavy, heavy\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in (\n"
        "    'jax', 'jaxlib', 'qflux_tpu', 'optax', 'orbax', 'huggingface_hub'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "NO_JAX_OK" in res.stdout, res.stdout + res.stderr
