"""Kernel K1 of the port (qflux_tpu_torch/ops/flash_nr.py): its plain PyTorch
version against the JAX package's `flash_attention_nr`, run as
tests/ops/test_flash_nr.py runs it on the CPU (the Pallas kernel in
interpret mode), and the wrapper's refusals.

Shapes and tolerance are those of tests/ops/test_flash_nr.py: B=2, S=256,
H=2, D=128, the txt/img boundary at 96, float32, atol 3e-5.  In float32 the
pipeline's intermediate casts are the identity, so the two sides differ
only in the order of the f32 sums of the softmax (online in the kernel).

The CUDA kernel itself cannot run here; `test_kernel_matches_plain_on_card`
holds it against the plain version where a card is present.
"""

import os
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

B, S, H, D = 2, 256, 2, 128
ST = 96
ATOL = 3e-5
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
    t_args = [torch.from_numpy(a) for a in _inputs(8, s=16)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tnr.flash_attention_nr(*t_args, 4, s_int8=True)
    for impl in ("int8", "ring", "stub"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tattn.qk_norm_rope_attention(*t_args, 4, impl=impl)
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


def test_kernel_arg_checks():
    """What csrc/flash_nr_fwd.cu does not take is refused before a launch."""
    q, k, v, qs2, ks2, cos, sin = (torch.from_numpy(a) for a in _inputs(10, s=64))
    bq, bk, bv = (x.to(torch.bfloat16) for x in (q, k, v))
    qs, ks, stride, seg = tnr._kernel_args(bq, bk, bv, qs2, ks2, cos, sin, None)
    assert stride == 0 and seg is None and qs.dtype == torch.float32
    _, _, stride, seg = tnr._kernel_args(bq, bk, bv, qs2, ks2, cos[None].expand(B, -1, -1)
                                         .contiguous(), sin[None].expand(B, -1, -1)
                                         .contiguous(), torch.ones(B, 64, dtype=torch.int64))
    assert stride == 64 * D and seg.dtype == torch.int32
    bad = [
        ((q, k, v, qs2, ks2, cos, sin, None), "bfloat16"),                 # f32 q/k/v
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
    """Importing every module of qflux_tpu_torch and running the tiny slice
    end to end leaves jax (and the JAX package) out of sys.modules."""
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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'qflux_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "NO_JAX_OK" in res.stdout, res.stdout + res.stderr


# ---------------------------------------------------------------------------
# on the card

@pytest.mark.cuda
@pytest.mark.parametrize("seg_kind", [None, "masked"])
def test_kernel_matches_plain_on_card(seg_kind):
    """K1 on the card against its plain version, bf16, at a small shape with a
    ragged edge (S=300 is not a multiple of the 64-row tiles).  Tolerances as
    chip_smoke.py states them: 4 bf16 ulps at magnitude 1 for out, 1e-4 for
    lse."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (and nvcc) to build and run csrc/flash_nr_fwd.cu")
    q, k, v, qs2, ks2, cos, sin = _inputs(11, s=300, h=4)
    args = [torch.from_numpy(a).cuda() for a in (q, k, v, qs2, ks2, cos, sin)]
    for i in range(3):
        args[i] = args[i].to(torch.bfloat16)
    seg = _segments(seg_kind, 300)
    seg = None if seg is None else torch.from_numpy(seg).cuda()
    out, lse = tnr.flash_attention_nr(*args, ST, segment_ids=seg)
    torch.cuda.synchronize()
    ref, ref_lse = tnr.flash_attention_nr_reference(*args, ST, segment_ids=seg)
    assert (out.float() - ref.float()).abs().max().item() <= 1.6e-2
    valid = ref_lse > -1e29
    assert (lse - ref_lse).abs()[valid].max().item() <= 1e-4
    if seg is not None:
        assert bool((out[0, 230:] == 0).all())
