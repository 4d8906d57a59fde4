"""The port's Qwen-Image-Edit LoRA train step over the int4-requant base
(qflux_tpu_torch/trainer/{qwen_edit,train_step,base}.py, the requant
matmul's backward, the remat policies) against the JAX package's, on the
CPU at tiny width.

The same numpy weights (the tiny Qwen DiT quantized by JAX's
`quantize_tree`), LoRA, batch, noise and σ go through both packages, f32
end to end.  Tolerance: INT4_F32_TOL (2e-3 relative) of
tests/test_torch_qwen.py, for the reason given there: each requant product
and its backward is exact on both sides given the same operand, but an
activation (or a cotangent) one f32 ulp apart, from sums taken in another
order, can round to the neighbouring int8 step in a row quantization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qflux_tpu.losses import losses as jlosses
from qflux_tpu.ops import quant as jquant
from qflux_tpu.trainer import qwen_edit as jqe
from qflux_tpu_torch import losses as tlosses
from qflux_tpu_torch.config import config_from_dict
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.qwen import transformer as tqwen
from qflux_tpu_torch.ops import flash_nr as tnr
from qflux_tpu_torch.ops import int4_matmul as ti4
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.ops import remat as tremat
from qflux_tpu_torch.trainer import qwen_edit as tqe
from qflux_tpu_torch.trainer import train_step as tts
from qflux_tpu_torch.trainer.base import Trainer, train_config
from tests.test_torch_flash_nr import _plain_launchers
from tests.test_torch_ops import rel_err as _rel_err
from tests.test_torch_quant import _plain_rq_launchers
from tests.test_torch_qwen import (GH, GW, INT4_F32_TOL, JCFG, QCFG, S_TXT, TCFG, _jax_dit,
                                   _lora, _np_tree, _port)
from tests.test_torch_train import _jax_step

# per sample: 2·16 image rows (target + control) and 8 text rows.  At b = 4
# the image stream's 128 rows take the requant matmul and the text stream's
# 32 the dequantized product, so both routes are under the gradient; at
# b = 6 the text stream's 48 rows take the requant matmul too, as at full
# width.
B_BOTH_ROUTES, B_ALL_REQUANT = 4, 6


def _batch(seed, b):
    """A cached-embedding training batch of the tiny Qwen adapter (numpy),
    the last sample's text padded from token 5."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = np.ones((b, S_TXT), np.int64)
    mask[-1, 5:] = 0
    return {
        "image_latents": rng.standard_normal((b, GH * GW, JCFG.in_channels)).astype(f32),
        "control_latents": rng.standard_normal((b, GH * GW, JCFG.in_channels)).astype(f32),
        "prompt_embeds": rng.standard_normal((b, S_TXT, JCFG.joint_attention_dim)).astype(f32),
        "prompt_embeds_mask": mask,
        "img_shapes_arr": np.asarray([(1, GH, GW), (1, GH, GW)], np.int32),
    }


def _noise_sigma(seed, b):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, GH * GW, JCFG.in_channels)).astype(np.float32),
            rng.uniform(0.05, 0.95, b).astype(np.float32))


@pytest.fixture(scope="module")
def tiny_int4():
    """The JAX tiny Qwen DiT quantized by JAX's quantize_tree, a rank-4
    LoRA on the eight attention projections with nonzero b, and the port's
    model holding the same numbers (f32)."""
    jq = jquant.quantize_tree(_jax_dit(seed=11), QCFG)
    return jq, _lora(jq, 12), _port(jq)


def _t_batch(b_np):
    return {k: torch.as_tensor(np.asarray(v))
            for k, v in tqe.QwenImageEditAdapter(TCFG).prepare_cached_embeddings(b_np).items()}


# the LoRA layers whose gradient is zero: the last block's text stream
# ends in its add_out and text MLP, whose output the DiT drops, and its
# text queries (add_q) feed only that stream (JAX's gradients there are
# zero too; the train step fills in zeros where autograd leaves none)
ZERO_GRAD = {f"blocks/{TCFG.num_layers - 1}/attn/{n}" for n in ("add_q", "add_out")}


def _grads(model, lora_np, batch, noise, sigma, policy="flash_offload"):
    """The LoRA gradients (a, b, scaling) of one microbatch's loss, numpy,
    zero where the loss does not reach (as the train step fills them);
    policy None: no remat."""
    lora = tlayers.mark_trainable(bridge.lora_from_tree(model, lora_np))
    adapter = tqe.QwenImageEditAdapter(TCFG, remat=policy is not None,
                                       remat_policy=policy or "full")
    loss = tts._loss_for_microbatch(model, lora, batch, torch.from_numpy(noise),
                                    torch.from_numpy(sigma), adapter.predict_velocity,
                                    tlosses.MseLoss(), tts.TrainStepConfig())
    loss.backward()
    for leaf in lora.values():
        for t in leaf.values():
            if t.grad is None:
                t.grad = torch.zeros_like(t)
    return bridge.lora_to_numpy(lora, grads=True)


@pytest.mark.parametrize("accum", [1, 2])
def test_qwen_train_step_matches_jax(tiny_int4, accum):
    """One step of the port (remat "flash_offload", the published config's
    policy) and of JAX (no remat) at injected noise and σ, MseLoss: the
    loss, every LoRA a/b gradient (relative L2 per tensor), every scaling
    gradient (against the largest one, absolute), grad_norm, all to
    INT4_F32_TOL; the LoRA after the clip (active) and one AdamW step
    (eps 1e-3 and weight_decay 0.1 on both sides, as
    tests/test_torch_train.py:test_train_step_matches_jax) to lr ·
    INT4_F32_TOL absolute: the update is smooth in the gradient at that eps,
    so a gradient 2e-3 off moves it by less than that."""
    jq, jl, model = tiny_int4
    b, max_norm, lr = B_BOTH_ROUTES, 1e-2, 1e-2
    adam = {"b1": 0.9, "b2": 0.999, "eps": 1e-3, "weight_decay": 0.1}
    raw = _batch(80 + accum, b)
    noise, sigma = _noise_sigma(90 + accum, b)
    jbatch = jqe.QwenImageEditAdapter(JCFG).prepare_cached_embeddings(raw)
    j_loss, j_grads, j_gnorm, j_new = _jax_step(
        JCFG, jq, jl, jbatch, noise, sigma, jlosses.MseLoss(), accum, max_norm,
        optax.adamw(lr, **adam), adapter=jqe.QwenImageEditAdapter(JCFG, remat=False))

    lora = tlayers.mark_trainable(bridge.lora_from_tree(model, _np_tree(jl)))
    cfg = train_config()
    cfg.optimizer.learning_rate = lr
    cfg.optimizer.init_args = adam
    opt, schedule = Trainer(cfg, "cpu").build_optimizer(tts.lora_leaves(lora)[0])
    step = tts.make_train_step(
        tqe.QwenImageEditAdapter(TCFG, remat_policy="flash_offload").predict_velocity,
        tlosses.MseLoss(), opt, schedule,
        tts.TrainStepConfig(max_grad_norm=max_norm, grad_accum_steps=accum))
    grads_seen = {}
    orig_step = opt.step

    def spy_step():  # the clipped gradients, as the optimizer sees them
        grads_seen.update(bridge.lora_to_numpy(lora, grads=True))
        orig_step()

    opt.step = spy_step
    m = step(model, lora, _t_batch(raw), None, noise=torch.from_numpy(noise),
             sigma=torch.from_numpy(sigma))
    assert float(m["loss"]) == pytest.approx(j_loss, rel=INT4_F32_TOL)
    assert float(m["grad_norm"]) == pytest.approx(j_gnorm, rel=INT4_F32_TOL)
    assert j_gnorm > max_norm  # the clip is active
    clip = max_norm / (j_gnorm + 1e-12)
    j_grads_np = bridge.lora_to_numpy(bridge.lora_from_tree(model, _np_tree(j_grads)))
    assert sorted(grads_seen) == sorted(j_grads_np) and len(j_grads_np) == 8 * TCFG.num_layers
    s_scale = max(abs(float(w["scaling"])) for w in j_grads_np.values())
    for path, want in j_grads_np.items():
        for key in ("a", "b"):
            assert _rel_err(grads_seen[path][key] / clip, want[key]) < INT4_F32_TOL, (path, key)
        got = grads_seen[path]["scaling"] / clip
        assert abs(got - want["scaling"]) <= INT4_F32_TOL * s_scale, path
    j_new_np = bridge.lora_to_numpy(bridge.lora_from_tree(model, _np_tree(j_new)))
    for path, want in j_new_np.items():
        for key in ("a", "b", "scaling"):
            np.testing.assert_allclose(lora[path][key].detach().numpy(), want[key],
                                       atol=lr * INT4_F32_TOL, rtol=0, err_msg=f"{path}/{key}")


def test_step_runs_both_int4_routes_under_the_gradient(tiny_int4, monkeypatch):
    """A counting double over `_base_matmul`'s two int4 routes: at b = 4 the
    requant matmul (image stream) and the dequantized product (text stream)
    both run on inputs that need a gradient, and the AdaLN mods (B rows,
    dequantized) never do."""
    jq, jl, model = tiny_int4
    seen = {"rq": 0, "dequant": 0}
    orig_rq, orig_mm = ti4.rq_fused_matmul, tlayers._matmul_f32

    def rq(x, *a, **k):
        seen["rq"] += bool(x.requires_grad)
        return orig_rq(x, *a, **k)

    def mm(x, w):
        seen["dequant"] += bool(x.requires_grad)
        return orig_mm(x, w)

    monkeypatch.setattr(ti4, "rq_fused_matmul", rq)
    monkeypatch.setattr(tlayers, "_matmul_f32", mm)
    raw = _batch(83, B_BOTH_ROUTES)
    grads = _grads(model, _np_tree(jl), _t_batch(raw), *_noise_sigma(93, B_BOTH_ROUTES))
    assert seen["rq"] > 0 and seen["dequant"] > 0
    for path, g in grads.items():
        reached = np.abs(g["a"]).sum() > 0 and np.abs(g["b"]).sum() > 0
        assert reached == (path not in ZERO_GRAD), path


def test_mods_record_nothing_for_backward(tiny_int4):
    """The per-block AdaLN mods depend on σ alone: under autograd their
    outputs need no gradient and no tensor of a mod weight's size (its
    dequantized [6·dim, dim] copy) is saved for backward."""
    jq, jl, model = tiny_int4
    mod_outputs, saved_shapes = [], []
    orig = tqwen.dense

    def spy(p, x, *a, **k):
        y = orig(p, x, *a, **k)
        if p.out_dim == 6 * TCFG.dim:
            mod_outputs.append(y)
        return y

    tqwen.dense = spy
    lora = tlayers.mark_trainable(bridge.lora_from_tree(model, _np_tree(jl)))
    batch = _t_batch(_batch(84, 2))
    noise, sigma = _noise_sigma(94, 2)
    adapter = tqe.QwenImageEditAdapter(TCFG, remat_policy="flash_offload")
    try:
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved_shapes.append(tuple(t.shape)) or t, lambda t: t):
            loss = tts._loss_for_microbatch(model, lora, batch, torch.from_numpy(noise),
                                            torch.from_numpy(sigma), adapter.predict_velocity,
                                            tlosses.MseLoss(), tts.TrainStepConfig())
    finally:
        tqwen.dense = orig
    loss.backward()
    assert len(mod_outputs) == 2 * TCFG.num_layers
    assert not any(y.requires_grad for y in mod_outputs)
    dim = TCFG.dim
    assert saved_shapes and not {(6 * dim, dim), (dim, 6 * dim)} & set(saved_shapes)


def test_remat_policies_give_identical_gradients(tiny_int4):
    """On the CPU (the plain attention and the plain requant matmul) the
    tiny Qwen step's LoRA gradients under "flash", "full" and
    "flash_offload" are the same to the bit, and equal those without remat."""
    jq, jl, model = tiny_int4
    batch = _t_batch(_batch(85, B_BOTH_ROUTES))
    noise, sigma = _noise_sigma(95, B_BOTH_ROUTES)
    grads = {p: _grads(model, _np_tree(jl), batch, noise, sigma, p)
             for p in ("flash", "full", "flash_offload", None)}
    for policy in ("full", "flash_offload", None):
        for path, want in grads["flash"].items():
            for key in ("a", "b", "scaling"):
                np.testing.assert_array_equal(grads[policy][path][key], want[key],
                                              err_msg=f"{policy} {path}/{key}")


@pytest.mark.parametrize("policy,k1_per_step", [("flash", 1), ("full", 2),
                                               ("flash_offload", 1)])
def test_kernel_launch_counts_per_step(tiny_int4, monkeypatch, policy, k1_per_step):
    """The tiny step at b = 6 (every block GEMM on the requant route, as at
    full width) with all four kernels' launchers replaced by plain-math
    doubles (test doubles, not fallbacks of the package), per step:
    K1 once a block under "flash" and "flash_offload" (its residuals kept
    on the device, or in host memory and replayed), twice under "full";
    K2 once a block; K5a for the 12 block GEMMs in the forward and again in
    the recompute, plus img_in, txt_in and proj_out; K5b for every GEMM
    whose input needs a gradient and whose output reaches the loss: 6 in
    block 0 (to_out, add_out, the four MLP GEMMs; its q/k/v inputs carry
    none), 12 in every middle block, 9 in the last (its add_out and text
    MLP feed only the dropped text stream), and proj_out.  At 60 blocks
    that is 1,443 K5a and 712 K5b.  The gradients equal those of the plain
    path without the doubles, to the bit: the doubles compute the kernels'
    functions, and the offloaded residuals come back unchanged."""
    jq, jl, model = tiny_int4
    n = TCFG.num_layers
    batch = _t_batch(_batch(86, B_ALL_REQUANT))
    noise, sigma = _noise_sigma(96, B_ALL_REQUANT)
    want = _grads(model, _np_tree(jl), batch, noise, sigma, policy)
    _plain_launchers(monkeypatch)
    _plain_rq_launchers(monkeypatch)
    for name in ("KERNEL_LAUNCHES", "BWD_KERNEL_LAUNCHES"):
        monkeypatch.setattr(tnr, name, 0)
    for name in ("RQ_KERNEL_LAUNCHES", "RQ_BWD_KERNEL_LAUNCHES"):
        monkeypatch.setattr(ti4, name, 0)
    offloads = []
    orig_put = tremat._Store.put
    monkeypatch.setattr(tremat._Store, "put",
                        lambda self, name, value: (offloads.append(name) if self.offload
                                                   else None) or orig_put(self, name, value))
    got = _grads(model, _np_tree(jl), batch, noise, sigma, policy)
    assert (tnr.KERNEL_LAUNCHES, tnr.BWD_KERNEL_LAUNCHES) == (k1_per_step * n, n)
    assert ti4.RQ_KERNEL_LAUNCHES == 12 * n + 3 + 12 * n
    assert ti4.RQ_BWD_KERNEL_LAUNCHES == 6 + 12 * (n - 2) + 9 + 1
    assert len(offloads) == (n if policy == "flash_offload" else 0)
    for path, w in want.items():
        for key in ("a", "b", "scaling"):
            np.testing.assert_array_equal(got[path][key], w[key], err_msg=f"{path}/{key}")


def test_microbatches_split_and_share_the_qwen_keys():
    """Under gradient accumulation the step splits prompt_embeds_mask,
    segment_ids and the latents and shares img_shapes_arr and the rope
    tables, as JAX's `_microbatches` scan does."""
    batch = _t_batch(_batch(87, 4))
    batch["segment_ids"] = torch.ones(4, S_TXT + 2 * GH * GW, dtype=torch.int32)
    mbs = tts._microbatches(batch, 2)
    for key in ("image_latents", "control_latents", "prompt_embeds", "prompt_embeds_mask",
                "segment_ids"):
        assert all(torch.equal(mb[key], batch[key][2 * i:2 * i + 2]) for i, mb in enumerate(mbs))
    for key in [k for k in batch if k.startswith("rope_")] + ["img_shapes_arr"]:
        assert all(mb[key] is batch[key] for mb in mbs)
    assert tuple(batch["img_shapes_arr"].shape) == (2, 3)  # not a batch axis


def test_trainer_fit_on_the_tiny_int4_model_and_loss_falls(tmp_path):
    """Trainer.fit on the tiny Qwen model over the int4-requant base, remat
    "flash_offload": 12 steps on the CPU (f32, lr 1e-2), finite loss /
    grad_norm / lr in history, and the loss averaged over four fixed
    draws of noise and σ falls from the initial LoRA to the trained one
    (below 0.96 of it; measured 0.929: at this width most of the
    flow-matching loss is noise the adapter cannot predict); no kernel
    launches on the CPU."""
    cfg = config_from_dict({
        "trainer": "QwenImageEditTrainer", "mesh": {"remat": "flash_offload"},
        "model": {"variant": "test", "quantize": {"enabled": True, "dtype": "int4_requant"}},
        "optimizer": {"class_path": "optax.adamw", "learning_rate": 1e-2},
        "train": {"max_train_steps": 12, "weight_dtype": "float32"},
        "logging": {"output_dir": str(tmp_path)}})
    tr = Trainer(cfg, "cpu")
    batch = _batch(88, 2)
    before = (ti4.RQ_KERNEL_LAUNCHES, ti4.RQ_BWD_KERNEL_LAUNCHES, tnr.KERNEL_LAUNCHES)
    lora = tr.fit([batch] * 20)
    assert (ti4.RQ_KERNEL_LAUNCHES, ti4.RQ_BWD_KERNEL_LAUNCHES, tnr.KERNEL_LAUNCHES) == before
    assert tr.adapter.remat_policy == "flash_offload"
    assert tr.bundle.dit_params.blocks[0].attn.to_q.q4 is not None
    assert [h["step"] for h in tr.history] == list(range(1, 13))
    assert all(np.isfinite([h["loss"], h["grad_norm"], h["lr"]]).all() for h in tr.history)

    t_batch = tr._device_batch(batch)
    fresh = tlayers.mark_trainable(tr.build_lora())

    def loss(lo):
        with torch.no_grad():
            return np.mean([float(tts._loss_for_microbatch(
                tr.bundle.dit_params, lo, t_batch, *map(torch.from_numpy, _noise_sigma(s, 2)),
                tr.adapter.predict_velocity, tr.build_criterion(), tr._build_step_config()))
                for s in range(97, 101)])

    assert loss(lora) < 0.96 * loss(fresh)
    # every LoRA b moved off zero but the two the loss never reaches; the
    # scaling stayed alpha / r
    for path, leaf in lora.items():
        assert (leaf["b"].abs().sum() > 0) == (path not in ZERO_GRAD), path
        assert leaf["scaling"].item() == 1.0
