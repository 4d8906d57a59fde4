"""The port's train slice (scheduler noising and σ sampling, loss weighting,
losses, lr schedules, the train step, remat, Trainer.fit) against the JAX
package's, on the CPU at tiny width.

The two packages draw noise and σ from different generators, so the step
parity test injects the same numpy noise and σ into both.  Both sides are
float32 end to end; tolerances (stated per test) leave room for the order
of the f32 sums in XLA's and PyTorch's CPU kernels over a forward and a
backward through the 6 tiny blocks, and nothing else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qflux_tpu.losses import losses as jlosses
from qflux_tpu.models.flux import transformer as jflux
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.ops.rope import flux_image_ids, flux_text_ids
from qflux_tpu.scheduler import flow_match as jfm
from qflux_tpu.scheduler import weighting as jweighting
from qflux_tpu.trainer import flux_kontext as jfk
from qflux_tpu.trainer import train_step as jts
from qflux_tpu_torch import losses as tlosses
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.flux import transformer as tflux
from qflux_tpu_torch.ops import flash_nr as tnr
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.scheduler import flow_match as tfm
from qflux_tpu_torch.scheduler import weighting as tweighting
from qflux_tpu_torch.trainer import flux_kontext as tfk
from qflux_tpu_torch.trainer import train_step as tts
from qflux_tpu_torch.trainer.base import Trainer, train_config
from tests.test_torch_flash_nr import _plain_launchers
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err

GH = GW = 4  # a 4×4 latent grid: 16 target + 16 control tokens
S_TXT = 8


def _batch(seed, b, edit_mask=False):
    """A cached-embedding training batch at the tiny width (numpy)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = {
        "image_latents": rng.standard_normal((b, GH * GW, 16)).astype(f32),
        "control_latents": rng.standard_normal((b, GH * GW, 16)).astype(f32),
        "prompt_embeds": rng.standard_normal((b, S_TXT, 64)).astype(f32),
        "pooled_prompt_embeds": rng.standard_normal((b, 32)).astype(f32),
        "guidance": np.full((b,), 2.5, f32),
        "img_ids": np.concatenate([flux_image_ids(GH, GW, 0), flux_image_ids(GH, GW, 1)]),
        "txt_ids": flux_text_ids(S_TXT),
    }
    if edit_mask:
        out["edit_mask"] = (rng.uniform(size=(b, GH * GW)) > 0.5).astype(f32)
    return out


# ---------------------------------------------------------------------------
# scheduler: noising, σ sampling, loss weights

def test_add_noise_and_target_match_jax():
    rng = np.random.default_rng(0)
    x0, eps = (rng.standard_normal((3, 5, 4)).astype(np.float32) for _ in range(2))
    sigma = rng.uniform(size=3).astype(np.float32)
    j = jfm.FlowMatchScheduler.add_noise(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(sigma))
    t = tfm.FlowMatchScheduler.add_noise(*map(torch.from_numpy, (x0, eps, sigma)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        tfm.FlowMatchScheduler.training_target(torch.from_numpy(x0), torch.from_numpy(eps)).numpy(),
        np.asarray(jfm.FlowMatchScheduler.training_target(jnp.asarray(x0), jnp.asarray(eps))))


@pytest.mark.parametrize("scheme", ["uniform", "logit_normal", "shift"])
def test_sample_training_sigmas_statistics(scheme):
    """The generators differ, so 20,000 draws of each package are compared
    by their deciles: within 0.02 (the deciles of 20,000 draws move by
    ~0.004 between seeds)."""
    n = 20000
    j = np.asarray(jfm.sample_training_sigmas(jax.random.PRNGKey(0), n, scheme=scheme,
                                              logit_mean=0.2, logit_std=1.1, shift=2.0))
    t = tfm.sample_training_sigmas(torch.Generator().manual_seed(0), n, scheme=scheme,
                                   logit_mean=0.2, logit_std=1.1, shift=2.0)
    assert t.dtype == torch.float32 and t.shape == (n,)
    assert 0.0 <= t.min().item() and t.max().item() < 1.0
    qs = np.linspace(0.1, 0.9, 9)
    np.testing.assert_allclose(np.quantile(t.numpy(), qs), np.quantile(j, qs), atol=0.02)
    with pytest.raises(ValueError):
        tfm.sample_training_sigmas(torch.Generator(), 2, scheme="mode")


@pytest.mark.parametrize("scheme", ["none", "bell", "half_bell", "table"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_for_sigmas_match_jax(scheme, dtype):
    """Exact: the same table entries, at the same indices n - round(σ·n)
    with σ·n in σ's dtype (bf16 rounds σ·n before round())."""
    sig = np.concatenate([np.linspace(0.0005, 1.0, 37), [0.5, 0.25, 0.999]]).astype(np.float32)
    table = jweighting.default_weighting_table() if scheme == "table" else None
    j = jweighting.weights_for_sigmas(jnp.asarray(sig).astype(dtype), scheme, table=table)
    t = tweighting.weights_for_sigmas(torch.from_numpy(sig).to(getattr(torch, dtype)), scheme,
                                      table=table)
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))
    np.testing.assert_array_equal(tweighting.default_weighting_table(),
                                  jweighting.default_weighting_table())


# ---------------------------------------------------------------------------
# losses

@pytest.mark.parametrize("name,kw", [
    ("MseLoss", {}), ("MseLoss", {"reduction": "sum"}), ("MseLoss", {"reduction": "none"}),
    ("MaskEditLoss", {}), ("MaskEditLoss", {"foreground_weight": 3.0, "reduction": "sum"}),
    ("AttentionMaskMseLoss", {}), ("AttentionMaskMseLoss", {"reduction": "none"}),
])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(name, kw, weighted):
    rng = np.random.default_rng(1)
    pred, target = (rng.standard_normal((3, 10, 6)).astype(np.float32) for _ in range(2))
    extra = {"edit_mask": (rng.uniform(size=(3, 10)) > 0.4).astype(np.float32),
             "attention_mask": (rng.uniform(size=(3, 10)) > 0.2).astype(np.float32)}
    if weighted:
        extra["weighting"] = rng.uniform(0.5, 2, (3, 1, 1)).astype(np.float32)
    j = getattr(jlosses, name)(**kw)(jnp.asarray(pred), jnp.asarray(target),
                                     **{k: jnp.asarray(v) for k, v in extra.items()})
    t = getattr(tlosses, name)(**kw)(torch.from_numpy(pred), torch.from_numpy(target),
                                     **{k: torch.from_numpy(v) for k, v in extra.items()})
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def test_map_mask_to_latent_matches_jax():
    mask = (np.random.default_rng(2).uniform(size=(2, 64, 48)) > 0.7).astype(np.float32)
    j = jlosses.map_mask_to_latent(jnp.asarray(mask))
    t = tlosses.map_mask_to_latent(torch.from_numpy(mask))
    assert t.shape == (2, 4 * 3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


# ---------------------------------------------------------------------------
# lr schedules

@pytest.mark.parametrize("kind,warmup", [("constant", 0), ("constant", 5),
                                         ("constant_with_warmup", 0),
                                         ("constant_with_warmup", 3), ("cosine", 0),
                                         ("cosine", 4), ("linear", 0), ("linear", 6)])
def test_lr_schedule_matches_optax(kind, warmup):
    j = jts.make_lr_schedule(3e-4, kind, warmup, total_steps=20)
    t = tts.make_lr_schedule(3e-4, kind, warmup, total_steps=20)
    for step in range(25):
        want = float(j(step)) if callable(j) else float(j)
        assert t(step) == pytest.approx(want, rel=1e-5, abs=1e-12), step
    with pytest.raises(ValueError):
        tts.make_lr_schedule(1e-4, "step")


# ---------------------------------------------------------------------------
# the train step against JAX

@pytest.fixture(scope="module")
def tiny_pair():
    """JAX tiny DiT + rank-4 LoRA (nonzero b, so every a has a gradient) and
    the port's modules holding the same numbers."""
    jcfg = jflux.FluxConfig.tiny()
    jp = _random_tree(lambda: jflux.init(jax.random.PRNGKey(0), jcfg, jnp.float32), 0)
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(2), jp, [r"attn/(to_q|to_k|to_v|to_out)"],
                                 rank=4, alpha=4.0)
    rng = np.random.default_rng(3)
    for stack in ("dual", "single"):
        for leaf in jl[stack]["attn"].values():
            leaf["b"] = jnp.asarray(rng.standard_normal(leaf["b"].shape).astype(np.float32) * 0.05)
    model = bridge.load_params(tflux.FluxTransformer(tflux.FluxConfig.tiny(),
                                                     dtype=torch.float32),
                               jax.tree.map(np.asarray, jp))
    return jcfg, jp, jl, model


def _jax_step(jcfg, jp, jl, batch, noise, sigma, criterion, accum, max_norm, opt,
              adapter=None):
    """The JAX step with injected noise / σ: `_loss_for_microbatch`'s body
    under jax.value_and_grad per microbatch (tests/trainer/test_train_step.py),
    mean over microbatches (the keys of SHARED_BATCH_KEY_PREFIXES shared),
    global-norm clip, optax.adamw, scaling updates zeroed — make_train_step's
    arithmetic.  `adapter`: the JAX adapter (default FLUX.1-Kontext, no remat)."""
    adapter = adapter or jfk.FluxKontextAdapter(jcfg, remat=False)

    def loss_fn(lora, mb, nz, sg):
        lat = mb["image_latents"]
        noisy = jfm.FlowMatchScheduler.add_noise(lat, nz, sg)
        target = jfm.FlowMatchScheduler.training_target(lat, nz)
        pred = adapter.predict_velocity(jlayers.merge_lora(jp, lora), mb, noisy, sg)
        return criterion(pred, target, weighting=None, edit_mask=mb.get("edit_mask"),
                         attention_mask=mb.get("attention_mask"))

    b = batch["image_latents"].shape[0] // accum
    losses, grads = [], []
    for i in range(accum):
        sl = slice(i * b, (i + 1) * b)
        mb = {k: jnp.asarray(v if k.startswith(jts.SHARED_BATCH_KEY_PREFIXES) else v[sl])
              for k, v in batch.items()}
        loss, g = jax.value_and_grad(loss_fn)(jl, mb, jnp.asarray(noise[sl]),
                                              jnp.asarray(sigma[sl]))
        losses.append(float(loss))
        grads.append(g)
    grads = jax.tree.map(lambda *g: sum(g) / accum, *grads)
    gnorm = float(optax.global_norm(grads))
    scale = min(1.0, max_norm / (gnorm + 1e-12))
    clipped = jax.tree.map(lambda g: g * scale, grads)
    updates, _ = opt.update(clipped, opt.init(jl), jl)
    updates = jax.tree_util.tree_map_with_path(
        lambda path, u: jnp.zeros_like(u)
        if any(getattr(k, "key", None) == "scaling" for k in path) else u, updates)
    return sum(losses) / accum, grads, gnorm, optax.apply_updates(jl, updates)


def assert_step_matches_jax(jadapter, jparams, jl, jbatch, tadapter, model, tbatch, noise,
                            sigma, rel_tol=2e-5) -> dict:
    """One MseLoss LoRA step of another family's adapter at injected noise
    and σ, without a clip: JAX's loss and gradients (`_jax_step`'s loss,
    under jax.jit) against the port's `make_train_step` on the same LoRA
    (`jl`, bridged into `model`): the loss and grad_norm within `rel_tol`,
    every a / b gradient JAX gives a nonzero value within 1e-4 relative L2
    (the bound and its reason: `test_train_step_matches_jax`).  Returns
    JAX's gradients as the port's numpy LoRA tree."""
    def loss_fn(lora):
        lat, nz, sg = jbatch["image_latents"], jnp.asarray(noise), jnp.asarray(sigma)
        pred = jadapter.predict_velocity(jlayers.merge_lora(jparams, lora), jbatch,
                                         jfm.FlowMatchScheduler.add_noise(lat, nz, sg), sg)
        return jlosses.MseLoss()(pred, jfm.FlowMatchScheduler.training_target(lat, nz))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(jl)
    j_loss, j_gnorm = float(j_loss), float(optax.global_norm(j_grads))
    lora = tlayers.mark_trainable(bridge.lora_from_tree(model, jax.tree.map(np.asarray, jl)))
    opt = torch.optim.AdamW(tts.lora_leaves(lora)[0], lr=1e-3)
    step = tts.make_train_step(tadapter.predict_velocity, tlosses.MseLoss(), opt,
                               lambda i: 1e-3, tts.TrainStepConfig(max_grad_norm=1e9))
    seen = {}
    orig = opt.step

    def spy():
        seen.update(bridge.lora_to_numpy(lora, grads=True))
        orig()

    opt.step = spy
    m = step(model, lora, tbatch, None, noise=torch.from_numpy(noise),
             sigma=torch.from_numpy(sigma))
    assert abs(float(m["loss"]) - j_loss) <= rel_tol * abs(j_loss)
    assert abs(float(m["grad_norm"]) - j_gnorm) <= rel_tol * j_gnorm
    want = bridge.lora_to_numpy(bridge.lora_from_tree(model, jax.tree.map(np.asarray, j_grads)))
    assert sorted(seen) == sorted(want)
    for p, w in want.items():
        for k in ("a", "b"):
            if np.abs(w[k]).max() > 0:
                assert _rel_err(seen[p][k], w[k]) < 1e-4, (p, k)
    return want


@pytest.mark.parametrize("loss_name", ["MseLoss", "MaskEditLoss"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(tiny_pair, loss_name, accum):
    """One step at injected noise and σ: the loss (rel 1e-5), every LoRA a/b
    gradient (relative L2 1e-4 per tensor: ~1e-6 of f32 sum-order noise per
    op through forward and backward) and every scaling gradient, grad_norm
    (rel 1e-5), and the LoRA after clipping (active: the bound is below the
    norm) and one AdamW step (atol 1e-6).  The step runs with eps 1e-3 and
    weight_decay 0.1 on both sides: Adam's first update is lr·g/(|g| + eps),
    which at the default eps 1e-8 turns the f32 noise of a gradient element
    near 1e-8 into a visible difference; at 1e-3 it is smooth in g, and the
    decay term (lr·0.1·|p| ~ 1e-4) stands well above the tolerance.
    The scaling gradients are nonzero and counted in grad_norm, yet scaling
    is not stepped: mirrored from JAX, a divergence from upstream PEFT
    (ROADMAP.md, queue 3)."""
    jcfg, jp, jl, model = tiny_pair
    b, max_norm, lr = 4, 1e-2, 1e-2
    adam = {"b1": 0.9, "b2": 0.999, "eps": 1e-3, "weight_decay": 0.1}
    batch = _batch(40 + accum, b, edit_mask=loss_name == "MaskEditLoss")
    rng = np.random.default_rng(50 + accum)
    noise = rng.standard_normal(batch["image_latents"].shape).astype(np.float32)
    sigma = rng.uniform(0.05, 0.95, b).astype(np.float32)

    j_loss, j_grads, j_gnorm, j_new = _jax_step(
        jcfg, jp, jl, batch, noise, sigma, getattr(jlosses, loss_name)(), accum, max_norm,
        optax.adamw(lr, **adam))

    lora = tlayers.mark_trainable(bridge.lora_from_tree(model, jax.tree.map(np.asarray, jl)))
    cfg = train_config()
    cfg.optimizer.learning_rate = lr
    cfg.optimizer.init_args = adam
    opt, schedule = Trainer(cfg, "cpu").build_optimizer(tts.lora_leaves(lora)[0])
    step = tts.make_train_step(tfk.FluxKontextAdapter(model.cfg).predict_velocity,
                               getattr(tlosses, loss_name)(), opt, schedule,
                               tts.TrainStepConfig(max_grad_norm=max_norm, grad_accum_steps=accum))
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads_seen = {}
    orig_step = opt.step

    def spy_step():  # the clipped gradients, as the optimizer sees them
        grads_seen.update(bridge.lora_to_numpy(lora, grads=True))
        orig_step()

    opt.step = spy_step
    m = step(model, lora, t_batch, None, noise=torch.from_numpy(noise),
             sigma=torch.from_numpy(sigma))
    assert float(m["loss"]) == pytest.approx(j_loss, rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(j_gnorm, rel=1e-5)
    assert j_gnorm > max_norm  # the clip is active
    clip = max_norm / (j_gnorm + 1e-12)
    j_grads_np = bridge.lora_to_numpy(bridge.lora_from_tree(model,
                                                            jax.tree.map(np.asarray, j_grads)))
    assert sorted(grads_seen) == sorted(j_grads_np)
    # a scaling gradient is one sum over every output element of its layer,
    # with cancellation: held to 1e-4 of the largest one, absolute
    s_scale = max(abs(float(w["scaling"])) for w in j_grads_np.values())
    for path, want in j_grads_np.items():
        for key in ("a", "b"):
            got = grads_seen[path][key] / clip
            assert _rel_err(got, want[key]) < 1e-4, (path, key)
        got = grads_seen[path]["scaling"] / clip
        assert abs(got - want["scaling"]) <= 1e-4 * s_scale, path
        assert want["scaling"] != 0
    j_new_np = bridge.lora_to_numpy(bridge.lora_from_tree(model, jax.tree.map(np.asarray, j_new)))
    for path, want in j_new_np.items():
        for key in ("a", "b", "scaling"):
            np.testing.assert_allclose(lora[path][key].detach().numpy(), want[key], atol=1e-6,
                                       err_msg=f"{path}/{key}")
        assert lora[path]["scaling"].item() == 1.0  # alpha / r, never stepped


def test_scaling_gradient_mirrors_jax_not_peft(tiny_pair):
    """A divergence from upstream PEFT, mirrored from the JAX package: LoRA
    `scaling` (alpha / r) is a differentiated leaf, so its gradient is
    nonzero and counted in grad_norm (and so in the clip), yet it is never
    stepped.  PEFT keeps alpha / r a float: its grad_norm is the a/b part
    alone (ROADMAP.md, queue 3)."""
    *_, model = tiny_pair
    lora = tlayers.mark_trainable(tlayers.build_lora_tree(
        torch.Generator().manual_seed(1), model, [r"attn/to_q"], 4, 8.0))
    with torch.no_grad():
        for leaf in lora.values():
            leaf["b"].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(2))
    params, scalings = tts.lora_leaves(lora)
    opt = torch.optim.AdamW(params, lr=1e-2)
    step = tts.make_train_step(tfk.FluxKontextAdapter(model.cfg).predict_velocity,
                               tlosses.MseLoss(), opt, lambda count: 1e-2,
                               tts.TrainStepConfig(max_grad_norm=0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(65, 2).items()}
    m = step(model, lora, batch, torch.Generator().manual_seed(0))
    ab = sum(float(t.grad.pow(2).sum()) for t in params)
    sc = sum(float(t.grad.pow(2).sum()) for t in scalings)
    assert sc > 0
    assert float(m["grad_norm"]) ** 2 == pytest.approx(ab + sc, rel=1e-5)
    assert float(m["grad_norm"]) ** 2 > ab * (1 + 1e-6)  # PEFT's norm would be sqrt(ab)
    assert all(t.item() == 2.0 for t in scalings)  # 8 / 4, not stepped


def test_step_draws_noise_and_sigma_from_the_generator(tiny_pair):
    """Without injected noise the step draws from the generator: the same
    seed gives the same loss, another seed another."""
    *_, model = tiny_pair
    batch = {k: torch.from_numpy(v) for k, v in _batch(60, 2).items()}

    def loss_at(seed):
        lora = tlayers.mark_trainable(tlayers.build_lora_tree(
            torch.Generator().manual_seed(1), model, [r"attn/to_q"], 4, 4.0))
        opt = torch.optim.AdamW(tts.lora_leaves(lora)[0], lr=0.0)
        step = tts.make_train_step(tfk.FluxKontextAdapter(model.cfg).predict_velocity,
                                   tlosses.MseLoss(), opt, lambda count: 0.0)
        return float(step(model, lora, batch, torch.Generator().manual_seed(seed))["loss"])

    assert loss_at(3) == loss_at(3) != loss_at(4)


def test_step_refuses_frozen_lora(tiny_pair):
    *_, model = tiny_pair
    lora = tlayers.build_lora_tree(torch.Generator().manual_seed(1), model, [r"attn/to_q"], 4, 4.0)
    step = tts.make_train_step(tfk.FluxKontextAdapter(model.cfg).predict_velocity,
                               tlosses.MseLoss(), torch.optim.AdamW([torch.zeros(1)]),
                               lambda count: 0.0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(61, 2).items()}
    with pytest.raises(ValueError, match="mark_trainable"):
        step(model, lora, batch, torch.Generator())


# ---------------------------------------------------------------------------
# remat through the custom op (plain-math doubles for the launchers)

@pytest.mark.parametrize("policy,k1_per_step", [("flash", 1), ("full", 2),
                                               ("flash_offload", 1)])
def test_remat_launch_counts_and_grads(tiny_pair, monkeypatch, policy, k1_per_step):
    """The train step at tiny depth with the kernels' launchers replaced by
    plain-math doubles (a test double, not a fallback of the package): per
    block and step, K1 launches once under "flash" (its out / lse saved by
    the selective-checkpoint policy) and under "flash_offload" (kept in host
    memory and replayed in the recompute), twice under "full"; K2 once under
    all three.  The LoRA gradients equal those of the plain path without
    remat (relative L2 1e-5: the same f32 math, recomputed)."""
    *_, model = tiny_pair
    n_blocks = model.cfg.num_layers + model.cfg.num_single_layers
    batch = {k: torch.from_numpy(v) for k, v in _batch(62, 2).items()}
    rng = np.random.default_rng(63)
    noise = torch.from_numpy(rng.standard_normal((2, GH * GW, 16)).astype(np.float32))
    sigma = torch.from_numpy(rng.uniform(0.1, 0.9, 2).astype(np.float32))

    def grads(adapter):
        lora = tlayers.mark_trainable(tlayers.build_lora_tree(
            torch.Generator().manual_seed(1), model, [r"attn/(to_q|to_k|to_v|to_out)"], 4, 4.0))
        with torch.no_grad():
            for leaf in lora.values():
                leaf["b"].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(2))
        loss = tts._loss_for_microbatch(model, lora, batch, noise, sigma,
                                        adapter.predict_velocity, tlosses.MseLoss(),
                                        tts.TrainStepConfig())
        loss.backward()
        return bridge.lora_to_numpy(lora, grads=True)

    want = grads(tfk.FluxKontextAdapter(model.cfg, remat=False))
    _plain_launchers(monkeypatch)
    monkeypatch.setattr(tnr, "KERNEL_LAUNCHES", 0)
    monkeypatch.setattr(tnr, "BWD_KERNEL_LAUNCHES", 0)
    got = grads(tfk.FluxKontextAdapter(model.cfg, remat=True, remat_policy=policy))
    assert tnr.KERNEL_LAUNCHES == k1_per_step * n_blocks
    assert tnr.BWD_KERNEL_LAUNCHES == n_blocks
    for path in want:
        for key in ("a", "b", "scaling"):
            assert _rel_err(got[path][key], want[path][key]) < 1e-5, (path, key)


def test_flash_policy_sees_the_op_in_a_fresh_process(tmp_path):
    """Importing the transformer alone is enough for a policy that keeps
    tensors: in a fresh process the tiny DiT trains one step under "flash",
    with LoRA gradients equal to those of "full" (the save points live in
    the ops themselves, ops/remat.py; no policy needs an op registered
    first; tests/test_torch_remat.py holds every policy to "full")."""
    import subprocess
    import sys
    from pathlib import Path

    script = tmp_path / "fresh.py"
    script.write_text(
        "import torch\n"
        "from qflux_tpu_torch.models.flux import transformer as t\n"
        "from qflux_tpu_torch.ops import layers\n"
        "cfg = t.FluxConfig.tiny()\n"
        "m = t.init(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)\n"
        "g = torch.Generator().manual_seed(1)\n"
        "x, c = torch.randn(1, 16, 16, generator=g), torch.randn(1, 4, 64, generator=g)\n"
        "ids = torch.zeros(16, 3), torch.zeros(4, 3)\n"
        "def grads(policy):\n"
        "    lora = layers.mark_trainable(layers.build_lora_tree(\n"
        "        torch.Generator().manual_seed(2), m, ['attn/to_q', 'mlp'], 2, 2.0))\n"
        "    layers.merge_lora(m, lora)\n"
        "    y = t.forward(m, cfg, x, c, torch.randn(1, 32, generator=torch.Generator()),\n"
        "                  torch.full((1,), 0.5), *ids, guidance=torch.ones(1),\n"
        "                  remat_policy=policy)\n"
        "    y.square().sum().backward()\n"
        "    return [leaf[k].grad for leaf in lora.values() for k in ('a', 'b')]\n"
        "want = grads('full')\n"
        "assert all(torch.equal(a, b) for a, b in zip(grads('flash'), want))\n")
    env = {"PYTHONPATH": str(Path(__file__).resolve().parent.parent), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("mesh_remat", ["minimal", "flash_mlp", "flash_single"])
def test_unported_remat_policies_raise(tiny_pair, mesh_remat):
    """The three policies a config can name beyond full / flash /
    flash_offload (once refused here) train: a step's LoRA gradients under
    each equal those of "full" to the bit (the same math; what a policy
    keeps is replayed, not recomputed).  An unknown name still raises."""
    *_, model = tiny_pair
    b = {k: torch.from_numpy(v) for k, v in _batch(64, 1).items()}
    rng = np.random.default_rng(65)
    noise = torch.from_numpy(rng.standard_normal((1, GH * GW, 16)).astype(np.float32))
    sigma = torch.tensor([0.4])

    def grads(policy):
        lora = tlayers.mark_trainable(tlayers.build_lora_tree(
            torch.Generator().manual_seed(1), model, [r"attn/(to_q|to_v)", "mlp"], 4, 4.0))
        with torch.no_grad():
            for leaf in lora.values():
                leaf["b"].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(2))
        adapter = tfk.FluxKontextAdapter(model.cfg, remat_policy=policy)
        tts._loss_for_microbatch(model, lora, b, noise, sigma, adapter.predict_velocity,
                                 tlosses.MseLoss(), tts.TrainStepConfig()).backward()
        return bridge.lora_to_numpy(lora, grads=True)

    want = grads("full")
    got = grads(tfk.remat_policy_from_config(mesh_remat))
    for path in want:
        for key in ("a", "b", "scaling"):
            np.testing.assert_array_equal(got[path][key], want[path][key], err_msg=path)
    with pytest.raises(ValueError):
        tflux._remat(lambda: None, "nonsense", "flux_dual")


# ---------------------------------------------------------------------------
# the Trainer

def test_trainer_config_surface():
    """optax.adamw → the port's optax Adam (weight decay 1e-4 at optax's
    default, the config's 1e-2 here), qflux_tpu.ops.adam8bit.adamw8bit →
    AdamW8bit, optax.lion / optax.contrib.prodigy / optax.sgd / optax.adam
    and adamw's nesterov / eps_root / mu_dtype → the port's optimizers
    (tests/test_torch_optimizers.py holds each to optax); the three losses
    by their JAX class paths; any other optimizer (optax.adafactor) or
    argument (optax's `mask`) raises naming ROADMAP.md and listing what is
    ported."""
    from qflux_tpu_torch.trainer import optimizers

    cfg = train_config()
    tr = Trainer(cfg, "cpu")
    w = [torch.zeros(3, requires_grad=True)]
    opt, schedule = tr.build_optimizer(w)
    g = opt.param_groups[0]
    assert type(opt) is optimizers.Adam
    assert g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8 and g["weight_decay"] == 1e-2
    assert schedule(0) == g["lr"] == 1e-4
    for name in ("MseLoss", "MaskEditLoss", "AttentionMaskMseLoss"):
        cfg.loss = type(cfg.loss)(class_path=f"qflux_tpu.losses.{name}",
                                  init_args={"reduction": "sum"})
        crit = tr.build_criterion()
        assert type(crit).__name__ == name and crit.reduction == "sum"
    cfg.train.timestep_sampling = "weighted"
    sc = tr._build_step_config()
    assert sc.timestep_sampling == "uniform" and sc.weighting_scheme == "table"
    assert sc.weighting_table.shape == (1000,)
    cfg.optimizer.class_path = "qflux_tpu.ops.adam8bit.adamw8bit"
    cfg.optimizer.init_args = {"b1": 0.8, "block_size": 128}
    opt, _ = tr.build_optimizer(w)
    g = opt.param_groups[0]
    assert type(opt).__name__ == "AdamW8bit" and g["betas"] == (0.8, 0.999)
    assert g["weight_decay"] == 1e-2 and g["block_size"] == 128 and g["eps"] == 1e-8
    scaling = [torch.ones((), requires_grad=True)]
    for path, args, cls, want in [
            ("optax.lion", {}, optimizers.Lion, {"betas": (0.9, 0.99), "weight_decay": 1e-3}),
            ("optax.contrib.prodigy", {"betas": [0.8, 0.9]}, optimizers.Prodigy,
             {"betas": (0.8, 0.9), "weight_decay": 0.0, "estim_lr0": 1e-6}),
            ("optax.sgd", {"momentum": 0.9, "nesterov": True}, optimizers.SGD,
             {"momentum": 0.9, "nesterov": True, "accumulator_dtype": None}),
            ("optax.adam", {"mu_dtype": "bfloat16"}, optimizers.Adam,
             {"weight_decay": None, "mu_dtype": torch.bfloat16}),
            ("optax.adamw", {"b1": 0.9, "nesterov": True, "eps_root": 1e-9}, optimizers.Adam,
             {"nesterov": True, "eps_root": 1e-9, "weight_decay": 1e-4})]:
        cfg.optimizer.class_path, cfg.optimizer.init_args = path, args
        opt, _ = tr.build_optimizer(w, frozen=scaling)
        g = opt.param_groups[0]
        assert type(opt) is cls and all(g[k] == v for k, v in want.items()), path
        # only Prodigy's update depends on the whole tree: it alone holds the scaling
        assert (len(g["params"]) == 2) == (cls is optimizers.Prodigy), path
    cfg.optimizer.class_path, cfg.optimizer.init_args = "optax.adafactor", {}
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7.*optax.contrib.prodigy"):
        tr.build_optimizer(w)
    cfg.optimizer.class_path = "optax.adamw"
    cfg.optimizer.init_args = {"b1": 0.9, "mask": {"a": True}}
    with pytest.raises(NotImplementedError, match="ROADMAP.*mask"):
        tr.build_optimizer(w)
    cfg.loss.class_path = "qflux_tpu.losses.Nope"
    with pytest.raises(NotImplementedError):
        tr.build_criterion()


def test_trainer_fit_runs_and_loss_falls(tmp_path):
    """Trainer.fit on the tiny trainer: 12 steps on the CPU (f32, lr 1e-2),
    finite loss / grad_norm / lr per step in history, and the loss at a
    fixed noise and σ falls from the initial LoRA to the trained one."""
    cfg = train_config(variant="test", max_train_steps=12)
    cfg.train.weight_dtype = "float32"
    cfg.optimizer.learning_rate = 1e-2
    cfg.logging.output_dir = str(tmp_path)
    tr = Trainer(cfg, "cpu")
    batch = _batch(70, 2)
    lora = tr.fit([batch] * 20)
    assert [h["step"] for h in tr.history] == list(range(1, 13))
    assert all(np.isfinite([h["loss"], h["grad_norm"], h["lr"]]).all() for h in tr.history)
    assert all(h["lr"] == 1e-2 for h in tr.history)

    t_batch = tr._device_batch(batch)
    rng = np.random.default_rng(71)
    noise = torch.from_numpy(rng.standard_normal((2, GH * GW, 16)).astype(np.float32))
    sigma = torch.tensor([0.3, 0.7])
    fresh = tlayers.mark_trainable(tr.build_lora())

    def loss(lo):
        with torch.no_grad():
            return float(tts._loss_for_microbatch(
                tr.bundle.dit_params, lo, t_batch, noise, sigma, tr.adapter.predict_velocity,
                tr.build_criterion(), tr._build_step_config()))

    assert loss(lora) < 0.9 * loss(fresh)
    # the LoRA b moved off zero; the scaling stayed alpha / r
    assert all(leaf["b"].abs().sum() > 0 and leaf["scaling"].item() == 1.0
               for leaf in lora.values())
