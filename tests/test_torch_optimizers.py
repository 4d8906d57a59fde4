"""The port's optax optimizers (qflux_tpu_torch/trainer/optimizers.py)
against optax 0.2.6's jitted updates, their state in the JAX trainer's
`optimizer_state.npz` both ways, and `Trainer.fit` under prodigy and lion
against the JAX Trainer's, on the CPU at tiny width.

The LoRA is the JAX package's stacked tree over the tiny FLUX DiT, loaded
into the port's flat tree through `models/bridge.py`; the gradients are
drawn with numpy, the scaling leaves' included, and JAX zeroes the
scaling's updates after `optimizer.update`, as its train step does.

Tolerances (relative L2 per leaf): the elementwise optimizers 1e-6: XLA may
contract a product and a sum into one fused multiply-add and computes its
bias corrections with its own `pow`, each an f32 ulp away from the port's
separate ops; Prodigy 1e-5, whose global f32 sums (the inner product <g,
p0 - p> and Σ|grad_sum|) add in another order.  A Lion sign flip moves a
parameter by 2·lr, which the parameters' bound would show; the update's
signs are checked to agree besides.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qflux_tpu.models.flux import transformer as jflux
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.trainer import train_step as jts
from qflux_tpu.trainer.base import _flatten_with_paths
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.flux import transformer as tflux
from qflux_tpu_torch.ops.layers import mark_trainable
from qflux_tpu_torch.trainer import optimizers
from qflux_tpu_torch.trainer import train_step as tts
from qflux_tpu_torch.utils import checkpoint
from tests.test_torch_ops import random_tree as _random_tree
from tests.test_torch_ops import rel_err as _rel_err

STEPS = 20
# (class path, optax constructor, init_args, lr): each optimizer in each of
# its argument sets
CASES = {
    "adamw": ("optax.adamw", optax.adamw, {}, 1e-2),
    "adamw_nesterov": ("optax.adamw", optax.adamw, {"nesterov": True, "weight_decay": 1e-2},
                       1e-2),
    "adamw_eps_root": ("optax.adamw", optax.adamw, {"eps_root": 1e-8, "b1": 0.8, "eps": 1e-6},
                       1e-2),
    "adamw_mu_bf16": ("optax.adamw", optax.adamw, {"mu_dtype": "bfloat16"}, 1e-2),
    "adam": ("optax.adam", optax.adam, {}, 1e-2),
    "adam_nesterov_bf16": ("optax.adam", optax.adam, {"nesterov": True, "mu_dtype": "bfloat16",
                                                      "b2": 0.99}, 1e-2),
    "lion": ("optax.lion", optax.lion, {}, 1e-3),
    "lion_mu_bf16": ("optax.lion", optax.lion, {"mu_dtype": "bfloat16", "b1": 0.95,
                                                "weight_decay": 0.1}, 1e-3),
    "sgd": ("optax.sgd", optax.sgd, {}, 1e-2),
    "sgd_momentum": ("optax.sgd", optax.sgd, {"momentum": 0.9}, 1e-2),
    "sgd_nesterov": ("optax.sgd", optax.sgd, {"momentum": 0.9, "nesterov": True}, 1e-2),
    "sgd_acc_bf16": ("optax.sgd", optax.sgd, {"momentum": 0.8, "accumulator_dtype": "bfloat16"},
                     1e-2),
    "prodigy": ("optax.contrib.prodigy", optax.contrib.prodigy, {}, 1.0),
    "prodigy_wd_safeguard": ("optax.contrib.prodigy", optax.contrib.prodigy,
                             {"weight_decay": 0.1, "safeguard_warmup": True}, 1.0),
    "prodigy_betas": ("optax.contrib.prodigy", optax.contrib.prodigy,
                      {"betas": [0.8, 0.99], "beta3": 0.9, "estim_lr_coef": 0.5, "eps": 1e-6,
                       "estim_lr0": 1e-5}, 1.0),
}
# a constant lr, and a schedule (optax then keeps its count).  Not one that
# starts at 0: Prodigy's first update then sums a zero grad_sum, and
# optax's estim_lr becomes max(estim_lr, 0 / 0), NaN (the port's too)
SCHEDULES = {"constant": ("constant", 0), "cosine": ("cosine", 0)}


@pytest.fixture(scope="module")
def tree():
    """(the port's tiny FLUX DiT, the JAX LoRA tree over it as numpy, with
    nonzero b and a second scaling)."""
    jcfg = jflux.FluxConfig.tiny()
    jp = _random_tree(lambda: jflux.init(jax.random.PRNGKey(0), jcfg, jnp.float32), 0)
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(2), jp, [r"attn/(to_q|to_k|to_v|to_out)"],
                                 rank=4, alpha=8.0)
    rng = np.random.default_rng(3)
    jl = jax.tree.map(lambda x: np.asarray(x, np.float32), jl)
    for stack in ("dual", "single"):
        for leaf in jl[stack]["attn"].values():
            leaf["b"] = rng.standard_normal(leaf["b"].shape).astype(np.float32) * 0.05
    model = tflux.FluxTransformer(tflux.FluxConfig.tiny(), dtype=torch.float32)
    return model, jl


def _drift(jl):
    """A fixed direction for every leaf, the scaling's too, across three
    decades: the gradients below share it, as a descent's do, so the moves
    add up (Prodigy's <g, p0 - p> grows instead of cancelling to noise)."""
    rng = np.random.default_rng(10)
    return jax.tree.map(lambda x: rng.standard_normal(x.shape)
                        * 10.0 ** rng.uniform(-3, 0, x.shape), jl)


def _grads(rng, drift):
    """The drift plus as much noise again, in f32."""
    return jax.tree.map(lambda d: (d * (1 + rng.standard_normal(d.shape))).astype(np.float32),
                        drift)


def _zero_scaling(updates):
    return jax.tree_util.tree_map_with_path(
        lambda path, u: jnp.zeros_like(u)
        if any(getattr(k, "key", None) == "scaling" for k in path) else u, updates)


def _jax_optimizer(case, schedule):
    _, ctor, args, lr = CASES[case]
    kind, warmup = SCHEDULES[schedule]
    return ctor(learning_rate=jts.make_lr_schedule(lr, kind, warmup, STEPS), **args)


def _jax_update(opt):
    @jax.jit
    def update(params, state, grads):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, _zero_scaling(updates)), state, updates

    return update


def _port(model, jl, case, schedule):
    """(the port's LoRA tree holding `jl`, its optimizer of `case`, the lr
    schedule as the Trainer builds them)."""
    class_path, _, args, lr = CASES[case]
    kind, warmup = SCHEDULES[schedule]
    lora = mark_trainable(bridge.lora_from_tree(model, jax.tree.map(np.copy, jl)))
    params, scalings = tts.lora_leaves(lora)
    sched = tts.make_lr_schedule(lr, kind, warmup, STEPS)
    return lora, optimizers.build(class_path, params, sched(0), args, frozen=scalings), sched


def _port_step(model, lora, opt, grads, lr):
    """One update of the port's optimizer on the JAX tree `grads`, with the
    lr its train step sets."""
    gl = bridge.lora_from_tree(model, grads)
    for path, leaf in lora.items():
        for k in ("a", "b", "scaling"):
            leaf[k].grad = gl[path][k].clone()
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def _copy(tree):
    return {path: {k: np.array(v) for k, v in leaf.items()} for path, leaf in tree.items()}


def _jax_state(state):
    return {"/".join(p): np.asarray(v) for p, v in _flatten_with_paths(state)}


def _npz_dtype(arr):
    """The dtype `np.savez` writes an array in (bf16 as its bytes, `|V2`)."""
    return np.dtype("V2") if arr.dtype.name == "bfloat16" else arr.dtype


def _f32(arr):
    """An npz array (a `|V2` one as bf16) in f64 for comparing."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(
            torch.bfloat16).float().numpy()
    return arr.astype(np.float64)


def _assert_close(model, lora, opt, jparams, jstate, case, schedule, count, what=""):
    """The port's parameters and state against JAX's (module docstring's
    bounds); the scaling leaves' moments only for Prodigy, which holds
    them (the elementwise optimizers keep none and write optax's zeros)."""
    tol = 1e-5 if CASES[case][0] == "optax.contrib.prodigy" else 1e-6
    want = bridge.lora_to_numpy(bridge.lora_from_tree(model, jparams))
    got = bridge.lora_to_numpy(lora)
    for path in want:
        for k in ("a", "b", "scaling"):
            assert _rel_err(got[path][k], want[path][k]) <= tol, (what, path, k)
    ours = checkpoint.optimizer_state_arrays(lora, opt, count, schedule != "constant")
    theirs = _jax_state(jstate)
    assert sorted(ours) == sorted(theirs), what
    for key, arr in theirs.items():
        assert ours[key].dtype == _npz_dtype(arr) and ours[key].shape == arr.shape, (what, key)
        if key.endswith("/scaling") and tol == 1e-6:
            continue
        assert _rel_err(_f32(ours[key]), _f32(arr)) <= tol, (what, key)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(tree, case, schedule):
    """STEPS updates of the port's optimizer against optax's jitted update
    (the scaling's zeroed after it) on the same numpy gradients: the
    parameters and, in optax's keys, the state; for Lion the update's
    signs every step."""
    model, jl = tree
    opt_j = _jax_optimizer(case, schedule)
    update = _jax_update(opt_j)
    jparams, jstate = jl, opt_j.init(jl)
    lora, opt, sched = _port(model, jl, case, schedule)
    rng, drift = np.random.default_rng(11), _drift(jl)
    lion = CASES[case][0] == "optax.lion"
    for k in range(STEPS):
        grads = _grads(rng, drift)
        before = _copy(bridge.lora_to_numpy(lora)) if lion else None
        jparams, jstate, jupd = update(jparams, jstate, grads)
        _port_step(model, lora, opt, grads, sched(k))
        if lion:  # the sign of every a / b update agrees
            after = bridge.lora_to_numpy(lora)
            wd = CASES[case][2].get("weight_decay", 1e-3)
            for path, leaf in bridge.lora_to_numpy(
                    bridge.lora_from_tree(model, jax.tree.map(np.asarray, jupd))).items():
                for name in ("a", "b"):
                    # u = -lr·(sign + wd·p): recover the sign from each side
                    lr = sched(k)
                    want = np.rint(-leaf[name] / lr - wd * before[path][name])
                    got = np.rint((before[path][name] - after[path][name]) / lr
                                  - wd * before[path][name])
                    np.testing.assert_array_equal(got, want, err_msg=f"{path}/{name} step {k}")
    _assert_close(model, lora, opt, jparams, jstate, case, schedule, STEPS)


def test_prodigy_needs_the_scaling_gradients(tree):
    """Prodigy without the scaling leaves (the a / b alone) ends further
    from optax than the bound: the whole tree's sums need them."""
    model, jl = tree
    opt_j = _jax_optimizer("prodigy", "constant")
    update = _jax_update(opt_j)
    jparams, jstate = jl, opt_j.init(jl)
    lora = mark_trainable(bridge.lora_from_tree(model, jax.tree.map(np.copy, jl)))
    opt = optimizers.build("optax.contrib.prodigy", tts.lora_leaves(lora)[0], 1.0, {})
    rng, drift = np.random.default_rng(11), _drift(jl)
    for _ in range(STEPS):
        grads = _grads(rng, drift)
        jparams, jstate, _ = update(jparams, jstate, grads)
        _port_step(model, lora, opt, grads, 1.0)
    assert abs(float(opt.param_groups[0]["estim_lr"]) - float(jstate.estim_lr)) > 1e-4 * float(
        jstate.estim_lr)


# ---------------------------------------------------------------------------
# optimizer_state.npz both ways

RESUME = ["adamw", "adam", "lion", "sgd", "sgd_momentum", "prodigy"]
HEAD_DIM = 32  # FluxConfig.tiny()'s


def _port_trainer(model, case, schedule, out):
    """The port's Trainer around the tiny DiT (no model loaded: the LoRA
    file's names and paths are the FLUX adapter's), configured as `case`."""
    from types import SimpleNamespace

    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.trainer.base import Trainer
    from qflux_tpu_torch.trainer.flux_kontext import FluxKontextAdapter

    class_path, _, args, lr = CASES[case]
    kind, warmup = SCHEDULES[schedule]
    tr = Trainer(config_from_dict({
        "model": {"variant": "test"},
        "optimizer": {"class_path": class_path, "learning_rate": lr, "init_args": args},
        "lr_scheduler": {"scheduler_type": kind, "warmup_steps": warmup},
        "train": {"max_train_steps": STEPS}, "logging": {"output_dir": str(out)}}), "cpu")
    tr.adapter = FluxKontextAdapter
    tr.bundle = SimpleNamespace(dit_cfg=SimpleNamespace(attention_head_dim=HEAD_DIM),
                                dit_params=model)
    tr.generator = torch.Generator().manual_seed(0)
    tr.output_dir, tr.global_step, tr.epoch = out, 3, 0
    return tr


def _jax_trainer(jparams, jstate, out):
    from types import SimpleNamespace

    from qflux_tpu.trainer import base as jbase
    from qflux_tpu.trainer.flux_kontext import FluxKontextAdapter
    from qflux_tpu.trainer.train_step import TrainState

    jt = object.__new__(jbase.Trainer)
    jt.adapter = FluxKontextAdapter
    jt.bundle = SimpleNamespace(dit_cfg=SimpleNamespace(attention_head_dim=HEAD_DIM))
    jt.state = TrainState(lora=jparams, opt_state=jstate, step=jnp.asarray(3, jnp.int32))
    jt.output_dir, jt.global_step, jt.epoch = out, 3, 0
    return jt


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("case", RESUME)
def test_optimizer_state_file_both_ways(tree, tmp_path, case, schedule):
    """Three updates in each package, a checkpoint written by each
    (`save_checkpoint`): the npz key sets are equal (dtypes and shapes
    too); the port's Trainer resumes JAX's checkpoint (`_load_train_state`)
    and JAX's `_load_train_state` resumes the port's, then two further
    updates on the same gradients agree as the optimizer test's bounds
    say."""
    from qflux_tpu.trainer.train_step import TrainState
    from qflux_tpu.utils.lora_io import flux_tree_path as jflux_tree_path
    from qflux_tpu.utils.lora_io import load_lora_safetensors as jload_lora
    from qflux_tpu_torch.utils.lora_io import LORA_FILE_BASE_NAME

    model, jl = tree
    opt_j = _jax_optimizer(case, schedule)
    update = _jax_update(opt_j)
    rng, drift = np.random.default_rng(12), _drift(jl)
    grads = [_grads(rng, drift) for _ in range(5)]
    jparams, jstate = jl, opt_j.init(jl)
    lora, opt, sched = _port(model, jl, case, schedule)
    for k in range(3):
        jparams, jstate, _ = update(jparams, jstate, grads[k])
        _port_step(model, lora, opt, grads[k], sched(k))
    theirs = _jax_trainer(jparams, jstate, tmp_path / "jax").save_checkpoint()
    tr = _port_trainer(model, case, schedule, tmp_path / "port")
    tr.lora, tr.optimizer = lora, opt
    ours = tr.save_checkpoint()
    with np.load(ours / checkpoint.OPTIMIZER_FILE) as a, \
            np.load(theirs / checkpoint.OPTIMIZER_FILE) as b:
        assert sorted(a.files) == sorted(b.files)
        if case != "prodigy":  # optax keeps the schedule's count where the lr is one
            assert ("2/count" in a.files or "1/count" in a.files) == (schedule != "constant")
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k

    # the port resumes JAX's checkpoint
    tr2 = _port_trainer(model, case, schedule, tmp_path / "port2")
    tr2.config.model.lora.pretrained_weight = str(theirs)
    tr2.lora = mark_trainable(tr2.build_lora())
    params, scalings = tts.lora_leaves(tr2.lora)
    tr2.optimizer, _ = tr2.build_optimizer(params, checkpoint.lora_stacks(tr2.lora),
                                           frozen=scalings)
    tr2.global_step = 0
    tr2._load_train_state(theirs)
    assert tr2.global_step == 3
    # JAX resumes the port's
    jlora = jax.tree.map(jnp.asarray, jload_lora(ours / LORA_FILE_BASE_NAME,
                                                 jflux_tree_path, head_dim=HEAD_DIM))
    jt = _jax_trainer(jlora, opt_j.init(jlora), tmp_path / "unused")
    jt.state = TrainState.create(jlora, opt_j)
    jt.global_step = 0
    jt._load_train_state(ours, opt_j)
    assert jt.global_step == 3
    p2, s2 = jt.state.lora, jt.state.opt_state
    for k in (3, 4):
        jparams, jstate, _ = update(jparams, jstate, grads[k])
        p2, s2, _ = update(p2, s2, grads[k])
        _port_step(model, tr2.lora, tr2.optimizer, grads[k], sched(k))
        _port_step(model, lora, opt, grads[k], sched(k))
    _assert_close(model, tr2.lora, tr2.optimizer, jparams, jstate, case, schedule, 5,
                  "port resumed JAX's")
    _assert_close(model, lora, opt, p2, s2, case, schedule, 5, "JAX resumed the port's")


# ---------------------------------------------------------------------------
# Trainer.fit against the JAX Trainer's

FIT_STEPS = 4


@pytest.fixture(scope="module")
def fit_pair(tree, tmp_path_factory):
    """(JAX adapter, JAX bundle, numpy DiT weights, a LoRA file, batches,
    noise, σ): the tiny FLUX DiT for both Trainers, their starting LoRA
    (the JAX tree of `tree`, written as the file both read), four cached
    batches and per step numpy noise and σ."""
    from qflux_tpu.trainer import flux_kontext as jfk

    _, jl = tree
    jcfg = jflux.FluxConfig.tiny()
    jp = _random_tree(lambda: jflux.init(jax.random.PRNGKey(0), jcfg, jnp.float32), 0)
    from qflux_tpu.utils.lora_io import save_lora_safetensors as jsave

    lora_file = jsave(jl, tmp_path_factory.mktemp("lora"), head_dim=HEAD_DIM)
    from tests.test_torch_checkpoint import _flux_batch

    batches = [_flux_batch(40 + i) for i in range(FIT_STEPS)]
    rng = np.random.default_rng(41)
    noise = [rng.standard_normal(b["image_latents"].shape).astype(np.float32) for b in batches]
    sigma = [rng.uniform(0.1, 0.9, (1,)).astype(np.float32) for _ in batches]
    bundle = jfk.ModelBundle(dit_cfg=jcfg, dit_params=jp, vae_cfg=None, vae_params=None,
                             text_cfgs={}, text_params={}, tokenizers={})
    return (jfk.FluxKontextAdapter(jcfg, remat=False), bundle,
            jax.tree.map(lambda x: np.asarray(x, np.float32), jp), lora_file, batches, noise,
            sigma)


def _fit_config(class_path, args, lr, out):
    return {"trainer": "FluxKontextLoraTrainer", "model": {"variant": "test"},
            "optimizer": {"class_path": class_path, "learning_rate": lr, "init_args": args},
            "lr_scheduler": {"scheduler_type": "cosine", "warmup_steps": 0},
            "logging": {"output_dir": str(out), "project": "p", "report_to": "none"},
            "train": {"max_train_steps": FIT_STEPS, "checkpointing_steps": 100,
                      "weight_dtype": "float32", "max_grad_norm": 1.0, "seed": 0}}


@pytest.mark.parametrize("case", ["prodigy", "lion"])
def test_fit_matches_jax_fit(fit_pair, tmp_path, monkeypatch, case):
    """`Trainer.fit`, FIT_STEPS steps under optax.contrib.prodigy and
    optax.lion from the same LoRA file over the same weights and batches,
    each step's noise and σ drawn with numpy and handed to both (JAX's step
    finds its step's by its folded key): the losses and the trained LoRA
    within the 1e-4 that tests/test_torch_train.py holds AdamW's step to."""
    from qflux_tpu.config import Config
    from qflux_tpu.trainer import base as jbase
    from qflux_tpu.trainer import train_step as jts_mod
    from qflux_tpu.utils import logger as jlogger
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.trainer.base import Trainer
    from qflux_tpu_torch.utils.lora_io import load_lora_safetensors

    jadapter, jbundle, np_params, lora_file, batches, noise, sigma = fit_pair
    class_path, _, args, lr = CASES[case]
    lr = 1e-2 if case == "lion" else lr
    raw = _fit_config(class_path, args, lr, tmp_path / "jax")
    raw["model"]["lora"] = {"pretrained_weight": str(lora_file)}

    # JAX: each step's noise and σ by the step's folded key
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), s) for s in range(FIT_STEPS)])
    j_noise, j_sigma = jnp.asarray(np.stack(noise)), jnp.asarray(np.stack(sigma))
    orig = jts_mod._loss_for_microbatch

    def loss_with_numpy_noise(base_params, lora, batch, rng, predict_velocity, criterion, cfg):
        i = jnp.argmax(jnp.all(rng == keys, axis=1))  # train.seed 0, folded with the step
        lat = batch["image_latents"]
        nz, sg = j_noise[i], j_sigma[i]
        pred = predict_velocity(jlayers.merge_lora(base_params, lora), batch,
                                jts_mod.FlowMatchScheduler.add_noise(lat, nz, sg), sg)
        return criterion(pred, jts_mod.FlowMatchScheduler.training_target(lat, nz))

    monkeypatch.setattr(jts_mod, "_loss_for_microbatch", loss_with_numpy_noise)
    j_losses = []
    monkeypatch.setattr(jlogger.NullLogger, "log_metrics",
                        lambda self, metrics, step: j_losses.extend(
                            [metrics["loss"]] if "loss" in metrics else []))
    # JAX's fit cannot run Prodigy as it stands: optax's init keeps the LoRA
    # itself as params0, and the jitted step donates both, the same buffers
    # twice ("Attempt to donate the same buffer twice"); its state is built
    # here over a copy of the LoRA (the port donates nothing)
    monkeypatch.setattr(jts_mod.TrainState, "create", classmethod(
        lambda cls, lora, optimizer: cls(lora=lora,
                                         opt_state=optimizer.init(jax.tree.map(jnp.copy, lora)),
                                         step=jnp.zeros((), jnp.int32))))
    jt = jbase.Trainer(Config.model_validate(raw))
    jt.adapter, jt.bundle = jadapter, jbundle
    jt.fit(batches)

    # the port: the same noise and σ, step by step
    draws = iter(zip(noise, sigma))
    monkeypatch.setattr(tts, "draw_noise_and_sigma",
                        lambda gen, lat, cfg: tuple(torch.from_numpy(x) for x in next(draws)))
    raw["logging"]["output_dir"] = str(tmp_path / "port")
    tr = Trainer(config_from_dict(raw), "cpu")
    tr.load_model()
    bridge.load_params(tr.bundle.dit_params, np_params)
    lora = tr.fit(batches)
    losses = [h["loss"] for h in tr.history]
    assert len(losses) == len(j_losses) == FIT_STEPS
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    want = bridge.lora_to_numpy(bridge.lora_from_tree(
        tr.bundle.dit_params, jax.tree.map(np.asarray, jt.state.lora)))
    got = bridge.lora_to_numpy(lora)
    start = load_lora_safetensors(lora_file, head_dim=HEAD_DIM)
    for path in want:
        for k in ("a", "b"):
            assert _rel_err(got[path][k], want[path][k]) < 1e-4, (path, k)
            assert not np.array_equal(got[path][k], start[path][k]), (path, k)


def test_bf16_moments_resume_from_a_jax_npz(tree, tmp_path):
    """optax.adamw with mu_dtype bfloat16: JAX's state as its trainer writes
    it (`np.savez`: bf16 as `|V2` bytes) restores the port's mu to the bit
    and its nu, and the port writes the same bytes back (JAX's own loader
    cannot read `|V2`: ROADMAP item 7)."""
    model, jl = tree
    opt_j = _jax_optimizer("adamw_mu_bf16", "constant")
    update = _jax_update(opt_j)
    jparams, jstate = jl, opt_j.init(jl)
    rng, drift = np.random.default_rng(13), _drift(jl)
    for _ in range(3):
        jparams, jstate, _ = update(jparams, jstate, _grads(rng, drift))
    np.savez(tmp_path / "state.npz", **_jax_state(jstate))
    lora, opt, _ = _port(model, jax.tree.map(np.asarray, jparams), "adamw_mu_bf16", "constant")
    with np.load(tmp_path / "state.npz") as arrays:
        assert checkpoint.restore_optimizer_state(dict(arrays), lora, opt) == 3
        ours = checkpoint.optimizer_state_arrays(lora, opt, 3, False)
        for key in arrays.files:
            if "scaling" not in key:
                assert ours[key].dtype == arrays[key].dtype, key
                assert ours[key].tobytes() == arrays[key].tobytes(), key
