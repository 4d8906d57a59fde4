"""The port's remat policies (ops/remat.py, models/flux/transformer.py:_remat,
models/qwen/transformer.py) and the out-of-memory fallback of
`Trainer.fit`, against the JAX package's, on the CPU at tiny width.

Every policy of the JAX forward, for FLUX (2 dual + 2 single blocks, f32,
the fused K1 route) and for the Qwen DiT (2 blocks over JAX's int4-requant
tree, on the K1 route and on K3's): the LoRA gradients under the policy
equal those under "full" to the bit (what a policy keeps is replayed, the
same bits the recompute would make); they match JAX's step under the same
policy (`test_train_step_matches_jax`'s bounds for FLUX, INT4_F32_TOL for
the requant base, for the reason tests/test_torch_qwen_train.py gives);
and each kernel launches per step as the policy says.  The kernels'
launchers are plain-math doubles, as in tests/test_torch_train.py (test
doubles, never a fallback of the package).  The tensors a block keeps are
held against JAX's own record of its residuals (`saved_residuals`).
"""

import collections
import dataclasses
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode

from qflux_tpu.losses import losses as jlosses
from qflux_tpu.models.flux import transformer as jflux
from qflux_tpu.models.qwen import transformer as jqwen
from qflux_tpu.ops import flash_attention as jfa
from qflux_tpu.ops import flash_nr as jnr
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.ops import quant as jquant
from qflux_tpu.scheduler import flow_match as jfm
from qflux_tpu.trainer import flux_kontext as jfk
from qflux_tpu.trainer import qwen_edit as jqe
from qflux_tpu_torch import losses as tlosses
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.flux import transformer as tflux
from qflux_tpu_torch.models.qwen import transformer as tqwen
from qflux_tpu_torch.ops import flash_attention as tfa
from qflux_tpu_torch.ops import flash_nr as tnr
from qflux_tpu_torch.ops import int4_matmul as ti4
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.ops import remat as tremat
from qflux_tpu_torch.ops.norms import ada_ln_mods
from qflux_tpu_torch.trainer import flux_kontext as tfk
from qflux_tpu_torch.trainer import qwen_edit as tqe
from qflux_tpu_torch.trainer import train_step as tts
from qflux_tpu_torch.trainer.base import Trainer, train_config
from tests.test_torch_flash_attention import _plain_flash_launchers
from tests.test_torch_flash_nr import _plain_launchers
from tests.test_torch_ops import random_tree, rel_err
from tests.test_torch_quant import _plain_rq_launchers
from tests.test_torch_qwen import JCFG, QCFG, TCFG, _jax_dit, _lora, _np_tree
from tests.test_torch_qwen_train import B_ALL_REQUANT
from tests.test_torch_qwen_train import _batch as _qwen_batch
from tests.test_torch_qwen_train import _noise_sigma as _qwen_noise_sigma
from tests.test_torch_qwen_train import _t_batch as _qwen_t_batch
from tests.test_torch_train import _batch as _flux_batch

POLICIES = ("full", "flash", "flash_offload", "dots", "dots_all", "flash_qkv", "flash_mlp",
            "flash_single")
FLUX_KW = dict(attention_head_dim=32, num_attention_heads=4, joint_attention_dim=64,
               in_channels=16, out_channels=16, pooled_projection_dim=32,
               axes_dims_rope=(8, 12, 12))
JFCFG = jflux.FluxConfig(num_layers=2, num_single_layers=2, **FLUX_KW)
TFCFG = tflux.FluxConfig(num_layers=2, num_single_layers=2, **FLUX_KW)
FLUX_TOL = 1e-4  # test_train_step_matches_jax's relative L2 per a / b gradient
N_DUAL, N_SINGLE, N_QWEN = JFCFG.num_layers, JFCFG.num_single_layers, TCFG.num_layers


def _nonzero_b(jl, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if path[-1].key == "b" else x, jl)


@pytest.fixture(scope="module")
def flux_pair():
    """JAX's tiny FLUX DiT (2 + 2 blocks), a rank-4 LoRA on the attention
    projections and every MLP with nonzero b, and the port's model."""
    jp = random_tree(lambda: jflux.init(jax.random.PRNGKey(0), JFCFG, jnp.float32), 30)
    jl = _nonzero_b(jlayers.build_lora_tree(
        jax.random.PRNGKey(31), jp, [r"attn/(to_q|to_k|to_v|to_out)", "mlp", "proj_mlp"],
        rank=4, alpha=4.0), 32)
    model = bridge.load_params(tflux.FluxTransformer(TFCFG, dtype=torch.float32),
                               _np_tree(jp))
    return jp, jl, model


@pytest.fixture(scope="module")
def qwen_pair():
    """JAX's tiny Qwen DiT in f32 and quantized by JAX's quantize_tree
    (int4_requant), the attention LoRA with nonzero b, and the port's two
    models."""
    jp = _jax_dit(seed=33)
    jq = jquant.quantize_tree(jp, QCFG)
    port = lambda tree: bridge.load_params(  # noqa: E731
        tqwen.QwenImageTransformer(TCFG, dtype=torch.float32), _np_tree(tree))
    return {"f32": (jp, _lora(jp, 34), port(jp)), "int4": (jq, _lora(jq, 34), port(jq))}


def _case(family, flux_pair, qwen_pair):
    """(JAX params, JAX LoRA, JAX adapter class and config, JAX batch, port
    model, port adapter class and config, port batch, noise, σ)."""
    if family == "flux":
        jp, jl, model = flux_pair
        raw = _flux_batch(35, 2)
        rng = np.random.default_rng(36)
        noise = rng.standard_normal(raw["image_latents"].shape).astype(np.float32)
        sigma = rng.uniform(0.05, 0.95, 2).astype(np.float32)
        tbatch = {k: torch.from_numpy(v) for k, v in raw.items()}
        return (jp, jl, jfk.FluxKontextAdapter, JFCFG, raw, model, tfk.FluxKontextAdapter,
                TFCFG, tbatch, noise, sigma)
    jp, jl, model = qwen_pair["int4" if family == "qwen_int4" else "f32"]
    raw = _qwen_batch(37, B_ALL_REQUANT)
    noise, sigma = _qwen_noise_sigma(38, B_ALL_REQUANT)
    jbatch = jqe.QwenImageEditAdapter(JCFG).prepare_cached_embeddings(raw)
    return (jp, jl, jqe.QwenImageEditAdapter, JCFG, jbatch, model, tqe.QwenImageEditAdapter,
            TCFG, _qwen_t_batch(raw), noise, sigma)


# JAX's policies that are one program on the CPU: "flash_offload" is "flash"
# there (no host memory space apart), and the Qwen DiT's "flash_single" is
# "flash" (one kind of block)
_JAX_SAME = {("flux", "flash_offload"): "flash", ("qwen", "flash_offload"): "flash",
             ("qwen", "flash_single"): "flash"}
_JAX_CACHE, _FULL_CACHE = {}, {}


def _jax_grads(family, policy, case):
    """JAX's loss and LoRA gradients under `policy` (remat on), jitted, as
    the port's numpy LoRA tree; one jit for the policies of `_JAX_SAME`."""
    key = (family, _JAX_SAME.get((family, policy), policy))
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = _jax_grads_uncached(key[1], case)
    return _JAX_CACHE[key]


def _jax_grads_uncached(policy, case):
    jp, jl, jcls, jcfg, jbatch, model, *_, noise, sigma = case
    adapter = jcls(jcfg, remat=True, remat_policy=policy)
    batch = {k: jnp.asarray(v) for k, v in jbatch.items()}

    def loss_fn(lora):
        lat, nz, sg = batch["image_latents"], jnp.asarray(noise), jnp.asarray(sigma)
        pred = adapter.predict_velocity(jlayers.merge_lora(jp, lora), batch,
                                        jfm.FlowMatchScheduler.add_noise(lat, nz, sg), sg)
        return jlosses.MseLoss()(pred, jfm.FlowMatchScheduler.training_target(lat, nz))

    # XLA's cheapest CPU compile (a third less time; the same program)
    step = jax.jit(jax.value_and_grad(loss_fn)).lower(jl).compile(compiler_options={
        "xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    loss, grads = step(jl)
    return float(loss), bridge.lora_to_numpy(bridge.lora_from_tree(model, _np_tree(grads)))


def _port_grads(case, policy):
    """The port's loss and LoRA gradients (a, b, scaling; zero where the
    loss does not reach) under `policy`."""
    jp, jl, _, _, _, model, tcls, tcfg, tbatch, noise, sigma = case
    lora = tlayers.mark_trainable(bridge.lora_from_tree(model, _np_tree(jl)))
    adapter = tcls(tcfg, remat=True, remat_policy=policy)
    loss = tts._loss_for_microbatch(model, lora, tbatch, torch.from_numpy(noise),
                                    torch.from_numpy(sigma), adapter.predict_velocity,
                                    tlosses.MseLoss(), tts.TrainStepConfig())
    loss.backward()
    for leaf in lora.values():
        for t in leaf.values():
            if t.grad is None:
                t.grad = torch.zeros_like(t)
    return float(loss.detach()), bridge.lora_to_numpy(lora, grads=True)


def _expected_launches(family, policy, route="k1"):
    """{counter: launches per step}: the forward attention kernel once a
    block, again in the recompute unless the block keeps its out / lse; the
    backward one once a block; on the requant base, K5a for the 12 block
    GEMMs and img_in / txt_in / proj_out, and again in the recompute for
    each block GEMM the policy does not keep; K5b for the 16 GEMMs whose
    input needs a gradient and whose output reaches the loss
    (tests/test_torch_qwen_train.py counts them).  On the Qwen K1 route
    "flash_qkv" keeps the six raw projections; on K3's the normed and roped
    q / k and the two raw v projections, so the recompute skips only the v
    projections: the plain norm + rope before K3 needs the raw q / k in its
    backward (JAX recomputes them too: `test_kept_tensors_match_saved_residuals`
    holds the skipped products to JAX's)."""
    fwd, bwd = ("k1", "k2") if route == "k1" else ("k3", "k4")
    flash = lambda kind: tremat.FLASH in tremat.names(policy, kind)  # noqa: E731
    if family == "flux":
        n = N_DUAL + N_SINGLE
        kept = N_DUAL * flash("flux_dual") + N_SINGLE * flash("flux_single")
        return {fwd: 2 * n - kept, bwd: n}
    n = N_QWEN
    out = {fwd: 2 * n - n * flash("qwen"), bwd: n}
    if family == "qwen_int4":
        recompute = {"dots": 0, "dots_all": 0, "flash_mlp": 10 * n,
                     "flash_qkv": (6 if route == "k1" else 10) * n}.get(policy, 12 * n)
        out.update(k5a=12 * n + 3 + recompute, k5b=16)
    return out


def _zero_launches(monkeypatch):
    for mod, names in ((tnr, ("KERNEL_LAUNCHES", "BWD_KERNEL_LAUNCHES")),
                       (tfa, ("KERNEL_LAUNCHES", "BWD_KERNEL_LAUNCHES")),
                       (ti4, ("RQ_KERNEL_LAUNCHES", "RQ_BWD_KERNEL_LAUNCHES"))):
        for name in names:
            monkeypatch.setattr(mod, name, 0)


def _launches(expected):
    counts = {"k1": tnr.KERNEL_LAUNCHES, "k2": tnr.BWD_KERNEL_LAUNCHES,
              "k3": tfa.KERNEL_LAUNCHES, "k4": tfa.BWD_KERNEL_LAUNCHES,
              "k5a": ti4.RQ_KERNEL_LAUNCHES, "k5b": ti4.RQ_BWD_KERNEL_LAUNCHES}
    return {k: counts[k] for k in expected}


def _assert_equal_grads(got, want):
    for path in want:
        for key in ("a", "b", "scaling"):
            np.testing.assert_array_equal(got[path][key], want[path][key], err_msg=path)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", ["flux", "qwen", "qwen_int4"])
def test_policy_gradients_launches_and_jax(family, policy, flux_pair, qwen_pair, monkeypatch):
    """One step's LoRA gradients under `policy`, the kernels' launchers
    plain-math doubles: equal to "full"'s to the bit, and the launches per
    step as `_expected_launches` says.  FLUX and the f32 Qwen DiT (the K1
    route) are held to JAX's step under the same policy within
    `test_train_step_matches_jax`'s bounds (loss 1e-5, each a / b gradient
    1e-4 relative L2, each scaling gradient 1e-4 of the largest); the
    requant Qwen runs the K1 route and then K3's (its step is held to JAX's
    in tests/test_torch_qwen_train.py, where INT4_F32_TOL says why a row
    quantization may round to the next step on one side)."""
    case = _case(family, flux_pair, qwen_pair)
    _plain_launchers(monkeypatch)
    if family == "qwen_int4":
        _plain_rq_launchers(monkeypatch)
        _plain_flash_launchers(monkeypatch)
    routes = ["k1", "k3"] if family == "qwen_int4" else ["k1"]
    for route in routes:
        if route == "k3":
            monkeypatch.setattr(tnr, "supports", lambda *a, **kw: False)
        if (family, route) not in _FULL_CACHE:
            _FULL_CACHE[family, route] = _port_grads(case, "full")
        want_loss, want = _FULL_CACHE[family, route]
        _zero_launches(monkeypatch)
        loss, got = _port_grads(case, policy)
        expected = _expected_launches(family, policy, route)
        assert _launches(expected) == expected, route
        assert loss == want_loss
        _assert_equal_grads(got, want)
    if family == "qwen_int4":
        return
    j_loss, j_grads = _jax_grads(family, policy, case)
    assert abs(loss - j_loss) <= 1e-5 * abs(j_loss)
    s_scale = max(abs(float(w["scaling"])) for w in j_grads.values())
    for path, w in j_grads.items():
        for key in ("a", "b"):
            if np.abs(w[key]).max() > 0:
                assert rel_err(got[path][key], w[key]) < FLUX_TOL, (path, key)
        assert abs(got[path]["scaling"] - w["scaling"]) <= FLUX_TOL * s_scale, path


# ---------------------------------------------------------------------------
# what a block keeps, against JAX's saved_residuals

S_TXT, S_IMG = 32, 96  # S = 128: no kernel block padding on JAX's side
JAX_POLICY = {
    "dots": jax.checkpoint_policies.dots_with_no_batch_dims_saveable,
    "dots_all": jax.checkpoint_policies.dots_saveable,
    "flash": jax.checkpoint_policies.save_only_these_names("flash_out", "flash_lse",
                                                           "mod_out"),
    "flash_qkv": jax.checkpoint_policies.save_only_these_names(
        "flash_out", "flash_lse", "flash_q", "flash_k", "flash_v", "mod_out"),
    "flash_mlp": jax.checkpoint_policies.save_only_these_names("flash_out", "flash_lse",
                                                               "mlp_h", "mod_out"),
    "full": None}


def _jax_kind(aval, src):
    """A JAX residual's save point: "flash" (flash_out / flash_lse), "qkv",
    "mlp_h", "dot", "mod" (the AdaLN mods: the port computes them outside
    the block) or None (an argument or a constant)."""
    if "from the argument" in src or "from a constant" in src:
        return None
    line = re.search(r"flash_nr\.py:(\d+)", src)
    if line:
        return "qkv" if 595 <= int(line.group(1)) <= 606 else "flash"
    line = re.search(r"flash_attention\.py:(\d+)", src)
    if line:
        return "qkv" if 560 <= int(line.group(1)) <= 566 else "flash"
    if "(named_checkpoint)" in src:
        return "mod" if len(aval.shape) == 2 else "mlp_h"
    if "(_base_matmul)" in src or "(dense)" in src:
        return "mod" if len(aval.shape) == 2 else "dot"
    return "other"


def _jax_dots(jaxpr, out):
    """`out` (a Counter) plus the (rows, contraction, columns) of every
    dot_general in `jaxpr` and its sub-jaxprs whose left operand has a
    token axis (the AdaLN mods' products, [B, dim] in JAX's block, are
    computed outside the port's)."""
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general" and len(e.invars[0].aval.shape) == 3:
            lhs, rhs = e.invars[0].aval.shape, e.invars[1].aval.shape
            out[lhs[0] * lhs[1], lhs[2], rhs[-1]] += 1
        for v in e.params.values():
            sub = getattr(v, "jaxpr", v)
            if hasattr(sub, "eqns"):
                _jax_dots(sub, out)
    return out


def _jax_inventory(block, policy):
    """({kind: sorted [(numel, dtype)]} of JAX's residuals of one block
    under `policy`, the products its gradient runs (`_jax_dots`)), with the
    attention JAX runs on a TPU: the fused K1 route, or for "qwen_k3" the
    plain norm + rope before the Pallas `flash_attention` (K3's route)."""
    rng = np.random.default_rng(40)
    f32 = np.float32
    txt = jnp.asarray(rng.standard_normal((1, S_TXT, 128)).astype(f32))
    img = jnp.asarray(rng.standard_normal((1, S_IMG, 128)).astype(f32))
    temb = jnp.asarray(rng.standard_normal((1, 128)).astype(f32))
    cos = jnp.asarray(rng.standard_normal((S_TXT + S_IMG, 32)).astype(f32))
    def attn(q, k, v, qs, ks, c, s, st, segment_ids=None, impl="auto"):
        if block != "qwen_k3":
            return jnr.flash_attention_nr(q, k, v, qs, ks, c, s, st, segment_ids=segment_ids)
        qn, kn = (jnr.apply_qk_norm_rope(x, sc, c, s, st) for x, sc in ((q, qs), (k, ks)))
        return jfa.flash_attention(qn, kn, v, segment_ids=segment_ids)

    mlp_save = policy == "flash_mlp"
    if block.startswith("qwen"):
        jq = _jax_dit(seed=41)
        jl = jlayers.build_lora_tree(jax.random.PRNGKey(42), jq,
                                     [r"attn/(to_q|to_k|to_v|to_out)", "mlp"], rank=4,
                                     alpha=4.0)
        p = jax.tree.map(lambda a: a[0], jlayers.merge_lora(jq, jl)["blocks"])
        cfg, mod = JCFG, jqwen

        def f(p, img, txt):
            return sum(jnp.sum(o ** 2) for o in jqwen._block(
                p, cfg, img, txt, temb, cos[S_TXT:], cos[S_TXT:], cos[:S_TXT], cos[:S_TXT],
                None, "auto", mlp_save))
        args = (p, img, txt)
    else:
        jp = random_tree(lambda: jflux.init(jax.random.PRNGKey(0), JFCFG, jnp.float32), 43)
        jl = jlayers.build_lora_tree(jax.random.PRNGKey(44), jp,
                                     [r"attn/(to_q|to_k|to_v|to_out)", "mlp", "proj_mlp"],
                                     rank=4, alpha=4.0)
        p = jax.tree.map(lambda a: a[0], jlayers.merge_lora(jp, jl)[block])
        cfg, mod = JFCFG, jflux
        if block == "dual":
            def f(p, img, txt):
                return sum(jnp.sum(o ** 2) for o in jflux._dual_block(
                    p, cfg, img, txt, temb, cos, cos, None, "auto", mlp_save))
            args = (p, img, txt)
        else:
            def f(p, x):
                return jnp.sum(jflux._single_block(p, cfg, x, temb, cos, cos, None, "auto",
                                                   mlp_save) ** 2)
            args = (p, jnp.concatenate([txt, img], axis=1))
    orig = mod.qk_norm_rope_attention
    mod.qk_norm_rope_attention = attn
    try:
        g = jax.checkpoint(f, policy=JAX_POLICY[policy], prevent_cse=False)
        res = saved_residuals(g, *args)
        jaxpr = jax.make_jaxpr(jax.grad(g, argnums=tuple(range(len(args)))))(*args)
    finally:
        mod.qk_norm_rope_attention = orig
    out = {}
    for aval, src in res:
        kind = _jax_kind(aval, src)
        if kind not in (None, "mod"):
            out.setdefault(kind, []).append((int(np.prod(aval.shape)), str(aval.dtype)))
    return {k: sorted(v) for k, v in out.items()}, _jax_dots(jaxpr.jaxpr, collections.Counter())


class _CountProducts(TorchDispatchMode):
    """(rows, contraction, columns) of every 2-D product that runs."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            a, b = args[-2:]
            self.counts[a.shape[0], a.shape[1], b.shape[1]] += 1
        return func(*args, **(kwargs or {}))


def _port_inventory(block, policy, monkeypatch):
    """{kind: sorted [(numel, dtype)]} of what the port's block keeps in its
    store under `policy` (the K1 route, or for "qwen_k3" K3's, the
    launchers plain-math doubles).  Also returns how many
    tensors beyond the block's inputs its autograd graph saves (counted
    through saved_tensors_hooks, which checkpoint's own hooks replace
    inside the block: none, the block's saved tensors are recorded and
    recomputed), and the products its forward and backward run
    (`_CountProducts`)."""
    _plain_launchers(monkeypatch)
    if block == "qwen_k3":
        _plain_flash_launchers(monkeypatch)
        monkeypatch.setattr(tnr, "supports", lambda *a, **kw: False)
    kinds = {tremat.FLASH: "flash", tremat.QKV: "qkv", tremat.MLP_H: "mlp_h",
             tremat.DOT: "dot", tremat.DOT_BATCH: "dot"}
    kept = []
    orig_put = tremat._Store.put
    monkeypatch.setattr(tremat._Store, "put", lambda self, name, value: kept.append(
        (name, value)) or orig_put(self, name, value))
    rng = np.random.default_rng(45)
    f32 = np.float32
    txt = torch.from_numpy(rng.standard_normal((1, S_TXT, 128)).astype(f32))
    img = torch.from_numpy(rng.standard_normal((1, S_IMG, 128)).astype(f32))
    temb = torch.from_numpy(rng.standard_normal((1, 128)).astype(f32))
    cos = torch.from_numpy(rng.standard_normal((S_TXT + S_IMG, 32)).astype(f32))
    if block.startswith("qwen"):
        model = tqwen.init(torch.Generator().manual_seed(0), TCFG, dtype=torch.float32)
        p = model.blocks[0]
        targets = [r"attn/(to_q|to_k|to_v|to_out)", "mlp"]
    else:
        model = tflux.init(torch.Generator().manual_seed(0), TFCFG, dtype=torch.float32)
        p = getattr(model, block)[0]
        targets = [r"attn/(to_q|to_k|to_v|to_out)", "mlp", "proj_mlp"]
    lora = tlayers.mark_trainable(tlayers.build_lora_tree(torch.Generator().manual_seed(1),
                                                          model, targets, 4, 4.0))
    tlayers.merge_lora(model, lora)
    if block.startswith("qwen"):
        mods = [tlayers.dense(m.proj, torch.nn.functional.silu(temb)) for m in (p.img_mod,
                                                                               p.txt_mod)]
        fn = lambda img, txt: tqwen._block(p, TCFG, img, txt, *mods, cos, cos, None,  # noqa
                                           "auto")
        args = (img, txt)
    elif block == "dual":
        mods = [ada_ln_mods(m.proj, temb, 6) for m in (p.img_mod, p.txt_mod)]
        fn = lambda img, txt: tflux._dual_block(p, TFCFG, img, txt, *mods, cos, cos,  # noqa
                                                None, "auto")
        args = (img, txt)
    else:
        mods = ada_ln_mods(p.mod.proj, temb, 3)
        fn = lambda x: (tflux._single_block(p, TFCFG, x, mods, cos, cos, None, "auto"),)  # noqa
        args = (torch.cat([txt, img], dim=1),)
    saved = []
    kind = {"dual": "flux_dual", "single": "flux_single"}.get(block, "qwen")
    with _CountProducts() as products:
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            out = tflux._remat(fn, policy, kind)(*args)
        sum(o.square().sum() for o in out).backward()
    tlayers.merge_lora(model, None)
    inv = {}
    for name, value in kept:
        for t in ((value,) if torch.is_tensor(value) else value):
            inv.setdefault(kinds[name], []).append((t.numel(), str(t.dtype).replace(
                "torch.", "")))
    return ({k: sorted(v) for k, v in inv.items()}, len(saved) - len(args),
            products.counts)


@pytest.mark.parametrize("policy", ["full", "flash", "dots", "dots_all", "flash_qkv",
                                    "flash_mlp"])
@pytest.mark.parametrize("block", ["dual", "single", "qwen", "qwen_k3"])
def test_kept_tensors_match_saved_residuals(block, policy, monkeypatch):
    """One dual, one single and one Qwen block at S = 128 under each policy
    (f32; "flash_offload" and "flash_single" keep what "flash" keeps), on
    the fused K1 route, and the Qwen block on K3's too: the port's store
    holds JAX's residuals of each kind, element counts and dtypes (the
    shapes differ in layout only: JAX folds the heads into one axis, and
    the port keeps a base product as [rows, out]); the total bytes are
    JAX's.  One difference is by design: under "flash_qkv" JAX keeps the
    joint q / k / v of each block, the port each stream's projection (two
    tensors per joint one in a dual or Qwen block), the same elements; on
    K3's route JAX keeps the joint q / k after the norm + rope and the
    joint v, the port the same q / k and each stream's v projection.  The
    recompute skips the products JAX's skips: those the policy's gradient
    runs fewer of than "full"'s (the policies that run the attention kernel
    again) or "flash"'s (those that keep its out / lse), by rows,
    contraction and columns; on K3's route under "flash_qkv" only the two
    v projections, since the norm + rope's backward needs the raw q / k in
    both packages.  No other tensor outlives the block's forward but its
    inputs (JAX's arguments): the checkpoint records the block's saved
    tensors in place of keeping them."""
    want, jax_dots = _jax_inventory(block, policy)
    got, n_saved, port_dots = _port_inventory(block, policy, monkeypatch)
    assert n_saved == 0
    assert "other" not in want
    if "qkv" in want:
        joint, streams = want.pop("qkv"), got.pop("qkv")
        per_stream = 1 if block == "qwen_k3" else 3  # kept as each stream's projection
        assert len(streams) == 3 - per_stream + per_stream * (1 if block == "single" else 2)
        assert sum(n for n, _ in streams) == sum(n for n, _ in joint)
    assert got == want
    base = "flash" if policy.startswith("flash") else "full"
    jax_skips = _jax_inventory(block, base)[1] - jax_dots
    port_skips = _port_inventory(block, base, monkeypatch)[2] - port_dots
    assert port_skips == jax_skips
    if (block, policy) == ("qwen_k3", "flash_qkv"):
        assert port_skips == {(S_TXT, 128, 128): 1, (S_IMG, 128, 128): 1}
    nbytes = lambda inv: sum(n * np.dtype(dt).itemsize for v in inv.values()  # noqa: E731
                             for n, dt in v)
    assert nbytes(got) == nbytes(want)


# ---------------------------------------------------------------------------
# the out-of-memory fallback of Trainer.fit

OOM = "CUDA out of memory. Tried to allocate 2.00 GiB"


@dataclasses.dataclass(frozen=True)
class _OomUnlessFull(tfk.FluxKontextAdapter):
    """The FLUX adapter whose forward runs out of memory under every policy
    but "full", after the step drew its noise (a test double)."""
    error: Exception = None

    def predict_velocity(self, *a, **k):
        if self.remat_policy != "full":
            raise self.error
        return super().predict_velocity(*a, **k)


def _fit(tmp_path, name, policy, error=None, opt_error=None, steps=3):
    """A tiny f32 `Trainer.fit` of `steps` steps under mesh.remat `policy`;
    `error`: what the forward raises under any policy but "full";
    `opt_error`: what the optimizer's first update raises after it began."""
    cfg = train_config(variant="test", max_train_steps=steps)
    cfg.train.weight_dtype = "float32"
    cfg.optimizer.learning_rate = 1e-2
    cfg.mesh.remat = policy
    cfg.logging.output_dir = str(tmp_path / name)
    tr = Trainer(cfg, "cpu")
    tr.load_model()
    if error is not None:
        tr.adapter = _OomUnlessFull(**{f.name: getattr(tr.adapter, f.name)
                                       for f in dataclasses.fields(tr.adapter)}, error=error)
    if opt_error is not None:
        build = tr.build_optimizer

        def build_failing(*a, **k):
            opt, schedule = build(*a, **k)
            step = opt.step
            calls = []

            def failing_step(*sa, **sk):
                calls.append(1)
                if len(calls) == 1:
                    raise opt_error
                return step(*sa, **sk)

            opt.step = failing_step
            return opt, schedule

        tr.build_optimizer = build_failing
    lora = tr.fit([_flux_batch(46, 2)] * 4)
    return tr, lora


def test_oom_before_the_update_degrades_to_full(tmp_path, caplog):
    """A torch.OutOfMemoryError in the first step's forward under "dots"
    (mesh.remat: minimal) warns in JAX's words, replaces the adapter with
    one under "full" and runs the same batch again: the fit's losses and
    its trained LoRA equal a run under "full" from the start, to the bit
    (the retry draws the failed attempt's noise again)."""
    caplog.set_level(logging.WARNING)
    tr, lora = _fit(tmp_path, "degraded", "minimal", error=torch.OutOfMemoryError(OOM))
    assert tr.adapter.remat_policy == "full"
    assert "ran out of memory under remat policy 'dots'" in caplog.text
    assert "retrying with mesh.remat: full" in caplog.text
    ref, ref_lora = _fit(tmp_path, "full", "full")
    assert [h["loss"] for h in tr.history] == [h["loss"] for h in ref.history]
    assert [h["step"] for h in tr.history] == [1, 2, 3]
    for path, leaf in ref_lora.items():
        for key in ("a", "b"):
            assert torch.equal(lora[path][key], leaf[key]), (path, key)


def test_oom_after_the_update_began_reraises(tmp_path, caplog):
    """An out-of-memory error raised once the optimizer began its update (the
    LoRA may be half stepped; JAX's consumed-donated-state case) re-raises
    unchanged, with an error logged, and nothing is retried."""
    err = torch.OutOfMemoryError(OOM)
    with pytest.raises(torch.OutOfMemoryError) as info:
        _fit(tmp_path, "after", "minimal", opt_error=err)
    assert info.value is err
    assert "AFTER the optimizer began its update" in caplog.text


def test_other_errors_reraise_unchanged(tmp_path):
    err = ValueError("a bug in the loss")
    with pytest.raises(ValueError) as info:
        _fit(tmp_path, "other", "minimal", error=err)
    assert info.value is err


def test_full_policy_never_retries(tmp_path):
    """Under "full" there is nothing leaner to degrade to: the error
    re-raises, with no retry loop."""
    cfg_error = torch.OutOfMemoryError(OOM)
    calls = []

    @dataclasses.dataclass(frozen=True)
    class _AlwaysOom(tfk.FluxKontextAdapter):
        def predict_velocity(self, *a, **k):
            calls.append(self.remat_policy)
            raise cfg_error

    cfg = train_config(variant="test", max_train_steps=2)
    cfg.train.weight_dtype = "float32"
    cfg.mesh.remat = "full"
    cfg.logging.output_dir = str(tmp_path)
    tr = Trainer(cfg, "cpu")
    tr.load_model()
    tr.adapter = _AlwaysOom(**{f.name: getattr(tr.adapter, f.name)
                               for f in dataclasses.fields(tr.adapter)})
    with pytest.raises(torch.OutOfMemoryError):
        tr.fit([_flux_batch(47, 2)] * 2)
    assert calls == ["full"]
