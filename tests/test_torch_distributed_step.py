"""The port's LoRA train step on a mesh of ranks, over gloo on the CPU.

A tiny FLUX LoRA step (injected global noise / σ, the global-norm clip,
optax.sgd) at dp = 2, at fsdp = 2 (the frozen base sharded by FSDP2), at
sp = 2 (ring attention) and at dp = 2 × grad_accum_steps = 2 with
AttentionMaskMseLoss on a right-padded mixed-size batch.  Every case runs
on two ranks of tests/torch_dist_worker.py (this file's cases in one
spawn, tests/test_torch_distributed_step_sp.py the others); each is
held to the port's one-process step and to JAX's step on the same mesh,
built here on the conftest's 8-device CPU mesh from the same numpy inputs
(the batch sharded over (dp, fsdp), the base by `mmdit_rules` where fsdp >
1, the attention through JAX's ring where sp > 1): loss and grad_norm rtol
1e-5, the LoRA after the update atol 1e-6 / rtol 1e-4 (JAX's own
`test_train_step_sp2_matches_sp1` bounds), equal on every rank.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from qflux_tpu.losses import losses as jlosses
from qflux_tpu.models.flux import transformer as jflux
from qflux_tpu.ops import layers as jlayers
from qflux_tpu.ops.rope import flux_image_ids, flux_text_ids
from qflux_tpu.parallel import MeshConfig as JMeshConfig, build_mesh as j_build_mesh
from qflux_tpu.parallel import shard_pytree
from qflux_tpu.parallel.partitioning import mmdit_rules as j_mmdit_rules
from qflux_tpu.scheduler import flow_match as jfm
from qflux_tpu.trainer import flux_kontext as jfk
from qflux_tpu.trainer import train_step as jts
from qflux_tpu_torch import losses as tlosses
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.flux import transformer as tflux
from qflux_tpu_torch.config import config_from_dict
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.ops import quant as tquant
from qflux_tpu_torch.trainer import optimizers
from qflux_tpu_torch.trainer.flux_kontext import FluxKontextAdapter
from qflux_tpu_torch.trainer.train_step import TrainStepConfig, lora_leaves, make_train_step
from tests.test_torch_distributed import _finish, _restore_jax_mesh, _start
from tests.test_torch_ops import random_tree

GH = GW = 4
S_TXT = 8
LR, MAX_NORM = 1e-2, 1.0
# name: (mesh, loss, grad_accum_steps, global batch)
CASES = {
    "dp2": ({"dp": 2, "fsdp": 1}, "MseLoss", 1, 4),
    "fsdp2": ({"dp": 1, "fsdp": 2}, "MseLoss", 1, 4),
    "sp2": ({"dp": 1, "fsdp": 1, "sp": 2}, "MseLoss", 1, 2),
    "dp2_accum2_mask": ({"dp": 2, "fsdp": 1}, "AttentionMaskMseLoss", 2, 4),
    "fsdp2_int4_requant": ({"dp": 1, "fsdp": 2}, "MseLoss", 1, 4),
}
# the cases whose base is quantized (by the port's quantize_tree) before it
# is sharded: held to the one-process step only (JAX's int4 route differs by
# row-quantization flips, tests/test_torch_quant.py)
QUANTIZE = {"fsdp2_int4_requant": "int4_requant"}


def _tiny():
    """JAX's tiny FLUX tree and a rank-4 LoRA with nonzero b (numpy)."""
    jcfg = jflux.FluxConfig.tiny()
    jp = random_tree(lambda: jflux.init(jax.random.PRNGKey(0), jcfg, jnp.float32), 0)
    jl = jlayers.build_lora_tree(jax.random.PRNGKey(2), jp, [r"attn/(to_q|to_k|to_v|to_out)"],
                                 rank=4, alpha=4.0)
    rng = np.random.default_rng(3)
    for stack in ("dual", "single"):
        for leaf in jl[stack]["attn"].values():
            leaf["b"] = jnp.asarray(rng.standard_normal(leaf["b"].shape).astype(np.float32) * 0.05)
    return jcfg, jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jl)


def _batch(b, padded):
    rng = np.random.default_rng(7)
    f = np.float32
    n = GH * GW
    out = {"image_latents": rng.standard_normal((b, n, 16)).astype(f),
           "control_latents": rng.standard_normal((b, n, 16)).astype(f),
           "prompt_embeds": rng.standard_normal((b, S_TXT, 64)).astype(f),
           "pooled_prompt_embeds": rng.standard_normal((b, 32)).astype(f),
           "guidance": np.full((b,), 2.5, f),
           "img_ids": np.concatenate([flux_image_ids(GH, GW, 0), flux_image_ids(GH, GW, 1)]),
           "txt_ids": flux_text_ids(S_TXT)}
    if padded:  # right-padded mixed sizes: valid target / control tokens per sample
        valid = np.zeros((b, n), np.int32)
        for i, k in enumerate([16, 12, 8, 16][:b]):
            valid[i, :k] = 1
        out["segment_ids"] = np.concatenate([np.ones((b, S_TXT), np.int32), valid, valid], 1)
        out["attention_mask"] = valid.astype(f)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _inputs(name):
    mesh_kw, loss, accum, b = CASES[name]
    batch = _batch(b, padded=loss == "AttentionMaskMseLoss")
    rng = np.random.default_rng(5)
    noise = rng.standard_normal(batch["image_latents"].shape).astype(np.float32)
    sigma = rng.uniform(0.05, 0.95, b).astype(np.float32)
    return batch, noise, sigma


def _jax_on_mesh(tiny, name):
    """JAX's step under the mesh of the case (`_jax_step` of
    tests/test_torch_train.py, jitted): each microbatch's value_and_grad
    over the batch sharded on (dp, fsdp) and the base by `mmdit_rules`
    where fsdp > 1, the attention through the ring where sp > 1; the mean
    over microbatches, the global-norm clip, optax.sgd, scaling updates
    zeroed.  Returns (loss, grad_norm, the updated LoRA)."""
    jcfg, jp, jl = tiny
    mesh_kw, loss, accum, _ = CASES[name]
    batch, noise, sigma = _inputs(name)
    mesh = j_build_mesh(JMeshConfig(**{"tp": 1, "sp": 1, **mesh_kw}))
    try:
        params = jax.tree.map(jnp.asarray, jp)
        if mesh_kw["fsdp"] > 1:
            params = shard_pytree(params, j_mmdit_rules(), mesh)
        adapter = jfk.FluxKontextAdapter(jcfg, remat=False)
        crit = getattr(jlosses, loss)()

        def loss_fn(lora, mb, nz, sg):
            lat = mb["image_latents"]
            noisy = jfm.FlowMatchScheduler.add_noise(lat, nz, sg)
            pred = adapter.predict_velocity(jlayers.merge_lora(params, lora), mb, noisy, sg)
            return crit(pred, jfm.FlowMatchScheduler.training_target(lat, nz), weighting=None,
                        edit_mask=mb.get("edit_mask"), attention_mask=mb.get("attention_mask"))

        value_grad = jax.jit(jax.value_and_grad(loss_fn))
        sharding = NamedSharding(mesh, P(("dp", "fsdp")))
        lora = jax.tree.map(jnp.asarray, jl)
        b = batch["image_latents"].shape[0] // accum
        losses, grads = [], []
        for i in range(accum):
            sl = slice(i * b, (i + 1) * b)
            mb = {k: (jnp.asarray(v) if k.startswith(jts.SHARED_BATCH_KEY_PREFIXES)
                      else jax.device_put(v[sl], sharding)) for k, v in batch.items()}
            val, g = value_grad(lora, mb, jax.device_put(noise[sl], sharding),
                                jax.device_put(sigma[sl], sharding))
            losses.append(float(val))
            grads.append(g)
        grads = jax.tree.map(lambda *g: sum(g) / accum, *grads)
        gnorm = float(optax.global_norm(grads))
        scale = min(1.0, MAX_NORM / (gnorm + 1e-12))
        opt = optax.sgd(LR)
        updates, _ = opt.update(jax.tree.map(lambda g: g * scale, grads), opt.init(lora), lora)
        updates = jax.tree_util.tree_map_with_path(
            lambda path, u: jnp.zeros_like(u)
            if any(getattr(k, "key", None) == "scaling" for k in path) else u, updates)
        return sum(losses) / accum, gnorm, jax.tree.map(np.asarray,
                                                        optax.apply_updates(lora, updates))
    finally:
        _restore_jax_mesh()


def _one_process(tiny, name):
    """The port's step in this process: no process group, the whole batch."""
    _, jp, jl = tiny
    _, loss, accum, _ = CASES[name]
    batch, noise, sigma = _inputs(name)
    model = bridge.load_params(tflux.FluxTransformer(tflux.FluxConfig.tiny(),
                                                     dtype=torch.float32), jp)
    if name in QUANTIZE:
        tquant.quantize_tree(model, config_from_dict({"model": {"quantize": {
            "enabled": True, "dtype": QUANTIZE[name]}}}).model.quantize)
    lora = tlayers.mark_trainable(bridge.lora_from_tree(model, jl))
    opt = optimizers.build("optax.sgd", lora_leaves(lora)[0], LR, {})
    step = make_train_step(FluxKontextAdapter(model.cfg).predict_velocity,
                           getattr(tlosses, loss)(), opt, lambda i: LR,
                           TrainStepConfig(max_grad_norm=MAX_NORM, grad_accum_steps=accum))
    m = step(model, lora, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
             noise=torch.from_numpy(noise), sigma=torch.from_numpy(sigma))
    return float(m["loss"]), float(m["grad_norm"]), bridge.lora_to_numpy(lora)


class Ranks:
    """`names`' cases started on two ranks in one spawn, the JAX tree and
    LoRA beside them; `results` waits for the ranks (the first call) and
    returns {case: [each rank's results]}."""

    def __init__(self, root, names):
        self.tiny = _tiny()
        self.names = names
        self.root = root
        _write_cases(root, self.tiny, names)
        self.procs = _start("steps", 2, root)
        self._results = None

    def results(self, name):
        if self._results is None:
            _finish(self.procs)
            self._results = {n: [dict(np.load(self.root / n / f"step-{r}.npz"))
                                 for r in range(2)] for n in self.names}
        return self._results[name]


def _write_cases(root, tiny, names):
    """Each case's inputs (the weights, the LoRA, the batch, noise and σ)
    and settings in its directory under `root`, and cases.json."""
    _, jp, jl = tiny
    model = bridge.load_params(tflux.FluxTransformer(tflux.FluxConfig.tiny(),
                                                     dtype=torch.float32), jp)
    lora_np = bridge.lora_to_numpy(bridge.lora_from_tree(model, jl))
    for name in names:
        mesh_kw, loss, accum, _ = CASES[name]
        d = root / name
        d.mkdir()
        batch, noise, sigma = _inputs(name)
        np.savez(d / "inputs.npz", noise=noise, sigma=sigma,
                 **{f"p/{k}": v for k, v in _flat(jp).items()},
                 **{f"l/{p.replace('/', '|')}/{k}": v for p, leaf in lora_np.items()
                    for k, v in leaf.items()},
                 **{f"b/{k}": v for k, v in batch.items()})
        (d / "step.json").write_text(json.dumps(
            {"mesh": mesh_kw, "loss": loss, "accum": accum, "lr": LR, "max_norm": MAX_NORM,
             "quantize": QUANTIZE.get(name)}))
    (root / "cases.json").write_text(json.dumps(names))


def check_case(ranks: Ranks, case: str) -> None:
    """The case's step on two ranks: the loss, grad_norm and the LoRA after
    the update equal the port's one-process step and JAX's step on the same
    mesh, the same on every rank; each rank holds its rows (B / (dp ·
    fsdp)); under fsdp = 2 each rank holds about half of each block's base
    bytes (norm scales, biases and quantization scales stay whole), else
    all of them."""
    tiny = ranks.tiny
    mesh_kw, _, _, b = CASES[case]
    one = _one_process(tiny, case)
    refs = [one]
    if case not in QUANTIZE:  # while the ranks run
        j_loss, j_gnorm, j_new = _jax_on_mesh(tiny, case)
        model = tflux.FluxTransformer(tflux.FluxConfig.tiny(), dtype=torch.float32)
        refs.append((j_loss, j_gnorm,
                     bridge.lora_to_numpy(bridge.lora_from_tree(model, j_new))))
    data_ways = mesh_kw["dp"] * mesh_kw["fsdp"]
    results = ranks.results(case)
    got0 = results[0]
    for r, got in enumerate(results):
        assert int(got["data_size"]) == data_ways and int(got["rows"]) == b // data_ways
        for want_loss, want_gnorm, _ in refs:
            assert float(got["loss"]) == pytest.approx(want_loss, rel=1e-5), r
            assert float(got["grad_norm"]) == pytest.approx(want_gnorm, rel=1e-5), r
        for path in one[2]:
            for key in ("a", "b"):
                mine = got[f"lora/{path}/{key}"]
                np.testing.assert_array_equal(mine, got0[f"lora/{path}/{key}"])
                for _, _, want in refs:
                    np.testing.assert_allclose(mine, want[path][key], atol=1e-6, rtol=1e-4,
                                               err_msg=f"rank {r} {path}/{key}")
        fracs = [float(v) for k, v in got.items()
                 if k.startswith("frac/") and "sharded" not in k]
        sharded = [float(v) for k, v in got.items() if k.startswith("frac/sharded/")]
        assert len(fracs) == len(sharded) == 6
        if mesh_kw["fsdp"] == 2:
            # the sharded tensors halve; the whole block's bytes about halve
            # (the f32 quantization scales an int4 base keeps whole weigh more)
            assert all(f == 0.5 for f in sharded), sharded
            assert all(0.45 < f < (0.7 if case in QUANTIZE else 0.55) for f in fracs), fracs
        else:
            assert all(f == 1.0 for f in fracs + sharded), fracs


MINE = ["dp2", "fsdp2"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return Ranks(tmp_path_factory.mktemp("steps"), MINE)


@pytest.mark.parametrize("case", MINE)
def test_train_step_on_a_mesh_matches_one_process_and_jax(ranks, case):
    """The case's step on two ranks: the loss, grad_norm and the LoRA after
    the update equal the port's one-process step and JAX's step on the same
    mesh, the same on every rank; each rank holds its rows (B / (dp ·
    fsdp)); under fsdp = 2 each rank holds about half of each block's base
    bytes (norm scales and biases stay whole), else all of them."""
    check_case(ranks, case)
