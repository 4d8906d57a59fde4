"""The port's distribution modules in one process, against the JAX package.

`qflux_tpu_torch/parallel/{mesh,partitioning,collectives}.py` against
`qflux_tpu/parallel/`: `MeshConfig.resolve` over a grid of sizes and device
counts (the errors included), the rules' clipped specs leaf for leaf
against JAX's `spec_tree_from_rules` on the tiny FLUX and Qwen trees (full
precision and quantized), the collectives' single-process fast paths; then
what the port adds: `build_mesh` without a process group, tp > 1 naming
item 8b, the attention dispatch's ring / stub refusals, the ring on one rank
equal to the flash hop to the bit, the rows each data rank takes and the
noise it draws, the quantized leaves as frozen parameters and the blocks
run as module calls (so FSDP2's hooks see them).  Multi-process cases are
tests/test_torch_distributed*.py.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from qflux_tpu.models.flux import transformer as jflux
from qflux_tpu.models.qwen import transformer as jqwen
from qflux_tpu.ops import quant as jquant
from qflux_tpu.parallel import MeshConfig as JMeshConfig, build_mesh as j_build_mesh
from qflux_tpu.parallel import collectives as jcol
from qflux_tpu.parallel.partitioning import (clip_spec_to_shape as j_clip, mmdit_rules as j_rules,
                                             spec_tree_from_rules)
from qflux_tpu_torch import losses as tlosses
from qflux_tpu_torch.config import config_from_dict
from qflux_tpu_torch.models import bridge
from qflux_tpu_torch.models.flux import transformer as tflux
from qflux_tpu_torch.models.qwen import transformer as tqwen
from qflux_tpu_torch.ops import attention as tattn
from qflux_tpu_torch.ops import flash_attention as tfa
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.ops import ring_attention as tring
from qflux_tpu_torch.parallel import collectives as tcol
from qflux_tpu_torch.parallel import mesh as tmesh
from qflux_tpu_torch.parallel import partitioning as tpart
from qflux_tpu_torch.trainer.base import Trainer, train_config
from qflux_tpu_torch.trainer.train_step import TrainStepConfig, draw_noise_and_sigma
from tests.test_torch_ops import random_tree


@pytest.fixture(autouse=True)
def _restore_meshes():
    """Each test leaves a world-of-one mesh active in both packages."""
    yield
    j_build_mesh(JMeshConfig(dp=1, fsdp=1))
    tmesh.build_mesh(tmesh.MeshConfig(dp=1, fsdp=1))


# ---------------------------------------------------------------------------
# mesh

SIZES = [(1, -1, 1, 1), (2, -1, 1, 1), (1, 4, 2, 1), (2, 2, 1, 2), (-1, 2, 1, 1),
         (3, -1, 1, 1), (-1, -1, 1, 1), (2, 2, 2, 2), (1, 1, 1, 8), (8, 1, 1, 1), (1, 3, 1, 1)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_mesh_config_resolve_matches_jax(sizes, n):
    """The sizes, or the error and its message, JAX's `resolve` gives."""
    dp, fsdp, tp, sp = sizes
    def run(cls):
        try:
            return cls(dp=dp, fsdp=fsdp, tp=tp, sp=sp).resolve(n)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(tmesh.MeshConfig) == run(JMeshConfig)


def test_build_mesh_without_a_process_group():
    """A world of one: every axis 1 (fsdp's -1 absorbs the one device), no
    groups, the active mesh; JAX's errors where the config needs more than
    one rank; tp > 1 raises naming item 8b, before any other check."""
    mesh = tmesh.build_mesh(tmesh.MeshConfig())
    assert mesh.shape == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
    assert tmesh.active_mesh() is mesh and mesh.device_mesh is None
    assert mesh.data_size == 1 and mesh.data_index == 0 and mesh.sp_group is None
    assert tmesh.local_batch_size(mesh, 4) == 4 and tmesh.data_axis_size(mesh) == 1
    with pytest.raises(ValueError, match="needs more than the 1 devices"):
        tmesh.build_mesh(tmesh.MeshConfig(dp=2, fsdp=1))
    for cfg in (tmesh.MeshConfig(tp=2), tmesh.MeshConfig(dp=1, fsdp=1, tp=4, sp=2)):
        with pytest.raises(NotImplementedError, match="item 8b"):
            tmesh.build_mesh(cfg)
    assert tpart.shard_base(nn.Linear(2, 2), mesh).weight.__class__ is nn.Parameter


def test_mesh_layout_is_row_major():
    """Ranks over (dp, fsdp, tp, sp) row-major, sp innermost; the data
    groups are the dp × fsdp ranks sharing a (tp, sp) pair."""
    shape = {"dp": 2, "fsdp": 2, "tp": 1, "sp": 2}
    sizes = tuple(shape[a] for a in tmesh.AXIS_ORDER)
    assert [tmesh._coords(r, sizes)["sp"] for r in range(8)] == [0, 1] * 4
    assert tmesh._coords(5, sizes) == {"dp": 1, "fsdp": 0, "tp": 0, "sp": 1}
    assert tmesh.data_ranks(shape) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    m = tmesh.Mesh(shape=shape, coords=tmesh._coords(6, sizes), rank=6, world=8)
    assert m.data_size == 4 and m.data_index == 3


@pytest.mark.parametrize("shape,grouped,shards,exchanges", [
    ({"dp": 2}, True, False, False),
    ({"fsdp": 2}, True, True, True),
    ({"dp": 2, "sp": 2}, True, False, True),
    ({}, True, False, False),  # a world of one under a process group
    ({"fsdp": 2}, False, False, False),
])
def test_what_a_mesh_shards_and_exchanges(shape, grouped, shards, exchanges):
    """The base is sharded only over fsdp > 1 ranks of a process group (at
    fsdp = 1 FSDP2 would cost its hooks and save nothing); a step exchanges
    tensors with other ranks under a sharded base or the ring."""
    mesh = tmesh.Mesh(shape={**dict.fromkeys(tmesh.AXIS_ORDER, 1), **shape},
                      coords=dict.fromkeys(tmesh.AXIS_ORDER, 0),
                      device_mesh=object() if grouped else None)
    assert (mesh.shards_base, mesh.step_collectives) == (shards, exchanges)


def test_oom_under_step_collectives_raises_at_once(monkeypatch, caplog):
    """Where the step exchanges tensors with other ranks (fsdp > 1), the
    rank that runs out of memory raises at once: the step asks no other
    rank (the others wait in its collectives and would never answer) and
    the Trainer does not retry."""
    from types import SimpleNamespace

    from qflux_tpu_torch.trainer.train_step import make_train_step

    mesh = tmesh.Mesh(shape={"dp": 1, "fsdp": 2, "tp": 1, "sp": 1},
                      coords=dict.fromkeys(tmesh.AXIS_ORDER, 0), device_mesh=object())
    tmesh.set_active_mesh(mesh)

    def never(flag):
        raise AssertionError("any_across reached under a step with collectives")

    monkeypatch.setattr(tcol, "any_across", never)
    calls = []

    def predict(*a):
        calls.append(1)
        raise torch.OutOfMemoryError("CUDA out of memory")

    lora = tlayers.mark_trainable({"x": {"a": torch.ones(2, 1), "b": torch.zeros(1, 2),
                                         "scaling": torch.tensor(1.0)}})
    step = make_train_step(predict, tlosses.MseLoss(), torch.optim.SGD(
        [lora["x"]["a"], lora["x"]["b"]], lr=0.1), lambda i: 0.1)
    base = nn.Module()
    base.x = tlayers.Dense(2, 2)
    trainer = SimpleNamespace(mesh=mesh, generator=torch.Generator().manual_seed(0),
                              bundle=SimpleNamespace(dit_params=base), lora=lora)
    batch = {"image_latents": torch.zeros(1, 4, 2)}
    with pytest.raises(torch.OutOfMemoryError):
        Trainer._run_step(trainer, step, batch, tlosses.DataShard(), None, None, None)
    assert calls == [1]
    assert "other ranks cannot join a retry" in caplog.text


def test_trainer_raises_where_the_mesh_needs_more_ranks():
    """A Trainer whose config.mesh needs two ranks, in one process, raises
    JAX's resolve error (no silent fallback to one device)."""
    cfg = train_config("test")
    cfg.mesh.dp, cfg.mesh.fsdp = 2, 1
    with pytest.raises(ValueError, match="needs more than the 1 devices"):
        Trainer(cfg, "cpu")
    cfg.mesh.dp, cfg.mesh.tp = 1, 2
    with pytest.raises(NotImplementedError, match="item 8b"):
        Trainer(cfg, "cpu")


# ---------------------------------------------------------------------------
# partitioning

CLIP_CASES = [(("fsdp", "tp"), (8, 6)), (("fsdp", "tp"), (6, 6)), (("fsdp",), (3,)),
              (("fsdp",), (12, 4)), (("tp", "fsdp"), (4, 8, 6)), ((), (5, 5)),
              ((("dp", "fsdp"),), (16, 3)), ((("dp", "fsdp"),), (6, 3)), (None, (4,))]


@pytest.mark.parametrize("mesh_kw", [{"dp": 1, "fsdp": 4, "tp": 2}, {"dp": 2, "fsdp": 2, "tp": 1}])
@pytest.mark.parametrize("spec,shape", CLIP_CASES)
def test_clip_spec_to_shape_matches_jax(mesh_kw, spec, shape):
    from jax.sharding import PartitionSpec as P

    jmesh = j_build_mesh(JMeshConfig(**mesh_kw))
    want = j_clip(None if spec is None else P(*spec), shape, jmesh)
    got = tpart.clip_spec_to_shape(spec, shape, {**mesh_kw, "sp": 1})
    assert got == tuple(want)


def _jax_specs(tree, mesh_kw):
    jmesh = j_build_mesh(JMeshConfig(**mesh_kw))
    specs = spec_tree_from_rules(tree, j_rules(), jmesh)
    return {k: tuple(v) for k, v in _flat_specs(specs).items()}


def _flat_specs(tree, prefix=""):
    from jax.sharding import PartitionSpec as P

    out = {}
    for k, v in tree.items():
        if isinstance(v, P):
            out[prefix + k] = v
        else:
            out.update(_flat_specs(v, f"{prefix}{k}/"))
    return out


def _qcfg(dtype):
    return config_from_dict({"model": {"quantize": {"enabled": True, "dtype": dtype}}}
                            ).model.quantize


@pytest.fixture(scope="module")
def trees():
    fc, qc = jflux.FluxConfig.tiny(), jqwen.QwenImageConfig.tiny()
    flux = random_tree(lambda: jflux.init(jax.random.PRNGKey(0), fc, jnp.float32), 0)
    qwen = random_tree(lambda: jqwen.init(jax.random.PRNGKey(0), qc, jnp.float32), 1)
    return {"flux": (flux, lambda: tflux.FluxTransformer(tflux.FluxConfig.tiny(),
                                                         dtype=torch.float32)),
            "qwen": (qwen, lambda: tqwen.QwenImageTransformer(tqwen.QwenImageConfig.tiny(),
                                                              dtype=torch.float32))}


@pytest.mark.parametrize("mesh_kw", [{"dp": 1, "fsdp": 2, "tp": 1}, {"dp": 1, "fsdp": 4, "tp": 2},
                                     {"dp": 2, "fsdp": 4, "tp": 1}])
@pytest.mark.parametrize("model", ["flux", "qwen"])
@pytest.mark.parametrize("form", [None, "int4_requant", "int8", "int8_dynamic"])
def test_mmdit_specs_match_jax_leaf_for_leaf(trees, model, form, mesh_kw):
    """`param_specs` over the port's model (weights bridged from the JAX
    tree, quantized by JAX's `quantize_tree` where `form` is set): every
    parameter's JAX path and clipped spec equal JAX's `spec_tree_from_rules`
    leaf (its stacked-layer dim, always replicated, dropped); the shard dim
    is the fsdp entry's dim in the port's layout (transposed for `weight`
    and `q`); the requant factors take the scale's spec."""
    tree, make = trees[model]
    if form is not None:
        tree = jquant.quantize_tree(tree, _qcfg(form))
    tree = jax.tree.map(np.asarray, tree)
    jspecs = _jax_specs(tree, mesh_kw)
    module = bridge.load_params(make(), tree)
    specs = tpart.param_specs(module, {**mesh_kw, "sp": 1})
    seen = set()
    for name, (path, spec, dim) in specs.items():
        param = module.get_parameter(name)
        if name.rsplit(".", 1)[-1] in ("rq_f", "rq_s_vec"):
            assert path.endswith("/kernel_scale") and dim is None
            continue
        stacked = name.split(".")[0] in ("dual", "single", "blocks")
        want = jspecs[path]
        if stacked:
            assert want[:1] in ((), (None,))
            want = want[1:]
        assert spec == want, (name, path)
        seen.add(path)
        aligned = [None] * (param.dim() - len(spec)) + list(spec)
        if "fsdp" in aligned:
            j = aligned.index("fsdp")
            transposed = name.endswith((".weight", ".q"))
            assert dim == (param.dim() - 1 - j if transposed else j), name
            assert param.shape[dim] % mesh_kw["fsdp"] == 0
        else:
            assert dim is None
    assert seen == set(jspecs), set(jspecs) ^ seen


def test_rules_tables_match_jax():
    """The rule sets, pattern for pattern and spec for spec."""
    from qflux_tpu.parallel import partitioning as jpart

    for jr, tr in ((jpart.mmdit_rules(), tpart.mmdit_rules()),
                   (jpart.lora_rules(), tpart.lora_rules()),
                   (jpart.batch_rules(), tpart.batch_rules())):
        assert [p.pattern for p, _ in jr._rules] == [p.pattern for p, _ in tr._rules]
        assert [tuple(s) for _, s in jr._rules] == [s for _, s in tr._rules]


# ---------------------------------------------------------------------------
# collectives, one process

def test_collectives_single_process_fastpaths():
    """JAX's tests/parallel/test_collectives.py on the port, and the same
    answers as JAX's functions."""
    assert tcol.is_main_process() and jcol.is_main_process()
    assert tcol.process_count() == jcol.process_count() == 1
    tcol.barrier()
    out = tcol.all_gather_host({"x": np.arange(3.0)})
    assert out["x"].shape == (1, 3)
    np.testing.assert_array_equal(out["x"], jcol.all_gather_host({"x": np.arange(3.0)})["x"])
    t = {"y": np.ones(2)}
    assert tcol.broadcast_from_main(t) is t
    assert tcol.mean_across_hosts(2.5) == jcol.mean_across_hosts(2.5) == 2.5
    assert tcol.shard_validation_samples(5) == jcol.shard_validation_samples(5) == [0, 1, 2, 3, 4]
    assert tcol.shard_validation_samples(5, rank=1, world=2) == [1, 3]
    imgs = [np.zeros((2, 2), np.uint8)]
    assert tcol.gather_validation_images([3], imgs, 4) == ([3], imgs)
    assert tcol.any_across(True) and not tcol.any_across(False)


# ---------------------------------------------------------------------------
# the attention dispatch and the ring on one rank

def _qkv(seed, s=64, h=2, d=16, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((2, s, h, d)).astype(np.float32)).to(dtype)
            for _ in range(3)]


def test_dispatch_refuses_ring_without_sp_and_stub():
    """impl="ring" without an active mesh whose sp > 1 raises JAX's
    ValueError; "stub" names the "Do not port" list; under an sp = 1 mesh
    "auto" stays on K3's route (its plain version here)."""
    q, k, v = _qkv(0)
    tmesh.build_mesh(tmesh.MeshConfig(dp=1, fsdp=1, sp=1))
    with pytest.raises(ValueError, match="needs an active mesh with sp > 1"):
        tattn.dot_product_attention(q, k, v, impl="ring")
    with pytest.raises(NotImplementedError, match="Do not port"):
        tattn.dot_product_attention(q, k, v, impl="stub")
    assert torch.equal(tattn.dot_product_attention(q, k, v), tfa.flash_attention(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_on_one_rank_is_the_flash_hop_to_the_bit(dtype):
    """One rank, one hop: the merge with an empty accumulator (weights 0 and
    1) returns the hop's out, and the backward the hop's gradients, to the
    bit (what smoke phase L(b) holds on the card against K3 / K4), with
    padded rows and two segments."""
    q, k, v = (t.requires_grad_() for t in _qkv(1, dtype=dtype))
    seg = torch.ones(2, 64, dtype=torch.int32)
    seg[0, 40:] = 0
    seg[1, 20:] = 2
    out = tring.ring_attention(q, k, v, None, seg)
    ref, lse = tfa.flash_fwd_reference(q.detach(), k.detach(), v.detach(), seg, seg,
                                       1.0 / 4.0)
    assert torch.equal(out, ref)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(dtype)
    out.backward(dout)
    want = tfa.flash_bwd_from_residuals(q.detach(), k.detach(), v.detach(), seg, seg, ref, lse,
                                        dout, 1.0 / 4.0)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)


def test_ring_sharded_refuses_an_indivisible_sequence():
    q, k, v = _qkv(2, s=63)
    mesh = tmesh.Mesh(shape={"dp": 1, "fsdp": 1, "tp": 1, "sp": 2},
                      coords=dict.fromkeys(tmesh.AXIS_ORDER, 0))
    with pytest.raises(ValueError, match="not divisible by mesh.sp = 2"):
        tring.ring_attention_sharded(q, k, v, mesh)


# ---------------------------------------------------------------------------
# the data split: rows, noise, losses

def _trainer_on(shape, index, accum=1):
    """A Trainer (never loaded) whose mesh says this rank is data index
    `index` of `shape`."""
    t = object.__new__(Trainer)
    t.config = train_config("test")
    t.config.train.gradient_accumulation_steps = accum
    sizes = tuple(shape[a] for a in tmesh.AXIS_ORDER)
    rank = next(r for r in range(int(np.prod(sizes)))
                if tmesh._coords(r, sizes)["dp"] * shape["fsdp"]
                + tmesh._coords(r, sizes)["fsdp"] == index)
    t.mesh = tmesh.Mesh(shape=shape, coords=tmesh._coords(rank, sizes), rank=rank)
    return t


@pytest.mark.parametrize("accum", [1, 2])
def test_each_data_rank_takes_its_rows_of_every_microbatch(accum):
    """dp × fsdp = 4 ranks over a batch of 8: each takes its rows of each
    global microbatch (JAX's reshape to [accum, B / accum], each microbatch
    split over the data ranks), shared ids whole and per-sample ids split;
    together the ranks hold every row once."""
    shape = {"dp": 2, "fsdp": 2, "tp": 1, "sp": 1}
    b = 8
    emb = {"image_latents": np.arange(b)[:, None] * np.ones((1, 3)),
           "img_ids": np.zeros((5, 3)), "rope_x": np.arange(b * 2 * 4).reshape(b, 2, 4),
           "txt_ids": np.zeros((b, 3))}
    seen = []
    for index in range(4):
        out, data = _trainer_on(shape, index, accum)._rank_rows(emb)
        rows = out["image_latents"][:, 0].astype(int).tolist()
        m = b // (4 * accum)
        assert rows == [i * (b // accum) + index * m + j for i in range(accum) for j in range(m)]
        assert out["img_ids"].shape == (5, 3) and out["txt_ids"].shape == (b, 3)
        np.testing.assert_array_equal(out["rope_x"], emb["rope_x"][rows])
        assert (data.index, data.size) == (index, 4)
        seen += rows
    assert sorted(seen) == list(range(b))


def test_rank_rows_errors_and_the_replicated_batch(caplog):
    """JAX's divisibility error (by dp × fsdp, times the microbatches
    here); a batch of one trains replicated with JAX's one warning."""
    shape = {"dp": 2, "fsdp": 1, "tp": 1, "sp": 1}
    with pytest.raises(ValueError, match=r"must be divisible by dp×fsdp = 2"):
        _trainer_on(shape, 0)._rank_rows({"image_latents": np.zeros((3, 4))})
    with pytest.raises(ValueError, match="times grad_accum_steps = 2"):
        _trainer_on(shape, 0, accum=2)._rank_rows({"image_latents": np.zeros((2, 4))})
    t = _trainer_on(shape, 1)
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            out, data = t._rank_rows({"image_latents": np.zeros((1, 4))})
            assert out["image_latents"].shape == (1, 4) and data.size == 1
    assert sum("REPLICATED" in r.message for r in caplog.records) == 1


def test_each_rank_draws_the_global_noise_and_keeps_its_rows():
    """Every rank draws the noise and σ of the whole global microbatch from
    the same generator state and keeps its rows: the ranks' draws together
    are the one-process draw, and the generator ends where it would."""
    cfg = TrainStepConfig(timestep_sampling="logit_normal")
    lat = torch.zeros(6, 4, 3)
    one = draw_noise_and_sigma(torch.Generator().manual_seed(3), lat, cfg)
    gens = []
    for index in range(3):
        g = torch.Generator().manual_seed(3)
        nz, sg = draw_noise_and_sigma(g, lat[:2], cfg, tlosses.DataShard(index, 3))
        assert torch.equal(nz, one[0][2 * index:2 * index + 2])
        assert torch.equal(sg, one[1][2 * index:2 * index + 2])
        gens.append(g.get_state())
    end = torch.Generator().manual_seed(3)
    draw_noise_and_sigma(end, lat, cfg)
    assert all(torch.equal(s, end.get_state()) for s in gens)


class _Sum(tlosses.DataShard):
    """A DataShard whose sum over ranks is a given total (one process)."""

    def __init__(self, size, total):
        super().__init__(0, size, None)
        object.__setattr__(self, "total", total)

    def sum(self, t):
        return torch.as_tensor(self.total, dtype=t.dtype)


def test_loss_shares_sum_to_the_global_loss():
    """Each rank's share of the global loss: the mean reductions of its
    rows over the number of ranks, AttentionMaskMseLoss over the global
    Σa (eps once), "sum" its own; the shares of two halves add up to the
    whole batch's loss."""
    rng = np.random.default_rng(0)
    pred, tgt = (torch.from_numpy(rng.standard_normal((4, 6, 3)).astype(np.float32))
                 for _ in range(2))
    mask = torch.from_numpy((rng.uniform(size=(4, 6)) > 0.3).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2, (4, 1, 1)).astype(np.float32))
    for loss, kw in ((tlosses.MseLoss(), {}), (tlosses.MseLoss(), {"weighting": w}),
                     (tlosses.MaskEditLoss(), {"edit_mask": mask}),
                     (tlosses.AttentionMaskMseLoss(), {"attention_mask": mask}),
                     (tlosses.MseLoss(reduction="sum"), {})):
        whole = loss(pred, tgt, **kw)
        parts = []
        for half in (slice(0, 2), slice(2, 4)):
            kwh = {k: v[half] for k, v in kw.items()}
            data = _Sum(2, float(mask.sum()))
            parts.append(loss(pred[half], tgt[half], data=data, **kwh))
        assert float(sum(parts)) == pytest.approx(float(whole), rel=1e-6), loss


# ---------------------------------------------------------------------------
# what FSDP2 needs of the model

def test_quantized_leaves_are_frozen_parameters():
    """Every quantized form holds its leaves as frozen parameters (FSDP2
    shards parameters, not buffers), contiguous, and the bridge counts them
    as loaded."""
    qc = jqwen.QwenImageConfig.tiny()
    tree = random_tree(lambda: jqwen.init(jax.random.PRNGKey(0), qc, jnp.float32), 1)
    for form in ("int4_requant", "int4", "int8", "fp8_e4m3", "int8_dynamic"):
        jq = jax.tree.map(np.asarray, jquant.quantize_tree(tree, _qcfg(form)))
        model = bridge.load_params(tqwen.QwenImageTransformer(tqwen.QwenImageConfig.tiny(),
                                                              dtype=torch.float32), jq)
        node = model.blocks[0].attn.to_q
        names = {n for n, _ in node.named_parameters()}
        assert node.q_form == form and "weight" not in names and not list(node.buffers())
        for name in tlayers.QUANT_LEAVES:
            t = getattr(node, name)
            if t is not None:
                assert isinstance(t, nn.Parameter) and not t.requires_grad and name in names
                assert t.is_contiguous()


@pytest.mark.parametrize("model", ["flux", "qwen"])
def test_blocks_run_as_module_calls(trees, model):
    """The DiT's forward calls the root and every block as modules (FSDP2's
    pre-forward hooks gather a sharded block there), in training (under
    the checkpoint) and without autograd."""
    tree, make = trees[model]
    module = bridge.load_params(make(), jax.tree.map(np.asarray, tree))
    calls = []
    for name, blocks in tpart.block_lists(module):
        for i, blk in enumerate(blocks):
            blk.register_forward_pre_hook(lambda m, a, n=f"{name}/{i}": calls.append(n))
    module.register_forward_pre_hook(lambda m, a: calls.append("root"))
    rng = np.random.default_rng(0)
    cfg = module.cfg
    s_img, s_txt = 8, 4

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    for grad in (False, True):
        calls.clear()
        with torch.set_grad_enabled(grad):
            if model == "flux":
                ids = torch.zeros(s_img, 3)
                tflux.forward(module, cfg, f32(1, s_img, cfg.in_channels),
                              f32(1, s_txt, cfg.joint_attention_dim),
                              f32(1, cfg.pooled_projection_dim), torch.full((1,), 0.5),
                              ids, torch.zeros(s_txt, 3), guidance=torch.ones(1))
            else:
                tqwen.forward(module, cfg, f32(1, s_img, cfg.in_channels),
                              f32(1, s_txt, cfg.joint_attention_dim), torch.full((1,), 0.5),
                              img_shapes=[(1, 2, 4)])
        n = sum(len(b) for _, b in tpart.block_lists(module))
        assert calls[0] == "root" and len(calls) == n + 1, calls
