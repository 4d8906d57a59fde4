"""The port's file layer against the JAX package and the `safetensors`
package: the safetensors writer (byte for byte) and reader, the bnb 4-bit
import, the FLUX / Qwen DiT and VAE converters (leaf for leaf, to the bit),
the DiTs loaded block by block from files (within 2e-5 of the upstream
torch goldens, the bound tests/models/test_dit_goldens.py holds the JAX
DiTs to), and the LoRA files (byte for byte, both key formats)."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file as torch_save_file

from qflux_tpu.models import nf4 as jnf4
from qflux_tpu.models import porting as jporting
from qflux_tpu.models.qwen import porting as jqporting
from qflux_tpu.models.qwen import vae as jqvae
from qflux_tpu.utils import lora_io as jlora_io
from qflux_tpu_torch.config import config_from_dict
from qflux_tpu_torch.models import bridge, nf4, porting
from qflux_tpu_torch.models.flux import transformer as tflux
from qflux_tpu_torch.models.flux import vae as tflux_vae
from qflux_tpu_torch.models.qwen import porting as qporting
from qflux_tpu_torch.models.qwen import transformer as tqwen
from qflux_tpu_torch.ops import layers as tlayers
from qflux_tpu_torch.ops.quant import quantize_tree
from qflux_tpu_torch.trainer.base import Trainer
from qflux_tpu_torch.trainer.qwen_edit import _qwen_module_name, _qwen_tree_path
from qflux_tpu_torch.utils import lora_io
from qflux_tpu_torch.utils import safetensors as st
from tests.models.test_nf4_import import NF4, _quantize_nf4_oracle, _serialize
from tests.test_torch_ops import rel_err

FIXTURES = Path(__file__).parent / "fixtures" / "dit_goldens"
GOLDEN_TOL = 2e-5  # relative L2, as tests/models/test_dit_goldens.py


def _fixture(name):
    z = np.load(FIXTURES / f"{name}_tiny.npz")
    return ({k[3:]: z[k] for k in z.files if k.startswith("sd.")},
            {k[3:]: z[k] for k in z.files if k.startswith("in.")}, z["out"])


def _leaves(tree, prefix=""):
    """{"a/b/c": numpy array} of a nested tree (numpy, jax or torch leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def _assert_trees_equal(ours, theirs):
    a, b = _leaves(ours), _leaves(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the safetensors writer and reader

def _torch_tensors():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, generator=g)
    return {"f64": x.double(), "f32": x, "f16": x.half(), "bf16": x.bfloat16(),
            "i64": torch.arange(4, dtype=torch.int64) - 2,
            "i32": torch.arange(3, dtype=torch.int32),
            "i16": torch.tensor([-7, 9], dtype=torch.int16), "i8": torch.tensor([-128, 127],
                                                                                 dtype=torch.int8),
            "u8": torch.arange(250, 256, dtype=torch.uint8), "bool": torch.tensor([True, False]),
            "f8_e4m3": x.to(torch.float8_e4m3fn), "f8_e5m2": x.to(torch.float8_e5m2),
            "f8_e4m3fnuz": x.to(torch.float8_e4m3fnuz), "f8_e5m2fnuz": x.to(torch.float8_e5m2fnuz),
            "zero_d": torch.tensor(2.5), "empty": torch.zeros(0, 4, dtype=torch.float16),
            "a.b.lora_A.weight": x[:2].clone()}


@pytest.mark.parametrize("metadata", [None, {}, {"format": "qflux_tpu.diffusers"}],
                         ids=["none", "empty", "one_key"])
def test_writer_matches_safetensors_torch(tmp_path, metadata):
    tensors = _torch_tensors()
    torch_save_file(tensors, str(tmp_path / "ref.safetensors"), metadata=metadata)
    st.save_file(tensors, tmp_path / "ours.safetensors", metadata=metadata)
    assert ((tmp_path / "ours.safetensors").read_bytes()
            == (tmp_path / "ref.safetensors").read_bytes())


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}], ids=["none", "one_key"])
def test_writer_matches_safetensors_numpy(tmp_path, metadata):
    rng = np.random.default_rng(1)
    arrays = {"f64": rng.standard_normal((2, 3)), "f32": rng.standard_normal(7).astype(np.float32),
              "f16": rng.standard_normal((1, 1, 2)).astype(np.float16),
              "i64": np.arange(3), "i32": np.arange(5, dtype=np.int32),
              "i16": np.array([3, -3], np.int16), "i8": np.array([1, -1], np.int8),
              "u8": np.arange(9, dtype=np.uint8), "bool": np.array([[True], [False]]),
              "zero_d": np.asarray(np.float32(4.0)), "empty": np.zeros((3, 0), np.int32),
              "alpha": np.asarray(16.0, np.float32)}
    np_save_file(arrays, str(tmp_path / "ref.safetensors"), metadata=metadata)
    st.save_file(arrays, tmp_path / "ours.safetensors", metadata=metadata)
    assert ((tmp_path / "ours.safetensors").read_bytes()
            == (tmp_path / "ref.safetensors").read_bytes())
    st.save_file({}, tmp_path / "none.safetensors")
    np_save_file({}, str(tmp_path / "none_ref.safetensors"))
    assert ((tmp_path / "none.safetensors").read_bytes()
            == (tmp_path / "none_ref.safetensors").read_bytes())


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def test_reader_matches_safe_open(tmp_path):
    """A file and a sharded directory written by the package read as
    `safe_open` reads them, tensor for tensor, metadata included."""
    tensors = _torch_tensors()
    torch_save_file(tensors, str(tmp_path / "one.safetensors"), metadata={"format": "pt"})
    ours = st.SafeTensors(tmp_path / "one.safetensors")
    assert ours.metadata == {"format": "pt"} and sorted(ours) == sorted(tensors)
    with safe_open(str(tmp_path / "one.safetensors"), framework="pt") as f:
        for k in f.keys():
            assert _same(ours[k], f.get_tensor(k)), k
    shards = tmp_path / "transformer"
    shards.mkdir()
    names = sorted(tensors)
    torch_save_file({k: tensors[k] for k in names[:7]},
                    str(shards / "diffusion_pytorch_model-00002-of-00002.safetensors"))
    torch_save_file({k: tensors[k] for k in names[7:]},
                    str(shards / "diffusion_pytorch_model-00001-of-00002.safetensors"))
    (shards / "diffusion_pytorch_model.safetensors.index.json").write_text("{}")
    ours = st.SafeTensors(shards)
    assert [f.name for f in ours.files] == sorted(f.name for f in shards.glob("*.safetensors"))
    assert sorted(ours) == names
    assert all(_same(ours[k], tensors[k]) for k in names)
    loaded = st.load_file(shards)
    assert all(_same(loaded[k], tensors[k]) for k in names)


def test_reader_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):
        st.SafeTensors(tmp_path / "nowhere.safetensors")
    with pytest.raises(FileNotFoundError):
        st.SafeTensors(tmp_path)  # a directory without shards
    st.save_file({"x": torch.zeros(2)}, tmp_path / "a.safetensors")
    st.save_file({"x": torch.ones(2)}, tmp_path / "b.safetensors")
    with pytest.raises(ValueError, match="both"):
        st.SafeTensors(tmp_path)
    (tmp_path / "bad.safetensors").write_bytes(b"\xff" * 8 + b"{}")
    with pytest.raises(ValueError, match="exceeds"):
        st.SafeTensors(tmp_path / "bad.safetensors")


# ---------------------------------------------------------------------------
# bnb 4-bit import

def _nf4_inputs():
    """The inputs of tests/models/test_nf4_import.py."""
    rng = np.random.default_rng(0)
    plain = _serialize("blocks.0.ff", rng.standard_normal((16, 64)).astype(np.float32))
    plain["blocks.0.norm.weight"] = np.ones((64,), np.float32)
    return {"plain": plain,
            "double_quant": _serialize("lin", rng.standard_normal((8, 128)).astype(np.float32),
                                       double_quant=True),
            "fp4": _serialize("l", rng.standard_normal((4, 64)).astype(np.float32), kind="fp4"),
            "odd": _serialize("o", rng.standard_normal((3, 5)).astype(np.float32))}


@pytest.mark.parametrize("case", ["plain", "double_quant", "fp4", "odd"])
def test_import_bnb_4bit_matches_jax(case, tmp_path):
    """`import_bnb_4bit` equals JAX's on the nf4 test's inputs, and the
    reader hands out what JAX's `load_safetensors` does for the same file."""
    state = _nf4_inputs()[case]
    assert nf4.is_bnb_4bit(state) and jnf4.is_bnb_4bit(state)
    ours, theirs = nf4.import_bnb_4bit(state), jnf4.import_bnb_4bit(state)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    np_save_file(state, str(tmp_path / "m.safetensors"))
    read = st.SafeTensors(tmp_path / "m.safetensors")
    jread = jporting.load_safetensors(str(tmp_path / "m.safetensors"))
    assert sorted(read) == sorted(jread)
    for k in read:
        np.testing.assert_array_equal(read[k].numpy(), jread[k], err_msg=k)


def test_dequantize_4bit_matches_jax():
    w = np.random.default_rng(2).standard_normal((8, 96)).astype(np.float32)
    packed, absmax = _quantize_nf4_oracle(w, blocksize=64)
    np.testing.assert_array_equal(nf4.dequantize_4bit(packed, absmax, NF4, 64, w.shape),
                                  jnf4.dequantize_4bit(packed, absmax, NF4, 64, w.shape))


# ---------------------------------------------------------------------------
# converters against the JAX package's, leaf for leaf

def test_flux_dit_converter_matches_jax():
    sd, _, _ = _fixture("flux")
    cfg = tflux.FluxConfig.tiny()
    kw = dict(num_layers=cfg.num_layers, num_single_layers=cfg.num_single_layers,
              head_dim=cfg.attention_head_dim)
    ours, unconsumed = porting.convert_with_coverage(porting.convert_flux_transformer, sd,
                                                     strict=True, **kw)
    assert not unconsumed
    _assert_trees_equal(ours, jporting.convert_flux_transformer(sd, **kw))
    # the per-block form gives the same leaves, block by block
    assert porting.count_blocks(sd, "transformer_blocks") == cfg.num_layers
    assert porting.count_blocks(sd, "single_transformer_blocks") == cfg.num_single_layers
    for i in range(cfg.num_layers):
        _assert_trees_equal(porting.flux_dual_block(sd, i, head_dim=cfg.attention_head_dim),
                            bridge._index(ours["dual"], i))


def test_qwen_dit_converter_matches_jax():
    sd, _, _ = _fixture("qwen")
    cfg = tqwen.QwenImageConfig.tiny()
    kw = dict(num_layers=cfg.num_layers, head_dim=cfg.attention_head_dim)
    ours, unconsumed = porting.convert_with_coverage(qporting.convert_qwen_image_transformer,
                                                     sd, strict=True, **kw)
    assert not unconsumed
    _assert_trees_equal(ours, jqporting.convert_qwen_image_transformer(sd, **kw))
    with pytest.raises(ValueError, match="NOT consumed"):
        porting.convert_with_coverage(qporting.convert_qwen_image_transformer,
                                      {**sd, "bogus.weight": np.zeros(1)}, strict=True, **kw)


def _flux_vae_sd(cfg):
    """The random diffusers AutoencoderKL state dict of
    tests/models/test_vae.py:test_vae_converter_roundtrip."""
    rng = np.random.default_rng(0)
    sd = {}

    def conv_(name, ci, co, k=3):
        sd[f"{name}.weight"] = rng.normal(size=(co, ci, k, k)).astype(np.float32) * 0.05
        sd[f"{name}.bias"] = rng.normal(size=(co,)).astype(np.float32) * 0.05

    def gn_(name, c):
        sd[f"{name}.weight"] = np.ones(c, np.float32)
        sd[f"{name}.bias"] = np.zeros(c, np.float32)

    def lin_(name, ci, co):
        sd[f"{name}.weight"] = rng.normal(size=(co, ci)).astype(np.float32) * 0.05
        sd[f"{name}.bias"] = np.zeros(co, np.float32)

    def resnet_(name, ci, co):
        gn_(f"{name}.norm1", ci)
        conv_(f"{name}.conv1", ci, co)
        gn_(f"{name}.norm2", co)
        conv_(f"{name}.conv2", co, co)
        if ci != co:
            conv_(f"{name}.conv_shortcut", ci, co, k=1)

    def mid_(name, c):
        resnet_(f"{name}.resnets.0", c, c)
        resnet_(f"{name}.resnets.1", c, c)
        gn_(f"{name}.attentions.0.group_norm", c)
        for m in ("to_q", "to_k", "to_v"):
            lin_(f"{name}.attentions.0.{m}", c, c)
        lin_(f"{name}.attentions.0.to_out.0", c, c)

    ch = cfg.block_out_channels
    conv_("encoder.conv_in", 3, ch[0])
    cin = ch[0]
    for i, co in enumerate(ch):
        resnet_(f"encoder.down_blocks.{i}.resnets.0", cin, co)
        if i < len(ch) - 1:
            conv_(f"encoder.down_blocks.{i}.downsamplers.0.conv", co, co)
        cin = co
    mid_("encoder.mid_block", ch[-1])
    gn_("encoder.conv_norm_out", ch[-1])
    conv_("encoder.conv_out", ch[-1], 2 * cfg.latent_channels)
    conv_("decoder.conv_in", cfg.latent_channels, ch[-1])
    mid_("decoder.mid_block", ch[-1])
    rev = list(reversed(ch))
    cin = ch[-1]
    for i, co in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            resnet_(f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else co, co)
        if i < len(rev) - 1:
            conv_(f"decoder.up_blocks.{i}.upsamplers.0.conv", co, co)
        cin = co
    gn_("decoder.conv_norm_out", ch[0])
    conv_("decoder.conv_out", ch[0], cfg.out_channels)
    return sd


def _qwen_vae_sd(cfg):
    """The Wan-layout state dict of tests/models/test_vae.py:
    test_convert_qwen_vae_roundtrip (the JAX init tree, serialized)."""
    tree = jqvae.init(jax.random.PRNGKey(0), cfg)
    levels, nres = len(cfg.dim_mult), cfg.num_res_blocks
    sd = {}

    def put_c3(base, p):
        sd[f"{base}.weight"] = np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2)
        sd[f"{base}.bias"] = np.asarray(p["bias"])

    def put_c2(base, p):
        sd[f"{base}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
        sd[f"{base}.bias"] = np.asarray(p["bias"])

    def put_res(base, p):
        sd[f"{base}.norm1.gamma"] = np.asarray(p["norm1"]["gamma"])[:, None, None]
        put_c3(f"{base}.conv1", p["conv1"])
        sd[f"{base}.norm2.gamma"] = np.asarray(p["norm2"]["gamma"])[:, None, None]
        put_c3(f"{base}.conv2", p["conv2"])
        if "conv_shortcut" in p:
            put_c3(f"{base}.conv_shortcut", p["conv_shortcut"])

    def put_lin1x1(base, p):
        sd[f"{base}.weight"] = np.asarray(p["kernel"]).T[:, :, None, None]
        sd[f"{base}.bias"] = np.asarray(p["bias"])

    def put_mid(base, p):
        put_res(f"{base}.resnets.0", p["res_0"])
        sd[f"{base}.attentions.0.norm.gamma"] = np.asarray(p["attn"]["norm"]["gamma"])[:, None,
                                                                                        None]
        put_lin1x1(f"{base}.attentions.0.to_qkv", p["attn"]["to_qkv"])
        put_lin1x1(f"{base}.attentions.0.proj", p["attn"]["proj"])
        put_res(f"{base}.resnets.1", p["res_1"])

    enc = tree["encoder"]
    put_c3("encoder.conv_in", enc["conv_in"])
    k = 0
    for i in range(levels):
        for j in range(nres):
            put_res(f"encoder.down_blocks.{k}", enc[f"down_{i}"][f"res_{j}"])
            k += 1
        if i < levels - 1:
            put_c2(f"encoder.down_blocks.{k}.resample.1", enc[f"down_{i}"]["down"])
            sd[f"encoder.down_blocks.{k}.time_conv.weight"] = np.zeros((1,))
            sd[f"encoder.down_blocks.{k}.time_conv.bias"] = np.zeros((1,))
            k += 1
    put_mid("encoder.mid_block", enc["mid"])
    sd["encoder.norm_out.gamma"] = np.asarray(enc["norm_out"]["gamma"])[:, None, None]
    put_c3("encoder.conv_out", enc["conv_out"])
    z2 = 2 * cfg.z_dim
    sd["quant_conv.weight"] = np.eye(z2, dtype=np.float32)[:, :, None, None, None]
    sd["quant_conv.bias"] = np.zeros((z2,), np.float32)
    dec = tree["decoder"]
    put_c3("decoder.conv_in", dec["conv_in"])
    put_mid("decoder.mid_block", dec["mid"])
    k = 0
    for i in range(levels):
        for j in range(nres + 1):
            put_res(f"decoder.up_blocks.{k}", dec[f"up_{i}"][f"res_{j}"])
            k += 1
        if i < levels - 1:
            put_c2(f"decoder.up_blocks.{k}.resample.1", dec[f"up_{i}"]["up"])
            k += 1
    sd["decoder.norm_out.gamma"] = np.asarray(dec["norm_out"]["gamma"])[:, None, None]
    put_c3("decoder.conv_out", dec["conv_out"])
    sd["post_quant_conv.weight"] = np.eye(cfg.z_dim, dtype=np.float32)[:, :, None, None, None]
    sd["post_quant_conv.bias"] = np.zeros((cfg.z_dim,), np.float32)
    return sd


def test_flux_vae_converter_matches_jax():
    cfg = tflux_vae.VAEConfig.tiny()
    sd = _flux_vae_sd(cfg)
    kw = dict(num_blocks=len(cfg.block_out_channels), layers_per_block=cfg.layers_per_block)
    ours = porting.convert_flux_vae(sd, **kw)
    _assert_trees_equal(ours, jporting.convert_flux_vae(sd, **kw))
    bridge.load_vae_params(tflux_vae.VAE(cfg), ours)  # the decoder loads as it is


def test_qwen_vae_converter_matches_jax():
    from qflux_tpu_torch.models.qwen import vae as tqvae

    cfg = tqvae.QwenVAEConfig.tiny()
    sd = _qwen_vae_sd(jqvae.QwenVAEConfig.tiny())
    kw = dict(num_res_blocks=cfg.num_res_blocks, levels=len(cfg.dim_mult))
    ours = qporting.convert_qwen_vae(sd, **kw)
    _assert_trees_equal(ours, jqporting.convert_qwen_vae(sd, **kw))
    bridge.load_vae_params(tqvae.QwenVAE(cfg, post_quant_conv=True), ours)


# ---------------------------------------------------------------------------
# the tiny DiTs loaded block by block from files, against the torch goldens

def _write(sd, path, dtype=None):
    st.save_file({k: (torch.from_numpy(np.ascontiguousarray(v)) if dtype is None
                      else torch.from_numpy(np.ascontiguousarray(v)).to(dtype))
                  for k, v in sd.items()}, path)
    return path


def test_flux_dit_from_file_matches_torch_golden(tmp_path):
    """Written as two shards, read lazily, converted and loaded one block at
    a time through Trainer.load_model (dit_path), the tiny FLUX DiT
    reproduces the upstream torch module's output; its parameters equal
    the bridge's load of the whole dict's conversion to the bit."""
    sd, inputs, out = _fixture("flux")
    shards = tmp_path / "transformer"
    shards.mkdir()
    keys = sorted(sd)
    _write({k: sd[k] for k in keys[::2]}, shards / "a.safetensors")
    _write({k: sd[k] for k in keys[1::2]}, shards / "b.safetensors")
    tr = Trainer(config_from_dict({"model": {"variant": "test",
                                             "pretrained_model_name_or_path": str(tmp_path)},
                                   "train": {"weight_dtype": "float32"}}), device="cpu")
    tr.load_model()
    cfg = tr.bundle.dit_cfg
    assert cfg == tflux.FluxConfig.tiny() and tr.bundle.vae_params is None
    model = tr.bundle.dit_params
    whole = bridge.load_params(tflux.FluxTransformer(cfg, dtype=torch.float32),
                               porting.convert_flux_transformer(
                                   sd, cfg.num_layers, cfg.num_single_layers,
                                   head_dim=cfg.attention_head_dim))
    for (n, p), (n2, p2) in zip(model.named_parameters(), whole.named_parameters()):
        assert n == n2 and torch.equal(p, p2), n
    with torch.inference_mode():
        got = tflux.forward(model, cfg, *[torch.from_numpy(np.asarray(inputs[k], np.float32))
                                          for k in ("hidden_states", "encoder_hidden_states",
                                                    "pooled_projections", "timestep",
                                                    "img_ids", "txt_ids")],
                            guidance=torch.from_numpy(np.asarray(inputs["guidance"], np.float32)))
    assert rel_err(got.numpy(), out) < GOLDEN_TOL


def test_qwen_dit_from_file_matches_torch_golden(tmp_path):
    sd, inputs, out = _fixture("qwen")
    path = _write(sd, tmp_path / "dit.safetensors")
    tr = Trainer(config_from_dict({"trainer": "QwenImageEditTrainer",
                                   "model": {"variant": "test", "dit_path": str(path)},
                                   "train": {"weight_dtype": "float32"}}), device="cpu")
    tr.load_model()
    cfg = tr.bundle.dit_cfg
    assert cfg == tqwen.QwenImageConfig.tiny()
    shapes = [tuple(int(v) for v in row) for row in inputs["img_shapes"]]
    with torch.inference_mode():
        got = tqwen.forward(tr.bundle.dit_params, cfg,
                            *[torch.from_numpy(np.asarray(inputs[k], np.float32))
                              for k in ("hidden_states", "encoder_hidden_states", "timestep")],
                            shapes)
    assert rel_err(got.numpy(), out) < GOLDEN_TOL


def test_qwen_quantized_blocks_from_file_equal_quantize_tree(tmp_path):
    """Under model.quantize each block is quantized right after it loads:
    the int4-requant leaves equal `quantize_tree` of the whole in-memory
    conversion, to the bit, and the rest of the parameters too."""
    sd, _, _ = _fixture("qwen")
    path = _write(sd, tmp_path / "dit.safetensors", dtype=torch.bfloat16)
    q = {"enabled": True, "dtype": "int4_requant"}
    tr = Trainer(config_from_dict({"trainer": "QwenImageEditTrainer",
                                   "model": {"variant": "test", "dit_path": str(path),
                                             "quantize": q}}), device="cpu")
    tr.load_model()
    cfg = tr.bundle.dit_cfg
    read = st.load_file(path)
    whole = bridge.load_params(tqwen.QwenImageTransformer(cfg, dtype=torch.bfloat16),
                               qporting.convert_qwen_image_transformer(
                                   read, cfg.num_layers, head_dim=cfg.attention_head_dim))
    quantize_tree(whole, config_from_dict({"model": {"quantize": q}}).model.quantize)
    ours = dict(tlayers.iter_dense_paths(tr.bundle.dit_params))
    n_q = 0
    for p, mod in tlayers.iter_dense_paths(whole):
        if mod.q4 is not None:
            n_q += 1
            assert torch.equal(ours[p].q4, mod.q4) and torch.equal(ours[p].scale, mod.scale), p
    assert n_q >= cfg.num_layers * 12 and n_q == sum(m.q4 is not None for m in ours.values())
    sd_ours = tr.bundle.dit_params.state_dict()
    for k, v in whole.state_dict().items():
        assert torch.equal(sd_ours[k], v), k


def test_adapters_read_the_vae_dir_and_refuse_a_missing_dit(tmp_path):
    """A diffusers root with transformer/ and vae/ loads both (the VAE's
    decoder only); a missing DiT raises FileNotFoundError, as in JAX."""
    sd, _, _ = _fixture("flux")
    (tmp_path / "transformer").mkdir()
    (tmp_path / "vae").mkdir()
    _write(sd, tmp_path / "transformer" / "diffusion_pytorch_model.safetensors")
    vcfg = tflux_vae.VAEConfig.tiny()
    vsd = _flux_vae_sd(vcfg)
    _write(vsd, tmp_path / "vae" / "diffusion_pytorch_model.safetensors")
    tr = Trainer(config_from_dict({"model": {"variant": "test",
                                             "pretrained_model_name_or_path": str(tmp_path)}}),
                 device="cpu")
    tr.load_model()
    want = bridge.load_vae_params(tflux_vae.VAE(vcfg), porting.convert_flux_vae(
        vsd, num_blocks=len(vcfg.block_out_channels), layers_per_block=vcfg.layers_per_block))
    for (n, p), (_, p2) in zip(tr.bundle.vae_params.named_parameters(), want.named_parameters()):
        assert torch.equal(p, p2), n
    for trainer, model in (("FluxKontextLoraTrainer", {"pretrained_model_name_or_path":
                                                       str(tmp_path / "vae")}),
                           ("QwenImageEditTrainer", {"dit_path": str(tmp_path / "nowhere")})):
        with pytest.raises(FileNotFoundError):
            Trainer(config_from_dict({"trainer": trainer, "model": {"variant": "test", **model}}),
                    device="cpu").load_model()


# ---------------------------------------------------------------------------
# LoRA files

def _flatten_jax_lora(tree, prefix=()):
    """The JAX package's nested, stacked LoRA tree → the port's flat one."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "a" in v and "b" in v:
            a, b, s = np.asarray(v["a"]), np.asarray(v["b"]), np.asarray(v["scaling"])
            jpath = prefix + (k,)
            if a.ndim == 3:
                for i in range(a.shape[0]):
                    out[lora_io.port_path(jpath, i)] = {"a": a[i], "b": b[i],
                                                         "scaling": np.asarray(s[i])}
            else:
                out[lora_io.port_path(jpath, None)] = {"a": a, "b": b, "scaling": s}
        else:
            out.update(_flatten_jax_lora(v, prefix + (k,)))
    return out


def _jax_lora(family, rank=4, n=2, d=64, seed=0):
    """A JAX LoRA tree with nonzero b on the attention projections of every
    block, the MLPs of the dual / Qwen blocks and a top-level module."""
    rng = np.random.default_rng(seed)

    def leaf(d_in, d_out, stack):
        lead = (stack,) if stack else ()
        return {"a": rng.standard_normal(lead + (d_in, rank)).astype(np.float32),
                "b": rng.standard_normal(lead + (rank, d_out)).astype(np.float32),
                "scaling": np.full(lead, 0.5 + seed, np.float32)}

    attn = {name: leaf(d, d, n) for name in ("to_q", "to_k", "to_v", "to_out", "add_q",
                                             "add_k", "add_v", "add_out")}
    mlp = {"in": leaf(d, 4 * d, n), "out": leaf(4 * d, d, n)}
    if family == "flux":
        return {"dual": {"attn": attn, "img_mlp": mlp},
                "single": {"attn": {n_: leaf(d, d, 3) for n_ in ("to_q", "to_k", "to_v")},
                           "proj_mlp": leaf(d, 4 * d, 3)},
                "x_embedder": leaf(16, d, 0)}
    return {"blocks": {"attn": attn, "txt_mlp": mlp}, "img_in": leaf(16, d, 0)}


def _fns(family):
    if family == "flux":
        return (jlora_io.flux_module_name, jlora_io.flux_tree_path,
                lora_io.flux_module_name, lora_io.flux_tree_path)
    from qflux_tpu.trainer.qwen_edit import _qwen_module_name as jname, _qwen_tree_path as jpath
    return jname, jpath, _qwen_module_name, _qwen_tree_path


@pytest.mark.parametrize("family", ["flux", "qwen"])
def test_lora_file_matches_jax_byte_for_byte(family, tmp_path):
    """The port's LoRA file for a LoRA is the JAX package's file for the
    same LoRA, byte for byte (head_dim 32, so the q/k B permutation acts)."""
    jname, jpath, name, path_fn = _fns(family)
    jtree = _jax_lora(family)
    ours = {p: {k: torch.from_numpy(v) for k, v in leaf.items()}
            for p, leaf in _flatten_jax_lora(jtree).items()}
    theirs_file = jlora_io.save_lora_safetensors(jtree, tmp_path / "jax.safetensors", jname,
                                                 head_dim=32)
    ours_file = lora_io.save_lora_safetensors(ours, tmp_path / "port.safetensors", name,
                                              head_dim=32)
    assert ours_file.read_bytes() == Path(theirs_file).read_bytes()
    (tmp_path / "ckpt").mkdir()
    assert (lora_io.save_lora_safetensors(ours, tmp_path / "ckpt", name, head_dim=32)
            == tmp_path / "ckpt" / lora_io.LORA_FILE_BASE_NAME)
    # and the round trip through the port's reader gives the tree back
    back = lora_io.load_lora_safetensors(tmp_path / "ckpt", path_fn, head_dim=32)
    flat = _flatten_jax_lora(jtree)
    assert sorted(back) == sorted(flat)
    for p in flat:
        for k in ("a", "b", "scaling"):
            np.testing.assert_array_equal(back[p][k], flat[p][k], err_msg=f"{p}/{k}")


@pytest.mark.parametrize("family", ["flux", "qwen"])
def test_lora_import_matches_jax(family, tmp_path):
    """A JAX-written LoRA file, and the same LoRA under PEFT keys (with and
    without `.default`, without `.alpha`), import as JAX imports them."""
    jname, jpath, _, path_fn = _fns(family)
    jtree = _jax_lora(family, seed=1)
    f = jlora_io.save_lora_safetensors(jtree, tmp_path / "jax.safetensors", jname, head_dim=32)
    want = _flatten_jax_lora(jlora_io.load_lora_safetensors(f, jpath, head_dim=32))
    got = lora_io.load_lora_safetensors(f, path_fn, head_dim=32)
    flat = jlora_io.export_lora(jtree, jname, head_dim=32)
    peft = {}
    for i, (k, v) in enumerate(sorted(flat.items())):
        if k.endswith(".alpha"):
            continue
        k = "base_model.model." + k[len("transformer."):]
        if i % 2:
            k = k.replace(".lora_A.weight", ".lora_A.default.weight").replace(
                ".lora_B.weight", ".lora_B.default.weight")
        peft[k] = v
    assert lora_io.classify_lora_weight(peft) == jlora_io.classify_lora_weight(peft) == "peft"
    cases = [(got, want),
             (lora_io.import_lora(peft, path_fn, head_dim=32),
              _flatten_jax_lora(jlora_io.import_lora(peft, jpath, head_dim=32)))]
    for ours, theirs in cases:
        assert sorted(ours) == sorted(theirs)
        for p in theirs:
            for k in ("a", "b", "scaling"):
                np.testing.assert_array_equal(ours[p][k], theirs[p][k], err_msg=f"{p}/{k}")
    gap = {k.replace("transformer.transformer_blocks.0.", "transformer.transformer_blocks.5."): v
           for k, v in flat.items()}
    with pytest.raises(ValueError, match="non-contiguous"):
        jlora_io.import_lora(gap, jpath, head_dim=32)
    with pytest.raises(ValueError, match="non-contiguous"):
        lora_io.import_lora(gap, path_fn, head_dim=32)


def test_build_lora_reads_pretrained_weight(tmp_path):
    """model.lora.pretrained_weight: Trainer.build_lora returns the file's
    LoRA on the device, which merges into the model."""
    tr = Trainer(config_from_dict({"model": {"variant": "test"}}), device="cpu")
    tr.load_model()
    lora = tr.build_lora()
    gen = torch.Generator().manual_seed(0)
    for leaf in lora.values():
        leaf["b"].normal_(generator=gen)
    f = lora_io.save_lora_safetensors(lora, tmp_path / "l.safetensors",
                                      tr.adapter.lora_module_name_fn, head_dim=32)
    tr.config.model.lora.pretrained_weight = str(f)
    back = tr.build_lora()
    assert sorted(back) == sorted(lora)
    for p in lora:
        for k in ("a", "b", "scaling"):
            assert torch.equal(back[p][k], lora[p][k]), f"{p}/{k}"
    tlayers.merge_lora(tr.bundle.dit_params, back)
    tlayers.merge_lora(tr.bundle.dit_params, None)


@pytest.mark.parametrize("family", ["flux", "qwen"])
def test_smoke_checkpoints_load_at_tiny_width(tmp_path, family):
    """chip_smoke.py's synthetic diffusers checkpoints (drawn here on the CPU
    at the tiny widths; on the card at the published ones) cover every
    tensor the converters read and nothing else, load through
    Trainer.load_model, and predict finite images."""
    import chip_smoke
    from qflux_tpu_torch.models.qwen import vae as tqvae

    if family == "flux":
        cfg = dataclasses.replace(tflux.FluxConfig.tiny(), num_layers=1, num_single_layers=2)
        sd = chip_smoke.flux_state_dict(cfg, seed=1, device="cpu")
        vsd = chip_smoke.flux_vae_state_dict(tflux_vae.VAEConfig.tiny(), seed=2, device="cpu")
        full = porting.convert_flux_transformer
        args = (cfg.num_layers, cfg.num_single_layers)
        trainer = "FluxKontextLoraTrainer"
    else:
        cfg = dataclasses.replace(tqwen.QwenImageConfig.tiny(), num_layers=3)
        sd = chip_smoke.qwen_state_dict(cfg, seed=1, device="cpu")
        vsd = chip_smoke.qwen_vae_state_dict(tqvae.QwenVAEConfig.tiny(), seed=2, device="cpu")
        full = qporting.convert_qwen_image_transformer
        args = (cfg.num_layers,)
        trainer = "QwenImageEditTrainer"
    _, unconsumed = porting.convert_with_coverage(full, sd, *args, head_dim=32, strict=True)
    assert not unconsumed
    n_bytes = chip_smoke.write_checkpoint(tmp_path / "ckpt", sd, vsd)
    assert n_bytes > sum(t.numel() * t.element_size() for t in sd.values())
    index = json.loads((tmp_path / "ckpt" / "transformer"
                        / "diffusion_pytorch_model.safetensors.index.json").read_text())
    assert sorted(index["weight_map"]) == sorted(sd)
    tr = Trainer(config_from_dict({"trainer": trainer, "model": {
        "variant": "test", "pretrained_model_name_or_path": str(tmp_path / "ckpt")},
        "predict": {"num_inference_steps": 2}}), device="cpu")
    tr.load_model()
    assert tr.bundle.dit_cfg == cfg and tr.bundle.vae_params is not None
    rng = np.random.default_rng(3)
    gh, gw = tr.adapter.latent_grid(16, 16)
    request = (chip_smoke._request if family == "flux" else chip_smoke._qwen_request)
    images = tr.predict_from_embeddings(request(rng, cfg, gh, gw, 1), 16, 16)
    assert images.dtype == np.uint8 and images.shape == (1, 16, 16, 3)
    assert tr.last_predict["latents_finite"]
    from qflux_tpu_torch.models import bridge as tbridge

    conv = full(st.SafeTensors(tmp_path / "ckpt" / "transformer"), *args, head_dim=32)
    model = (tflux.FluxTransformer if family == "flux" else tqwen.QwenImageTransformer)(
        cfg, dtype=torch.bfloat16)
    want = tbridge.load_params(model, conv)
    assert chip_smoke._params_equal(tr.bundle.dit_params, want) > 0
