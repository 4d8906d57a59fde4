"""FLUX.2-Klein model adapter: weights, encoding (the cache pass, training
from pixels, predict on raw images), velocity prediction and decoding for
the port's Trainer.

Counterpart of qflux_tpu/trainer/flux2_klein.py.  The DiT is the FLUX
MMDiT body (`models/flux/transformer.py`) under another config: 4-axis RoPE
(axes (32, 32, 32, 32) over ids (t, h, w, l)), no pooled text projection,
guidance embeds, joint_attention_dim 3 · 2560.  The batch is the JAX
package's Klein cache format:

    image_latents          [B, S_img, 64]    packed target latents, normalized
    control_latents        [B, S_ctl, 64]    packed control latents, normalized
    prompt_embeds          [B, S_txt, 7680]  Qwen3 layers (9, 18, 27), concatenated
    pooled_prompt_embeds   [B, 7680]         their sequence mean (not read by the DiT)
    img_ids                [S_img + S_ctl, 4] (set, h, w, 0); controls set 1, 2, …
    txt_ids                [S_txt, 4]        (0, 0, 0, l)

Latents are the FLUX VAE encoder's, 2×2-packed and then normalized by the
checkpoint VAE's BatchNorm statistics ((z − bn.running_mean) /
sqrt(bn.running_var + 1e-5) over the 64 packed channels; zeros and ones,
then sqrt(1 + 1e-5), where the file has none, as in JAX); `decode_latents`
undoes it before the VAE decoder.  The text encoder is Qwen3
(`models/flux2/text_encoder.py`), built on first use (`qwen3_encoder`), so a
fit from the embedding cache never holds its 16 GB of f32.  Like JAX's
adapter this one has no `prepare_cached_embeddings` (the cache holds
img_ids whole) and no mixed-size predict path.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path

import numpy as np
import torch

from qflux_tpu_torch.models import porting
from qflux_tpu_torch.models.bridge import load_vae_params
from qflux_tpu_torch.models.flux import transformer as flux
from qflux_tpu_torch.models.flux import vae as flux_vae
from qflux_tpu_torch.models.flux2 import text_encoder as qwen3
from qflux_tpu_torch.models.tokenizers import load_tokenizer
from qflux_tpu_torch.ops.packing import pack_latents, unpack_latents
from qflux_tpu_torch.trainer.flux_kontext import (ModelBundle, SimpleTokenizer,
                                                  _load_dir, attn_impl_from_config,
                                                  checkpoint_dirs, quantize_config,
                                                  remat_policy_from_config, require_vae)
from qflux_tpu_torch.utils.lora_io import flux_module_name, flux_tree_path
from qflux_tpu_torch.utils.safetensors import SafeTensors

# the architecture keys of a diffusers config.json the DiT consumes
_CONFIG_KEYS = ("num_layers", "num_single_layers", "attention_head_dim", "num_attention_heads",
                "joint_attention_dim", "in_channels", "out_channels", "patch_size",
                "guidance_embeds")


def flux2_config(**overrides) -> flux.FluxConfig:
    """The FLUX.2-Klein topology (klein-4B's layout): 8 dual + 24 single
    blocks, 24 heads × 128, 4-axis RoPE, no pooled text projection."""
    base = dict(num_layers=8, num_single_layers=24, attention_head_dim=128,
                num_attention_heads=24, joint_attention_dim=3 * 2560,
                pooled_projection_dim=0, guidance_embeds=True,
                axes_dims_rope=(32, 32, 32, 32))
    base.update(overrides)
    return flux.FluxConfig(**base)


def flux2_config_from_json(path) -> flux.FluxConfig:
    """The DiT topology from a checkpoint's diffusers config.json, as JAX's:
    an architecture key this forward does not consume (not one of
    `_CONFIG_KEYS`, axes_dims_rope, pooled_projection_dim or mlp_ratio, and
    not "_"-prefixed) raises ValueError, unless QFLUX_FLUX2_ALLOW_UNKNOWN=1
    makes it a warning."""
    raw = json.loads(Path(path).read_text())
    overrides = {k: raw[k] for k in _CONFIG_KEYS if k in raw and raw[k] is not None}
    if raw.get("axes_dims_rope"):
        overrides["axes_dims_rope"] = tuple(raw["axes_dims_rope"])
    if raw.get("pooled_projection_dim") is not None:
        overrides["pooled_projection_dim"] = raw["pooled_projection_dim"]
    known = set(_CONFIG_KEYS) | {"axes_dims_rope", "pooled_projection_dim", "mlp_ratio"}
    unknown = sorted(k for k in raw if k not in known and not k.startswith("_"))
    if unknown:
        msg = (f"flux2 config.json carries architecture keys this implementation does not "
               f"consume: {unknown} — refusing to load. Audit each key against "
               f"models/flux/transformer.py and set QFLUX_FLUX2_ALLOW_UNKNOWN=1 to proceed.")
        if os.environ.get("QFLUX_FLUX2_ALLOW_UNKNOWN") != "1":
            raise ValueError(msg)
        logging.warning(msg)
    if raw.get("mlp_ratio") is not None:
        overrides["mlp_ratio"] = raw["mlp_ratio"]
    return flux2_config(**overrides)


def latent_ids_4d(height: int, width: int, set_id: int = 0) -> np.ndarray:
    """[(h·w), 4] ids (set, h, w, 0), row-major."""
    ids = np.zeros((height, width, 4), np.float32)
    ids[..., 0] = set_id
    ids[..., 1] = np.arange(height)[:, None]
    ids[..., 2] = np.arange(width)[None, :]
    return ids.reshape(-1, 4)


def text_ids_4d(seq_len: int) -> np.ndarray:
    """[L, 4] ids (0, 0, 0, l)."""
    ids = np.zeros((seq_len, 4), np.float32)
    ids[:, 3] = np.arange(seq_len)
    return ids


def qwen3_encoder(bundle: ModelBundle):
    """The bundle's Qwen3, built by its factory on first use; raises where
    the checkpoint had no text_encoder dir."""
    if not bundle.text_params and bundle.text_factory is not None:
        bundle.text_params = bundle.text_factory()
    if "qwen3" not in bundle.text_params:
        raise FileNotFoundError("no Qwen3 text encoder was loaded: the checkpoint has no "
                                "text_encoder directory (set model.text_encoder_path)")
    return bundle.text_params["qwen3"]


def load_qwen3_tokenizer(root, tokenizer_path=None):
    """The first-party Qwen3 (Qwen2 BPE) tokenizer of <root>/tokenizer (or
    model.tokenizer_path), imported here; where that import or those files
    fail, JAX's hash fallback (`SimpleTokenizer(150000, 512)`) with its
    warning."""
    try:
        if root is None:
            raise FileNotFoundError("no checkpoint directory")
        return load_tokenizer(Path(tokenizer_path or Path(root) / "tokenizer"))
    except FileNotFoundError as e:
        logging.warning("tokenizer unavailable (%s); hash fallback", e)
        return SimpleTokenizer(150000, 512)


@dataclasses.dataclass(frozen=True)
class Flux2KleinAdapter:
    cfg: flux.FluxConfig
    attn_impl: str = "auto"
    remat: bool = True
    remat_policy: str = "dots"
    vae_scale: int = 8
    hidden_states_layers: tuple[int, ...] = (9, 18, 27)

    lora_module_name_fn = staticmethod(flux_module_name)
    lora_tree_path_fn = staticmethod(flux_tree_path)
    default_lora_targets = (r"attn/(to_q|to_k|to_v|to_out|add_q|add_k|add_v|add_out)",)

    @classmethod
    def load(cls, config, device, dtype=torch.bfloat16,
             mesh=None) -> tuple["Flux2KleinAdapter", ModelBundle]:
        """The DiT in `dtype`, the FLUX VAE and Qwen3 in float32 on
        `device`.  Variant "test": JAX's tiny set (`flux2_config` at 2 + 2
        blocks, 4 heads × 32, axes (8, 8, 8, 8), joint_attention_dim 3 · 48;
        the tiny VAE; `Qwen3Config.tiny()` picked at layers (1, 2, 3); zero
        / unit BatchNorm statistics; `SimpleTokenizer(510, 64)`), drawn from
        generators seeded 0 (DiT), 1 (VAE) and 2 (Qwen3).  Otherwise the
        full widths: `flux2_config()` (or the checkpoint's config.json,
        `flux2_config_from_json`), `VAEConfig()`, Qwen3-4B at layers (9,
        18, 27); synthetic from the same seeds without a checkpoint, else
        read as JAX reads it (`flux_kontext.checkpoint_dirs`): the DiT block
        by block (`transformer.load_from_state_dict`, quantized per block
        under model.quantize and sharded over `mesh`) with the depth the file has, the VAE with
        its `bn.running_mean` / `bn.running_var`, Qwen3 from
        model.text_encoder_path or <root>/text_encoder one layer at a time,
        the tokenizer from <root>/tokenizer (`load_qwen3_tokenizer`).
        Qwen3 is built on first use (`qwen3_encoder`)."""
        model = config.model
        test = model.variant == "test"
        device = torch.device(device)
        if test:
            tcfg, vae_cfg = qwen3.Qwen3Config.tiny(), flux_vae.VAEConfig.tiny()
            packed = vae_cfg.latent_channels * 4
            dit_cfg = flux2_config(num_layers=2, num_single_layers=2, attention_head_dim=32,
                                   num_attention_heads=4, joint_attention_dim=3 * tcfg.hidden_size,
                                   in_channels=packed, out_channels=packed,
                                   axes_dims_rope=(8, 8, 8, 8))
            layers = (1, 2, 3)
        else:
            tcfg, vae_cfg, dit_cfg = qwen3.Qwen3Config(), flux_vae.VAEConfig(), flux2_config()
            layers = (9, 18, 27)
            packed = 64
        files = checkpoint_dirs(model)
        text_cfgs = {"qwen3": tcfg, "hidden_states_layers": layers,
                     "bn_mean": np.zeros(packed, np.float32),
                     "bn_std": np.ones(packed, np.float32)}
        bundle = ModelBundle(dit_cfg=dit_cfg, dit_params=None, vae_cfg=vae_cfg,
                             text_cfgs=text_cfgs)
        if files is None:
            bundle.dit_params = flux.init(torch.Generator(device).manual_seed(0), dit_cfg,
                                          device, dtype)
            bundle.vae_params = flux_vae.init(torch.Generator(device).manual_seed(1), vae_cfg,
                                              device)

            def text_factory():
                return {"qwen3": qwen3.init(torch.Generator(device).manual_seed(2), tcfg, device)}
        else:
            dit_path, vae_path = files
            cfg_json = (dit_path if dit_path.is_dir() else dit_path.parent) / "config.json"
            if cfg_json.exists():
                dit_cfg = flux2_config_from_json(cfg_json)
            sd = SafeTensors(dit_path)
            dit_cfg = bundle.dit_cfg = dataclasses.replace(
                dit_cfg, num_layers=porting.count_blocks(sd, "transformer_blocks"),
                num_single_layers=porting.count_blocks(sd, "single_transformer_blocks"))
            bundle.dit_params = flux.load_from_state_dict(sd, dit_cfg, device, dtype,
                                                          quantize=quantize_config(config),
                                                          mesh=mesh)
            if vae_path is not None:
                vsd = SafeTensors(vae_path)
                tree = _load_dir(vae_path, porting.convert_flux_vae, "the VAE",
                                 num_blocks=len(vae_cfg.block_out_channels),
                                 layers_per_block=vae_cfg.layers_per_block)
                bundle.vae_params = load_vae_params(flux_vae.VAE(vae_cfg, device=device), tree)
                mean = (vsd["bn.running_mean"].float().numpy() if "bn.running_mean" in vsd
                        else np.zeros(64, np.float32))
                var = (vsd["bn.running_var"].float().numpy() if "bn.running_var" in vsd
                       else np.ones(64, np.float32))
                text_cfgs["bn_mean"], text_cfgs["bn_std"] = mean, np.sqrt(var + 1e-5)
            root = Path(model.pretrained_model_name_or_path or ".")
            te_path = Path(model.text_encoder_path or root / "text_encoder")

            def text_factory():
                if not te_path.exists():
                    return {}
                enc = qwen3.load_from_state_dict(SafeTensors(te_path), tcfg, device)
                logging.info("loaded Qwen3 from %s", te_path)
                return {"qwen3": enc}
        bundle.text_factory = text_factory
        if test:
            bundle.tokenizers = {"qwen3": SimpleTokenizer(tcfg.vocab_size - 2, 64)}
        else:
            root = (Path(model.pretrained_model_name_or_path or ".") if files is not None
                    else None)
            bundle.tokenizers = {"qwen3": load_qwen3_tokenizer(root, model.tokenizer_path)}
        remat_cfg = config.mesh.remat
        adapter = cls(dit_cfg, attn_impl=attn_impl_from_config(config),
                      remat=remat_cfg != "none", remat_policy=remat_policy_from_config(remat_cfg),
                      vae_scale=vae_cfg.downscale, hidden_states_layers=layers)
        return adapter, bundle

    # ======================================================================
    # encoding

    @torch.no_grad()
    def encode_prompt(self, bundle: ModelBundle, prompts: list[str],
                      max_sequence_length: int = 512):
        """(prompt_embeds [B, L, 3 · D] f32, pooled [B, 3 · D] = their mean
        over all L positions, txt_ids [L, 4] numpy): the hash tokenizer's
        ids at min(max_sequence_length, its max_length) with mask ids != 0,
        or the first-party tokenizer's chat template (thinking off) padded
        to max_sequence_length; Qwen3's picked hidden states."""
        enc = qwen3_encoder(bundle)
        tok = bundle.tokenizers["qwen3"]
        if isinstance(tok, SimpleTokenizer):
            ids = tok(prompts, max_length=min(max_sequence_length, tok.max_length))
            mask = (ids != 0).astype(np.int64)
        else:
            texts = [tok.apply_chat_template([{"role": "user", "content": p}], tokenize=False,
                                             add_generation_prompt=True, enable_thinking=False)
                     for p in prompts]
            out = tok(texts, padding="max_length", truncation=True,
                      max_length=max_sequence_length, return_tensors="np")
            ids, mask = out["input_ids"], out["attention_mask"]
        layers = bundle.text_cfgs.get("hidden_states_layers", self.hidden_states_layers)
        embeds = qwen3.encode(enc, bundle.text_cfgs["qwen3"], ids, attention_mask=mask,
                              hidden_states_layers=layers)
        return embeds, embeds.mean(dim=1), text_ids_4d(embeds.shape[1])

    def _bn(self, bundle: ModelBundle, like: torch.Tensor):
        return tuple(torch.as_tensor(np.asarray(bundle.text_cfgs[k])).to(like.device, like.dtype)
                     for k in ("bn_mean", "bn_std"))

    @torch.no_grad()
    def encode_vae_image(self, bundle: ModelBundle, images) -> torch.Tensor:
        """uint8 NHWC [B, H, W, 3] → packed latents [B, S, 64] normalized by
        the BatchNorm statistics, f32."""
        require_vae(bundle)
        dev = next(bundle.vae_params.parameters()).device
        x = torch.as_tensor(np.asarray(images)).to(dev, torch.float32) / 127.5 - 1.0
        packed = pack_latents(flux_vae.encode(bundle.vae_params, bundle.vae_cfg, x))
        mean, std = self._bn(bundle, packed)
        return (packed - mean) / std

    def latent_grid(self, height: int, width: int) -> tuple[int, int]:
        return (height // (self.vae_scale * 2), width // (self.vae_scale * 2))

    def prepare_embeddings(self, bundle: ModelBundle, batch: dict,
                           max_sequence_length: int = 512) -> dict:
        """A batch of pixels (uint8 "image", "control", "control_*",
        "prompt") → the embedding set, as JAX's: the target and control
        latents (controls in the order control, then control_* by name,
        set ids 1, 2, …), img_ids [S_img + S_ctl, 4]; no control makes an
        empty control_latents and the target's ids alone."""
        images = np.asarray(batch["image"])
        b, height, width = images.shape[:3]
        gh, gw = self.latent_grid(height, width)
        prompt_embeds, pooled, txt_ids = self.encode_prompt(bundle, list(batch["prompt"]),
                                                            max_sequence_length)
        image_latents = self.encode_vae_image(bundle, images)
        ids, controls = [latent_ids_4d(gh, gw, 0)], []
        ctl_keys = [k for k in ("control",) if k in batch]
        ctl_keys += sorted(k for k in batch if k.startswith("control_") and k != "control")
        for i, key in enumerate(ctl_keys):
            ctl = np.asarray(batch[key])
            ch, cw = self.latent_grid(ctl.shape[1], ctl.shape[2])
            controls.append(self.encode_vae_image(bundle, ctl))
            ids.append(latent_ids_4d(ch, cw, i + 1))
        out = {"image_latents": image_latents, "prompt_embeds": prompt_embeds,
               "pooled_prompt_embeds": pooled, "txt_ids": txt_ids,
               "img_ids": np.concatenate(ids)}
        if controls:
            out["control_latents"] = torch.cat(controls, dim=1)
        else:
            out["control_latents"] = image_latents.new_zeros((b, 0, image_latents.shape[-1]))
            out["img_ids"] = ids[0]
        if "edit_mask" in batch:
            out["edit_mask"] = np.asarray(batch["edit_mask"])
        return out

    def cache_embeddings(self, bundle: ModelBundle, item_batch: dict,
                         max_sequence_length: int = 512) -> tuple[dict, dict]:
        """One sample (a bs=1 batch) → (arrays, hash-key names) for
        `EmbeddingCacheManager.save`: JAX's eight keys (the ids whole)."""
        emb = self.prepare_embeddings(bundle, item_batch, max_sequence_length)
        empty_pe, empty_pooled, _ = self.encode_prompt(bundle, [""], max_sequence_length)
        h = item_batch["file_hashes"]
        h = h[0] if isinstance(h, list) else h

        def host(t):
            return t[0].float().cpu().numpy()

        arrays = {
            "image_latents": host(emb["image_latents"]),
            "control_latents": host(emb["control_latents"]),
            "prompt_embeds": host(emb["prompt_embeds"]),
            "pooled_prompt_embeds": host(emb["pooled_prompt_embeds"]),
            "empty_prompt_embeds": host(empty_pe),
            "empty_pooled_prompt_embeds": host(empty_pooled),
            "img_ids": np.asarray(emb["img_ids"]),
            "txt_ids": np.asarray(emb["txt_ids"]),
        }
        hash_keys = {
            "image_latents": h["image_hash"],
            "control_latents": h.get("controls_sum_hash", h["image_hash"]),
            "prompt_embeds": h["prompt_hash"],
            "pooled_prompt_embeds": h["prompt_hash"],
            "empty_prompt_embeds": h["empty_prompt_hash"],
            "empty_pooled_prompt_embeds": h["empty_prompt_hash"],
            "img_ids": h["main_hash"], "txt_ids": h["prompt_hash"],
        }
        return arrays, hash_keys

    def negative_embeddings(self, bundle: ModelBundle, negative_prompt: str,
                            batch: dict, max_sequence_length: int = 512) -> dict:
        b = len(batch["prompt"]) if "prompt" in batch else 1
        pe, pooled, _ = self.encode_prompt(bundle, [negative_prompt] * b, max_sequence_length)
        return {"neg_prompt_embeds": pe, "neg_pooled_prompt_embeds": pooled}

    def predict_velocity(self, params, batch, latents, sigma):
        """DiT forward over [noisy_target, control] with no pooled input,
        guidance ones where the batch has none; sliced back to the target
        tokens."""
        ctrl = batch["control_latents"].to(latents.dtype)
        inp = torch.cat([latents, ctrl], dim=1)
        guidance = batch.get("guidance")
        if guidance is None and self.cfg.guidance_embeds:
            guidance = torch.ones_like(sigma)
        pred = flux.forward(
            params, self.cfg, inp, batch["prompt_embeds"].to(latents.dtype), None,
            sigma, batch["img_ids"], batch["txt_ids"], guidance=guidance,
            segment_ids=batch.get("segment_ids"), attn_impl=self.attn_impl, remat=self.remat,
            remat_policy=self.remat_policy)
        return pred[:, :latents.shape[1]]

    @torch.inference_mode()
    def decode_latents(self, bundle: ModelBundle, packed, height: int, width: int) -> np.ndarray:
        """Packed latents → the BatchNorm normalization undone → uint8 RGB
        images [B, H, W, 3]."""
        require_vae(bundle)
        gh, gw = self.latent_grid(height, width)
        mean, std = self._bn(bundle, packed)
        lat = unpack_latents(packed * std + mean, gh * 2, gw * 2)
        img = flux_vae.decode(bundle.vae_params, bundle.vae_cfg, lat.float())
        img = (torch.clamp(img, -1, 1) + 1) * 127.5
        return torch.round(img).to(torch.uint8).cpu().numpy()
