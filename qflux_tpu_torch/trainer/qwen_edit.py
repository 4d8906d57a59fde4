"""Qwen-Image-Edit model adapter: weights, encoding (the cache pass and
training from pixels), cached-embedding prep, velocity prediction and
decoding for the port's Trainer.

Counterpart of qflux_tpu/trainer/qwen_edit.py.  The batch is the JAX
package's embedding-cache format:

    image_latents          [B, S_img, 64]   packed target latents (training)
    control_latents        [B, S_ctl, 64]   packed control latents
    prompt_embeds          [B, S_txt, 3584] Qwen2.5-VL hidden states
    prompt_embeds_mask     [B, S_txt]       1 = real token, 0 = padding
    img_shapes_arr         [n_planes, 3] or [B, n_planes, 3]  (frame, h, w)
                                            per image plane (→ RoPE tables)
    neg_prompt_embeds(_mask)                optional, for true-CFG
    segment_ids            [B, S_txt+S_img+S_ctl] optional (0 = padding)
    edit_mask              [B, S_img] optional (MaskEditLoss)

Under gradient accumulation the train step (trainer/train_step.py) splits
every key with a leading batch axis into microbatches (prompt_embeds_mask
and segment_ids among them) and shares img_shapes_arr and the rope_* tables,
as the JAX step does.

`prepare_embeddings` makes that format from a batch of pixels, as JAX's:
the prompt inside the edit chat template with the control images' tokens
in place of <|image_pad|> through Qwen2.5-VL (`models/qwen/vl_encoder.py`,
f32), its first `drop_idx` template tokens dropped and each sample re-packed
to at most max_sequence_length; the 3D VAE encoder's packed latents for the
target and every control image.  The tokenizer is the port's Qwen2 BPE
(`models/tokenizers.py`) from the checkpoint's tokenizer dir where
those files exist, else `SimpleTokenizer` (the JAX package's hash fallback,
not a vocabulary; a first-party Qwen2 byte-level BPE is ROADMAP.md queue 1
item 5c).
"""

from __future__ import annotations

import dataclasses
import logging
import re
from pathlib import Path

import numpy as np
import torch

from qflux_tpu_torch.models.bridge import load_vae_params
from qflux_tpu_torch.models.porting import count_blocks
from qflux_tpu_torch.models.qwen import transformer as qwen_dit
from qflux_tpu_torch.models.qwen import vae as qwen_vae
from qflux_tpu_torch.models.qwen import vl_encoder as vl
from qflux_tpu_torch.models.qwen.porting import convert_qwen_vae
from qflux_tpu_torch.models.tokenizers import load_tokenizer
from qflux_tpu_torch.ops.packing import pack_latents, unpack_latents
from qflux_tpu_torch.ops.rope import qwen_rope
from qflux_tpu_torch.trainer.flux_kontext import (ModelBundle, SimpleTokenizer,
                                                  attn_impl_from_config, checkpoint_dirs,
                                                  quantize_config, remat_policy_from_config,
                                                  require_vae)
from qflux_tpu_torch.utils.safetensors import SafeTensors

# the diffusers QwenImageEditPipeline template (drop_idx: its 64 prefix tokens)
EDIT_TEMPLATE = (
    "<|im_start|>system\nDescribe the key features of the input image "
    "(color, shape, size, texture, objects, background), then explain how the "
    "user's text instruction should alter or modify the image. Generate a new "
    "image that meets the user's requirements while maintaining consistency "
    "with the original input where appropriate.<|im_end|>\n"
    "<|im_start|>user\n<|vision_start|><|image_pad|><|vision_end|>{}<|im_end|>\n"
    "<|im_start|>assistant\n"
)
EDIT_DROP_IDX = 64
_VISION_MARKERS = re.compile(r"(<\|vision_start\|>|<\|image_pad\|>|<\|vision_end\|>)")


def vl_encoder(bundle: ModelBundle) -> dict:
    """{"vision", "text"} of the bundle, built by its factory on first use;
    raises where the checkpoint had no text_encoder dir."""
    if not bundle.text_params and bundle.text_factory is not None:
        bundle.text_params = bundle.text_factory()
    if "text" not in bundle.text_params:
        raise FileNotFoundError("no Qwen2.5-VL text encoder was loaded: the checkpoint has no "
                                "text_encoder directory (set model.text_encoder_path)")
    return bundle.text_params


def load_vl_tokenizer(root, tokenizer_path=None):
    """The first-party Qwen2 tokenizer of <root>/tokenizer (or
    model.tokenizer_path), imported here; where that import or those files
    fail, the JAX package's hash fallback with its warning."""
    try:
        if root is None:
            raise FileNotFoundError("no checkpoint directory")
        return load_tokenizer(Path(tokenizer_path or Path(root) / "tokenizer"))
    except FileNotFoundError as e:
        logging.warning("tokenizer unavailable (%s); using hash fallback", e)
        return SimpleTokenizer(140000, 1024)


_QWEN_BLOCK_MODULES = {
    ("attn", "to_q"): "attn.to_q", ("attn", "to_k"): "attn.to_k",
    ("attn", "to_v"): "attn.to_v", ("attn", "to_out"): "attn.to_out.0",
    ("attn", "add_q"): "attn.add_q_proj", ("attn", "add_k"): "attn.add_k_proj",
    ("attn", "add_v"): "attn.add_v_proj", ("attn", "add_out"): "attn.to_add_out",
    ("img_mlp", "in"): "img_mlp.net.0.proj", ("img_mlp", "out"): "img_mlp.net.2",
    ("txt_mlp", "in"): "txt_mlp.net.0.proj", ("txt_mlp", "out"): "txt_mlp.net.2",
    ("img_mod", "proj"): "img_mod.1", ("txt_mod", "proj"): "txt_mod.1",
}
_QWEN_BLOCK_PATHS = {v: k for k, v in _QWEN_BLOCK_MODULES.items()}


def _qwen_module_name(path: tuple[str, ...], layer):
    """The JAX tree's LoRA path → the diffusers QwenImageTransformer2DModel
    module name (qflux_tpu/trainer/qwen_edit.py:_qwen_module_name)."""
    if path[0] == "blocks":
        sub = _QWEN_BLOCK_MODULES.get(tuple(path[1:]))
        return None if sub is None else f"transformer_blocks.{layer}.{sub}"
    return ".".join(path)


def _qwen_tree_path(module: str):
    parts = module.split(".")
    if parts[0] == "transformer_blocks":
        sub = _QWEN_BLOCK_PATHS.get(".".join(parts[2:]))
        return None if sub is None else (("blocks",) + sub, int(parts[1]))
    return tuple(parts), None


@dataclasses.dataclass(frozen=True)
class QwenImageEditAdapter:
    cfg: qwen_dit.QwenImageConfig
    attn_impl: str = "auto"
    remat: bool = True
    remat_policy: str = "dots"
    vae_scale: int = 8
    template: str = EDIT_TEMPLATE
    drop_idx: int = EDIT_DROP_IDX

    lora_module_name_fn = staticmethod(_qwen_module_name)
    lora_tree_path_fn = staticmethod(_qwen_tree_path)
    default_lora_targets = (
        r"attn/(to_q|to_k|to_v|to_out|add_q|add_k|add_v|add_out)",
    )

    @classmethod
    def load(cls, config, device, dtype=torch.bfloat16,
             mesh=None) -> tuple["QwenImageEditAdapter", ModelBundle]:
        """The DiT in `dtype`, the VAE and Qwen2.5-VL in float32 on
        `device`, at the widths of the variant's config: the published
        Qwen-Image-Edit topology (`QwenImageConfig()`: 60 blocks, 24 heads ×
        128; `QwenVAEConfig()`; `VLVisionConfig()` / `VLTextConfig()`: 32
        vision blocks × 1,280, 28 LM layers × 3,584), or for variant "test"
        the tiny DiT (joint_attention_dim 48, the tiny VL's width;
        in_channels 16 = 4 · the tiny VAE's z_dim 4; out_channels 4), the
        tiny VAE and the tiny VL with JAX's special tokens (500, 502, 503)
        and hash tokenizer (`SimpleTokenizer(480, 512)`).  With
        model.quantize enabled each DiT block is quantized as soon as it
        exists, so only one block's full-precision weights exist at a time;
        with `mesh` (a parallel/mesh.Mesh that shards the base) each block
        is then sharded.

        With model.pretrained_model_name_or_path or model.dit_path, the
        weights are read from a diffusers checkpoint as the JAX adapter
        reads them (`flux_kontext.checkpoint_dirs`): the DiT block by block
        (`transformer.load_from_state_dict`) with the depth the file has (a
        missing DiT raises FileNotFoundError); the VAE (encoder and decoder)
        from its directory when there is one (without it `vae_params` is
        None and what needs it raises); Qwen2.5-VL from
        model.text_encoder_path or <root>/text_encoder, one block at a time
        (`vl_encoder.load_from_state_dict`), where it exists; the tokenizer
        from <root>/tokenizer (`load_vl_tokenizer`).  Without a checkpoint
        the weights are synthetic, drawn on `device` from generators seeded
        0 (DiT), 1 (VAE), 2 (vision tower) and 3 (LM).  Qwen2.5-VL, read or
        drawn, is built on first use (`vl_encoder`), so a fit from the
        embedding cache or a predict from embeddings never holds its 33 GB
        of f32."""
        model = config.model
        test = model.variant == "test"
        if test:
            dit_cfg = dataclasses.replace(qwen_dit.QwenImageConfig.tiny(), joint_attention_dim=48,
                                          in_channels=16, out_channels=4)
            vae_cfg = qwen_vae.QwenVAEConfig.tiny()
            text_cfgs = {"vision": vl.VLVisionConfig.tiny(), "text": vl.VLTextConfig.tiny(),
                         "tokens": vl.VLSpecialTokens(500, 502, 503)}
        else:
            dit_cfg, vae_cfg = qwen_dit.QwenImageConfig(), qwen_vae.QwenVAEConfig()
            text_cfgs = {"vision": vl.VLVisionConfig(), "text": vl.VLTextConfig(),
                         "tokens": vl.VLSpecialTokens()}
        device = torch.device(device)
        files = checkpoint_dirs(model)
        bundle = ModelBundle(dit_cfg=dit_cfg, dit_params=None, vae_cfg=vae_cfg,
                             text_cfgs=text_cfgs)
        if files is None:
            bundle.dit_params = qwen_dit.init(torch.Generator(device).manual_seed(0), dit_cfg,
                                              device, dtype, quantize=quantize_config(config),
                                              mesh=mesh)
            bundle.vae_params = qwen_vae.init(torch.Generator(device).manual_seed(1), vae_cfg,
                                              device)

            def text_factory():
                return {"vision": vl.vision_init(torch.Generator(device).manual_seed(2),
                                                 text_cfgs["vision"], device),
                        "text": vl.text_init(torch.Generator(device).manual_seed(3),
                                             text_cfgs["text"], device)}
        else:
            sd = SafeTensors(files[0])
            dit_cfg = bundle.dit_cfg = dataclasses.replace(
                dit_cfg, num_layers=count_blocks(sd, "transformer_blocks"))
            bundle.dit_params = qwen_dit.load_from_state_dict(sd, dit_cfg, device, dtype,
                                                              quantize=quantize_config(config),
                                                              mesh=mesh)
            if files[1] is not None:
                vsd = SafeTensors(files[1])
                bundle.vae_params = load_vae_params(
                    qwen_vae.QwenVAE(vae_cfg, device=device,
                                     post_quant_conv="post_quant_conv.weight" in vsd),
                    convert_qwen_vae(vsd, num_res_blocks=vae_cfg.num_res_blocks,
                                     levels=len(vae_cfg.dim_mult)))
            root = Path(model.pretrained_model_name_or_path or ".")
            te_path = Path(model.text_encoder_path or root / "text_encoder")

            def text_factory():
                if not te_path.exists():
                    return {}
                vision, text = vl.load_from_state_dict(SafeTensors(te_path), text_cfgs["vision"],
                                                       text_cfgs["text"], device)
                logging.info("loaded Qwen2.5-VL from %s", te_path)
                return {"vision": vision, "text": text}
        bundle.text_factory = text_factory
        if test:
            bundle.tokenizers = {"vl": SimpleTokenizer(480, 512)}
        else:
            root = (Path(model.pretrained_model_name_or_path or ".") if files is not None
                    else None)
            bundle.tokenizers = {"vl": load_vl_tokenizer(root, model.tokenizer_path)}
        remat_cfg = config.mesh.remat
        adapter = cls(dit_cfg, attn_impl=attn_impl_from_config(config),
                      remat=remat_cfg != "none", remat_policy=remat_policy_from_config(remat_cfg),
                      vae_scale=vae_cfg.downscale)
        return adapter, bundle

    # ======================================================================
    # encoding (the cache pass, training from pixels, predict on raw images)

    def _tokenize_with_images(self, bundle: ModelBundle, text: str,
                              n_image_tokens: list[int]) -> np.ndarray:
        """Template text with <|vision_start|> / <|image_pad|> /
        <|vision_end|> markers → int64 ids, each <|image_pad|> expanded to
        its image's token count."""
        toks: vl.VLSpecialTokens = bundle.text_cfgs["tokens"]
        tok = bundle.tokenizers["vl"]
        special = {"<|vision_start|>": toks.vision_start_token_id,
                   "<|vision_end|>": toks.vision_end_token_id}
        ids: list[int] = []
        img_i = 0
        for part in _VISION_MARKERS.split(text):
            if not part:
                continue
            if part == "<|image_pad|>":
                ids.extend([toks.image_token_id] * n_image_tokens[img_i])
                img_i += 1
            elif part in special:
                ids.append(special[part])
            elif isinstance(tok, SimpleTokenizer):
                ids.extend(int(i) for i in tok([part])[0] if i != 0)
            else:  # the first-party tokenizer
                ids.extend(tok(part, add_special_tokens=False)["input_ids"])
        return np.asarray(ids, np.int64)

    def format_prompt(self, prompt: str, n_images: int) -> str:
        return self.template.format(prompt)

    @torch.no_grad()
    def encode_prompt(self, bundle: ModelBundle, prompts: list[str],
                      vl_images: list[list[np.ndarray]], max_sequence_length: int = 1024):
        """(prompt_embeds [B, L, D] f32, prompt_embeds_mask [B, L] int32, as
        JAX's device array holds it) on the encoder's device: each prompt in the template with its images'
        tokens, the batch padded to its longest sample, the vision tower's
        features in place of the image tokens, the LM's hidden_states[-1];
        then the template prefix dropped (`drop_idx` tokens; under the hash
        tokenizer the prefix's own length, as in JAX) and each sample
        re-packed to L = min(its longest, max_sequence_length)."""
        enc = vl_encoder(bundle)
        vcfg: vl.VLVisionConfig = bundle.text_cfgs["vision"]
        tcfg: vl.VLTextConfig = bundle.text_cfgs["text"]
        toks: vl.VLSpecialTokens = bundle.text_cfgs["tokens"]
        msz2 = vcfg.spatial_merge_size ** 2
        per_sample = []
        for prompt, images in zip(prompts, vl_images):
            pre = [vl.preprocess_image(np.asarray(im), vcfg) for im in images]
            grids = [g for _, g in pre]
            ids = self._tokenize_with_images(bundle, self.format_prompt(prompt, len(images)),
                                             [t * h * w // msz2 for t, h, w in grids])
            per_sample.append((ids, [p for p, _ in pre], grids))
        b = len(per_sample)
        max_len = max(len(ids) for ids, _, _ in per_sample)
        input_ids = np.zeros((b, max_len), np.int64)
        attn = np.zeros((b, max_len), np.int64)
        for i, (ids, _, _) in enumerate(per_sample):
            input_ids[i, :len(ids)] = ids
            attn[i, :len(ids)] = 1
        text = enc["text"]
        dev = text.embed_tokens.device
        embeds = text.embed_tokens[torch.from_numpy(input_ids).to(dev)]
        for i, (_, patches, grids) in enumerate(per_sample):
            if patches:
                vis = vl.vision_forward(enc["vision"], vcfg, np.concatenate(patches), grids)
                mask = torch.from_numpy(input_ids[i] == toks.image_token_id).to(dev)
                embeds[i, mask] = vis.to(embeds.dtype)
        pos = vl.get_rope_index(input_ids, [g for _, _, gs in per_sample for g in gs],
                                vcfg.spatial_merge_size, toks, attention_mask=attn)
        hidden = vl.text_forward(text, tcfg, embeds, pos, attention_mask=attn)
        drop = self.drop_idx
        if isinstance(bundle.tokenizers["vl"], SimpleTokenizer):
            prefix = self.template.split("<|vision_start|>")[0]
            drop = len(self._tokenize_with_images(bundle, prefix, []))
        n = [max(int(attn[i].sum()) - drop, 0) for i in range(b)]
        length = min(max(n), max_sequence_length)
        pe = hidden.new_zeros((b, length, hidden.shape[-1]))
        pm = torch.zeros((b, length), dtype=torch.int32, device=dev)
        for i in range(b):
            k = min(n[i], length)
            pe[i, :k] = hidden[i, drop:drop + k]
            pm[i, :k] = 1
        return pe, pm

    @torch.no_grad()
    def encode_vae_image(self, bundle: ModelBundle, images) -> torch.Tensor:
        """uint8 NHWC [B, H, W, 3] → packed latents [B, S, z·4], f32."""
        require_vae(bundle)
        dev = next(bundle.vae_params.parameters()).device
        x = torch.as_tensor(np.asarray(images)).to(dev, torch.float32) / 127.5 - 1.0
        return pack_latents(qwen_vae.encode(bundle.vae_params, bundle.vae_cfg, x))

    @staticmethod
    def _control_keys(batch: dict) -> list[str]:
        """"control", then "control_*" in string order, as JAX's."""
        return ([k for k in ("control",) if k in batch]
                + sorted(k for k in batch if k.startswith("control_")))

    def prepare_embeddings(self, bundle: ModelBundle, batch: dict,
                           max_sequence_length: int = 1024) -> dict:
        """A batch of pixels (uint8 "image", "control", "control_*",
        "prompt") → the embedding set, as JAX's: the prompts with every
        sample's control images through Qwen2.5-VL, the target and control
        latents (concatenated in `_control_keys` order), img_shapes_arr
        [(1, h, w) per plane] and its RoPE tables; no control makes an empty
        control_latents and the target's plane alone."""
        images = np.asarray(batch["image"])
        b, height, width = images.shape[:3]
        gh, gw = self.latent_grid(height, width)
        ctl_keys = self._control_keys(batch)
        vl_images = [[np.asarray(batch[k][i]) for k in ctl_keys] for i in range(b)]
        prompt_embeds, prompt_mask = self.encode_prompt(bundle, list(batch["prompt"]),
                                                        vl_images, max_sequence_length)
        image_latents = self.encode_vae_image(bundle, images)
        img_shapes, controls = [(1, gh, gw)], []
        for k in ctl_keys:
            ctl = np.asarray(batch[k])
            controls.append(self.encode_vae_image(bundle, ctl))
            img_shapes.append((1, *self.latent_grid(ctl.shape[1], ctl.shape[2])))
        out = {"image_latents": image_latents, "prompt_embeds": prompt_embeds,
               "prompt_embeds_mask": prompt_mask,
               "img_shapes_arr": np.asarray(img_shapes, np.int32),
               "control_latents": (torch.cat(controls, dim=1) if controls else
                                   image_latents.new_zeros((b, 0, image_latents.shape[-1])))}
        out.update(self.rope_for(img_shapes, int(prompt_embeds.shape[1])))
        if "edit_mask" in batch:
            out["edit_mask"] = np.asarray(batch["edit_mask"])
        return out

    def cache_embeddings(self, bundle: ModelBundle, item_batch: dict,
                         max_sequence_length: int = 1024) -> tuple[dict, dict]:
        """One sample (a bs=1 batch) → ({embedding key: numpy array},
        {embedding key: the file_hashes name its file is keyed by}) for
        `EmbeddingCacheManager.save`: JAX's seven keys, the empty prompt
        encoded with the sample's "control" image (caption dropout keeps the
        image context)."""
        emb = self.prepare_embeddings(bundle, item_batch, max_sequence_length)
        vl_images = [[np.asarray(item_batch[k][0]) for k in ("control",) if k in item_batch]]
        empty_pe, empty_pm = self.encode_prompt(bundle, [" "], vl_images, max_sequence_length)
        h = item_batch["file_hashes"]
        h = h[0] if isinstance(h, list) else h

        def host(t):
            return t[0].cpu().numpy() if t.dtype == torch.int32 else t[0].float().cpu().numpy()

        arrays = {
            "image_latents": host(emb["image_latents"]),
            "control_latents": host(emb["control_latents"]),
            "prompt_embeds": host(emb["prompt_embeds"]),
            "prompt_embeds_mask": host(emb["prompt_embeds_mask"]),
            "empty_prompt_embeds": host(empty_pe),
            "empty_prompt_embeds_mask": host(empty_pm),
            "img_shapes_arr": emb["img_shapes_arr"],
        }
        prompt = h.get("control_prompt_hash", h["prompt_hash"])
        empty = h.get("control_empty_prompt_hash", h["empty_prompt_hash"])
        hash_keys = {
            "image_latents": h["image_hash"],
            "control_latents": h.get("controls_sum_hash", h["image_hash"]),
            "prompt_embeds": prompt, "prompt_embeds_mask": prompt,
            "empty_prompt_embeds": empty, "empty_prompt_embeds_mask": empty,
            "img_shapes_arr": h["main_hash"],
        }
        return arrays, hash_keys

    def prepare_multires_embeddings(self, bundle: ModelBundle, items: list[dict],
                                    max_sequence_length: int = 1024) -> dict:
        """Items of different sizes ({"image": target-size reference,
        "control"/"control_*", "prompt"}) → one padded embeddings dict, as
        JAX's: each item prepared alone, its text, target, control and
        image planes right-padded to the longest, per-sample RoPE tables
        (identity rotations on padding, `prepare_cached_embeddings`),
        segment ids [txt mask | target | control] and `sample_grids`
        [(gh, gw)] for decoding."""
        singles = []
        for item in items:
            batch = {k: (np.asarray(v)[None] if isinstance(v, np.ndarray) else [v])
                     for k, v in item.items()}
            e = self.prepare_embeddings(bundle, batch, max_sequence_length)
            singles.append({k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                            for k, v in e.items()})
        s_txt = max(e["prompt_embeds"].shape[1] for e in singles)
        s_tgt = max(e["image_latents"].shape[1] for e in singles)
        s_ctl = max(e["control_latents"].shape[1] for e in singles)
        n_planes = max(e["img_shapes_arr"].shape[0] for e in singles)

        def pad2(x, n):
            return np.pad(x, ((0, n - x.shape[0]),) + ((0, 0),) * (x.ndim - 1))

        emb = {"image_latents": np.stack([pad2(e["image_latents"][0], s_tgt) for e in singles]),
               "control_latents": np.stack([pad2(e["control_latents"][0], s_ctl)
                                            for e in singles]),
               "prompt_embeds": np.stack([pad2(e["prompt_embeds"][0], s_txt) for e in singles]),
               "prompt_embeds_mask": np.stack([pad2(e["prompt_embeds_mask"][0], s_txt)
                                               for e in singles]),
               "img_shapes_arr": np.stack([pad2(e["img_shapes_arr"], n_planes)
                                           for e in singles])}
        emb = self.prepare_cached_embeddings(emb)
        segs = []
        for e in singles:
            pm = pad2(e["prompt_embeds_mask"][0], s_txt).astype(np.int32)
            segs.append(np.concatenate([
                pm, (np.arange(s_tgt) < e["image_latents"].shape[1]).astype(np.int32),
                (np.arange(s_ctl) < e["control_latents"].shape[1]).astype(np.int32)]))
        emb["segment_ids"] = np.stack(segs)
        emb["sample_grids"] = [(int(e["img_shapes_arr"][0][1]), int(e["img_shapes_arr"][0][2]))
                               for e in singles]
        return emb

    def negative_embeddings(self, bundle: ModelBundle, negative_prompt: str,
                            batch: dict, max_sequence_length: int = 1024) -> dict:
        """neg_*-prefixed embeddings for true-CFG sampling: the negative
        prompt with the batch's control images, as JAX's."""
        ctl_keys = self._control_keys(batch)
        b = int(np.shape(batch[ctl_keys[0]])[0]) if ctl_keys else 1
        vl_images = [[np.asarray(batch[k][i]) for k in ctl_keys] for i in range(b)]
        pe, pm = self.encode_prompt(bundle, [negative_prompt] * b, vl_images,
                                    max_sequence_length)
        return {"neg_prompt_embeds": pe, "neg_prompt_embeds_mask": pm}

    def latent_grid(self, height: int, width: int) -> tuple[int, int]:
        return (height // (self.vae_scale * 2), width // (self.vae_scale * 2))

    def rope_for(self, img_shapes, txt_len: int) -> dict:
        vc, vs, tc, ts = qwen_rope([tuple(int(v) for v in s) for s in img_shapes], txt_len,
                                   self.cfg.axes_dims_rope, scale_rope=self.cfg.scale_rope)
        return {"rope_vid_cos": vc, "rope_vid_sin": vs, "rope_txt_cos": tc, "rope_txt_sin": ts}

    def prepare_cached_embeddings(self, emb: dict) -> dict:
        """Rebuild the RoPE tables from the cached img_shapes_arr.  A
        single-resolution batch gets shared [S, D] tables; a mixed one
        per-sample [B, S, D] tables split into (target | control) sections
        that align with the independently padded latent sections, padded
        with identity rotations (cos 1, sin 0)."""
        if "rope_vid_cos" in emb:
            return emb
        arr = np.asarray(emb["img_shapes_arr"])
        txt_len = int(np.shape(emb["prompt_embeds"])[1])
        emb = dict(emb)
        if arr.ndim == 2 or bool((arr == arr[0]).all()):
            rows = arr[0] if arr.ndim == 3 else arr
            emb.update(self.rope_for([tuple(r) for r in rows], txt_len))
            return emb
        max_tgt = int(np.shape(emb["image_latents"])[1])
        max_ctl = int(np.shape(emb["control_latents"])[1])
        tables = {"rope_vid_cos": [], "rope_vid_sin": [], "rope_txt_cos": [], "rope_txt_sin": []}
        for rows in arr:
            shapes = [tuple(int(v) for v in r) for r in rows if int(r[1]) > 0]
            r = {k: v.numpy() for k, v in self.rope_for(shapes, txt_len).items()}
            s_tgt = shapes[0][0] * shapes[0][1] * shapes[0][2]
            vc, vs = r["rope_vid_cos"], r["rope_vid_sin"]

            def pad_id(c, sn, n):
                d = c.shape[-1]
                return (np.concatenate([c, np.ones((n - len(c), d), np.float32)]),
                        np.concatenate([sn, np.zeros((n - len(sn), d), np.float32)]))

            tc, ts = pad_id(vc[:s_tgt], vs[:s_tgt], max_tgt)
            cc, cs = pad_id(vc[s_tgt:], vs[s_tgt:], max_ctl)
            tables["rope_vid_cos"].append(np.concatenate([tc, cc]))
            tables["rope_vid_sin"].append(np.concatenate([ts, cs]))
            tables["rope_txt_cos"].append(r["rope_txt_cos"])
            tables["rope_txt_sin"].append(r["rope_txt_sin"])
        emb.update({k: torch.from_numpy(np.stack(v)) for k, v in tables.items()})
        return emb

    def predict_velocity(self, params, batch, latents, sigma):
        """DiT forward over [noisy_target, control], sliced back to the
        target tokens.  Without explicit segment ids the text padding of
        prompt_embeds_mask is masked out of the joint attention (segment 0),
        as in the JAX adapter."""
        ctrl = batch["control_latents"].to(latents.dtype)
        inp = torch.cat([latents, ctrl], dim=1)
        s_img = latents.shape[1]
        rope = (batch["rope_vid_cos"], batch["rope_vid_sin"],
                batch["rope_txt_cos"], batch["rope_txt_sin"])
        seg = batch.get("segment_ids")
        if seg is None and "prompt_embeds_mask" in batch:
            pm = batch["prompt_embeds_mask"].to(torch.int32)
            seg = torch.cat([pm, torch.ones((pm.shape[0], inp.shape[1]), dtype=torch.int32,
                                            device=pm.device)], dim=1)
        pred = qwen_dit.forward(
            params, self.cfg, inp, batch["prompt_embeds"].to(latents.dtype), sigma,
            rope=rope, segment_ids=seg, attn_impl=self.attn_impl, remat=self.remat,
            remat_policy=self.remat_policy)
        return pred[:, :s_img]

    @torch.inference_mode()
    def decode_latents(self, bundle: ModelBundle, packed, height: int, width: int) -> np.ndarray:
        """Packed latents → uint8 RGB images [B, H, W, 3]."""
        require_vae(bundle)
        gh, gw = self.latent_grid(height, width)
        lat = unpack_latents(packed, gh * 2, gw * 2)
        img = qwen_vae.decode(bundle.vae_params, bundle.vae_cfg, lat.float())
        img = (torch.clamp(img, -1, 1) + 1) * 127.5
        return torch.round(img).to(torch.uint8).cpu().numpy()
