"""FLUX.1-Kontext model adapter: weights, encoding (the cache pass,
training from pixels, mixed-size predict), cached-embedding prep, velocity
prediction and decoding for the port's Trainer.

Counterpart of qflux_tpu/trainer/flux_kontext.py.  The batch is the
embedding-cache format of the JAX package:

    image_latents          [B, S_img, 64]   packed target latents (training)
    control_latents        [B, S_ctl, 64]   packed control latents
    prompt_embeds          [B, S_txt, 4096] T5 sequence embeds
    pooled_prompt_embeds   [B, 768]         CLIP pooled embeds
    tgt_ids / ctl_ids      separately cached ids (→ img_ids)
    txt_ids                [S_txt, 3]
    guidance               [B] optional
    segment_ids            [B, S_txt+S_img+S_ctl] optional (0 = padding)
    edit_mask              [B, S_img] optional (MaskEditLoss token weights)

`prepare_embeddings` makes that format from a batch of pixels: CLIP-L's
pooled output and T5-XXL's sequence for the prompts, the VAE encoder's
packed latents for the target and every control image (control set ids
1, 2, … in the ids), all in f32 as JAX computes them.  Tokenizers are the
port's own (`models/tokenizers.py`: CLIP's BPE from tokenizer/, T5's
Unigram from tokenizer_2/), which give the ids transformers' AutoTokenizer
gives JAX from the same files; where the checkpoint has no tokenizer files
(no checkpoint, variant "test"), `SimpleTokenizer`, the JAX package's hash
fallback (a hash of each word, not a real vocabulary).
"""

from __future__ import annotations

import dataclasses
import logging
import zlib
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from qflux_tpu_torch.models import porting
from qflux_tpu_torch.models.bridge import load_text_params, load_vae_params
from qflux_tpu_torch.models.flux import text_encoders as te
from qflux_tpu_torch.models.flux import transformer as flux
from qflux_tpu_torch.models.flux import vae as flux_vae
from qflux_tpu_torch.models.tokenizers import load_tokenizer
from qflux_tpu_torch.ops.packing import pack_latents, unpack_latents
from qflux_tpu_torch.ops.rope import flux_image_ids, flux_text_ids
from qflux_tpu_torch.utils.lora_io import flux_module_name, flux_tree_path
from qflux_tpu_torch.utils.safetensors import SafeTensors


@dataclasses.dataclass
class ModelBundle:
    """The model components of one family.  `text_params` holds the text
    encoders by name ("clip", "t5"), which `text_factory` builds on first
    use (`text_encoders`), from files or synthetic, so a fit from the
    embedding cache or a predict from embeddings never holds T5-XXL's
    19 GB."""

    dit_cfg: Any
    dit_params: Any
    vae_cfg: Any = None
    vae_params: Any = None
    text_cfgs: dict = dataclasses.field(default_factory=dict)
    text_params: dict = dataclasses.field(default_factory=dict)
    tokenizers: dict = dataclasses.field(default_factory=dict)
    text_factory: Optional[Callable[[], dict]] = None


def require_vae(bundle: ModelBundle) -> None:
    if bundle.vae_params is None:
        raise FileNotFoundError("no VAE was loaded: the checkpoint has no vae directory "
                                "(set model.vae_path)")


def text_encoders(bundle: ModelBundle) -> dict:
    """{"clip", "t5"} of the bundle, built by its factory on first use;
    raises where the checkpoint had no text_encoder / text_encoder_2 dir."""
    if not bundle.text_params and bundle.text_factory is not None:
        bundle.text_params = bundle.text_factory()
    missing = [k for k in ("clip", "t5") if k not in bundle.text_params]
    if missing:
        raise FileNotFoundError(
            f"no {' / '.join(missing)} text encoder was loaded: the checkpoint has no "
            "text_encoder / text_encoder_2 directory (set model.text_encoder_path / "
            "model.text_encoder_2_path)")
    return bundle.text_params


class SimpleTokenizer:
    """The JAX package's hash fallback tokenizer: each whitespace-separated
    word → crc32(word) % (vocab_size - 2) + 1, cut to max_length - 1, then
    the EOS id where there is one, zeros after.  Not a real vocabulary, so
    `decode` writes placeholder words ("tok<id>"), as JAX's does, for the
    greedy decoding of DreamOmni2's prompt enhancer."""

    def __init__(self, vocab_size: int, max_length: int, eos_token_id: Optional[int] = None):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.eos = eos_token_id

    def __call__(self, texts: list[str], max_length: Optional[int] = None) -> np.ndarray:
        n = max_length or self.max_length
        out = np.zeros((len(texts), n), np.int32)
        for i, t in enumerate(texts):
            toks = [zlib.crc32(w.encode()) % (self.vocab_size - 2) + 1
                    for w in t.split()][: n - 1]
            out[i, : len(toks)] = toks
            if self.eos is not None:
                out[i, len(toks)] = self.eos
        return out

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"tok{int(i)}" for i in ids if int(i) != 0)


def load_tokenizers(root: Optional[Path], tokenizer_path=None) -> dict:
    """{"clip", "t5"}: the first-party tokenizers of <root>/tokenizer (or
    model.tokenizer_path) and <root>/tokenizer_2 (`tokenizers.load_tokenizer`);
    where those files do not exist, the JAX package's hash fallback with its
    warning.  Files the port cannot read (a `spiece.model` without
    `tokenizer.json`) raise."""
    try:
        if root is None:
            raise FileNotFoundError("no checkpoint directory")
        return {"clip": load_tokenizer(Path(tokenizer_path or root / "tokenizer")),
                "t5": load_tokenizer(root / "tokenizer_2")}
    except FileNotFoundError as e:
        logging.warning("tokenizers unavailable (%s); using hash fallback", e)
        return {"clip": SimpleTokenizer(49408, 77, 49407), "t5": SimpleTokenizer(32128, 512)}


def _load_dir(path: Path, converter, what: str, **kw) -> dict:
    """A safetensors file or directory of shards through a converter,
    auditing the keys it did not read (`convert_with_coverage`)."""
    tree, _ = porting.convert_with_coverage(converter, SafeTensors(path), **kw)
    logging.info("loaded %s from %s", what, path)
    return tree


def checkpoint_dirs(model) -> Optional[tuple[Path, Optional[Path]]]:
    """(DiT path, VAE dir or None) of a config's model section, as the JAX
    adapters find them: model.dit_path, else <pretrained_model_name_or_path>
    /transformer; model.vae_path, else <root>/vae if that exists.  None when
    the section names no checkpoint (the weights are then synthetic)."""
    if not (model.pretrained_model_name_or_path or model.dit_path):
        return None
    root = Path(model.pretrained_model_name_or_path or ".")
    dit = Path(model.dit_path or root / "transformer")
    vae = Path(model.vae_path or root / "vae")
    return dit, (vae if vae.exists() else None)


def text_dirs(model, text_cfgs: dict):
    """(name, dir or None, converter, module class) of CLIP-L and T5: the
    configured path, else <root>/text_encoder(_2), where it exists."""
    root = Path(model.pretrained_model_name_or_path or ".")
    out = []
    for name, key, sub, conv, module in (
            ("clip", "text_encoder_path", "text_encoder", porting.convert_clip_text,
             te.CLIPText),
            ("t5", "text_encoder_2_path", "text_encoder_2", porting.convert_t5_encoder,
             te.T5Encoder)):
        path = Path(getattr(model, key, None) or root / sub)
        out.append((name, path if path.exists() else None, conv, module))
    return out


def quantize_config(config):
    """model.quantize where enabled, else None."""
    qz = config.model.quantize
    return qz if qz and qz.enabled else None


def remat_policy_from_config(remat_cfg: str) -> str:
    """mesh.remat YAML value → transformer remat_policy name (the JAX
    table)."""
    return {"minimal": "dots", "full": "full", "flash": "flash",
            "flash_mlp": "flash_mlp", "flash_single": "flash_single",
            "flash_offload": "flash_offload"}.get(remat_cfg, "flash")


def attn_impl_from_config(config) -> str:
    """`model.quantize: {enabled: true, attention: true}` → "int8", the int8
    score GEMM of K1 and K2 (their s_int8 modes), which applies where JAX on
    a TPU applies it: S up to 2560 at head dim 128 (`flash_nr.s_int8_tiles`),
    bf16 attention elsewhere (K3 / K4 at the published Qwen 832×576 config,
    S = 4000); else "auto"."""
    qz = config.model.quantize
    return "int8" if (qz and qz.enabled and qz.attention) else "auto"


@dataclasses.dataclass(frozen=True)
class FluxKontextAdapter:
    cfg: flux.FluxConfig
    attn_impl: str = "auto"
    remat: bool = True
    remat_policy: str = "dots"  # JAX's adapter default; configs set mesh.remat
    vae_scale: int = 8

    lora_module_name_fn = staticmethod(flux_module_name)
    lora_tree_path_fn = staticmethod(flux_tree_path)
    default_lora_targets = (
        r"attn/(to_q|to_k|to_v|to_out|add_q|add_k|add_v|add_out)",
    )

    @classmethod
    def _per_block(cls, config, mesh) -> dict:
        """What the loader does to each DiT block as a checkpoint loads: the
        quantization (`quantize_config`) and the sharding over `mesh`'s
        fsdp ranks; the Trainer quantizes and shards the rest after
        `load`."""
        return {"quantize": quantize_config(config), "mesh": mesh}

    @classmethod
    def load(cls, config, device, dtype=torch.bfloat16,
             mesh=None) -> tuple["FluxKontextAdapter", ModelBundle]:
        """The DiT in `dtype`, the VAE and the text encoders in float32 on
        `device`, at the widths of the variant's config: `FluxConfig()` /
        `VAEConfig()` / `CLIPTextConfig()` / `T5Config()` (FLUX.1-Kontext-dev),
        or the tiny ones for variant "test" (whose tokenizers are the hash
        fallback at the tiny vocabularies, as in JAX).

        With model.pretrained_model_name_or_path or model.dit_path, the
        weights are read from a diffusers checkpoint, as the JAX adapter
        reads them (`checkpoint_dirs`): the DiT from a safetensors file or a
        directory of shards, block by block (`flux.load_from_state_dict`,
        each block quantized as it loads under model.quantize and, with
        `mesh` (a parallel/mesh.Mesh that shards the base), sharded), with the
        depth the file has (a file with fewer blocks builds a cut model); a
        missing DiT raises FileNotFoundError.  The VAE (encoder and decoder)
        from model.vae_path or <root>/vae, CLIP-L from
        model.text_encoder_path or <root>/text_encoder and T5 from
        model.text_encoder_2_path or <root>/text_encoder_2, each where it
        exists (without one, what needs it raises), read on first use
        (`text_encoders`); tokenizers from
        <root>/tokenizer(_2) (`load_tokenizers`).

        Without a checkpoint the weights are synthetic, drawn on `device`
        from generators seeded 0 (DiT), 1 (VAE), 2 (CLIP) and 3 (T5) with
        the JAX inits' distributions; the text encoders are drawn on first
        use (`text_encoders`)."""
        model = config.model
        test = model.variant == "test"
        if test:
            dit_cfg, vae_cfg = flux.FluxConfig.tiny(), flux_vae.VAEConfig.tiny()
            text_cfgs = {"clip": te.CLIPTextConfig.tiny(), "t5": te.T5Config.tiny()}
        else:
            dit_cfg, vae_cfg = flux.FluxConfig(), flux_vae.VAEConfig()
            text_cfgs = {"clip": te.CLIPTextConfig(), "t5": te.T5Config()}
        device = torch.device(device)
        files = checkpoint_dirs(model)
        bundle = ModelBundle(dit_cfg=dit_cfg, dit_params=None, vae_cfg=vae_cfg,
                             text_cfgs=text_cfgs)
        if files is None:
            bundle.dit_params = flux.init(torch.Generator(device).manual_seed(0), dit_cfg,
                                          device, dtype)
            bundle.vae_params = flux_vae.init(torch.Generator(device).manual_seed(1), vae_cfg,
                                              device)

            def text_factory():
                return {"clip": te.clip_init(torch.Generator(device).manual_seed(2),
                                             text_cfgs["clip"], device),
                        "t5": te.t5_init(torch.Generator(device).manual_seed(3),
                                         text_cfgs["t5"], device)}
        else:
            sd = SafeTensors(files[0])
            dit_cfg = bundle.dit_cfg = dataclasses.replace(
                dit_cfg, num_layers=porting.count_blocks(sd, "transformer_blocks"),
                num_single_layers=porting.count_blocks(sd, "single_transformer_blocks"))
            bundle.dit_params = flux.load_from_state_dict(sd, dit_cfg, device, dtype,
                                                          **cls._per_block(config, mesh))
            if files[1] is not None:
                tree = _load_dir(files[1], porting.convert_flux_vae, "the VAE",
                                 num_blocks=len(vae_cfg.block_out_channels),
                                 layers_per_block=vae_cfg.layers_per_block)
                bundle.vae_params = load_vae_params(flux_vae.VAE(vae_cfg, device=device), tree)

            def text_factory():
                return {name: load_text_params(module(text_cfgs[name], device=device),
                                               _load_dir(path, conv, name,
                                                         num_layers=text_cfgs[name].num_layers))
                        for name, path, conv, module in text_dirs(model, text_cfgs)
                        if path is not None}
        bundle.text_factory = text_factory
        if test:
            clip_cfg = text_cfgs["clip"]
            bundle.tokenizers = {
                "clip": SimpleTokenizer(clip_cfg.vocab_size, clip_cfg.max_position_embeddings,
                                        clip_cfg.eos_token_id),
                "t5": SimpleTokenizer(text_cfgs["t5"].vocab_size, 64)}
        else:
            root = (Path(model.pretrained_model_name_or_path or ".") if files is not None
                    else None)
            bundle.tokenizers = load_tokenizers(root, model.tokenizer_path)
        remat_cfg = config.mesh.remat
        adapter = cls(dit_cfg, attn_impl=attn_impl_from_config(config),
                      remat=remat_cfg != "none",
                      remat_policy=remat_policy_from_config(remat_cfg),
                      vae_scale=vae_cfg.downscale)
        return adapter, bundle

    # ======================================================================
    # encoding (the cache pass, training from pixels, predict on raw images)

    @torch.no_grad()
    def encode_prompt(self, bundle: ModelBundle, prompts: list[str],
                      max_sequence_length: int = 512):
        """(prompt_embeds [B, S, 4096] from T5, pooled [B, 768] from CLIP-L,
        txt_ids [S, 3] numpy): the dual-encoder scheme, CLIP at its 77
        positions, T5 at max_sequence_length, f32 on the encoders' device."""
        enc = text_encoders(bundle)
        tok_c, tok_t = bundle.tokenizers["clip"], bundle.tokenizers["t5"]
        if isinstance(tok_c, SimpleTokenizer):
            clip_ids = tok_c(prompts)
            t5_ids = tok_t(prompts, max_length=max_sequence_length)
        else:  # the first-party tokenizers
            clip_ids = np.asarray(tok_c(prompts, padding="max_length", truncation=True,
                                        max_length=77, return_tensors="np")["input_ids"])
            t5_ids = np.asarray(tok_t(prompts, padding="max_length", truncation=True,
                                      max_length=max_sequence_length,
                                      return_tensors="np")["input_ids"])
        _, pooled = te.clip_encode(enc["clip"], bundle.text_cfgs["clip"], clip_ids)
        prompt_embeds = te.t5_encode(enc["t5"], bundle.text_cfgs["t5"], t5_ids)
        return prompt_embeds, pooled, flux_text_ids(prompt_embeds.shape[1])

    @torch.no_grad()
    def encode_vae_image(self, bundle: ModelBundle, images) -> torch.Tensor:
        """uint8 NHWC [B, H, W, 3] → packed latents [B, S, C·4], f32."""
        require_vae(bundle)
        dev = next(bundle.vae_params.parameters()).device
        x = torch.as_tensor(np.asarray(images)).to(dev, torch.float32) / 127.5 - 1.0
        return pack_latents(flux_vae.encode(bundle.vae_params, bundle.vae_cfg, x))

    def prepare_embeddings(self, bundle: ModelBundle, batch: dict,
                           max_sequence_length: int = 512) -> dict:
        """A batch of pixels (uint8 "image", "control", "control_1", …, and
        "prompt") → the embedding set, as JAX's: target latents, the control
        images' latents concatenated in the order control, control_1, … (by
        name) with set ids 1, 2, …, img_ids [S_img + S_ctl, 3]; no control
        makes an empty control_latents and the target's ids alone."""
        images = np.asarray(batch["image"])
        b, height, width = images.shape[:3]
        gh, gw = self.latent_grid(height, width)
        prompt_embeds, pooled, txt_ids = self.encode_prompt(
            bundle, list(batch["prompt"]), max_sequence_length)
        image_latents = self.encode_vae_image(bundle, images)
        controls, ids = [], [flux_image_ids(gh, gw, 0)]
        ctl_keys = [k for k in ("control",) if k in batch]
        ctl_keys += sorted(k for k in batch if k.startswith("control_"))
        for i, key in enumerate(ctl_keys):
            ctl = np.asarray(batch[key])
            cg_h, cg_w = self.latent_grid(ctl.shape[1], ctl.shape[2])
            controls.append(self.encode_vae_image(bundle, ctl))
            ids.append(flux_image_ids(cg_h, cg_w, i + 1))
        out = {"image_latents": image_latents, "prompt_embeds": prompt_embeds,
               "pooled_prompt_embeds": pooled, "txt_ids": txt_ids,
               "img_ids": np.concatenate(ids)}
        if controls:
            out["control_latents"] = torch.cat(controls, dim=1)
        else:  # control-free training degenerates to pure t2i
            out["control_latents"] = image_latents.new_zeros((b, 0, image_latents.shape[-1]))
            out["img_ids"] = ids[0]
        if "edit_mask" in batch:
            out["edit_mask"] = np.asarray(batch["edit_mask"])
        return out

    def cache_embeddings(self, bundle: ModelBundle, item_batch: dict,
                         max_sequence_length: int = 512) -> tuple[dict, dict]:
        """One sample (a bs=1 batch) → ({embedding key: numpy array},
        {embedding key: the file_hashes name its file is keyed by}) for
        `EmbeddingCacheManager.save`: JAX's nine keys, the target and
        control ids cached apart."""
        emb = self.prepare_embeddings(bundle, item_batch, max_sequence_length)
        empty_pe, empty_pooled, _ = self.encode_prompt(bundle, [""], max_sequence_length)
        h = item_batch["file_hashes"]
        h = h[0] if isinstance(h, list) else h
        ids = np.asarray(emb["img_ids"])
        s_img = int(emb["image_latents"].shape[1])

        def host(t):
            return t[0].float().cpu().numpy()

        arrays = {
            "image_latents": host(emb["image_latents"]),
            "control_latents": host(emb["control_latents"]),
            "prompt_embeds": host(emb["prompt_embeds"]),
            "pooled_prompt_embeds": host(emb["pooled_prompt_embeds"]),
            "empty_prompt_embeds": host(empty_pe),
            "empty_pooled_prompt_embeds": host(empty_pooled),
            "tgt_ids": ids[:s_img],
            "ctl_ids": ids[s_img:],
            "txt_ids": np.asarray(emb["txt_ids"]),
        }
        hash_keys = {
            "image_latents": h["image_hash"],
            "control_latents": h.get("controls_sum_hash", h["image_hash"]),
            "prompt_embeds": h["prompt_hash"],
            "pooled_prompt_embeds": h["prompt_hash"],
            "empty_prompt_embeds": h["empty_prompt_hash"],
            "empty_pooled_prompt_embeds": h["empty_prompt_hash"],
            "tgt_ids": h["image_hash"],
            "ctl_ids": h.get("controls_sum_hash", h["main_hash"]),
            "txt_ids": h["prompt_hash"],
        }
        return arrays, hash_keys

    def prepare_multires_embeddings(self, bundle: ModelBundle, items: list[dict],
                                    max_sequence_length: int = 512) -> dict:
        """Items of different sizes ({"image": target-size reference,
        "control"/"control_*", "prompt"}) → one padded embeddings dict for
        one sampler call, as JAX's: each item prepared alone, its target and
        control latents and ids right-padded to the longest (per-sample
        img_ids [B, S, 3]), segment ids [txt | target | control] (padding 0),
        the target tokens' `attention_mask`, and `sample_grids` [(gh, gw)]
        for decoding."""
        singles = []
        for item in items:
            batch = {k: (np.asarray(v)[None] if isinstance(v, np.ndarray) else [v])
                     for k, v in item.items()}
            e = self.prepare_embeddings(bundle, batch, max_sequence_length)
            singles.append({k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
                            for k, v in e.items()})
        s_txt = max(e["prompt_embeds"].shape[1] for e in singles)
        s_tgt = max(e["image_latents"].shape[1] for e in singles)
        s_ctl = max(e["control_latents"].shape[1] for e in singles)

        def pad2(x, n):
            return np.pad(x, ((0, n - x.shape[0]),) + ((0, 0),) * (x.ndim - 1))

        out = {"image_latents": np.stack([pad2(e["image_latents"][0], s_tgt) for e in singles]),
               "control_latents": np.stack([pad2(e["control_latents"][0], s_ctl)
                                            for e in singles]),
               "prompt_embeds": np.stack([pad2(e["prompt_embeds"][0], s_txt) for e in singles]),
               "pooled_prompt_embeds": np.stack([e["pooled_prompt_embeds"][0]
                                                 for e in singles]),
               "txt_ids": singles[0]["txt_ids"]}
        ids, segs, n_tgts = [], [], []
        for e in singles:
            n_tgt, n_ctl = e["image_latents"].shape[1], e["control_latents"].shape[1]
            ids.append(np.concatenate([pad2(e["img_ids"][:n_tgt], s_tgt),
                                       pad2(e["img_ids"][n_tgt:], s_ctl)]))
            segs.append(np.concatenate([np.ones(s_txt, np.int32),
                                        (np.arange(s_tgt) < n_tgt).astype(np.int32),
                                        (np.arange(s_ctl) < n_ctl).astype(np.int32)]))
            n_tgts.append(n_tgt)
        out["img_ids"] = np.stack(ids)
        out["segment_ids"] = np.stack(segs)
        out["attention_mask"] = (np.arange(s_tgt)[None] < np.asarray(n_tgts)[:, None]
                                 ).astype(np.float32)
        out["sample_grids"] = [(int(e["img_ids"][:n, 1].max()) + 1,
                                int(e["img_ids"][:n, 2].max()) + 1)
                               for e, n in zip(singles, n_tgts)]
        return out

    def negative_embeddings(self, bundle: ModelBundle, negative_prompt: str,
                            batch: dict, max_sequence_length: int = 512) -> dict:
        """neg_*-prefixed embeddings for true-CFG sampling."""
        b = (len(batch["prompt"]) if "prompt" in batch
             else int(np.shape(batch["prompt_embeds"])[0]))
        pe, pooled, _ = self.encode_prompt(bundle, [negative_prompt] * b, max_sequence_length)
        return {"neg_prompt_embeds": pe, "neg_pooled_prompt_embeds": pooled}

    def latent_grid(self, height: int, width: int) -> tuple[int, int]:
        return (height // (self.vae_scale * 2), width // (self.vae_scale * 2))

    def prepare_cached_embeddings(self, emb: dict) -> dict:
        """Rebuild img_ids from the separately cached target/control ids.
        Single-res batches collapse to shared 2D ids; mixed-resolution
        batches keep per-sample [B, S, 3] ids."""
        if "img_ids" in emb or "tgt_ids" not in emb:
            return emb
        emb = dict(emb)
        tgt = np.asarray(emb.pop("tgt_ids"))
        ctl = np.asarray(emb.pop("ctl_ids"))
        txt = np.asarray(emb["txt_ids"]) if "txt_ids" in emb else None
        if tgt.ndim == 3:  # collated per-sample
            ids = np.concatenate([tgt, ctl], axis=1)
            same = bool((ids == ids[0]).all())
            emb["img_ids"] = ids[0] if same else ids
            if txt is not None:
                emb["txt_ids"] = txt[0] if txt.ndim == 3 else txt
        else:
            emb["img_ids"] = np.concatenate([tgt, ctl], axis=0)
            if txt is not None:
                emb["txt_ids"] = txt
        return emb

    def predict_velocity(self, params, batch, latents, sigma):
        """DiT forward over [noisy_target, control], sliced back to the
        target tokens."""
        ctrl = batch["control_latents"].to(latents.dtype)
        inp = torch.cat([latents, ctrl], dim=1)
        s_img = latents.shape[1]
        guidance = batch.get("guidance")
        if guidance is None and self.cfg.guidance_embeds:
            guidance = torch.ones_like(sigma)
        pred = flux.forward(
            params, self.cfg, inp,
            batch["prompt_embeds"].to(latents.dtype),
            batch["pooled_prompt_embeds"].to(latents.dtype),
            sigma, batch["img_ids"], batch["txt_ids"],
            guidance=guidance, segment_ids=batch.get("segment_ids"),
            attn_impl=self.attn_impl, remat=self.remat, remat_policy=self.remat_policy)
        return pred[:, :s_img]

    @torch.inference_mode()
    def decode_latents(self, bundle: ModelBundle, packed, height: int, width: int) -> np.ndarray:
        """Packed latents → uint8 RGB images [B, H, W, 3]."""
        require_vae(bundle)
        gh, gw = self.latent_grid(height, width)
        lat = unpack_latents(packed, gh * 2, gw * 2)
        img = flux_vae.decode(bundle.vae_params, bundle.vae_cfg, lat.float())
        img = (torch.clamp(img, -1, 1) + 1) * 127.5
        return torch.round(img).to(torch.uint8).cpu().numpy()
