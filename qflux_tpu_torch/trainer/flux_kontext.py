"""FLUX.1-Kontext model adapter: weights, cached-embedding prep, velocity
prediction and decoding for the port's Trainer.

Counterpart of qflux_tpu/trainer/flux_kontext.py for the predict and train
slices.  The batch is the embedding-cache format of the JAX package:

    image_latents          [B, S_img, 64]   packed target latents (training)
    control_latents        [B, S_ctl, 64]   packed control latents
    prompt_embeds          [B, S_txt, 4096] T5 sequence embeds
    pooled_prompt_embeds   [B, 768]         CLIP pooled embeds
    tgt_ids / ctl_ids      separately cached ids (→ img_ids)
    txt_ids                [S_txt, 3]
    guidance               [B] optional
    segment_ids            [B, S_txt+S_img+S_ctl] optional (0 = padding)
    edit_mask              [B, S_img] optional (MaskEditLoss token weights)

Text encoders and the VAE encoder (the cache pass) are a later slice.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from qflux_tpu_torch.models import porting
from qflux_tpu_torch.models.bridge import load_vae_params
from qflux_tpu_torch.models.flux import transformer as flux
from qflux_tpu_torch.models.flux import vae as flux_vae
from qflux_tpu_torch.ops.packing import unpack_latents
from qflux_tpu_torch.utils.lora_io import flux_module_name, flux_tree_path
from qflux_tpu_torch.utils.safetensors import SafeTensors


@dataclasses.dataclass
class ModelBundle:
    """The model components of one family."""

    dit_cfg: Any
    dit_params: Any
    vae_cfg: Any = None
    vae_params: Any = None


def require_vae(bundle: ModelBundle) -> None:
    if bundle.vae_params is None:
        raise FileNotFoundError("no VAE was loaded: the checkpoint has no vae directory "
                                "(set model.vae_path)")


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


def quantize_config(config):
    """model.quantize where enabled, else None."""
    qz = config.model.quantize
    return qz if qz and qz.enabled else None


def remat_policy_from_config(remat_cfg: str) -> str:
    """mesh.remat YAML value → transformer remat_policy name (the JAX
    table; the transformer raises on the names it has not ported)."""
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
    remat_policy: str = "flash"
    vae_scale: int = 8

    lora_module_name_fn = staticmethod(flux_module_name)
    lora_tree_path_fn = staticmethod(flux_tree_path)
    default_lora_targets = (
        r"attn/(to_q|to_k|to_v|to_out|add_q|add_k|add_v|add_out)",
    )

    @classmethod
    def load(cls, config, device, dtype=torch.bfloat16) -> tuple["FluxKontextAdapter", ModelBundle]:
        """The DiT in `dtype` and the VAE in float32 on `device`, at the
        widths of the variant's config: `FluxConfig()` / `VAEConfig()`
        (FLUX.1-Kontext-dev), or the tiny ones for variant "test".

        With model.pretrained_model_name_or_path or model.dit_path, the
        weights are read from a diffusers checkpoint, as the JAX adapter
        reads them (`checkpoint_dirs`): the DiT from a safetensors file or a
        directory of shards, block by block (`flux.load_from_state_dict`,
        each block quantized as it loads under model.quantize), with the
        depth the file has (a file with fewer blocks builds a cut model); a
        missing DiT raises FileNotFoundError.  The VAE's decoder is loaded
        from its directory when there is one (the encoder belongs to the
        cache pass, a later slice); without one `vae_params` is None and
        decoding raises.  The text encoders and tokenizers of the directory
        are not read: the port predicts from cached embeddings, and the
        encoders are ROADMAP.md queue 1 item 5.

        Without a checkpoint the weights are synthetic, drawn on `device`
        from generators seeded 0 (DiT) and 1 (VAE) with the
        `dense_init`/`_conv_init` bounds."""
        model = config.model
        if model.variant == "test":
            dit_cfg, vae_cfg = flux.FluxConfig.tiny(), flux_vae.VAEConfig.tiny()
        else:
            dit_cfg, vae_cfg = flux.FluxConfig(), flux_vae.VAEConfig()
        device = torch.device(device)
        files = checkpoint_dirs(model)
        if files is None:
            dit = flux.init(torch.Generator(device).manual_seed(0), dit_cfg, device, dtype)
            vae = flux_vae.init(torch.Generator(device).manual_seed(1), vae_cfg, device)
        else:
            sd = SafeTensors(files[0])
            dit_cfg = dataclasses.replace(
                dit_cfg, num_layers=porting.count_blocks(sd, "transformer_blocks"),
                num_single_layers=porting.count_blocks(sd, "single_transformer_blocks"))
            dit = flux.load_from_state_dict(sd, dit_cfg, device, dtype,
                                            quantize=quantize_config(config))
            vae = None
            if files[1] is not None:
                tree = porting.convert_flux_vae(
                    SafeTensors(files[1]), num_blocks=len(vae_cfg.block_out_channels),
                    layers_per_block=vae_cfg.layers_per_block)
                vae = load_vae_params(flux_vae.VAE(vae_cfg, device=device), tree)
        remat_cfg = config.mesh.remat
        adapter = cls(dit_cfg, attn_impl=attn_impl_from_config(config),
                      remat=remat_cfg != "none",
                      remat_policy=remat_policy_from_config(remat_cfg),
                      vae_scale=vae_cfg.downscale)
        return adapter, ModelBundle(dit_cfg=dit_cfg, dit_params=dit, vae_cfg=vae_cfg,
                                    vae_params=vae)

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
