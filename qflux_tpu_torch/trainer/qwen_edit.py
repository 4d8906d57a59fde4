"""Qwen-Image-Edit model adapter: weights, cached-embedding prep, velocity
prediction and decoding for the port's Trainer (predict and the LoRA train
step).

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
as the JAX step does.  The text encoder and the VAE encoder (the cache pass)
are ROADMAP.md queue 1 item 5b.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qflux_tpu_torch.models.bridge import load_vae_params
from qflux_tpu_torch.models.porting import count_blocks
from qflux_tpu_torch.models.qwen import transformer as qwen_dit
from qflux_tpu_torch.models.qwen import vae as qwen_vae
from qflux_tpu_torch.models.qwen.porting import convert_qwen_vae
from qflux_tpu_torch.ops.packing import unpack_latents
from qflux_tpu_torch.ops.rope import qwen_rope
from qflux_tpu_torch.trainer.flux_kontext import (ModelBundle, attn_impl_from_config,
                                                  checkpoint_dirs, quantize_config,
                                                  remat_policy_from_config, require_vae)
from qflux_tpu_torch.utils.safetensors import SafeTensors

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

    lora_module_name_fn = staticmethod(_qwen_module_name)
    lora_tree_path_fn = staticmethod(_qwen_tree_path)
    default_lora_targets = (
        r"attn/(to_q|to_k|to_v|to_out|add_q|add_k|add_v|add_out)",
    )

    @classmethod
    def load(cls, config, device, dtype=torch.bfloat16) -> tuple["QwenImageEditAdapter",
                                                                 ModelBundle]:
        """The DiT in `dtype` and the VAE in float32 on `device`, at the
        widths of the variant's config: the published Qwen-Image-Edit
        topology (`QwenImageConfig()`: 60 blocks, 24 heads × 128;
        `QwenVAEConfig()`), or for variant "test" the tiny DiT
        (joint_attention_dim 48, the tiny VL text encoder's width;
        in_channels 16 = 4 · the tiny VAE's z_dim 4; out_channels 4) and the
        tiny VAE.  With model.quantize enabled each DiT block is quantized
        as soon as it exists, so only one block's full-precision weights
        exist at a time.

        With model.pretrained_model_name_or_path or model.dit_path, the
        weights are read from a diffusers checkpoint as the JAX adapter
        reads them (`flux_kontext.checkpoint_dirs`): the DiT block by block
        (`transformer.load_from_state_dict`) with the depth the file has (a
        missing DiT raises FileNotFoundError), and the VAE's decoder from
        its directory when there is one (without it `vae_params` is None
        and decoding raises).  The Qwen2.5-VL text encoder and the tokenizer
        are not read: the port predicts from cached embeddings, and the
        encoders are ROADMAP.md queue 1 item 5b.  Without a checkpoint the
        weights are synthetic, drawn on `device` from generators seeded 0
        (DiT) and 1 (VAE)."""
        model = config.model
        if model.variant == "test":
            dit_cfg = dataclasses.replace(qwen_dit.QwenImageConfig.tiny(), joint_attention_dim=48,
                                          in_channels=16, out_channels=4)
            vae_cfg = qwen_vae.QwenVAEConfig.tiny()
        else:
            dit_cfg, vae_cfg = qwen_dit.QwenImageConfig(), qwen_vae.QwenVAEConfig()
        device = torch.device(device)
        files = checkpoint_dirs(model)
        if files is None:
            dit = qwen_dit.init(torch.Generator(device).manual_seed(0), dit_cfg, device, dtype,
                                quantize=quantize_config(config))
            vae = qwen_vae.init(torch.Generator(device).manual_seed(1), vae_cfg, device)
        else:
            sd = SafeTensors(files[0])
            dit_cfg = dataclasses.replace(dit_cfg,
                                          num_layers=count_blocks(sd, "transformer_blocks"))
            dit = qwen_dit.load_from_state_dict(sd, dit_cfg, device, dtype,
                                                quantize=quantize_config(config))
            vae = None
            if files[1] is not None:
                vsd = SafeTensors(files[1])
                vae = load_vae_params(
                    qwen_vae.QwenVAE(vae_cfg, device=device,
                                     post_quant_conv="post_quant_conv.weight" in vsd),
                    convert_qwen_vae(vsd, num_res_blocks=vae_cfg.num_res_blocks,
                                     levels=len(vae_cfg.dim_mult)))
        remat_cfg = config.mesh.remat
        adapter = cls(dit_cfg, attn_impl=attn_impl_from_config(config),
                      remat=remat_cfg != "none", remat_policy=remat_policy_from_config(remat_cfg),
                      vae_scale=vae_cfg.downscale)
        return adapter, ModelBundle(dit_cfg=dit_cfg, dit_params=dit, vae_cfg=vae_cfg,
                                    vae_params=vae)

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
