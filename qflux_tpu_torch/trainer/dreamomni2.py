"""DreamOmni2 model adapter: FLUX.1-Kontext with its edit-LoRA fused into
the base weights at load, cumulative control ids, and the optional VLM
prompt enhancer.

Counterpart of qflux_tpu/trainer/dreamomni2.py:

  * `load`: FLUX.1-Kontext's load, then the edit-LoRA of
    model.pretrained_embeddings read (`utils/lora_io.load_lora_safetensors`,
    at JAX's default head dim) and folded into the full-precision DiT for
    good (`ops/layers.fuse_lora`; a checkpoint's blocks then load
    unquantized, and the Trainer quantizes the fused model, JAX's order).
    A LoRA that fails to read or names a layer the model lacks leaves the
    base as it was with a warning, as in JAX;
  * `prepare_embeddings`: FLUX.1-Kontext's, with the control images' ids
    from `ops/rope.dreamomni2_control_ids` (set id i + 1 and row and column
    offsets summed over the images before: JAX's cumulative layout, whose
    row offset the reference pipeline does not apply);
  * with model.use_vlm_prompt_enhancer, every non-empty prompt of a batch of
    pixels is first rewritten by Qwen2.5-VL given the batch's control
    images (`enhance_prompt`: the chat layout with the images' tokens and
    the " It is editing task." suffix, greedy decoding of up to 128 tokens
    over the KV cache of `models/qwen/vl_encoder.py`, the ids decoded by
    the tokenizer).  An empty prompt (conditioning dropout) stays empty.
    Without model.vlm_path (and outside variant "test") no VL is loaded and
    prompts pass through unchanged, with JAX's warning.

The VL stack ("vision", "text", "lm_head") is built with the text encoders,
on first use, by the bundle's text factory, so a fit from the embedding
cache holds none of them.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from pathlib import Path

import numpy as np
import torch

from qflux_tpu_torch.models.qwen import vl_encoder as vl
from qflux_tpu_torch.models.tokenizers import load_tokenizer
from qflux_tpu_torch.ops.layers import Dense, dense, fuse_lora
from qflux_tpu_torch.ops.rope import dreamomni2_control_ids, flux_image_ids
from qflux_tpu_torch.trainer.flux_kontext import (FluxKontextAdapter, ModelBundle,
                                                  SimpleTokenizer)
from qflux_tpu_torch.utils.lora_io import load_lora_safetensors
from qflux_tpu_torch.utils.safetensors import SafeTensors
from qflux_tpu_torch.utils.tensors import numeric_suffix_key

EDIT_SUFFIX = " It is editing task."
_VISION_MARKERS = re.compile(r"(<\|vision_start\|>|<\|image_pad\|>|<\|vision_end\|>)")


def lm_head_init(generator: torch.Generator, tcfg: vl.VLTextConfig, device=None) -> Dense:
    """JAX's test LM head: 0.05 · N(0, 1), [hidden, vocab], no bias."""
    head = Dense(tcfg.hidden_size, tcfg.vocab_size, bias=False, device=device,
                 dtype=torch.float32)
    with torch.no_grad():
        head.weight.normal_(generator=generator).mul_(0.05)
    return head


def vlm_factory(config, device):
    """(text cfgs, tokenizer, factory of {"vision", "text", "lm_head"}) for
    the prompt enhancer, or None where JAX loads no VL (no model.vlm_path
    outside variant "test", with JAX's warning).  Variant "test": the tiny
    VL with JAX's special tokens (500, 502, 503; EOS 1), drawn from
    generators seeded 11 / 12 / 13, and `SimpleTokenizer(vocab, 512)`;
    otherwise the full widths read from the safetensors under
    model.vlm_path one block / layer at a time, the LM head from
    `lm_head.weight` or the tied embedding (`convert_vl_lm_head`)."""
    model = config.model
    device = torch.device(device)
    if model.variant == "test":
        vcfg, tcfg = vl.VLVisionConfig.tiny(), vl.VLTextConfig.tiny()
        cfgs = {"vision": vcfg, "text": tcfg, "tokens": vl.VLSpecialTokens(500, 502, 503, (1,))}

        def factory():
            return {"vision": vl.vision_init(torch.Generator(device).manual_seed(11), vcfg,
                                             device),
                    "text": vl.text_init(torch.Generator(device).manual_seed(12), tcfg, device),
                    "lm_head": lm_head_init(torch.Generator(device).manual_seed(13), tcfg,
                                            device)}

        return cfgs, SimpleTokenizer(tcfg.vocab_size, 512), factory
    if not model.vlm_path:
        logging.warning("use_vlm_prompt_enhancer set but model.vlm_path missing; prompts will "
                        "pass through unchanged")
        return None
    path = Path(model.vlm_path)
    if not any(path.glob("*.safetensors")):
        raise FileNotFoundError(f"no safetensors under {path}")
    vcfg, tcfg = vl.VLVisionConfig(), vl.VLTextConfig()
    cfgs = {"vision": vcfg, "text": tcfg, "tokens": vl.VLSpecialTokens()}

    def factory():
        vision, text, head = vl.load_from_state_dict(SafeTensors(path), vcfg, tcfg, device,
                                                     lm_head=True)
        logging.info("loaded the prompt enhancer's Qwen2.5-VL from %s", path)
        return {"vision": vision, "text": text, "lm_head": head}

    try:
        tok = load_tokenizer(path)
    except FileNotFoundError as e:
        logging.warning("VLM tokenizer unavailable (%s); hash fallback", e)
        tok = SimpleTokenizer(tcfg.vocab_size, 1024)
    return cfgs, tok, factory


@dataclasses.dataclass(frozen=True)
class DreamOmni2Adapter(FluxKontextAdapter):
    use_vlm_prompt_enhancer: bool = False

    @classmethod
    def _per_block(cls, config, mesh) -> dict:
        """Nothing where an edit-LoRA is given: JAX fuses it into the
        full-precision DiT and quantizes after, so the checkpoint's blocks
        load unquantized and whole, and the Trainer quantizes and shards
        the fused model."""
        if config.model.pretrained_embeddings:
            return {"quantize": None, "mesh": None}
        return super()._per_block(config, mesh)

    @classmethod
    def load(cls, config, device, dtype=torch.bfloat16, mesh=None):
        """FLUX.1-Kontext's load (`FluxKontextAdapter.load`), then the
        edit-LoRA fused and, with model.use_vlm_prompt_enhancer, the VL
        stack joined to the text encoders' factory (`vlm_factory`)."""
        adapter, bundle = super().load(config, device, dtype, mesh)
        edit_lora = config.model.pretrained_embeddings
        if edit_lora:
            try:
                tree = load_lora_safetensors(edit_lora, adapter.lora_tree_path_fn)
                fuse_lora(bundle.dit_params, {p: {k: torch.as_tensor(np.asarray(v))
                                                  for k, v in leaf.items()}
                                              for p, leaf in tree.items()})
                logging.info("fused DreamOmni2 edit-LoRA from %s", edit_lora)
            except Exception as e:
                logging.warning("edit-LoRA fuse failed: %s", e)
        if config.model.use_vlm_prompt_enhancer:
            adapter = dataclasses.replace(adapter, use_vlm_prompt_enhancer=True)
            vlm = vlm_factory(config, device)
            if vlm is not None:
                cfgs, tok, factory = vlm
                bundle.text_cfgs.update(cfgs)
                bundle.tokenizers["vl"] = tok
                text_factory = bundle.text_factory
                bundle.text_factory = lambda: {**text_factory(), **factory()}
        return adapter, bundle

    def prepare_embeddings(self, bundle: ModelBundle, batch: dict,
                           max_sequence_length: int = 512) -> dict:
        """FLUX.1-Kontext's embeddings of the batch, its prompts rewritten
        first where the enhancer is on, with the controls' ids cumulative
        (`dreamomni2_control_ids`)."""
        batch = self._rewrite_batch_prompts(bundle, batch)
        out = FluxKontextAdapter.prepare_embeddings(self, bundle, batch, max_sequence_length)
        images = np.asarray(batch["image"])
        gh, gw = self.latent_grid(images.shape[1], images.shape[2])
        ctl_keys = [k for k in ("control",) if k in batch]
        ctl_keys += sorted(k for k in batch if k.startswith("control_") and k != "control")
        shapes = [self.latent_grid(*np.shape(batch[k])[1:3]) for k in ctl_keys]
        if shapes:
            out["img_ids"] = np.concatenate([flux_image_ids(gh, gw, 0),
                                             dreamomni2_control_ids(shapes)])
        return out

    # ------------------------------------------------------------------
    # the VLM prompt enhancer

    def _vl_tokenize(self, bundle: ModelBundle, text: str, n_image_tokens: list[int]) -> list[int]:
        """Chat text → ids, each <|image_pad|> expanded to its image's token
        count, the vision markers as their special ids."""
        toks = bundle.text_cfgs["tokens"]
        tok = bundle.tokenizers["vl"]
        ids: list[int] = []
        img_i = 0
        for part in _VISION_MARKERS.split(text):
            if not part:
                continue
            if part == "<|image_pad|>":
                ids.extend([toks.image_token_id] * n_image_tokens[img_i])
                img_i += 1
            elif part == "<|vision_start|>":
                ids.append(toks.vision_start_token_id)
            elif part == "<|vision_end|>":
                ids.append(toks.vision_end_token_id)
            elif isinstance(tok, SimpleTokenizer):
                ids.extend(int(i) for i in tok([part])[0] if i != 0)
            else:
                ids.extend(tok(part, add_special_tokens=False)["input_ids"])
        return ids

    @torch.no_grad()
    def enhance_prompt(self, bundle: ModelBundle, prompt: str, images: list,
                       max_new_tokens: int = 128) -> str:
        """The edit instruction rewritten by Qwen2.5-VL given the reference
        images, as JAX's: the vision tower's features in place of the image
        tokens, M-RoPE positions from `get_rope_index`, a KV cache of
        len(ids) + max_new_tokens slots filled by `text_prefill`, then
        greedy `text_decode_step`s at positions max(pos) + 1 + step until
        an EOS id or max_new_tokens; the generated ids decoded (the prompt
        as it was where nothing was generated, the stack is missing, or
        the enhancer is off)."""
        if not self.use_vlm_prompt_enhancer:
            return prompt
        if not bundle.text_params and bundle.text_factory is not None:
            bundle.text_params = bundle.text_factory()
        tp = bundle.text_params
        if "vision" not in tp or "text" not in tp or "lm_head" not in tp:
            logging.warning("VL stack/lm_head not loaded; keeping original prompt")
            return prompt
        vcfg, tcfg = bundle.text_cfgs["vision"], bundle.text_cfgs["text"]
        toks = bundle.text_cfgs["tokens"]
        tok = bundle.tokenizers["vl"]
        pre = [vl.preprocess_image(np.asarray(im), vcfg) for im in images]
        grids = [g for _, g in pre]
        msz2 = vcfg.spatial_merge_size ** 2
        text = ("<|im_start|>user\n"
                + "".join("<|vision_start|><|image_pad|><|vision_end|>" for _ in images)
                + f"{prompt}{EDIT_SUFFIX}<|im_end|>\n<|im_start|>assistant\n")
        ids = self._vl_tokenize(bundle, text, [t * h * w // msz2 for t, h, w in grids])
        cur = np.asarray([ids])
        lm = tp["text"]
        dev = lm.embed_tokens.device
        embeds = lm.embed_tokens[torch.from_numpy(cur).to(dev)]
        img_mask = cur[0] == toks.image_token_id
        if img_mask.any():
            vis = vl.vision_forward(tp["vision"], vcfg, np.concatenate([p for p, _ in pre]),
                                    grids)
            embeds[0, torch.from_numpy(img_mask).to(dev)] = vis.to(embeds.dtype)
        pos = vl.get_rope_index(cur, grids, vcfg.spatial_merge_size, toks)
        cache = vl.make_kv_cache(tcfg, 1, len(ids) + max_new_tokens, embeds.dtype, dev)
        hidden, cache = vl.text_prefill(lm, tcfg, embeds, pos, cache)
        head = tp["lm_head"]
        nxt = int(torch.argmax(dense(head, hidden[0, len(ids) - 1])))
        pos_base = int(pos.max()) + 1
        generated: list[int] = []
        eos = set(toks.eos_token_ids)
        for step in range(max_new_tokens):
            if nxt in eos:
                break
            generated.append(nxt)
            step_pos = np.full((3, 1, 1), pos_base + step, np.int64)
            emb = lm.embed_tokens[torch.tensor([[nxt]], device=dev)]
            hidden, cache = vl.text_decode_step(lm, tcfg, emb, step_pos, cache, len(ids) + step)
            nxt = int(torch.argmax(dense(head, hidden[0])))
        if not generated or not hasattr(tok, "decode"):
            return prompt
        out = tok.decode(generated, skip_special_tokens=True).strip()
        return out or prompt

    def _rewrite_batch_prompts(self, bundle: ModelBundle, batch: dict) -> dict:
        """Every prompt of a batch of pixels through `enhance_prompt` with
        its sample's control images (control, then control_* by numeric
        suffix), where the enhancer is on; an empty prompt (conditioning
        dropout chose the sample) or a sample without control images keeps
        its prompt."""
        if not self.use_vlm_prompt_enhancer or "prompt" not in batch:
            return batch
        prompts = batch["prompt"]
        single = isinstance(prompts, str)
        prompts = [prompts] if single else list(prompts)
        ctl_keys = [k for k in ("control",) if k in batch]
        ctl_keys += sorted((k for k in batch if k.startswith("control_")
                            and not k.startswith("control_latents")), key=numeric_suffix_key)
        new = []
        for bi, p in enumerate(prompts):
            imgs = [np.asarray(batch[k][bi]) for k in ctl_keys]
            new.append(self.enhance_prompt(bundle, p, imgs) if (imgs and p) else p)
        out = dict(batch)
        out["prompt"] = new[0] if single else new
        return out
