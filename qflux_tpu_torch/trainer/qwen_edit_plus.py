"""Qwen-Image-Edit-2509 ("Plus") model adapter: several images composed in
one edit.

Counterpart of qflux_tpu/trainer/qwen_edit_plus.py.  It is the
Qwen-Image-Edit adapter (`trainer/qwen_edit.py`) with two differences, both
in the encoding:

  * the chat template names every image, "Picture i: <|vision_start|>
    <|image_pad|><|vision_end|>", before the instruction (`PLUS_TEMPLATE`,
    drop_idx 64);
  * Qwen2.5-VL sees a condition copy of each image shrunk to at most 384²
    pixels, each side a multiple of 32 (`resize_condition_image`: cv2's
    INTER_AREA in JAX, `data/preprocess._resize(..., "area")` here, equal to
    it to the bit), while the VAE encodes the full-resolution controls.

The control latents are concatenated along the sequence with one image
plane each, as the base adapter does for any number of controls.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from qflux_tpu_torch.data.preprocess import _resize
from qflux_tpu_torch.trainer.qwen_edit import QwenImageEditAdapter

# the diffusers QwenImageEditPlusPipeline template
PLUS_TEMPLATE = (
    "<|im_start|>system\nDescribe the key features of the input image "
    "(color, shape, size, texture, objects, background), then explain how the "
    "user's text instruction should alter or modify the image. Generate a new "
    "image that meets the user's requirements while maintaining consistency "
    "with the original input where appropriate.<|im_end|>\n"
    "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n"
)
PLUS_DROP_IDX = 64
CONDITION_IMAGE_PIXELS = 384 * 384


def resize_condition_image(image: np.ndarray, max_pixels: int = CONDITION_IMAGE_PIXELS,
                           factor: int = 32) -> np.ndarray:
    """uint8 [H, W, 3] → its aspect-preserving copy of at most `max_pixels`
    pixels, each side cut down to a multiple of `factor` (at least
    `factor`), resampled by INTER_AREA."""
    h, w = image.shape[:2]
    if h * w > max_pixels:
        scale = math.sqrt(max_pixels / (h * w))
        h, w = int(h * scale), int(w * scale)
    h = max(factor, h // factor * factor)
    w = max(factor, w // factor * factor)
    return _resize(image, w, h, "area")


@dataclasses.dataclass(frozen=True)
class QwenImageEditPlusAdapter(QwenImageEditAdapter):
    template: str = PLUS_TEMPLATE
    drop_idx: int = PLUS_DROP_IDX

    def format_prompt(self, prompt: str, n_images: int) -> str:
        pics = "".join(f"Picture {i + 1}: <|vision_start|><|image_pad|><|vision_end|>"
                       for i in range(n_images))
        return self.template.format(pics + prompt)

    def encode_prompt(self, bundle, prompts, vl_images, max_sequence_length: int = 1024):
        """The base adapter's `encode_prompt` over the condition copies of
        every sample's images (`resize_condition_image`)."""
        small = [[resize_condition_image(np.asarray(im)) for im in images]
                 for images in vl_images]
        return super().encode_prompt(bundle, prompts, small, max_sequence_length)
