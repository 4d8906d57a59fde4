"""Flow-match Euler sampling loop.

Counterpart of qflux_tpu/trainer/sampling.py.  The JAX sampler compiles the
loop into one `lax.scan`; here it is a Python loop over the plan that calls
the adapter's `predict_velocity` once per step (twice with true-CFG).
True-CFG mixes neg + s·(pos − neg) and the `guidance_rescale` flag is
carried exactly as in the JAX package (it defaults to False and no caller
sets it — a known divergence kept on purpose, ROADMAP.md queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from qflux_tpu_torch.scheduler.flow_match import FlowMatchScheduler

# predict_velocity(params, batch, latents, sigma) -> [B, S_img, C]
PredictFn = Callable[[Any, dict, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    num_inference_steps: int = 20
    true_cfg_scale: float = 1.0
    guidance_rescale: bool = False  # Qwen norm-rescale of the CFG output


def make_sampler(predict_velocity: PredictFn, cfg: SamplingConfig = SamplingConfig()):
    """Returns `sample(params, batch, latents0, sigmas) -> latents`.

    For true-CFG the batch also holds the negative embeddings under
    "neg_"-prefixed keys; the negative pass sees them under the plain keys.
    The loop runs under `torch.inference_mode`, or `torch.no_grad` where
    `params` is sharded by FSDP2 (whose gathers write into tensors made
    outside inference mode).
    """
    use_cfg = cfg.true_cfg_scale > 1.0

    def sample(params, batch, latents, sigmas: np.ndarray):
        from torch.distributed.fsdp import FSDPModule

        mode = torch.no_grad if isinstance(params, FSDPModule) else torch.inference_mode
        with mode():
            return _loop(params, batch, latents, sigmas)

    def _loop(params, batch, latents, sigmas):
        lat = latents
        for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
            t = torch.full((lat.shape[0],), float(sigma), dtype=lat.dtype, device=lat.device)
            v = predict_velocity(params, batch, lat, t)
            if use_cfg:
                neg_batch = {**batch}
                for key in list(batch):
                    if key.startswith("neg_"):
                        neg_batch[key[4:]] = batch[key]
                v_neg = predict_velocity(params, neg_batch, lat, t)
                v_cfg = v_neg + cfg.true_cfg_scale * (v - v_neg)
                if cfg.guidance_rescale:
                    norm_pos = torch.linalg.vector_norm(v.float(), dim=-1, keepdim=True)
                    norm_cfg = torch.linalg.vector_norm(v_cfg.float(), dim=-1, keepdim=True)
                    v_cfg = (v_cfg.float() * (norm_pos / (norm_cfg + 1e-8))).to(v.dtype)
                v = v_cfg
            lat = FlowMatchScheduler.step(lat.float(), v, sigma, sigma_next).to(latents.dtype)
        return lat

    return sample
