"""Flow-match Euler scheduler: host-side numpy plan, a torch step, and the
training-time noising and σ sampling.

Counterpart of qflux_tpu/scheduler/flow_match.py (`calculate_shift`,
`time_shift`, `SamplerPlan`, `FlowMatchScheduler.sampling_plan` / `.step` /
`.add_noise` / `.training_target`, `sample_training_sigmas`).  Conventions as
there: sigma = t/1000 in (0, 1]; x_t = (1 - σ) x0 + σ ε; the model predicts
v = ε - x0; Euler: x_{i+1} = x_i + (σ_{i+1} - σ_i) v.  Random draws come from
an explicit `torch.Generator`; they are not `jax.random`'s bits, so the tests
compare distributions, or inject the same numbers into both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUM_TRAIN_TIMESTEPS = 1000
BASE_IMAGE_SEQ_LEN = 256
MAX_IMAGE_SEQ_LEN = 4096
BASE_SHIFT = 0.5
MAX_SHIFT = 1.15


def calculate_shift(image_seq_len: int, base_seq_len: int = BASE_IMAGE_SEQ_LEN,
                    max_seq_len: int = MAX_IMAGE_SEQ_LEN, base_shift: float = BASE_SHIFT,
                    max_shift: float = MAX_SHIFT) -> float:
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def time_shift(mu: float, sigma: float, t):
    """diffusers FlowMatch 'exponential' time shift."""
    return np.exp(mu) / (np.exp(mu) + (1 / t - 1) ** sigma)


@dataclasses.dataclass(frozen=True)
class SamplerPlan:
    """sigmas has num_steps+1 entries (terminal 0 appended), float32;
    timesteps = sigmas[:-1] * 1000."""

    sigmas: np.ndarray
    timesteps: np.ndarray

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)


class FlowMatchScheduler:
    def __init__(self, num_train_timesteps: int = NUM_TRAIN_TIMESTEPS, shift: float = 3.0,
                 use_dynamic_shifting: bool = True,
                 base_image_seq_len: int = BASE_IMAGE_SEQ_LEN,
                 max_image_seq_len: int = MAX_IMAGE_SEQ_LEN,
                 base_shift: float = BASE_SHIFT, max_shift: float = MAX_SHIFT,
                 shift_terminal: float | None = None):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.use_dynamic_shifting = use_dynamic_shifting
        self.base_image_seq_len = base_image_seq_len
        self.max_image_seq_len = max_image_seq_len
        self.base_shift = base_shift
        self.max_shift = max_shift
        self.shift_terminal = shift_terminal

    def sampling_plan(self, num_steps: int, image_seq_len: int | None = None) -> SamplerPlan:
        sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
        if self.use_dynamic_shifting:
            if image_seq_len is None:
                raise ValueError("dynamic shifting requires image_seq_len")
            mu = calculate_shift(image_seq_len, self.base_image_seq_len,
                                 self.max_image_seq_len, self.base_shift, self.max_shift)
            sigmas = time_shift(mu, 1.0, sigmas)
        else:
            sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        if self.shift_terminal:
            one_minus = 1.0 - sigmas
            scale = one_minus[-1] / (1.0 - self.shift_terminal)
            sigmas = 1.0 - one_minus / scale
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        return SamplerPlan(sigmas=sigmas, timesteps=sigmas[:-1] * self.num_train_timesteps)

    @staticmethod
    def add_noise(x0, noise, sigma):
        """x_t = (1-σ)x0 + σ·ε, σ ∈ [0,1], broadcast over trailing dims."""
        sigma = sigma.reshape(sigma.shape + (1,) * (x0.dim() - sigma.dim()))
        return (1.0 - sigma) * x0 + sigma * noise

    @staticmethod
    def training_target(x0, noise):
        return noise - x0

    @staticmethod
    def step(latents, v_pred, sigma: np.float32, sigma_next: np.float32):
        """latents + (σ_next - σ)·v in float32; the σ difference is taken in
        float32, as in JAX."""
        d = float(np.float32(sigma_next) - np.float32(sigma))
        return latents + d * v_pred.float()


def sample_training_sigmas(generator: torch.Generator, batch_size: int,
                           scheme: str = "uniform", logit_mean: float = 0.0,
                           logit_std: float = 1.0, shift: float = 3.0):
    """σ ∈ (0, 1) for the train step, [batch_size] f32 on the generator's
    device.  "uniform": U[0, 1) (the FLUX trainer); "logit_normal":
    sigmoid(N(mean, std)) through the static shift (the Qwen trainer);
    "shift": U[0, 1) through the static shift."""
    kw = {"generator": generator, "device": generator.device}
    if scheme in ("uniform", "shift"):
        u = torch.rand(batch_size, **kw)
        return shift * u / (1 + (shift - 1) * u) if scheme == "shift" else u
    if scheme == "logit_normal":
        s = torch.sigmoid(torch.randn(batch_size, **kw) * logit_std + logit_mean)
        return shift * s / (1 + (shift - 1) * s)
    raise ValueError(f"unknown timestep sampling scheme {scheme!r}")
