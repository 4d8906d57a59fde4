"""The flow-matching LoRA train step, shared by every model family.

Counterpart of qflux_tpu/trainer/train_step.py (`TrainStepConfig`,
`_loss_for_microbatch`, `make_train_step`, `make_lr_schedule`):

    noise ~ N(0,1);  σ ~ sampler;  x_σ = (1-σ)x₀ + σ·ε
    v̂ = DiT(x_σ, cond)          target = ε − x₀
    loss = criterion(v̂, target, masks…);  grads w.r.t. the LoRA tree only

then gradient accumulation over microbatches (means of losses and grads),
clip by the global norm, and the optimizer's update.  JAX's jitted pure
step over a `TrainState` becomes an eager step that updates the LoRA
tensors in place (the optimizer, `trainer/optimizers.py` or
`ops/adam8bit.py`, holds the moments and computes optax's update).  The
"scaling" leaves are differentiated and counted in the global norm, as in
JAX, but never stepped: JAX zeroes their updates after the optimizer's.
An elementwise optimizer is not given them; Prodigy, whose sums run over
the whole tree, holds them and drops their updates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from qflux_tpu_torch.ops.layers import merge_lora
from qflux_tpu_torch.scheduler.flow_match import FlowMatchScheduler, sample_training_sigmas
from qflux_tpu_torch.scheduler.weighting import weights_for_sigmas


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    timestep_sampling: str = "uniform"   # uniform | logit_normal | shift
    logit_mean: float = 0.0
    logit_std: float = 1.0
    sigma_shift: float = 3.0
    weighting_scheme: str = "none"       # none | bell | half_bell | table
    # per-timestep loss weights for scheme="table"; excluded from eq/hash
    weighting_table: Any = dataclasses.field(default=None, compare=False)
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 1


# Batch keys shared across samples (RoPE id tables, shape manifests) rather
# than carrying a leading batch axis: never split into microbatches.
SHARED_BATCH_KEY_PREFIXES = ("img_ids", "txt_ids", "rope_", "img_shapes")

# predict_velocity(merged_params, batch, noisy_latents, sigma) -> [B, S_img, C]
PredictFn = Callable[[Any, dict, torch.Tensor, torch.Tensor], torch.Tensor]


def draw_noise_and_sigma(generator: torch.Generator, latents, cfg: TrainStepConfig):
    """ε ~ N(0, 1) in f32 then latents' dtype, and σ from the configured
    sampler in latents' dtype, as the JAX step draws them."""
    noise = torch.randn(latents.shape, generator=generator, device=latents.device,
                        dtype=torch.float32).to(latents.dtype)
    sigma = sample_training_sigmas(generator, latents.shape[0], scheme=cfg.timestep_sampling,
                                   logit_mean=cfg.logit_mean, logit_std=cfg.logit_std,
                                   shift=cfg.sigma_shift)
    return noise, sigma.to(latents.dtype)


def _loss_for_microbatch(base_params, lora, batch, noise, sigma,
                         predict_velocity: PredictFn, criterion, cfg: TrainStepConfig):
    """The loss of one microbatch at the given noise and σ (the JAX function
    draws them from its key; here the caller does, so a test can inject
    them)."""
    latents = batch["image_latents"]
    noisy = FlowMatchScheduler.add_noise(latents, noise, sigma)
    target = FlowMatchScheduler.training_target(latents, noise)
    pred = predict_velocity(merge_lora(base_params, lora), batch, noisy, sigma)
    weighting = None
    if cfg.weighting_scheme != "none":
        weighting = weights_for_sigmas(sigma, cfg.weighting_scheme,
                                       table=cfg.weighting_table)[:, None, None]
    return criterion(pred, target, weighting=weighting, edit_mask=batch.get("edit_mask"),
                     attention_mask=batch.get("attention_mask"))


def lora_leaves(lora) -> tuple[list, list]:
    """(trainable a/b tensors, scaling tensors) of a LoRA tree."""
    params = [leaf[k] for leaf in lora.values() for k in ("a", "b")]
    scalings = [leaf["scaling"] for leaf in lora.values()]
    return params, scalings


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ ||t||²) in f32, as optax.global_norm."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def _microbatches(batch: dict, n: int):
    if n == 1:
        return [batch]
    b_total = batch["image_latents"].shape[0]
    if b_total % n:
        raise ValueError(f"batch size {b_total} not divisible by grad_accum_steps={n}")
    micro = b_total // n
    split = {k for k, v in batch.items()
             if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == b_total
             and not k.startswith(SHARED_BATCH_KEY_PREFIXES)}
    return [{k: (v[i * micro:(i + 1) * micro] if k in split else v) for k, v in batch.items()}
            for i in range(n)]


def make_train_step(predict_velocity: PredictFn, criterion, optimizer: torch.optim.Optimizer,
                    lr_schedule: Callable[[int], float],
                    cfg: TrainStepConfig = TrainStepConfig(), first_update: int = 0):
    """Returns `step(base_params, lora, batch, generator, noise=None,
    sigma=None) -> {"loss", "grad_norm", "lr"}`.

    `optimizer` holds the LoRA's a/b tensors (`lora_leaves`); the step
    updates them in place.  With cfg.grad_accum_steps = n > 1 the step takes
    the same flat [B, …] batch and runs n microbatches of B/n, averaging
    losses and gradients.  noise / σ are drawn per microbatch from
    `generator` unless given for the whole batch (a test's injection).  The
    learning rate of update k (from 0) is lr_schedule(k), as optax evaluates
    its schedule at the update count; `first_update` is the count of the
    step's first call (a resumed run's global_step).  `step.began_update`
    says whether its last call reached the optimizer's update (an error
    before it left the LoRA as it was).
    """
    count = first_update

    def step(base_params, lora, batch, generator, noise=None, sigma=None):
        nonlocal count
        step.began_update = False
        params, scalings = lora_leaves(lora)
        leaves = params + scalings
        if not all(t.requires_grad and t.is_leaf for t in leaves):
            raise ValueError("the LoRA tensors must be leaves that require grad "
                             "(ops/layers.py:mark_trainable)")
        for t in leaves:
            t.grad = None
        n = cfg.grad_accum_steps
        loss_sum = 0.0
        for i, mb in enumerate(_microbatches(batch, n)):
            lat = mb["image_latents"]
            if noise is None:
                nz, sg = draw_noise_and_sigma(generator, lat, cfg)
            else:
                b = lat.shape[0]
                nz, sg = noise[i * b:(i + 1) * b], sigma[i * b:(i + 1) * b]
            loss = _loss_for_microbatch(base_params, lora, mb, nz, sg, predict_velocity,
                                        criterion, cfg)
            (loss / n).backward()
            loss_sum = loss_sum + loss.detach().float()
        for t in leaves:  # a leaf the forward never reached has a zero gradient
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        gnorm = global_norm([t.grad for t in leaves])
        if cfg.max_grad_norm > 0:  # clip by the global norm
            scale = torch.clamp(cfg.max_grad_norm / (gnorm + 1e-12), max=1.0)
            for t in leaves:
                t.grad.mul_(scale)
        lr = lr_schedule(count)
        for group in optimizer.param_groups:
            group["lr"] = lr
        step.began_update = True
        optimizer.step()
        count += 1
        return {"loss": loss_sum / n, "grad_norm": gnorm, "lr": lr}

    step.began_update = False
    return step


def _linear(init: float, end: float, steps: int):
    """optax.linear_schedule; non-positive steps → the constant init value."""
    if steps <= 0:
        return lambda c: init
    return lambda c: (init - end) * (1 - min(max(c, 0), steps) / steps) + end


def _join(schedules, boundaries):
    """optax.join_schedules: schedule i + 1 from its boundary on, shifted."""
    def schedule(step):
        out = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = fn(step - boundary)
        return out

    return schedule


def make_lr_schedule(base_lr: float, scheduler_type: str = "constant",
                     warmup_steps: int = 0, total_steps: int = 10000) -> Callable[[int], float]:
    """The JAX package's schedules (diffusers get_scheduler equivalents) as a
    function of the update count, value for value the optax schedules it
    builds — including optax's constant 0 for "constant_with_warmup" at
    warmup 0 (a linear schedule over no steps keeps its init value)."""
    if scheduler_type == "constant" and warmup_steps == 0:
        return lambda step: base_lr
    if scheduler_type in ("constant", "constant_with_warmup"):
        return _linear(0.0, base_lr, warmup_steps)
    if scheduler_type == "cosine":
        decay = max(total_steps, warmup_steps + 1) - warmup_steps

        def cosine(c):
            return base_lr * 0.5 * (1 + math.cos(math.pi * min(c, decay) / decay))

        return _join([_linear(0.0, base_lr, warmup_steps), cosine], [warmup_steps])
    if scheduler_type == "linear":
        return _join([_linear(0.0, base_lr, max(warmup_steps, 1)),
                      _linear(base_lr, 0.0, max(total_steps - warmup_steps, 1))],
                     [warmup_steps])
    raise ValueError(f"unknown lr scheduler {scheduler_type!r}")
