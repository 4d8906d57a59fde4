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

Under data parallelism (dp × fsdp ranks, `losses.DataShard`) the step
gives JAX's global-batch numbers on any mesh: each rank holds its rows of
every global microbatch (the Trainer's `_rank_rows` picks them), draws
the noise and σ of the whole global microbatch from the same generator as
every other rank and keeps its rows, the criterion returns the rank's share
of the global loss, and the LoRA gradients are summed over the data ranks
before the global-norm clip (the logged loss too).  Every rank then takes
the same update, so the LoRA stays replicated, as JAX's `_replicate`
keeps it.

A rank that runs out of device memory in the forward or backward tells
the others after its `grads` (`collectives.any_across`), and the step
raises on every rank, so the Trainer's retry runs on all together.  That
holds only where the forward and backward exchange nothing with other
ranks (a dp-only mesh): under a sharded base or the ring
(`Mesh.step_collectives`) the other ranks wait in this step's collectives
and never reach the decision, so the error is raised at once on the rank
that ran out, and its exit ends the run (torchrun stops the other
ranks; without it, NCCL's watchdog times them out).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from qflux_tpu_torch.losses import DataShard
from qflux_tpu_torch.ops.layers import merge_lora
from qflux_tpu_torch.parallel import collectives
from qflux_tpu_torch.parallel.mesh import active_mesh
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


def draw_noise_and_sigma(generator: torch.Generator, latents, cfg: TrainStepConfig,
                         data: DataShard = DataShard()):
    """ε ~ N(0, 1) in f32 then latents' dtype, and σ from the configured
    sampler in latents' dtype, as the JAX step draws them: for the global
    microbatch of which `latents` are this rank's rows (`data`), the rank's
    rows of it."""
    b = latents.shape[0]
    rows = slice(data.index * b, (data.index + 1) * b)
    shape = (b * data.size,) + tuple(latents.shape[1:])
    noise = torch.randn(shape, generator=generator, device=latents.device,
                        dtype=torch.float32).to(latents.dtype)
    sigma = sample_training_sigmas(generator, shape[0], scheme=cfg.timestep_sampling,
                                   logit_mean=cfg.logit_mean, logit_std=cfg.logit_std,
                                   shift=cfg.sigma_shift)
    return noise[rows], sigma.to(latents.dtype)[rows]


def _loss_for_microbatch(base_params, lora, batch, noise, sigma,
                         predict_velocity: PredictFn, criterion, cfg: TrainStepConfig,
                         data: DataShard = DataShard()):
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
                     attention_mask=batch.get("attention_mask"), data=data)


def lora_leaves(lora) -> tuple[list, list]:
    """(trainable a/b tensors, scaling tensors) of a LoRA tree."""
    params = [leaf[k] for leaf in lora.values() for k in ("a", "b")]
    scalings = [leaf["scaling"] for leaf in lora.values()]
    return params, scalings


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ ||t||²) in f32, as optax.global_norm."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def _all_reduce_sum(tensors, data: DataShard) -> None:
    """Sum `tensors` (f32) over the data ranks, in place, in one collective."""
    if data.size == 1 or not tensors:
        return
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=data.group)
    for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


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
    sigma=None, data=None) -> {"loss", "grad_norm", "lr"}`.

    `optimizer` holds the LoRA's a/b tensors (`lora_leaves`); the step
    updates them in place.  With cfg.grad_accum_steps = n > 1 the step takes
    the same flat [B, …] batch and runs n microbatches of B/n, averaging
    losses and gradients.  noise / σ are drawn per microbatch from
    `generator` unless given for the whole batch (a test's injection).  The
    learning rate of update k (from 0) is lr_schedule(k), as optax evaluates
    its schedule at the update count; `first_update` is the count of the
    step's first call (a resumed run's global_step).  `step.began_update`
    says whether its last call reached the optimizer's update (an error
    before it left the LoRA as it was).  `data` (a `losses.DataShard`) is
    this rank's share of a global batch split over data ranks: `batch`
    then holds the rank's rows of each global microbatch in turn, and
    injected noise / σ are the global batch's.  Under a dp-only mesh of
    several ranks a step that runs out of device memory on any rank raises
    on every rank, before the gradients' collective, so that the Trainer's
    retry is every rank's; where the step holds collectives of its own
    (`Mesh.step_collectives`) it raises on the rank that ran out alone.
    """
    count = first_update

    def grads(base_params, lora, batch, generator, noise, sigma, data):
        """The microbatches' forward and backward → the summed loss shares."""
        n = cfg.grad_accum_steps
        loss_sum = 0.0
        for i, mb in enumerate(_microbatches(batch, n)):
            lat = mb["image_latents"]
            if noise is None:  # one process: the draw as it always was
                nz, sg = draw_noise_and_sigma(generator, lat, cfg,
                                              *((data,) if data.size > 1 else ()))
            else:  # the global batch's: this rank's rows of microbatch i
                b = lat.shape[0]
                rows = slice((i * data.size + data.index) * b,
                             (i * data.size + data.index + 1) * b)
                nz, sg = noise[rows], sigma[rows]
            loss = _loss_for_microbatch(base_params, lora, mb, nz, sg, predict_velocity,
                                        criterion, cfg, data)
            (loss / n).backward()
            loss_sum = loss_sum + loss.detach().float()
        return loss_sum

    def step(base_params, lora, batch, generator, noise=None, sigma=None, data=None):
        nonlocal count
        data = data or DataShard()
        step.began_update = False
        params, scalings = lora_leaves(lora)
        leaves = params + scalings
        if not all(t.requires_grad and t.is_leaf for t in leaves):
            raise ValueError("the LoRA tensors must be leaves that require grad "
                             "(ops/layers.py:mark_trainable)")
        for t in leaves:
            t.grad = None
        n = cfg.grad_accum_steps
        failed = None
        try:
            loss_sum = grads(base_params, lora, batch, generator, noise, sigma, data)
        except torch.OutOfMemoryError as err:
            mesh = active_mesh()
            if mesh is not None and mesh.step_collectives:
                raise  # the other ranks wait in this step's collectives
            failed = err
        if collectives.any_across(failed is not None):
            raise failed or torch.OutOfMemoryError("another rank ran out of device memory "
                                                   "in this train step")
        for t in leaves:  # a leaf the forward never reached has a zero gradient
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        if data.size > 1:  # the global gradient and loss: the ranks' shares summed
            loss_sum = torch.as_tensor(loss_sum, dtype=torch.float32,
                                       device=leaves[0].device).reshape(1)
            _all_reduce_sum([t.grad for t in leaves] + [loss_sum], data)
            loss_sum = loss_sum[0]
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
