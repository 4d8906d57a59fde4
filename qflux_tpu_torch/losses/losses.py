"""Pure-function losses over packed latent sequences.

Counterpart of qflux_tpu/losses/losses.py, with the same math and the same
reductions:

  * MseLoss — weighted MSE, per-sample-mean-then-batch-mean reduction;
  * MaskEditLoss — foreground/background-weighted MSE over edit regions;
  * AttentionMaskMseLoss — channel-invariant token loss for padded batches;
  * map_mask_to_latent — image-space mask → packed-latent token weights.

Every loss takes the full kwargs set (weighting / edit_mask /
attention_mask) and ignores what it does not use.

Under data parallelism each rank holds its rows of the global batch, and
`data` (a `DataShard`: this rank's index among the data ranks, their
number, their process group) makes a loss return the rank's SHARE of the
global loss, so that the shares sum over the data ranks to JAX's
global-batch value (and their gradients, summed, to its gradient): "mean"
reductions divide the rank's mean of per-sample means by the number of
ranks (the ranks hold equal row counts), `AttentionMaskMseLoss` divides by
the global Σa (summed over the ranks, eps added once), and "sum" is the
rank's own sum.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DataShard:
    """This rank's place among the data ranks (dp × fsdp): `index` of
    `size`, reducing over `group` (None: one rank, nothing to reduce)."""

    index: int = 0
    size: int = 1
    group: object = None

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the data ranks (no gradient flows through it)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        t = t.detach().clone()
        dist.all_reduce(t, group=self.group)
        return t


def _share(x, data):
    """A rank's mean as its share of the global mean."""
    return x if data is None or data.size == 1 else x / data.size


def map_mask_to_latent(image_mask, vae_scale: int = 8):
    """[B, H, W] binary image mask → [B, seq] packed-latent token weights:
    avg-pool vae_scale× (VAE downsampling), then max over each 2×2 packing
    patch (max keeps thin edit regions alive)."""
    b, h, w = image_mask.shape
    lh, lw = h // vae_scale, w // vae_scale
    m = image_mask.float()[:, : lh * vae_scale, : lw * vae_scale]
    m = m.reshape(b, lh, vae_scale, lw, vae_scale).mean(dim=(2, 4))
    m = m.reshape(b, lh // 2, 2, lw // 2, 2).amax(dim=(2, 4))
    return m.reshape(b, (lh // 2) * (lw // 2))


def _sample_mean(x):
    """Mean over all non-batch dims, then over batch."""
    return x.reshape(x.shape[0], -1).mean(dim=1).mean()


def _sq_err(model_pred, target, weighting):
    err = (model_pred.float() - target.float()) ** 2
    return err if weighting is None else weighting.float() * err


def _edit_weights(edit_mask, fg: float, bg: float):
    em = edit_mask.float()
    return em * fg + (1.0 - em) * bg


@dataclasses.dataclass(frozen=True)
class MseLoss:
    reduction: str = "mean"

    def __call__(self, model_pred, target, weighting=None, data=None, **_):
        err = _sq_err(model_pred, target, weighting)
        if weighting is not None and self.reduction == "mean":
            return _share(_sample_mean(err), data)
        if self.reduction == "none":
            return err
        if self.reduction == "sum":
            return err.sum()
        return _share(err.mean(), data)


@dataclasses.dataclass(frozen=True)
class MaskEditLoss:
    foreground_weight: float = 2.0
    background_weight: float = 1.0
    reduction: str = "mean"

    def __call__(self, model_pred, target, weighting=None, edit_mask=None, data=None, **_):
        err = _sq_err(model_pred, target, weighting)
        if edit_mask is None:
            edit_mask = torch.ones(model_pred.shape[:2], device=model_pred.device)
        err = err * _edit_weights(edit_mask, self.foreground_weight,
                                  self.background_weight)[..., None]
        if self.reduction == "none":
            return err
        if self.reduction == "sum":
            return err.sum()
        return _share(_sample_mean(err), data)


@dataclasses.dataclass(frozen=True)
class AttentionMaskMseLoss:
    """Channel-mean per token, then the average over attention-mask-valid
    tokens only: padding tokens contribute exactly zero."""

    foreground_weight: float = 2.0
    background_weight: float = 1.0
    eps: float = 1e-12
    reduction: str = "mean"

    def __call__(self, model_pred, target, attention_mask=None, edit_mask=None,
                 weighting=None, data=None, **_):
        err = _sq_err(model_pred, target, weighting)
        if edit_mask is not None:
            err = err * _edit_weights(edit_mask, self.foreground_weight,
                                      self.background_weight)[..., None]
        token_loss = err.mean(dim=-1)  # [B, T]
        a = (torch.ones_like(token_loss) if attention_mask is None
             else attention_mask.float())
        if self.reduction == "none":
            return token_loss * a
        if self.reduction == "sum":
            return (token_loss * a).sum()
        total = a.sum() if data is None else data.sum(a.sum())
        return (token_loss * a).sum() / (total + self.eps)
