from qflux_tpu_torch.losses.losses import (
    AttentionMaskMseLoss,
    MaskEditLoss,
    MseLoss,
    map_mask_to_latent,
)

__all__ = ["MseLoss", "MaskEditLoss", "AttentionMaskMseLoss", "map_mask_to_latent"]
