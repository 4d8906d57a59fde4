from qflux_tpu_torch.losses.losses import (
    AttentionMaskMseLoss,
    DataShard,
    MaskEditLoss,
    MseLoss,
    map_mask_to_latent,
)

__all__ = ["DataShard", "MseLoss", "MaskEditLoss", "AttentionMaskMseLoss", "map_mask_to_latent"]
