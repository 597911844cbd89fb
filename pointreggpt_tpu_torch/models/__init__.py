"""The DiffusionUNet and MaskUNet of the PyTorch port."""

from pointreggpt_tpu_torch.models.unet import DiffusionUNet, MaskUNet

__all__ = ["DiffusionUNet", "MaskUNet"]
