"""The DiffusionUNet and MaskUNet of the PyTorch port, and guided-diffusion's
ADM as a second denoiser."""

from pointreggpt_tpu_torch.models.adm import ADMUNet
from pointreggpt_tpu_torch.models.unet import DiffusionUNet, MaskUNet

__all__ = ["ADMUNet", "DiffusionUNet", "MaskUNet"]
