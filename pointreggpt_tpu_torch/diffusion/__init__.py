"""Diffusion schedules and the DDIM + DDNM sampler of the PyTorch port."""

from pointreggpt_tpu_torch.diffusion.gaussian import GaussianDiffusion

__all__ = ["GaussianDiffusion"]
