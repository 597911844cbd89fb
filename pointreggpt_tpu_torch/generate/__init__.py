"""Dataset generation (the main path) of the PyTorch port."""

from pointreggpt_tpu_torch.generate.generator import Generator

__all__ = ["Generator"]
