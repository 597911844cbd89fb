"""Dataset generation (the main path), the Tester and gt.log of the
PyTorch port."""

from pointreggpt_tpu_torch.generate.generator import Generator
from pointreggpt_tpu_torch.generate.gt import gather_gt, generate_gt
from pointreggpt_tpu_torch.generate.tester import Tester

__all__ = ["Generator", "Tester", "gather_gt", "generate_gt"]
