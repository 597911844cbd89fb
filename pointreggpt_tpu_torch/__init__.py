"""PointRegGPT generation on PyTorch + CUDA (NVIDIA Hopper).

A port of the JAX package ``pointreggpt_tpu`` beside it, which stays the
numerical reference. This package imports torch, numpy, PIL, the standard
library and, where they are used, scipy (FID's matrix square root, the
registration loaders' Euler rotations) only — never JAX or any module of
``pointreggpt_tpu``.

Entry points run on ``cuda``. The CPU is used only when the caller asks for
it, with ``device="cpu"`` or ``PRGPT_PLATFORM=cpu`` (the variable the JAX
CLIs read); on the CPU every hand-written kernel is replaced by its plain
PyTorch version. With no GPU and no such request, :func:`resolve_device`
raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``device`` wins when given; otherwise ``PRGPT_PLATFORM`` (``cpu`` or
    ``cuda``/``gpu``); otherwise ``cuda``. Under torchrun (``LOCAL_RANK``
    set) a ``cuda`` with no index is the process's own GPU,
    ``cuda:<LOCAL_RANK>``. Raises when CUDA is asked for (explicitly or by
    default) and no GPU is visible.
    """
    if device is None:
        platform = os.environ.get("PRGPT_PLATFORM", "").strip().lower()
        device = "cpu" if platform == "cpu" else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pointreggpt_tpu_torch runs on a CUDA GPU and none is visible; "
            "pass device='cpu' or set PRGPT_PLATFORM=cpu to run the plain "
            "PyTorch path on the CPU")
    local_rank = os.environ.get("LOCAL_RANK")
    if dev.type == "cuda" and dev.index is None and local_rank:
        dev = torch.device("cuda", int(local_rank))
    return dev


# public surface; imported after resolve_device, which these modules use
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion  # noqa: E402
from pointreggpt_tpu_torch.generate import Generator  # noqa: E402
from pointreggpt_tpu_torch.models import DiffusionUNet, MaskUNet  # noqa: E402

__all__ = ["resolve_device", "GaussianDiffusion", "Generator",
           "DiffusionUNet", "MaskUNet"]
