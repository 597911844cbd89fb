"""Inference bake: pre-standardize WSConv kernels, pre-cast weights.

Port of ``pointreggpt_tpu/models/bake.py``. Done once at load, not in each
of the 250 chain steps:

- WSConv kernels: standardized in fp32 with correctly rounded ``/ sqrt``,
  then cast to the compute dtype (``WSConv`` skips standardizing a
  non-fp32 kernel);
- other conv / linear weights: cast to the compute dtype (the forward's
  cast is then the identity);
- ``final_conv`` and the upsample conv (marked ``keep_fp32``), biases and
  norm scales stay fp32.

Each baked weight is the fp32 standardization rounded once, so it differs
from the per-step path by at most one bf16 ulp. Baked modules are
inference-only.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from pointreggpt_tpu_torch.models.blocks import WSConv, ws_eps


def standardize(weight: torch.Tensor, eps: float) -> torch.Tensor:
    """(o, i, kh, kw) fp32 kernel standardized per output channel."""
    w = weight.detach().float()
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
    return (w - mean) / torch.sqrt(var + eps)


def bake_inference(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A baked inference copy of ``model`` for compute ``dtype``; the
    model itself is returned unchanged when ``dtype`` is fp32."""
    if dtype == torch.float32:
        return model
    baked = copy.deepcopy(model).eval().requires_grad_(False)
    n_std = 0
    for mod in baked.modules():
        if not isinstance(mod, (nn.Conv2d, nn.Linear)):
            continue
        if getattr(mod, "keep_fp32", False):
            continue
        if isinstance(mod, WSConv):
            w = standardize(mod.weight, ws_eps(dtype))
            n_std += 1
        else:
            w = mod.weight.detach()
        mod.weight = nn.Parameter(w.to(dtype), requires_grad=False)
    if n_std == 0:
        raise ValueError("bake_inference standardized no WSConv kernel; "
                         "the model holds no Block")
    return baked
