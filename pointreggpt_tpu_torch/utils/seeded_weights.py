"""Weights of a U-Net drawn from a seed with numpy alone.

``fill_seeded(net, seed)`` gives any process the same weights from the same
seed, with no framework's initializer in the way: the PyTorch port and the
JAX package (through ``pointreggpt_tpu/utils/torch_port.py``) then run one
set of weights, and a reference computed by one can be rebuilt by the other.

In sorted ``state_dict()`` key order, from one
``numpy.random.default_rng(seed)``:

- GroupNorm and channel-LayerNorm scales are 1 and their shifts 0 (no
  draw);
- other weights are normal / sqrt(fan_in) (fan_in: all dims but the
  first);
- biases are normal x ``BIAS_STD``;
- the frequencies of a Fourier time embedding
  (``RandomOrLearnedSinusoidalPosEmb.weights``, learned or frozen) are
  standard normal, the module's own init;
- each LinearAttention's output projection is then scaled by
  ``ATTN_OUT_GAIN`` and its bias set to 0: the block averages its values
  over all n tokens (the reference's v / (h w)), so with weights of unit
  gain its output, some 1e-6, would vanish under the bias ahead of its
  LayerNorm, and the U-Net's output would not depend on the attention;
- a MaskUNet's output bias is then set to ``mask_out_bias``
  (``MASK_OUT_BIAS`` unless asked otherwise; None keeps the draw): its
  keep probability sits far above the 0.99 threshold, so the keep decision
  does not hang on the last bits of either package's arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from pointreggpt_tpu_torch.models.blocks import (
    ChannelLayerNorm, LinearAttention, RandomOrLearnedSinusoidalPosEmb)
from pointreggpt_tpu_torch.models.unet import MaskUNet

BIAS_STD = 0.02
ATTN_OUT_GAIN = float(1 << 20)  # > n = 65536 tokens at 256^2, by 16
MASK_OUT_BIAS = 12.0


def _norm_keys(net: nn.Module) -> dict:
    """{state_dict key: fill value} of the norm scales and shifts."""
    keys = {}
    for name, mod in net.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, nn.GroupNorm):
            keys[pre + "weight"], keys[pre + "bias"] = 1.0, 0.0
        elif isinstance(mod, ChannelLayerNorm):
            keys[pre + "g"] = 1.0
    return keys


def _fourier_keys(net: nn.Module) -> set:
    """The state_dict keys of Fourier time-embedding frequencies."""
    return {f"{name}.weights" for name, mod in net.named_modules()
            if isinstance(mod, RandomOrLearnedSinusoidalPosEmb)}


def seeded_state_dict(net: nn.Module, seed: int,
                      mask_out_bias=MASK_OUT_BIAS) -> dict:
    """The seeded fp32 state dict for ``net`` (see the module docstring)."""
    rng = np.random.default_rng(seed)
    norms = _norm_keys(net)
    fourier = _fourier_keys(net)
    out = {}
    for key, ref in sorted(net.state_dict().items()):
        shape = tuple(ref.shape)
        if key in norms:
            w = np.full(shape, norms[key])
        elif key in fourier:
            w = rng.standard_normal(shape)
        elif len(shape) >= 2:
            w = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            w = rng.standard_normal(shape) * BIAS_STD
        out[key] = torch.from_numpy(w.astype(np.float32))
    for name, mod in net.named_modules():
        if isinstance(mod, LinearAttention):
            out[f"{name}.to_out.0.weight"] *= ATTN_OUT_GAIN
            out[f"{name}.to_out.0.bias"].zero_()
    if isinstance(net, MaskUNet) and mask_out_bias is not None:
        out["final_conv.0.bias"] = torch.full_like(out["final_conv.0.bias"],
                                                   mask_out_bias)
    return out


def fill_seeded(net: nn.Module, seed: int,
                mask_out_bias=MASK_OUT_BIAS) -> nn.Module:
    """Load :func:`seeded_state_dict` into ``net``; returns ``net``."""
    net.load_state_dict(seeded_state_dict(net, seed, mask_out_bias))
    return net
