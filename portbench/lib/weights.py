"""Weights from a seed, made on the device in one draw.

For a net's state-dict layout (its keys and shapes, in sorted key order),
one ``torch.randn`` over all the weights from a ``torch.Generator`` on the
device, then per key:

- norm scales (GroupNorm ``norm.weight``, channel-LayerNorm ``g``) 1 and
  GroupNorm shifts 0;
- other weights scaled by 1 / sqrt(fan_in), biases by ``BIAS_STD``;
- each LinearAttention's output projection scaled by ``ATTN_OUT_GAIN``, its
  bias 0: the block averages its values over all n pixels, so at unit gain
  its output, some 1e-6, would vanish under the bias ahead of its
  LayerNorm and the net would not depend on the attention;
- the MaskUNet's output bias set to the configuration's
  ``mask_out_bias``: the keep probabilities then sit around the 0.99
  threshold's high side, so most pixels are kept and the keep decision
  still reads the net.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

BIAS_STD = 0.02
ATTN_OUT_GAIN = float(1 << 20)


def _is_norm(key: str) -> bool:
    return key.endswith("norm.weight") or key.endswith("norm.bias") or \
        key.endswith(".g")


def seeded(layout: Dict[str, Tuple[int, ...]], seed: int, device,
           mask_out_bias=None) -> Dict[str, torch.Tensor]:
    """fp32 weights of ``layout`` ({key: shape}) drawn from ``seed`` on
    ``device``."""
    keys = sorted(k for k in layout if not _is_norm(k))
    sizes = [math.prod(layout[k]) for k in keys]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for key, part in zip(keys, torch.split(flat, sizes)):
        shape = layout[key]
        if len(shape) >= 2:
            w = part.reshape(shape) / math.sqrt(math.prod(shape[1:]))
        else:
            w = part.reshape(shape) * BIAS_STD
        out[key] = w
    for key in layout:
        if _is_norm(key):
            fill = 0.0 if key.endswith("norm.bias") else 1.0
            out[key] = torch.full(layout[key], fill, device=device)
        elif key.endswith("fn.fn.to_out.0.weight"):
            out[key] = out[key] * ATTN_OUT_GAIN
        elif key.endswith("fn.fn.to_out.0.bias"):
            out[key] = torch.zeros_like(out[key])
    if mask_out_bias is not None:
        out["final_conv.0.bias"].fill_(float(mask_out_bias))
    return out


def layout_of(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{key: shape} of a module's state dict."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
