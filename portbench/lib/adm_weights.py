"""ADM weights from a seed, made on the device in one draw, as
``lib/weights.py`` makes the PointRegGPT nets' (sorted keys, one
``torch.randn`` from a ``torch.Generator`` on the device), with ADM's
names:

- GroupNorm32 scales 1 and shifts 0 (``in_layers.0``, ``out_layers.0``,
  an attention block's ``norm``, ``out.0``);
- other weights scaled by 1 / sqrt(fan_in), biases by ``BIAS_STD``;
- in each attention block, the q and k rows of ``qkv`` scaled by
  ``QK_GAIN``: the scores q k^T / sqrt(64) then spread by about
  ``QK_GAIN`` ^ 2 = 2, so a row's softmax over up to 1,024 keys leans on
  a few tens of them and the block moves the output (with unit gain it is
  flatter, its output nearer the values' mean). At a small size on the
  CPU the bf16 port's gap to the fp32 reference is a seventh of fp8's at
  unit gain, a tenth at sqrt(2) and a fifth at 2 (0.11-0.14, the peaked
  scores' bf16 rounding): sqrt(2) keeps the port furthest below the
  control.

guided-diffusion initializes ``proj_out`` and each ResBlock's last conv
to zero; a trained net has them nonzero, and a zero draw would take the
attention and the ResBlocks' branches out of the output.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.lib.weights import BIAS_STD

QK_GAIN = 2.0 ** 0.5
NORMS = ("in_layers.0.", "out_layers.0.", "norm.", "out.0.")


def is_norm(key: str) -> bool:
    return key.startswith("out.0.") or any(f".{n}" in key for n in NORMS)


def seeded(layout: Dict[str, Tuple[int, ...]], seed: int, device,
           head_channels: int) -> Dict[str, torch.Tensor]:
    """fp32 weights of ``layout`` ({key: shape}, guided-diffusion's names)
    drawn from ``seed`` on ``device``; attention heads of
    ``head_channels``."""
    keys = sorted(k for k in layout if not is_norm(k))
    sizes = [math.prod(layout[k]) for k in keys]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for key, part in zip(keys, torch.split(flat, sizes)):
        shape = layout[key]
        if len(shape) >= 2:
            out[key] = part.reshape(shape) / math.sqrt(math.prod(shape[1:]))
        else:
            out[key] = part.reshape(shape) * BIAS_STD
        if key.endswith((".qkv.weight", ".qkv.bias")):
            # the rows are per head [q | k | v]: scale q and k
            out[key].view(-1, 3, head_channels, *shape[1:])[:, :2] *= QK_GAIN
    for key in layout:
        if is_norm(key):
            fill = 0.0 if key.endswith(".bias") else 1.0
            out[key] = torch.full(layout[key], fill, device=device)
    return out
