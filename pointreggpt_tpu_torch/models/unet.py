"""The two PointRegGPT U-Nets as torch modules (NCHW, channels_last).

Port of ``pointreggpt_tpu/models/unet.py`` with the reference's module
tree (Unet / MaskUnet), so state-dict keys match published checkpoints:

- :class:`DiffusionUNet`: the depth-inpainting denoiser, conditioned on the
  timestep and the (fx, fy, cx, cy) intrinsics vector.
- :class:`MaskUNet`: the same topology without conditioning; input
  featurized by ``depth_augment``, output squashed by a sigmoid.

Compute runs in ``dtype`` (bfloat16 on the card); params and norms stay
fp32; ``final_conv`` is fp32. Every forward runs K1 eight times (the
LinearAttention blocks at a 4-stage depth) and K2 once (``mid_attn``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pointreggpt_tpu_torch.models.blocks import (
    Attention,
    Conv2d,
    Downsample,
    LinearAttention,
    Linear,
    PreNormResidual,
    RandomOrLearnedSinusoidalPosEmb,
    ResnetBlock,
    SinusoidalPosEmb,
    Upsample,
    depth_augment,
)


def _stages(init_dim, dim, dim_mults, cond_dim, groups, dtype, remat=False):
    dims = [init_dim] + [dim * m for m in dim_mults]
    in_out = list(zip(dims[:-1], dims[1:]))
    downs, ups = nn.ModuleList(), nn.ModuleList()
    for i, (d_in, d_out) in enumerate(in_out):
        last = i >= len(in_out) - 1
        downs.append(nn.ModuleList([
            ResnetBlock(d_in, d_in, cond_dim, groups, dtype, remat),
            ResnetBlock(d_in, d_in, cond_dim, groups, dtype, remat),
            PreNormResidual(d_in, LinearAttention(d_in, dtype=dtype), dtype),
            Downsample(d_in, d_out, dtype) if not last else
            Conv2d(d_in, d_out, 3, padding=1, dtype=dtype),
        ]))
    mid = dims[-1]
    for i, (d_in, d_out) in enumerate(reversed(in_out)):
        last = i == len(in_out) - 1
        ups.append(nn.ModuleList([
            ResnetBlock(d_out + d_in, d_out, cond_dim, groups, dtype, remat),
            ResnetBlock(d_out + d_in, d_out, cond_dim, groups, dtype, remat),
            PreNormResidual(d_out, LinearAttention(d_out, dtype=dtype),
                            dtype),
            Upsample(d_out, d_in, dtype) if not last else
            Conv2d(d_out, d_in, 3, padding=1, dtype=dtype),
        ]))
    return downs, ups, mid


def _unet_body(net, x, cond):
    """init_conv -> down stages -> mid -> up stages -> final_res_block."""
    x = net.init_conv(x)
    r = x
    hs = []
    for block1, block2, attn, down in net.downs:
        x = block1(x, cond)
        hs.append(x)
        x = block2(x, cond)
        x = attn(x)
        hs.append(x)
        x = down(x)
    x = net.mid_block1(x, cond)
    x = net.mid_attn(x)
    x = net.mid_block2(x, cond)
    for block1, block2, attn, up in net.ups:
        x = block1(torch.cat([x, hs.pop()], dim=1), cond)
        x = block2(torch.cat([x, hs.pop()], dim=1), cond)
        x = attn(x)
        x = up(x)
    return net.final_res_block(torch.cat([x, r], dim=1), cond)


def _final(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x.float(), conv.weight.float(), conv.bias.float())


class DiffusionUNet(nn.Module):
    """Depth-inpainting diffusion denoiser (reference Unet).

    forward(x (b, channels, h, w), time (b,), param_cond (b, 4)) -> fp32
    (b, channels, h, w) prediction (x0 for the production objective).
    ``remat`` recomputes every ResnetBlock in the backward instead of
    keeping its activations (training memory; gradients do not change).

    The reference's optional surface: ``learned_variance`` doubles the
    output channels; ``learned_sinusoidal_cond`` (learned) or
    ``random_fourier_features`` (frozen) embed the timestep with
    ``learned_sinusoidal_dim`` Fourier frequencies, ``time_mlp.0.weights``,
    instead of the sinusoidal embedding. GaussianDiffusion takes neither
    (``config.build_diffusion`` refuses them, as the JAX package does).
    """

    denoiser = "unet"

    def __init__(self, dim: int = 64, param_cond_dim: int = 4,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 1,
                 resnet_block_groups: int = 8,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 learned_variance: bool = False,
                 learned_sinusoidal_cond: bool = False,
                 random_fourier_features: bool = False,
                 learned_sinusoidal_dim: int = 16):
        super().__init__()
        self.dim, self.channels, self.dtype = dim, channels, dtype
        self.learned_variance = learned_variance
        self.learned_sinusoidal_cond = learned_sinusoidal_cond
        self.random_fourier_features = random_fourier_features
        time_dim = param_dim = dim * 4
        self.init_conv = Conv2d(channels, dim, 7, padding=3, dtype=dtype)
        if learned_sinusoidal_cond or random_fourier_features:
            pos_emb = RandomOrLearnedSinusoidalPosEmb(
                learned_sinusoidal_dim, is_random=random_fourier_features)
            fourier_dim = learned_sinusoidal_dim + 1
        else:
            pos_emb, fourier_dim = SinusoidalPosEmb(dim), dim
        self.time_mlp = nn.Sequential(
            pos_emb, Linear(fourier_dim, time_dim, dtype=dtype),
            nn.GELU(), Linear(time_dim, time_dim, dtype=dtype))
        self.param_mlp = nn.Sequential(
            Linear(param_cond_dim, param_dim, dtype=dtype), nn.GELU(),
            Linear(param_dim, param_dim, dtype=dtype))
        cond_dim = time_dim + param_dim
        g = resnet_block_groups
        self.remat = remat
        self.downs, self.ups, mid = _stages(dim, dim, dim_mults, cond_dim,
                                            g, dtype, remat)
        self.mid_block1 = ResnetBlock(mid, mid, cond_dim, g, dtype, remat)
        self.mid_attn = PreNormResidual(mid, Attention(mid, dtype=dtype),
                                        dtype)
        self.mid_block2 = ResnetBlock(mid, mid, cond_dim, g, dtype, remat)
        self.final_res_block = ResnetBlock(dim * 2, dim, cond_dim, g, dtype,
                                           remat)
        self.final_conv = nn.Conv2d(
            dim, channels * (2 if learned_variance else 1), 1)
        self.final_conv.keep_fp32 = True

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                param_cond: torch.Tensor) -> torch.Tensor:
        t = self.time_mlp(time)
        p = self.param_mlp(param_cond)
        cond = torch.cat([t, p], dim=-1)
        x = _unet_body(self, x, cond)
        return _final(self.final_conv, x)


class MaskUNet(nn.Module):
    """Depth-correction mask network (reference MaskUnet):
    (b, 1, h, w) depth in [0, 1] -> (b, 1, h, w) keep probability."""

    def __init__(self, dim: int = 64, out_dim: int = 1,
                 dim_mults: Sequence[int] = (1, 2, 4, 8),
                 resnet_block_groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.init_conv = Conv2d(3, dim, 7, padding=3, dtype=dtype)
        g = resnet_block_groups
        self.downs, self.ups, mid = _stages(dim, dim, dim_mults, None, g,
                                            dtype)
        self.mid_block1 = ResnetBlock(mid, mid, None, g, dtype)
        self.mid_attn = PreNormResidual(mid, Attention(mid, dtype=dtype),
                                        dtype)
        self.mid_block2 = ResnetBlock(mid, mid, None, g, dtype)
        self.final_res_block = ResnetBlock(dim * 2, dim, None, g, dtype)
        self.final_conv = nn.Sequential(nn.Conv2d(dim, out_dim, 1),
                                        nn.Sigmoid())
        self.final_conv[0].keep_fp32 = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = depth_augment(x).contiguous(memory_format=torch.channels_last)
        x = _unet_body(self, x, None)
        return torch.sigmoid(_final(self.final_conv[0], x))
