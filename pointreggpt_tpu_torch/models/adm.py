"""ADM: guided-diffusion's U-Net (Dhariwal & Nichol 2021, "Diffusion Models
Beat GANs on Image Synthesis", github.com/openai/guided-diffusion), the
denoiser DDNM samples with, as a denoiser of the port's generation path.

The module tree follows guided-diffusion's ``UNetModel`` with
``resblock_updown`` and ``use_scale_shift_norm`` on, so state-dict keys and
shapes are guided-diffusion's (``time_embed.{0,2}``, ``input_blocks.N``,
``middle_block``, ``output_blocks.N``, ``out.{0,2}``; inside blocks
``in_layers``, ``emb_layers``, ``out_layers``, ``skip_connection``,
``norm``, ``qkv``, ``proj_out``) and a checkpoint of matching shapes loads
directly. ``256x256_diffusion_uncond`` is ``ADMUNet()`` with
``in_channels=3, out_channels=6``; the depth denoiser takes 1 and 2
(``config.ADMConfig``).

- Timestep embedding: ``[cos, sin]`` of ``t exp(-ln(1e4) i / (c / 2))``,
  then Linear, SiLU, Linear to 4 c.
- ResBlock: ``GN32 -> SiLU -> [resample] -> conv3x3``, the input resampled
  the same way (average pooling down, nearest up); then
  ``SiLU(GN32(h) (1 + scale) + shift) -> conv3x3`` with scale and shift
  from the embedding (AdaGN); ``skip(x) + h``, skip the identity or a 1x1
  conv.
- AttentionBlock: ``GN32 -> 1x1 qkv`` in the legacy per-head order
  ``[q_h | k_h | v_h]``, ``softmax(q k^T / sqrt(d)) v`` per head on K2
  (heads of ``num_head_channels``; q, k and v are strided views of the
  projection, heads 3 d apart, so nothing is copied), ``1x1 proj_out``,
  the residual.
- Output: ``GN32 -> SiLU -> conv3x3`` to ``out_channels``; with twice the
  input's channels the second half is the learned variance, which DDIM
  does not read.

Dtypes as the PointRegGPT nets: params fp32; GroupNorm, the scale-shift
and the softmax in fp32; convs and linears through ``blocks.Conv2d`` /
``Linear`` in ``dtype`` (bf16 on the card: guided-diffusion's fp16, whose
linears stay fp32, and whose norms return fp16); the last conv fp32. No
dropout: the net samples. The stream between blocks is in ``dtype``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pointreggpt_tpu_torch.models.blocks import (Conv2d, Linear, _from_rows,
                                                norm_act)
from pointreggpt_tpu_torch.ops.attention import multihead_attention, rows
from pointreggpt_tpu_torch.ops.conv import conv2d

Tensor = torch.Tensor
GROUPS = 32


def timestep_embedding(t: Tensor, dim: int,
                       max_period: float = 10000.0) -> Tensor:
    """guided-diffusion's sinusoidal embedding: (b,) -> (b, dim) fp32,
    cosines first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm32(nn.GroupNorm):
    """32-group GroupNorm, computed in fp32 by ``blocks.norm_act`` with the
    work that follows it."""

    def __init__(self, channels: int):
        super().__init__(GROUPS, channels, eps=1e-5)


class Conv1x1(nn.Conv1d):
    """guided-diffusion's ``conv_nd(1, ...)`` 1x1 projection (weight
    (out, in, 1)) on a (b, c, h, w) tensor, in ``dtype``, through
    ``ops/conv.py::conv2d``."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__(cin, cout, 1)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        d = self.compute_dtype
        w = self.weight.to(d)
        cout, cin, _ = w.shape
        # a channels-last (cout, cin, 1, 1) view: the conv then returns
        # channels-last output whatever the input's layout (a GroupNorm's
        # is NCHW on the card), and K2 reads q, k, v as views of it
        w = w.as_strided((cout, cin, 1, 1), (cin, 1, cin, cin))
        return conv2d(x.to(d), w, self.bias.to(d), 1, 0)


class EmbedSequential(nn.Sequential):
    """guided-diffusion's ``TimestepEmbedSequential``: ResBlocks get the
    embedding too."""

    def forward(self, x: Tensor, emb: Tensor) -> Tensor:
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class ResBlock(nn.Module):
    """AdaGN ResBlock (``use_scale_shift_norm``), with ``up`` / ``down`` its
    BigGAN-style resampling step."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None, *, up: bool = False,
                 down: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        out = out_channels or channels
        self.up, self.down = up, down
        self.compute_dtype = dtype
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(),
            Conv2d(channels, out, 3, padding=1, dtype=dtype))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_channels, 2 * out, dtype=dtype))
        # index 2 is guided-diffusion's dropout, off for sampling
        self.out_layers = nn.Sequential(
            GroupNorm32(out), nn.SiLU(), nn.Identity(),
            Conv2d(out, out, 3, padding=1, dtype=dtype))
        self.skip_connection = (nn.Identity() if out == channels else
                                Conv2d(channels, out, 1, dtype=dtype))

    def _resample(self, x: Tensor) -> Tensor:
        if self.up:
            return F.interpolate(x, scale_factor=2, mode="nearest")
        if self.down:
            return F.avg_pool2d(x, 2, 2)
        return x

    def forward(self, x: Tensor, emb: Tensor) -> Tensor:
        d = self.compute_dtype
        h = norm_act(self.in_layers[0], x, out_dtype=d)
        h = self.in_layers[2](self._resample(h))
        x = self._resample(x)
        scale_shift = self.emb_layers(emb)[:, :, None, None].chunk(2, dim=1)
        h = norm_act(self.out_layers[0], h, scale_shift, out_dtype=d)
        h = self.out_layers[3](h)
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Multi-head self-attention over the pixels, heads of
    ``num_head_channels``; the core is K2."""

    def __init__(self, channels: int, num_head_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if channels % num_head_channels:
            raise ValueError(f"AttentionBlock: {channels} channels in heads "
                             f"of {num_head_channels}")
        self.heads = channels // num_head_channels
        self.dim_head = num_head_channels
        self.norm = GroupNorm32(channels)
        self.qkv = Conv1x1(channels, 3 * channels, dtype)
        self.proj_out = Conv1x1(channels, channels, dtype)

    def forward(self, x: Tensor) -> Tensor:
        b, c, hh, ww = x.shape
        n = hh * ww
        xn = norm_act(self.norm, x, silu=False,
                      out_dtype=self.qkv.compute_dtype)
        qkv = rows(self.qkv(xn)).reshape(b, n, self.heads, 3, self.dim_head)
        out = multihead_attention(qkv[:, :, :, 0], qkv[:, :, :, 1],
                                  qkv[:, :, :, 2],
                                  scale=self.dim_head ** -0.5)
        out = _from_rows(out.reshape(b, n, c), hh, ww)
        return x + self.proj_out(out)


class ADMUNet(nn.Module):
    """guided-diffusion's UNetModel with AdaGN and up/down ResBlocks.

    forward(x (b, in_channels, h, w), time (b,)) -> fp32
    (b, out_channels, h, w). ``attention_ds`` are the downsampling rates
    with an AttentionBlock (guided-diffusion's ``attention_resolutions``
    after ``image_size // res``).
    """

    denoiser = "adm"
    has_ws_conv = False  # ``bake_inference`` standardizes nothing

    def __init__(self, in_channels: int = 1, model_channels: int = 256,
                 out_channels: int = 2, num_res_blocks: int = 2,
                 attention_ds: Sequence[int] = (8, 16, 32),
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
                 num_head_channels: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels = in_channels
        self.model_channels = model_channels
        self.learned_variance = out_channels == 2 * in_channels
        self.dtype = dtype
        emb = 4 * model_channels
        self.time_embed = nn.Sequential(
            Linear(model_channels, emb, dtype=dtype), nn.SiLU(),
            Linear(emb, emb, dtype=dtype))

        def res(cin, cout=None, **kw):
            return ResBlock(cin, emb, cout, dtype=dtype, **kw)

        def attn(c):
            return AttentionBlock(c, num_head_channels, dtype)

        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([EmbedSequential(
            Conv2d(in_channels, ch, 3, padding=1, dtype=dtype))])
        skips, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_ds:
                    layers.append(attn(ch))
                self.input_blocks.append(EmbedSequential(*layers))
                skips.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(EmbedSequential(res(ch, down=True)))
                skips.append(ch)
                ds *= 2
        self.middle_block = EmbedSequential(res(ch), attn(ch), res(ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [res(ch + skips.pop(), mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_ds:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(res(ch, up=True))
                    ds //= 2
                self.output_blocks.append(EmbedSequential(*layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 nn.Conv2d(ch, out_channels, 3, padding=1))
        self.out[2].keep_fp32 = True

    def forward(self, x: Tensor, time: Tensor,
                param_cond: Optional[Tensor] = None) -> Tensor:
        """The unconditional net reads no ``param_cond`` (the Generator's
        intrinsics vector): DDNM conditions it through the null-space
        projection."""
        emb = self.time_embed(timestep_embedding(time, self.model_channels))
        hs = []
        h = x
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        conv = self.out[2]
        return F.conv2d(norm_act(self.out[0], h), conv.weight.float(),
                        conv.bias.float(), padding=1)
