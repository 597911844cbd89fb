"""U-Net building blocks as torch modules (NCHW, channels_last).

Port of ``pointreggpt_tpu/models/blocks.py``. Parameter names follow the
reference's torch state dict (``block1.proj.weight``,
``fn.fn.to_qkv.weight``, ``fn.fn.to_out.1.g``, ...), so published
checkpoints load directly and ``utils/torch_port.py`` of the JAX package
maps a ``state_dict()`` of these modules onto the JAX tree.

Dtype handling mirrors the JAX package: params stay fp32; every conv and
linear casts its input and weight to the module's compute ``dtype``
(bfloat16 on the card); GroupNorm, the channel LayerNorm and the softmaxes
compute in fp32. A weight that is not fp32 has been baked (``bake.py``):
a WSConv then skips its standardization, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pointreggpt_tpu_torch.core.geometry import min_pool
from pointreggpt_tpu_torch.ops.attention import multihead_attention
from pointreggpt_tpu_torch.ops.linear_attention import fused_linear_attention

Tensor = torch.Tensor


def ws_eps(dtype: torch.dtype) -> float:
    """WSConv / channel-LayerNorm epsilon: 1e-5 at fp32, 1e-3 otherwise."""
    return 1e-5 if dtype == torch.float32 else 1e-3


def _cast(t: Optional[Tensor], dtype: torch.dtype) -> Optional[Tensor]:
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (input, weight and bias cast)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        d = self.compute_dtype
        return F.conv2d(x.to(d), self.weight.to(d), _cast(self.bias, d),
                        self.stride, self.padding)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), _cast(self.bias, d))


class WSConv(Conv2d):
    """Weight-standardized conv: the kernel is standardized over
    (in, kh, kw) per output channel in fp32 before the conv, unless it was
    baked (non-fp32)."""

    def forward(self, x: Tensor) -> Tensor:
        d = self.compute_dtype
        w = self.weight
        if w.dtype == torch.float32:
            mean = w.mean(dim=(1, 2, 3), keepdim=True)
            var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
            w = (w - mean) * torch.rsqrt(var + ws_eps(d))
        return F.conv2d(x.to(d), w.to(d), _cast(self.bias, d), self.stride,
                        self.padding)


def channel_layer_norm(x: Tensor, g: Tensor, dtype: torch.dtype) -> Tensor:
    """Scale-only LayerNorm over dim 1 in fp32 (biased variance)."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = xf.var(dim=1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + ws_eps(dtype)) * g).to(dtype)


class ChannelLayerNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        return channel_layer_norm(x, self.g, self.compute_dtype)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: Tensor) -> Tensor:
        half = self.dim // 2
        freqs = torch.exp(
            torch.arange(half, dtype=torch.float32, device=t.device) *
            -(math.log(10000.0) / (half - 1)))
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """Fourier features of the timestep, ``[t, sin(2 pi t w), cos(2 pi t
    w)]``: dim + 1 features from dim / 2 frequencies ``weights`` (normal
    at init). ``is_random`` freezes them (``requires_grad=False``; still
    in the state dict, as the reference keeps them)."""

    def __init__(self, dim: int, is_random: bool = False):
        super().__init__()
        if dim % 2:
            raise ValueError(f"RandomOrLearnedSinusoidalPosEmb: odd dim {dim}")
        self.weights = nn.Parameter(torch.randn(dim // 2),
                                    requires_grad=not is_random)

    def forward(self, t: Tensor) -> Tensor:
        t = t.float()[:, None]
        freqs = t * self.weights.float()[None, :] * 2 * math.pi
        return torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class Block(nn.Module):
    """WSConv3x3 -> GroupNorm (fp32) -> optional (scale + 1, shift) ->
    SiLU -> compute dtype."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = WSConv(dim, dim_out, 3, padding=1, dtype=dtype)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: Tensor,
                scale_shift: Optional[Tuple[Tensor, Tensor]] = None
                ) -> Tensor:
        x = self.norm(self.proj(x).float())
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale.float() + 1.0) + shift.float()
        return F.silu(x).to(self.compute_dtype)


class ResnetBlock(nn.Module):
    """Two Blocks (the first conditioned by SiLU -> Linear of the
    embedding) + 1x1-conv residual.

    With ``remat`` set, a forward under autograd keeps only the block's
    inputs and recomputes its body in the backward
    (``torch.utils.checkpoint``, the port of ``nn.remat(ResnetBlock)``).
    """

    def __init__(self, dim: int, dim_out: int, cond_dim: Optional[int] = None,
                 groups: int = 8, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.mlp = (nn.Sequential(nn.SiLU(), Linear(cond_dim, dim_out * 2,
                                                    dtype=dtype))
                    if cond_dim else None)
        self.block1 = Block(dim, dim_out, groups, dtype)
        self.block2 = Block(dim_out, dim_out, groups, dtype)
        self.res_conv = (Conv2d(dim, dim_out, 1, dtype=dtype)
                         if dim != dim_out else nn.Identity())

    def forward(self, x: Tensor, cond: Optional[Tensor] = None) -> Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._body, x, cond, use_reentrant=False)
        return self._body(x, cond)

    def _body(self, x: Tensor, cond: Optional[Tensor]) -> Tensor:
        scale_shift = None
        if self.mlp is not None and cond is not None:
            emb = self.mlp(cond)[:, :, None, None]
            scale_shift = emb.chunk(2, dim=1)
        h = self.block1(x, scale_shift)
        h = self.block2(h)
        return h + self.res_conv(x)


def _to_rows(x: Tensor) -> Tensor:
    """(b, c, h, w) -> contiguous (b, h*w, c); a view for a channels_last
    tensor, a copy otherwise."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()


def _from_rows(y: Tensor, h: int, w: int) -> Tensor:
    """(b, h*w, c) -> (b, c, h, w) in channels_last memory (a view)."""
    b, _, c = y.shape
    return y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class LinearAttention(nn.Module):
    """Linear attention block; its whole body is kernel K1."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv2d(hidden, dim, 1),
                                    ChannelLayerNorm(dim, dtype))
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        b, c, h, w = x.shape
        d = self.compute_dtype
        out = fused_linear_attention(
            _to_rows(x.to(d)), self.to_qkv.weight[:, :, 0, 0].t(),
            self.to_out[0].weight[:, :, 0, 0].t(), self.to_out[0].bias,
            self.to_out[1].g.reshape(c), self.heads, self.dim_head,
            ws_eps(d))
        return _from_rows(out, h, w)


class Attention(nn.Module):
    """Full softmax attention at the bottleneck; the core is kernel K2."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.to_out = Conv2d(hidden, dim, 1, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        b, c, h, w = x.shape
        n = h * w
        qkv = _to_rows(self.to_qkv(x)).reshape(b, n, 3, self.heads,
                                               self.dim_head)
        out = multihead_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                  scale=self.dim_head**-0.5)
        out = _from_rows(out.reshape(b, n, self.heads * self.dim_head), h, w)
        return self.to_out(out)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fn = fn
        self.norm = ChannelLayerNorm(dim, dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.fn(self.norm(x))


class PreNormResidual(nn.Module):
    """x + fn(ChannelLayerNorm(x)), named as the reference's
    Residual(PreNorm(...))."""

    def __init__(self, dim: int, fn: nn.Module,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fn = PreNorm(dim, fn, dtype)

    def forward(self, x: Tensor) -> Tensor:
        return x + self.fn(x)


def Downsample(dim: int, dim_out: int,
               dtype: torch.dtype = torch.float32) -> Conv2d:
    """4x4 conv, stride 2, padding 1."""
    return Conv2d(dim, dim_out, 4, 2, 1, dtype=dtype)


def Upsample(dim: int, dim_out: int,
             dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """Nearest 2x upsample -> 3x3 conv (its weight stays fp32 in a bake)."""
    conv = Conv2d(dim, dim_out, 3, padding=1, dtype=dtype)
    conv.keep_fp32 = True
    return nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"), conv)


def depth_augment(depth: Tensor, invalid_number: float = 0.0) -> Tensor:
    """(b, 1, h, w) depth -> (b, 3, h, w) [depth, 3x3 valid min,
    min - depth]; an all-invalid neighborhood falls back to the raw
    min-pool."""
    d = depth[:, 0].float()
    d_cln = torch.where(d == invalid_number, torch.full_like(d, float("inf")),
                        d)
    mn = min_pool(d_cln, window=3, stride=1)
    mn0 = min_pool(d, window=3, stride=1)
    mn = torch.where(torch.isinf(mn), mn0, mn)
    return torch.stack([d, mn, mn - d], dim=1)


def depth_downsample(depth: Tensor, invalid_number: float = 0.0) -> Tensor:
    """(b, 1, h, w) depth -> (b, 1, ceil(h / 2), ceil(w / 2)): a 2x2
    min-pool (stride 2, "SAME": an odd edge is padded with +inf) over the
    valid pixels; a window with none keeps the raw minimum, the invalid
    value."""
    d = depth[:, 0].float()
    d_cln = torch.where(d == invalid_number, torch.full_like(d, float("inf")),
                        d)

    def pool(x):
        x = F.pad(-x[:, None], (0, x.shape[-1] % 2, 0, x.shape[-2] % 2),
                  value=float("-inf"))
        return -F.max_pool2d(x, 2, 2)[:, 0]

    down = pool(d_cln)
    down = torch.where(torch.isinf(down), pool(d), down)
    return down[:, None]
