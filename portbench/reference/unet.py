"""Plain fp32 forwards of PointRegGPT's two U-Nets, written from the
published model (Chen-Suyi/PointRegGPT, after lucidrains'
denoising-diffusion-pytorch ``Unet``): functions of a state dict with the
reference's key names, plain ``torch`` operations, no kernels, no bake.

- :func:`diffusion_unet`: the depth-inpainting denoiser, conditioned on the
  timestep (sinusoidal embedding) and the (fx, fy, cx, cy) vector.
- :func:`mask_unet`: the depth-correction net: the depth featurized as
  ``[d, 3x3 valid min, min - d]``, a sigmoid at the end.

Weight standardization and the channel LayerNorm use ``eps``, which the
published code takes from the input dtype (1e-5 in fp32, 1e-3 in half
precision): a configuration served in bf16 states 1e-3. Every product's
operands pass through ``rnd`` and its output through ``rnd.out``
(``precision.rounding``): the identity for the reference, a lower precision
for the control. Norms, softmaxes and sums stay fp32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
SD = Dict[str, Tensor]
HEADS, DIM_HEAD = 4, 32


def _conv(rnd, x, w, b=None, stride=1, padding=0):
    return rnd.out(F.conv2d(rnd(x), rnd(w), None if b is None else b.float(),
                            stride, padding))


def _linear(rnd, x, w, b=None):
    return rnd.out(F.linear(rnd(x), rnd(w), None if b is None else b.float()))


def _ws_conv(rnd, x, w, b, eps):
    w = w.float()
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
    return _conv(rnd, x, (w - mean) * torch.rsqrt(var + eps), b, 1, 1)


def _chan_ln(x, g, eps):
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g.float()


def _block(sd, p, x, groups, eps, rnd, scale_shift=None):
    h = _ws_conv(rnd, x, sd[p + "proj.weight"], sd[p + "proj.bias"], eps)
    h = F.group_norm(h, groups, sd[p + "norm.weight"].float(),
                     sd[p + "norm.bias"].float(), 1e-5)
    if scale_shift is not None:
        scale, shift = scale_shift
        h = h * (scale + 1.0) + shift
    return F.silu(h)


def _resnet(sd, p, x, cond, groups, eps, rnd):
    scale_shift = None
    if cond is not None and p + "mlp.1.weight" in sd:
        emb = _linear(rnd, F.silu(cond), sd[p + "mlp.1.weight"],
                      sd[p + "mlp.1.bias"])
        scale_shift = emb[:, :, None, None].chunk(2, dim=1)
    h = _block(sd, p + "block1.", x, groups, eps, rnd, scale_shift)
    h = _block(sd, p + "block2.", h, groups, eps, rnd)
    if p + "res_conv.weight" in sd:
        x = _conv(rnd, x, sd[p + "res_conv.weight"], sd[p + "res_conv.bias"])
    return h + x


def _linear_attention(sd, p, x, eps, rnd):
    """Residual(PreNorm(LinearAttention)) at prefix ``p``."""
    b, c, hh, ww = x.shape
    n = hh * ww
    xn = _chan_ln(x, sd[p + "fn.norm.g"], eps)
    qkv = _conv(rnd, xn, sd[p + "fn.fn.to_qkv.weight"])
    q, k, v = (t.reshape(b, HEADS, DIM_HEAD, n) for t in qkv.chunk(3, dim=1))
    q = q.softmax(dim=-2) * DIM_HEAD ** -0.5
    k = k.softmax(dim=-1)
    v = v / n
    context = rnd.out(torch.einsum("bhdn,bhen->bhde", rnd(k), rnd(v)))
    out = rnd.out(torch.einsum("bhde,bhdn->bhen", rnd(context), rnd(q)))
    out = out.reshape(b, HEADS * DIM_HEAD, hh, ww)
    out = _conv(rnd, out, sd[p + "fn.fn.to_out.0.weight"],
                sd[p + "fn.fn.to_out.0.bias"])
    return x + _chan_ln(out, sd[p + "fn.fn.to_out.1.g"], eps)


def _attention(sd, p, x, eps, rnd):
    """Residual(PreNorm(Attention)) at prefix ``p``."""
    b, c, hh, ww = x.shape
    n = hh * ww
    xn = _chan_ln(x, sd[p + "fn.norm.g"], eps)
    qkv = _conv(rnd, xn, sd[p + "fn.fn.to_qkv.weight"])
    q, k, v = (t.reshape(b, HEADS, DIM_HEAD, n) for t in qkv.chunk(3, dim=1))
    q = q * DIM_HEAD ** -0.5
    sim = rnd.out(torch.matmul(rnd(q).transpose(-1, -2), rnd(k)))  # b h i j
    attn = sim.softmax(dim=-1)
    out = rnd.out(torch.matmul(rnd(attn), rnd(v).transpose(-1, -2)))
    out = out.transpose(-1, -2).reshape(b, HEADS * DIM_HEAD, hh, ww)
    return x + _conv(rnd, out, sd[p + "fn.fn.to_out.weight"],
                     sd[p + "fn.fn.to_out.bias"])


def _stage_count(sd: SD) -> int:
    return 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("downs."))


def _body(sd, x, cond, groups, eps, rnd):
    x = _conv(rnd, x, sd["init_conv.weight"], sd["init_conv.bias"], 1,
              sd["init_conv.weight"].shape[-1] // 2)
    r = x
    hs = []
    stages = _stage_count(sd)
    for i in range(stages):
        p = f"downs.{i}."
        x = _resnet(sd, p + "0.", x, cond, groups, eps, rnd)
        hs.append(x)
        x = _resnet(sd, p + "1.", x, cond, groups, eps, rnd)
        x = _linear_attention(sd, p + "2.", x, eps, rnd)
        hs.append(x)
        if i < stages - 1:
            x = _conv(rnd, x, sd[p + "3.weight"], sd[p + "3.bias"], 2, 1)
        else:
            x = _conv(rnd, x, sd[p + "3.weight"], sd[p + "3.bias"], 1, 1)
    x = _resnet(sd, "mid_block1.", x, cond, groups, eps, rnd)
    x = _attention(sd, "mid_attn.", x, eps, rnd)
    x = _resnet(sd, "mid_block2.", x, cond, groups, eps, rnd)
    for i in range(stages):
        p = f"ups.{i}."
        x = _resnet(sd, p + "0.", torch.cat([x, hs.pop()], 1), cond, groups,
                    eps, rnd)
        x = _resnet(sd, p + "1.", torch.cat([x, hs.pop()], 1), cond, groups,
                    eps, rnd)
        x = _linear_attention(sd, p + "2.", x, eps, rnd)
        if i < stages - 1:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = _conv(rnd, x, sd[p + "3.1.weight"], sd[p + "3.1.bias"], 1, 1)
        else:
            x = _conv(rnd, x, sd[p + "3.weight"], sd[p + "3.bias"], 1, 1)
    return _resnet(sd, "final_res_block.", torch.cat([x, r], 1), cond,
                   groups, eps, rnd)


def sinusoidal(t: Tensor, dim: int) -> Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device) *
                      -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([args.sin(), args.cos()], dim=-1)


def diffusion_unet(sd: SD, x: Tensor, t: Tensor, param_cond: Tensor, *,
                   groups: int, eps: float,
                   rnd: Callable[[Tensor], Tensor]) -> Tensor:
    """(b, 1, h, w) noisy depth, (b,) timesteps, (b, 4) intrinsics ->
    (b, 1, h, w) prediction, fp32."""
    dim = sd["init_conv.weight"].shape[0]
    te = sinusoidal(t, dim)
    te = _linear(rnd, te, sd["time_mlp.1.weight"], sd["time_mlp.1.bias"])
    te = _linear(rnd, F.gelu(te), sd["time_mlp.3.weight"],
                 sd["time_mlp.3.bias"])
    pe = _linear(rnd, param_cond.float(), sd["param_mlp.0.weight"],
                 sd["param_mlp.0.bias"])
    pe = _linear(rnd, F.gelu(pe), sd["param_mlp.2.weight"],
                 sd["param_mlp.2.bias"])
    cond = torch.cat([te, pe], dim=-1)
    h = _body(sd, x.float(), cond, groups, eps, rnd)
    return _conv(rnd, h, sd["final_conv.weight"], sd["final_conv.bias"])


def min_pool3(d: Tensor) -> Tensor:
    """3x3 min with +inf beyond the border, (b, h, w)."""
    return -F.max_pool2d(-d[:, None], 3, 1, 1)[:, 0]


def depth_features(depth: Tensor) -> Tensor:
    """(b, 1, h, w) depth -> (b, 3, h, w) [d, min of the valid (nonzero)
    3x3 neighbours, min - d]; a neighbourhood with none keeps the raw
    minimum."""
    d = depth[:, 0].float()
    mn = min_pool3(torch.where(d == 0, torch.full_like(d, float("inf")), d))
    mn = torch.where(torch.isinf(mn), min_pool3(d), mn)
    return torch.stack([d, mn, mn - d], dim=1)


def mask_unet_logits(sd: SD, depth: Tensor, *, groups: int, eps: float,
                     rnd: Callable[[Tensor], Tensor]) -> Tensor:
    """(b, 1, h, w) depth in [0, 1] -> (b, 1, h, w) keep logits, fp32."""
    h = _body(sd, depth_features(depth), None, groups, eps, rnd)
    return _conv(rnd, h, sd["final_conv.0.weight"], sd["final_conv.0.bias"])


def mask_unet(sd: SD, depth: Tensor, **kw) -> Tensor:
    """The keep probability."""
    return torch.sigmoid(mask_unet_logits(sd, depth, **kw))


def forward_fn(config: dict, rnd) -> Callable:
    """The reference forward of a configuration file's net, with its
    stated groups and eps."""
    net = config["net"]
    kw = dict(groups=config["resnet_block_groups"], eps=config["ws_eps"],
              rnd=rnd)
    if net == "DiffusionUNet":
        return lambda sd, x, t, cond: diffusion_unet(sd, x, t, cond, **kw)
    if net == "MaskUNet":
        return lambda sd, x: mask_unet(sd, x, **kw)
    raise ValueError(f"unknown net {net!r}")


def in_blocks(fn: Callable, rows: int, *args: Optional[Tensor]) -> Tensor:
    """``fn`` over the leading dim in blocks of ``rows`` (a reference
    forward at a served batch fits beside nothing else)."""
    b = args[0].shape[0]
    outs = [fn(*(a[i:i + rows] for a in args)) for i in range(0, b, rows)]
    return torch.cat(outs, dim=0)
