"""Plain fp32 forward of guided-diffusion's ADM U-Net (Dhariwal & Nichol
2021, github.com/openai/guided-diffusion, ``UNetModel`` with
``resblock_updown`` and ``use_scale_shift_norm``), as a function of a state
dict with guided-diffusion's key names: plain ``torch`` operations, no
kernels, no bake. With it, the DDIM + DDNM transition of a noise-predicting
net on guided-diffusion's beta schedules.

The benchmark's reference and the CPU tests' (``tests/
test_torch_port_adm.py``); it imports nothing of the port.

Departures from guided-diffusion, all of the served configuration, none
of the arithmetic here:

- the served net computes in bf16 where guided-diffusion's ``use_fp16``
  computes in fp16 (an H100 serves bf16); this reference is fp32
  throughout, with TF32 off (:func:`adm_unet` sets
  ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` to False);
- depth has one channel: the first conv takes 1 channel and the last
  returns 2 (the noise and the learned variance) instead of 3 and 6;
- no dropout: the net samples.

Every product's operands pass through ``rnd`` and its output through
``rnd.out`` (the benchmark's ``precision.rounding``): the identity here, a
lower precision for a control. Norms, softmaxes and sums stay fp32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
SD = Dict[str, Tensor]
GROUPS = 32


class _Exact:
    """The identity rounding."""

    def __call__(self, x: Tensor) -> Tensor:
        return x.float()

    def out(self, y: Tensor) -> Tensor:
        return y


EXACT = _Exact()


def _conv(rnd, x, w, b, padding=0):
    return rnd.out(F.conv2d(rnd(x), rnd(w), b.float(), 1, padding))


def _conv1d(rnd, x, w, b):
    return rnd.out(F.conv1d(rnd(x), rnd(w), b.float()))


def _linear(rnd, x, w, b):
    return rnd.out(F.linear(rnd(x), rnd(w), b.float()))


def _norm(sd, p, x):
    """GroupNorm32 at prefix ``p``: 32 groups, eps 1e-5, fp32."""
    return F.group_norm(x.float(), GROUPS, sd[p + "weight"].float(),
                        sd[p + "bias"].float(), 1e-5)


def timestep_embedding(t: Tensor, dim: int,
                       max_period: float = 10000.0) -> Tensor:
    """[cos, sin] of t exp(-ln(max_period) i / half), i < half = dim / 2."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _resample(x: Tensor, how: Optional[str]) -> Tensor:
    if how == "up":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    if how == "down":
        return F.avg_pool2d(x, 2, 2)
    return x


def _resblock(sd, p, x, emb, rnd, how=None):
    """ResBlock at prefix ``p``: GN, SiLU, [resample], conv; AdaGN with the
    embedding's scale and shift, SiLU, conv; plus the (resampled) input,
    through a 1x1 conv where the channels change."""
    h = _resample(F.silu(_norm(sd, p + "in_layers.0.", x)), how)
    x = _resample(x.float(), how)
    h = _conv(rnd, h, sd[p + "in_layers.2.weight"], sd[p + "in_layers.2.bias"],
              1)
    e = _linear(rnd, F.silu(emb), sd[p + "emb_layers.1.weight"],
                sd[p + "emb_layers.1.bias"])
    scale, shift = e[:, :, None, None].chunk(2, dim=1)
    h = _norm(sd, p + "out_layers.0.", h) * (1.0 + scale) + shift
    h = _conv(rnd, F.silu(h), sd[p + "out_layers.3.weight"],
              sd[p + "out_layers.3.bias"], 1)
    if p + "skip_connection.weight" in sd:
        x = _conv(rnd, x, sd[p + "skip_connection.weight"],
                  sd[p + "skip_connection.bias"])
    return x + h


def _attention(sd, p, x, head_channels, rnd):
    """AttentionBlock at prefix ``p`` with QKVAttentionLegacy: the qkv
    projection's channels are per head [q | k | v]."""
    b, c, hh, ww = x.shape
    heads = c // head_channels
    xn = _norm(sd, p + "norm.", x).reshape(b, c, hh * ww)
    qkv = _conv1d(rnd, xn, sd[p + "qkv.weight"], sd[p + "qkv.bias"])
    q, k, v = qkv.reshape(b * heads, 3 * head_channels, hh * ww).split(
        head_channels, dim=1)
    w = rnd.out(torch.einsum("bct,bcs->bts", rnd(q), rnd(k)))
    w = torch.softmax(w * head_channels ** -0.5, dim=-1)
    a = rnd.out(torch.einsum("bts,bcs->bct", rnd(w), rnd(v)))
    h = _conv1d(rnd, a.reshape(b, c, hh * ww), sd[p + "proj_out.weight"],
                sd[p + "proj_out.bias"])
    return x.float() + h.reshape(b, c, hh, ww)


def _layers(sd, p, x, emb, head_channels, rnd, how=None):
    """One TimestepEmbedSequential at prefix ``p``: a ResBlock, then an
    AttentionBlock where the state dict has one, then a resampling
    ResBlock when ``how`` says so."""
    x = _resblock(sd, p + "0.", x, emb, rnd)
    i = 1
    if p + "1.qkv.weight" in sd:
        x = _attention(sd, p + "1.", x, head_channels, rnd)
        i = 2
    if how is not None:
        x = _resblock(sd, f"{p}{i}.", x, emb, rnd, how)
    return x


def adm_unet(sd: SD, x: Tensor, t: Tensor, *, channel_mult: Sequence[int],
             num_res_blocks: int, num_head_channels: int,
             rnd=EXACT) -> Tensor:
    """(b, in, h, w) noisy input, (b,) timesteps -> (b, out, h, w), fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mc = sd["time_embed.0.weight"].shape[1]
    emb = _linear(rnd, timestep_embedding(t, mc), sd["time_embed.0.weight"],
                  sd["time_embed.0.bias"])
    emb = _linear(rnd, F.silu(emb), sd["time_embed.2.weight"],
                  sd["time_embed.2.bias"])
    h = _conv(rnd, x.float(), sd["input_blocks.0.0.weight"],
              sd["input_blocks.0.0.bias"], 1)
    hs, n = [h], 1
    levels = len(channel_mult)
    for level in range(levels):
        for _ in range(num_res_blocks):
            p = f"input_blocks.{n}."
            h = _resblock(sd, p + "0.", h, emb, rnd)
            if p + "1.qkv.weight" in sd:
                h = _attention(sd, p + "1.", h, num_head_channels, rnd)
            hs.append(h)
            n += 1
        if level != levels - 1:
            h = _resblock(sd, f"input_blocks.{n}.0.", h, emb, rnd, "down")
            hs.append(h)
            n += 1
    h = _resblock(sd, "middle_block.0.", h, emb, rnd)
    h = _attention(sd, "middle_block.1.", h, num_head_channels, rnd)
    h = _resblock(sd, "middle_block.2.", h, emb, rnd)
    n = 0
    for level in reversed(range(levels)):
        for i in range(num_res_blocks + 1):
            how = "up" if level and i == num_res_blocks else None
            h = _layers(sd, f"output_blocks.{n}.", torch.cat([h, hs.pop()], 1),
                        emb, num_head_channels, rnd, how)
            n += 1
    h = F.silu(_norm(sd, "out.0.", h))
    return _conv(rnd, h, sd["out.2.weight"], sd["out.2.bias"], 1)


def layout(in_channels: int, model_channels: int, out_channels: int,
           num_res_blocks: int, attention_ds: Sequence[int],
           channel_mult: Sequence[int],
           num_head_channels: int) -> Dict[str, tuple]:
    """{key: shape} of guided-diffusion's ``UNetModel`` state dict with
    ``resblock_updown`` and ``use_scale_shift_norm`` (dims 2, no class
    embedding), written from its constructor."""
    emb = 4 * model_channels
    out = {"time_embed.0.weight": (emb, model_channels),
           "time_embed.0.bias": (emb,), "time_embed.2.weight": (emb, emb),
           "time_embed.2.bias": (emb,)}

    def res(p, cin, cout):
        out.update({
            p + "in_layers.0.weight": (cin,), p + "in_layers.0.bias": (cin,),
            p + "in_layers.2.weight": (cout, cin, 3, 3),
            p + "in_layers.2.bias": (cout,),
            p + "emb_layers.1.weight": (2 * cout, emb),
            p + "emb_layers.1.bias": (2 * cout,),
            p + "out_layers.0.weight": (cout,),
            p + "out_layers.0.bias": (cout,),
            p + "out_layers.3.weight": (cout, cout, 3, 3),
            p + "out_layers.3.bias": (cout,)})
        if cin != cout:
            out[p + "skip_connection.weight"] = (cout, cin, 1, 1)
            out[p + "skip_connection.bias"] = (cout,)

    def attn(p, c):
        assert c % num_head_channels == 0
        out.update({p + "norm.weight": (c,), p + "norm.bias": (c,),
                    p + "qkv.weight": (3 * c, c, 1), p + "qkv.bias": (3 * c,),
                    p + "proj_out.weight": (c, c, 1),
                    p + "proj_out.bias": (c,)})

    ch = channel_mult[0] * model_channels
    out["input_blocks.0.0.weight"] = (ch, in_channels, 3, 3)
    out["input_blocks.0.0.bias"] = (ch,)
    chans, ds, n = [ch], 1, 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            res(f"input_blocks.{n}.0.", ch, mult * model_channels)
            ch = mult * model_channels
            if ds in attention_ds:
                attn(f"input_blocks.{n}.1.", ch)
            chans.append(ch)
            n += 1
        if level != len(channel_mult) - 1:
            res(f"input_blocks.{n}.0.", ch, ch)
            chans.append(ch)
            ds *= 2
            n += 1
    res("middle_block.0.", ch, ch)
    attn("middle_block.1.", ch)
    res("middle_block.2.", ch, ch)
    n = 0
    for level, mult in reversed(list(enumerate(channel_mult))):
        for i in range(num_res_blocks + 1):
            p = f"output_blocks.{n}."
            res(p + "0.", ch + chans.pop(), mult * model_channels)
            ch = mult * model_channels
            j = 1
            if ds in attention_ds:
                attn(p + "1.", ch)
                j = 2
            if level and i == num_res_blocks:
                res(f"{p}{j}.", ch, ch)
                ds //= 2
            n += 1
    out.update({"out.0.weight": (ch,), "out.0.bias": (ch,),
                "out.2.weight": (out_channels, ch, 3, 3),
                "out.2.bias": (out_channels,)})
    return out


def forward_fn(config: dict, rnd=EXACT) -> Callable:
    """The reference forward of a configuration file's ADM (guided-diffusion
    flag names): ``fn(sd, x, t)``."""
    kw = dict(channel_mult=tuple(config["channel_mult"]),
              num_res_blocks=config["num_res_blocks"],
              num_head_channels=config["num_head_channels"], rnd=rnd)
    return lambda sd, x, t: adm_unet(sd, x, t, **kw)


def alphas_cumprod(schedule: str, timesteps: int) -> np.ndarray:
    """float64 alphas_cumprod of guided-diffusion's named beta schedules."""
    if schedule == "linear":
        scale = 1000.0 / timesteps
        betas = np.linspace(scale * 0.0001, scale * 0.02, timesteps,
                            dtype=np.float64)
    elif schedule == "cosine":
        s = np.arange(timesteps + 1, dtype=np.float64) / timesteps
        f = np.cos((s + 0.008) / 1.008 * math.pi / 2) ** 2
        betas = np.minimum(1 - f[1:] / f[:-1], 0.999)
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return np.cumprod(1.0 - betas)


def ddim_ddnm_step(x: Tensor, eps: Tensor, t: int, t_next: int,
                   img_cond: Tensor, z: Tensor, eta: float,
                   ac: np.ndarray) -> Tensor:
    """x_{t_next} from x_t and the net's noise ``eps`` (both (b, h, w, 1)),
    the (b, h, w, 2) condition and the step's noise ``z``: x0 from the noise,
    clipped to [-1, 1], replaced by the condition on its valid pixels
    (DDNM), then DDIM with the net's own noise."""
    a = float(ac[t])
    x0 = (float(np.sqrt(1.0 / a)) * x -
          float(np.sqrt(1.0 / a - 1.0)) * eps).clamp(-1.0, 1.0)
    valid = ((img_cond[..., 1:2] + 1.0) * 0.5) > 0.5
    x0 = torch.where(valid, img_cond[..., 0:1], x0)
    if t_next < 0:
        return x0
    a_next = float(ac[t_next])
    sigma = float(eta * np.sqrt((1 - a / a_next) * (1 - a_next) / (1 - a)))
    c = float(np.sqrt(max(1 - a_next - sigma ** 2, 0.0)))
    return x0 * float(np.sqrt(a_next)) + c * eps + sigma * z
