"""Plain reference of the diffusion process: the sigmoid schedule, the DDIM
time grid, one DDIM + DDNM transition, and the training loss. Written from
the published model (lucidrains' ``GaussianDiffusion`` as PointRegGPT
extends it), in float64 tables and fp32 tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Tensor = torch.Tensor


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def tables(timesteps: int) -> Dict[str, np.ndarray]:
    """alphas_cumprod and the pred_x0 loss weight (the SNR) of the sigmoid
    schedule (start -3, end 3, tau 1; betas clipped to [0, 0.999])."""
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    v_start = float(_sigmoid(np.float32(-3.0)))
    v_end = float(_sigmoid(np.float32(3.0)))
    ac = (-_sigmoid(t * 6.0 - 3.0) + v_end) / (v_end - v_start)
    ac = ac / ac[0]
    betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.999)
    alphas_cumprod = np.cumprod(1.0 - betas)
    snr = alphas_cumprod / (1 - alphas_cumprod)
    return {"alphas_cumprod": alphas_cumprod, "loss_weight": snr}


def ddim_next(timesteps: int, sampling_timesteps: int) -> Dict[int, int]:
    """{t: t_next} of the DDIM grid (the fp32 ``linspace(-1, T - 1, S + 1)``
    truncated to integers; the last t_next is -1)."""
    times = torch.linspace(-1, timesteps - 1,
                           sampling_timesteps + 1).int().tolist()
    times = list(reversed(times))
    return dict(zip(times[:-1], times[1:]))


def ddim_ddnm_step(x: Tensor, out: Tensor, t: int, t_next: int,
                   img_cond: Tensor, z: Tensor, eta: float,
                   ac: np.ndarray) -> Tensor:
    """x_{t_next} from x_t, the net's pred_x0 ``out``, the condition and the
    step's noise ``z`` (all (b, h, w, 1) but the (b, h, w, 2) condition):
    x0 clipped to [-1, 1], the noise estimate taken before the DDNM
    projection replaces x0 on the condition's valid pixels."""
    a = float(ac[t])
    r, rm1 = float(np.sqrt(1.0 / a)), float(np.sqrt(1.0 / a - 1.0))
    x0 = out.clamp(-1.0, 1.0)
    eps = (r * x - x0) / rm1
    valid = ((img_cond[..., 1:2] + 1.0) * 0.5) > 0.5
    x0 = torch.where(valid, img_cond[..., 0:1], x0)
    if t_next < 0:
        return x0
    a_next = float(ac[t_next])
    sigma = float(eta * np.sqrt((1 - a / a_next) * (1 - a_next) / (1 - a)))
    c = float(np.sqrt(max(1 - a_next - sigma ** 2, 0.0)))
    return x0 * float(np.sqrt(a_next)) + c * eps + sigma * z


def training_inputs(img01: Tensor, intrinsic: Tensor, t: Tensor,
                    noise: Tensor, ac: np.ndarray):
    """The net's inputs of one microbatch with the step's drawn ``t`` and
    ``noise``: x_t (NHWC), the (b, 4) intrinsics condition, and x0."""
    x0 = img01.float() * 2.0 - 1.0
    dev = x0.device
    a = torch.as_tensor(ac, device=dev)[t.long()].float()[:, None, None, None]
    x = a.sqrt() * x0 + (1 - a).sqrt() * noise.float()
    cond = torch.stack([intrinsic[:, 0, 0], intrinsic[:, 1, 1],
                        intrinsic[:, 0, 2], intrinsic[:, 1, 2]], -1).float()
    return x, cond, x0


def loss_of(out: Tensor, x0: Tensor, t: Tensor,
            loss_weight: np.ndarray) -> Tensor:
    """The SNR-weighted L1 pred_x0 loss of one microbatch (a mean over its
    rows) from the net's (b, 1, h, w) output."""
    diff = out.float().permute(0, 2, 3, 1) - x0
    per_row = diff.abs().reshape(out.shape[0], -1).mean(dim=1)
    w = torch.as_tensor(loss_weight, device=x0.device)[t.long()].float()
    return (per_row * w).mean()


def training_loss(net, img01: Tensor, intrinsic: Tensor, t: Tensor,
                  noise: Tensor, ac: np.ndarray,
                  loss_weight: np.ndarray):
    """:func:`loss_of` the output of ``net(x_nchw, t, cond)``; returns the
    loss and the output."""
    x, cond, x0 = training_inputs(img01, intrinsic, t, noise, ac)
    out = net(x.permute(0, 3, 1, 2), t.float(), cond)
    return loss_of(out, x0, t, loss_weight), out
