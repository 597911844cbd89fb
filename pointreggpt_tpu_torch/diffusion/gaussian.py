"""GaussianDiffusion: the DDIM + DDNM sampling chain on torch.

Port of the sampling side of ``pointreggpt_tpu/diffusion/gaussian.py``.
The JAX ``lax.scan`` over timestep pairs is a Python loop here; nothing in
it reads a value back to the host, so the whole chain queues on the stream
without a sync.

Images are NHWC ``(b, h, w, c)`` at the public functions, like the JAX
package; the network sees the NCHW view (channels_last memory, no copy).

DDNM (null-space data consistency): after the network predicts x0, pixels
where the condition mask is valid are replaced by the conditioned depth.
The DDNM branch takes precedence over ``is_denoise``, and the DDIM update
uses the noise estimate from *before* the projection, as the reference.
Deterministic scalar coefficients are computed on the host in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from pointreggpt_tpu_torch.core.geometry import (
    mask_from_image_condition,
    unnormalize_to_zero_to_one,
)
from pointreggpt_tpu_torch.diffusion import schedules as sched

Tensor = torch.Tensor


class ModelPrediction(NamedTuple):
    pred_noise: Tensor
    pred_x_start: Tensor


class GaussianDiffusion:
    """DDPM sampling process for a DiffusionUNet.

    Args mirror the JAX package's (and the reference's) constructor. The
    network is passed to each sampling call, as the JAX package passes its
    params: the (possibly baked) DiffusionUNet, called as
    ``model(x_nchw, t, param_cond)``.
    """

    def __init__(self, *, image_size: int,
                 channels: int = 1, timesteps: int = 1000,
                 sampling_timesteps: Optional[int] = None,
                 objective: str = "pred_x0",
                 beta_schedule: str = "sigmoid",
                 ddim_sampling_eta: float = 1.0,
                 is_ddnm_sampling: bool = True,
                 ddnm_sampling_dropout: float = 0.0,
                 ddnm_dropout_schedule: str = "none"):
        if objective not in ("pred_noise", "pred_x0", "pred_v"):
            raise ValueError(f"unknown objective {objective}")
        self.image_size = image_size
        self.channels = channels
        self.timesteps = timesteps
        self.objective = objective
        self.ddim_sampling_eta = ddim_sampling_eta
        self.is_ddnm_sampling = is_ddnm_sampling
        self.tables = sched.make_tables(timesteps, beta_schedule, objective)
        self.ddnm_dropouts = sched.ddnm_dropout_table(
            timesteps, ddnm_sampling_dropout, ddnm_dropout_schedule)
        self.denoise_dropouts = sched.denoise_dropout_table(timesteps)
        s = timesteps if sampling_timesteps is None else sampling_timesteps
        if not 1 <= s <= timesteps:
            raise ValueError(
                f"sampling_timesteps must be in [1, {timesteps}], got {s}")
        self.sampling_timesteps = int(s)

    @property
    def is_ddim_sampling(self) -> bool:
        return self.sampling_timesteps < self.timesteps

    # -- q / prediction conversions ---------------------------------------

    def _table(self, name: str, t: Tensor, ndim: int) -> Tensor:
        table = torch.as_tensor(getattr(self.tables, name), device=t.device)
        out = table[t.long()]
        return out.reshape(out.shape + (1,) * (ndim - 1))

    def q_sample(self, x_start: Tensor, t: Tensor, noise: Tensor) -> Tensor:
        nd = x_start.dim()
        return (self._table("sqrt_alphas_cumprod", t, nd) * x_start +
                self._table("sqrt_one_minus_alphas_cumprod", t, nd) * noise)

    def _coef(self, name: str, t: int) -> float:
        return float(getattr(self.tables, name)[t])

    def model_predictions(self, model: nn.Module, x: Tensor, t: int,
                          param_cond: Tensor,
                          img_cond: Optional[Tensor] = None, *,
                          generator: Optional[torch.Generator] = None,
                          clip_x_start: bool = False,
                          is_ban_ddnm: bool = False,
                          is_denoise: bool = False) -> ModelPrediction:
        """Network forward + objective conversion + DDNM projection at the
        scalar timestep ``t`` (all samples share it while sampling).

        Args:
            x: (b, h, w, c) current noisy image in [-1, 1].
            img_cond: (b, h, w, 2) condition; consumed only by the DDNM
                projection, never fed to the network.
        """
        b = x.shape[0]
        tt = torch.full((b,), float(t), device=x.device)
        out = model(x.permute(0, 3, 1, 2), tt, param_cond)
        out = out.permute(0, 2, 3, 1).float()
        if out.shape != x.shape:
            raise ValueError(f"model output {tuple(out.shape)} != input "
                             f"{tuple(x.shape)}")
        clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start else (
            lambda v: v)
        r = self._coef("sqrt_recip_alphas_cumprod", t)
        rm1 = self._coef("sqrt_recipm1_alphas_cumprod", t)
        if self.objective == "pred_noise":
            pred_noise = out
            x_start = clip(r * x - rm1 * pred_noise)
        else:
            if self.objective == "pred_x0":
                x_start = clip(out)
            else:
                x_start = clip(
                    self._coef("sqrt_alphas_cumprod", t) * x -
                    self._coef("sqrt_one_minus_alphas_cumprod", t) * out)
            pred_noise = (r * x - x_start) / rm1

        use_ddnm = self.is_ddnm_sampling and not is_ban_ddnm
        if img_cond is not None and (use_ddnm or is_denoise):
            img_rpj = img_cond[..., 0:1]
            mask = mask_from_image_condition(img_cond)[..., None]
            table = self.ddnm_dropouts if use_ddnm else self.denoise_dropouts
            p_drop = float(table[t])
            if p_drop > 0:
                if generator is None:
                    raise ValueError(
                        "model_predictions: the mask-dropout schedule is "
                        "nonzero but no generator was passed")
                keep = torch.rand(mask.shape, generator=generator,
                                  device=x.device) > p_drop
                mask = mask & keep
            # pred_noise stays the pre-projection estimate (reference)
            x_start = torch.where(mask, img_rpj, x_start)
        return ModelPrediction(pred_noise, x_start)

    # -- DDIM sampling ----------------------------------------------------

    @torch.inference_mode()
    def ddim_sample(self, model: nn.Module, param_cond: Tensor,
                    img_cond: Optional[Tensor],
                    shape: Sequence[int], *,
                    generator: Optional[torch.Generator] = None,
                    clip_denoised: bool = True,
                    has_refine_step: bool = False,
                    is_denoise: bool = False,
                    x_init: Optional[Tensor] = None) -> Tensor:
        """DDIM chain with DDNM projection; returns (b, h, w, c) in [0, 1].

        ``x_init`` injects the x_T draw (tests); with eta 0 the chain then
        draws no random numbers at all.
        """
        device = param_cond.device
        eta = np.float32(self.ddim_sampling_eta)
        ac = self.tables.alphas_cumprod
        pairs = sched.ddim_time_pairs(self.timesteps,
                                      self.sampling_timesteps)
        img = (torch.randn(tuple(shape), generator=generator, device=device)
               if x_init is None else x_init.to(device, torch.float32))
        for t, t_next in pairs.tolist():
            pred_noise, x_start = self.model_predictions(
                model, img, t, param_cond, img_cond, generator=generator,
                clip_x_start=clip_denoised, is_denoise=is_denoise)
            if t_next < 0:
                img = x_start
                continue
            alpha, alpha_next = ac[t], ac[t_next]
            sigma = eta * np.sqrt((np.float32(1) - alpha / alpha_next) *
                                  (np.float32(1) - alpha_next) /
                                  (np.float32(1) - alpha))
            c = np.sqrt(np.maximum(np.float32(1) - alpha_next - sigma**2,
                                   np.float32(0)))
            img = x_start * float(np.sqrt(alpha_next)) + float(c) * pred_noise
            if sigma > 0:
                noise = torch.randn(img.shape, generator=generator,
                                    device=device)
                img = img + float(sigma) * noise

        if has_refine_step and img_cond is not None:
            _, x_start = self.model_predictions(
                model, img, 0, param_cond, img_cond, generator=generator,
                clip_x_start=clip_denoised, is_ban_ddnm=True)
            mask = mask_from_image_condition(img_cond)[..., None]
            img = torch.where(mask, x_start, img)
        return unnormalize_to_zero_to_one(img)

    def sample(self, model: nn.Module, *, param_cond: Tensor,
               img_cond: Optional[Tensor] = None,
               generator: Optional[torch.Generator] = None,
               has_refine_step: bool = False,
               x_init: Optional[Tensor] = None) -> Tensor:
        """Sample (b, h, w, c) images in [0, 1] with the DDIM chain."""
        if not self.is_ddim_sampling:
            raise NotImplementedError(
                "ancestral sampling (sampling_timesteps == timesteps) is not "
                "ported yet; use DDIM (sampling_timesteps < timesteps)")
        b = param_cond.shape[0]
        shape = (b, self.image_size, self.image_size, self.channels)
        return self.ddim_sample(model, param_cond, img_cond, shape,
                                generator=generator,
                                has_refine_step=has_refine_step,
                                x_init=x_init)
