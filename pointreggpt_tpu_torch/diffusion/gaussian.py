"""GaussianDiffusion: the training loss and the DDIM + DDNM sampling chain
on torch.

Port of ``pointreggpt_tpu/diffusion/gaussian.py`` (ancestral sampling,
``denoise`` and ``interpolate`` are not ported yet).
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
    normalize_to_neg_one_to_one,
    param_vector,
    unnormalize_to_zero_to_one,
)
from pointreggpt_tpu_torch.diffusion import schedules as sched

Tensor = torch.Tensor


class ModelPrediction(NamedTuple):
    pred_noise: Tensor
    pred_x_start: Tensor


class GaussianDiffusion:
    """DDPM process for a DiffusionUNet: training loss and DDIM sampling.

    Args mirror the JAX package's (and the reference's) constructor. The
    network is passed to each call, as the JAX package passes its params:
    the DiffusionUNet (baked, for sampling), called as
    ``model(x_nchw, t, param_cond)``.
    """

    def __init__(self, *, image_size: int,
                 channels: int = 1, timesteps: int = 1000,
                 sampling_timesteps: Optional[int] = None,
                 loss_type: str = "l1",
                 objective: str = "pred_x0",
                 beta_schedule: str = "sigmoid",
                 ddim_sampling_eta: float = 1.0,
                 min_snr_loss_weight: bool = False,
                 min_snr_gamma: float = 5.0,
                 is_ddnm_sampling: bool = True,
                 ddnm_sampling_dropout: float = 0.0,
                 ddnm_dropout_schedule: str = "none"):
        if objective not in ("pred_noise", "pred_x0", "pred_v"):
            raise ValueError(f"unknown objective {objective}")
        if loss_type not in ("l1", "l2"):
            raise ValueError(f"invalid loss type {loss_type}")
        self.image_size = image_size
        self.channels = channels
        self.timesteps = timesteps
        self.loss_type = loss_type
        self.objective = objective
        self.ddim_sampling_eta = ddim_sampling_eta
        self.is_ddnm_sampling = is_ddnm_sampling
        self.tables = sched.make_tables(timesteps, beta_schedule, objective,
                                        min_snr_loss_weight, min_snr_gamma)
        self._device_tables = {}
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
        # one upload per table and device: a copy from host memory would
        # wait for the stream on every call inside the training loop
        key = (name, t.device)
        table = self._device_tables.get(key)
        if table is None:
            table = self._device_tables[key] = torch.as_tensor(
                getattr(self.tables, name), device=t.device)
        out = table[t.long()]
        return out.reshape(out.shape + (1,) * (ndim - 1))

    def q_sample(self, x_start: Tensor, t: Tensor, noise: Tensor) -> Tensor:
        nd = x_start.dim()
        return (self._table("sqrt_alphas_cumprod", t, nd) * x_start +
                self._table("sqrt_one_minus_alphas_cumprod", t, nd) * noise)

    def predict_v(self, x_start: Tensor, t: Tensor, noise: Tensor) -> Tensor:
        nd = x_start.dim()
        return (self._table("sqrt_alphas_cumprod", t, nd) * noise -
                self._table("sqrt_one_minus_alphas_cumprod", t, nd) * x_start)

    # -- training loss ------------------------------------------------------

    def p_losses(self, model: nn.Module, x_start: Tensor, t: Tensor,
                 param_cond: Tensor, noise: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Tensor:
        """Per-batch SNR-weighted L1/L2 denoising loss (a scalar).

        Args:
            x_start: (b, h, w, c) clean images in [-1, 1].
            t: (b,) integer timesteps.
            noise: injected noise (tests); else drawn from ``generator``
                on x_start's device.
        """
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                device=x_start.device, dtype=x_start.dtype)
        x = self.q_sample(x_start, t, noise)
        out = model(x.permute(0, 3, 1, 2), t, param_cond).permute(0, 2, 3, 1)
        if out.shape != x_start.shape:
            # e.g. a 2x learned-variance head would broadcast against the
            # target and train a wrong loss
            raise ValueError(f"model output {tuple(out.shape)} != target "
                             f"{tuple(x_start.shape)}; GaussianDiffusion "
                             "requires out channels == in channels")
        if self.objective == "pred_noise":
            target = noise
        elif self.objective == "pred_x0":
            target = x_start
        else:
            target = self.predict_v(x_start, t, noise)
        diff = out - target
        loss = diff.abs() if self.loss_type == "l1" else diff * diff
        loss = loss.reshape(loss.shape[0], -1).mean(dim=-1)
        return (loss * self._table("loss_weight", t, 1)).mean()

    def training_loss(self, model: nn.Module, img01: Tensor,
                      intrinsic: Tensor,
                      generator: Optional[torch.Generator] = None) -> Tensor:
        """The training forward: draw t, then the noise, from ``generator``.

        Args:
            img01: (b, h, w, c) depth in [0, 1] model units.
            intrinsic: (b, 3, 3).
        """
        t = torch.randint(0, self.timesteps, (img01.shape[0],),
                          generator=generator, device=img01.device)
        return self.p_losses(model, normalize_to_neg_one_to_one(img01), t,
                             param_vector(intrinsic), generator=generator)

    # -- sampling -----------------------------------------------------------

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
