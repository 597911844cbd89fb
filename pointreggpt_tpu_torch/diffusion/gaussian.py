"""GaussianDiffusion: the training loss and the DDIM + DDNM sampling chain
on torch.

Port of ``pointreggpt_tpu/diffusion/gaussian.py``: the loss, both
sampling chains, ``denoise`` and ``interpolate``. The JAX ``lax.scan`` over
timesteps (DDIM pairs, all ``timesteps`` of the ancestral chain, or the t
steps of an interpolation) is a Python loop here; nothing in it reads a
value back to the host, so the whole chain queues on the stream without a
sync.

Random draws come from ``torch.Generator``s, so they differ from
``jax.random``'s; tests inject them: x_T (``x_init``), each step's noise
(``noise(t)``), the keep-mask uniforms of a nonzero mask-dropout table
(``uniforms(t)``) and the two q_sample noises of ``interpolate``
(``q_noise``).

Data parallel runs pass ``rows`` (:class:`~pointreggpt_tpu_torch.parallel.
mesh.Rows`): each random draw is then made at the global batch's shape and
cut to the process's rows, so N processes draw what one process draws.

Images are NHWC ``(b, h, w, c)`` at the public functions, like the JAX
package; the network sees the NCHW view (channels_last memory, no copy).

DDNM (null-space data consistency): after the network predicts x0, pixels
where the condition mask is valid are replaced by the conditioned depth.
The DDNM branch takes precedence over ``is_denoise``, and the DDIM update
uses the noise estimate from *before* the projection, as the reference.
Deterministic scalar coefficients are computed on the host in float32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

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
from pointreggpt_tpu_torch.parallel.mesh import Rows

Tensor = torch.Tensor
Draws = Callable[[int], Tensor]  # injected draws of the step at t (tests)


def _draw(fn, shape: Sequence[int], generator: Optional[torch.Generator],
          device, rows: Optional[Rows], **kw) -> Tensor:
    """``fn`` (``torch.randn`` or ``torch.rand``) at ``shape``; with
    ``rows``, at the global batch's shape and then this process's rows, so
    every process draws what one process draws for the whole batch."""
    if rows is None:
        return fn(tuple(shape), generator=generator, device=device, **kw)
    if shape[0] != rows.size:
        raise ValueError(f"batch {shape[0]} != the process's rows {rows}")
    return rows.take(fn((rows.total,) + tuple(shape[1:]),
                        generator=generator, device=device, **kw))


def _at(draws: Optional[Draws], t: int) -> Optional[Tensor]:
    return None if draws is None else draws(t)


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
    def num_timesteps(self) -> int:
        return self.timesteps

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

    def predict_start_from_noise(self, x_t: Tensor, t: Tensor,
                                 noise: Tensor) -> Tensor:
        nd = x_t.dim()
        return (self._table("sqrt_recip_alphas_cumprod", t, nd) * x_t -
                self._table("sqrt_recipm1_alphas_cumprod", t, nd) * noise)

    def predict_noise_from_start(self, x_t: Tensor, t: Tensor,
                                 x0: Tensor) -> Tensor:
        nd = x_t.dim()
        return ((self._table("sqrt_recip_alphas_cumprod", t, nd) * x_t - x0)
                / self._table("sqrt_recipm1_alphas_cumprod", t, nd))

    def predict_start_from_v(self, x_t: Tensor, t: Tensor,
                             v: Tensor) -> Tensor:
        nd = x_t.dim()
        return (self._table("sqrt_alphas_cumprod", t, nd) * x_t -
                self._table("sqrt_one_minus_alphas_cumprod", t, nd) * v)

    def q_posterior(self, x_start: Tensor, x_t: Tensor, t: Tensor):
        """(mean, variance, clipped log variance) of q(x_{t-1} | x_t,
        x_0) at (b,) timesteps ``t``."""
        nd = x_t.dim()
        mean = (self._table("posterior_mean_coef1", t, nd) * x_start +
                self._table("posterior_mean_coef2", t, nd) * x_t)
        return (mean, self._table("posterior_variance", t, nd),
                self._table("posterior_log_variance_clipped", t, nd))

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
        if getattr(model, "learned_variance", False):
            raise ValueError(
                "p_losses: a learned-variance net (twice the channels out: "
                "the prediction and the variance) trains with L_hybrid "
                "(L_simple + lambda L_vlb, Nichol & Dhariwal 2021), which is "
                "not ported; such a net only samples")
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
                      generator: Optional[torch.Generator] = None,
                      rows: Optional[Rows] = None) -> Tensor:
        """The training forward: draw t, then the noise, from ``generator``.

        Args:
            img01: (b, h, w, c) depth in [0, 1] model units.
            intrinsic: (b, 3, 3).
            rows: this process's rows of the global microbatch (data
                parallel; None: the whole batch): t and the noise are
                drawn for all of its rows.
        """
        x_start = normalize_to_neg_one_to_one(img01)
        if rows is None:
            rows = Rows(0, img01.shape[0], img01.shape[0])
        if img01.shape[0] != rows.size:
            raise ValueError(f"batch {img01.shape[0]} != the process's rows "
                             f"{rows}")
        t = rows.take(torch.randint(0, self.timesteps, (rows.total,),
                                    generator=generator,
                                    device=img01.device))
        noise = _draw(torch.randn, x_start.shape, generator, img01.device,
                      rows, dtype=x_start.dtype)
        return self.p_losses(model, x_start, t, param_vector(intrinsic),
                             noise=noise)

    # -- sampling -----------------------------------------------------------

    def _coef(self, name: str, t: int) -> float:
        return float(getattr(self.tables, name)[t])

    def model_predictions(self, model: nn.Module, x: Tensor, t: int,
                          param_cond: Tensor,
                          img_cond: Optional[Tensor] = None, *,
                          generator: Optional[torch.Generator] = None,
                          clip_x_start: bool = False,
                          is_ban_ddnm: bool = False,
                          is_denoise: bool = False,
                          keep_uniform: Optional[Tensor] = None,
                          rows: Optional[Rows] = None) -> ModelPrediction:
        """Network forward + objective conversion + DDNM projection at the
        scalar timestep ``t`` (all samples share it while sampling).

        Args:
            x: (b, h, w, c) current noisy image in [-1, 1]; a net that
                returns 2 c channels (learned variance) has its first c
                read.
            img_cond: (b, h, w, 2) condition; consumed only by the DDNM
                projection, never fed to the network.
            keep_uniform: (b, h, w, 1) injected uniforms of the keep mask
                (tests); else drawn from ``generator`` when the active
                mask-dropout table is nonzero at ``t``.
        """
        b = x.shape[0]
        tt = torch.full((b,), float(t), device=x.device)
        out = model(x.permute(0, 3, 1, 2), tt, param_cond)
        out = out.permute(0, 2, 3, 1).float()
        c = x.shape[-1]
        if out.shape[:-1] == x.shape[:-1] and out.shape[-1] == 2 * c:
            # a learned-variance head: the objective's prediction, then
            # the variance, which DDIM does not read
            out = out[..., :c]
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
                if keep_uniform is None and generator is None:
                    raise ValueError(
                        "model_predictions: the mask-dropout schedule is "
                        "nonzero but no generator was passed")
                u = (_draw(torch.rand, mask.shape, generator, x.device, rows)
                     if keep_uniform is None else
                     keep_uniform.to(x.device, torch.float32))
                mask = mask & (u > p_drop)
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
                    x_init: Optional[Tensor] = None,
                    noise: Optional[Draws] = None,
                    uniforms: Optional[Draws] = None,
                    rows: Optional[Rows] = None) -> Tensor:
        """DDIM chain with DDNM projection; returns (b, h, w, c) in [0, 1].

        ``x_init`` injects the x_T draw, ``noise(t)`` the noise of the step
        at t and ``uniforms(t)`` its keep-mask uniforms (tests); with eta 0
        and a zero dropout table the chain then draws nothing.
        """
        device = param_cond.device
        eta = np.float32(self.ddim_sampling_eta)
        ac = self.tables.alphas_cumprod
        pairs = sched.ddim_time_pairs(self.timesteps,
                                      self.sampling_timesteps)
        img = (_draw(torch.randn, shape, generator, device, rows)
               if x_init is None else x_init.to(device, torch.float32))
        for t, t_next in pairs.tolist():
            pred_noise, x_start = self.model_predictions(
                model, img, t, param_cond, img_cond, generator=generator,
                clip_x_start=clip_denoised, is_denoise=is_denoise,
                keep_uniform=_at(uniforms, t), rows=rows)
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
                z = (_draw(torch.randn, img.shape, generator, device, rows)
                     if noise is None else noise(t).to(device, torch.float32))
                img = img + float(sigma) * z

        if has_refine_step and img_cond is not None:
            _, x_start = self.model_predictions(
                model, img, 0, param_cond, img_cond, generator=generator,
                clip_x_start=clip_denoised, is_ban_ddnm=True, rows=rows)
            mask = mask_from_image_condition(img_cond)[..., None]
            img = torch.where(mask, x_start, img)
        return unnormalize_to_zero_to_one(img)

    # -- ancestral sampling -------------------------------------------------

    def _p_sample_step(self, model: nn.Module, x: Tensor, t: int,
                       param_cond: Tensor, img_cond: Optional[Tensor],
                       generator: Optional[torch.Generator],
                       noise: Optional[Draws], *,
                       is_ban_ddnm: bool = False,
                       is_denoise: bool = False,
                       uniforms: Optional[Draws] = None,
                       rows: Optional[Rows] = None) -> Tensor:
        """One step of the posterior chain: x_{t-1} from x_t (the posterior
        mean at t = 0, where the noise is zero)."""
        _, x_start = self.model_predictions(
            model, x, t, param_cond, img_cond, generator=generator,
            is_ban_ddnm=is_ban_ddnm, is_denoise=is_denoise,
            keep_uniform=_at(uniforms, t), rows=rows)
        x_start = x_start.clamp(-1.0, 1.0)
        mean = (self._coef("posterior_mean_coef1", t) * x_start +
                self._coef("posterior_mean_coef2", t) * x)
        if t == 0:
            return mean
        std = float(np.exp(np.float32(0.5) *
                           self.tables.posterior_log_variance_clipped[t]))
        z = (_draw(torch.randn, x.shape, generator, x.device, rows)
             if noise is None else noise(t).to(x.device, torch.float32))
        return mean + std * z

    @torch.inference_mode()
    def p_sample_loop(self, model: nn.Module, param_cond: Tensor,
                      img_cond: Optional[Tensor], shape: Sequence[int], *,
                      generator: Optional[torch.Generator] = None,
                      has_refine_step: bool = False,
                      is_denoise: bool = False,
                      x_init: Optional[Tensor] = None,
                      noise: Optional[Draws] = None,
                      uniforms: Optional[Draws] = None,
                      rows: Optional[Rows] = None) -> Tensor:
        """Ancestral chain over all ``timesteps``; returns (b, h, w, c) in
        [0, 1].

        ``x_init`` injects the x_T draw, ``noise(t)`` the noise of step t
        and ``uniforms(t)`` its keep-mask uniforms (tests); otherwise they
        are drawn from ``generator``.
        """
        device = param_cond.device
        img = (_draw(torch.randn, shape, generator, device, rows)
               if x_init is None else x_init.to(device, torch.float32))
        for t in range(self.timesteps - 1, -1, -1):
            img = self._p_sample_step(model, img, t, param_cond, img_cond,
                                      generator, noise,
                                      is_denoise=is_denoise,
                                      uniforms=uniforms, rows=rows)
        if has_refine_step and img_cond is not None:
            refined = self._p_sample_step(model, img, 0, param_cond,
                                          img_cond, generator, noise,
                                          is_ban_ddnm=True, rows=rows)
            mask = mask_from_image_condition(img_cond)[..., None]
            img = torch.where(mask, refined, img)
        return unnormalize_to_zero_to_one(img)

    def sample(self, model: nn.Module, *, param_cond: Tensor,
               img_cond: Optional[Tensor] = None,
               generator: Optional[torch.Generator] = None,
               has_refine_step: bool = False,
               x_init: Optional[Tensor] = None,
               rows: Optional[Rows] = None) -> Tensor:
        """Sample (b, h, w, c) images in [0, 1]: the DDIM chain when
        ``sampling_timesteps < timesteps``, else the ancestral chain.
        ``rows``: this process's rows of a global batch."""
        b = param_cond.shape[0]
        shape = (b, self.image_size, self.image_size, self.channels)
        chain = (self.ddim_sample if self.is_ddim_sampling
                 else self.p_sample_loop)
        return chain(model, param_cond, img_cond, shape, generator=generator,
                     has_refine_step=has_refine_step, x_init=x_init,
                     rows=rows)

    def denoise(self, model: nn.Module, *, param_cond: Tensor,
                img_cond: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None,
                has_refine_step: bool = False,
                x_init: Optional[Tensor] = None,
                noise: Optional[Draws] = None,
                uniforms: Optional[Draws] = None) -> Tensor:
        """Denoise mode: the chain of :meth:`sample` with ``is_denoise``,
        so the condition's pixels are projected under the denoise dropout
        table when DDNM is off (with DDNM on, its own table wins). Returns
        (b, h, w, c) in [0, 1]; the draws may be injected as in the
        chains."""
        b = param_cond.shape[0]
        shape = (b, self.image_size, self.image_size, self.channels)
        chain = (self.ddim_sample if self.is_ddim_sampling
                 else self.p_sample_loop)
        return chain(model, param_cond, img_cond, shape, generator=generator,
                     has_refine_step=has_refine_step, is_denoise=True,
                     x_init=x_init, noise=noise, uniforms=uniforms)

    @torch.inference_mode()
    def interpolate(self, model: nn.Module, x1: Tensor, x2: Tensor,
                    param_cond: Tensor, *, t: Optional[int] = None,
                    lam: float = 0.5,
                    generator: Optional[torch.Generator] = None,
                    q_noise: Optional[Tuple[Tensor, Tensor]] = None,
                    noise: Optional[Draws] = None) -> Tensor:
        """Diffuse two (b, h, w, c) images in [-1, 1] to step ``t``
        (default T - 1), blend them ``(1 - lam) x1_t + lam x2_t``, and run
        the t ancestral steps back down, unconditioned. Returns (b, h, w,
        c) in [-1, 1].

        ``q_noise`` injects the two q_sample noises and ``noise(t)`` each
        step's noise (tests); else they are drawn from ``generator``.
        """
        if x1.shape != x2.shape:
            raise ValueError(f"interpolate: shapes {tuple(x1.shape)} and "
                             f"{tuple(x2.shape)} differ")
        t = self.num_timesteps - 1 if t is None else int(t)
        if not 1 <= t <= self.num_timesteps - 1:
            raise ValueError(
                f"interpolate: t={t} outside [1, {self.num_timesteps - 1}]")
        device = param_cond.device
        x1 = x1.to(device, torch.float32)
        x2 = x2.to(device, torch.float32)
        if q_noise is None:
            q_noise = tuple(_draw(torch.randn, x1.shape, generator, device,
                                  None) for _ in range(2))
        tb = torch.full((x1.shape[0],), t, device=device)
        xt1 = self.q_sample(x1, tb, q_noise[0].to(device, torch.float32))
        xt2 = self.q_sample(x2, tb, q_noise[1].to(device, torch.float32))
        img = (1 - lam) * xt1 + lam * xt2
        for step in range(t - 1, -1, -1):
            img = self._p_sample_step(model, img, step, param_cond, None,
                                      generator, noise)
        return img
