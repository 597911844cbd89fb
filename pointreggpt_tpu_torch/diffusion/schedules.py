"""Beta schedules and the precomputed diffusion tables (host numpy).

Own copy of ``pointreggpt_tpu/diffusion/schedules.py``: tables are built
at float64 and stored float32, like the reference's buffer registration;
the DDIM time grid comes from float32 ``torch.linspace``, whose rounding
decides some timesteps.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Reference: sdd:976-980."""
    scale = 1000.0 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps,
                       dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule. Reference: sdd:983-994."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5)**2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(timesteps: int,
                          start: float = -3,
                          end: float = 3,
                          tau: float = 1) -> np.ndarray:
    """Sigmoid schedule (arXiv:2212.11972), used by all entry scripts.

    Reference: sdd:997-1012.
    """

    def sigmoid(x):
        return 1 / (1 + np.exp(-x))

    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    # the reference evaluates the endpoint sigmoids on float32 scalars
    # (torch.tensor(start/tau).sigmoid(), sdd:1005-1006); match exactly.
    v_start = np.float64(sigmoid(np.float32(start / tau)))
    v_end = np.float64(sigmoid(np.float32(end / tau)))
    alphas_cumprod = (-sigmoid((t * (end - start) + start) / tau) +
                      v_end) / (v_end - v_start)
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


BETA_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


@dataclasses.dataclass(frozen=True)
class DiffusionTables:
    """The ~15 float32 lookup tables of the DDPM process (sdd:1096-1151).

    Stored as numpy float32; they become device constants when closed over
    by jitted samplers/losses.
    """

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    loss_weight: np.ndarray
    snr: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_tables(
    timesteps: int,
    beta_schedule: str = "sigmoid",
    objective: str = "pred_x0",
    min_snr_loss_weight: bool = False,
    min_snr_gamma: float = 5.0,
) -> DiffusionTables:
    """Build all diffusion tables at float64, return float32.

    Loss weighting follows the reference exactly (sdd:1136-1151): with
    min-SNR off, pred_noise -> 1, pred_x0 -> snr, pred_v -> snr/(snr+1).
    """
    betas = BETA_SCHEDULES[beta_schedule](timesteps).astype(np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (
        1.0 - alphas_cumprod)

    snr = alphas_cumprod / (1 - alphas_cumprod)
    maybe_clipped_snr = np.minimum(snr,
                                   min_snr_gamma) if min_snr_loss_weight else snr
    if objective == "pred_noise":
        loss_weight = maybe_clipped_snr / snr
    elif objective == "pred_x0":
        loss_weight = maybe_clipped_snr
    elif objective == "pred_v":
        loss_weight = maybe_clipped_snr / (snr + 1)
    else:
        raise ValueError(f"unknown objective {objective}")

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return DiffusionTables(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) *
                                 np.sqrt(alphas) / (1.0 - alphas_cumprod)),
        loss_weight=f32(loss_weight),
        snr=f32(snr),
    )


def ddnm_dropout_table(timesteps: int,
                       dropout: float = 0.0,
                       schedule: str = "none") -> np.ndarray:
    """Per-timestep DDNM mask-dropout probabilities (sdd:1076-1089)."""
    if schedule == "none":
        return np.full(timesteps, dropout, dtype=np.float32)
    if schedule == "linear":
        return np.linspace(dropout, 0.0, timesteps, dtype=np.float32)
    raise ValueError(f"unknown ddnm dropout schedule {schedule}")


def denoise_dropout_table(timesteps: int) -> np.ndarray:
    """Denoise-mode dropout: linspace(1, 0, T)**100 (sdd:1091-1094)."""
    return (np.linspace(1.0, 0.0, timesteps, dtype=np.float64)**100).astype(
        np.float32)


def ddim_time_pairs(timesteps: int, sampling_timesteps: int) -> np.ndarray:
    """The (S, 2) descending [t, t_next] DDIM pairs; the last t_next is -1.

    The grid is float32 ``torch.linspace(-1, T - 1, S + 1)`` truncated with
    ``.int()``, as the reference builds it.
    """
    import torch

    times = torch.linspace(-1, timesteps - 1,
                           sampling_timesteps + 1).int().tolist()
    times = list(reversed(times))
    return np.asarray(list(zip(times[:-1], times[1:])), dtype=np.int32)
