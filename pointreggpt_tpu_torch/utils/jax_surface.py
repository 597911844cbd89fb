"""The port's side of the check of its library surface against JAX output.

``tests/make_torch_port_jax_surface_reference.py`` runs the JAX package
once, on the CPU, on weights and inputs that this module rebuilds from a
seed with numpy alone, and writes ``tests/data/
torch_port_jax_surface.npz``. The port recomputes the four cases on any
device and is held to that file:

- ``condition``: ``geometry.image_condition`` of a synthetic depth (two
  frames at 256^2, 2-2.8 m) under two camera motions as the Generator
  draws them;
- ``denoise``: ``GaussianDiffusion.denoise`` with the production bf16
  DiffusionUNet (``jax_parity.nets``' weights), 10 DDIM steps, eta 0, DDNM
  on, x_T injected, on the JAX package's ``condition``;
- ``interpolate``: ``GaussianDiffusion.interpolate`` of two 64^2 images
  with the same weights in fp32 (bf16 rounding alone moves an unpinned
  chain of seeded weights by some 0.2, which would hide a planted fault),
  t = 10, lambda 0.3, the JAX draws (the two q_sample noises and each
  step's noise) stored in the file and injected;
- ``fourier``: one fp32 forward of a full-width DiffusionUNet with
  ``random_fourier_features`` and ``learned_variance`` (two output
  channels) at (1, 256, 256, 1).

``run_port(..., lam=1 - INTERP_LAM)`` swaps the interpolation's weights:
the planted fault of ``chip_smoke.py``'s ``surface_path``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch.core import geometry as G
from pointreggpt_tpu_torch.utils import jax_parity as J
from pointreggpt_tpu_torch.utils.seeded_weights import fill_seeded

SEED = J.SEED
H = J.H
BATCH = 2
DENOISE_STEPS = 10
INTERP_H = 64
INTERP_T = 10
INTERP_LAM = 0.3
FOURIER_MODEL = C.ModelConfig(bf16=False, random_fourier_features=True,
                              learned_variance=True)
CASES = ("condition", "denoise", "interpolate", "fourier")
# a condition pixel "differs" past this (both channels lie in [-1, 1])
CONDITION_TOL = 1e-5


def nets(seed: int = SEED):
    """(the bf16 DiffusionUNet of ``jax_parity``, its fp32 twin, the fp32
    Fourier / learned-variance DiffusionUNet), fp32 parameters from
    ``seed``."""
    unet32 = fill_seeded(C.build_diffusion_unet(C.ModelConfig(bf16=False)),
                         seed)
    fourier = fill_seeded(C.build_diffusion_unet(FOURIER_MODEL), seed + 3)
    return J.nets(seed)[0], unet32, fourier


def diffusion():
    """The denoise / interpolate GaussianDiffusion (production config,
    ``DENOISE_STEPS`` DDIM steps, eta 0)."""
    return C.build_diffusion(C.DiffusionConfig(
        sampling_timesteps=DENOISE_STEPS, ddim_sampling_eta=0.0))


def inputs(seed: int = SEED) -> Dict[str, np.ndarray]:
    """Every input of the four cases but the interpolation's draws."""
    rng = np.random.default_rng(seed + 10)
    intr = J._intrinsics(BATCH)
    yy, xx = np.mgrid[0:H, 0:H]
    depth = np.stack([
        2.4 + 0.4 * np.sin(xx / 37.0 + i) * np.cos(yy / 23.0) +
        0.01 * rng.uniform(size=(H, H)) for i in range(BATCH)])
    x1 = np.clip(rng.standard_normal((BATCH, INTERP_H, INTERP_H, 1)) * 0.5,
                 -1, 1)
    x2 = np.clip(rng.standard_normal((BATCH, INTERP_H, INTERP_H, 1)) * 0.5,
                 -1, 1)
    return dict(
        depth01=(depth / 10.0).astype(np.float32), intrinsic=intr,
        pose=J._pose(rng, BATCH), param_cond=J._param_vector(intr),
        x_init=rng.standard_normal((BATCH, H, H, 1)).astype(np.float32),
        x1=x1.astype(np.float32), x2=x2.astype(np.float32),
        fourier_x=rng.standard_normal((1, H, H, 1)).astype(np.float32),
        fourier_t=np.array([rng.integers(0, 1000)], np.float32),
        fourier_param_cond=J._param_vector(J._intrinsics(1)))


@torch.inference_mode()
def run_port(device, ref, seed: int = SEED, cases=CASES, nets_=None,
             lam: float = INTERP_LAM) -> Dict[str, np.ndarray]:
    """The port's outputs of ``cases`` on ``device`` through its entry
    points (``image_condition``, ``denoise`` and ``interpolate`` on the
    baked net, the Fourier net's forward). ``ref`` is the reference file
    (the JAX condition the denoise runs on, the interpolation's draws);
    ``nets_`` and ``lam`` may plant a fault."""
    from pointreggpt_tpu_torch.generate.generator import place_for_inference

    device = torch.device(device)
    unet, unet32, fourier = nets(seed) if nets_ is None else nets_
    x = {k: torch.from_numpy(v).to(device) for k, v in inputs(seed).items()}
    out = {}
    if "condition" in cases:
        out["condition"] = G.image_condition(
            x["depth01"], x["intrinsic"], x["pose"]).cpu().numpy()
    if "denoise" in cases:
        net = place_for_inference(unet, device)
        cond = torch.tensor(ref["condition"], device=device)
        out["denoise"] = diffusion().denoise(
            net, param_cond=x["param_cond"], img_cond=cond,
            x_init=x["x_init"]).cpu().numpy()
        del net
    if "interpolate" in cases:
        net = place_for_inference(unet32, device)
        noise = torch.tensor(ref["interpolate_noise"], device=device)
        q = torch.tensor(ref["interpolate_q_noise"], device=device)
        out["interpolate"] = diffusion().interpolate(
            net, x["x1"], x["x2"], x["param_cond"], t=INTERP_T, lam=lam,
            q_noise=(q[0], q[1]), noise=lambda t: noise[t - 1]).cpu().numpy()
        del net
    if "fourier" in cases:
        net = place_for_inference(fourier, device)
        y = net(x["fourier_x"].permute(0, 3, 1, 2), x["fourier_t"],
                x["fourier_param_cond"])
        out["fourier"] = y.permute(0, 2, 3, 1).float().cpu().numpy()
    return out


def gaps(got: Dict[str, np.ndarray], ref) -> Dict[str, float]:
    """Largest absolute difference of each case present in ``got`` to
    ``ref``; for ``condition`` the share of pixels where either channel
    differs by more than ``CONDITION_TOL`` (a splatted point that a fused
    multiply-add moves across a pixel edge)."""
    out = {}
    for k in CASES:
        if k not in got:
            continue
        d = np.abs(np.asarray(got[k], np.float64) -
                   np.asarray(ref[k], np.float64))
        out[k] = float((d.max(axis=-1) > CONDITION_TOL).mean()
                       if k == "condition" else d.max())
    return out
