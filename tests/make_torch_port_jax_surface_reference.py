"""Write ``tests/data/torch_port_jax_surface.npz``: the JAX package's
outputs of the library surface that the PyTorch port is held to, on the
CPU and on the card.

    JAX_PLATFORMS=cpu python tests/make_torch_port_jax_surface_reference.py

Runs the JAX package on the CPU at full production width, from the weights
and inputs that ``pointreggpt_tpu_torch/utils/jax_surface.py`` rebuilds
from its seed (the weights cross over through
``pointreggpt_tpu/utils/torch_port.py``): ``image_condition``, a 10-step
bf16 denoise chain (``ddim_sample`` with ``is_denoise``, as ``denoise``
runs it, x_T injected), a 10-step fp32 ``interpolate`` (its draws,
replayed from its key, stored beside it) and an fp32 forward of a Fourier /
learned-variance DiffusionUNet. Then it runs the port on the CPU and
stores its gap to each output (``cpu_gap_*``), the first part of the
card's gate in ``tests/test_torch_port_cuda_paths.py``'s
``test_surface_parity_on_the_card``. Takes a few minutes.
"""

import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from make_torch_port_jax_reference import _template, jax_nets  # noqa: E402
from pointreggpt_tpu import config as JC  # noqa: E402
from pointreggpt_tpu.core import geometry as JG  # noqa: E402
from pointreggpt_tpu.utils import torch_port  # noqa: E402
from pointreggpt_tpu_torch.utils import jax_surface as S  # noqa: E402

OUT = REPO / "tests" / "data" / "torch_port_jax_surface.npz"
KEY = 5  # the interpolation's PRNG key


def interpolate_draws(key, shape, t):
    """The draws of the JAX ``interpolate``: its two q_sample noises, and
    the noise of each step s = 1 .. t - 1 (row s - 1; step 0 adds none),
    replayed from its key splits."""
    k_n1, k_n2, k_scan = jax.random.split(key, 3)
    q = np.stack([np.asarray(jax.random.normal(k, shape))
                  for k in (k_n1, k_n2)])
    steps = {t - 1 - i: np.asarray(jax.random.normal(
        jax.random.split(k)[1], shape, jnp.float32))
        for i, k in enumerate(jax.random.split(k_scan, t))}
    return q, np.stack([steps[s] for s in range(1, t)])


def main() -> None:
    seed = S.SEED
    x = S.inputs(seed)
    t0 = time.time()
    jm, params, *_ = jax_nets(seed)
    ref = {}
    ref["condition"] = np.asarray(JG.image_condition(
        jnp.asarray(x["depth01"]), jnp.asarray(x["intrinsic"]),
        jnp.asarray(x["pose"])), np.float32)
    jd = JC.build_diffusion(JC.DiffusionConfig(
        sampling_timesteps=S.DENOISE_STEPS, ddim_sampling_eta=0.0), jm)
    ref["denoise"] = np.asarray(jax.jit(lambda p, c, xi: jd.ddim_sample(
        p, jax.random.PRNGKey(0), jnp.asarray(x["param_cond"]), c,
        xi.shape, is_denoise=True, x_init=xi))(
        params, jnp.asarray(ref["condition"]), jnp.asarray(x["x_init"])),
        np.float32)
    print(f"denoise {time.time() - t0:.1f} s", flush=True)
    _, unet32, fourier = S.nets(seed)
    j32 = JC.build_diffusion_unet(JC.ModelConfig(bf16=False))
    params32 = torch_port.port_diffusion_unet(
        unet32.state_dict(), _template(j32, jnp.zeros((1, S.H, S.H, 1)),
                                       jnp.zeros((1,)), jnp.zeros((1, 4))),
        num_stages=4)
    jd32 = JC.build_diffusion(JC.DiffusionConfig(
        sampling_timesteps=S.DENOISE_STEPS, ddim_sampling_eta=0.0), j32)
    key = jax.random.PRNGKey(KEY)
    ref["interpolate"] = np.asarray(jax.jit(
        lambda p, a, b: jd32.interpolate(
            p, key, a, b, jnp.asarray(x["param_cond"]), t=S.INTERP_T,
            lam=S.INTERP_LAM))(params32, jnp.asarray(x["x1"]),
                               jnp.asarray(x["x2"])), np.float32)
    ref["interpolate_q_noise"], ref["interpolate_noise"] = \
        interpolate_draws(key, x["x1"].shape, S.INTERP_T)
    print(f"interpolate {time.time() - t0:.1f} s", flush=True)

    jf = JC.build_diffusion_unet(S.FOURIER_MODEL)
    fparams = torch_port.port_diffusion_unet(
        fourier.state_dict(),
        _template(jf, jnp.zeros((1, S.H, S.H, 1)), jnp.zeros((1,)),
                  jnp.zeros((1, 4))), num_stages=4)
    ref["fourier"] = np.asarray(jax.jit(jf.apply)(
        fparams, x["fourier_x"], x["fourier_t"], x["fourier_param_cond"]),
        np.float32)
    print(f"fourier {time.time() - t0:.1f} s", flush=True)

    import torch

    torch.set_num_threads(os.cpu_count() or 1)
    port = S.run_port("cpu", ref, seed)
    gap = S.gaps(port, ref)
    print("port on the CPU vs JAX:", gap, flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, seed=np.int64(seed), **ref,
                        **{f"cpu_gap_{k}": np.float64(v)
                           for k, v in gap.items()})
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
