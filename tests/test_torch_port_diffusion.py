"""PyTorch port: diffusion schedules and the DDIM + DDNM chain against the
JAX package on the CPU (same weights, same x_T, same condition, eta 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointreggpt_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from pointreggpt_tpu.diffusion import schedules as jsched
from pointreggpt_tpu.models import DiffusionUNet as JDiffusionUNet
from test_torch_port_generator import single_torch_thread  # noqa: F401
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.diffusion import schedules as sched
from pointreggpt_tpu_torch.models import DiffusionUNet
from pointreggpt_tpu_torch.utils import jax_params

# fp32 chain parity: the repo's own bound for a 4-to-8-step DDIM chain
# against a torch mirror (tests/test_torch_parity.py)
ATOL, RTOL = 5e-4, 1e-3


@pytest.mark.parametrize("schedule", ["sigmoid", "cosine", "linear"])
def test_tables_match(schedule):
    a = sched.make_tables(1000, schedule, "pred_x0")
    b = jsched.make_tables(1000, schedule, "pred_x0")
    for name in ("alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                 "loss_weight"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("t,s", [(1000, 250), (1000, 26), (16, 4)])
def test_ddim_pairs_and_dropout_tables_match(t, s):
    np.testing.assert_array_equal(sched.ddim_time_pairs(t, s),
                                  jsched.ddim_time_pairs(t, s))
    np.testing.assert_array_equal(sched.denoise_dropout_table(t),
                                  jsched.denoise_dropout_table(t))
    np.testing.assert_array_equal(sched.ddnm_dropout_table(t, 0.3, "linear"),
                                  jsched.ddnm_dropout_table(t, 0.3, "linear"))


@pytest.fixture(scope="module")
def chain():
    jm = JDiffusionUNet(dim=8, dim_mults=(1, 2))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), jnp.zeros((1,)),
        jnp.zeros((1, 4))))
    tm = DiffusionUNet(dim=8, dim_mults=(1, 2)).eval()
    tm.load_state_dict(jax_params.diffusion_unet_from_jax(params, tm))
    kw = dict(image_size=32, timesteps=16, sampling_timesteps=4,
              objective="pred_x0", beta_schedule="sigmoid",
              ddim_sampling_eta=0.0)
    jd = JGaussianDiffusion(
        apply_fn=lambda p, x, t, pc: jm.apply(p, x, t, pc), **kw)
    td = GaussianDiffusion(**kw)

    rng = np.random.default_rng(0)
    x_init = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    pc = np.array([[40.0, 40.0, 16.0, 16.0], [35.0, 36.0, 16.0, 16.0]],
                  np.float32)
    mask = (rng.uniform(size=(2, 32, 32)) > 0.5).astype(np.float32)
    depth = rng.uniform(0.1, 0.4, (2, 32, 32)).astype(np.float32)
    cond = np.stack([depth, mask], -1) * 2.0 - 1.0
    return jd, params, td, tm, x_init, pc, cond, mask


@pytest.mark.parametrize("refine", [False, True])
def test_ddim_chain_matches(chain, refine):
    jd, params, td, tm, x_init, pc, cond, mask = chain
    ref = np.asarray(jd.sample(params, jax.random.PRNGKey(1),
                               param_cond=jnp.asarray(pc),
                               img_cond=jnp.asarray(cond),
                               has_refine_step=refine,
                               x_init=jnp.asarray(x_init)))
    got = td.sample(tm, param_cond=torch.from_numpy(pc),
                    img_cond=torch.from_numpy(cond),
                    has_refine_step=refine,
                    x_init=torch.from_numpy(x_init)).numpy()
    assert got.shape == ref.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    if not refine:
        # DDNM-pinned pixels are the condition itself: exact
        pinned = mask[..., None] > 0.5
        np.testing.assert_array_equal(got[pinned], ref[pinned])
        np.testing.assert_array_equal(
            got[pinned], ((cond[..., 0:1] + 1.0) * 0.5)[pinned])


def test_q_sample_matches(chain):
    jd, _, td, *_ = chain
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(3, 8, 8, 1)).astype(np.float32)
    noise = rng.normal(size=(3, 8, 8, 1)).astype(np.float32)
    t = np.array([0, 7, 15], np.int32)
    ref = np.asarray(jd.q_sample(jnp.asarray(x0), jnp.asarray(t),
                                 jnp.asarray(noise)))
    got = td.q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                      torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_sampling_config_guards():
    with pytest.raises(ValueError):
        GaussianDiffusion(image_size=8, timesteps=16, sampling_timesteps=0)
    # sampling_timesteps == timesteps selects the ancestral chain: one
    # forward a timestep, from T - 1 down to 0
    td = GaussianDiffusion(image_size=8, timesteps=16, sampling_timesteps=16)
    assert not td.is_ddim_sampling
    seen = []

    def model(x, t, pc):
        seen.append(int(t[0]))
        return torch.zeros_like(x)

    out = td.sample(model, param_cond=torch.zeros(1, 4))
    assert out.shape == (1, 8, 8, 1) and bool(torch.isfinite(out).all())
    assert seen == list(range(15, -1, -1))
