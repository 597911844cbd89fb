"""PyTorch port: the U-Nets, the weight carry from JAX params and the
inference bake, against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pointreggpt_tpu.models import DiffusionUNet as JDiffusionUNet
from pointreggpt_tpu.models import MaskUNet as JMaskUNet
from pointreggpt_tpu.models.bake import bake_inference_params
from pointreggpt_tpu.utils import torch_port
from test_torch_port_generator import single_torch_thread  # noqa: F401
from pointreggpt_tpu_torch.models import DiffusionUNet, MaskUNet
from pointreggpt_tpu_torch.models.bake import bake_inference
from pointreggpt_tpu_torch.utils import jax_params

# fp32 module parity: the repo's own bound for torch vs JAX U-Nets
# (tests/test_torch_parity.py) — conv / matmul summation order only
ATOL, RTOL = 2e-4, 1e-3


def _jitter(tree, seed):
    """Random-init params with biases and norm scales moved off 0 / 1 so
    every leaf is exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.05
                   ).astype(np.float32), tree)


def _diffusion_init(jm, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 1)),
        jnp.zeros((1,)), jnp.zeros((1, 4))))


@pytest.fixture(scope="module")
def diffusion_pair():
    jm = JDiffusionUNet(dim=8, dim_mults=(1, 2))
    params = _jitter(_diffusion_init(jm), 0)
    tm = DiffusionUNet(dim=8, dim_mults=(1, 2)).eval()
    tm.load_state_dict(jax_params.diffusion_unet_from_jax(params, tm))
    return jm, params, tm


@pytest.fixture(scope="module")
def mask_pair():
    jm = JMaskUNet(dim=8, dim_mults=(1, 2))
    params = _jitter(jax.jit(jm.init)(jax.random.PRNGKey(1),
                                      jnp.zeros((1, 32, 32, 1))), 1)
    tm = MaskUNet(dim=8, dim_mults=(1, 2)).eval()
    tm.load_state_dict(jax_params.mask_unet_from_jax(params, tm))
    return jm, params, tm


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def test_diffusion_unet_forward_matches(diffusion_pair):
    jm, params, tm = diffusion_pair
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    t = np.array([3.0, 911.0], np.float32)
    pc = rng.uniform(100, 600, (2, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, x, t, pc))
    with torch.no_grad():
        got = tm(_nchw(x), torch.from_numpy(t), torch.from_numpy(pc))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=ATOL, rtol=RTOL)


def test_mask_unet_forward_matches(mask_pair):
    jm, params, tm = mask_pair
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    x[0, :5, :5] = 0.0  # invalid pixels exercise the depth augment
    ref = np.asarray(jax.jit(jm.apply)(params, x))
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=ATOL, rtol=RTOL)


def _assert_same_tree(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_state_dict_round_trips_through_torch_port(diffusion_pair,
                                                   mask_pair):
    _, params, tm = diffusion_pair
    _assert_same_tree(
        torch_port.port_diffusion_unet(tm.state_dict(), params,
                                       num_stages=2), params)
    _, mparams, mm = mask_pair
    _assert_same_tree(
        torch_port.port_mask_unet(mm.state_dict(), mparams, num_stages=2),
        mparams)


def test_weight_carry_rejects_mismatch(diffusion_pair):
    _, params, _ = diffusion_pair
    with pytest.raises(ValueError, match="keys differ|shape mismatch"):
        jax_params.diffusion_unet_from_jax(
            params, DiffusionUNet(dim=8, dim_mults=(1, 2, 4)))
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_params.diffusion_unet_from_jax(
            params, DiffusionUNet(dim=16, dim_mults=(1, 2)))
    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["params"]["stray"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(ValueError, match="no port counterpart"):
        jax_params.diffusion_unet_from_jax(extra)
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["params"]["time_mlp_2"]
    with pytest.raises(ValueError, match="missing"):
        jax_params.diffusion_unet_from_jax(missing)


def _bf16_ulps(a, b):
    """Distance in bf16 steps between two bf16-valued arrays."""
    ia = np.asarray(a, np.float32).view(np.int32) >> 16
    ib = np.asarray(b, np.float32).view(np.int32) >> 16
    ia = np.where(ia < 0, -(ia & 0x7FFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFF), ib)
    return np.abs(ia - ib)


def test_bake_matches_jax_bake_to_one_ulp(diffusion_pair, mask_pair):
    for (_, params, tm), port in ((diffusion_pair,
                                   torch_port.port_diffusion_unet),
                                  (mask_pair, torch_port.port_mask_unet)):
        jbaked = bake_inference_params(params, jnp.bfloat16)
        tm.dtype = torch.bfloat16
        baked = bake_inference(tm, torch.bfloat16)
        tm.dtype = torch.float32
        assert baked is not tm
        sd = baked.state_dict()
        kinds = {str(v.dtype) for v in sd.values()}
        assert kinds == {"torch.bfloat16", "torch.float32"}
        tree = port({k: v.float() for k, v in sd.items()}, params,
                    num_stages=2)
        la, _ = jax.tree_util.tree_flatten(tree)
        lb, _ = jax.tree_util.tree_flatten(jbaked)
        n_bf16 = 0
        for ours, theirs in zip(la, lb):
            theirs = np.asarray(theirs)
            if theirs.dtype == ml_dtypes.bfloat16:
                n_bf16 += 1
                assert _bf16_ulps(ours, theirs.astype(np.float32)).max() <= 1
            else:
                np.testing.assert_array_equal(ours, theirs)
        assert n_bf16 > 10


def test_baked_bf16_forward_close_to_jax_fp32():
    # the JAX package's own bound for a baked bf16 forward against fp32
    # (models/bake.py, measured there at dim 8 on init params)
    from pointreggpt_tpu.models.bake import BF16_NOISE_REL

    jm = JDiffusionUNet(dim=8, dim_mults=(1, 2))
    params = _diffusion_init(jm)
    bf = DiffusionUNet(dim=8, dim_mults=(1, 2), dtype=torch.bfloat16)
    bf.load_state_dict(jax_params.diffusion_unet_from_jax(params, bf))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    t = np.array([5.0, 400.0], np.float32)
    pc = rng.uniform(100, 600, (2, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, x, t, pc))
    with torch.no_grad():
        got = bake_inference(bf, torch.bfloat16)(
            _nchw(x), torch.from_numpy(t), torch.from_numpy(pc))
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < BF16_NOISE_REL, rel
