"""PyTorch port at full production width against the JAX package's own
outputs, on the CPU: ``tests/data/torch_port_jax_reference.npz``, written
by ``tests/make_torch_port_jax_reference.py`` from the weights and inputs
that ``pointreggpt_tpu_torch/utils/jax_parity.py`` remakes from a seed.
The same file is what ``tests/test_torch_port_cuda_paths.py``'s
``test_jax_parity_on_the_card`` holds the card to."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointreggpt_tpu.models import DiffusionUNet as JDiffusionUNet
from pointreggpt_tpu.models import MaskUNet as JMaskUNet
from pointreggpt_tpu.utils import torch_port
from test_torch_port_generator import _template  # noqa: F401
from test_torch_port_generator import single_torch_thread  # noqa: F401
from pointreggpt_tpu_torch.models import DiffusionUNet, MaskUNet
from pointreggpt_tpu_torch.utils import jax_parity as J
from pointreggpt_tpu_torch.utils import seeded_weights as SW

REF = Path(__file__).resolve().parent / "data" / \
    "torch_port_jax_reference.npz"

# Port vs JAX on the CPU, measured (gaps as ``jax_parity.gaps`` reads
# them; one torch thread, and eight in the reference script): forward
# 0.0949 / 0.0950 (bf16; |output| up to 10.9), mask 7.5e-6 / 5.0e-6
# (fp32), step images 0.043 / 0.047, keep 0, overflow 0, the memory's
# voxel count 1.24e-3 / 4.4e-4 and centroid sum 1.39e-3 / 3.2e-4 of their
# size (the bf16 chain moves some depths across the 10 m clip and voxel
# edges; the thread count changes the bf16 sums' order). Each tolerance is
# about twice its larger gap; the keep mask and overflow are exact.
TOL = {"forward": 0.2, "mask": 2e-5, "step_images": 0.1, "step_keep": 0.0,
       "step_overflow": 0.0, "step_mem_count": 3e-3, "step_mem_sum": 3e-3}


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(REF))


@pytest.fixture(scope="module")
def nets():
    return J.nets()


def _check(got, ref):
    gap = J.gaps(got, ref)
    bad = {k: (v, TOL[k]) for k, v in gap.items() if not v <= TOL[k]}
    assert not bad, bad
    return gap


def test_reference_file(ref):
    assert REF.stat().st_size < 3 << 20
    assert int(ref["seed"]) == J.SEED
    assert ref["forward"].shape == (J.FORWARD_BATCH, J.H, J.H, 1)
    assert ref["mask"].shape == (J.MASK_BATCH, J.H, J.H, 1)
    assert ref["step_images"].shape == (J.STEP_BATCH, J.H, J.H, 1)
    # the step's condition and outputs are not degenerate
    assert 0.3 < ref["step_keep"].mean() < 1.0
    assert (ref["step_mem_count"] > 65536).all()
    assert ref["mask"].std() > 0.05  # probabilities off the sigmoid's ends
    # the stored CPU gaps are the ones these tolerances were set from
    for k, tol in TOL.items():
        assert float(ref[f"cpu_gap_{k}"]) <= tol, k


def test_forward_matches_jax(ref, nets):
    _check(J.run_port("cpu", cases=("forward",), nets_=nets), ref)


def test_mask_forward_matches_jax(ref, nets):
    _check(J.run_port("cpu", cases=("mask",), nets_=nets), ref)


# about 70 s on one CPU thread: ten bf16 forwards and two fp32 MaskUNet
# forwards at batch 2, 256^2
@pytest.mark.slow
def test_generator_step_matches_jax(ref, nets, tmp_path):
    _check(J.run_port("cpu", cases=("step",), nets_=nets,
                      tmp_dir=str(tmp_path)), ref)


def test_planted_fault_misses_the_forward_gate_widely(ref, nets):
    bad = (J.plant_fault(nets[0]),) + nets[1:]
    gap = J.gaps(J.run_port("cpu", cases=("forward",), nets_=bad), ref)
    assert gap["forward"] > 10 * TOL["forward"], gap


def test_seeded_weights():
    a = SW.seeded_state_dict(MaskUNet(dim=8, dim_mults=(1, 2)), 3)
    b = SW.seeded_state_dict(MaskUNet(dim=8, dim_mults=(1, 2)), 3)
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert (a["final_conv.0.bias"] == SW.MASK_OUT_BIAS).all()
    assert (a["downs.0.0.block1.norm.weight"] == 1).all()
    assert (a["downs.0.0.block1.norm.bias"] == 0).all()
    assert (a["downs.0.2.fn.norm.g"] == 1).all()
    assert (a["downs.0.2.fn.fn.to_out.0.bias"] == 0).all()
    w = a["downs.0.0.block1.proj.weight"]  # (8, 8, 3, 3): fan_in 72
    assert 0.5 < float(w.std() * 72**0.5) < 1.5
    c = SW.seeded_state_dict(MaskUNet(dim=8, dim_mults=(1, 2)), 3,
                             mask_out_bias=None)
    assert abs(float(c["final_conv.0.bias"])) < 0.2


def test_seeded_weights_cross_to_jax():
    """The weights reach the JAX package through ``torch_port`` as the
    reference script passes them: one small net of each kind, fp32."""
    h = 32
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, h, h, 1)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    pc = np.array([[300.0, 300.0, 16.0, 16.0]] * 2, np.float32)
    tm = SW.fill_seeded(DiffusionUNet(dim=8, dim_mults=(1, 2)), 5).eval()
    jm = JDiffusionUNet(dim=8, dim_mults=(1, 2))
    params = torch_port.port_diffusion_unet(
        tm.state_dict(), _template(jm, jnp.zeros((1, h, h, 1)),
                                   jnp.zeros((1,)), jnp.zeros((1, 4))),
        num_stages=2)
    want = np.asarray(jax.jit(jm.apply)(params, x, t, pc))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 torch.from_numpy(t), torch.from_numpy(pc))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=2e-4, rtol=1e-4)
    tdc = SW.fill_seeded(MaskUNet(dim=8, dim_mults=(1, 2)), 5,
                         mask_out_bias=None).eval()
    jdc = JMaskUNet(dim=8, dim_mults=(1, 2))
    dc = torch_port.port_mask_unet(
        tdc.state_dict(), _template(jdc, jnp.zeros((1, h, h, 1))),
        num_stages=2)
    depth = rng.uniform(0, 1, (2, h, h, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jdc.apply)(dc, depth))
    with torch.no_grad():
        got = tdc(torch.from_numpy(depth).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)
