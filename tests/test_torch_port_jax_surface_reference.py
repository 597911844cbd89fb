"""PyTorch port's library surface at full production width against the
JAX package's own outputs, on the CPU:
``tests/data/torch_port_jax_surface.npz``, written by
``tests/make_torch_port_jax_surface_reference.py`` from the weights and
inputs that ``pointreggpt_tpu_torch/utils/jax_surface.py`` remakes from a
seed. ``chip_smoke.py``'s ``surface_path`` and
``tests/test_torch_port_cuda.py`` hold the card to the same file."""

from pathlib import Path

import numpy as np
import pytest

from test_torch_port_generator import single_torch_thread  # noqa: F401
from pointreggpt_tpu_torch.utils import jax_surface as JS

REF = Path(__file__).resolve().parent / "data" / \
    "torch_port_jax_surface.npz"

# Port vs JAX on the CPU, measured (``jax_surface.gaps``; one torch thread
# here, eight in the reference script): condition 7.6e-6 (one pixel of
# 131,072 lands on the other side of an edge), denoise 0.047 (bf16; the
# masked pixels are pinned), interpolate 3.0e-5 / 2.5e-5 (fp32, |output|
# up to about 3), fourier 1.3e-5 / 1.1e-5 (fp32, two channels). Each
# tolerance is about twice its larger gap.
TOL = {"condition": 2e-5, "denoise": 0.1, "interpolate": 6e-5,
       "fourier": 3e-5}


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(REF))


@pytest.fixture(scope="module")
def nets():
    return JS.nets()


def test_reference_file(ref):
    assert REF.stat().st_size <= 3 << 20
    assert int(ref["seed"]) == JS.SEED
    assert ref["condition"].shape == (JS.BATCH, JS.H, JS.H, 2)
    assert ref["denoise"].shape == (JS.BATCH, JS.H, JS.H, 1)
    assert ref["interpolate"].shape == (JS.BATCH, JS.INTERP_H, JS.INTERP_H,
                                        1)
    assert ref["fourier"].shape == (1, JS.H, JS.H, 2)
    assert ref["interpolate_noise"].shape[0] == JS.INTERP_T - 1
    # the condition is partial and the outputs are not flat
    assert 0.3 < (ref["condition"][..., 1] > 0).mean() < 1.0
    for k in ("denoise", "interpolate", "fourier"):
        assert ref[k].std() > 0.05, k
    for k, tol in TOL.items():
        assert float(ref[f"cpu_gap_{k}"]) <= tol, k


@pytest.mark.parametrize("case", sorted(TOL))
def test_case_matches_jax(ref, nets, case):
    gap = JS.gaps(JS.run_port("cpu", ref, cases=(case,), nets_=nets), ref)
    assert gap[case] <= TOL[case], gap


def test_swapped_interpolation_misses_widely(ref, nets):
    gap = JS.gaps(JS.run_port("cpu", ref, cases=("interpolate",),
                              nets_=nets, lam=1 - JS.INTERP_LAM), ref)
    assert gap["interpolate"] > 1e3 * TOL["interpolate"], gap
