"""PyTorch port, K5 and K6 (3x3 convs) and the conv op, against the JAX
package's two conv tools (CPU).

``conv3x3`` runs K5 and ``conv3_igemm`` K6, hand-written CUDA kernels, on a
CUDA tensor; on a CPU tensor each takes its plain version, held here
against the tools' Pallas kernels in interpret mode, their XLA convs and
``jax.grad`` through the JAX ``conv3x3``. The tools are not a package:
they are loaded from ``tools/`` by path, and their import-time changes to
JAX's global config are undone.
"""

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_generator import single_torch_thread  # noqa: F401
from pointreggpt_tpu_torch.ops import _build
from pointreggpt_tpu_torch.ops import conv as K
from pointreggpt_tpu_torch.tools import (kernel_resources, profile_conv,
                                         profile_conv_igemm)

REPO = Path(__file__).resolve().parent.parent
# both tools set these at import: a persistent compilation cache under
# ~/.cache that no other test on this worker should write
_TOOL_CONFIG = ("jax_compilation_cache_dir",
                "jax_persistent_cache_min_compile_time_secs")
_CONFIG_BEFORE = {k: getattr(jax.config, k) for k in _TOOL_CONFIG}


@pytest.fixture(scope="module")
def jtools():
    saved = {k: getattr(jax.config, k) for k in _TOOL_CONFIG}
    path = list(sys.path)
    mods = {}
    try:
        for name in ("profile_conv", "profile_conv_igemm"):
            spec = importlib.util.spec_from_file_location(
                f"_jax_tool_{name}", REPO / "tools" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[name] = mod
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return SimpleNamespace(**mods)


def test_loading_the_jax_tools_leaves_jax_config_alone(jtools):
    assert jtools.profile_conv.conv3x3 is not None
    assert {k: getattr(jax.config, k) for k in _TOOL_CONFIG} == \
        _CONFIG_BEFORE


def _inputs(b, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, cin)).astype(np.float32),
            (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t.astype(jnp.float32))


# bf16 on both sides: fp32 sums of exact bf16 products in another order,
# rounded once to bf16, differ by at most one bf16 step (2^-8 relative)
BF16_REL = 2**-7


def test_conv3x3_plain_matches_pallas_interpret(jtools):
    x, w = _inputs(2, 16, 128, 16, 8)
    ref = jtools.profile_conv._conv3x3_pallas(_bf16(x), _bf16(w),
                                              interpret=True)
    got = K.conv3x3(torch.from_numpy(x).bfloat16(),
                    torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 128, 8)
    assert _rel(_np(got), _np(ref)) <= BF16_REL


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_conv3x3_plain_matches_xla(jtools, dtype):
    # edges, cin != cout, a width that is not a multiple of any tile
    x, w = _inputs(2, 7, 10, 5, 3, seed=1)
    ref = jtools.profile_conv.conv3x3_xla(jnp.asarray(x, dtype),
                                          jnp.asarray(w))
    got = K.conv3x3_plain(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(w))
    assert _rel(_np(got), _np(ref)) <= (BF16_REL if dtype == "bfloat16"
                                        else 1e-6)


def test_conv3x3_grads_match_jax_grad(jtools):
    # fp32, cin != cout: dx through the flipped, channel-swapped weights
    # (K5 again on the card), dw through the nine shifted products
    x, w = _inputs(2, 6, 9, 5, 3, seed=2)
    JC = jtools.profile_conv

    def loss(a, b):
        return jnp.sum(JC.conv3x3(a, b)**2)

    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xx = torch.from_numpy(x).requires_grad_()
    ww = torch.from_numpy(w).requires_grad_()
    out = K.conv3x3(xx, ww)
    assert type(out.grad_fn).__name__ == "Conv3x3FnBackward"
    (out**2).sum().backward()
    for got, r in ((xx.grad, ref[0]), (ww.grad, ref[1])):
        assert got.shape == r.shape
        assert _rel(got.numpy(), r) <= 1e-5


def test_conv3x3_grads_keep_dtypes():
    x, w = _inputs(1, 4, 4, 3, 2, seed=3)
    xx = torch.from_numpy(x).bfloat16().requires_grad_()
    ww = torch.from_numpy(w).requires_grad_()
    K.conv3x3(xx, ww).float().sum().backward()
    assert xx.grad.dtype == torch.bfloat16 and ww.grad.dtype == torch.float32


def test_conv3_igemm_plain_matches_pallas_interpret(jtools):
    x, w = _inputs(2, 32, 32, 64, 64, seed=4)
    ref = jtools.profile_conv_igemm.conv3_igemm(_bf16(x), jnp.asarray(w),
                                                rows=8, interpret=True)
    got = K.conv3_igemm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                        rows=8)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 32, 32, 64)
    assert _rel(_np(got), _np(ref)) <= BF16_REL


def test_conv3_igemm_asserts_rows_divide_h():
    x = torch.zeros((1, 12, 8, 4), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 4, 4))
    with pytest.raises(AssertionError):
        K.conv3_igemm(x, w, rows=8)
    with pytest.raises(AssertionError):
        K.conv3_igemm_plain(x, w, rows=8)
    assert K.conv3_igemm(x, w, rows=4).shape == (1, 12, 8, 4)


@pytest.mark.parametrize("name", ["conv_shift9", "conv_pair"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tool_variants_match_jax(jtools, name, dtype):
    x, w = _inputs(2, 6, 9, 5, 3, seed=5)
    ref = getattr(jtools.profile_conv, name)(jnp.asarray(x, dtype),
                                             jnp.asarray(w, dtype))
    got = getattr(K, name)(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert _rel(_np(got), _np(ref)) <= (BF16_REL if dtype == "bfloat16"
                                        else 1e-6)


def test_blockdiag_matches_jax(jtools):
    x, w = _inputs(4, 8, 8, 6, 5, seed=6)
    ref = jtools.profile_conv_igemm.conv3_blockdiag(_bf16(x), jnp.asarray(w))
    got = K.conv3_blockdiag(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(w))
    assert got.dtype == torch.bfloat16 and got.shape == (4, 8, 8, 5)
    assert _rel(_np(got), _np(ref)) <= BF16_REL


def test_library_conv_is_the_same_function():
    x, w = map(torch.from_numpy, _inputs(2, 5, 7, 4, 6, seed=7))
    np.testing.assert_allclose(K.conv_library(x, w).numpy(),
                               K.conv3x3_plain(x, w).numpy(), atol=1e-5)


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    before = (K.conv3x3.launches, K.conv3_igemm.launches)
    x, w = map(torch.from_numpy, _inputs(1, 8, 8, 4, 4, seed=8))
    x.requires_grad_()
    K.conv3x3(x, w).sum().backward()
    K.conv3_igemm(x.detach().bfloat16(), w)
    assert (K.conv3x3.launches, K.conv3_igemm.launches) == before
    assert not {"conv3x3", "conv3_igemm"} & set(_build._libs)


def test_work_conv_counts():
    wk = K.work_conv(16, 256, 256, 128, 64, 2)
    assert wk["flops"] == 2 * 16 * 256 * 256 * 128 * 64 * 9
    assert wk["bytes"] == (16 * 256 * 256 * (128 + 64) + 9 * 128 * 64) * 2


def test_check_inputs_conv_are_seeded_and_typed():
    x, w = K.check_inputs_conv(2, 4, 5, 3, 6, torch.bfloat16, "cpu",
                               w_dtype=torch.float32)
    x2, w2 = K.check_inputs_conv(2, 4, 5, 3, 6, torch.bfloat16, "cpu",
                                 w_dtype=torch.float32)
    assert x.dtype == torch.bfloat16 and w.dtype == torch.float32
    assert x.shape == (2, 4, 5, 3) and w.shape == (3, 3, 3, 6)
    assert torch.equal(x, x2) and torch.equal(w, w2)


def _conv_with_fault(x, w, fault, tile_rows):
    """The conv as K5 or K6 computes it, with one planted fault of
    tests/test_torch_port_cuda.py: fp32 sums of the x.dtype products, each
    tile of ``tile_rows`` output rows reading its own halo window (with
    ``stale_ring_stage``, the window of the tile before it, and zeros for
    the first)."""
    b, h, wd, cin = x.shape
    xf, wf = x.float(), w.to(x.dtype).float()
    if fault == "cin_slice_dropped":  # input channels 16..31 left out
        wf = wf.clone()
        wf[:, :, 16:32] = 0
    out = torch.zeros((b, h, wd, w.shape[-1]))
    pad = torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1))
    prev = torch.zeros_like(pad[:, :tile_rows + 2])
    for y0 in range(0, h, tile_rows):
        win = pad[:, y0:y0 + tile_rows + 2].clone()  # rows y0-1 .. y0+R
        if fault == "halo_row_lost" and y0 > 0:
            win[:, 0] = 0
        if fault == "edge_wrapped":
            win[:, :, 0], win[:, :, -1] = _wrapped_cols(xf, y0, tile_rows)
        if fault == "stale_ring_stage":
            win, prev = prev, win
        for dy in range(3):
            for dx in range(3):
                if fault == "tap_dropped" and (dy, dx) == (2, 2):
                    continue
                rows = min(tile_rows, h - y0)
                out[:, y0:y0 + rows] += win[:, dy:dy + rows, dx:dx + wd] @ \
                    wf[dy, dx]
    return out.to(x.dtype)


def _wrapped_cols(xf, y0, tile_rows):
    """The window's left and right edge columns when the column index
    wraps around the image instead of reading zeros."""
    h = xf.shape[1]
    idx = [y for y in range(y0 - 1, y0 + tile_rows + 1)]
    left = torch.stack([xf[:, y, -1] if 0 <= y < h else
                        torch.zeros_like(xf[:, 0, -1]) for y in idx], 1)
    right = torch.stack([xf[:, y, 0] if 0 <= y < h else
                         torch.zeros_like(xf[:, 0, 0]) for y in idx], 1)
    return left, right


# The card checks hold K5 and K6 against their plain versions by max |got -
# ref| / max |ref| <= 1e-2 in bf16 on K.check_inputs_conv; each planted
# fault must move the output past that. Row tiles: K5's 16, K6's 8; h = 32
# gives each at least two.
@pytest.mark.parametrize("tile_rows", [K.K5_TILE_ROWS, K.ROWS])
@pytest.mark.parametrize("fault", [None, "tap_dropped", "halo_row_lost",
                                   "edge_wrapped", "cin_slice_dropped",
                                   "stale_ring_stage"])
def test_conv_check_inputs_expose_faults(fault, tile_rows):
    x, w = K.check_inputs_conv(2, 32, 16, 64, 64, torch.bfloat16, "cpu")
    ref = K.conv3x3_plain(x, w)
    err = _rel(_np(_conv_with_fault(x, w, fault, tile_rows)), _np(ref))
    if fault is None:
        assert err <= 1e-2, err
    else:
        assert err > 3e-2, err


def _tile_cover(b, h, w, cout, tile_rows, tile_cols, blocks):
    """How often the walk of :func:`K.conv_tiles` writes each (image,
    output pixel, n tile), with the kernel's masks at h, w and the tile's
    rows."""
    walk = K.conv_tiles(b, h, w, cout, tile_rows, tile_cols, blocks=blocks)
    n_tiles = -(-cout // K.TILE_N)
    count = np.zeros((b, h, w, n_tiles), np.int64)
    for mine in walk:
        for img, y0, x0, n0 in mine:
            assert n0 % K.TILE_N == 0 and x0 % tile_cols == 0
            count[img, y0:min(y0 + tile_rows, h),
                  x0:min(x0 + tile_cols, w), n0 // K.TILE_N] += 1
    return walk, count


@pytest.mark.parametrize("b,h,w,cout,blocks", [
    (3, 37, 50, 130, 132), (1, 1, 1, 1, 132), (2, 16, 40, 36, 5),
    (16, 128, 128, 128, 132), (4, 40, 100, 72, 132)])
def test_conv_tiles_cover_every_output_once_k5(b, h, w, cout, blocks):
    walk, count = _tile_cover(b, h, w, cout, K.K5_TILE_ROWS,
                              K.tile_cols(K.K5_TILE_ROWS, 64), blocks)
    assert (count == 1).all()
    tiles = sum(len(m) for m in walk)
    assert len(walk) == min(tiles, blocks)
    # block g walks tiles g, g + G, ...: counts differ by at most one
    assert max(map(len, walk)) - min(map(len, walk)) <= 1


@pytest.mark.parametrize("rows", range(1, 17))
def test_conv_tiles_cover_every_output_once_k6(rows):
    for cin in (64, 128):
        walk, count = _tile_cover(3, 3 * rows, 137, 100, rows,
                                  K.tile_cols(rows, cin), 7)
        assert (count == 1).all()
        # n tile slowest: a block's n tile never goes back
        for mine in walk:
            ns = [t[3] for t in mine]
            assert ns == sorted(ns)


def test_tile_cols_fill_the_block():
    # 4 warps x 64 pixels: the tile's full height times its columns
    for rows in range(1, 17):
        full = 4 if rows <= 4 else 8 if rows <= 8 else 16
        assert full * K.tile_cols(rows, 64) == 256
        assert K.tile_cols(rows, 65) == 16
    assert K.tile_cols(K.K5_TILE_ROWS, 64) == 16


def test_profile_conv_main_runs_on_the_cpu():
    res = profile_conv.main(shapes=[(2, 8, 16, 4, 6)], iters=1, device="cpu")
    assert res["device"] == "cpu"
    (row,) = res["shapes"]
    assert set(row) >= {"conv", "shift9", "pair", "kernel", "plain_ms",
                        "grad_rel_err", "fwd_bwd"}
    # the CPU takes the plain version: the kernel variant is exact
    assert row["kernel"]["rel_err"] == 0.0
    assert row["grad_rel_err"]["dw"] <= 1e-2
    assert set(row["fwd_bwd"]) == {"conv3x3_ms", "library_autograd_ms",
                                   "wgrad_ms"}


def test_profile_conv_igemm_main_runs_on_the_cpu(monkeypatch):
    monkeypatch.setenv("IGEMM_ROWS", "4,8")
    monkeypatch.setenv("IGEMM_BLOCKDIAG", "1")
    res = profile_conv_igemm.main(batches=(2,), size=16, iters=1,
                                  device="cpu")
    assert res["correctness"]["rel_err"] == 0.0
    (row,) = res["batches"]
    assert [r["rows"] for r in row["igemm"]] == [4, 8]
    assert "blockdiag_ms" in row and row["library_ms"] > 0


def test_kernel_resources_reads_ptxas_output():
    text = """\
ptxas info    : Compiling entry function '_Z4kernA' for 'sm_90a'
ptxas info    : Function properties for _Z4kernA
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 135 registers, used 1 barriers, 16 bytes smem
ptxas info    : Compiling entry function '_Z4kernB' for 'sm_90a'
ptxas info    : Function properties for _Z4kernB
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 78 registers
"""
    rows = kernel_resources.parse(text)
    assert rows == [
        dict(kernel="_Z4kernA", stack_frame=0, spill_stores=8,
             spill_loads=12, registers=135, static_smem=16),
        dict(kernel="_Z4kernB", stack_frame=0, spill_stores=0,
             spill_loads=0, registers=78)]
