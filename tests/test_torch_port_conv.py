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
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# the route of the U-Nets' convs (ops/conv.py::conv2d) and conv3_dw


@pytest.mark.parametrize("device,dtype,kernel,stride,padding,dilation,"
                         "groups,want", [
                             ("cuda", torch.float32, (3, 3), 1, 1, 1, 1, True),
                             ("cuda", torch.float32, 3, (1, 1), (1, 1),
                              (1, 1), 1, True),
                             ("cpu", torch.float32, (3, 3), 1, 1, 1, 1, False),
                             ("cuda", torch.bfloat16, (3, 3), 1, 1, 1, 1,
                              False),
                             ("cuda", torch.float16, (3, 3), 1, 1, 1, 1,
                              False),
                             ("cuda", torch.float64, (3, 3), 1, 1, 1, 1,
                              False),
                             ("cuda", torch.float32, (7, 7), 1, 3, 1, 1,
                              False),
                             ("cuda", torch.float32, (4, 4), 2, 1, 1, 1,
                              False),
                             ("cuda", torch.float32, (1, 1), 1, 0, 1, 1,
                              False),
                             ("cuda", torch.float32, (3, 1), 1, 1, 1, 1,
                              False),
                             ("cuda", torch.float32, (3, 3), 2, 1, 1, 1,
                              False),
                             ("cuda", torch.float32, (3, 3), 1, 0, 1, 1,
                              False),
                             ("cuda", torch.float32, (3, 3), 1, (1, 0), 1, 1,
                              False),
                             ("cuda", torch.float32, (3, 3), 1, "same", 1, 1,
                              False),
                             ("cuda", torch.float32, (3, 3), 1, 1, 2, 1,
                              False),
                             ("cuda", torch.float32, (3, 3), 1, 1, 1, 2,
                              False)])
def test_k5_route_is_a_function_of_device_dtype_and_geometry(
        device, dtype, kernel, stride, padding, dilation, groups, want):
    assert K.k5_route(device, dtype, kernel, stride, padding, dilation,
                      groups) is want


def _routed(model) -> tuple:
    """(convs the route sends to K5 on a card, convs it leaves to
    F.conv2d) over a net's Conv2d and WSConv modules."""
    from pointreggpt_tpu_torch.models.blocks import Conv2d

    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    k5 = sum(K.k5_route("cuda", m.compute_dtype, m.kernel_size, m.stride,
                        m.padding, m.dilation, m.groups) for m in convs)
    return k5, len(convs) - k5


def test_route_takes_43_of_the_mask_unets_convs_and_none_in_bf16():
    # 38 WSConvs, the last down stage's 3x3, three Upsample convs and the
    # last up stage's 3x3; left: the 7x7, three 4x4 stride-2 convs, nine
    # 1x1 residual convs and mid-attention's two 1x1 convs
    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.models import DiffusionUNet

    with torch.device("meta"):
        assert _routed(C.build_mask_unet(C.MaskModelConfig())) == (43, 15)
        assert _routed(DiffusionUNet(dtype=torch.bfloat16)) == (0, 58)
        assert _routed(DiffusionUNet()) == (43, 15)


def test_conv2d_routes_each_call_by_the_predicate(monkeypatch):
    """A full-width MaskUNet forward on the CPU with the route's predicate
    asked as on a card and the K5 function standing in as F.conv2d: 43
    calls routed, 15 left, no copy of a channels-last input."""
    from pointreggpt_tpu_torch import config as C

    route = K.k5_route
    monkeypatch.setattr(K, "k5_route",
                        lambda dev, *a: route("cuda", *a))
    monkeypatch.setattr(K.Conv2dK5Fn, "apply", staticmethod(
        lambda x, w, b: F.conv2d(x, w, b, 1, 1)))
    torch.manual_seed(0)
    net = C.build_mask_unet(C.MaskModelConfig()).to(
        memory_format=torch.channels_last)
    before = dict(K.ROUTES)
    with torch.no_grad():
        net(torch.rand(1, 1, 32, 32))
    got = {k: v - before[k] for k, v in K.ROUTES.items()}
    assert (got["conv_k5"], got["conv_library"]) == (43, 15)


def test_cpu_forward_routes_nothing_to_k5():
    from pointreggpt_tpu_torch.models import MaskUNet

    torch.manual_seed(0)
    net = MaskUNet(dim=8, dim_mults=(1, 2), resnet_block_groups=4)
    before = dict(K.ROUTES)
    with torch.no_grad():
        net(torch.rand(1, 1, 16, 16))
    n = sum(_routed(net))
    assert {k: v - before[k] for k, v in K.ROUTES.items()} == {
        "conv_k5": 0, "conv_library": n, "conv_copies": 0}


def _k5_f32_plain(x, wt, bias=None):
    """K5's fp32 entry in plain PyTorch: wt (cout, 3, 3, cin)."""
    out = K.conv3x3_plain(x, wt.permute(1, 2, 3, 0))
    return out if bias is None else out + bias


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_k5_function_lays_out_and_flips_as_f_conv2d(monkeypatch,
                                                    channels_last, bias):
    """Conv2dK5Fn's layouts, with K5's entry in plain PyTorch: y, dx, dw
    and db against autograd of F.conv2d in fp64; a layout that is not
    channels-last costs one counted copy (x forward, dy backward)."""
    monkeypatch.setattr(K, "_k5_f32", _k5_f32_plain)
    rng = np.random.default_rng(11)
    b, cin, cout, h, w = 2, 5, 7, 6, 9
    x = torch.tensor(rng.normal(size=(b, cin, h, w)))
    wt = torch.tensor(rng.normal(size=(cout, cin, 3, 3)))
    bb = torch.tensor(rng.normal(size=cout)) if bias else None
    gy = torch.tensor(rng.normal(size=(b, cout, h, w)))
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    got = [x.contiguous(memory_format=fmt).requires_grad_(),
           wt.contiguous(memory_format=fmt).requires_grad_()]
    got += [bb.clone().requires_grad_()] if bias else []
    want = [t.detach().clone().requires_grad_() for t in got]
    before = dict(K.ROUTES)
    y = K.Conv2dK5Fn.apply(got[0], got[1], got[2] if bias else None)
    copies = (not channels_last) + before["conv_copies"]
    assert K.ROUTES["conv_copies"] == copies
    y.backward(gy.contiguous(memory_format=fmt))
    assert K.ROUTES["conv_copies"] == copies + (not channels_last)
    yr = F.conv2d(want[0], want[1], want[2] if bias else None, padding=1)
    yr.backward(gy)
    np.testing.assert_allclose(y.detach().numpy(), yr.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    for a, r in zip(got, want):
        # dw and db summed in fp32 by the plain version
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)
    # dw lands in the weight's own layout
    assert got[1].grad.is_contiguous(memory_format=fmt)


def test_wgrad_and_the_bias_gradient_match_autograd_in_fp64():
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.normal(size=(2, 7, 9, 5)))
    g = torch.tensor(rng.normal(size=(2, 7, 9, 3)))
    w = torch.zeros((3, 5, 3, 3), dtype=torch.float64, requires_grad=True)
    b = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1).backward(
        g.permute(0, 3, 1, 2))
    # the nine fp32 products, HWIO, and conv3_dw's (cout, 3, 3, cin)
    np.testing.assert_allclose(K._wgrad(x, g).numpy(),
                               w.grad.permute(2, 3, 1, 0).numpy(),
                               rtol=1e-5, atol=1e-5)
    dw, db = K.conv3_dw(x, g)
    np.testing.assert_allclose(dw.numpy(), w.grad.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(db.numpy(), b.grad.numpy(), rtol=1e-6)
    assert K.conv3_dw(x, g, bias=False)[1] is None


# (b, h, w, cin, cout): every MaskUNet 3x3 shape at batch 4, and ragged
DW_SHAPES = [(4, h, h, cin, cout) for h, cin, cout in (
    (256, 64, 64), (256, 128, 64), (128, 64, 64), (128, 192, 128),
    (128, 128, 128), (128, 256, 128), (64, 128, 128), (64, 384, 256),
    (64, 256, 256), (64, 512, 256), (32, 256, 256), (32, 256, 512),
    (32, 512, 512), (32, 768, 512))] + [
    (1, 1, 1, 1, 1), (2, 7, 37, 5, 3), (1, 9, 33, 70, 130),
    (3, 13, 50, 36, 72), (2, 64, 64, 16, 8)]


@pytest.mark.parametrize("b,h,w,cin,cout", DW_SHAPES)
def test_dw_walk_covers_every_tap_channel_and_pixel_once(b, h, w, cin,
                                                         cout):
    """Every block of conv3_dw sums all nine taps of its 32 x 64 channel
    tile over its items' pixels: each (channel tile, pixel) once is each
    (tap, cin, cout, pixel) once; the blocks of input tile 0 sum db."""
    splits = K.dw_split(b, h, w, cin, cout)
    walk = K.dw_walk(b, h, w, cin, cout, splits)
    m_t, n_t = -(-cin // K.DW_TILE_CI), -(-cout // K.DW_TILE_CO)
    items = b * -(-h // K.DW_ROWS) * -(-w // K.DW_COLS)
    assert 1 <= splits <= items and len(walk) == m_t * n_t * splits
    count = np.zeros((m_t, n_t, b, h, w), np.int64)
    for ci0, co0, split, mine in walk:
        assert ci0 < cin and co0 < cout and mine
        for img, y0, x0 in mine:
            count[ci0 // K.DW_TILE_CI, co0 // K.DW_TILE_CO, img,
                  y0:y0 + K.DW_ROWS, x0:x0 + K.DW_COLS] += 1
    assert (count == 1).all()
    # a split's items are contiguous and the splits differ by at most one
    sizes = [len(m) for _, _, _, m in walk]
    assert max(sizes) - min(sizes) <= 1


def test_dw_split_fills_the_card_only_as_far_as_it_must():
    # the 2-tile 64 -> 64 convs split 64 ways (128 blocks); 128 tiles of
    # 512 -> 512 already fill a wave; 192 tiles of 768 -> 512 split 2 ways
    # (3 full waves, not 2 at 73%)
    assert K.dw_split(4, 256, 256, 64, 64) == 64
    assert K.dw_split(4, 128, 128, 64, 64) == 64
    assert K.dw_split(4, 32, 32, 512, 512) == 1
    assert K.dw_split(4, 32, 32, 768, 512) == 2
    assert K.dw_split(1, 1, 1, 1, 1) == 1


def test_trace_reads_the_route_kernels_as_hand_written():
    from portbench.lib import trace

    for name in (
            "void prgpt::conv3dw::conv3_kernel_dw<true>(float const*, "
            "float const*, float*, float*, prgpt::conv3dw::Geo)",
            "prgpt::conv3dw::conv3_kernel_dw_sum(float const*, float "
            "const*, float*, float*, int, int, int)",
            "void prgpt::conv3::conv3_kernel<prgpt::conv3::tf32::Body, "
            "true>(float const*, float const*, float*, prgpt::conv3::Geo, "
            "int, int, int)"):
        assert trace.kind(name) == "kernel", name
