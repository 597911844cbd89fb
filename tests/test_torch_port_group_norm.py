"""The GroupNorm route (``pointreggpt_tpu_torch/ops/group_norm.py``) on the
CPU: its plain version against the expressions the nets wrote before it,
bit for bit; the route's choice and counters; the kernel's tile plan at the
nets' shapes; and the kernel's arithmetic (splits, Chan merges, the folded
a x + b) emulated in PyTorch against the plain version, with the faults the
card tests plant. The kernel itself runs in tests/test_torch_port_cuda.py.
"""

import math

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from pointreggpt_tpu_torch.models import DiffusionUNet
from pointreggpt_tpu_torch.models.adm import ADMUNet, AttentionBlock, ResBlock
from pointreggpt_tpu_torch.models.blocks import Block
from pointreggpt_tpu_torch.ops import group_norm as GN
from pointreggpt_tpu_torch.ops.attention import multihead_attention, rows
from pointreggpt_tpu_torch.ops import routes

DTYPES = [torch.bfloat16, torch.float32]


def check_inputs(b, c, h, w, groups, dtype, seed=0):
    return GN.check_inputs(b, c, h, w, groups, dtype, "cpu", seed)


def _block_before(norm, y, scale_shift, dtype):
    """``Block.forward`` after its conv, as written before the route."""
    x = norm(y.float())
    if scale_shift is not None:
        scale, shift = scale_shift
        x = x * (scale.float() + 1.0) + shift.float()
    return F.silu(x).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("groups,c", [(8, 64), (8, 128), (32, 256),
                                      (32, 768)])
@pytest.mark.parametrize("ss", [True, False])
def test_plain_is_the_block_expression_bit_for_bit(dtype, groups, c, ss):
    x, gamma, beta, scale, shift = check_inputs(2, c, 6, 5, groups, dtype)
    norm = nn.GroupNorm(groups, c, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
    sc = (scale, shift) if ss else None
    want = _block_before(norm, x, sc, dtype)
    got = GN.group_norm_act_plain(x, groups, norm.weight, norm.bias, 1e-5,
                                  *(sc or (None, None)), silu=True,
                                  out_dtype=dtype)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("groups", [8, 32])
def test_plain_is_the_adm_expressions_bit_for_bit(dtype, groups):
    """ADM's four forms before the route: in_layers (SiLU, cast), the AdaGN
    out_layers (scale and shift cast to fp32 first, 1 + scale), the
    attention block's norm (cast by the qkv conv) and the output head
    (SiLU, fp32)."""
    c = 4 * groups
    x, gamma, beta, scale, shift = check_inputs(2, c, 4, 7, groups, dtype, 3)
    norm = nn.GroupNorm(groups, c, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
    gn = lambda t: norm(t.float())  # GroupNorm32.forward as it was
    args = (x, groups, norm.weight, norm.bias, 1e-5)
    assert torch.equal(GN.group_norm_act_plain(*args, out_dtype=dtype),
                       F.silu(gn(x)).to(dtype))
    s32 = torch.cat([scale, shift], dim=1).float().chunk(2, dim=1)
    want = F.silu(gn(x) * (1.0 + s32[0]) + s32[1]).to(dtype)
    assert torch.equal(GN.group_norm_act_plain(*args, scale, shift,
                                               out_dtype=dtype), want)
    assert torch.equal(GN.group_norm_act_plain(*args, silu=False,
                                               out_dtype=dtype),
                       gn(x).to(dtype))
    assert torch.equal(GN.group_norm_act_plain(*args), F.silu(gn(x)))


def test_block_and_adm_blocks_forward_as_before():
    """Block, ADM's ResBlock and AttentionBlock give the bits their
    expressions before the route gave (CPU, the plain version)."""
    torch.manual_seed(0)
    blk = Block(6, 16, groups=8, dtype=torch.bfloat16)
    x = torch.randn(2, 6, 5, 5).to(torch.bfloat16)
    ss = torch.randn(2, 32, 1, 1).to(torch.bfloat16).chunk(2, dim=1)
    with torch.no_grad():
        assert torch.equal(blk(x, ss), _block_before(
            blk.norm, blk.proj(x), ss, torch.bfloat16))
        res = ResBlock(64, 32, 96, dtype=torch.bfloat16)
        emb = torch.randn(2, 32)
        xa = torch.randn(2, 64, 4, 4).to(torch.bfloat16)
        d = torch.bfloat16
        h = F.silu(res.in_layers[0](xa.float())).to(d)
        h = res.in_layers[2](h)
        sc, sh = res.emb_layers(emb).float()[:, :, None, None].chunk(2, 1)
        h = res.out_layers[0](h.float()) * (1.0 + sc) + sh
        h = res.out_layers[3](F.silu(h).to(d))
        assert torch.equal(res(xa, emb), res.skip_connection(xa) + h)
        att = AttentionBlock(64, 32, dtype=d)
        before = dict(GN.ROUTES)
        got = att(xa)
        assert GN.ROUTES["norm_plain"] == before["norm_plain"] + 1
        xn = nn.GroupNorm.forward(att.norm, xa.float())
        qkv = rows(att.qkv(xn)).reshape(2, 16, 2, 3, 32)
        out = multihead_attention(qkv[:, :, :, 0], qkv[:, :, :, 1],
                                  qkv[:, :, :, 2], scale=32 ** -0.5)
        out = out.reshape(2, 4, 4, 64).permute(0, 3, 1, 2)
        assert torch.equal(got, xa + att.proj_out(out))


def test_route_takes_the_plain_version_on_the_cpu_and_under_grad():
    x, gamma, beta, scale, shift = check_inputs(2, 16, 3, 3, 4,
                                                torch.float32)
    w = gamma.clone().requires_grad_()
    xg = x.clone().requires_grad_()
    before = dict(GN.ROUTES)
    y = GN.group_norm_act(xg, 4, w, beta, 1e-5, scale, shift)
    assert y.requires_grad  # autograd recorded the plain version
    y.sum().backward()
    assert w.grad is not None and xg.grad is not None
    with torch.no_grad():
        GN.group_norm_act(x, 4, w, beta, 1e-5, silu=False,
                          out_dtype=torch.bfloat16)
    assert {k: v - before[k] for k, v in GN.ROUTES.items()} == {
        "norm_fused": 0, "norm_plain": 2, "norm_copies": 0}
    assert not GN.fused_route(x, 4, gamma, beta, scale, shift)
    with pytest.raises(ValueError, match="go together"):
        GN.group_norm_act(x, 4, gamma, beta, 1e-5, scale, None)


def test_routes_list_the_norm_counters():
    assert {"norm_fused", "norm_plain", "norm_copies"} <= set(routes.ROUTES)
    assert {"conv_k5", "attn_k2_d64"} <= set(routes.ROUTES)
    GN.ROUTES["norm_copies"] += 1
    assert routes.ROUTES["norm_copies"] == GN.ROUTES["norm_copies"]
    GN.ROUTES["norm_copies"] -= 1


def _norm_shapes(net, *inputs, scale=1):
    """(c, h * scale, w * scale, groups) of every GroupNorm a forward
    runs, in order, read off the route."""
    seen = []
    orig = GN.group_norm_act

    def spy(x, groups, *a, **k):
        seen.append((x.shape[1], x.shape[2] * scale, x.shape[3] * scale,
                     groups))
        return orig(x, groups, *a, **k)

    import pointreggpt_tpu_torch.models.blocks as B
    B.group_norm_act = spy
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        B.group_norm_act = orig
    return seen


@pytest.fixture(scope="module")
def net_shapes():
    """Every GroupNorm of a dim-64 DiffusionUNet and of ADM at 256^2 (run
    at 32^2, the sizes scaled by 8)."""
    torch.manual_seed(0)
    dn = _norm_shapes(DiffusionUNet(), torch.randn(1, 1, 32, 32),
                      torch.zeros(1), torch.zeros(1, 4), scale=8)
    adm = _norm_shapes(ADMUNet(), torch.randn(1, 1, 32, 32), torch.zeros(1),
                       scale=8)
    return dn, adm


def test_the_nets_norms_are_the_counted_ones(net_shapes):
    dn, adm = net_shapes
    assert len(dn) == 38 and len(adm) == 101
    for got, table in ((dn, GN.DIM64_SHAPES), (adm, GN.ADM_SHAPES)):
        assert sorted(set(got)) == sorted((c, s, s, g)
                                          for c, s, g, _ in table)
        assert all(got.count((c, s, s, g)) == n for c, s, g, n in table)
    el = lambda s: sum(c * h * w for c, h, w, _ in s)
    assert el(dn) * 8 == 528_482_304  # batch 8: 2.11 GB in bf16
    assert el(adm) * 8 == 3_201_826_816
    assert {g for *_, g in dn} == {8} and {g for *_, g in adm} == {32}


@pytest.mark.parametrize("b", [4, 8])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_covers_every_shape_of_the_nets(net_shapes, b, itemsize):
    for c, h, w, groups in set(net_shapes[0] + net_shapes[1]):
        p = GN.plan(b, h * w, c, groups, itemsize, 132)
        threads = c // p["vec"] * p["by"]
        assert 128 <= threads <= 1024, (c, p)
        assert p["vec"] * itemsize == 16  # 16-byte loads at every shape
        assert (c // groups) % p["vec"] == 0
        # the statistics' splits cover the image, about 4 blocks an SM,
        # none under SPLIT_BYTES unless it is the whole image
        by, row = p["by"], p["by"] * c * itemsize
        assert p["span"] % by == 0
        assert p["splits"] * p["span"] >= h * w > (p["splits"] - 1) * p[
            "span"]
        want = -(-GN.STATS_BLOCKS * 132 // b)
        least = by * -(-GN.SPLIT_BYTES // row)
        assert p["splits"] <= want
        assert p["span"] >= least or p["splits"] == 1
        assert 2 * p["splits"] > want or p["span"] in (least, by)
        # the apply tiles cover a split, about TILE_BYTES each
        assert p["tile"] % p["by"] == 0 and p["tile"] <= p["span"]
        assert p["tiles"] * p["tile"] >= p["span"] > (p["tiles"] - 1) * p[
            "tile"]
        assert p["tile"] * c * itemsize <= GN.TILE_BYTES or p["tile"] == p[
            "by"]


def test_plan_narrows_the_vector_to_the_group():
    """The kernel loads 16 bytes a thread: a group narrower than that, or
    of a width it does not divide, is the plain version's, as are the
    dtype pairs it has no body for and bf16 past 2,048 channels."""
    bf, f32 = torch.bfloat16, torch.float32
    assert GN.plan(2, 9, 48, 2, 2)["vec"] == 8
    assert GN.plan(2, 9, 36, 3, 4)["vec"] == 4
    assert GN.plan(2, 9, 96, 4, 2)["by"] == 21  # 12 x 21 = 252 threads
    assert GN.takes(64, 8, bf, bf) and GN.takes(2048, 32, bf, f32)
    assert GN.takes(4096, 32, f32, f32) and GN.takes(36, 3, f32, f32)
    assert not GN.takes(8, 4, bf, bf)  # 2 channels a group
    assert not GN.takes(33, 3, f32, f32)
    assert not GN.takes(4096, 32, bf, bf)  # 512 threads a pixel
    assert not GN.takes(64, 8, f32, bf)  # no fp32-to-bf16 body
    assert not GN.takes(64, 8, torch.float16, torch.float16)
    assert not GN.takes(10, 4, f32, f32)
    with pytest.raises(ValueError, match="over 1024"):
        GN.plan(1, 4, 1025 * 8, 1025, 2)
    with pytest.raises(ValueError, match="whole vectors"):
        GN.plan(1, 4, 8, 4, 2)


def emulate(x, groups, gamma, beta, eps, scale=None, shift=None, silu=True,
            out_dtype=torch.float32, fault=None):
    """The kernel's arithmetic in PyTorch, split by split as :func:`GN.plan`
    cuts an image: each split's (mean, M2) per group, merged in order by
    Chan's formula, then a = rstd gamma (scale + 1), b = (beta - mean rstd
    gamma)(scale + 1) + shift per channel, y = a x + b, SiLU, one rounding.
    ``fault`` plants one of the card tests' faults."""
    b, c, h, w = x.shape
    cpg = c // groups
    p = GN.plan(b, h * w, c, groups, x.element_size())
    xf = x.float().permute(0, 2, 3, 1).reshape(b, h * w, groups, cpg)
    mean = torch.empty(b, groups)
    rstd = torch.empty(b, groups)
    for n in range(b):
        cnt = torch.zeros(groups)
        m = torch.zeros(groups)
        m2 = torch.zeros(groups)
        for t in range(p["splits"]):
            tile = xf[n, t * p["span"]:(t + 1) * p["span"]]
            nb = float(tile.shape[0] * cpg)
            mb = tile.mean(dim=(0, 2))
            sb = ((tile - mb[None, :, None]) ** 2).sum(dim=(0, 2))
            d = mb - m
            wgt = nb / (cnt + nb)
            m = m + d * wgt
            term = d * d * cnt * wgt
            m2 = m2 + sb + (0 * term if fault == "merge_term" else term)
            cnt = cnt + nb
        mean[n], rstd[n] = m, torch.rsqrt(m2 / cnt + eps)
    g_of = torch.arange(c) // cpg
    if fault == "wrong_group":
        g_of = (g_of + 1) % groups
    a = rstd[:, g_of] * gamma
    bb = beta - mean[:, g_of] * a
    if scale is not None:
        s1 = scale.reshape(b, c).float() + (0.0 if fault == "no_plus_one"
                                            else 1.0)
        a, bb = a * s1, bb * s1 + shift.reshape(b, c).float()
    y = a[:, :, None, None] * x.float() + bb[:, :, None, None]
    if silu:
        y = F.silu(y)
    return y.to(out_dtype)


EMU_SHAPES = [(2, 64, 16, 16, 8), (3, 128, 5, 7, 32), (1, 256, 20, 20, 32)]


@pytest.mark.parametrize("b,c,h,w,groups", EMU_SHAPES)
def test_kernel_arithmetic_matches_the_plain_version(b, c, h, w, groups):
    x, gamma, beta, scale, shift = check_inputs(b, c, h, w, groups,
                                                torch.float32, 7)
    for ss in (True, False):
        for silu in (True, False):
            sc = (scale, shift) if ss else (None, None)
            ref = GN.group_norm_act_plain(x, groups, gamma, beta, 1e-5, *sc,
                                          silu=silu)
            got = emulate(x, groups, gamma, beta, 1e-5, *sc, silu=silu)
            err = (got - ref).abs().max().item()
            assert err <= 1e-5 * ref.abs().max().item(), (ss, silu, err)


@pytest.mark.parametrize("fault", ["wrong_group", "no_plus_one",
                                   "merge_term"])
def test_kernel_check_sees_planted_fault(fault):
    b, c, h, w, groups = EMU_SHAPES[2]
    x, gamma, beta, scale, shift = check_inputs(b, c, h, w, groups,
                                                torch.float32, 7)
    ref = GN.group_norm_act_plain(x, groups, gamma, beta, 1e-5, scale, shift)
    got = emulate(x, groups, gamma, beta, 1e-5, scale, shift, fault=fault)
    err = (got - ref).abs().max().item()
    assert err > 1e-2 * ref.abs().max().item(), err


def test_work_counts_one_read_and_one_write():
    wk = GN.work_group_norm(8, 65536, 64, 2, 2)
    assert wk["bytes"] == 8 * 65536 * 64 * 4
    assert math.isclose(wk["bytes"] / 3.35e12 * 1e3, 0.0401, rel_tol=1e-2)
