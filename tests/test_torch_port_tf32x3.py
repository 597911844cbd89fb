"""The three-pass TF32 numerics of K1's and K2's fp32 kernels, emulated in
torch on the CPU and held against the JAX package in fp32.

On the card the fp32 bodies (``csrc/linear_attention_tf32.cuh`` for K1,
``flash_fwd_tf32x3`` in ``csrc/attention.cu`` for K2) take every product
on the TF32 tensor cores in three passes: x = hi + lo with hi = tf32(x) and
lo = x - hi, which the tensor cores read to TF32 by dropping its 13 low
bits (``split_raw_lo``), and a b ~= a_lo b_hi + a_hi b_lo + a_hi b_hi. Here
TF32 rounding is done on the fp32 bits with integer operations, as
``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero), and each
TF32 product is exact in fp32 (11-bit by 11-bit significands), so the
design's error, and what a single pass would cost, show before any card
run. The emulations follow the kernels' tiles: K2's 64-key tiles with an
online softmax in log2 units and P V with each 8-key block taken in the
order its accumulator fragments hold the keys; K1's splits of 64-row tiles
with a running max, the merge, and q C^ in the same permuted order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointreggpt_tpu.ops import attention as JA
from pointreggpt_tpu.ops import linear_attention as JLA
from test_torch_port_generator import single_torch_thread  # noqa: F401
from pointreggpt_tpu_torch.ops import attention as K2
from pointreggpt_tpu_torch.ops import linear_attention as K1

HEADS, D = 4, 32
HID = HEADS * D
TM = 64  # rows per tile of K1's kernels, keys per tile of K2's
LOG2E = 1.4426950408889634
# the card checks' fp32 bounds (tests/test_torch_port_cuda.py): K2 and K1
# max |got - ref|; the chip_smoke.py gates are 1e-4 (K2) and 1e-3 (K1)
K2_ATOL, K1_ATOL = 1e-5, 1e-4
K2_GATE = 1e-4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 stored mantissa bits) to nearest, ties away
    from zero, on the fp32 bits: add half a unit of the 13 dropped bits to
    the magnitude, then clear them (finite x)."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi); x - hi is exact in
    fp32. The exact two-term split, which ``split_raw_lo`` approximates."""
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def split_raw_lo(x: torch.Tensor) -> tuple:
    """(hi, lo) as the tensor cores take them from ``common.cuh``'s
    ``split_frag``: hi = tf32(x) rounded, lo = x - hi (exact in fp32) read
    to TF32 by dropping its 13 low bits."""
    hi = tf32(x)
    u = (x.float() - hi).contiguous().view(torch.int32)
    return hi, (u & -0x2000).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor, passes: str = "three"):
    """a @ b as the kernels take it on the TF32 tensor cores, each product
    exact in fp32, the sums in fp32: ``three`` passes, or a planted fault
    of the card tests: ``small_dropped`` (a_lo b_hi left out),
    ``b_lo_dropped`` (a_hi b_lo left out) or ``single`` (one TF32 pass)."""
    ah, al = split_raw_lo(a)
    bh, bl = split_raw_lo(b)
    if passes == "single":
        return ah @ bh
    if passes == "small_dropped":
        return ah @ bl + ah @ bh
    if passes == "b_lo_dropped":
        return al @ bh + ah @ bh
    return al @ bh + ah @ bl + ah @ bh


# The fragments of mma.m16n8k8 with tf32 inputs, per lane (g = lane / 4,
# t = lane % 4): element e of the accumulator is (row g + 8 (e >> 1),
# column 2t + (e & 1)); element i of the A operand is (row g + 8 (i & 1),
# k index t + 4 (i >> 1)). The kernels hand accumulator elements
# (0, 2, 1, 3) over as A's elements (0, 1, 2, 3).
A_FROM_ACC = (0, 2, 1, 3)


def fragment_key_order() -> list:
    """The column of the accumulator that each of A's 8 k indices holds
    when a k8 step takes an accumulator fragment as its A operand as the
    kernels do; the rows must agree."""
    order = [None] * 8
    for lane in range(32):
        g, t = divmod(lane, 4)
        for i, e in enumerate(A_FROM_ACC):
            assert g + 8 * (i & 1) == g + 8 * (e >> 1)  # same row
            k, col = t + 4 * (i >> 1), 2 * t + (e & 1)
            assert order[k] in (None, col)
            order[k] = col
    return order


PERM = fragment_key_order()


def test_tf32_rounds_to_nearest_away_on_the_bits():
    one = 1.0
    ulp = 2.0**-10  # one unit of TF32's last stored bit at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 2.0**-130, 0.0, -0.0, 3.0e38])
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp,
                         2.0**-130, 0.0, -0.0, tf32(torch.tensor(3.0e38))])
    got = tf32(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_split_keeps_10_bits_and_rebuilds_x_within_2_pow_minus_22():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=100_000) *
                     10.0**rng.uniform(-30, 30, 100_000), dtype=torch.float32)
    hi, lo = split(x)
    for part in (hi, lo):  # 10 stored mantissa bits: 13 low bits clear
        assert not (part.view(torch.int32) & 0x1FFF).any()
    xd = x.double()
    assert ((hi.double() - xd).abs() <= 2.0**-11 * xd.abs()).all()
    err = (hi.double() + lo.double() - xd).abs()
    assert (err <= 2.0**-22 * xd.abs()).all(), (err / xd.abs()).max()


def test_raw_lo_split_loses_at_most_one_bit_of_the_exact_split():
    # the kernels' split: the same hi, lo within one TF32 unit of the
    # rounded lo (its low 13 bits dropped, not rounded), so hi + lo holds
    # x within 2^-21 relative where the exact split holds 2^-22
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=100_000) *
                     10.0**rng.uniform(-30, 30, 100_000), dtype=torch.float32)
    hi, lo = split(x)
    hr, lr = split_raw_lo(x)
    assert torch.equal(hr, hi)
    assert not (lr.view(torch.int32) & 0x1FFF).any()
    raw = (x.double() - hr.double()).abs()
    assert ((lr.double() - lo.double()).abs() <= 2.0**-10 * raw).all()
    xd = x.double()
    err = (hr.double() + lr.double() - xd).abs()
    assert (err <= 2.0**-21 * xd.abs()).all(), (err / xd.abs()).max()


def test_three_passes_hold_fp32_products_where_one_does_not():
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.normal(size=(64, 512)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(512, 64)), dtype=torch.float32)
    exact = a.double() @ b.double()
    scale = exact.abs().max()
    fp32 = ((a @ b).double() - exact).abs().max() / scale
    three = (mm3(a, b).double() - exact).abs().max() / scale
    single = (mm3(a, b, "single").double() - exact).abs().max() / scale
    assert three <= 4 * fp32, (three, fp32)
    assert single >= 100 * three, (single, three)


def test_fragment_key_order_is_the_kernels_permutation():
    # A's index t is column 2t and t + 4 is column 2t + 1: K2 reads V's
    # rows 8 jb + 2t and 8 jb + 2t + 1, K1 C^'s rows 8 kd + 2t and + 1
    assert PERM == [0, 2, 4, 6, 1, 3, 5, 7]
    rng = np.random.default_rng(2)
    p = torch.tensor(rng.normal(size=(16, 64)), dtype=torch.float64)
    v = torch.tensor(rng.normal(size=(64, 32)), dtype=torch.float64)
    idx = (torch.arange(0, 64, 8)[:, None] + torch.tensor(PERM)).flatten()
    torch.testing.assert_close(p[:, idx] @ v[idx], p @ v)
    # a step that took A's k indices in their own order would pair P's
    # column 2t with V's row t: another product
    assert not torch.allclose(p[:, idx] @ v, p @ v)


def k2_emulated(q, k, v, scale, passes="three"):
    """K2's fp32 kernel as it computes, emulated: per 64-key tile S = (q
    scale) k^T in TF32 passes, times log2 e; the online softmax with exp2;
    O += P V in TF32 passes with each 8-key block in the fragments' key
    order (PERM), keys past n masked and their V rows zero; O / l."""
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    qs = qf * scale
    n = qf.shape[2]
    m = torch.full(qf.shape[:-1], -torch.inf)
    l, o = torch.zeros(qf.shape[:-1]), torch.zeros(qf.shape)
    idx = (torch.arange(0, TM, 8)[:, None] + torch.tensor(PERM)).flatten()
    for t0 in range(0, n, TM):
        kt, vt = kf[:, :, t0:t0 + TM], vf[:, :, t0:t0 + TM]
        pad = TM - kt.shape[2]
        kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
        s = mm3(qs, kt.transpose(-1, -2), passes) * LOG2E
        s[..., TM - pad:] = -torch.inf
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm3(p[..., idx], vt[..., idx, :], passes)
        m = mx
    return (o / l[..., None]).permute(0, 2, 1, 3)


def _k2_inputs(kind, b, n):
    if kind == "check":  # a peaked softmax (see K2.check_inputs)
        return K2.check_inputs(b, n, HEADS, D, torch.float32, "cpu")
    rng = np.random.default_rng(1)  # the card test's unit normals
    qkv = torch.tensor(rng.normal(size=(b, n, 3, HEADS, D)),
                       dtype=torch.float32)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _k2_ref(q, k, v):
    return np.asarray(JA._attention_xla(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), D**-0.5))


@pytest.mark.parametrize("kind,b,n", [("check", 8, 1024), ("check", 2, 100),
                                      ("normal", 2, 100), ("check", 3, 1),
                                      ("check", 2, 65)])
def test_k2_three_passes_match_xla(kind, b, n):
    # the design against the JAX reference in fp32, inside the card test's
    # bound (and so chip_smoke.py's 1e-4)
    q, k, v = _k2_inputs(kind, b, n)
    got = k2_emulated(q, k, v, D**-0.5)
    err = np.abs(got.numpy() - _k2_ref(q, k, v)).max()
    assert err <= K2_ATOL, err
    plain = K2.multihead_attention_plain(q, k, v, scale=D**-0.5)
    assert (got - plain).abs().max() <= K2_ATOL


@pytest.mark.parametrize("passes", ["single", "small_dropped"])
def test_k2_fewer_passes_miss_the_gate(passes):
    # one TF32 pass, or one of the two small passes dropped, is far past
    # chip_smoke.py's 1e-4 on K2.check_inputs at the generation shape
    q, k, v = _k2_inputs("check", 8, 1024)
    ref = _k2_ref(q, k, v)
    err = np.abs(k2_emulated(q, k, v, D**-0.5, passes).numpy() - ref).max()
    assert err > 3 * K2_GATE, err


def k1_emulated(x, w_qkv, w_out, b_out, g, eps, passes="three"):
    """K1's fp32 kernels as they compute, emulated: kernel A per split of
    64-row tiles (k|v = x W_k|v, a running max per lane, exp(k - m), C_h =
    alpha C_h + ek_h^T v_h); kernel B's merge with max-rescaling, C^ = C
    scale / s; kernel C's q = x W_q, per-head softmax, q C^_h with the d of
    each k8 step in the fragments' order (PERM), y = core W_out + b_out
    and the LayerNorm. Every product in TF32 passes."""
    b, n, c = x.shape
    x, w_qkv, w_out = x.float(), w_qkv.float(), w_out.float()
    kv = mm3(x, w_qkv[:, HID:], passes)
    k, v = kv[..., :HID], kv[..., HID:]
    splits, per = K1._splits(b, n, TM)
    parts = []
    for sp in range(splits):
        m = torch.full((b, HID), -torch.inf)
        s, cacc = torch.zeros(b, HID), torch.zeros(b, HEADS, D, D)
        for r0 in range(sp * per, min(n, (sp + 1) * per), TM):
            kt, vt = k[:, r0:r0 + TM], v[:, r0:r0 + TM]
            mn = torch.maximum(m, kt.amax(1))
            alpha = torch.exp(m - mn)
            ek = torch.exp(kt - mn[:, None])
            s = s * alpha + ek.sum(1)
            prod = torch.stack([mm3(ek[..., h * D:(h + 1) * D].transpose(1, 2),
                                    vt[..., h * D:(h + 1) * D], passes)
                                for h in range(HEADS)], 1)
            cacc = cacc * alpha.view(b, HEADS, D, 1) + prod
            m = mn
        parts.append((m, s, cacc))
    mm = torch.stack([p[0] for p in parts]).amax(0)
    w = [torch.exp(p[0] - mm) for p in parts]
    ss = sum(p[1] * wi for p, wi in zip(parts, w))
    cc = sum(p[2] * wi.view(b, HEADS, D, 1) for p, wi in zip(parts, w))
    chat = cc * (D**-0.5 / n) / ss.clamp_min(1e-30).view(b, HEADS, D, 1)

    q = mm3(x, w_qkv[:, :HID], passes)
    qs = torch.softmax(q.unflatten(-1, (HEADS, D)), -1)
    idx = (torch.arange(0, D, 8)[:, None] + torch.tensor(PERM)).flatten()
    core = torch.cat([mm3(qs[:, :, h, idx], chat[:, h, idx], passes)
                      for h in range(HEADS)], -1)
    y = mm3(core, w_out, passes) + b_out.float()
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, unbiased=False, keepdim=True)
    return (y - mean) * torch.rsqrt(var + eps) * g.float()


def _k1_ref(args, eps):
    return np.asarray(JLA._xla_fused(*(jnp.asarray(t.numpy()) for t in args),
                                     HEADS, D, eps))


@pytest.mark.parametrize("b,n,c", [(2, 256, 64), (2, 300, 34), (1, 1000, 128),
                                   (8, 100, 36)])
def test_k1_three_passes_match_xla(b, n, c):
    # on K1.check_inputs, where the core carries the output: within the
    # card test's 1e-4 (and so chip_smoke.py's 1e-3) of _xla_fused
    args = K1.check_inputs(b, n, c, torch.float32, "cpu")
    got = k1_emulated(*args, 1e-5)
    err = np.abs(got.numpy() - _k1_ref(args, 1e-5)).max()
    assert err <= K1_ATOL, err
    plain = K1.fused_linear_attention_plain(*args, eps=1e-5)
    assert (got - plain).abs().max() <= K1_ATOL


def test_k1_three_passes_match_pallas_interpret():
    args = K1.check_inputs(1, 256, 16, torch.float32, "cpu", seed=3)
    ref = JLA._pallas_fused(*(jnp.asarray(t.numpy()) for t in args), HEADS,
                            D, 1e-5, interpret=True)
    err = np.abs(k1_emulated(*args, 1e-5).numpy() - np.asarray(ref)).max()
    assert err <= K1_ATOL, err


@pytest.mark.parametrize("passes", ["single", "small_dropped"])
def test_k1_fewer_passes_miss_the_card_bound(passes):
    # one TF32 pass, or one small pass dropped, is some 1e-3 off on
    # K1.check_inputs (PERF.md gives the card's numbers): an order of
    # magnitude past the card test's 1e-4 and its three-pass error
    args = K1.check_inputs(2, 1024, 64, torch.float32, "cpu")
    ref = _k1_ref(args, 1e-5)
    three = np.abs(k1_emulated(*args, 1e-5).numpy() - ref).max()
    fewer = np.abs(k1_emulated(*args, 1e-5, passes).numpy() - ref).max()
    assert fewer > 3 * K1_ATOL and fewer > 30 * three, (fewer, three)
