"""The three-pass TF32 numerics of K5's fp32 body (the 3x3 conv) and of
K3's fp32 q path, kv path and weight gradients, emulated in torch on the
CPU and held against the JAX package in fp32.

On the card ``csrc/conv3_tf32.cuh`` (K5) and
``csrc/linear_attention_bwd_tf32.cuh`` (K3) take every product on the TF32
tensor cores in three passes, x = hi + lo, a b ~= a_lo b_hi + a_hi b_lo +
a_hi b_hi, with hi = tf32(x) rounded and lo = x - hi left for the tensor
cores to read to TF32, which drops its 13 low bits (the split and ``mm3``
of ``test_torch_port_tf32x3.py``, whose ``tf32`` rounds on the fp32 bits;
each product is exact in fp32). The
emulations follow the kernels' order of sums: every fragment holds one
k range (K5: one k8 step of a tap column, 3 taps x 8 channels; K3: 32
channels, or one 64-row tile for the dC^ partial, or 32 rows for a weight
gradient),
added to the running sum in fp32 in the kernels' order; q~ C^ and dcore C^^T
take each k8 step in the accumulator fragments' permuted order. So the
designs' errors, and what a single pass would cost, show before any card
run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointreggpt_tpu.ops import linear_attention as JLA
from test_torch_port_conv import jtools  # noqa: F401
from test_torch_port_generator import single_torch_thread  # noqa: F401
from test_torch_port_tf32x3 import PERM, mm3
from pointreggpt_tpu_torch.ops import conv as KC
from pointreggpt_tpu_torch.ops import linear_attention as K1

HEADS, D = 4, 32
HID = HEADS * D
TM = 64    # rows per tile of K3's kernels (and K1's kernel A)
KCH = 32   # channels per chunk, and the deepest k range of one fragment
# the card checks' fp32 bounds: K5 max |got - ref| / max |ref| (1e-5, as
# chip_smoke.py's CONV_FP32_RTOL), K3 the same per output (1e-4, the card
# tests' K3_TOL and chip_smoke.py's K3_ATOL)
K5_RTOL, K3_RTOL = 1e-5, 1e-4


def mmc(a, b, passes="three", k=KCH):
    """a @ b with the contraction in ``k``-deep ranges, each range's
    products in TF32 passes (``mm3``) summed apart, the ranges added in
    fp32 in order: a fragment per range, as the kernels keep them."""
    out = None
    for k0 in range(0, a.shape[-1], k):
        p = mm3(a[..., k0:k0 + k], b[..., k0:k0 + k, :], passes)
        out = p if out is None else out + p
    return out


def _rel(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32).reshape(got.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ----------------------------------------------------------------- K5 fp32


def _shift(x, dy, dx):
    """x shifted so out[:, r, c] = x[:, r + dy, c + dx], zero-filled."""
    _, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    return xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def k5_emulated(x, w, passes="three"):
    """K5's fp32 body as it computes: per 32-channel chunk, per tap column
    dx, per k8 step, the three taps (dy, dx) of the step's 8 channels
    summed into a fragment of their own (TF32 passes), added to the running
    sums in fp32."""
    cin = x.shape[-1]
    acc = None
    for c0 in range(0, cin, KCH):
        for dx in range(3):
            for k0 in range(c0, min(c0 + KCH, cin), 8):
                xc, wc = x[..., k0:k0 + 8], w[:, :, k0:k0 + 8]
                t = None
                for dy in range(3):
                    p = mm3(_shift(xc, dy - 1, dx - 1), wc[dy, dx], passes)
                    t = p if t is None else t + p
                acc = t if acc is None else acc + t
    return acc


def _conv_inputs(shape, seed=0):
    x, w = KC.check_inputs_conv(*shape, torch.float32, "cpu", seed)
    return x, w


@pytest.mark.parametrize("shape", [(2, 16, 16, 64, 64), (1, 9, 7, 36, 20)])
def test_k5_three_passes_match_pallas_and_xla(jtools, shape):  # noqa: F811
    # the design against the JAX tool's Pallas kernel (interpret mode) and
    # its XLA conv in fp32, inside chip_smoke.py's 1e-5 relative; a 36 ->
    # 20 conv leaves a ragged last chunk
    x, w = _conv_inputs(shape)
    got = k5_emulated(x, w)
    pallas = jtools.profile_conv._conv3x3_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), interpret=True)
    xla = jtools.profile_conv.conv3x3_xla(jnp.asarray(x.numpy()),
                                          jnp.asarray(w.numpy()))
    errs = [_rel(got, ref) for ref in (pallas, xla, KC.conv3x3_plain(x, w))]
    print(shape, errs)
    assert max(errs) <= K5_RTOL, errs


@pytest.mark.parametrize("passes", ["single", "small_dropped"])
def test_k5_fewer_passes_miss_the_gate(jtools, passes):  # noqa: F811
    # one TF32 pass, or one of the two small passes dropped (the card
    # tests' planted faults), is past the 1e-5 gate, and far past the
    # three passes' own error
    x, w = _conv_inputs((2, 16, 16, 64, 64))
    ref = jtools.profile_conv.conv3x3_xla(jnp.asarray(x.numpy()),
                                          jnp.asarray(w.numpy()))
    three = _rel(k5_emulated(x, w), ref)
    fewer = _rel(k5_emulated(x, w, passes), ref)
    print(passes, fewer, three)
    assert fewer > 3 * K5_RTOL and fewer > 30 * three, (fewer, three)


# ----------------------------------------------------------------- K3 fp32


def _blocks(t):
    """(b, 128, 128) -> (b, heads, 32, 32): the head-diagonal blocks."""
    return torch.stack([t[:, h * D:(h + 1) * D, h * D:(h + 1) * D]
                        for h in range(HEADS)], 1)


def _statistics(x, w_kv, passes):
    """K1's fp32 kernels A and B, as k1_emulated of
    test_torch_port_tf32x3.py: per split of
    64-row tiles a running max, exp(k - m), C_h = alpha C_h + ek_h^T v_h
    (each tile's products apart); merged with max-rescaling. Returns m, s,
    C (unscaled) and C^."""
    b, n, _ = x.shape
    kv = mmc(x, w_kv, passes)
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
            prod = torch.stack([mm3(
                ek[..., h * D:(h + 1) * D].transpose(1, 2),
                vt[..., h * D:(h + 1) * D], passes) for h in range(HEADS)], 1)
            cacc = cacc * alpha.view(b, HEADS, D, 1) + prod
            m = mn
        parts.append((m, s, cacc))
    mm = torch.stack([p[0] for p in parts]).amax(0)
    wts = [torch.exp(p[0] - mm) for p in parts]
    s = sum(p[1] * wi for p, wi in zip(parts, wts))
    cmat = sum(p[2] * wi.view(b, HEADS, D, 1) for p, wi in zip(parts, wts))
    chat = cmat * (D**-0.5 / n) / s.clamp_min(1e-30).view(b, HEADS, D, 1)
    return mm, s, cmat, chat


def _rows_product(a, b, passes):
    """sum over rows of a^T b (a: (rows, P), b: (rows, Q)) in stages of 32
    rows, each stage's products apart (the weight gradients)."""
    return mmc(a.T, b, passes)


def k3_emulated(x, dy, w_qkv, w_out, b_out, g, eps, passes="three"):
    """K3's fp32 launches as they compute, emulated: the statistics
    (K1's kernels A and B); the q path (q = x W_q, the per-head softmax,
    core = q~ C^_h with each k8 step's d in the fragments' order, pre =
    core W_out + b_out, the LayerNorm backward, dcore = dpre W_out^T, the
    dC^ partial per 64-row tile, dq~ = dcore C^_h^T with e in the
    fragments' order, the softmax backward, dx_q = dq W_q^T); the fold;
    the kv path (k|v, exp(k - m), dk = ek (v dC_h^T + ds), dv = ek_h dC_h,
    dx_kv = [dk | dv] W_k|v^T); the weight gradients over 32-row stages.
    Every product in TF32 passes, each 32-deep k range apart."""
    b, n, c = x.shape
    wq, wkv = w_qkv[:, :HID], w_qkv[:, HID:]
    m, s, cmat, chat = _statistics(x, wkv, passes)
    scale = D**-0.5 / n
    idx = (torch.arange(0, D, 8)[:, None] + torch.tensor(PERM)).flatten()

    # q path
    q = mmc(x, wq, passes)
    qs = torch.softmax(q.unflatten(-1, (HEADS, D)), -1)
    core = torch.cat([mm3(qs[:, :, h, idx], chat[:, h, idx], passes)
                      for h in range(HEADS)], -1)
    pre = mmc(core, w_out, passes) + b_out
    mean = pre.mean(-1, keepdim=True)
    inv = torch.rsqrt(((pre - mean)**2).mean(-1, keepdim=True) + eps)
    xh = (pre - mean) * inv
    dxh = dy * g
    dpre = inv * (dxh - dxh.mean(-1, keepdim=True) -
                  xh * (dxh * xh).mean(-1, keepdim=True))
    dcore = mmc(dpre, w_out.T, passes)
    qsf = qs.flatten(-2)
    dchat = torch.zeros(b, HEADS, D, D)
    splits, per = K1._splits(b, n, TM)
    for sp in range(splits):  # each block's tiles in order, then the blocks
        part = torch.zeros(b, HEADS, D, D)
        for r0 in range(sp * per, min(n, (sp + 1) * per), TM):
            rows = slice(r0, r0 + TM)
            part = part + _blocks(mm3(qsf[:, rows].transpose(1, 2),
                                      dcore[:, rows], passes))
        dchat = dchat + part
    dcu = dcore.unflatten(-1, (HEADS, D))
    dqs = torch.stack([mm3(dcu[:, :, h, idx],
                           chat[:, h].transpose(1, 2)[:, idx], passes)
                       for h in range(HEADS)], 2)
    dq = (qs * (dqs - (dqs * qs).sum(-1, keepdim=True))).flatten(-2)
    dx_q = mmc(dq, wq.T, passes)

    # fold
    s4 = s.view(b, HEADS, D)
    dc = dchat * scale / s4[..., None]
    ds = (-(dchat * cmat).sum(-1) * scale / s4**2).flatten(-2)

    # kv path
    kv = mmc(x, wkv, passes)
    ek = torch.exp(kv[..., :HID] - m[:, None])
    v = kv[..., HID:]
    tk = torch.cat([mm3(v[..., h * D:(h + 1) * D], dc[:, h].transpose(1, 2),
                        passes) for h in range(HEADS)], -1)
    dk = ek * (tk + ds[:, None])
    dv = torch.cat([mm3(ek[..., h * D:(h + 1) * D], dc[:, h], passes)
                    for h in range(HEADS)], -1)
    dkv = torch.cat([dk, dv], -1)
    dx_kv = mmc(dkv, wkv.T, passes)

    rows = lambda t: t.reshape(b * n, -1)  # noqa: E731
    dw_qkv = _rows_product(rows(x), torch.cat([rows(dq), rows(dkv)], -1),
                           passes)
    dw_out = _rows_product(rows(core), rows(dpre), passes)
    return (dx_q, dx_kv, dw_qkv, dw_out, dpre.sum((0, 1)),
            (dy * xh).sum((0, 1)))


def _k3_inputs(b, n, c, seed=0):
    """K1.check_inputs (the core carries the output) and dy ~ N(0, 1), all
    drawn with numpy."""
    x, w_qkv, w_out, b_out, g = K1.check_inputs(b, n, c, torch.float32,
                                                "cpu", seed)
    rng = np.random.default_rng(seed + 1)
    dy = torch.tensor(rng.normal(size=(b, n, c)), dtype=torch.float32)
    return x, dy, w_qkv, w_out, b_out, g


def _k3_refs(args, eps):
    j = [jnp.asarray(a.numpy()) for a in args]
    pallas = JLA._pallas_fused_bwd(*j, HEADS, D, eps, interpret=True)
    _, vjp = jax.vjp(lambda *a: JLA._xla_fused(*a, HEADS, D, eps),
                     j[0], *j[2:])
    return pallas, vjp(j[1])


K3_NAMES = ("dx_q", "dx_kv", "dw_qkv", "dw_out", "db_out", "dg")


def _k3_errors(got, pallas, xla) -> dict:
    """Each output's max |got - ref| / max |ref| against the Pallas
    backward, and (dx whole, the weight gradients) against XLA's vjp."""
    errs = {f"{name}/pallas": _rel(got[i], pallas[i])
            for i, name in enumerate(K3_NAMES)}
    errs["dx/xla"] = _rel(got[0] + got[1], xla[0])
    errs.update({f"{name}/xla": _rel(got[i + 2], xla[i + 1])
                 for i, name in enumerate(K3_NAMES[2:])})
    return errs


@pytest.mark.parametrize("b,n,c", [(2, 256, 64), (1, 128, 2048)])
def test_k3_three_passes_match_pallas_and_xla(b, n, c):
    # the fp32 design against the JAX package's Pallas backward (interpret
    # mode) and XLA's vjp of _xla_fused, inside the card's 1e-4 per output
    args = _k3_inputs(b, n, c)
    got = k3_emulated(*args, 1e-5)
    errs = _k3_errors(got, *_k3_refs(args, 1e-5))
    print((b, n, c), errs)
    assert max(errs.values()) <= K3_RTOL, errs
    plain = K1.fused_linear_attention_bwd_plain(*args, eps=1e-5)
    assert max(_rel(a, p) for a, p in zip(got, plain)) <= K3_RTOL


@pytest.mark.parametrize("passes", ["single", "small_dropped"])
def test_k3_fewer_passes_miss_the_card_bound(passes):
    # one TF32 pass, or one small pass dropped (the card tests' planted
    # faults), puts some output past the card's 1e-4, an order of
    # magnitude past the three passes' own error
    args = _k3_inputs(2, 256, 64)
    pallas, xla = _k3_refs(args, 1e-5)
    three = max(_k3_errors(k3_emulated(*args, 1e-5), pallas, xla).values())
    fewer = max(_k3_errors(k3_emulated(*args, 1e-5, passes), pallas,
                           xla).values())
    print(passes, fewer, three)
    assert fewer > K3_RTOL and fewer > 10 * three, (fewer, three)
