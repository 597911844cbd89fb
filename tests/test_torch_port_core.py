"""PyTorch port, K4 (the LinearAttention core on packed qkv) against the
JAX package (CPU).

``linear_attention_core`` runs K4, a hand-written CUDA kernel, on a CUDA
tensor; on a CPU tensor it takes ``linear_attention_core_plain``, held here
against ``_pallas_core`` in interpret mode, ``_xla_core`` in bf16 and
``jax.grad`` through the JAX op's ``custom_vjp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointreggpt_tpu.ops import linear_attention as JLA
from test_torch_port_generator import single_torch_thread  # noqa: F401
from test_torch_port_tf32x3 import mm3
from pointreggpt_tpu_torch.ops import _build
from pointreggpt_tpu_torch.ops import linear_attention as K1

HEADS, D = 4, 32
HIDDEN = HEADS * D


def _qkv(b, n, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 3 * HIDDEN)) * scale).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("n", [64, 256, 4096])
def test_core_matches_pallas_interpret(n):
    # fp32 on both sides: summation order only. The output is O(1/n), so
    # the 2e-5 bound of tests/test_linear_attention.py is taken relative to
    # max |ref| as well as per element
    qkv = _qkv(2, n, seed=n)
    ref = np.asarray(JLA._pallas_core(jnp.asarray(qkv), HEADS, D,
                                      interpret=True))
    got = K1.linear_attention_core(torch.from_numpy(qkv), HEADS, D)
    assert got.dtype == torch.float32 and got.shape == (2, n, HIDDEN)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5,
                               atol=2e-5 * np.abs(ref).max())


def test_core_plain_bf16_rounds_where_xla_does():
    # bf16 on both sides: exp(k - m), the context, the softmaxed q and the
    # output are rounded where _xla_core rounds them; fp32 sums in another
    # order flip a few roundings by one bf16 step (2^-8 relative)
    qkv = _qkv(2, 256, seed=1)
    ref = JLA._xla_core(jnp.asarray(qkv, jnp.bfloat16), HEADS, D)
    got = K1.linear_attention_core_plain(torch.from_numpy(qkv).bfloat16(),
                                         HEADS, D)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), ref.astype(jnp.float32)) <= 2**-7


def test_core_grad_matches_jax_grad():
    qkv = _qkv(2, 64, seed=2)

    def loss(a):
        return jnp.sum(JLA.linear_attention_core(a, HEADS, D)**2)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(qkv)))
    leaf = torch.from_numpy(qkv).requires_grad_()
    out = K1.linear_attention_core(leaf, HEADS, D)
    assert type(out.grad_fn).__name__ == "LinearAttentionCoreFnBackward"
    # the JAX residual, qkv, and nothing else
    assert [tuple(t.shape) for t in out.grad_fn.saved_tensors] == \
        [qkv.shape]
    (out**2).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_core_extreme_values_stay_finite():
    """All lanes 40: the running max keeps exp(k - m) from overflowing."""
    qkv = np.full((1, 64, 3 * HIDDEN), 40.0, np.float32)
    got = K1.linear_attention_core(torch.from_numpy(qkv), HEADS, D).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(JLA._xla_core(
        jnp.asarray(qkv), HEADS, D)), rtol=1e-6)


def test_core_cpu_tensor_takes_the_plain_path_and_counts_nothing():
    before = K1.linear_attention_core.launches
    qkv = torch.from_numpy(_qkv(1, 16)).requires_grad_()
    K1.linear_attention_core(qkv).sum().backward()
    assert K1.linear_attention_core.launches == before
    assert "linear_attention_core" not in _build._libs


def test_work_core_counts():
    wk = K1.work_core(8, 65536, 2)
    # packed qkv read once, the (b, n, 128) output written once
    assert wk["bytes"] == 8 * 65536 * (384 + 128) * 2
    # two context products on the four 32x32 head blocks per row
    assert wk["flops"] == 2 * 8 * 65536 * 2 * 4 * 32 * 32


# How the card splits the work, as on an H100 (132 SMs): kernel A holds 2
# blocks an SM in bf16 and 1 in fp32 (``prgpt_linear_attention_core_kv_
# slots``); kernel C's persistent grid is taken as 2 blocks an SM in both.
K4_SLOTS_A = {torch.bfloat16: 264, torch.float32: 132}
K4_SLOTS_C = 264
TM = 64  # rows per tile of both walks


def _mm(a, b, dt, passes="three"):
    """a @ b as the kernel's tensor cores take it: bf16 products exact in
    fp32, sums in fp32; fp32 in TF32 passes (``mm3``)."""
    if dt == torch.bfloat16:
        return a @ b
    return mm3(a, b, passes)


def _stale(t, first):
    """t (..., tiles, rows, lanes) with each tile replaced by the tile
    before it in its walk, and zeros where ``first`` (tiles,) marks a
    walk's first tile: what a stage holds when it is read before its item
    lands (the racing refill, which would land a later item, is not
    emulated)."""
    prev = torch.roll(t, 1, dims=-3)
    return torch.where(first[:, None, None], torch.zeros_like(t), prev)


def _core_with_fault(qkv, fault=None, passes="three"):
    """K4 as the kernel computes it, with one planted fault of
    tests/test_torch_port_cuda.py (or ``passes``, the TF32 passes of both
    fp32 products), rounding to qkv.dtype where the plain version does.

    Kernel A: each batch row's n in the splits of ``K1._core_splits`` of
    64-row tiles; per tile the running max of k, exp(k - m) against it
    (rounded to T for the product, its fp32 sum rescaled by alpha),
    C = alpha C + ek_h^T v_h with the tile's products summed apart (fp32:
    in three TF32 passes, each 32-row range in a fragment of its own).
    Kernel B: the merge with max-rescaling, C^ rounded. Kernel C: q's
    per-head softmax rounded, q C^_h (fp32: three passes, 32 deep),
    rounded."""
    dt = qkv.dtype
    r = lambda t: t.to(dt).float()
    b, n, _ = qkv.shape
    q, k, v = qkv.float().split(HIDDEN, dim=-1)
    splits, per = K1._core_splits(b, n, TM, K4_SLOTS_A[dt])
    tps = per // TM
    pad = splits * per - n
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad), value=-float("inf"))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    kt = kp.reshape(b, splits, tps, TM, HIDDEN)
    vt = vp.reshape(b, splits, tps, TM, HIDDEN)
    if fault == "stale_ring_stage":
        first = torch.arange(tps) == 0
        valid = torch.isfinite(kt)
        kt = torch.where(valid, _stale(kt.nan_to_num(0, 0, 0), first),
                         -float("inf"))
        vt = _stale(vt, first) * valid
    m = torch.full((b, splits, HIDDEN), -float("inf"))
    s = torch.zeros(b, splits, HIDDEN)
    c = torch.zeros(b, splits, HEADS, D, D)
    for t in range(tps):
        ks, vs = kt[:, :, t], vt[:, :, t]
        m_new = torch.maximum(m, ks.amax(2))
        al = torch.exp(m - m_new)
        m = m_new
        e = torch.exp(ks - m[:, :, None])
        s = s * al + e.sum(2)
        ek = r(e).unflatten(-1, (HEADS, D)).permute(0, 1, 3, 4, 2)
        vh = vs.unflatten(-1, (HEADS, D)).transpose(2, 3)
        if dt == torch.bfloat16:
            tile = ek @ vh
        else:  # each 32-row range in a fragment of its own
            tile = sum(_mm(ek[..., h:h + 32], vh[..., h:h + 32, :], dt,
                           passes) for h in (0, 32))
        if fault == "kv_rescale_dropped":
            c = c + tile
        else:
            c = c * al.unflatten(-1, (HEADS, D))[..., None] + tile
    if fault == "kv_split_dropped":
        m, s, c = m[:, 1:], s[:, 1:], c[:, 1:]
    mm = m.amax(1, keepdim=True)
    w = torch.exp(m - mm)
    s = (s * w).sum(1)
    c = (c * w.unflatten(-1, (HEADS, D))[..., None]).sum(1)
    chat = r(c * (D**-0.5 / n) * (1.0 / s.clamp_min(1e-30)).unflatten(
        -1, (HEADS, D))[..., None])                             # b,h,d,e
    if fault == "context_zeroed":
        chat = chat * 0.0

    if fault == "swizzle_mismatch":  # q's chunks written unswizzled
        lanes = 16 // qkv.element_size()
        j = torch.arange(HIDDEN // lanes)
        rows = torch.arange(n)[:, None]
        src = (j[None] ^ (rows % TM & 7)) * lanes
        q = q.gather(-1, (src[..., None] + torch.arange(lanes)).flatten(1)
                     .expand(b, n, HIDDEN))
    if fault == "stale_ring_stage":
        row_tiles = -(-n // TM)
        tiles = b * row_tiles
        walk = -(-tiles // K4_SLOTS_C)
        qt = torch.nn.functional.pad(q, (0, 0, 0, row_tiles * TM - n))
        qt = qt.reshape(1, tiles, TM, HIDDEN)
        qt = _stale(qt, torch.arange(tiles) % walk == 0)
        q = qt.reshape(b, row_tiles * TM, HIDDEN)[:, :n]
    group = 2 * D if fault == "q_softmax_across_heads" else D
    qs = r(torch.softmax(q.unflatten(-1, (-1, group)), -1).flatten(-2))
    qh = qs.unflatten(-1, (HEADS, D)).transpose(1, 2)           # b,h,n,d
    out = _mm(qh, chat, dt, passes).transpose(1, 2).flatten(-2)
    return r(out).to(dt)


# The card check (chip_smoke.py, tests/test_torch_port_cuda.py) holds K4
# against its plain version on K1.check_inputs_core by max |got - ref| /
# max |ref| within these bounds; on those inputs each fault must move the
# output past the bound.
K4_CHECK_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", sorted(K4_CHECK_TOL, key=str))
@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("fault", [None, "context_zeroed", "kv_split_dropped",
                                   "kv_rescale_dropped",
                                   "q_softmax_across_heads",
                                   "stale_ring_stage", "swizzle_mismatch"])
def test_k4_check_inputs_expose_faults(fault, n, dtype):
    tol = K4_CHECK_TOL[dtype]
    qkv = K1.check_inputs_core(8, n, dtype, "cpu")
    ref = K1.linear_attention_core_plain(qkv).float()
    _, rows = K1._core_splits(8, n, TM, K4_SLOTS_A[dtype])
    err = _rel(_core_with_fault(qkv, fault).float().numpy(), ref.numpy())
    if fault is None:
        assert err <= tol, err
    elif fault == "kv_rescale_dropped" and rows == TM:
        # one tile per split: nothing to rescale, the fault cannot show
        assert err <= tol, err
    else:
        assert err > 3 * tol, err


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("passes", ["b_lo_dropped", "single"])
def test_k4_fp32_check_inputs_expose_fewer_tf32_passes(passes, n):
    # the card table's TF32 faults (the passes in common.cuh), in both fp32
    # products: the small pass a_hi b_lo dropped, or a single pass. (The
    # other small pass, a_lo b_hi, K1's and K2's fault, moves K4's output
    # by only 2.4-2.6e-4 at every n, under 3x the gate.)
    tol = K4_CHECK_TOL[torch.float32]
    qkv = K1.check_inputs_core(8, n, torch.float32, "cpu")
    ref = K1.linear_attention_core_plain(qkv)
    err = _rel(_core_with_fault(qkv, passes=passes).numpy(), ref.numpy())
    assert err > 3 * tol, err


@pytest.mark.parametrize("dtype", sorted(K4_CHECK_TOL, key=str))
@pytest.mark.parametrize("n", [1000, 4096])
def test_k4_emulation_matches_pallas_and_xla(n, dtype):
    """The new design's numerics against the TPU kernel (interpret mode)
    and _xla_core, the JAX reference of the plain version.

    fp32: summation order and the three-pass TF32 products (about 21 bits
    of each) -> 1e-5 relative to max |ref|. bf16: _xla_core rounds where
    the kernel does, but exp(k - m) is taken against the split's running
    max (the kernel) or the global one (_xla_core), so its bf16 roundings
    differ, and a few values land a bf16 step (2^-8) apart -> 2^-6 against
    _xla_core; _pallas_core keeps every intermediate in fp32, so against it
    the kernel's bf16 roundings of exp(k - m), C^, q's softmax and the
    output add up -> 3e-2, the card's bf16 gate.
    """
    qkv = K1.check_inputs_core(8, n, dtype, "cpu")
    got = _core_with_fault(qkv).float().numpy()
    jq = jnp.asarray(qkv.float().numpy(), jnp.float32 if
                     dtype == torch.float32 else jnp.bfloat16)
    xla = np.asarray(JLA._xla_core(jq, HEADS, D).astype(jnp.float32))
    pallas = np.asarray(JLA._pallas_core(jq, HEADS, D, interpret=True)
                        .astype(jnp.float32))
    if dtype == torch.float32:
        assert _rel(got, xla) <= 1e-5
        assert _rel(got, pallas) <= 1e-5
    else:
        assert _rel(got, xla) <= 2**-6
        assert _rel(got, pallas) <= 3e-2


def test_core_splits_fill_the_card_in_one_wave():
    # kernel A's blocks fit the card at once: b * splits <= slots, every
    # split a whole number of 64-row tiles, none empty
    for slots in K4_SLOTS_A.values():
        for b, n in [(8, 65536), (8, 1024), (3, 1000), (1, 1), (300, 70),
                     (5, 4097)]:
            splits, per = K1._core_splits(b, n, TM, slots)
            assert per % TM == 0 and (splits - 1) * per < n <= splits * per
            assert b * splits <= max(slots, b)
    assert K1._core_splits(8, 65536, TM, 264) == (32, 2048)
    assert K1._core_splits(8, 65536, TM, 132) == (16, 4096)
