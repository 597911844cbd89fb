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


def _core_with_fault(qkv, fault=None, rows=16):
    """K4 as the kernel computes it, with one planted fault of
    tests/test_torch_port_cuda.py, rounding to qkv.dtype where the plain
    version does. ``rows`` is the kernel's rows per kv split."""
    dt = qkv.dtype
    r = lambda t: t.to(dt).float()
    b, n, _ = qkv.shape
    q, k, v = qkv.float().split(HIDDEN, dim=-1)
    splits = -(-n // rows)
    pad = splits * rows - n
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad), value=-float("inf"))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    ks = kp.reshape(b, splits, rows, HIDDEN)
    vs = vp.reshape(b, splits, rows, HIDDEN)
    tiles = ks.reshape(b, splits, rows // 16, 16, HIDDEN)
    # running max per split after each 16-row tile
    m_tile = tiles.amax(3).cummax(2).values                  # b,s,t,d
    m_split = m_tile[:, :, -1]                               # b,s,d
    if fault == "kv_rescale_dropped":
        # each tile's rows weighed by the running max of its own time
        ek = torch.exp(tiles - m_tile[:, :, :, None]).reshape(ks.shape)
    else:
        ek = torch.exp(ks - m_split[:, :, None])
    s_split = torch.exp(ks - m_split[:, :, None]).nan_to_num(0).sum(2)
    c_split = torch.einsum("bsnd,bsne->bsde", r(ek.nan_to_num(0)), vs)
    if fault == "kv_split_dropped":
        m_split, s_split, c_split = (t[:, 1:] for t in (m_split, s_split,
                                                        c_split))
    m = m_split.amax(1, keepdim=True)
    al = torch.exp(m_split - m)
    s = (s_split * al).sum(1)
    c = (c_split * al[..., None]).sum(1)
    mask = torch.block_diag(*[torch.ones(D, D)] * HEADS)
    chat = r(c / s[..., None] * (D**-0.5 / n) * mask)
    if fault == "context_zeroed":
        chat = chat * 0.0
    if fault == "q_softmax_across_heads":
        qs = torch.softmax(q, -1)
    else:
        qs = torch.softmax(q.unflatten(-1, (HEADS, D)), -1).flatten(-2)
    return r(r(qs) @ chat).to(dt)


# The card check (chip_smoke.py, tests/test_torch_port_cuda.py) holds K4
# against its plain version on K1.check_inputs_core by max |got - ref| /
# max |ref| within these bounds; on those inputs each fault must move the
# output past the bound.
K4_CHECK_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", sorted(K4_CHECK_TOL, key=str))
@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("fault", [None, "context_zeroed", "kv_split_dropped",
                                   "kv_rescale_dropped",
                                   "q_softmax_across_heads"])
def test_k4_check_inputs_expose_faults(fault, n, dtype):
    tol = K4_CHECK_TOL[dtype]
    qkv = K1.check_inputs_core(8, n, dtype, "cpu")
    ref = K1.linear_attention_core_plain(qkv).float()
    _, rows = K1._splits(8, n, 16)
    err = _rel(_core_with_fault(qkv, fault, rows).float().numpy(),
               ref.numpy())
    if fault is None:
        assert err <= tol, err
    elif fault == "kv_rescale_dropped" and rows == 16:
        # one tile per split: nothing to rescale, the fault cannot show
        assert err <= tol, err
    else:
        assert err > 3 * tol, err
