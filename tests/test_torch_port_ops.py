"""PyTorch port, kernels' plain versions against the JAX package (CPU).

K1 (fused LinearAttention) and K2 (bottleneck attention) run on the card
as hand-written CUDA kernels; on a CPU tensor each wrapper takes its plain
PyTorch version, which is held here against the JAX reference: the XLA
path and, for K1, the Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointreggpt_tpu.ops import attention as JA
from pointreggpt_tpu.ops import linear_attention as JLA
from test_torch_port_generator import single_torch_thread  # noqa: F401
from pointreggpt_tpu_torch.ops import _build
from pointreggpt_tpu_torch.ops import attention as K2
from pointreggpt_tpu_torch.ops import linear_attention as K1

HEADS, D = 4, 32

# fp32 on both sides: differences are summation order only
ATOL, RTOL = 2e-5, 2e-5


def _k1_inputs(c, n, b=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    w_qkv = (rng.normal(size=(c, 3 * HEADS * D)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(HEADS * D, c)) * 0.1).astype(np.float32)
    b_out = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    g_out = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    return x, w_qkv, w_out, b_out, g_out


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("n", [64, 256])
def test_k1_plain_matches_xla_fused(c, n):
    args = _k1_inputs(c, n)
    ref = JLA._xla_fused(*map(jnp.asarray, args), HEADS, D, 1e-5)
    got = K1.fused_linear_attention_plain(*map(torch.from_numpy, args),
                                          HEADS, D, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("n", [64, 256])
def test_k1_plain_matches_pallas_interpret(c, n):
    args = _k1_inputs(c, n, b=1, seed=1)
    ref = JLA._pallas_fused(*map(jnp.asarray, args), HEADS, D, 1e-5,
                            interpret=True)
    got = K1.fused_linear_attention(*map(torch.from_numpy, args),
                                    HEADS, D, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_k1_plain_bf16_rounds_where_xla_does():
    # bf16 on both sides: the plain version rounds qkv, exp(k - m), the
    # context, softmaxed q, core and output where _xla_fused does; one
    # bf16 step of the O(1) LayerNorm output (2^-7) bounds what remains
    args = _k1_inputs(16, 256, seed=2)
    ref = JLA._xla_fused(jnp.asarray(args[0], jnp.bfloat16),
                         *map(jnp.asarray, args[1:]), HEADS, D, 1e-3)
    got = K1.fused_linear_attention_plain(
        torch.from_numpy(args[0]).bfloat16(),
        *map(torch.from_numpy, args[1:]), HEADS, D, 1e-3)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2**-6, rtol=0)


@pytest.mark.parametrize("n", [16, 64])
def test_k2_plain_matches_xla(n):
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, n, HEADS, D)).astype(np.float32)
               for _ in range(3))
    ref = JA.multihead_attention(*map(jnp.asarray, (q, k, v)),
                                 scale=D**-0.5)
    got = K2.multihead_attention(*map(torch.from_numpy, (q, k, v)),
                                 scale=D**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    before = (K1.fused_linear_attention.launches,
              K2.multihead_attention.launches)
    args = _k1_inputs(8, 64)
    K1.fused_linear_attention(*map(torch.from_numpy, args))
    q = torch.zeros((1, 16, HEADS, D))
    K2.multihead_attention(q, q, q, scale=0.5)
    assert (K1.fused_linear_attention.launches,
            K2.multihead_attention.launches) == before
    assert not _build._libs  # nothing was built or loaded


@pytest.mark.parametrize("b,n", [(8, 65536), (8, 1024), (2, 100), (1, 16)])
def test_kv_splits_cover_every_row_once(b, n):
    rows = 16
    splits, per = K1._splits(b, n, rows)
    assert per % rows == 0 and splits >= 1
    assert (splits - 1) * per < n <= splits * per
    if n == 65536:
        assert b * splits >= 2 * 132  # fills the card in the kv phase


def test_work_counts():
    k1 = K1.work(8, 65536, 64, 2)
    assert k1["bytes"] == 2 * 8 * 65536 * 64 * 2 + 4 * 128 * 64 * 2 + 2 * 64 * 4
    # projections, then the two context products on the four 32x32 head
    # blocks only (the rest of C is masked away)
    assert k1["flops"] == 2 * 8 * 65536 * (4 * 128 * 64 + 2 * 4 * 32 * 32)
    assert K2.work(8, 1024, 4, 32, 2)["flops"] == 4 * 8 * 4 * 1024**2 * 32


def test_build_is_keyed_on_the_sources():
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert set(paths) == {"linear_attention", "attention"}
    for n, p in paths.items():
        assert p.parent == _build.BUILD_DIR
        assert p.name.startswith(n + "-") and p.suffix == ".so"
        assert (_build.CSRC / f"{n}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS


def _k1_with_fault(args, eps, fault=None, dropped_rows=0):
    """K1 as the kernel computes it with one planted fault (the faults of
    tests/test_torch_port_cuda.py), rounding to the model dtype where the
    plain version does."""
    x, w_qkv, w_out, b_out, g = args
    r = lambda t: t.to(x.dtype).float()
    q, k, v = r(x.float() @ r(w_qkv)).split(HEADS * D, dim=-1)
    if fault == "kv_split_dropped":
        k, v = k[:, dropped_rows:], v[:, dropped_rows:]
    ek = torch.exp(k - k.amax(1, keepdim=True))
    ctx = torch.einsum("bnd,bne->bde", r(ek), v) / ek.sum(1)[..., None]
    ctx = ctx * torch.block_diag(*[torch.ones(D, D)] * HEADS) * (
        D**-0.5 / x.shape[1])
    if fault == "context_zeroed":
        ctx = ctx * 0.0
    qh = q.unflatten(-1, (HEADS, D))
    if fault == "q_softmax_across_heads":
        qs = torch.softmax(q, -1)
    elif fault == "q_softmax_unnormalised":
        qs = torch.exp(qh - qh.amax(-1, keepdim=True)).flatten(-2)
    else:
        qs = torch.softmax(qh, -1).flatten(-2)
    y = r(r(r(qs) @ r(ctx)) @ r(w_out))
    if fault != "bias_dropped":
        y = r(y + r(b_out))
    mean, var = y.mean(-1, keepdim=True), y.var(-1, unbiased=False,
                                                 keepdim=True)
    return ((y - mean) * torch.rsqrt(var + eps) * g).to(x.dtype)


# The card check (chip_smoke.py, tests/test_torch_port_cuda.py) holds K1
# against its plain version on K1.check_inputs within these bounds; on
# those inputs each fault must move the output past the bound. The kv
# split dropped is the kernel's first, as laid out for a batch of 8.
K1_CHECK_TOL = {torch.bfloat16: (3e-2, 1e-3), torch.float32: (1e-3, 1e-5)}


@pytest.mark.parametrize("dtype", sorted(K1_CHECK_TOL, key=str))
@pytest.mark.parametrize("n,c", [(1024, 256), (4096, 64)])
@pytest.mark.parametrize("fault", [None, "context_zeroed", "kv_split_dropped",
                                   "q_softmax_across_heads",
                                   "q_softmax_unnormalised", "bias_dropped"])
def test_k1_check_inputs_expose_faults(fault, n, c, dtype):
    atol, eps = K1_CHECK_TOL[dtype]
    args = K1.check_inputs(8, n, c, dtype, "cpu")
    ref = K1.fused_linear_attention_plain(*args, eps=eps).float()
    assert ref.abs().max() < 2.0  # an O(1) output, where the bound holds
    _, rows = K1._splits(8, n, 16)
    err = (_k1_with_fault(args, eps, fault, rows).float() - ref).abs().max()
    if fault is None:
        assert err <= atol, err
    else:
        assert err > 3 * atol, err

