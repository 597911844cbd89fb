"""PyTorch port, kernels' plain versions against the JAX package (CPU).

K1 (fused LinearAttention), its backward K3 and K2 (bottleneck attention)
run on the card as hand-written CUDA kernels; on a CPU tensor each wrapper
takes its plain PyTorch version, which is held here against the JAX
reference: the XLA path (and its vjp) and, for K1 and K3, the Pallas
kernels in interpret mode.
"""

import re

import jax
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


# the bounds of tests/test_linear_attention.py for the Pallas backward
BWD_ATOL = BWD_RTOL = 5e-4
BWD_NAMES = ("dx_q", "dx_kv", "dw_qkv", "dw_out", "db_out", "dg")


def _k3_inputs(c, n, b, seed=4):
    x, w_qkv, w_out, b_out, g_out = _k1_inputs(c, n, b, seed)
    dy = np.random.default_rng(seed + 1).normal(size=x.shape).astype(
        np.float32)
    return x, dy, w_qkv, w_out, b_out, g_out


# (2048, 128, 1): the widest c K3 and the Pallas backward take
@pytest.mark.parametrize("c,n,b", [(64, 256, 2), (128, 512, 1),
                                   (2048, 128, 1)])
def test_k3_plain_matches_pallas_bwd_interpret(c, n, b):
    args = _k3_inputs(c, n, b)
    ref = JLA._pallas_fused_bwd(*map(jnp.asarray, args), HEADS, D, 1e-5,
                                interpret=True)
    got = K1.fused_linear_attention_bwd(*map(torch.from_numpy, args),
                                        HEADS, D, 1e-5)
    for name, g, r in zip(BWD_NAMES, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=BWD_ATOL,
                                   rtol=BWD_RTOL, err_msg=name)


@pytest.mark.parametrize("c,n,b", [(64, 256, 2), (128, 512, 1)])
def test_k3_plain_matches_xla_vjp(c, n, b):
    x, dy, *w = _k3_inputs(c, n, b)
    _, vjp = jax.vjp(lambda *a: JLA._xla_fused(*a, HEADS, D, 1e-5),
                     *map(jnp.asarray, (x, *w)))
    dx, *dw = vjp(jnp.asarray(dy))
    got = K1.fused_linear_attention_bwd_plain(
        *map(torch.from_numpy, (x, dy, *w)), HEADS, D, 1e-5)
    np.testing.assert_allclose((got[0] + got[1]).numpy(), np.asarray(dx),
                               atol=BWD_ATOL, rtol=BWD_RTOL)
    for name, g, r in zip(BWD_NAMES[2:], got[2:], dw):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=BWD_ATOL,
                                   rtol=BWD_RTOL, err_msg=name)


def test_k1_autograd_runs_k3_and_saves_the_jax_residuals():
    x, dy, *w = map(torch.from_numpy, _k3_inputs(16, 64, 2))
    leaves = [t.clone().requires_grad_() for t in (x, *w)]
    out = K1.fused_linear_attention(*leaves, HEADS, D, 1e-5)
    assert type(out.grad_fn).__name__ == "FusedLinearAttentionFnBackward"
    # x and the four weights, never the packed qkv
    assert [tuple(t.shape) for t in out.grad_fn.saved_tensors] == \
        [tuple(t.shape) for t in leaves]
    out.backward(dy)
    want = K1.fused_linear_attention_bwd_plain(x, dy, *w, HEADS, D, 1e-5)
    torch.testing.assert_close(leaves[0].grad, want[0] + want[1])
    for leaf, g in zip(leaves[1:], want[2:]):
        torch.testing.assert_close(leaf.grad, g)


def test_k3_plain_casts_dy_and_keeps_weight_dtypes():
    x, dy, w_qkv, w_out, b_out, g_out = map(torch.from_numpy,
                                            _k3_inputs(16, 64, 2))
    grads = K1.fused_linear_attention_bwd_plain(
        x.bfloat16(), dy, w_qkv, w_out, b_out, g_out, HEADS, D, 1e-3)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 2 + \
        [torch.float32] * 4
    assert [tuple(g.shape) for g in grads[2:]] == [
        (16, 384), (128, 16), (16,), (16,)]


def test_k2_backward_matches_xla_vjp():
    rng = np.random.default_rng(6)
    q, k, v, g = (rng.normal(size=(2, 64, HEADS, D)).astype(np.float32)
                  for _ in range(4))
    _, vjp = jax.vjp(lambda *a: JA._attention_xla(*a, D**-0.5),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = K2.multihead_attention(*leaves, scale=D**-0.5)
    assert type(out.grad_fn).__name__ == "MultiheadAttentionFnBackward"
    out.backward(torch.from_numpy(g))
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r),
                                   atol=1e-5, rtol=0)


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    before = (K1.fused_linear_attention.launches,
              K1.fused_linear_attention_bwd.launches,
              K2.multihead_attention.launches)
    x, dy, *w = map(torch.from_numpy, _k3_inputs(8, 64, 2))
    x.requires_grad_()
    K1.fused_linear_attention(x, *w).backward(dy)
    q = torch.zeros((1, 16, HEADS, D), requires_grad=True)
    K2.multihead_attention(q, q, q, scale=0.5).sum().backward()
    assert (K1.fused_linear_attention.launches,
            K1.fused_linear_attention_bwd.launches,
            K2.multihead_attention.launches) == before
    assert not _build._libs  # nothing was built or loaded


# rows per tile of the kv phase: 64 in both tensor-core kernels, 16 in
# K4's CUDA-core kernel
@pytest.mark.parametrize("rows", [16, 64])
@pytest.mark.parametrize("b,n", [(8, 65536), (8, 1024), (2, 100), (1, 16)])
def test_kv_splits_cover_every_row_once(b, n, rows):
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
    k3 = K1.work_bwd(8, 65536, 64, 2)
    assert k3["bytes"] == (4 * 8 * 65536 * 64 * 2 + 4 * 128 * 64 * 2 +
                           2 * 64 * 4 + 4 * 128 * 64 * 4 + 2 * 64 * 4)
    # what the function needs per row: the q, k, v and out projections
    # once, their three transposes, the four weight gradients (1536 c
    # products), and six context products on the head blocks
    assert k3["flops"] == 2 * 8 * 65536 * (1536 * 64 + 6 * 4 * 32 * 32)
    shapes = [(65536, 64), (16384, 64), (4096, 128), (1024, 256),
              (1024, 512), (4096, 256), (16384, 128), (65536, 64)]
    total = sum(K1.work_bwd(32, n, c, 2)["flops"] for n, c in shapes)
    assert 1.63e12 < total < 1.65e12  # one training forward's backwards


def test_build_is_keyed_on_the_sources():
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert set(paths) == {"linear_attention", "linear_attention_bwd",
                          "attention", "linear_attention_core", "conv3x3",
                          "conv3_igemm", "conv3_dw", "group_norm"}
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


# The card check (tests/test_torch_port_cuda.py) holds K1 against its
# plain version on K1.check_inputs within these bounds; on those inputs
# each fault must move the output past the bound. The kv split dropped is
# the kernel's first, as laid out for a batch of 8 in tiles of the dtype's
# kernel (64 rows in both).
K1_CHECK_TOL = {torch.bfloat16: (3e-2, 1e-3), torch.float32: (1e-4, 1e-5)}
K1_TILE_ROWS = {torch.bfloat16: 64, torch.float32: 64}


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
    _, rows = K1._splits(8, n, K1_TILE_ROWS[dtype])
    err = (_k1_with_fault(args, eps, fault, rows).float() - ref).abs().max()
    if fault is None:
        assert err <= atol, err
    else:
        assert err > 3 * atol, err



def _k2_tensor_core(q, k, v, scale, fault=None, tile=64):
    """K2's bf16 kernel as it computes, emulated in torch on the CPU: per
    64-key tile S = q k^T from bf16 inputs with fp32 sums, scaled after the
    product by scale * log2 e; an online softmax with exp2; P rounded to
    bf16 before P V, the row sum from unrounded P; O / l rounded to bf16.
    ``fault`` plants one of the card tests' faults."""
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    sl2 = scale * 1.4426950408889634
    if fault == "scale_applied_twice":
        sl2 *= scale
    n = q.shape[1]
    m = torch.full(qf.shape[:-1], -torch.inf)
    l, o = torch.zeros(qf.shape[:-1]), torch.zeros(qf.shape)
    last = n - tile if fault == "last_k_tile_skipped" else n
    for t0 in range(0, last, tile):
        s = qf @ kf[:, :, t0:t0 + tile].transpose(-1, -2) * sl2
        mx = torch.maximum(m, s.amax(-1))
        al = torch.exp2(m - mx)
        if fault == "online_rescale_dropped":
            al = torch.ones_like(al)
        p = torch.exp2(s - mx[..., None])
        l = l * al + p.sum(-1)
        o = o * al[..., None] + p.bfloat16().float() @ vf[:, :, t0:t0 + tile]
        m = mx
    if fault != "row_sum_not_divided":
        o = o / l[..., None]
    return o.permute(0, 2, 1, 3).to(torch.bfloat16)


def _k2_inputs(kind, shape):
    if kind == "check":
        return K2.check_inputs(*shape, torch.bfloat16, "cpu")
    rng = np.random.default_rng(1)  # the card test's unit normals
    qkv = torch.tensor(rng.normal(size=(shape[0], shape[1], 3, *shape[2:])),
                       dtype=torch.bfloat16)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


K2_BF16_ATOL = 1e-2  # the card check's bf16 bound


@pytest.mark.parametrize("kind", ["check", "normal"])
@pytest.mark.parametrize("shape", [(8, 1024, HEADS, D), (2, 100, HEADS, D)])
def test_k2_tensor_core_numerics_match_xla(kind, shape):
    # the tensor-core design's roundings (bf16 P, bf16 output, scale after
    # the product, exp2) against the JAX reference in fp32 on the same bf16
    # inputs: the design fits the bf16 bound before any card run
    q, k, v = _k2_inputs(kind, shape)
    ref = JA._attention_xla(*(jnp.asarray(t.float().numpy())
                              for t in (q, k, v)), D**-0.5)
    got = _k2_tensor_core(q, k, v, D**-0.5)
    err = np.abs(got.float().numpy() - np.asarray(ref)).max()
    assert err <= K2_BF16_ATOL, err
    plain = K2.multihead_attention_plain(q, k, v, scale=D**-0.5)
    assert (got.float() - plain.float()).abs().max() <= K2_BF16_ATOL


@pytest.mark.parametrize("fault", ["online_rescale_dropped",
                                   "last_k_tile_skipped",
                                   "row_sum_not_divided",
                                   "scale_applied_twice"])
def test_k2_check_inputs_expose_faults(fault):
    # each fault of the card's K2 fault table that can be written in torch
    # moves the output on K2.check_inputs far past the bound
    q, k, v = K2.check_inputs(8, 1024, HEADS, D, torch.bfloat16, "cpu")
    ref = K2.multihead_attention_plain(q, k, v, scale=D**-0.5).float()
    assert ref.abs().max() < 1.0  # one bf16 step there is at most 2^-8
    err = (_k2_tensor_core(q, k, v, D**-0.5, fault).float() - ref).abs()
    assert err.max() > 3 * K2_BF16_ATOL, err.max()


def _includes(name, files):
    """``name`` and every header it includes, transitively."""
    seen, todo = set(), [name]
    while todo:
        f = todo.pop()
        if f in seen or f not in files:
            continue
        seen.add(f)
        todo += re.findall(r'#include "([^"]+)"', files[f])
    return seen


@pytest.mark.parametrize("table,source", [
    ("K1_FAULTS", "linear_attention"), ("K1_TC_FAULTS", "linear_attention"),
    ("K2_FAULTS", "attention"), ("K2_F32_FAULTS", "attention"),
    ("K3_FAULTS", "linear_attention_bwd"),
    ("K3_TC_FAULTS", "linear_attention_bwd"),
    ("K4_FAULTS", "linear_attention_core"),
    ("K4_TC_FAULTS", "linear_attention_core"), ("K5_FAULTS", "conv3x3"),
    ("K5_F32_FAULTS", "conv3x3"), ("K6_FAULTS", "conv3_igemm"),
    ("GN_FAULTS", "group_norm")])
def test_planted_fault_texts_each_sit_in_one_source(table, source):
    # the card's mutant builds patch the one file of the kernel's source and
    # the shared headers that holds each fault's text; that file must be
    # one the kernel's source compiles
    import test_torch_port_cuda as cuda_tests

    files = cuda_tests.sources(source)
    used = _includes(f"{source}.cu", files)
    for name, (old, new) in getattr(cuda_tests, table).items():
        assert old != new, name
        assert cuda_tests.fault_file(files, old) in used, name
