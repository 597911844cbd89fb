"""Hand-written kernels of the PyTorch port against their plain versions,
on the card (``-m cuda``), and gradients through them in a training step;
they skip without a card.

Run on a machine with an H100:  python -m pytest tests/test_torch_port_cuda.py
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from pointreggpt_tpu_torch.models import DiffusionUNet
from pointreggpt_tpu_torch.models.blocks import PreNormResidual
from pointreggpt_tpu_torch.ops import _build
from pointreggpt_tpu_torch.ops import attention as K2
from pointreggpt_tpu_torch.ops import conv as KC
from pointreggpt_tpu_torch.ops import linear_attention as K1

pytestmark = pytest.mark.cuda

# (n, c) of the eight LinearAttention calls of a dim-64 U-Net at 256^2
K1_SHAPES = [(65536, 64), (16384, 64), (4096, 128), (1024, 256),
             (1024, 512), (4096, 256), (16384, 128), (65536, 64)]
# LayerNorm output is O(1) (inside (-2, 2) on K1.check_inputs): bf16 keeps
# 8 mantissa bits, and a few values round one or two bf16 steps (2^-7
# each) apart where the kernel's fp32 sums run in another order -> 3e-2
# absolute. fp32: the three-pass TF32 products keep about 21 bits, a few
# 1e-6 on these inputs (tests/test_torch_port_tf32x3.py emulates them),
# where a single TF32 pass, or one of the two small passes dropped, is
# about 1e-3 off -> 1e-4 absolute.
K1_TOL = [(torch.bfloat16, 3e-2, 1e-3), (torch.float32, 1e-4, 1e-5)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda")


def _k1_err(device, dtype, eps, n, c):
    args = K1.check_inputs(8, n, c, dtype, device)
    out = K1.fused_linear_attention(*args, eps=eps)
    ref = K1.fused_linear_attention_plain(*args, eps=eps)
    assert out.dtype == dtype and out.shape == ref.shape
    return (out.float() - ref.float()).abs().max().item()


# (n, c) of up_0's LinearAttention in a dim-256 U-Net at 256^2: the widest
# c, 2048, the TPU kernels' own limit
WIDE = (1024, 2048)


@pytest.mark.parametrize("dtype,atol,eps", K1_TOL)
@pytest.mark.parametrize("n,c", [(256, 64), (1000, 72)] +
                         sorted(set(K1_SHAPES)) + [WIDE])
def test_linear_attention_kernel_matches_plain(cuda, dtype, atol, eps, n, c):
    before = K1.fused_linear_attention.launches
    err = _k1_err(cuda, dtype, eps, n, c)
    assert K1.fused_linear_attention.launches == before + 1
    assert err <= atol, err


# Faults planted in copies of csrc/linear_attention.cu and its headers:
# (text, replacement). The check above must fail for each of them at the
# production shapes.
#
# The three-pass split in common.cuh, shared by K1's and K2's fp32 bodies:
# one of the two small passes dropped, and both (a single TF32 pass).
_SMALL_PASSES = ("  mma1688_tf32(c, a_lo, b_hi[0], b_hi[1]);\n"
                 "  mma1688_tf32(c, a_hi, b_lo[0], b_lo[1]);\n")
TF32_FAULTS = {
    "small_pass_dropped": (_SMALL_PASSES, _SMALL_PASSES.splitlines(True)[1]),
    "single_pass": (_SMALL_PASSES, ""),
}
# fp32: the three-pass TF32 bodies (linear_attention_tf32.cuh) and the
# split: a kv split's partial dropped (merged as empty), C's rescale by
# alpha dropped, C^ zeroed where it is staged, q's softmax taken over the
# warp's two heads, the bias dropped, x's chunks written unswizzled while
# ldmatrix reads them swizzled, C^'s rows read in their own order instead
# of the softmax fragments' permuted one, and TF32_FAULTS
K1_FAULTS = {
    "kv_split_dropped": ("pf[tid] = m_s[tid];",
                         "pf[tid] = split == 0 ? -INFINITY : m_s[tid];"),
    "kv_rescale_dropped": (
        "cacc[j][e] = fmaf(cacc[j][e], e < 2 ? al0 : al1, tcc[j][e]);",
        "cacc[j][e] = cacc[j][e] + tcc[j][e];"),
    "context_zeroed": ("= chb[idx];", "= 0.f * chb[idx];"),
    "q_softmax_across_heads": ("const int jb0 = 4 * hh, jb1 = jb0 + 4;",
                               "const int jb0 = 0, jb1 = 8;"),
    "bias_dropped": (
        "const float b0 = bout[col], b1 = two ? bout[col + 1] : 0.f;",
        "const float b0 = 0.f, b1 = 0.f;"),
    "swizzle_mismatch": ("cp16(dst + swz(r, j, KCH * 4),",
                         "cp16(dst + r * KCH * 4 + (j << 4),"),
    "context_rows_unpermuted": (
        "const int d0 = kd * 8 + 2 * t4, d1 = d0 + 1;",
        "const int d0 = kd * 8 + t4, d1 = d0 + 4;"),
    **TF32_FAULTS,
}


# bf16: the tensor-core bodies (linear_attention_tc.cuh): a kv split's
# partial dropped (merged as empty), C's rescale by alpha dropped, C^
# zeroed where it is staged, q's softmax taken over the warp's two heads,
# the bias dropped, and x's chunks written unswizzled while ldmatrix reads
# them swizzled
K1_TC_FAULTS = {
    "kv_split_dropped": ("po[tid] = m_s[tid];",
                         "po[tid] = split == 0 ? -INFINITY : m_s[tid];"),
    "kv_rescale_dropped": ("cacc[j][e] *= e < 2 ? a0 : a1;",
                           "cacc[j][e] *= 1.f;"),
    "context_zeroed": ("__float2bfloat16_rn(chat[",
                       "__float2bfloat16_rn(0.f * chat["),
    "q_softmax_across_heads": ("const int nb0 = 4 * hh, nb1 = nb0 + 4;",
                               "const int nb0 = 0, nb1 = 8;"),
    "bias_dropped": ("make_float2(rnd16(bout[col]), rnd16(bout[col + 1]))",
                     "make_float2(0.f, 0.f)"),
    "swizzle_mismatch": ("cp16(dst + swz(r, j, KCH * 2),",
                         "cp16(dst + r * KCH * 2 + (j << 4),"),
}
# (dtype, fault): the faults of each dtype's kernel bodies
K1_DTYPE_FAULTS = {torch.float32: K1_FAULTS, torch.bfloat16: K1_TC_FAULTS}


def sources(source):
    """Name -> text of ``source``.cu and every shared header."""
    return {p.name: p.read_text()
            for p in [_build.CSRC / f"{source}.cu",
                      *sorted(_build.CSRC.glob("*.cuh"))]}


def fault_file(files, old):
    """The one file of ``files`` that holds a fault's text."""
    hits = [f for f, text in files.items() if old in text]
    assert len(hits) == 1, (old, hits)
    return hits[0]


def build_mutants(root, source, faults, bind):
    """One library per planted fault, built in parallel: each fault's
    (text, replacement) is applied to whichever of ``source``.cu and the
    shared headers holds the text, in a directory of its own."""
    files = sources(source)
    procs = {}
    for name, (old, new) in faults.items():
        hit = fault_file(files, old)
        d = root / name
        d.mkdir()
        for f, text in files.items():
            (d / f).write_text(text.replace(old, new) if f == hit else text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, "-o", str(d / "lib.so"),
             str(d / f"{source}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out
    return {name: bind(ctypes.CDLL(str(root / name / "lib.so")))
            for name in faults}


@pytest.fixture(scope="module")
def k1_mutants(cuda, tmp_path_factory):
    root = tmp_path_factory.mktemp("k1_mutants")
    mutants = {}
    for dtype, faults in K1_DTYPE_FAULTS.items():
        d = root / str(dtype).split(".")[-1]
        d.mkdir()
        mutants[dtype] = build_mutants(d, "linear_attention", faults, K1.bind)
    return mutants


@pytest.mark.parametrize("dtype,atol,eps,fault", [
    (dtype, atol, eps, fault) for dtype, atol, eps in K1_TOL
    for fault in sorted(K1_DTYPE_FAULTS[dtype])])
def test_linear_attention_check_sees_planted_fault(cuda, k1_mutants,
                                                   monkeypatch, fault, dtype,
                                                   atol, eps):
    monkeypatch.setattr(K1, "_lib", lambda: k1_mutants[dtype][fault])
    errs = {(n, c): _k1_err(cuda, dtype, eps, n, c)
            for n, c in sorted(set(K1_SHAPES))}
    print(fault, dtype, errs)
    assert max(errs.values()) > atol, errs


K2_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# the bounds of chip_smoke.py's K2 check, which each planted fault must
# exceed (fp32: a single TF32 pass is about 1.5e-3 off on K2.check_inputs)
K2_GATE = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def _k2_err(device, dtype, b, n, kind="check", cache=None):
    key = (dtype, b, n, kind)
    if cache is not None and key in cache:
        (q, k, v), ref = cache[key]
    else:
        if kind == "check":  # a peaked softmax (see K2.check_inputs)
            q, k, v = K2.check_inputs(b, n, 4, 32, dtype, device)
        else:
            rng = np.random.default_rng(1)
            qkv = torch.tensor(rng.normal(size=(b, n, 3, 4, 32)),
                               dtype=dtype, device=device)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        ref = K2.multihead_attention_plain(q, k, v, scale=32**-0.5)
        if cache is not None:
            cache[key] = (q, k, v), ref
    out = K2.multihead_attention(q, k, v, scale=32**-0.5)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    return (out.float() - ref.float()).abs().max().item()


@pytest.mark.parametrize("dtype", sorted(K2_TOL, key=str))
@pytest.mark.parametrize("b,n,kind", [(8, 1024, "normal"), (8, 100, "normal"),
                                      (8, 1024, "check"), (32, 1024, "check"),
                                      (8, 100, "check"), (3, 1, "check"),
                                      (2, 65, "check")])
def test_attention_kernel_matches_plain(cuda, dtype, b, n, kind):
    before = K2.multihead_attention.launches
    err = _k2_err(cuda, dtype, b, n, kind)
    assert K2.multihead_attention.launches == before + 1
    assert err <= K2_TOL[dtype], err


# Faults planted in a copy of csrc/attention.cu; the kernel's check must
# fail on each at the production shapes. bf16: the tensor-core kernel
# flash_fwd_tc.
K2_FAULTS = {
    "online_rescale_dropped": ("al[r] = exp2f(m[r] - mx[r]);",
                               "al[r] = 1.f;"),
    "last_k_tile_skipped": ("for (int t = 0; t < tiles; ++t) {",
                            "for (int t = 0; t < tiles - 1; ++t) {"),
    "row_sum_not_divided": ("inv[r] = 1.f / l[r];", "inv[r] = 1.f;"),
    "scale_applied_twice": (
        "const float sl2 = scale * 1.4426950408889634f;",
        "const float sl2 = scale * scale * 1.4426950408889634f;"),
    "swizzle_mismatch": ("cp16(dst + swz64(r, j),",
                         "cp16(dst + r * ROW_B + (j << 4),"),
}


# fp32: the three-pass TF32 kernel flash_fwd_tf32x3: the online rescale
# dropped, V's rows read in their own order instead of P's permuted one,
# the scale applied to q twice, the staged chunks written unswizzled while
# ldmatrix reads them swizzled, and TF32_FAULTS
K2_F32_FAULTS = {
    "online_rescale_dropped": ("alpha[r] = exp2f(m[r] - mx[r]);",
                               "alpha[r] = 1.f;"),
    "v_rows_unpermuted": ("const int k0 = jb * 8 + 2 * t4, k1 = k0 + 1;",
                          "const int k0 = jb * 8 + t4, k1 = k0 + 4;"),
    "scale_applied_twice": ("__uint_as_float(qh[kk][e]) * scale)",
                            "__uint_as_float(qh[kk][e]) * scale * scale)"),
    "swizzle_mismatch": ("cp16(dst + swz128(r, j),",
                         "cp16(dst + r * F_ROW + (j << 4),"),
    **TF32_FAULTS,
}
K2_DTYPE_FAULTS = {torch.bfloat16: K2_FAULTS, torch.float32: K2_F32_FAULTS}


@pytest.fixture(scope="module")
def k2_mutants(cuda, tmp_path_factory):
    root = tmp_path_factory.mktemp("k2_mutants")
    mutants = {}
    for dtype, faults in K2_DTYPE_FAULTS.items():
        d = root / str(dtype).split(".")[-1]
        d.mkdir()
        mutants[dtype] = build_mutants(d, "attention", faults, K2.bind)
    return mutants


@pytest.fixture(scope="module")
def k2_refs():
    return {}


@pytest.mark.parametrize("dtype,fault", [
    (dtype, fault) for dtype in sorted(K2_DTYPE_FAULTS, key=str)
    for fault in sorted(K2_DTYPE_FAULTS[dtype])])
def test_attention_check_sees_planted_fault(cuda, k2_mutants, k2_refs,
                                            monkeypatch, dtype, fault):
    monkeypatch.setattr(K2, "_lib", lambda: k2_mutants[dtype][fault])
    errs = {b: _k2_err(cuda, dtype, b, 1024, cache=k2_refs)
            for b in (8, 32)}
    print(fault, dtype, errs)
    assert _check_fails(errs, K2_GATE[dtype]), errs


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros((1, 16, 8), dtype=torch.float16, device=cuda)
    w = torch.zeros((8, 384), device=cuda)
    with pytest.raises(ValueError):
        K1.fused_linear_attention(x, w, torch.zeros((128, 8), device=cuda),
                                  torch.zeros(8, device=cuda),
                                  torch.ones(8, device=cuda))
    q = torch.zeros((1, 16, 4, 16), device=cuda)
    with pytest.raises(ValueError):
        K2.multihead_attention(q, q, q, scale=0.25)  # dim_head 16
    # the bf16 tensor-core kernels stage 16-byte chunks: K1 and K3 need
    # 16-byte aligned tensors (c % 8 != 0 is routed, not refused), K2
    # 16-byte aligned rows
    x = torch.zeros(1 + 16 * 16, dtype=torch.bfloat16,
                    device=cuda)[1:].view(1, 16, 16)
    w = (torch.zeros((16, 384), device=cuda),
         torch.zeros((128, 16), device=cuda), torch.zeros(16, device=cuda),
         torch.ones(16, device=cuda))
    with pytest.raises(ValueError):
        K1.fused_linear_attention(x, *w)
    with pytest.raises(ValueError):
        K1.fused_linear_attention_bwd(x, x, *w)
    q = torch.zeros(1 + 16 * 4 * 32, dtype=torch.bfloat16,
                    device=cuda)[1:].view(1, 16, 4, 32)
    with pytest.raises(ValueError):
        K2.multihead_attention(q, q, q, scale=0.25)
    # the fp32 kernel stages 16-byte chunks too: rows 4 bytes off raise
    qf = torch.zeros(1 + 16 * 4 * 32, device=cuda)[1:].view(1, 16, 4, 32)
    with pytest.raises(ValueError):
        K2.multihead_attention(qf, qf, qf, scale=0.25)


# K3 against its plain version: max |got - ref| / max |ref| per output, on
# K1.check_inputs_bwd (the core carries the output, dy ~ N(0, 1)). bf16:
# the kernel rounds where the plain version does, but its fp32 sums run in
# another order, so a few values land one or two bf16 steps (2^-8
# relative) apart, and those steps feed later products; fp32: sum order.
K3_TOL = {torch.bfloat16: (3e-2, 1e-3, 32), torch.float32: (1e-4, 1e-5, 8)}


def _k3_errs(device, dtype, n, c, batch, cache=None):
    atol, eps, _ = K3_TOL[dtype]
    key = (dtype, n, c, batch)
    if cache is not None and key in cache:
        args, ref = cache[key]
    else:
        args = K1.check_inputs_bwd(batch, n, c, dtype, device)
        ref = K1.fused_linear_attention_bwd_plain(*args, eps=eps)
        if cache is not None:
            cache[key] = args, ref
    got = K1.fused_linear_attention_bwd(*args, eps=eps)
    torch.cuda.synchronize()
    return [((a.float() - r.float()).abs().max() / r.float().abs().max())
            .item() for a, r in zip(got, ref)]


def _worst(errs) -> float:
    """The largest error, NaN if any is NaN (Python's max skips a NaN that
    is not first)."""
    return float(np.max(errs))


@pytest.mark.parametrize("dtype", sorted(K3_TOL, key=str))
@pytest.mark.parametrize("n,c", [(256, 64), (1000, 72), (300, 520)] +
                         sorted(set(K1_SHAPES)) + [WIDE])
def test_linear_attention_bwd_kernel_matches_plain(cuda, dtype, n, c):
    atol, _, batch = K3_TOL[dtype]
    before = K1.fused_linear_attention_bwd.launches
    errs = _k3_errs(cuda, dtype, n, c, batch if n * c >= 65536 else 3)
    assert K1.fused_linear_attention_bwd.launches == before + 1
    assert _worst(errs) <= atol, errs


@pytest.mark.parametrize("dtype", sorted(K3_TOL, key=str))
@pytest.mark.parametrize("n,c", [(4096, 128), WIDE])
def test_linear_attention_bwd_is_deterministic(cuda, dtype, n, c):
    args = K1.check_inputs_bwd(8, n, c, dtype, cuda)
    a = K1.fused_linear_attention_bwd(*args, eps=1e-3)
    b = K1.fused_linear_attention_bwd(*args, eps=1e-3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# Faults planted in a copy of csrc/linear_attention_bwd.cu and its headers;
# the K3 check must fail on each at the production shapes. fp32: the
# three-pass TF32 bodies (linear_attention_bwd_tf32.cuh): ds dropped from
# dk; each block's dC^ partial keeping its first row tile only; the
# LayerNorm backward's mean term dropped; the softmax-q backward summed
# over the warp's two heads; a streamed W_k|v chunk skipped (c > 128: the
# chunk of two items before is used); the staged chunks written
# unswizzled while ldmatrix and the 32-bit loads read them swizzled; the
# last row of each weight-gradient stage dropped; the fixed-order sum of
# the weight-gradient partials (reduce_partials, shared with bf16) skipping
# its first partial; and TF32_FAULTS (the split in common.cuh)
K3_FAULTS = {
    "ds_dropped": ("o *= t[mi][j][e] + ds_s[",
                   "o *= t[mi][j][e] + 0.f * ds_s["),
    "dchat_one_tile": (
        "for (int e = 0; e < 4; ++e) dch[j][e] += tcc[j][e];",
        "for (int e = 0; e < 4; ++e) dch[j][e] += r0 == r_begin ? "
        "tcc[j][e] : 0.f;"),
    "ln_mean_term_dropped": ("(dyv[u] * gj - (st[2] + xh * st[3]))",
                             "(dyv[u] * gj - (xh * st[3]))"),
    "q_softmax_bwd_across_heads": ("const int s0 = 4 * hh, s1 = s0 + 4;",
                                   "const int s0 = 0, s1 = 8;"),
    "weight_chunk_skipped": (
        "load_tile<2 * HID>(s + X_BYTES, wqkv, QKV, k * KCH, KCH, c, HID,",
        "if (k != 1) load_tile<2 * HID>(s + X_BYTES, wqkv, QKV, k * KCH, "
        "KCH, c, HID,"),
    "swizzle_mismatch": ("cp16(dst + swk(r, j, NC * 4),",
                         "cp16(dst + r * NC * 4 + (j << 4),"),
    "wgrad_row_dropped": (
        "load_tile<WG_Q>(st + WG_A, b, Q, k0, WG_K, r_end, q0, Q, vec);",
        "load_tile<WG_Q>(st + WG_A, b, Q, k0, WG_K, k0 + WG_K - 1 < r_end "
        "? k0 + WG_K - 1 : r_end, q0, Q, vec);"),
    "wgrad_split_dropped": ("for (int s = 0; s < count; ++s)",
                            "for (int s = 1; s < count; ++s)"),
    **TF32_FAULTS,
}


# bf16: the tensor-core bodies (linear_attention_bwd_tc.cuh): one block's
# dC^ partial dropped; the LayerNorm backward's mean term dropped; the
# softmax-q backward summed over the warp's two heads; ds dropped from dk;
# a streamed W_k|v chunk skipped (c > 256: the chunk of the stage before is
# used); the output tile read unswizzled while the products write it
# swizzled; a weight-gradient stage's first row dropped
K3_TC_FAULTS = {
    "dchat_block_dropped": (
        "make_float2(dch[j][2 * h], dch[j][2 * h + 1])",
        "split == 0 ? make_float2(0.f, 0.f) : "
        "make_float2(dch[j][2 * h], dch[j][2 * h + 1])"),
    "ln_mean_term_dropped": ("dyv * gj - st[2] - xh * st[3]",
                             "dyv * gj - xh * st[3]"),
    "q_softmax_bwd_across_heads": ("const int f0 = 4 * hh, f1 = f0 + 4;",
                                   "const int f0 = 0, f1 = 8;"),
    "ds_dropped": ("(rnd16(t[mi][j][e]) + ds_s[col])",
                   "(rnd16(t[mi][j][e]) + 0.f * ds_s[col])"),
    "weight_chunk_skipped": (
        "load_w<2 * HID>(s + X_BYTES, wqkv, QKV, k * KCH, KCH, c, HID, QKV);",
        "if (k != 1) load_w<2 * HID>(s + X_BYTES, wqkv, QKV, k * KCH, KCH, "
        "c, HID, QKV);"),
    "swizzle_mismatch": (
        "*reinterpret_cast<const uint4*>(ost + swz(r, j, KCH * 2));",
        "*reinterpret_cast<const uint4*>(ost + r * KCH * 2 + (j << 4));"),
    "wgrad_row_dropped": ("const bool in = k0 + r < r_end && col < P;",
                          "const bool in = k0 + r < r_end && col < P && "
                          "r != 0;"),
}
K3_DTYPE_FAULTS = {torch.float32: K3_FAULTS, torch.bfloat16: K3_TC_FAULTS}


@pytest.fixture(scope="module")
def k3_mutants(cuda, tmp_path_factory):
    root = tmp_path_factory.mktemp("k3_mutants")
    mutants = {}
    for dtype, faults in K3_DTYPE_FAULTS.items():
        d = root / str(dtype).split(".")[-1]
        d.mkdir()
        mutants[dtype] = build_mutants(d, "linear_attention_bwd", faults,
                                       K1.bind_bwd)
    return mutants


@pytest.fixture(scope="module")
def k3_refs():
    return {}


@pytest.mark.parametrize("dtype,fault", [
    (dtype, fault) for dtype in sorted(K3_TOL, key=str)
    for fault in sorted(K3_DTYPE_FAULTS[dtype])])
def test_linear_attention_bwd_check_sees_planted_fault(cuda, k3_mutants,
                                                       k3_refs, monkeypatch,
                                                       fault, dtype):
    atol, _, batch = K3_TOL[dtype]
    monkeypatch.setattr(K1, "_bwd_lib", lambda: k3_mutants[dtype][fault])
    errs = {(n, c): _worst(_k3_errs(cuda, dtype, n, c, batch, k3_refs))
            for n, c in sorted(set(K1_SHAPES))}
    print(fault, dtype, errs)
    assert _check_fails(errs, atol), errs


def test_training_backward_reaches_every_attention_parameter(cuda):
    """A DiffusionUNet loss's backward on the card gives every parameter of
    every LinearAttention and of mid_attn a nonzero gradient, through K3
    and K2's recompute (their forwards write through raw pointers, so
    without the autograd Functions these parameters got no gradient)."""
    torch.manual_seed(0)
    net = DiffusionUNet(dim=8, dim_mults=(1, 2)).to(
        cuda, memory_format=torch.channels_last)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=(2, 1, 32, 32)), dtype=torch.float32,
                     device=cuda).contiguous(memory_format=torch.channels_last)
    t = torch.tensor([3.0, 700.0], device=cuda)
    pc = torch.tensor(rng.uniform(100, 600, (2, 4)), dtype=torch.float32,
                      device=cuda)
    before = (K1.fused_linear_attention.launches,
              K1.fused_linear_attention_bwd.launches,
              K2.multihead_attention.launches)
    net(x, t, pc).abs().mean().backward()
    torch.cuda.synchronize()
    assert (K1.fused_linear_attention.launches - before[0],
            K1.fused_linear_attention_bwd.launches - before[1],
            K2.multihead_attention.launches - before[2]) == (4, 4, 1)
    mods = [m for m in net.modules() if isinstance(m, PreNormResidual)]
    assert len(mods) == 5
    for m in mods:
        for name, prm in m.named_parameters():
            assert prm.grad is not None, name
            assert prm.grad.abs().max() > 0, name


def test_dim256_training_step_runs_k1_and_k3_at_c2048(cuda):
    """A bf16 training step of a dim-256 U-Net (LinearAttention up to c =
    2048, up_0's) on the card: K1 and K3 launch at every width, none is
    routed to the plain version, and every gradient is finite. (Before K3
    took c up to 2048, this step raised.)"""
    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.models.blocks import LinearAttention

    torch.manual_seed(0)
    net = C.build_diffusion_unet(C.ModelConfig(dim=256)).to(
        cuda, memory_format=torch.channels_last)
    assert max(m.to_qkv.in_channels for m in net.modules()
               if isinstance(m, LinearAttention)) == 2048
    diffusion = C.build_diffusion(C.DiffusionConfig(image_size=64))
    rng = np.random.default_rng(7)
    img = torch.tensor(rng.uniform(0, 1, (2, 64, 64, 1)),
                       dtype=torch.float32, device=cuda)
    intr = torch.tensor([[[585.0, 0, 32.0], [0, 585.0, 32.0], [0, 0, 1]]] * 2,
                        device=cuda)
    ops = (K1.fused_linear_attention, K1.fused_linear_attention_bwd)
    before = [(op.launches, op.plain_routes) for op in ops]
    gen = torch.Generator(device=cuda).manual_seed(0)
    loss = diffusion.training_loss(net, img, intr, gen)
    loss.backward()
    torch.cuda.synchronize()
    assert [(op.launches - a, op.plain_routes - r)
            for op, (a, r) in zip(ops, before)] == [(8, 0), (8, 0)]
    assert torch.isfinite(loss)
    for name, prm in net.named_parameters():
        assert prm.grad is not None and torch.isfinite(prm.grad).all(), name


@pytest.mark.parametrize("n,c,shift", [(256, 36, 0), (300, 34, 0),
                                       (300, 36, 1)])
def test_fp32_block_launches_at_any_c(cuda, n, c, shift):
    """fp32 K1 and K3 take every c <= 2048: at c = 36, at a ragged c = 34
    (4-byte staging) and on an x 4 bytes past a 16-byte boundary (shift)
    both launch, none is routed, and both hold their plain versions'
    bounds (K3 through K1's fp32 kernel A)."""
    x, dy, *w = K1.check_inputs_bwd(2, n, c, torch.float32, cuda)
    if shift:
        x = torch.empty(x.numel() + shift, device=cuda)[shift:].view_as(
            x).copy_(x)
        assert x.data_ptr() % 16 and x.is_contiguous()
    ops = (K1.fused_linear_attention, K1.fused_linear_attention_bwd)
    before = [(op.launches, op.plain_routes) for op in ops]
    out = K1.fused_linear_attention(x, *w, eps=1e-5)
    got = K1.fused_linear_attention_bwd(x, dy, *w, eps=1e-5)
    torch.cuda.synchronize()
    assert [(op.launches - a, op.plain_routes - r)
            for op, (a, r) in zip(ops, before)] == [(1, 0), (1, 0)]
    ref = K1.fused_linear_attention_plain(x, *w, eps=1e-5)
    assert (out - ref).abs().max().item() <= next(
        atol for dtype, atol, _ in K1_TOL if dtype == torch.float32)
    want = K1.fused_linear_attention_bwd_plain(x, dy, *w, eps=1e-5)
    assert _worst([_rel(a, r) for a, r in zip(got, want)]) <= \
        K3_TOL[torch.float32][0]


def test_bf16_c36_block_runs_the_plain_version_by_routing(cuda):
    """bf16 at c = 36 (c % 8 != 0): the tensor-core kernels do not take
    it, so forward and backward run the plain versions on the card, each
    counted in plain_routes, with no launch; the gradients are the plain
    version's."""
    x, dy, *w = K1.check_inputs_bwd(2, 256, 36, torch.bfloat16, cuda)
    ops = (K1.fused_linear_attention, K1.fused_linear_attention_bwd)
    before = [(op.launches, op.plain_routes) for op in ops]
    leaf = x.clone().requires_grad_()
    K1.fused_linear_attention(leaf, *w, eps=1e-3).backward(dy)
    assert [(op.launches - a, op.plain_routes - r)
            for op, (a, r) in zip(ops, before)] == [(0, 1), (0, 1)]
    want = K1.fused_linear_attention_bwd_plain(x, dy, *w, eps=1e-3)
    assert torch.equal(leaf.grad, want[0] + want[1])


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() /
            ref.float().abs().max()).item()


# K4 against its plain version by max |got - ref| / max |ref| on
# K1.check_inputs_core: bf16 roundings where the plain version rounds, one
# bf16 step apart where the kernel's fp32 sums run in another order (and
# exp(k - m) against a split's running max); fp32: summation order and the
# three-pass TF32 products (about 21 bits of each).
K4_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
K4_N = [1024, 4096, 16384, 65536]  # the U-Net's n at 256^2, batch 8


def _k4_err(device, dtype, b, n, cache=None):
    key = (dtype, b, n)
    if cache is not None and key in cache:
        qkv, ref = cache[key]
    else:
        qkv = K1.check_inputs_core(b, n, dtype, device)
        ref = K1.linear_attention_core_plain(qkv)
        if cache is not None:
            cache[key] = qkv, ref
    out = K1.linear_attention_core(qkv)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    return _rel(out, ref)


# small shapes; a last split ending on a ragged tile (5, 4097); more
# batch rows than kernel A has blocks at once (one split each, 300, 70)
@pytest.mark.parametrize("dtype", sorted(K4_TOL, key=str))
@pytest.mark.parametrize("b,n", [(1, 1), (2, 100), (3, 1000), (5, 4097),
                                 (300, 70)] + [(8, n) for n in K4_N])
def test_linear_attention_core_kernel_matches_plain(cuda, dtype, b, n):
    before = K1.linear_attention_core.launches
    err = _k4_err(cuda, dtype, b, n)
    assert K1.linear_attention_core.launches == before + 1
    assert err <= K4_TOL[dtype], err


def test_linear_attention_core_backward_on_the_card(cuda):
    qkv = K1.check_inputs_core(2, 1000, torch.float32, cuda)
    g = torch.randn(2, 1000, 128, device=cuda)
    leaf = qkv.clone().requires_grad_()
    K1.linear_attention_core(leaf).backward(g)
    ref = qkv.clone().requires_grad_()
    K1.linear_attention_core_plain(ref).backward(g)
    assert _rel(leaf.grad, ref.grad) <= 1e-4


# Faults planted in a copy of csrc/linear_attention_core.cu (the skeleton
# of both types and its two bodies) or common.cuh; the K4 check must fail
# on each at the production shapes. Both types: a kv split's partial
# dropped (merged as empty), C's rescale by alpha dropped, C^ zeroed where
# it is staged, q's softmax taken over the warp's two heads, each walk's
# products reading the stage the ring refills (item i - 1's, while item
# i + S - 1 lands in it), and q's chunks written unswizzled while ldmatrix
# reads them swizzled.
K4_TC_FAULTS = {
    "context_zeroed": ("const float cv = chat_b[idx];",
                       "const float cv = 0.f * chat_b[idx];"),
    "kv_split_dropped": ("po[LPC * jc + l] = mrun[l];",
                         "po[LPC * jc + l] = split == 0 ? -INFINITY : "
                         "mrun[l];"),
    "kv_rescale_dropped": (
        "cacc[j][e] = fmaf(cacc[j][e], e < 2 ? al_lo : al_hi, tile[j][e]);",
        "cacc[j][e] = cacc[j][e] + tile[j][e];"),
    "q_softmax_across_heads": (
        "const int b0 = hh * (NB / 2), b1 = b0 + NB / 2;",
        "const int b0 = 0, b1 = NB;"),
    "stale_ring_stage": ("unsigned char* st = k4_smem + ring.stage(i);",
                         "unsigned char* st = k4_smem + ring.stage(i + S - "
                         "1);"),
    "swizzle_mismatch": ("cp16(dst + tc::swz(r, j, QROW),",
                         "cp16(dst + r * QROW + (j << 4),"),
}
# fp32 (the Tf32 body, three TF32 passes): the same, the small pass a_hi
# b_lo dropped (the other small pass moves K4's output by about 2.5x the
# gate, tests/test_torch_port_core.py), and a single TF32 pass
K4_FAULTS = {
    **K4_TC_FAULTS,
    "small_pass_dropped": (_SMALL_PASSES, _SMALL_PASSES.splitlines(True)[0]),
    "single_pass": TF32_FAULTS["single_pass"],
}
K4_DTYPE_FAULTS = {torch.float32: K4_FAULTS, torch.bfloat16: K4_TC_FAULTS}


@pytest.fixture(scope="module")
def k4_mutants(cuda, tmp_path_factory):
    root = tmp_path_factory.mktemp("k4_mutants")
    mutants = {}
    for dtype, faults in K4_DTYPE_FAULTS.items():
        d = root / str(dtype).split(".")[-1]
        d.mkdir()
        mutants[dtype] = build_mutants(d, "linear_attention_core", faults,
                                       K1.bind_core)
    return mutants


@pytest.fixture(scope="module")
def k4_refs():
    return {}


@pytest.mark.parametrize("dtype,fault", [
    (dtype, fault) for dtype in sorted(K4_TOL, key=str)
    for fault in sorted(K4_DTYPE_FAULTS[dtype])])
def test_linear_attention_core_check_sees_planted_fault(
        cuda, k4_mutants, k4_refs, monkeypatch, fault, dtype):
    monkeypatch.setattr(K1, "_core_lib", lambda: k4_mutants[dtype][fault])
    errs = {n: _k4_err(cuda, dtype, 8, n, k4_refs) for n in K4_N}
    print(fault, dtype, errs)
    assert _check_fails(errs, K4_TOL[dtype]), errs


# K5 and K6 against their plain versions by max |got - ref| / max |ref| on
# KC.check_inputs_conv: bf16 sums of exact products in another order,
# rounded once (one bf16 step, 2^-8 relative); fp32 summation order only.
CONV_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# small shapes with edges, partial tiles and cin != cout (each
# (b, h, w, cin, cout)), then the tools' shapes
CONV_SMALL = [(1, 1, 1, 1, 1), (2, 7, 37, 5, 3), (1, 9, 33, 70, 130),
              (2, 16, 40, 64, 36)]
# more tiles than the persistent grid has blocks (4 x 3 x 7 x 2 = 168 for
# K5, 4 x 20 x 2 x 2 = 320 for K6 at rows 2, on 132 SMs); cin % 8 != 0
# (element-wise staging); cin = 200, whose weights do not fit beside the
# ring and stream with the windows
CONV_TC = [(4, 40, 100, 16, 72), (2, 24, 24, 13, 72), (1, 20, 20, 200, 40)]
K5_SHAPES = [(16, 256, 256, 64, 64), (16, 256, 256, 128, 64),
             (8, 256, 256, 64, 64), (16, 128, 128, 128, 128)]


def _k5_err(device, dtype, shape, cache=None):
    key = (dtype, shape)
    if cache is not None and key in cache:
        x, w, ref = cache[key]
    else:
        x, w = KC.check_inputs_conv(*shape, dtype, device)
        ref = KC.conv3x3_plain(x, w)
        if cache is not None:
            cache[key] = x, w, ref
    with torch.no_grad():
        out = KC.conv3x3(x, w)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    return _rel(out, ref)


@pytest.mark.parametrize("dtype", sorted(CONV_TOL, key=str))
@pytest.mark.parametrize("shape", CONV_SMALL + CONV_TC + K5_SHAPES[1:3])
def test_conv3x3_kernel_matches_plain(cuda, dtype, shape):
    before = KC.conv3x3.launches
    err = _k5_err(cuda, dtype, shape)
    assert KC.conv3x3.launches == before + 1
    assert err <= CONV_TOL[dtype], err


@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 9, 37, 70, 36), torch.float32, 1e-4),
    ((16, 256, 256, 128, 64), torch.bfloat16, 3e-2),
    ((8, 256, 256, 64, 64), torch.float32, 1e-4)])
def test_conv3x3_gradients_on_the_card(cuda, shape, dtype, tol):
    x, w = KC.check_inputs_conv(*shape, dtype, cuda)
    before = KC.conv3x3.launches
    got = [t.detach().requires_grad_() for t in (x, w)]
    (KC.conv3x3(*got).float() ** 2).sum().backward()
    assert KC.conv3x3.launches == before + 2  # y, then dx
    ref = [t.detach().requires_grad_() for t in (x, w)]
    (KC.conv3x3_plain(*ref).float() ** 2).sum().backward()
    for a, r in zip(got, ref):
        assert a.grad.dtype == r.dtype
        assert _rel(a.grad, r.grad) <= tol


@pytest.mark.parametrize("shape", K5_SHAPES)
def test_conv3x3_fp32_kernel_matches_plain_at_the_tool_shapes(cuda, shape):
    # the three-pass TF32 body at every shape profile_conv.main runs
    before = KC.conv3x3.launches
    err = _k5_err(cuda, torch.float32, shape)
    assert KC.conv3x3.launches == before + 1
    assert err <= CONV_TOL[torch.float32], err


@pytest.mark.parametrize("shape", [(2, 9, 37, 16, 24), (1, 20, 20, 72, 64)])
def test_conv3x3_fp32_takes_any_alignment(cuda, shape):
    """fp32 x and w 4 bytes past a 16-byte boundary take the 4-byte
    staging, launch and hold the same bound."""
    x, w = KC.check_inputs_conv(*shape, torch.float32, cuda)
    xs = torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x).copy_(x)
    ws = torch.empty(w.numel() + 1, device=cuda)[1:].view_as(w).copy_(w)
    assert xs.data_ptr() % 16 and xs.is_contiguous()
    before = KC.conv3x3.launches
    with torch.no_grad():
        out = KC.conv3x3(xs, ws)
    torch.cuda.synchronize()
    assert KC.conv3x3.launches == before + 1
    assert _rel(out, KC.conv3x3_plain(x, w)) <= CONV_TOL[torch.float32]


K6_SHAPES = [((2, 32, 32, 64, 64), 8), ((8, 256, 256, 64, 64), 8)]


def _k6_err(device, shape, rows, cache=None):
    key = (shape, rows)
    if cache is not None and key in cache:
        x, w, ref = cache[key]
    else:
        x, w = KC.check_inputs_conv(*shape, torch.bfloat16, device,
                                    w_dtype=torch.float32)
        ref = KC.conv3_igemm_plain(x, w, rows)
        if cache is not None:
            cache[key] = x, w, ref
    out = KC.conv3_igemm(x, w, rows)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    return _rel(out, ref)


@pytest.mark.parametrize("shape,rows", [((1, 1, 1, 1, 1), 1),
                                        ((2, 6, 37, 5, 3), 3),
                                        ((1, 16, 33, 70, 130), 16),
                                        ((2, 16, 40, 64, 36), 8),
                                        (CONV_TC[0], 2), (CONV_TC[1], 12),
                                        (CONV_TC[2], 4), (CONV_TC[2], 5),
                                        ((2, 16, 40, 128, 64), 8)] +
                         K6_SHAPES + [((16, 256, 256, 64, 64), 8)])
def test_conv3_igemm_kernel_matches_plain(cuda, shape, rows):
    before = KC.conv3_igemm.launches
    err = _k6_err(cuda, shape, rows)
    assert KC.conv3_igemm.launches == before + 1
    assert err <= CONV_TOL[torch.bfloat16], err


def test_new_kernels_reject_what_they_do_not_take(cuda):
    qkv = torch.zeros((1, 16, 384), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError):
        K1.linear_attention_core(qkv)  # fp16
    with pytest.raises(ValueError):
        K1.linear_attention_core(qkv.float(), 8, 16)  # 8 heads x 16
    with pytest.raises(ValueError):
        K1.linear_attention_core(qkv.float()[:, ::2])  # not contiguous
    # the kernel stages 16-byte chunks: a qkv 4 bytes off raises
    with pytest.raises(ValueError):
        K1.linear_attention_core(torch.zeros(
            1 + 16 * 384, device=cuda)[1:].view(1, 16, 384))
    x = torch.zeros((1, 8, 8, 4), device=cuda)
    w = torch.zeros((3, 3, 4, 4), device=cuda)
    with pytest.raises(ValueError):
        KC.conv3x3(x.half(), w)
    with pytest.raises(ValueError):
        KC.conv3x3(x, torch.zeros((3, 3, 4, 8192), device=cuda))
    with pytest.raises(ValueError):
        KC.conv3_igemm(x, w)  # K6 has no fp32 version
    with pytest.raises(ValueError):
        KC.conv3_igemm(torch.zeros((1, 32, 8, 4), dtype=torch.bfloat16,
                                   device=cuda), w, rows=32)


# Faults planted in copies of csrc/conv3x3.cu and csrc/conv3_igemm.cu;
# all six are in the tensor-core body both include (csrc/conv3_tc.cuh), and
# each kernel's check must fail on each: the four of the old kernels, and
# two of the new design, a ring stage read one item late (tile t computes
# on the window of the block's tile before) and the window's chunks written
# unswizzled while ldmatrix reads them swizzled.
CONV_FAULTS = {
    "tap_dropped": ("if (r >= 0 && r < RW) {",
                    "if (r >= 0 && r < RW && !(dy == 2 && dx == 2)) {"),
    "halo_row_lost": ("in = gy >= 0 && gy < g.h",
                      "in = gy >= tl.y0 && gy < g.h"),
    "edge_wrapped": ("const int gx = tl.x0 - 1 + (pos - wr * WC);",
                     "const int gx = (tl.x0 - 1 + (pos - wr * WC) + g.wd) % "
                     "g.wd;"),
    "cin_slice_dropped": ("for (int kk = 0; kk < KCH / 16; ++kk) {",
                          "for (int kk = 0; kk < KCH / 16; ++kk) { "
                          "if (c * KCH + 16 * kk == 16) continue;"),
    "stale_ring_stage": (
        "const uint32_t xsm = ring + (i % stages) * stage_bytes;",
        "const uint32_t xsm = ring + ((i + stages - 1) % stages) * "
        "stage_bytes;"),
    "swizzle_mismatch": (
        "cp16(dst + pos * ROW_BYTES + ((j ^ (pos & 7)) << 4), src, in);",
        "cp16(dst + pos * ROW_BYTES + (j << 4), src, in);"),
}
K5_FAULTS = CONV_FAULTS
K6_FAULTS = CONV_FAULTS
# K5's fp32 path, the three-pass TF32 body (conv3_tf32.cuh): the window's
# chunks written unswizzled while ldmatrix reads them swizzled; the halo's
# zero-fill lost (positions outside the image and channels past cin read
# x's first four floats); the right tap column reading the centre
# column's window positions (a tap offset); the right tap column's
# fragment of the second chunk not added; the weights' hi passed for their
# lo; and TF32_FAULTS (the split in common.cuh)
K5_F32_FAULTS = {
    "swizzle_mismatch": ("cp16(win + row_chunk(pos, j), src, in);",
                         "cp16(win + pos * 128 + (j << 4), src, in);"),
    "halo_not_zeroed": ("cp16(win + row_chunk(pos, j), src, in);",
                        "cp16(win + row_chunk(pos, j), src, true);"),
    "tap_offset": ("const int wpos = apos + wr * WC + dx;",
                   "const int wpos = apos + wr * WC + (dx == 2 ? 1 : dx);"),
    "chunk_fragment_dropped": (
        "for (int e = 0; e < 4; ++e) acc[r][n][e] += t[r][n][e];",
        "for (int e = 0; e < 4; ++e) acc[r][n][e] += c == 1 && dx == 2 ? "
        "0.f : t[r][n][e];"),
    "weights_hi_for_lo": (
        "mma_3xtf32(t[r][n], ah, al, bh[dy][n], bl[dy][n]);",
        "mma_3xtf32(t[r][n], ah, al, bh[dy][n], bh[dy][n]);"),
    **TF32_FAULTS,
}


def _check_fails(errs: dict, tol: float) -> bool:
    """The kernel check (err <= tol) fails at some shape; a NaN fails it."""
    return any(not e <= tol for e in errs.values())


@pytest.fixture(scope="module")
def conv_mutants(cuda, tmp_path_factory):
    root = tmp_path_factory.mktemp("conv_mutants")
    for d in ("k5", "k6", "k5_f32"):
        (root / d).mkdir()
    return (build_mutants(root / "k5", "conv3x3", K5_FAULTS,
                          KC.bind_conv3x3),
            build_mutants(root / "k6", "conv3_igemm", K6_FAULTS,
                          KC.bind_igemm),
            build_mutants(root / "k5_f32", "conv3x3", K5_F32_FAULTS,
                          KC.bind_conv3x3))


@pytest.fixture(scope="module")
def conv_refs():
    return {}


@pytest.mark.parametrize("fault", sorted(K5_FAULTS))
def test_conv3x3_check_sees_planted_fault(cuda, conv_mutants, conv_refs,
                                          monkeypatch, fault):
    monkeypatch.setattr(KC, "_conv3x3_lib", lambda: conv_mutants[0][fault])
    errs = {s: _k5_err(cuda, torch.bfloat16, s, conv_refs)
            for s in [CONV_SMALL[3], K5_SHAPES[2]]}
    print(fault, errs)
    assert _check_fails(errs, CONV_TOL[torch.bfloat16]), errs


@pytest.mark.parametrize("fault", sorted(K5_F32_FAULTS))
def test_conv3x3_fp32_check_sees_planted_fault(cuda, conv_mutants, conv_refs,
                                               monkeypatch, fault):
    monkeypatch.setattr(KC, "_conv3x3_lib", lambda: conv_mutants[2][fault])
    errs = {s: _k5_err(cuda, torch.float32, s, conv_refs)
            for s in [CONV_SMALL[3], K5_SHAPES[2]]}
    print(fault, errs)
    assert _check_fails(errs, CONV_TOL[torch.float32]), errs


@pytest.mark.parametrize("fault", sorted(K6_FAULTS))
def test_conv3_igemm_check_sees_planted_fault(cuda, conv_mutants, conv_refs,
                                              monkeypatch, fault):
    monkeypatch.setattr(KC, "_igemm_lib", lambda: conv_mutants[1][fault])
    errs = {s: _k6_err(cuda, s, rows, conv_refs) for s, rows in K6_SHAPES}
    print(fault, errs)
    assert _check_fails(errs, CONV_TOL[torch.bfloat16]), errs


# ---------------------------------------------------------------------------
# the depth-correction path on the card

# fp32 gradients, card (K1, K2, K3 in three TF32 passes, cuDNN fp32) vs CPU
# (plain versions): per parameter, relative to its largest gradient
MASK_GRAD_RTOL = 2e-3


def _write_pairs(root, size, n=2, seed=0):
    """``n`` train pairs and one val pair of uint16 depth PNGs."""
    import json

    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "data").mkdir(parents=True)
    (root / "metadata").mkdir()
    for subset, count in (("train", n), ("val", 1)):
        entries = []
        for i in range(count):
            base = rng.integers(500, 9000, (size, size))
            label = base + rng.integers(0, 30, base.shape)
            off = rng.uniform(size=base.shape) < 0.3
            label[off] += rng.integers(60, 2000, int(off.sum()))
            names = [f"{subset}-{i}-{k}.depth.png" for k in ("in", "lb")]
            for name, a in zip(names, (base, label)):
                Image.fromarray(a.astype(np.uint16)).save(root / "data" / name)
            entries.append({"input_path": names[0], "label_path": names[1]})
        (root / "metadata" / f"{subset}.json").write_text(
            json.dumps(entries))
    return str(root)


# the small width has 2 channels a group: with 1 (dim 8, 8 groups) the
# bias of the conv before each GroupNorm has a gradient of exactly 0, and
# both sides hold rounding noise there
@pytest.mark.parametrize("dim,mults,groups,size", [
    (8, (1, 2), 4, 32), (64, (1, 2, 4, 8), 8, 64)])
def test_mask_trainer_step_on_the_card_matches_the_cpu(cuda, tmp_path, dim,
                                                       mults, groups, size,
                                                       monkeypatch):
    from pointreggpt_tpu_torch.data.datasets import collate
    from pointreggpt_tpu_torch.models import MaskUNet
    from pointreggpt_tpu_torch.train.mask_trainer import (MaskTrainer,
                                                          _to_device)

    # fp32 convs in fp32, as train_depth_correction sets them (cuDNN's
    # default TF32 keeps 10 mantissa bits)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    folder = _write_pairs(tmp_path / "dc", size)
    torch.manual_seed(0)
    kw = dict(dim=dim, dim_mults=mults, resnet_block_groups=groups)
    net = MaskUNet(**kw)
    trainers = [MaskTrainer(MaskUNet(**kw), folder,
                            image_size=size, train_batch_size=2,
                            train_lr=4e-5, num_workers=1, device=dev,
                            results_folder=str(tmp_path / f"r{dev}"),
                            samples_folder=str(tmp_path / f"s{dev}"))
                for dev in ("cpu", "cuda")]
    batch = collate([trainers[0].train_ds[i] for i in range(2)])
    for tr in trainers:
        tr.model.load_state_dict(net.state_dict())
        before = K1.fused_linear_attention_bwd.launches
        tr.train_step(*_to_device(batch, ("input_img", "mask"), tr.device))
    torch.cuda.synchronize()
    n_attn = 2 * len(mults)
    assert K1.fused_linear_attention_bwd.launches == before + n_attn
    lr = trainers[0].lr_at(0)
    for (name, p), q in zip(trainers[0].model.named_parameters(),
                            trainers[1].model.parameters()):
        g, gq = p.grad, q.grad.cpu()
        scale = g.abs().max().item()
        assert (gq - g).abs().max().item() <= MASK_GRAD_RTOL * scale, name
        # Adam's first step moves each parameter by lr times the sign of
        # its gradient: where the gradient is larger than the card-vs-CPU
        # bound, both sides take the same step, equal to fp32 rounding of
        # the O(1) parameter; elsewhere the sign may differ (at most 2 lr)
        diff = (q.detach().cpu() - p.detach()).abs()
        sure = g.abs() > 2 * MASK_GRAD_RTOL * scale
        assert diff[sure].max().item() <= 1e-6, name
        assert diff.max().item() <= 2 * lr * 1.001, name


def test_test_dataset_item_on_the_card_matches_the_cpu(cuda, tmp_path):
    from pointreggpt_tpu_torch.data import datasets
    from pointreggpt_tpu_torch.tools.synthetic_3dmatch import (
        write_motion_tree)

    rgbd, data_root, _, info = write_motion_tree(tmp_path, 1, seed=3)
    got, want = (datasets.TestDataset(info, str(rgbd), 256,
                                      data_root=str(data_root),
                                      device=dev)[0]
                 for dev in ("cuda", "cpu"))
    for k in ("input_img", "label_img"):
        # the same fp32 arithmetic; the card may fuse a multiply-add, which
        # can move a point across a pixel edge: at most 0.1% of pixels
        off = np.abs(got[k] - want[k]) > 1e-6
        assert off.mean() <= 1e-3, (k, off.mean())
    assert (got["input_img"] > 0).mean() > 0.5


# ---------------------------------------------------------------------------
# the port against JAX output, gt.log and the Tester on the card


@pytest.fixture
def fp32_exact(monkeypatch):
    """fp32 products in fp32, as the entry points set them (cuBLAS and
    cuDNN would otherwise run them in TF32)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.mark.parametrize("case", ["forward", "mask", "step"])
def test_jax_parity_on_the_card(cuda, fp32_exact, tmp_path, case):
    """``chip_smoke.py``'s ``jax_parity`` check on one case: the port on
    the card (K1 and K2 bf16 in the DiffusionUNet, fp32 in the MaskUNet)
    against ``tests/data/torch_port_jax_reference.npz``."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    res = chip_smoke.jax_parity_report(torch, K1, K2, tmp_path,
                                       cases=(case,))
    assert not res["failed"], res
    assert res["launches"] == res["want_launches"], res
    assert not any(res["plain_routes"].values()), res
    if case == "forward":
        assert res["fault_over_gate"] >= chip_smoke.FAULT_MARGIN, res


def test_overlap_ratio_on_the_card_matches_the_cpu(cuda, fp32_exact):
    from pointreggpt_tpu_torch.core import pointops as P

    rng = np.random.default_rng(0)
    s = rng.uniform(-1, 1, (3, 4000, 3)).astype(np.float32)
    t = s + rng.normal(0, 0.05, s.shape).astype(np.float32)
    t[:, :1500] += 0.8
    sv = rng.uniform(size=s.shape[:2]) < 0.9
    tv = rng.uniform(size=t.shape[:2]) < 0.9
    sv[2] = False  # an empty cloud: NaN on both
    args = [torch.from_numpy(a) for a in (s, sv, t, tv)]
    got = [o.cpu().numpy() for o in P.overlap_ratio(
        *(a.to(cuda) for a in args), voxel_size=0.05)]
    want = [o.numpy() for o in P.overlap_ratio(*args, voxel_size=0.05)]
    # a point within rounding of the radius may land on the other side:
    # one point of its downsampled cloud (1 / n)
    for g, w, (pts, ok) in zip(got, want, ((s, sv), (t, tv))):
        n = np.array([int(P.voxel_downsample(torch.from_numpy(p),
                                             torch.from_numpy(v), 0.05)[1]
                          .sum()) for p, v in zip(pts, ok)])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        fin = ~np.isnan(w)
        assert (np.abs(g - w)[fin] <= 1.0 / np.maximum(n, 1)[fin]).all()
    assert np.isnan(got[0][2]) and 0.3 < got[0][0] < 0.9


def _small_tester(device, tmp, **kw):
    from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
    from pointreggpt_tpu_torch.generate.generator import place_for_inference
    from pointreggpt_tpu_torch.generate.tester import Tester
    from pointreggpt_tpu_torch.utils.seeded_weights import fill_seeded

    net = fill_seeded(DiffusionUNet(dim=8, dim_mults=(1, 2)), 0)
    diffusion = GaussianDiffusion(image_size=32, timesteps=8,
                                  objective="pred_x0",
                                  beta_schedule="sigmoid", **kw)
    tester = Tester(net, diffusion, batch_size=2, device=device,
                    samples_folder=str(tmp / str(device)))
    tester.ema_model = place_for_inference(net, tester.device)
    return tester


# fp32 dim-8 net, card (K1 and K2 fp32, cuDNN fp32) vs CPU (plain
# versions): the chain bound of the CPU tests against JAX
CHAIN_ATOL, CHAIN_RTOL = 5e-4, 1e-3


def test_tester_step_on_the_card_matches_the_cpu(cuda, fp32_exact,
                                                 tmp_path):
    rng = np.random.default_rng(1)
    b, h = 2, 32
    intr = np.zeros((b, 3, 3), np.float32)
    intr[:, 0, 0] = intr[:, 1, 1] = 36.0
    intr[:, 0, 2] = intr[:, 1, 2] = h / 2
    intr[:, 2, 2] = 1.0
    pc = intr[:, [0, 1, 0, 1], [0, 1, 2, 2]]
    images = rng.uniform(0.15, 0.3, (b, h, h, 1)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose[:, :3, 3] = [0.0, 0.0, 0.5]
    x_init = rng.normal(size=(b, h, h, 1)).astype(np.float32)
    outs = []
    for dev in ("cuda", "cpu"):
        tester = _small_tester(dev, tmp_path, sampling_timesteps=4,
                               ddim_sampling_eta=0.0)
        before = K1.fused_linear_attention.launches
        out = tester.step(*(torch.from_numpy(a).to(dev)
                            for a in (images, intr, pc, pose)), True,
                          x_init=torch.from_numpy(x_init).to(dev))
        outs.append([o.cpu().numpy() for o in out])
        if dev == "cuda":
            assert K1.fused_linear_attention.launches == before + 4 * 4
    (d_gpu, c_gpu, i_gpu), (d_cpu, c_cpu, i_cpu) = outs
    # the splat may move a point across a pixel edge (a fused
    # multiply-add): at most 0.1% of pixels, as TestDataset's rule
    off = np.abs(d_gpu - d_cpu) > 1e-5
    assert off.mean() <= 1e-3, off.mean()
    same = ~off.any(axis=0, keepdims=True).repeat(b, 0)
    np.testing.assert_allclose(i_gpu[..., 0][same], i_cpu[..., 0][same],
                               atol=CHAIN_ATOL, rtol=CHAIN_RTOL)
    assert (c_cpu[..., 1] > 0).mean() > 0.3


def test_p_sample_loop_on_the_card_matches_the_cpu(cuda, fp32_exact,
                                                   tmp_path):
    rng = np.random.default_rng(2)
    b, h, t = 2, 32, 8
    x_init = rng.normal(size=(b, h, h, 1)).astype(np.float32)
    noise = rng.normal(size=(t, b, h, h, 1)).astype(np.float32)
    pc = np.array([[40.0, 40.0, 16.0, 16.0], [35.0, 36.0, 16.0, 16.0]],
                  np.float32)
    mask = (rng.uniform(size=(b, h, h)) > 0.5).astype(np.float32)
    depth = rng.uniform(0.1, 0.4, (b, h, h)).astype(np.float32)
    cond = (np.stack([depth, mask], -1) * 2.0 - 1.0).astype(np.float32)
    outs = []
    for dev in ("cuda", "cpu"):
        tester = _small_tester(dev, tmp_path, sampling_timesteps=t)
        assert not tester.diffusion.is_ddim_sampling
        before = K2.multihead_attention.launches
        out = tester.diffusion.p_sample_loop(
            tester.ema_model, torch.from_numpy(pc).to(dev),
            torch.from_numpy(cond).to(dev), (b, h, h, 1),
            has_refine_step=True, x_init=torch.from_numpy(x_init).to(dev),
            noise=lambda s: torch.from_numpy(noise[s]))
        outs.append(out.cpu().numpy())
        if dev == "cuda":
            # t chain steps and the refine step, one K2 each
            assert K2.multihead_attention.launches == before + t + 1
    np.testing.assert_allclose(outs[0], outs[1], atol=CHAIN_ATOL,
                               rtol=CHAIN_RTOL)


# ---------------------------------------------------------------------------
# FID, the checkpoint importer and the registration loaders on the card


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke


def test_inception_features_on_the_card_match_the_cpu_and_jax(cuda,
                                                              fp32_exact):
    """``chip_smoke.py``'s ``fid_path`` checks (b)-(d): InceptionFeatures
    at 299^2 on the card against the port on the CPU and the committed JAX
    features, the flipped pools as a planted fault, and the FID of two
    seeded sets card vs CPU."""
    cs = _chip_smoke()
    res = cs.fid_features_report(torch)
    assert res["card_gap"] <= res["gate"], res
    assert res["fault_over_gate"] >= cs.FID_FAULT_MARGIN, res
    assert res["fid_score_rel"] <= cs.FID_SCORE_RTOL, res


def test_correspondences_on_the_card_match_the_cpu(cuda, fp32_exact):
    from pointreggpt_tpu_torch.core import pointops as P
    from pointreggpt_tpu_torch.dataloaders.mixture import (
        uniform_sample_rotation)

    cs = _chip_smoke()
    rng = np.random.default_rng(0)
    tgt = rng.uniform(0, 2, (20000, 3)).astype(np.float32)
    tsfm = np.eye(4)
    tsfm[:3, :3] = uniform_sample_rotation(rng)
    tsfm[:3, 3] = rng.normal(size=3)
    src = (tgt[:15000] + rng.normal(0, 0.01, (15000, 3)) - tsfm[:3, 3]) @ \
        tsfm[:3, :3]
    got = P.correspondences_np(src, tgt, tsfm, 0.0375, device="cuda")
    want = P.correspondences_np(src, tgt, tsfm, 0.0375, device="cpu")
    assert len(want) > 15000
    # only pairs within 1e-5 of the radius may differ
    cs.pair_differences(got, want, src, tgt, tsfm, 0.0375)
    args = [torch.from_numpy(a) for a in (
        src.astype(np.float32), np.ones(15000, bool), tgt,
        rng.uniform(size=20000) > 0.2)]
    d_gpu = P.min_dist_sq(*(a.to(cuda) for a in args)).cpu()
    torch.testing.assert_close(d_gpu, P.min_dist_sq(*args), rtol=0,
                               atol=2e-6)


def test_imported_checkpoint_drives_a_generator_step_on_the_card(
        cuda, fp32_exact, tmp_path):
    """``chip_smoke.py``'s ``import_path`` (1): reference-layout ``.pt``
    files at full width through the importer, then one ``Generator.step``
    from them equal bit for bit to the step from the un-imported nets."""
    cs = _chip_smoke()
    res = cs.import_step_report(torch, K1, K2, tmp_path)
    assert not res["differ"], res
    assert [res["k1_launches"], res["k3_launches"], res["k2_launches"]] == \
        res["want_launches"], res
    assert not any(res["plain_routes"].values()), res


# ---------------------------------------------------------------------------
# more than one process (``chip_smoke.py``'s ``dist_path`` and
# ``profile_path`` at dim 8, 32^2, fp32)

def _small_trainer_run(root: str, results: str) -> dict:
    """Two Trainer steps at a global microbatch of 4 with cuDNN's
    deterministic algorithms; the replica digest and the device."""
    from pathlib import Path

    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = DR.build_trainer(str(Path(root) / "rgbd"),
                          str(Path(root) / "gt.log"), results,
                          full_width=False, global_batch=4, steps=2)
    tr.train(log_every=10**9)
    return dict(digest=DR.digest(tr.ema), device=str(tr.device))


def _group_of_one_rank(root: str) -> dict:
    import torch.distributed as dist

    return dict(backend=str(dist.get_backend()),
                **_small_trainer_run(root, root + "/results-ws1"))


def test_trainer_in_a_group_of_one_over_nccl_is_bit_identical(
        cuda, tmp_path, monkeypatch):
    """``dist_path`` (a): one process in a group of one over NCCL trains
    bit for bit as with no group (the all-reduce of one and the division
    by 1 are exact)."""
    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR

    for flag in ("deterministic", "benchmark", "allow_tf32"):
        monkeypatch.setattr(torch.backends.cudnn, flag,
                            getattr(torch.backends.cudnn, flag))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    DR.write_depth_tree(tmp_path, n_frames=8)
    one = _small_trainer_run(str(tmp_path), str(tmp_path / "results-one"))
    (ws1,) = DR.launch(_group_of_one_rank, 1, args=(str(tmp_path),),
                       timeout_s=300, threads=None)
    assert "nccl" in ws1["backend"]
    assert ws1["device"] == "cuda:0"
    assert ws1["digest"] == one["digest"]


def test_two_processes_share_the_card_over_gloo(cuda):
    """``dist_path`` (b)'s dry run: two processes on ``cuda:0`` over gloo,
    replicas identical, scenes by stride, rank 0's checkpoint alone."""
    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR

    out = DR.dryrun(2, local_ranks=[0, 0], backend="gloo", timeout_s=300)
    assert out["devices"] == ["cuda:0", "cuda:0"]


def test_profiled_trainer_traces_device_kernels(cuda, tmp_path,
                                                monkeypatch):
    """``profile_path``: ``PRGPT_PROFILE`` on the card writes a trace that
    holds the step's kernels."""
    import json

    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR

    folder, gt_log = DR.write_depth_tree(tmp_path, n_frames=4)
    monkeypatch.setenv("PRGPT_PROFILE", str(tmp_path / "prof"))
    tr = DR.build_trainer(folder, gt_log, str(tmp_path / "r"),
                          full_width=False, global_batch=2, steps=6)
    tr.sample_on_save = False
    tr.train(log_every=1)
    (trace,) = (tmp_path / "prof").rglob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


# ---------------------------------------------------------------------------
# the rest of the JAX surface (``chip_smoke.py``'s ``surface_path``)


@pytest.mark.parametrize("case", ["condition", "denoise", "interpolate",
                                  "fourier"])
def test_surface_parity_on_the_card(cuda, fp32_exact, case):
    """``surface_path`` (c) on one case: the port on the card against
    ``tests/data/torch_port_jax_surface.npz``; the swapped interpolation
    at least ``FAULT_MARGIN`` times its gate."""
    cs = _chip_smoke()
    res = cs.surface_parity_report(torch, K1, K2, cases=(case,))
    assert not res["failed"], res
    assert res["launches"] == res["want_launches"], res
    assert not any(res["plain_routes"].values()), res
    if case == "interpolate":
        assert res["fault_over_gate"] >= cs.FAULT_MARGIN, res


def test_surface_ckpt_folder_drives_a_generator_step_on_the_card(
        cuda, fp32_exact, tmp_path):
    """``surface_path`` (d): ``Generator.load`` on a folder of the JAX
    ``.ckpt`` files, its step bit for bit the importer's ``.pt``'s."""
    res = _chip_smoke().surface_ckpt_report(torch, K1, K2, tmp_path)
    assert not res["differ"], res
    assert res["launches"] == res["want_launches"], res


def test_surface_native_decode_on_the_cards_machine(cuda, tmp_path):
    """``surface_path`` (f): the native library builds on the card's host
    and decodes as PIL does, bit for bit."""
    res = _chip_smoke().surface_native_report(tmp_path / "native")
    assert res["available"] and not res["unequal"], res


def test_surface_fourier_gradients_on_the_card(cuda, fp32_exact):
    """``surface_path`` (g): a Fourier / learned-variance net's gradients
    through K1, K3 and K2 against the CPU; frozen frequencies get none."""
    cs = _chip_smoke()
    res = cs.surface_fourier_grads(torch, K1, K2)
    assert res["launches"] == res["want_launches"], res
    for name in cs.SURFACE_GRAD_OPTIONS:
        assert res[name]["max_rel_err"] <= cs.GRAD_RTOL, res
    assert res["learned"]["frequencies_grad"], res
    assert res["frozen"]["frequencies_grad"] is None, res
