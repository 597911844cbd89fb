"""Hand-written kernels of the PyTorch port against their plain versions,
on the card (``-m cuda``), each kernel's check against faults planted in
copies of its source, and the routes that hand the nets' calls to them;
they skip without a card. The entry points on the card are
``tests/test_torch_port_cuda_paths.py``'s.

Run on a machine with an H100:
    python -m pytest tests/test_torch_port_cuda*.py -q --noconftest
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from pointreggpt_tpu_torch.models import DiffusionUNet
from pointreggpt_tpu_torch.models.blocks import Conv2d, PreNormResidual
from pointreggpt_tpu_torch.ops import _build
from pointreggpt_tpu_torch.ops import attention as K2
from pointreggpt_tpu_torch.ops import conv as KC
from pointreggpt_tpu_torch.ops import group_norm as GN
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


@pytest.fixture
def fp32_exact(monkeypatch):
    """fp32 products in fp32, as the entry points set them (cuBLAS and
    cuDNN would otherwise run them in TF32)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _k1_err(device, dtype, eps, n, c, batch=8):
    args = K1.check_inputs(batch, n, c, dtype, device)
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
                                      (4, 1024, "check"), (8, 100, "check"),
                                      (3, 1, "check"), (2, 65, "check")])
def test_attention_kernel_matches_plain(cuda, dtype, b, n, kind):
    before = K2.multihead_attention.launches
    err = _k2_err(cuda, dtype, b, n, kind)
    assert K2.multihead_attention.launches == before + 1
    assert err <= K2_TOL[dtype], err


# Faults planted in a copy of csrc/attention.cu; the kernel's check must
# fail on each at the production shapes. bf16: the tensor-core kernel
# flash_fwd_tc, a template on d whose faults reach d = 32 and d = 64.
K2_FAULTS = {
    "online_rescale_dropped": ("al[r] = exp2f(m[r] - mx[r]);",
                               "al[r] = 1.f;"),
    "last_k_tile_skipped": ("for (int t = 0; t < tiles; ++t) {",
                            "for (int t = 0; t < tiles - 1; ++t) {"),
    "row_sum_not_divided": ("inv[r] = 1.f / l[r];", "inv[r] = 1.f;"),
    "scale_applied_twice": (
        "const float sl2 = scale * 1.4426950408889634f;",
        "const float sl2 = scale * scale * 1.4426950408889634f;"),
    "swizzle_mismatch": ("cp16(dst + swz_tc<D>(r, j),",
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
    if dtype == torch.bfloat16:  # the same template body at d = 64
        errs64 = {shape: _k2_err_d64(cuda, *shape) for shape in K2_D64}
        print(fault, "d = 64", errs64)
        assert _check_fails(errs64, K2_GATE[dtype]), errs64


# ADM's attention calls at batch 8: (b, n, heads, 64) at 32^2, 16^2, 8^2
K2_D64 = [(8, 1024, 8, 64), (8, 256, 16, 64), (8, 64, 16, 64)]


def _k2_err_d64(device, b, n, h, d, legacy=True):
    """max |K2 - plain fp32| at d = 64 in bf16 on K2.check_inputs, q, k, v
    as ADM passes them (heads 3 d apart)."""
    q, k, v = K2.check_inputs(b, n, h, d, torch.bfloat16, device,
                              legacy=legacy)
    ref = K2.multihead_attention_plain(q.float(), k.float(), v.float(),
                                       scale=d**-0.5)
    out = K2.multihead_attention(q, k, v, scale=d**-0.5)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    return (out.float() - ref).abs().max().item()


@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("shape", K2_D64 + [(3, 100, 16, 64),
                                            (2, 65, 8, 64)])
def test_attention_kernel_d64_matches_plain_fp32(cuda, shape, legacy):
    """bf16 K2 at d = 64 against the plain version in fp32 on the same
    bf16 inputs, within K2's bf16 bound 1e-2: the outputs lie inside
    (-2, 2), where one bf16 step of the written output is at most 2^-7,
    and P rounded to bf16 before P V adds about as much (check_inputs)."""
    before = dict(K2.ROUTES)
    err = _k2_err_d64(cuda, *shape, legacy=legacy)
    assert K2.ROUTES["attn_k2_d64"] == before["attn_k2_d64"] + 1
    assert K2.ROUTES["attn_k2_d32"] == before["attn_k2_d32"]
    assert err <= K2_TOL[torch.bfloat16], err


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
    q = torch.zeros((1, 16, 4, 64), device=cuda)
    with pytest.raises(ValueError):  # d = 64 is bf16 only
        K2.multihead_attention(q, q, q, scale=0.125)
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


@pytest.mark.parametrize("n,c", sorted(set(K1_SHAPES)))
def test_fp32_kernels_match_plain_at_the_mask_trainer_batch(cuda, n, c):
    """K1 and K3 in fp32 at the MaskTrainer's batch of 4, whose kv splits
    and their merge differ from batch 8's (``ops/linear_attention.py::
    _splits``), at the MaskUNet's shapes (K2's is a case of
    test_attention_kernel_matches_plain)."""
    atol, eps = next((a, e) for dtype, a, e in K1_TOL
                     if dtype == torch.float32)
    assert _k1_err(cuda, torch.float32, eps, n, c, batch=4) <= atol
    errs = _k3_errs(cuda, torch.float32, n, c, 4)
    assert _worst(errs) <= K3_TOL[torch.float32][0], errs


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


# ---------------------------------------------------------------------------
# the route of the U-Nets' fp32 3x3 convs: K5 with its bias, conv3_dw

# (h, cin, cout) of the MaskUNet's 43 fp32 3x3 convs at 256^2 (dim 64,
# mults 1, 2, 4, 8), each shape once
MASK_CONV3 = [(256, 64, 64), (256, 128, 64), (128, 64, 64), (128, 192, 128),
              (128, 128, 128), (128, 256, 128), (64, 128, 128),
              (64, 384, 256), (64, 256, 256), (64, 512, 256), (32, 256, 256),
              (32, 256, 512), (32, 512, 512), (32, 768, 512)]


def _dw_inputs(device, b, h, w, cin, cout, seed=0):
    """x ~ N(0, 1) and the output's gradient g ~ N(0, 1), NHWC fp64."""
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.normal(size=(b, h, w, cin)), device=device),
            torch.tensor(rng.normal(size=(b, h, w, cout)), device=device))


def _library_wgrad(x, g):
    """(dw (cout, 3, 3, cin), db) by torch's conv backward (cuDNN) in
    x.dtype on the NHWC tensors viewed as channels-last NCHW."""
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    w = torch.zeros((g.shape[-1], x.shape[-1], 3, 3), dtype=x.dtype,
                    device=x.device).contiguous(
                        memory_format=torch.channels_last)
    _, dw, db = torch.ops.aten.convolution_backward(
        gc, xc, w, [g.shape[-1]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [False, True, True])
    return dw.permute(0, 2, 3, 1), db


def _gap(got, ref):
    """||got - ref|| / ||ref|| over the whole tensor, in fp64."""
    return ((got.double() - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("b", [4, 8])
@pytest.mark.parametrize("h,cin,cout", MASK_CONV3)
def test_conv3_dw_at_the_mask_unet_shapes(cuda, fp32_exact, b, h, cin, cout):
    """dw and db against fp64 at every MaskUNet 3x3 shape: the kernel's gap
    at most twice cuDNN's fp32 weight gradient's (TF32 off)."""
    x, g = _dw_inputs(cuda, b, h, h, cin, cout)
    ref_w, ref_b = _library_wgrad(x, g)
    xf, gf = x.float(), g.float()
    before = KC.conv3_dw.launches
    dw, db = KC.conv3_dw(xf, gf)
    torch.cuda.synchronize()
    assert KC.conv3_dw.launches == before + 1
    lib_w, lib_b = _library_wgrad(xf, gf)
    gaps = dict(dw=_gap(dw, ref_w), db=_gap(db, ref_b),
                lib_dw=_gap(lib_w, ref_w), lib_db=_gap(lib_b, ref_b))
    print((b, h, cin, cout), KC.dw_split(b, h, h, cin, cout), gaps)
    assert gaps["dw"] <= 2 * gaps["lib_dw"], gaps
    assert gaps["db"] <= max(2 * gaps["lib_db"], 1e-6), gaps


@pytest.mark.parametrize("shape", [(4, 256, 256, 64, 64),
                                   (4, 32, 32, 512, 512),
                                   (4, 32, 32, 768, 512)])
def test_conv3_dw_gives_the_same_bits_every_run(cuda, shape):
    x, g = (t.float() for t in _dw_inputs(cuda, *shape, seed=1))
    first = KC.conv3_dw(x, g)
    again = KC.conv3_dw(x, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


# ragged channels and images (4-byte staging where a channel count is no
# multiple of 4), one image of one pixel, and a split over many blocks
DW_SMALL = [(1, 1, 1, 1, 1), (2, 7, 37, 5, 3), (1, 9, 33, 70, 130),
            (2, 16, 40, 64, 36), (3, 13, 50, 36, 72), (2, 64, 64, 16, 8)]


@pytest.mark.parametrize("shape", DW_SMALL)
def test_conv3_dw_matches_fp64_at_ragged_shapes(cuda, shape):
    x, g = _dw_inputs(cuda, *shape, seed=2)
    dw, db = KC.conv3_dw(x.float(), g.float())
    # the nine shifted products in fp64
    ref = torch.zeros_like(dw, dtype=torch.float64)
    h, w = x.shape[1:3]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    for ky in range(3):
        for kx in range(3):
            ref[:, ky, kx] = torch.einsum(
                "bhwi,bhwo->oi", xp[:, ky:ky + h, kx:kx + w], g)
    assert _rel(dw, ref) <= 1e-5
    assert _rel(db, g.sum((0, 1, 2))) <= 1e-5


def test_conv3_dw_takes_any_alignment(cuda):
    x, g = (t.float() for t in _dw_inputs(cuda, 2, 9, 37, 16, 24, seed=3))
    xs = torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x).copy_(x)
    gs = torch.empty(g.numel() + 1, device=cuda)[1:].view_as(g).copy_(g)
    assert xs.data_ptr() % 16 and gs.data_ptr() % 16
    got = KC.conv3_dw(xs, gs)
    want = KC.conv3_dw(x, g)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-6


@pytest.mark.parametrize("shape,channels_last,bias", [
    ((2, 7, 37, 5, 3), True, True), ((1, 9, 33, 70, 130), False, True),
    ((2, 16, 40, 64, 36), True, False)])
def test_conv2d_route_matches_fp64(cuda, shape, channels_last, bias):
    """The route's y, dx, dw and db against F.conv2d's in fp64; an input
    that is not channels-last is copied, once, and counted."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(b, cin, h, w)), device=cuda)
    wt = torch.tensor(rng.normal(size=(cout, cin, 3, 3)) * 0.1, device=cuda)
    bb = torch.tensor(rng.normal(size=cout), device=cuda) if bias else None
    gy = torch.tensor(rng.normal(size=(b, cout, h, w)), device=cuda)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    ins = [t.float().contiguous(memory_format=fmt).requires_grad_()
           for t in (x, wt)]
    bf = bb.float().requires_grad_() if bias else None
    routes = dict(KC.ROUTES)
    y = KC.conv2d(ins[0], ins[1], bf, 1, 1)
    assert KC.ROUTES["conv_k5"] == routes["conv_k5"] + 1
    assert (KC.ROUTES["conv_copies"]
            == routes["conv_copies"] + (not channels_last))
    y.backward(gy.float())
    ref = [t.detach().requires_grad_() for t in (x, wt)]
    rb = bb.detach().requires_grad_() if bias else None
    yr = torch.nn.functional.conv2d(ref[0], ref[1], rb, 1, 1)
    yr.backward(gy)
    assert _rel(y, yr) <= 1e-5
    for got, want in zip(ins + ([bf] if bias else []),
                         ref + ([rb] if bias else [])):
        assert _rel(got.grad, want.grad) <= 1e-5


# a MaskUNet on the route against cuDNN, fp32: per parameter, relative to
# its largest gradient
MASK_GRAD_RTOL = 2e-3
# (dim, mults, groups, size, batch): a small net, and the MaskTrainer's
MASK_ROUTE_NETS = [(8, (1, 2), 4, 32, 2), (64, (1, 2, 4, 8), 8, 256, 4)]


@pytest.mark.parametrize("dim,mults,groups,size,b", MASK_ROUTE_NETS)
def test_mask_unet_on_the_route_matches_cudnn(cuda, fp32_exact, monkeypatch,
                                             dim, mults, groups, size, b):
    """A MaskUNet forward and backward with its fp32 3x3 convs on the
    route against the same net with every conv on F.conv2d (cuDNN, TF32
    off): keep probabilities and every gradient within MASK_GRAD_RTOL;
    the launches count 43 forward, 43 dx and 43 dw at full width."""
    from pointreggpt_tpu_torch.models import MaskUNet
    from pointreggpt_tpu_torch.train.mask_trainer import bce_loss

    torch.manual_seed(0)
    net = MaskUNet(dim=dim, dim_mults=mults, resnet_block_groups=groups).to(
        cuda, memory_format=torch.channels_last)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.uniform(size=(b, 1, size, size)), dtype=torch.float32,
                     device=cuda).contiguous(memory_format=torch.channels_last)
    m = torch.tensor(rng.uniform(size=(b, 1, size, size)) > 0.5,
                     dtype=torch.float32, device=cuda)

    def run():
        net.zero_grad(set_to_none=True)
        prob = net(x)
        bce_loss(prob, m).backward()
        return prob.detach(), [p.grad.clone() for p in net.parameters()]

    n3 = sum(isinstance(mod, Conv2d) and KC.k5_route(
        "cuda", mod.compute_dtype, mod.kernel_size, mod.stride, mod.padding,
        mod.dilation, mod.groups) for mod in net.modules())
    k5, dw, routes = (KC.conv3x3.launches, KC.conv3_dw.launches,
                      dict(KC.ROUTES))
    prob, grads = run()
    torch.cuda.synchronize()
    assert KC.ROUTES["conv_k5"] - routes["conv_k5"] == n3
    assert KC.conv3x3.launches - k5 == 2 * n3  # y, then dx
    assert KC.conv3_dw.launches - dw == n3
    if dim == 64:
        assert n3 == 43
        assert KC.ROUTES["conv_library"] - routes["conv_library"] == 15
    monkeypatch.setattr(KC, "k5_route", lambda *a, **k: False)
    k5 = KC.conv3x3.launches
    prob_lib, grads_lib = run()
    assert KC.conv3x3.launches == k5
    assert (prob - prob_lib).abs().max().item() <= MASK_GRAD_RTOL
    for (name, _), g, gl in zip(net.named_parameters(), grads, grads_lib):
        scale = gl.abs().max().item()
        assert (g - gl).abs().max().item() <= MASK_GRAD_RTOL * scale, name


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


# GroupNorm with its epilogue (ops/group_norm.py, csrc/group_norm.cu)
# against its plain version in fp32 arithmetic: the kernel rounds once to
# the output type where the fp32 reference does not, so a bf16 output may
# sit half a bf16 step (2^-9 relative) off, given 2^-8; beyond that the
# statistics' and the folded a x + b's fp32 sum orders, a few 1e-7 of the
# output's scale, given 1e-5 of its largest value.
GN_REL = {torch.bfloat16: 2.0**-8, torch.float32: 1e-6}
GN_ATOL = 1e-5
# (scale-shift, SiLU) of the nets' calls: Block and ADM's out_layers,
# the MaskUNet's Blocks and ADM's in_layers and head, ADM's attention
GN_EPILOGUES = [(True, True), (False, True), (False, False)]
GN_CASES = ([(4, c, s, g) for c, s, g, _ in GN.DIM64_SHAPES] +
            [(8, c, s, g) for c, s, g, _ in GN.DIM64_SHAPES] +
            [(8, c, s, g) for c, s, g, _ in GN.ADM_SHAPES])


def _gn_err(inputs, groups, ss, silu, out_dtype):
    """The check: max over elements of (|kernel - fp32 plain| - rel
    |ref|) / max |ref|, which must stay under GN_ATOL; and the kernel's
    output."""
    x, gamma, beta, scale, shift = inputs
    sc = (scale, shift) if ss else (None, None)
    with torch.no_grad():
        got = GN.group_norm_act(x, groups, gamma, beta, 1e-5, *sc,
                                silu=silu, out_dtype=out_dtype)
        ref = GN.group_norm_act_plain(x, groups, gamma, beta, 1e-5, *sc,
                                      silu=silu)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == x.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    d = (got.float() - ref).abs() - GN_REL[out_dtype] * ref.abs()
    return (d.max() / ref.abs().max()).item(), got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,size,groups", GN_CASES)
def test_group_norm_kernel_matches_plain_at_the_nets_shapes(
        cuda, dtype, b, c, size, groups):
    """Every GroupNorm shape of the dim-64 nets (batches 4 and 8) and ADM
    (batch 8), each epilogue, in bf16 (output bf16 or fp32, as ADM's head)
    and fp32 (output fp32); one call a check, and the statistics the same
    bits every run."""
    inputs = GN.check_inputs(b, c, size, size, groups, dtype, cuda, seed=c)
    for ss, silu in GN_EPILOGUES:
        for out_dtype in ((torch.bfloat16, torch.float32)
                          if dtype == torch.bfloat16 else (torch.float32,)):
            before = dict(GN.ROUTES)
            err, got = _gn_err(inputs, groups, ss, silu, out_dtype)
            assert GN.ROUTES["norm_fused"] == before["norm_fused"] + 1
            assert GN.ROUTES["norm_copies"] == before["norm_copies"]
            assert err <= GN_ATOL, (ss, silu, out_dtype, err)
    again = _gn_err(inputs, groups, ss, silu, out_dtype)[1]
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,h,w,groups", [(2, 16, 5, 7, 2), (3, 256, 9, 11, 32),
                                            (1, 48, 17, 3, 3), (2, 64, 1, 1, 8),
                                            (2, 2048, 2, 3, 32)])
def test_group_norm_kernel_takes_any_shape_and_layout(cuda, dtype, b, c, h, w,
                                                      groups):
    """Ragged tiles, a block of 252 threads (48 channels in bf16), one
    pixel, 2,048 channels (512 threads a pixel in fp32), and an NCHW input
    or one off a 16-byte start, each of which costs one counted copy."""
    inputs = GN.check_inputs(b, c, h, w, groups, dtype, cuda, seed=3)
    err, _ = _gn_err(inputs, groups, True, True, dtype)
    assert err <= GN_ATOL, err
    x = inputs[0].contiguous()
    before = GN.ROUTES["norm_copies"]
    err, _ = _gn_err((x,) + inputs[1:], groups, True, True, dtype)
    assert err <= GN_ATOL, err
    assert GN.ROUTES["norm_copies"] == before + (
        not x.is_contiguous(memory_format=torch.channels_last))
    # x one element past an aligned start: one counted copy
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    xs = buf[1:].view(b, h, w, c)
    xs.copy_(inputs[0].permute(0, 2, 3, 1))
    before = GN.ROUTES["norm_copies"]
    err, _ = _gn_err((xs.permute(0, 3, 1, 2),) + inputs[1:], groups, True,
                     True, dtype)
    assert err <= GN_ATOL, err
    assert GN.ROUTES["norm_copies"] == before + 1


def test_group_norm_route_leaves_autograd_to_the_plain_version(cuda):
    x, gamma, beta, scale, shift = GN.check_inputs(2, 64, 8, 8, 8,
                                                   torch.bfloat16, cuda)
    w = gamma.clone().requires_grad_()
    before = dict(GN.ROUTES)
    y = GN.group_norm_act(x, 8, w, beta, 1e-5, scale, shift,
                          out_dtype=torch.bfloat16)
    assert y.requires_grad
    with torch.no_grad():
        GN.group_norm_act(x, 8, w, beta, 1e-5, scale, shift,
                          out_dtype=torch.bfloat16)
    GN.group_norm_act(x, 8, gamma, beta, 1e-5, scale, shift,
                      out_dtype=torch.bfloat16)
    with torch.no_grad():  # fp16 is not the kernel's
        GN.group_norm_act(x.half(), 8, gamma, beta, 1e-5)
    assert {k: v - before[k] for k, v in GN.ROUTES.items()} == {
        "norm_fused": 2, "norm_plain": 2, "norm_copies": 0}
    # nor groups narrower than a 16-byte vector, bf16 past 2,048
    # channels, or fp32 written as bf16: each the plain version's
    before = dict(GN.ROUTES)
    with torch.no_grad():
        for c, g in ((3075, 1025), (64, 16), (4096, 32)):
            y = GN.group_norm_act(
                torch.randn(1, c, 2, 2, device=cuda, dtype=torch.bfloat16),
                g, None, None, 1e-5, out_dtype=torch.bfloat16)
            assert y.shape == (1, c, 2, 2)
        GN.group_norm_act(x.float(), 8, gamma, beta, 1e-5,
                          out_dtype=torch.bfloat16)
    assert {k: v - before[k] for k, v in GN.ROUTES.items()} == {
        "norm_fused": 0, "norm_plain": 4, "norm_copies": 0}


def test_group_norm_runs_on_two_streams_at_once_and_in_a_graph(cuda):
    """The statistics' last block of an image knows itself from counters
    that calls on one stream share: calls in flight on two streams at once,
    of different splits, and calls replayed from two CUDA graphs between
    eager ones each give the bits the same call gives alone, and the launch
    count is two a call."""
    shapes = [(8, 256, 64, 32), (8, 512, 32, 32)]
    inputs = [GN.check_inputs(b, c, s, s, g, torch.bfloat16, cuda, seed=k)
              for k, (b, c, s, g) in enumerate(shapes)]

    def call(k):
        x, gamma, beta, scale, shift = inputs[k]
        return GN.group_norm_act(x, shapes[k][3], gamma, beta, 1e-5, scale,
                                 shift, out_dtype=torch.bfloat16)

    with torch.no_grad():
        want = [call(k) for k in range(2)]
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        torch.cuda.synchronize()
        launches = GN.group_norm_act.launches
        outs = [[], []]
        for _ in range(20):
            for k, st in enumerate(streams):
                with torch.cuda.stream(st):
                    outs[k].append(call(k))
        torch.cuda.synchronize()
        assert GN.group_norm_act.launches - launches == 2 * 40
        for k in range(2):
            assert all(torch.equal(o, want[k]) for o in outs[k]), k
        graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
        with torch.cuda.graph(graphs[0]):
            y = [call(0), call(1), call(0)]
        with torch.cuda.graph(graphs[1]):
            z = call(1)
        for _ in range(3):
            graphs[0].replay()
            graphs[1].replay()
            torch.cuda.synchronize()
            assert torch.equal(y[0], want[0]) and torch.equal(y[2], want[0])
            assert torch.equal(y[1], want[1]) and torch.equal(z, want[1])
            assert torch.equal(call(1), want[1])


@pytest.mark.parametrize("denoiser", ["unet", "adm"])
def test_sampling_forward_runs_every_group_norm_on_the_kernel(cuda,
                                                              denoiser):
    """A baked bf16 net on the card, channels-last, under inference_mode:
    every GroupNorm on the kernel with no copy, its output within the bf16
    net's noise of the plain route's; a training forward takes none."""
    from pointreggpt_tpu_torch.models import bake
    from pointreggpt_tpu_torch.models.adm import ADMUNet

    torch.manual_seed(0)
    # groups 8 channels wide, as the nets' (narrower ones are the plain
    # version's)
    if denoiser == "unet":
        net = DiffusionUNet(dim=64, dim_mults=(1, 2), resnet_block_groups=8,
                            dtype=torch.bfloat16)
        args = (torch.randn(2, 1, 32, 32), torch.tensor([3.0, 700.0]),
                torch.rand(2, 4))
    else:
        net = ADMUNet(model_channels=256, channel_mult=(1, 2),
                      attention_ds=(2,), dtype=torch.bfloat16)
        args = (torch.randn(2, 1, 32, 32), torch.tensor([3.0, 700.0]))
    n_norms = sum(isinstance(m, torch.nn.GroupNorm) for m in net.modules())
    gpu = bake.bake_inference(net, torch.bfloat16).to(
        cuda, memory_format=torch.channels_last)
    args = [a.to(cuda) for a in args]
    before = dict(GN.ROUTES)
    with torch.inference_mode():
        got = gpu(*args)
    assert {k: v - before[k] for k, v in GN.ROUTES.items()} == {
        "norm_fused": n_norms, "norm_plain": 0, "norm_copies": 0}
    with torch.inference_mode():
        orig = GN.fused_route
        GN.fused_route = lambda *a, **k: False
        try:
            want = gpu(*args)
        finally:
            GN.fused_route = orig
    gap = ((got - want).abs().max() / want.abs().max()).item()
    assert gap <= 0.05, gap
    before = dict(GN.ROUTES)
    net.to(cuda, memory_format=torch.channels_last)(*args).sum().backward()
    assert GN.ROUTES["norm_fused"] == before["norm_fused"]
    assert GN.ROUTES["norm_plain"] - before["norm_plain"] == n_norms


# Faults planted in copies of csrc/group_norm.cu: (text, replacement). The
# check above must fail for each of them.
GN_FAULTS = {
    "wrong_group": ("const float2 st = stats[n * q.groups + c0 / q.cpg];",
                    "const float2 st = stats[n * q.groups + (c0 / q.cpg + 1)"
                    " % q.groups];"),
    "no_plus_one": (": param<float>(scale, i)) + 1.f;",
                    ": param<float>(scale, i));"),
    "merge_term": ("s = s + sb + d * d * n * w;", "s = s + sb;"),
    "last_split": ("        if (t < q.splits)\n          chan(",
                   "        if (t < q.splits - 1)\n          chan("),
}


@pytest.fixture(scope="module")
def gn_mutants(cuda, tmp_path_factory):
    return build_mutants(tmp_path_factory.mktemp("gn_mutants"),
                         "group_norm", GN_FAULTS, GN.bind)


@pytest.mark.parametrize("fault", sorted(GN_FAULTS))
def test_group_norm_check_sees_planted_fault(cuda, gn_mutants, monkeypatch,
                                             fault):
    monkeypatch.setattr(GN, "_lib", lambda: gn_mutants[fault])
    errs = {}
    for b, c, size, groups in [(4, 64, 128, 8), (8, 1024, 8, 32)]:
        for dtype in (torch.bfloat16, torch.float32):
            inputs = GN.check_inputs(b, c, size, size, groups, dtype, cuda)
            errs[(c, size, dtype)] = _gn_err(inputs, groups, True, True,
                                             dtype)[0]
    print(fault, errs)
    assert _check_fails(errs, GN_ATOL), errs
