"""Hand-written kernels of the PyTorch port against their plain versions,
on the card (``-m cuda``); they skip without one.

Run on a machine with an H100:  python -m pytest tests/test_torch_port_cuda.py
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from pointreggpt_tpu_torch.ops import _build
from pointreggpt_tpu_torch.ops import attention as K2
from pointreggpt_tpu_torch.ops import linear_attention as K1

pytestmark = pytest.mark.cuda

# (n, c) of the eight LinearAttention calls of a dim-64 U-Net at 256^2
K1_SHAPES = [(65536, 64), (16384, 64), (4096, 128), (1024, 256),
             (1024, 512), (4096, 256), (16384, 128), (65536, 64)]
# LayerNorm output is O(1) (inside (-2, 2) on K1.check_inputs): bf16 keeps
# 8 mantissa bits, and a few values round one or two bf16 steps (2^-7
# each) apart where the kernel's fp32 sums run in another order -> 3e-2
# absolute. fp32 differs only by summation order.
K1_TOL = [(torch.bfloat16, 3e-2, 1e-3), (torch.float32, 1e-3, 1e-5)]


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


@pytest.mark.parametrize("dtype,atol,eps", K1_TOL)
@pytest.mark.parametrize("n,c", [(256, 64), (1000, 72)] +
                         sorted(set(K1_SHAPES)))
def test_linear_attention_kernel_matches_plain(cuda, dtype, atol, eps, n, c):
    before = K1.fused_linear_attention.launches
    err = _k1_err(cuda, dtype, eps, n, c)
    assert K1.fused_linear_attention.launches == before + 1
    assert err <= atol, err


# Faults planted in a copy of csrc/linear_attention.cu: (text, replacement).
# The check above must fail for each of them at the production shapes.
_SOFTMAX = """\
  for (int task = warp; task < rows * NH; task += THREADS / 32) {
    float* qv = qs + (task / NH) * HID + (task % NH) * DH;
    const float v = qv[lane];
    const float e = expf(v - prgpt::warp_max(v));
    qv[lane] = rnd<T>(e / prgpt::warp_sum(e));
  }"""
_SOFTMAX_ACROSS_HEADS = """\
  for (int r = warp; r < rows; r += THREADS / 32) {
    float* qv = qs + r * HID;
    float m = -INFINITY, s = 0.f;
    for (int h = 0; h < NH; ++h) m = fmaxf(m, qv[h * DH + lane]);
    m = prgpt::warp_max(m);
    for (int h = 0; h < NH; ++h) s += expf(qv[h * DH + lane] - m);
    s = prgpt::warp_sum(s);
    for (int h = 0; h < NH; ++h)
      qv[h * DH + lane] = rnd<T>(expf(qv[h * DH + lane] - m) / s);
  }"""
K1_FAULTS = {
    "context_zeroed": ("rnd<T>(acc * scale * inv_s[d])", "rnd<T>(0.f * acc)"),
    "kv_split_dropped": ("for (int i = 0; i < splits; ++i)",
                         "for (int i = 1; i < splits; ++i)"),
    "kv_rescale_dropped": ("acc[j] *= al;", "acc[j] *= 1.f;"),
    "q_softmax_unnormalised": ("rnd<T>(e / prgpt::warp_sum(e))",
                               "rnd<T>(e)"),
    # the head mask lost from q's softmax: normalised over all 128 lanes
    "q_softmax_across_heads": (_SOFTMAX, _SOFTMAX_ACROSS_HEADS),
    "bias_dropped": ("const float bj = rnd<T>(bout[j]);",
                     "const float bj = 0.f;"),
}


@pytest.fixture(scope="module")
def k1_mutants(cuda, tmp_path_factory):
    """One library per planted fault, built in parallel."""
    root = tmp_path_factory.mktemp("k1_mutants")
    src = (_build.CSRC / "linear_attention.cu").read_text()
    (root / "common.cuh").write_bytes((_build.CSRC / "common.cuh")
                                      .read_bytes())
    procs = {}
    for name, (old, new) in K1_FAULTS.items():
        assert old in src, name
        cu = root / f"{name}.cu"
        cu.write_text(src.replace(old, new))
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, "-o", str(root / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out
    return {name: K1.bind(ctypes.CDLL(str(root / f"{name}.so")))
            for name in K1_FAULTS}


@pytest.mark.parametrize("dtype,atol,eps", K1_TOL)
@pytest.mark.parametrize("fault", sorted(K1_FAULTS))
def test_linear_attention_check_sees_planted_fault(cuda, k1_mutants,
                                                   monkeypatch, fault, dtype,
                                                   atol, eps):
    monkeypatch.setattr(K1, "_lib", lambda: k1_mutants[fault])
    errs = {(n, c): _k1_err(cuda, dtype, eps, n, c)
            for n, c in sorted(set(K1_SHAPES))}
    print(fault, dtype, errs)
    assert max(errs.values()) > atol, errs


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("n", [1024, 100])
def test_attention_kernel_matches_plain(cuda, dtype, atol, n):
    rng = np.random.default_rng(1)
    qkv = torch.tensor(rng.normal(size=(8, n, 3, 4, 32)), dtype=dtype,
                       device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = K2.multihead_attention(q, k, v, scale=32**-0.5)
    torch.cuda.synchronize()
    ref = K2.multihead_attention_plain(q, k, v, scale=32**-0.5)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= atol, err


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
