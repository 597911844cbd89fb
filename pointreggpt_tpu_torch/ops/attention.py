"""K2: bottleneck full attention, with its plain PyTorch version.

``multihead_attention`` is a ``torch.autograd.Function``. Its forward runs
the hand-written CUDA flash kernel (``csrc/attention.cu``, which replaces
``pointreggpt_tpu/ops/attention.py::_attention_pallas``; on the tensor
cores, fp32 in three TF32 passes) for a CUDA tensor and
``multihead_attention_plain`` for a CPU tensor. No fallback: a CUDA tensor
the kernel does not take raises.

Its backward recomputes ``multihead_attention_plain`` under autograd and
takes that function's gradient, on either device: the exact counterpart
of ``_attention_pallas_ad_bwd``, whose backward is XLA's vjp of
``_attention_xla``. The JAX package has no backward kernel for K2, so a
plain backward is the faithful port here, not a missing kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from pointreggpt_tpu_torch.ops import _build


def multihead_attention_plain(q, k, v, *, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v in fp32 over (b, n, h, d) tensors, a port
    of ``_attention_xla``; returns q.dtype."""
    qf = q.float() * scale
    sim = torch.einsum("bihd,bjhd->bhij", qf, k.float())
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhij,bjhd->bihd", attn, v.float())
    return out.to(q.dtype)


def multihead_attention(q, k, v, *, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (b, n, heads, dim_head) tensors (K2).

    q, k and v may be strided views of one packed projection, as long as
    they share strides, each head's d values are contiguous and, on the
    card, every row starts 16-byte aligned. Returns a
    contiguous (b, n, h, d) tensor in q.dtype.
    """
    return MultiheadAttentionFn.apply(q, k, v, scale)


class MultiheadAttentionFn(torch.autograd.Function):
    """K2 forward; the backward is the gradient of the plain version,
    recomputed (``_attention_pallas_ad`` of the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = multihead_attention_plain(*leaves, scale=ctx.scale)
            return (*torch.autograd.grad(out, leaves, g), None)


def _forward(q, k, v, scale: float) -> torch.Tensor:
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return multihead_attention_plain(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"multihead_attention: unsupported device "
                         f"{q.device}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("multihead_attention: q, k, v must share one "
                         f"(b, n, h, d) shape, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"multihead_attention: dtypes {q.dtype} {k.dtype} "
                         f"{v.dtype}")
    b, n, h, d = q.shape
    if d != 32:
        raise ValueError(f"multihead_attention: dim_head {d} != 32")
    if k.device != q.device or v.device != q.device:
        raise ValueError("multihead_attention: q, k, v on different devices")
    strides = q.stride()
    if k.stride() != strides or v.stride() != strides or \
            strides[3] != 1 or strides[2] != d:
        raise ValueError("multihead_attention: q, k, v need shared strides "
                         f"with contiguous heads, got {q.stride()} "
                         f"{k.stride()} {v.stride()}")
    bf16 = q.dtype == torch.bfloat16
    per16 = 16 // q.element_size()  # elements in a 16-byte chunk
    if strides[0] % per16 or strides[1] % per16 or \
            any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("multihead_attention: the kernels stage 16-byte "
                         "chunks and need 16-byte aligned rows, got strides "
                         f"{strides}")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    # the launcher reads the current device's limits: make it q's
    with torch.cuda.device(q.device):
        rc = _lib().prgpt_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n,
            h, d, strides[0], strides[1], float(scale), int(bf16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "multihead_attention")
    multihead_attention.launches += 1
    return out


multihead_attention.launches = 0


def _lib():
    return bind(_build.load("attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of a library built from ``csrc/attention.cu``
    (once per library)."""
    if not getattr(lib, "_prgpt_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.prgpt_attention.argtypes = [p, p, p, p, i, i, i, i, ll, ll,
                                        ctypes.c_float, i, p]
        lib.prgpt_attention.restype = i
        lib._prgpt_typed = True
    return lib


def work(b: int, n: int, h: int, d: int, itemsize: int) -> dict:
    """Bytes (q, k, v read once, out written once) and operations (q k^T
    and p v) of one K2 call."""
    return {"bytes": 4 * b * n * h * d * itemsize,
            "flops": 2 * 2 * b * h * n * n * d}


def check_inputs(b: int, n: int, h: int, d: int, dtype: torch.dtype, device,
                 seed: int = 0) -> tuple:
    """``(q, k, v)`` that hold K2 against :func:`multihead_attention_plain`
    by max |got - ref|: strided views of one packed (b, n, 3, h, d)
    projection, as the U-Net's bottleneck passes them.

    - q and k have a spread of 2, so the scaled scores q k^T / sqrt(d) have
      a spread of about 4 and each row's softmax is peaked: a few keys carry
      it, so every k tile, the online rescale and the row sum move the
      output (with unit normals the softmax is nearly flat and the output
      nearly v's mean, which hides a lost rescale).
    - v has a spread of 1/4, so the output stays inside (-2, 2), where one
      bf16 step is at most 2^-7, inside the 1e-2 bound.
    """
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, n, 3, h, d))
    qkv[:, :, :2] *= 2.0
    qkv[:, :, 2] *= 0.25
    qkv = torch.tensor(qkv, dtype=dtype, device=device)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
