"""K2: bottleneck full attention, with its plain PyTorch version.

``multihead_attention`` is a ``torch.autograd.Function``. Its forward runs
the hand-written CUDA flash kernel (``csrc/attention.cu``, which replaces
``pointreggpt_tpu/ops/attention.py::_attention_pallas``) for a CUDA tensor
and ``multihead_attention_plain`` for a CPU tensor. No fallback: a CUDA
tensor the kernel does not take raises.

Its backward recomputes ``multihead_attention_plain`` under autograd and
takes that function's gradient, on either device: the exact counterpart
of ``_attention_pallas_ad_bwd``, whose backward is XLA's vjp of
``_attention_xla``. The JAX package has no backward kernel for K2, so a
plain backward is the faithful port here, not a missing kernel.
"""

from __future__ import annotations

import ctypes

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
    they share strides and each head's d values are contiguous. Returns a
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
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    rc = _lib().prgpt_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, h, d,
        strides[0], strides[1], float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "multihead_attention")
    multihead_attention.launches += 1
    return out


multihead_attention.launches = 0


def _lib():
    lib = _build.load("attention")
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
