"""K1, K3 and K4: the fused LinearAttention block, its analytic backward
and the core alone on packed qkv, each with its plain PyTorch version.

``fused_linear_attention`` is a ``torch.autograd.Function`` (the port of
the JAX ``custom_vjp``). Its forward runs the hand-written CUDA kernel K1
(``csrc/linear_attention.cu``, which replaces
``pointreggpt_tpu/ops/linear_attention.py::_pallas_fused``; on the tensor
cores, bf16 in ``csrc/linear_attention_tc.cuh`` and fp32 in three TF32
passes in ``csrc/linear_attention_tf32.cuh``) for a CUDA tensor and
``fused_linear_attention_plain`` for a CPU tensor. It saves only
``(x, w_qkv, w_out, b_out, g_out)``, the JAX residuals. Its backward runs
K3 (``csrc/linear_attention_bwd.cu``, which replaces ``_pallas_fused_bwd``)
through ``fused_linear_attention_bwd`` for a CUDA tensor and
``fused_linear_attention_bwd_plain`` for a CPU tensor; on the tensor
cores, bf16 in ``csrc/linear_attention_bwd_tc.cuh`` and fp32 in three TF32
passes in ``csrc/linear_attention_bwd_tf32.cuh``, each recomputing the
statistics with K1's kernels of its type.

Shapes past a kernel's limit are routed, as the JAX dispatch
(``_dispatch_fused``, ``_fused_bwd``) sends them to XLA: :func:`_k1_takes`
and :func:`_k3_takes` decide from the dtype and c alone, and a CUDA tensor
they refuse runs the plain version on the card and adds one to the op's
``plain_routes`` (never to its ``launches``). That is a routing rule, not
a fallback: nothing catches a build or launch error, and an unsupported
device or dtype, or a misaligned bf16 tensor, raises.

Block body: qkv projection -> softmax-q (over d per head) / softmax-k (over
n) linear attention core -> out projection + bias -> channel LayerNorm
(scale only, biased variance). heads = 4, dim_head = 32.

``linear_attention_core`` is the core alone, (b, n, 3*hidden) packed
``[q | k | v]`` -> (b, n, hidden), the port of the JAX ``custom_vjp`` of the
same name. Its forward runs K4 (``csrc/linear_attention_core.cu``, which
replaces ``_pallas_core``; on the tensor cores, bf16 in one pass and fp32
in three TF32 passes) for a CUDA tensor and
``linear_attention_core_plain`` for a CPU tensor; its backward is the
gradient of the plain version, recomputed, on either device: the JAX
package has no backward kernel for K4 (its ``_bwd`` takes XLA's vjp of
``_xla_core``), so a plain backward is the faithful port here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from pointreggpt_tpu_torch.ops import _build

HEADS = 4
DIM_HEAD = 32
HIDDEN = HEADS * DIM_HEAD
_TARGET_BLOCKS = 2 * 2 * 132  # keep ~2x the SMs busy in the kv phase
MAX_C = 2048  # the widest c K1 and K3 take, the TPU kernels' own limit


def _k1_takes(dtype: torch.dtype, c: int) -> bool:
    """Whether K1 takes a (b, n, c) CUDA tensor of ``dtype`` (bf16 or
    fp32): c <= 2048, and c % 8 == 0 in bf16 (its tensor-core body stages
    16-byte chunks; the fp32 body stages 4-byte ones where c % 4 != 0).
    Else the plain version runs, as the JAX ``_dispatch_fused`` runs
    ``_xla_fused``."""
    return 1 <= c <= MAX_C and (dtype != torch.bfloat16 or c % 8 == 0)


def _k3_takes(dtype: torch.dtype, c: int) -> bool:
    """Whether K3 takes a (b, n, c) CUDA tensor of ``dtype``: the limits of
    :func:`_k1_takes` (the JAX ``_fused_bwd`` takes Pallas up to c = 2048
    and XLA's vjp beyond)."""
    return _k1_takes(dtype, c)


def linear_attention_core_plain(qkv: torch.Tensor, heads: int = HEADS,
                                dim_head: int = DIM_HEAD) -> torch.Tensor:
    """Plain PyTorch version of K4, a port of ``_xla_core``: (b, n, 3*h*d)
    packed [q | k | v] (head-major within each third) -> (b, n, h*d),
    qkv.dtype; products accumulate in fp32, and exp(k - m), the context,
    the softmaxed q and the output are rounded to qkv.dtype."""
    b, n, _ = qkv.shape
    dtype = qkv.dtype
    x = qkv.reshape(b, n, 3, heads, dim_head)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]

    kf = k.float()
    kmax = kf.amax(dim=1, keepdim=True)
    ek = torch.exp(kf - kmax)
    ksum = ek.sum(dim=1)  # (b, h, d)
    context = torch.einsum("bnhd,bnhe->bhde", ek.to(dtype).float(),
                           v.to(dtype).float())
    context = context * (dim_head**-0.5 / n) / ksum[..., None]

    qs = torch.softmax(q.float(), dim=-1)
    out = torch.einsum("bhde,bnhd->bnhe", context.to(dtype).float(),
                       qs.to(dtype).float())
    return out.reshape(b, n, heads * dim_head).to(dtype)


def _fused_plain(xq, xkv, w_qkv, w_out, b_out, g_out, heads, dim_head,
                 eps) -> torch.Tensor:
    """K1's plain body with x given twice: ``xq`` feeds the q projection,
    ``xkv`` the k and v projections (the same tensor in the forward; two
    leaves in the backward, so that dx comes out in its two parts)."""
    dtype = xq.dtype
    hidden = heads * dim_head
    w = w_qkv.to(dtype).float()
    qkv = torch.cat([xq.float() @ w[:, :hidden],
                     xkv.float() @ w[:, hidden:]], dim=-1).to(dtype)
    core = linear_attention_core_plain(qkv, heads, dim_head)
    out = (core.float() @ w_out.to(dtype).float()).to(dtype) + \
        b_out.to(dtype)
    xf = out.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    ln = (xf - mean) * torch.rsqrt(var + eps) * g_out.float()
    return ln.to(dtype)


def fused_linear_attention_plain(x, w_qkv, w_out, b_out, g_out,
                                 heads: int = HEADS,
                                 dim_head: int = DIM_HEAD,
                                 eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K1, a port of ``_xla_fused``.

    Args:
        x: (b, n, c) pre-normalized activations, model dtype.
        w_qkv: (c, 3*heads*dim_head); w_out: (heads*dim_head, c) — cast to
            x.dtype; b_out, g_out: (c,) fp32.
    """
    return _fused_plain(x, x, w_qkv, w_out, b_out, g_out, heads, dim_head,
                        eps)


def fused_linear_attention_bwd_plain(x, dy, w_qkv, w_out, b_out, g_out,
                                     heads: int = HEADS,
                                     dim_head: int = DIM_HEAD,
                                     eps: float = 1e-5) -> tuple:
    """Plain PyTorch version of K3, a port of ``jax.vjp(_xla_fused)``: the
    autograd of :func:`fused_linear_attention_plain` at ``dy``, with x as
    two leaves (one feeds the q projection, the other k and v).

    Returns ``(dx_q, dx_kv, dw_qkv, dw_out, db_out, dg)``, the outputs of
    ``_pallas_fused_bwd``: the dx parts in x.dtype, the others in the
    dtypes and shapes of the weights given.
    """
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x, x, w_qkv, w_out, b_out, g_out)]
        out = _fused_plain(*leaves, heads, dim_head, eps)
        return torch.autograd.grad(out, leaves, dy.to(out.dtype))


def _splits(b: int, n: int, rows: int, per_row: int | None = None):
    """(splits, rows_per_split) for a kv phase: up to ``per_row`` blocks
    for each batch row (K1 and K3: enough to fill the card about twice,
    ``_TARGET_BLOCKS`` in all), each a whole number of row tiles and none
    empty."""
    if per_row is None:
        per_row = -(-_TARGET_BLOCKS // b)
    tiles = -(-n // rows)
    splits = max(1, min(tiles, per_row))
    tiles_per_split = -(-tiles // splits)
    return -(-tiles // tiles_per_split), tiles_per_split * rows


def _check_device(what, x, heads, dim_head):
    """Raise on what K1, K3 and their routing do not take: a device other
    than the card, another head layout, another dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if (heads, dim_head) != (HEADS, DIM_HEAD):
        raise ValueError(f"{what} kernel is built for 4 heads x 32, got "
                         f"{heads} x {dim_head}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: dtype {x.dtype}")


def _kernel_args(what, x, w_qkv, w_out, b_out, g_out):
    """Check what K1 and K3 take and return the weights as the kernels
    read them: W_qkv and W_out in x.dtype, b_out and g in fp32, each
    contiguous on x's device."""
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (b, n, c) tensor")
    c = x.shape[2]
    w_qkv = w_qkv.to(x.dtype).contiguous()
    w_out = w_out.to(x.dtype).contiguous()
    b_out = b_out.float().contiguous()
    g_out = g_out.float().contiguous()
    if w_qkv.shape != (c, 3 * HIDDEN) or w_out.shape != (HIDDEN, c) or \
            b_out.shape != (c,) or g_out.shape != (c,):
        raise ValueError(f"{what}: weight shapes {tuple(w_qkv.shape)} "
                         f"{tuple(w_out.shape)} {tuple(b_out.shape)} "
                         f"{tuple(g_out.shape)} do not match c={c}")
    for t in (w_qkv, w_out, b_out, g_out):
        if t.device != x.device:
            raise ValueError(f"{what}: weights on {t.device}, x on "
                             f"{x.device}")
    return w_qkv, w_out, b_out, g_out


def _forward(x, w_qkv, w_out, b_out, g_out, heads, dim_head, eps):
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_linear_attention_plain(x, w_qkv, w_out, b_out, g_out,
                                            heads, dim_head, eps)
    _check_device("fused_linear_attention", x, heads, dim_head)
    if not _k1_takes(x.dtype, x.shape[-1]):
        fused_linear_attention.plain_routes += 1
        return fused_linear_attention_plain(x, w_qkv, w_out, b_out, g_out,
                                            heads, dim_head, eps)
    w_qkv, w_out, b_out, g_out = _kernel_args(
        "fused_linear_attention", x, w_qkv, w_out, b_out, g_out)
    b, n, c = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    if bf16 and any(t.data_ptr() % 16 for t in (x, w_qkv, w_out, g_out)):
        raise ValueError("fused_linear_attention: the bf16 kernel stages "
                         "16-byte chunks and needs 16-byte aligned tensors")
    lib = _lib()
    splits, rows_per_split = _splits(
        b, n, lib.prgpt_linear_attention_rows_per_tile(bf16))
    # scratch and the weight copies may be freed on return while the
    # launches still run: the caching allocator hands their memory out
    # again only in the order of this stream
    scratch = torch.empty(lib.prgpt_linear_attention_scratch(b, splits),
                          dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    # the launcher reads the current device's limits: make it x's
    with torch.cuda.device(x.device):
        rc = lib.prgpt_linear_attention(
            x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(),
            b_out.data_ptr(), g_out.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, n, c, splits, rows_per_split, float(eps),
            bf16, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "fused_linear_attention")
    fused_linear_attention.launches += 1
    return out


def fused_linear_attention_bwd(x, dy, w_qkv, w_out, b_out, g_out,
                               heads: int = HEADS, dim_head: int = DIM_HEAD,
                               eps: float = 1e-5) -> tuple:
    """K3: the backward of the block at ``dy`` (same shape and dtype as x).

    A CPU tensor takes :func:`fused_linear_attention_bwd_plain`; a CUDA
    tensor launches the kernel, runs the plain version where
    :func:`_k3_takes` routes it there, or raises. Returns ``(dx_q, dx_kv,
    dw_qkv, dw_out, db_out, dg)``: the dx parts (b, n, c) in x.dtype, the
    weight gradients in fp32 (the plain version's in the weights' dtypes).
    """
    if x.device.type == "cpu":
        return fused_linear_attention_bwd_plain(x, dy, w_qkv, w_out, b_out,
                                                g_out, heads, dim_head, eps)
    _check_device("fused_linear_attention_bwd", x, heads, dim_head)
    if not _k3_takes(x.dtype, x.shape[-1]):
        fused_linear_attention_bwd.plain_routes += 1
        return fused_linear_attention_bwd_plain(x, dy, w_qkv, w_out, b_out,
                                                g_out, heads, dim_head, eps)
    lib = _bwd_lib()
    w_qkv, w_out, b_out, g_out = _kernel_args(
        "fused_linear_attention_bwd", x, w_qkv, w_out, b_out, g_out)
    if dy.shape != x.shape or dy.dtype != x.dtype or \
            dy.device != x.device or not dy.is_contiguous():
        raise ValueError("fused_linear_attention_bwd: dy must be a "
                         f"contiguous {tuple(x.shape)} {x.dtype} tensor on "
                         f"{x.device}, got {tuple(dy.shape)} {dy.dtype} "
                         f"on {dy.device}")
    b, n, c = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=x.device)
    # the scratch is freed on return while the launches still run: the
    # caching allocator hands it out again only in the order of this stream
    fscratch = torch.empty(lib.prgpt_linear_attention_bwd_fscratch(b, n, c),
                           **f32)
    tscratch = torch.empty(lib.prgpt_linear_attention_bwd_tscratch(b, n, c),
                           dtype=x.dtype, device=x.device)
    dx_q, dx_kv = torch.empty_like(x), torch.empty_like(x)
    if bf16 and any(t.data_ptr() % 16 for t in (x, dy, w_qkv, w_out,
                                                dx_q, dx_kv, tscratch)):
        raise ValueError("fused_linear_attention_bwd: the bf16 kernel "
                         "stages 16-byte chunks and needs 16-byte aligned "
                         "tensors")
    dw_qkv = torch.empty((c, 3 * HIDDEN), **f32)
    dw_out = torch.empty((HIDDEN, c), **f32)
    db_out, dg = torch.empty(c, **f32), torch.empty(c, **f32)
    with torch.cuda.device(x.device):
        rc = lib.prgpt_linear_attention_bwd(
            x.data_ptr(), dy.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(),
            b_out.data_ptr(), g_out.data_ptr(), dx_q.data_ptr(),
            dx_kv.data_ptr(), dw_qkv.data_ptr(), dw_out.data_ptr(),
            db_out.data_ptr(), dg.data_ptr(), fscratch.data_ptr(),
            tscratch.data_ptr(), b, n, c, float(eps), bf16,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "fused_linear_attention_bwd")
    fused_linear_attention_bwd.launches += 1
    return dx_q, dx_kv, dw_qkv, dw_out, db_out, dg


fused_linear_attention_bwd.launches = 0
fused_linear_attention_bwd.plain_routes = 0


class FusedLinearAttentionFn(torch.autograd.Function):
    """K1 forward, K3 backward (the JAX ``custom_vjp`` of
    ``fused_linear_attention``)."""

    @staticmethod
    def forward(ctx, x, w_qkv, w_out, b_out, g_out, heads, dim_head, eps):
        ctx.save_for_backward(x, w_qkv, w_out, b_out, g_out)
        ctx.config = (heads, dim_head, eps)
        return _forward(x, w_qkv, w_out, b_out, g_out, heads, dim_head, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w_qkv, w_out, b_out, g_out = ctx.saved_tensors
        dx_q, dx_kv, dw_qkv, dw_out, db_out, dg = fused_linear_attention_bwd(
            x, dy.to(x.dtype).contiguous(), w_qkv, w_out, b_out, g_out,
            *ctx.config)
        return (dx_q + dx_kv, dw_qkv.to(w_qkv.dtype), dw_out.to(w_out.dtype),
                db_out.to(b_out.dtype), dg.to(g_out.dtype), None, None, None)


def fused_linear_attention(x, w_qkv, w_out, b_out, g_out,
                           heads: int = HEADS, dim_head: int = DIM_HEAD,
                           eps: float = 1e-5) -> torch.Tensor:
    """LinearAttention block body (K1, differentiated by K3); add the
    residual outside. Returns (b, n, c) in x.dtype."""
    return FusedLinearAttentionFn.apply(x, w_qkv, w_out, b_out, g_out, heads,
                                        dim_head, eps)


fused_linear_attention.launches = 0
fused_linear_attention.plain_routes = 0


def _core_forward(qkv: torch.Tensor, heads: int, dim_head: int
                  ) -> torch.Tensor:
    """K4 on a CUDA tensor, its plain version on a CPU tensor."""
    if qkv.device.type == "cpu":
        return linear_attention_core_plain(qkv, heads, dim_head)
    if qkv.device.type != "cuda":
        raise ValueError(f"linear_attention_core: unsupported device "
                         f"{qkv.device}")
    if (heads, dim_head) != (HEADS, DIM_HEAD):
        raise ValueError("linear_attention_core kernel is built for 4 heads "
                         f"x 32, got {heads} x {dim_head}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"linear_attention_core: dtype {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] != 3 * HIDDEN or qkv.shape[1] < 1 \
            or not qkv.is_contiguous():
        raise ValueError("linear_attention_core: qkv must be a contiguous "
                         f"(b, n >= 1, {3 * HIDDEN}) tensor, got "
                         f"{tuple(qkv.shape)}")
    if qkv.data_ptr() % 16:
        raise ValueError("linear_attention_core: the kernel stages 16-byte "
                         "chunks and needs a 16-byte aligned qkv")
    b, n, _ = qkv.shape
    bf16 = int(qkv.dtype == torch.bfloat16)
    lib = _core_lib()
    slots = ctypes.c_int(0)
    _build.check(lib.prgpt_linear_attention_core_kv_slots(
        bf16, ctypes.byref(slots)), "linear_attention_core")
    splits, rows_per_split = _core_splits(
        b, n, lib.prgpt_linear_attention_core_rows_per_tile(), slots.value)
    # the scratch may be freed on return while the launches still run: the
    # caching allocator hands its memory out again only in the order of
    # this stream
    scratch = torch.empty(lib.prgpt_linear_attention_core_scratch(b, splits),
                          dtype=torch.float32, device=qkv.device)
    out = torch.empty((b, n, HIDDEN), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = lib.prgpt_linear_attention_core(
            qkv.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, n,
            splits, rows_per_split, bf16,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(rc, "linear_attention_core")
    linear_attention_core.launches += 1
    return out


def _core_splits(b: int, n: int, rows: int, slots: int):
    """K4's kv splits: ``slots`` is how many blocks of its kernel A the card
    holds at once (132 SMs x 2 in bf16, x 1 in fp32 on an H100), so each
    batch row gets ``slots // b`` of them and the kv phase runs in one
    wave, every block with its ring of tiles in flight."""
    return _splits(b, n, rows, max(1, slots // b))


class LinearAttentionCoreFn(torch.autograd.Function):
    """K4 forward; the backward is the gradient of the plain version,
    recomputed (the JAX ``custom_vjp``'s ``_bwd``, XLA's vjp of
    ``_xla_core``). Saves only ``qkv``, the JAX residual."""

    @staticmethod
    def forward(ctx, qkv, heads, dim_head):
        ctx.save_for_backward(qkv)
        ctx.config = (heads, dim_head)
        return _core_forward(qkv, heads, dim_head)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with torch.enable_grad():
            qkv = ctx.saved_tensors[0].detach().requires_grad_()
            out = linear_attention_core_plain(qkv, *ctx.config)
            return torch.autograd.grad(out, qkv, g)[0], None, None


def linear_attention_core(qkv: torch.Tensor, heads: int = HEADS,
                          dim_head: int = DIM_HEAD) -> torch.Tensor:
    """softmax-q / softmax-k linear attention over packed qkv (K4).

    Args:
        qkv: (b, n, 3*heads*dim_head) packed [q | k | v], head-major within
            each third; on a CUDA tensor contiguous bf16 or fp32 with 4
            heads x 32 and any n >= 1.

    Returns:
        (b, n, heads*dim_head) in qkv.dtype.
    """
    return LinearAttentionCoreFn.apply(qkv, heads, dim_head)


linear_attention_core.launches = 0


def _lib():
    return bind(_build.load("linear_attention"))


def _core_lib():
    return bind_core(_build.load("linear_attention_core"))


def _bwd_lib():
    return bind_bwd(_build.load("linear_attention_bwd"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/linear_attention.cu`` (once per library)."""
    if not getattr(lib, "_prgpt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.prgpt_linear_attention.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                               i, i, f, i, p]
        lib.prgpt_linear_attention.restype = i
        lib.prgpt_linear_attention_rows_per_tile.argtypes = [i]
        lib.prgpt_linear_attention_rows_per_tile.restype = i
        lib.prgpt_linear_attention_scratch.argtypes = [i, i]
        lib.prgpt_linear_attention_scratch.restype = ctypes.c_longlong
        lib._prgpt_typed = True
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/linear_attention_bwd.cu`` (once per library)."""
    if not getattr(lib, "_prgpt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.prgpt_linear_attention_bwd.argtypes = [p] * 14 + [i, i, i, f, i,
                                                              p]
        lib.prgpt_linear_attention_bwd.restype = i
        for fn in (lib.prgpt_linear_attention_bwd_fscratch,
                   lib.prgpt_linear_attention_bwd_tscratch):
            fn.argtypes = [i, i, i]
            fn.restype = ctypes.c_longlong
        lib._prgpt_typed = True
    return lib


def bind_core(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/linear_attention_core.cu`` (once per library)."""
    if not getattr(lib, "_prgpt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.prgpt_linear_attention_core.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.prgpt_linear_attention_core.restype = i
        lib.prgpt_linear_attention_core_rows_per_tile.argtypes = []
        lib.prgpt_linear_attention_core_rows_per_tile.restype = i
        lib.prgpt_linear_attention_core_kv_slots.argtypes = [
            i, ctypes.POINTER(i)]
        lib.prgpt_linear_attention_core_kv_slots.restype = i
        lib.prgpt_linear_attention_core_scratch.argtypes = [i, i]
        lib.prgpt_linear_attention_core_scratch.restype = ctypes.c_longlong
        lib._prgpt_typed = True
    return lib


def work(b: int, n: int, c: int, itemsize: int) -> dict:
    """Bytes and operations of one K1 call: x, the weights and the output
    each moved once; per row the three projections and the out projection
    (4 x 128 x c products) and the two context products restricted to the
    four 32x32 head blocks (the rest of C is masked away, so the function
    never needs it)."""
    weights = 4 * HIDDEN * c * itemsize + 2 * c * 4
    return {"bytes": 2 * b * n * c * itemsize + weights,
            "flops": 2 * b * n * (4 * HIDDEN * c
                                  + 2 * HEADS * DIM_HEAD * DIM_HEAD)}


def work_bwd(b: int, n: int, c: int, itemsize: int) -> dict:
    """Bytes and operations that one K3 call needs. Bytes: x and dy read
    once, dx_q and dx_kv written once (itemsize each), the weights read
    once and their gradients written once in fp32. Operations per row:
    the q, k, v and out projections once each, their transposes for dcore,
    dx_q and dx_kv, and the weight gradients dW_out, dW_q, dW_k, dW_v —
    1536 c products in all — plus six context products on the four 32x32
    head blocks (C, q C^, dC^, dqs, v dC^T, ek dC; the per-head softmax
    sums are not counted, as in :func:`work`). The kernel, like
    ``_pallas_fused_bwd``, projects k and v a second time in its kv pass
    (another 256 c per row); the function does not need that, so it is
    not counted."""
    weights = 4 * HIDDEN * c * itemsize + 2 * c * 4
    grads = 4 * HIDDEN * c * 4 + 2 * c * 4
    return {"bytes": 4 * b * n * c * itemsize + weights + grads,
            "flops": 2 * b * n * (12 * HIDDEN * c
                                  + 6 * HEADS * DIM_HEAD * DIM_HEAD)}


def work_core(b: int, n: int, itemsize: int) -> dict:
    """Bytes and operations of one K4 call: packed qkv read once and the
    output written once; per row the two context products on the four
    32x32 head blocks (the rest of C is masked away; the softmaxes are not
    counted, as in :func:`work`)."""
    return {"bytes": b * n * (3 * HIDDEN + HIDDEN) * itemsize,
            "flops": 2 * b * n * 2 * HEADS * DIM_HEAD * DIM_HEAD}


def check_inputs_core(b: int, n: int, dtype: torch.dtype, device,
                      seed: int = 0) -> torch.Tensor:
    """Packed qkv (b, n, 384) that holds K4 against
    :func:`linear_attention_core_plain` by max |got - ref| / max |ref|.

    Zero-mean normals: with a nonzero mean C^ would be v's mean, the same
    for every lane and every kv split. k's spread of 2 makes the softmax
    over n weigh the rows unevenly (about n/e^4 effective rows), so every
    kv split, the running max's rescaling and every lane of C^ move the
    output; q's spread of 2 makes each head's softmax over its 32 lanes
    uneven, so a softmax taken across heads shows too.
    """
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3, HIDDEN))
    x[:, :, :2] *= 2.0
    return torch.tensor(x.reshape(b, n, 3 * HIDDEN), dtype=dtype,
                        device=device)


def check_inputs(b: int, n: int, c: int, dtype: torch.dtype, device,
                 seed: int = 0) -> tuple:
    """``(x, w_qkv, w_out, b_out, g_out)`` at (b, n, c) on which every part
    of the block shows in its output: the inputs that hold the kernel
    against :func:`fused_linear_attention_plain`.

    - x has zero mean and k's weight columns are doubled, so the softmax
      over n weighs the rows differently for each lane (about n/e^4
      effective rows): every lane of C^ and every kv split of the kernel
      moves the output. With a nonzero mean C^ would be v's mean, the same
      for every lane and every split.
    - The core is then O(n^-1.5): 32^-1/2 / n times a weighted mean of
      zero-mean v. ``w_out`` carries n^1.5 to undo that, so the LayerNorm
      sees an O(1) projected core and not its eps; ``b_out`` is O(1) too,
      so a lost bias shows.
    - g of about 0.3 keeps the output inside (-2, 2), where one bf16 step
      is at most 2^-7: an O(1) output on which the kernel's bf16 roundings
      (one or two steps apart from the plain version's where the fp32 sums
      run in another order) stay inside the 3e-2 bound.
    """
    rng = np.random.default_rng(seed)
    w_qkv = rng.normal(size=(c, 3 * HIDDEN)) / np.sqrt(c)
    w_qkv[:, HIDDEN:2 * HIDDEN] *= 2.0
    w_out = rng.normal(size=(HIDDEN, c)) * (
        n**1.5 * np.sqrt(DIM_HEAD / HIDDEN))
    b_out = rng.normal(size=c)
    g_out = 0.3 * (1.0 + 0.1 * rng.normal(size=c))
    x = rng.normal(size=(b, n, c))
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)
    return (t(x, dtype), t(w_qkv, dtype), t(w_out, dtype),
            t(b_out, torch.float32), t(g_out, torch.float32))


def check_inputs_bwd(b: int, n: int, c: int, dtype: torch.dtype, device,
                     seed: int = 0) -> tuple:
    """``(x, dy, w_qkv, w_out, b_out, g_out)`` that hold K3 against
    :func:`fused_linear_attention_bwd_plain`: :func:`check_inputs` (on
    which the core, not the bias, carries the block's output, so every
    gradient term through the core counts) and dy ~ N(0, 1)."""
    x, w_qkv, w_out, b_out, g_out = check_inputs(b, n, c, dtype, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dy = torch.randn(x.shape, generator=gen, device=device).to(dtype)
    return x, dy, w_qkv, w_out, b_out, g_out
