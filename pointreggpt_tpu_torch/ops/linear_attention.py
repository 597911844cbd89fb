"""K1: the fused LinearAttention block, with its plain PyTorch version.

``fused_linear_attention`` runs the hand-written CUDA kernel
(``csrc/linear_attention.cu``, which replaces
``pointreggpt_tpu/ops/linear_attention.py::_pallas_fused``) for a CUDA
tensor and ``fused_linear_attention_plain`` for a CPU tensor. There is no
fallback: a CUDA tensor the kernel does not take raises.

Block body: qkv projection -> softmax-q (over d per head) / softmax-k (over
n) linear attention core -> out projection + bias -> channel LayerNorm
(scale only, biased variance). heads = 4, dim_head = 32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pointreggpt_tpu_torch.ops import _build

HEADS = 4
DIM_HEAD = 32
HIDDEN = HEADS * DIM_HEAD
_TARGET_BLOCKS = 2 * 2 * 132  # keep ~2x the SMs busy in the kv phase


def _core_plain(qkv: torch.Tensor, heads: int, dim_head: int
                ) -> torch.Tensor:
    """Port of ``_xla_core``: (b, n, 3*h*d) packed [q | k | v] ->
    (b, n, h*d), qkv.dtype; products accumulate in fp32."""
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
    dtype = x.dtype
    qkv = (x.float() @ w_qkv.to(dtype).float()).to(dtype)
    core = _core_plain(qkv, heads, dim_head)
    out = (core.float() @ w_out.to(dtype).float()).to(dtype) + \
        b_out.to(dtype)
    xf = out.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    ln = (xf - mean) * torch.rsqrt(var + eps) * g_out.float()
    return ln.to(dtype)


def _splits(b: int, n: int, rows: int):
    """(splits, rows_per_split) for the kv phase: enough blocks to fill the
    card, each a whole number of row tiles."""
    tiles = -(-n // rows)
    splits = max(1, min(tiles, -(-_TARGET_BLOCKS // b)))
    tiles_per_split = -(-tiles // splits)
    return -(-tiles // tiles_per_split), tiles_per_split * rows


def fused_linear_attention(x, w_qkv, w_out, b_out, g_out,
                           heads: int = HEADS, dim_head: int = DIM_HEAD,
                           eps: float = 1e-5) -> torch.Tensor:
    """LinearAttention block body (K1); add the residual outside.

    A CPU tensor takes :func:`fused_linear_attention_plain`; a CUDA tensor
    launches the kernel or raises. Returns (b, n, c) in x.dtype.
    """
    if x.device.type == "cpu":
        return fused_linear_attention_plain(x, w_qkv, w_out, b_out, g_out,
                                            heads, dim_head, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_linear_attention: unsupported device "
                         f"{x.device}")
    if (heads, dim_head) != (HEADS, DIM_HEAD):
        raise ValueError("fused_linear_attention kernel is built for 4 heads "
                         f"x 32, got {heads} x {dim_head}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_linear_attention: dtype {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_linear_attention: x must be a contiguous "
                         "(b, n, c) tensor")
    b, n, c = x.shape
    if not 1 <= c <= 2048:
        raise ValueError(f"fused_linear_attention: c={c} outside [1, 2048]")
    w_qkv = w_qkv.to(x.dtype).contiguous()
    w_out = w_out.to(x.dtype).contiguous()
    b_out = b_out.float().contiguous()
    g_out = g_out.float().contiguous()
    if w_qkv.shape != (c, 3 * HIDDEN) or w_out.shape != (HIDDEN, c) or \
            b_out.shape != (c,) or g_out.shape != (c,):
        raise ValueError("fused_linear_attention: weight shapes "
                         f"{tuple(w_qkv.shape)} {tuple(w_out.shape)} "
                         f"{tuple(b_out.shape)} {tuple(g_out.shape)} do not "
                         f"match c={c}")
    for t in (w_qkv, w_out, b_out, g_out):
        if t.device != x.device:
            raise ValueError("fused_linear_attention: weights on "
                             f"{t.device}, x on {x.device}")

    lib = _lib()
    splits, rows_per_split = _splits(
        b, n, lib.prgpt_linear_attention_rows_per_tile())
    # scratch and the weight copies may be freed on return while the
    # launches still run: the caching allocator hands their memory out
    # again only in the order of this stream
    scratch = torch.empty(lib.prgpt_linear_attention_scratch(b, splits),
                          dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    rc = lib.prgpt_linear_attention(
        x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        g_out.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, n, c,
        splits, rows_per_split, float(eps), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "fused_linear_attention")
    fused_linear_attention.launches += 1
    return out


fused_linear_attention.launches = 0


def _lib():
    return bind(_build.load("linear_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/linear_attention.cu`` (once per library)."""
    if not getattr(lib, "_prgpt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.prgpt_linear_attention.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                               i, i, f, i, p]
        lib.prgpt_linear_attention.restype = i
        lib.prgpt_linear_attention_rows_per_tile.argtypes = []
        lib.prgpt_linear_attention_rows_per_tile.restype = i
        lib.prgpt_linear_attention_scratch.argtypes = [i, i]
        lib.prgpt_linear_attention_scratch.restype = ctypes.c_longlong
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
