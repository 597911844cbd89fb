"""GroupNorm and the work that follows it, on channels-last tensors: the
U-Nets' norm chain (``models/blocks.py::Block``; ADM's ``GroupNorm32`` in
its ResBlocks, attention blocks and output head).

:func:`group_norm_act` computes, for x (b, c, h, w) and ``groups`` groups,
in fp32: GroupNorm (biased variance) with the affine ``weight``, ``bias``;
then, where given, ``* (scale + 1) + shift`` with scale and shift per
(image, channel); then, with ``silu``, SiLU; and rounds once to
``out_dtype``. Its route:

- the kernel (``csrc/group_norm.cu``: the statistics and the whole epilogue
  in two launches that read and write NHWC) for a CUDA tensor of the
  bodies it has (bf16 in, bf16 or fp32 out; fp32 in and out; groups of
  whole 16-byte vectors) when autograd records nothing: grad mode off, or
  no input that requires grad. Generation, the Tester, FID's sampling, the trainers'
  sample grids and the MaskTrainer's validation run so. An input that is
  not channels-last, or does not start on 16 bytes, costs one copy
  (``norm_copies``); the output is channels-last;
- :func:`group_norm_act_plain`, the expressions the nets wrote before the
  kernel (``F.group_norm`` in fp32 and PyTorch's elementwise ops), for
  everything else: a CPU tensor, a training forward, remat's recompute, a
  shape or dtype it has no body for. The kernel has no backward.

The choice reads only the inputs' device, dtypes, shape and the grad mode;
the kernel's tiles follow c, groups and h * w (:func:`plan`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from pointreggpt_tpu_torch.ops import _build

Tensor = torch.Tensor

# The route of the nets' GroupNorms. Counts since import: calls the kernel
# ran (``norm_fused``, counted where it launched) and calls on the plain
# version (``norm_plain``), and the NHWC copies made of an input that was
# not channels-last or not 16-byte aligned (``norm_copies``); generation's
# and the trainers' spans record their changes (``ops/routes.py``).
ROUTES = {"norm_fused": 0, "norm_plain": 0, "norm_copies": 0}

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (x, y) dtypes the kernel has bodies for, and the most threads a pixel of
# each x: bf16 8 channels a thread, fp32 4 (16-byte loads)
_BODIES = {(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
           (torch.float32, torch.float32)}
_MAX_T = {torch.bfloat16: 256, torch.float32: 1024}
THREADS = 256       # threads a block, about (at most 1024 where c / vec
                    # is above 256)
STATS_BLOCKS = 4    # blocks of the statistics an SM, about
SPLIT_BYTES = 32768  # bytes of x a block of the statistics reads, at least
TILE_BYTES = 32768  # bytes of x an apply block reads, about


def group_norm_act_plain(x: Tensor, groups: int, weight: Optional[Tensor],
                         bias: Optional[Tensor], eps: float,
                         scale: Optional[Tensor] = None,
                         shift: Optional[Tensor] = None, silu: bool = True,
                         out_dtype: torch.dtype = torch.float32) -> Tensor:
    """The plain version: ``F.group_norm`` of x in fp32, ``* (scale + 1) +
    shift`` in fp32, SiLU in fp32, then ``out_dtype``. scale and shift
    broadcast against x, (b, c, 1, 1)."""
    y = F.group_norm(x.float(), groups, weight, bias, eps)
    if scale is not None:
        y = y * (scale.float() + 1.0) + shift.float()
    if silu:
        y = F.silu(y)
    return y.to(out_dtype)


def takes(c: int, groups: int, dtype: torch.dtype,
          out_dtype: torch.dtype) -> bool:
    """Whether the kernel has a body for x of ``dtype`` with c channels in
    ``groups`` groups, written in ``out_dtype``: bf16 to bf16 or fp32, or
    fp32 to fp32, each group whole 16-byte vectors wide (8 bf16 or 4 fp32
    channels, as every group of the nets is), at most :data:`_MAX_T`
    threads a pixel."""
    if (dtype, out_dtype) not in _BODIES or c < 1 or groups < 1 or \
            c % groups:
        return False
    vec = 16 // dtype.itemsize
    return (c // groups) % vec == 0 and c // vec <= _MAX_T[dtype]


def fused_route(x: Tensor, groups: int, weight: Optional[Tensor],
                bias: Optional[Tensor], scale: Optional[Tensor],
                shift: Optional[Tensor],
                out_dtype: torch.dtype = torch.float32) -> bool:
    """Whether :func:`group_norm_act` runs the kernel: x (b, c, h, w) on the
    card, not empty, of a shape and dtypes :func:`takes`, scale and shift
    in bf16 or fp32, the affine fp32, and nothing that autograd would
    record."""
    if x.device.type != "cuda" or x.dim() != 4 or x.numel() == 0 or \
            not takes(x.shape[1], groups, x.dtype, out_dtype):
        return False
    if any(t is not None and t.dtype != torch.float32
           for t in (weight, bias)):
        return False
    ts = [t for t in (weight, bias, scale, shift) if t is not None]
    if any(t.dtype not in _KERNEL_DTYPES for t in ts):
        return False
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (x, *ts)))


def group_norm_act(x: Tensor, groups: int, weight: Optional[Tensor],
                   bias: Optional[Tensor], eps: float,
                   scale: Optional[Tensor] = None,
                   shift: Optional[Tensor] = None, silu: bool = True,
                   out_dtype: torch.dtype = torch.float32) -> Tensor:
    """GroupNorm of x (b, c, h, w) in fp32, then ``* (scale + 1) + shift``
    (scale and shift (b, c, 1, 1), or None), SiLU where ``silu``, rounded
    once to ``out_dtype``: on the kernel where :func:`fused_route` says so,
    else the plain version; counted in :data:`ROUTES`."""
    if (scale is None) != (shift is None):
        raise ValueError("group_norm_act: scale and shift go together")
    if fused_route(x, groups, weight, bias, scale, shift, out_dtype):
        return _fused(x, groups, weight, bias, eps, scale, shift, silu,
                      out_dtype)
    ROUTES["norm_plain"] += 1
    return group_norm_act_plain(x, groups, weight, bias, eps, scale, shift,
                                silu, out_dtype)


@functools.lru_cache(maxsize=1024)
def plan(b: int, hw: int, c: int, groups: int, itemsize: int,
         sms: int = 132) -> dict:
    """The kernel's launch: ``vec`` channels a thread (16 bytes' worth), a
    block of ``c / vec`` x ``by`` threads (``by`` pixel rows at once); the statistics cut
    each image into ``splits`` runs of ``span`` pixels (a multiple of
    ``by``), about :data:`STATS_BLOCKS` blocks an SM in all but none under
    :data:`SPLIT_BYTES` where the image has them; the apply pass
    cuts each split into ``tiles`` tiles of ``tile`` pixels (a multiple of
    ``by``, about :data:`TILE_BYTES` of x)."""
    vec = 16 // itemsize
    if c % groups or (c // groups) % vec:
        raise ValueError(f"group_norm: {c} channels in {groups} groups, "
                         f"not whole vectors of {vec}")
    t = c // vec
    if t > 1024:
        raise ValueError(f"group_norm: {c} channels at {vec} a thread need "
                         f"{t} threads a pixel, over 1024")
    by = max(1, THREADS // t)
    rows = -(-hw // by)  # rows of threads an image
    per = -(-STATS_BLOCKS * sms // b)  # splits an image, wanted
    least = -(-SPLIT_BYTES // (by * c * itemsize))  # rows of a split, least
    span = by * min(rows, max(least, -(-rows // per)))
    tile = min(span, by * max(1, TILE_BYTES // (by * c * itemsize)))
    return {"vec": vec, "by": by, "span": span, "splits": -(-hw // span),
            "tile": tile, "tiles": -(-span // tile)}


# (channels, image side, groups, calls a forward) of the nets' GroupNorms
# at 256^2: the dim-64 DiffusionUNet's and MaskUNet's 38, ADM's 101
DIM64_SHAPES = [(64, 256, 8, 10), (64, 128, 8, 4), (128, 128, 8, 4),
                (128, 64, 8, 4), (256, 64, 8, 4), (256, 32, 8, 4),
                (512, 32, 8, 8)]
ADM_SHAPES = [(256, 256, 32, 10), (512, 256, 32, 3), (256, 128, 32, 10),
              (512, 128, 32, 3), (768, 128, 32, 1), (256, 64, 32, 2),
              (512, 64, 32, 9), (768, 64, 32, 1), (1024, 64, 32, 2),
              (512, 32, 32, 15), (1024, 32, 32, 3), (1536, 32, 32, 1),
              (512, 16, 32, 2), (1024, 16, 32, 14), (1536, 16, 32, 1),
              (2048, 16, 32, 2), (1024, 8, 32, 19), (2048, 8, 32, 3)]


def check_inputs(b: int, c: int, h: int, w: int, groups: int,
                 dtype: torch.dtype, device, seed: int = 0) -> tuple:
    """``(x, gamma, beta, scale, shift)`` that hold the kernel against the
    plain version: x (b, c, h, w) channels-last with a mean in (-2, 2) and
    a spread in (0.3, 3) of its own per (image, group), so that statistics
    of the wrong group or image move the output, and a ramp down the
    pixels, so that statistics of part of the image do; gamma in (0.5,
    1.5) and beta ~ N(0, 0.2^2), fp32; scale and shift ~ N(0, 0.3^2) in
    dtype, (b, c, 1, 1) views of one (b, 2 c) embedding, as the nets
    chunk it."""
    g = torch.Generator(device=device).manual_seed(seed)

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, device=device)

    mu = uni(-2, 2, b, groups, 1, 1, 1)
    sd = uni(0.3, 3, b, groups, 1, 1, 1)
    ramp = torch.linspace(-1.5, 1.5, h * w, device=device).reshape(h, w)
    x = mu + sd * (torch.randn(b, groups, c // groups, h, w, generator=g,
                               device=device) + ramp)
    x = x.reshape(b, c, h, w).to(dtype).contiguous(
        memory_format=torch.channels_last)
    gamma = uni(0.5, 1.5, c)
    beta = 0.2 * torch.randn(c, generator=g, device=device)
    emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=device)).to(dtype)
    scale, shift = emb[:, :, None, None].chunk(2, dim=1)
    return x, gamma, beta, scale, shift


def work_group_norm(b: int, hw: int, c: int, in_itemsize: int,
                    out_itemsize: int) -> dict:
    """Bytes of the kernel's bound: x read once, y written once (the
    parameters are a few KB)."""
    return {"bytes": b * hw * c * (in_itemsize + out_itemsize), "flops": 0}


# the counters from which the statistics' last block of each image knows
# itself (b of them, zero before a call and after it), per (device,
# stream) and per CUDA graph capture: see _done
_DONE = {}


def _done(device: torch.device, stream, b: int) -> Tensor:
    """The counters of a call on ``stream``. Calls on one stream run one
    after another, and each leaves the counters zero for the next; calls on
    two streams at once have a set each. The calls captured into one CUDA
    graph share a set of their own, zeroed by a fill captured before the
    first of them, so that each replay starts from zero and neither the
    graph nor eager work on its stream sees the other's counts (one graph
    replayed on two streams at once would share them, as it shares all its
    buffers). A launch cut off mid-kernel leaves them unfinished only
    through a device fault, after which the process runs no kernel."""
    key, capture = (device, stream.cuda_stream), 0
    if torch.cuda.is_current_stream_capturing():
        key += ("graph",)
        capture = _lib().prgpt_capture_id(stream.cuda_stream)
    done, seen = _DONE.get(key, (None, 0))
    if done is None or done.numel() < b or seen != capture:
        done = torch.zeros(max(b, 64), dtype=torch.int32, device=device)
        _DONE[key] = (done, capture)
    return done


def _rows_of(t: Tensor, b: int, c: int) -> Tensor:
    """scale or shift as (b, c) rows with unit channel stride."""
    if t.numel() != b * c:
        raise ValueError(f"group_norm: scale / shift of {tuple(t.shape)} "
                         f"for {b} images of {c} channels")
    r = t.reshape(b, c)
    return r if r.stride(1) == 1 else r.contiguous()


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fused(x, groups, weight, bias, eps, scale, shift, silu, out_dtype):
    """The kernel on x (b, c, h, w) that :func:`fused_route` took: two
    launches, counted in ``group_norm_act.launches`` and ``norm_fused``
    once the launcher has returned success."""
    b, c, h, w = x.shape
    out = torch.empty((b, h, w, c), dtype=out_dtype,
                      device=x.device).permute(0, 3, 1, 2)
    v = x.permute(0, 2, 3, 1)
    if not v.is_contiguous() or v.data_ptr() % 16:
        ROUTES["norm_copies"] += 1
        v = torch.empty_like(v, memory_format=torch.contiguous_format).copy_(v)
    p = plan(b, h * w, c, groups, v.element_size(), _sms(x.device))
    work = torch.empty(2 * (b * p["splits"] + b) * groups,
                       dtype=torch.float32, device=x.device)
    params = [None if t is None else t.contiguous() for t in (weight, bias)]
    ss = [None if t is None else _rows_of(t, b, c) for t in (scale, shift)]
    if ss[0] is not None and ss[0].dtype != ss[1].dtype:
        ss[1] = ss[1].to(ss[0].dtype)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(x.device)
    with torch.cuda.device(x.device):
        rc = _lib().prgpt_group_norm(
            v.data_ptr(), out.data_ptr(), ptr(params[0]), ptr(params[1]),
            ptr(ss[0]), ptr(ss[1]), 0 if ss[0] is None else ss[0].stride(0),
            0 if ss[1] is None else ss[1].stride(0),
            0 if ss[0] is None else _DTYPE_CODE[ss[0].dtype],
            work.data_ptr(), _done(x.device, stream, b).data_ptr(), b,
            h * w, c,
            groups, p["vec"], p["by"], p["span"], p["tile"],
            _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[out_dtype], int(silu), eps, stream.cuda_stream)
    _build.check(rc, "group_norm")
    group_norm_act.launches += 2
    ROUTES["norm_fused"] += 1
    return out


group_norm_act.launches = 0


def _lib():
    return bind(_build.load("group_norm"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of a library built from
    ``csrc/group_norm.cu`` (once per library)."""
    if not getattr(lib, "_prgpt_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.prgpt_group_norm.argtypes = [
            p, p, p, p, p, p, ll, ll, i, p, p, i, ll, i, i, i, i, i, i, i,
            i, i, ctypes.c_float, p]
        lib.prgpt_group_norm.restype = i
        lib.prgpt_capture_id.argtypes = [p]
        lib.prgpt_capture_id.restype = ctypes.c_ulonglong
        lib._prgpt_typed = True
    return lib
