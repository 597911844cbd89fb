"""K5 and K6: 3x3 stride-1 SAME convolutions, each with its plain PyTorch
version, and the conv op that runs K5 forward and backward.

The port of the op layer of the JAX package's two conv tools
(``tools/profile_conv.py``, ``tools/profile_conv_igemm.py``). It keeps their
layout, NHWC activations (b, h, w, c) and HWIO weights (3, 3, cin, cout),
so the same numpy arrays go through both packages and no weight converter
is needed.

- ``conv3x3`` is a ``torch.autograd.Function`` (the port of the JAX
  ``custom_vjp``). Its forward runs K5 (``csrc/conv3x3.cu``, which replaces
  ``_conv3x3_pallas``) on w cast to x.dtype, an implicit GEMM on the
  tensor cores: in bf16 ``csrc/conv3_tc.cuh``, in fp32 three TF32 passes
  in ``csrc/conv3_tf32.cuh`` (on w repacked as (cout, 3, 3, cin)). Its
  backward computes dx as K5 again, on the spatially
  flipped weights with in and out channels swapped, and dw as nine shifted
  (pixels x cin)^T @ (pixels x cout) products in fp32 (``_wgrad``; plain
  matrix products, as the JAX package leaves them to XLA outside any
  Pallas kernel) on a CPU tensor, and by ``conv3_dw`` on a CUDA one.
- ``conv3_igemm`` is K6 (``csrc/conv3_igemm.cu``, which replaces
  ``conv3_igemm``): the same conv as one implicit (pixels x 9 cin) @
  (9 cin x cout) product on the tensor cores, bf16 only, through the same
  ``conv3_tc.cuh`` with ``rows`` output rows per tile.
- ``conv2d`` is the route of the U-Nets' convs (``models/blocks.py``):
  ``F.conv2d`` in every case but the one :func:`k5_route` names, an fp32
  3x3 stride-1 SAME conv of a CUDA tensor, which runs forward and backward
  on hand-written kernels (``Conv2dK5Fn``): K5's fp32 body for y, with the
  bias in its epilogue, and for dx; ``conv3_dw`` (``csrc/conv3_dw.cu``,
  three TF32 passes) for dw and db.

Both bf16 kernels walk their tiles on a persistent grid of one block per
SM; :func:`conv_tiles` is that walk in Python, :func:`dw_walk` the blocks
of ``conv3_dw``.

A CPU tensor takes the plain version (``conv3x3_plain``,
``conv3_igemm_plain``, ``conv3_dw_plain``); a CUDA tensor launches the
kernel or raises. ``conv_shift9``, ``conv_pair`` and ``conv3_blockdiag``
are the tools' other lowerings, plain PyTorch, for the tools to time;
``conv_library`` is ``torch.nn.functional.conv2d`` (cuDNN on the card), the
yardstick the tools time and compare with.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pointreggpt_tpu_torch.ops import _build


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x shifted so out[:, r, c] = x[:, r + dy, c + dx], zero-filled."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def conv_shift9(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Nine shifted (pixels x cin) @ (cin x cout) products accumulated in
    fp32, rounded once to x.dtype (the tool's ``shift9``)."""
    b, h, wd, c = x.shape
    acc = None
    for i in range(3):
        for j in range(3):
            xs = _shift(x, i - 1, j - 1).reshape(b * h * wd, c)
            p = xs.float() @ w[i, j].float()
            acc = p if acc is None else acc + p
    return acc.reshape(b, h, wd, -1).to(x.dtype)


def conv_pair(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Taps paired along channels: four K = 2 cin products and one K = cin
    remainder, fp32 accumulation (the tool's ``pair``)."""
    b, h, wd, c = x.shape
    taps = [(i - 1, j - 1) for i in range(3) for j in range(3)]
    acc = None
    for t0, t1 in zip(taps[0::2], taps[1::2]):
        xs = torch.cat([_shift(x, *t0), _shift(x, *t1)], dim=-1).reshape(
            b * h * wd, 2 * c)
        wk = torch.cat([w[t0[0] + 1, t0[1] + 1], w[t1[0] + 1, t1[1] + 1]],
                       dim=0)
        p = xs.float() @ wk.float()
        acc = p if acc is None else acc + p
    t_last = taps[-1]
    xs = _shift(x, *t_last).reshape(b * h * wd, c)
    acc = acc + xs.float() @ w[t_last[0] + 1, t_last[1] + 1].float()
    return acc.reshape(b, h, wd, -1).to(x.dtype)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5, a port of ``conv3x3_xla``: the products
    of x and w cast to x.dtype, accumulated in fp32, rounded once to
    x.dtype. x (b, h, w, cin), w (3, 3, cin, cout)."""
    return conv_shift9(x, w.to(x.dtype))


def conv_library(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` in x.dtype on the NHWC tensor viewed as channels-last
    NCHW (cuDNN on the card): the tools' yardstick, never called by an op.
    Returns (b, h, w, cout) in x.dtype."""
    wc = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    out = F.conv2d(x.permute(0, 3, 1, 2), wc, padding=1)
    return out.permute(0, 2, 3, 1).contiguous()


def conv3_blockdiag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batch pairs folded into channels, (b, h, w, c) -> (b/2, h, w, 2c),
    with block-diagonal weights, through the library conv (the igemm tool's
    ``blockdiag``): twice the products, twice the contraction depth."""
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    xf = x.reshape(b // 2, 2, h, wd, c).permute(0, 2, 3, 1, 4)
    xf = xf.reshape(b // 2, h, wd, 2 * c)
    wb = torch.zeros((3, 3, 2 * c, 2 * cout), dtype=w.dtype, device=w.device)
    wb[:, :, :c, :cout] = w
    wb[:, :, c:, cout:] = w
    out = conv_library(xf, wb)
    out = out.reshape(b // 2, h, wd, 2, cout).permute(0, 3, 1, 2, 4)
    return out.reshape(b, h, wd, cout)


def _wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw[di, dj] = shifted-x^T @ dy over all pixels, fp32 (3, 3, cin,
    cout): the port of the tool's ``_wgrad``."""
    cin, cout = x.shape[-1], dy.shape[-1]
    dyf = dy.reshape(-1, cout).float()
    parts = [_shift(x, di - 1, dj - 1).reshape(-1, cin).float().T @ dyf
             for di in range(3) for dj in range(3)]
    return torch.stack(parts).reshape(3, 3, cin, cout)


def _cuda_check(what: str, x: torch.Tensor, w, dtypes: tuple) -> None:
    """Raise unless x is a contiguous nonempty (b, h, w, cin) CUDA tensor
    of one of ``dtypes`` and w, where given, a (3, 3, cin, cout) tensor on
    x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {x.dtype} (the kernel takes "
                         f"{', '.join(map(str, dtypes))})")
    if x.dim() != 4 or not x.is_contiguous() or min(x.shape) < 1:
        raise ValueError(f"{what}: x must be a contiguous nonempty (b, h, w, "
                         f"cin) tensor, got {tuple(x.shape)}")
    if w is not None and (w.dim() != 4 or
                          tuple(w.shape[:3]) != (3, 3, x.shape[3])):
        raise ValueError(f"{what}: w must be (3, 3, {x.shape[3]}, cout), got "
                         f"{tuple(w.shape)}")
    if w is not None and w.device != x.device:
        raise ValueError(f"{what}: w on {w.device}, x on {x.device}")
    if x.shape[0] > 65535:
        raise ValueError(f"{what}: batch {x.shape[0]} > 65535")


def _k5(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5 on a CUDA tensor, its plain version on a CPU tensor; w is cast
    to x.dtype."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    _cuda_check("conv3x3", x, w, (torch.bfloat16, torch.float32))
    if x.dtype == torch.float32:
        # the fp32 body reads B^T's rows: w repacked as (cout, 3, 3, cin)
        return _k5_f32(x, w.float().permute(3, 0, 1, 2).contiguous())
    lib = _conv3x3_lib()
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    max_c = lib.prgpt_conv3x3_max_c()
    if not (cin <= max_c and 1 <= cout <= max_c):
        raise ValueError(f"conv3x3: cin={cin}, cout={cout} outside [1, "
                         f"{max_c}]")
    # the cast copy may be freed on return while the launch still runs:
    # the caching allocator hands its memory out again only in stream order
    w = w.to(x.dtype).contiguous()
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    # the launcher reads the current device's limits: make it x's
    with torch.cuda.device(x.device):
        rc = lib.prgpt_conv3x3(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, cin, cout,
            _sms(x.device),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "conv3x3")
    conv3x3.launches += 1
    return out


class Conv3x3Fn(torch.autograd.Function):
    """K5 forward; backward: dx by K5 on the flipped, channel-swapped
    weights, dw by :func:`conv3_dw` in fp32 (the JAX ``custom_vjp`` of
    ``conv3x3``). Saves ``(x, w)``, the JAX residuals."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _k5(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        # dx: full correlation = conv of dy with the spatially flipped
        # weights, in and out channels swapped
        w_flip = w.flip((0, 1)).transpose(2, 3).to(dy.dtype)
        dx = _k5(dy.contiguous(), w_flip)
        dw, _ = conv3_dw(x.float(), dy.float().contiguous(), bias=False)
        return dx.to(x.dtype), dw.permute(1, 2, 3, 0).to(w.dtype)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv, NHWC x HWIO, K5 forward and backward.

    Args:
        x: (b, h, w, cin) activations; on a CUDA tensor contiguous bf16 or
            fp32, with cin and cout up to ``prgpt_conv3x3_max_c`` (4096).
        w: (3, 3, cin, cout) weights, cast to x.dtype inside.

    Returns:
        (b, h, w, cout) in x.dtype.
    """
    return Conv3x3Fn.apply(x, w)


conv3x3.launches = 0

# The route of the U-Nets' convs. Counts since import: convs sent to K5
# (``conv_k5``) and left to ``F.conv2d`` (``conv_library``), and the NHWC
# copies the route made of an input or an incoming gradient that did not
# arrive channels-last (``conv_copies``); the trainers' and the
# generator's spans record their changes (``profiling.span(...,
# counters=ROUTES)``).
ROUTES = {"conv_k5": 0, "conv_library": 0, "conv_copies": 0}


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list, torch.Size)) else (v, v)


def k5_route(device_type: str, dtype: torch.dtype, kernel, stride, padding,
             dilation=1, groups: int = 1) -> bool:
    """Whether :func:`conv2d` runs a conv on the hand-written kernels: an
    fp32 3x3 conv of a CUDA tensor with stride 1, padding 1, dilation 1 and
    one group. The CPU and every other geometry take ``F.conv2d``, and so
    does bf16, where K5's body takes 1.47x cuDNN's time (PERF.md)."""
    return (device_type == "cuda" and dtype == torch.float32
            and _pair(kernel) == (3, 3) and _pair(stride) == (1, 1)
            and _pair(padding) == (1, 1) and _pair(dilation) == (1, 1)
            and groups == 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride=1,
           padding=0) -> torch.Tensor:
    """``F.conv2d(x, w, b, stride, padding)`` (one group, dilation 1) on
    NCHW tensors of one dtype, with each conv that :func:`k5_route` takes
    run forward and backward on the hand-written kernels
    (:class:`Conv2dK5Fn`); counted in :data:`ROUTES`."""
    if k5_route(x.device.type, x.dtype, w.shape[2:], stride, padding):
        ROUTES["conv_k5"] += 1
        return Conv2dK5Fn.apply(x, w, b)
    ROUTES["conv_library"] += 1
    return F.conv2d(x, w, b, stride, padding)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """(b, c, h, w) -> contiguous (b, h, w, c): a view of a channels-last
    tensor, a copy (counted) of any other."""
    v = t.permute(0, 2, 3, 1)
    if v.is_contiguous():
        return v
    ROUTES["conv_copies"] += 1
    return v.contiguous()


def _k5_f32(x: torch.Tensor, wt: torch.Tensor, bias=None) -> torch.Tensor:
    """K5's fp32 body on CUDA tensors: x (b, h, w, cin) and wt (cout, 3,
    3, cin) contiguous, bias (cout,) or None; returns (b, h, w, cout)."""
    if wt.dim() != 4 or tuple(wt.shape[1:]) != (3, 3, x.shape[-1]):
        raise ValueError(f"conv3x3 fp32: weights {tuple(wt.shape)} for x "
                         f"{tuple(x.shape)}")
    _cuda_check("conv3x3 fp32", x, wt.permute(1, 2, 3, 0), (torch.float32,))
    cout = wt.shape[0]
    if (wt.dtype != torch.float32 or not wt.is_contiguous() or
            bias is not None and (bias.dtype != torch.float32 or
                                  tuple(bias.shape) != (cout,) or
                                  bias.device != x.device)):
        raise ValueError("conv3x3 fp32: K5 takes contiguous fp32 weights, "
                         "and an fp32 bias, on x's device")
    lib = _conv3x3_lib()
    b, h, wd, cin = x.shape
    max_c = lib.prgpt_conv3x3_max_c()
    if not (cin <= max_c and cout <= max_c):
        raise ValueError(f"conv3x3 fp32: cin={cin}, cout={cout} above "
                         f"{max_c}")
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.prgpt_conv3x3_f32(
            x.data_ptr(), wt.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), b, h,
            wd, cin, cout, _sms(x.device),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "conv3x3 fp32")
    conv3x3.launches += 1
    return out


class Conv2dK5Fn(torch.autograd.Function):
    """An fp32 3x3 SAME conv of NCHW tensors on the hand-written kernels:
    y by K5, the bias added in its epilogue; backward: dx by K5 on the
    weights flipped in space with in and out channels swapped, dw and db by
    :func:`conv3_dw`. x is taken as NHWC (a view of a channels-last
    tensor) and w (cout, cin, 3, 3) as (cout, 3, 3, cin) (a view of a
    channels-last weight); y and dx come back as channels-last views, dw
    in channels-last memory. Saves x as NHWC, and w."""

    @staticmethod
    def forward(ctx, x, w, b):
        xh = _nhwc(x)
        y = _k5_f32(xh, w.permute(0, 2, 3, 1).contiguous(), b)
        ctx.save_for_backward(xh, w)
        return y.permute(0, 3, 1, 2)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        xh, w = ctx.saved_tensors
        gh = _nhwc(dy)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            wt = w.flip((2, 3)).permute(1, 2, 3, 0).contiguous()
            dx = _k5_f32(gh, wt).permute(0, 3, 1, 2)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dwt, db = conv3_dw(xh, gh, bias=ctx.needs_input_grad[2])
            if ctx.needs_input_grad[1]:
                dw = dwt.permute(0, 3, 1, 2)
        return dx, dw, db


DW_TILE_CI, DW_TILE_CO = 32, 64  # channels of conv3_dw's tile (BM, BN)
DW_ROWS, DW_COLS = 4, 32         # pixels of its item (R, C)


def _dw_grid(b: int, h: int, w: int, cin: int, cout: int) -> tuple:
    """(row items, column items, items, input-channel tiles, tiles) of
    ``csrc/conv3_dw.cu``."""
    rows, cols = -(-h // DW_ROWS), -(-w // DW_COLS)
    m_tiles = -(-cin // DW_TILE_CI)
    return (rows, cols, b * rows * cols, m_tiles,
            m_tiles * -(-cout // DW_TILE_CO))


@functools.lru_cache(maxsize=None)
def dw_split(b: int, h: int, w: int, cin: int, cout: int,
             sms: int = 132) -> int:
    """How many runs :func:`conv3_dw` cuts the pixel sum into: of 1 ..
    items, the split whose grid (tiles x splits blocks, one an SM a wave)
    ends soonest, counting a wave as its items a run plus one for the
    block's start and its partial sums' store; the smallest of those."""
    *_, items, _, tiles = _dw_grid(b, h, w, cin, cout)
    return min(range(1, items + 1),
               key=lambda s: (-(-tiles * s // sms) * (-(-items // s) + 1),
                              s))


def dw_walk(b: int, h: int, w: int, cin: int, cout: int,
            splits: int) -> list:
    """The blocks of ``csrc/conv3_dw.cu`` in launch order, by the kernel's
    formulas: block k is tile k % tiles of split k // tiles, a tile's input
    channels fastest; split s takes items [s items / splits, (s + 1) items
    / splits), numbered column fastest, then row, then image. Returns per
    block ``(ci0, co0, split, [(image, y0, x0), ...])``; each block sums
    all nine taps of its tile over its items' DW_ROWS x DW_COLS pixels."""
    rows, cols, items, m_tiles, tiles = _dw_grid(b, h, w, cin, cout)
    walk = []
    for k in range(tiles * splits):
        tile, split = k % tiles, k // tiles
        mine = []
        for it in range(split * items // splits,
                        (split + 1) * items // splits):
            img, rem = divmod(it, rows * cols)
            ry, cx = divmod(rem, cols)
            mine.append((img, ry * DW_ROWS, cx * DW_COLS))
        walk.append(((tile % m_tiles) * DW_TILE_CI,
                     (tile // m_tiles) * DW_TILE_CO, split, mine))
    return walk


def conv3_dw_plain(x: torch.Tensor, g: torch.Tensor) -> tuple:
    """Plain version of :func:`conv3_dw`: (:func:`_wgrad` as (cout, 3, 3,
    cin), g summed over its pixels), fp32."""
    return _wgrad(x, g).permute(3, 0, 1, 2), g.float().sum((0, 1, 2))


def conv3_dw(x: torch.Tensor, g: torch.Tensor, bias: bool = True) -> tuple:
    """The weight and bias gradients of a 3x3 stride-1 SAME conv of x
    whose output's gradient is g (``csrc/conv3_dw.cu``: every product in
    three TF32 passes, fp32 sums, the same bits every run).

    Args:
        x: (b, h, w, cin) input; on a CUDA tensor contiguous fp32.
        g: (b, h, w, cout) gradient of the output, the same.
        bias: compute db too.

    Returns:
        ``(dw, db)``: dw (cout, 3, 3, cin) and db (cout,) (None without
        ``bias``), fp32.
    """
    if x.device.type == "cpu":
        dw, db = conv3_dw_plain(x, g)
        return dw, db if bias else None
    b, h, wd, cin = x.shape
    _cuda_check("conv3_dw", x, None, (torch.float32,))
    if (g.dtype != torch.float32 or g.dim() != 4 or not g.is_contiguous()
            or tuple(g.shape[:3]) != (b, h, wd) or g.device != x.device):
        raise ValueError(f"conv3_dw: g must be a contiguous fp32 (b, h, w, "
                         f"cout) on x's device, got {tuple(g.shape)} "
                         f"{g.dtype}")
    cout = g.shape[-1]
    lib = _dw_lib()
    splits = dw_split(b, h, wd, cin, cout, _sms(x.device))
    dw = torch.empty((cout, 3, 3, cin), dtype=torch.float32, device=x.device)
    db = (torch.empty(cout, dtype=torch.float32, device=x.device)
          if bias else None)
    # the partial sums of each split, added in split order by the library
    scratch = (torch.empty(splits * (9 * cin * cout + cout),
                           dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    with torch.cuda.device(x.device):
        rc = lib.prgpt_conv3_dw(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(),
            None if db is None else db.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, h, wd, cin,
            cout, splits, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "conv3_dw")
    conv3_dw.launches += 1
    return dw, db


conv3_dw.launches = 0


def load(device) -> None:
    """Load the route's two libraries (K5's and ``conv3_dw``'s, building
    them where need be) for a CUDA device: a set-up step, so that no timed
    call is their first."""
    if torch.device(device).type == "cuda":
        _conv3x3_lib()
        _dw_lib()

ROWS = 8  # output rows per tile of K6, as the JAX tool's default


def conv3_igemm_plain(x: torch.Tensor, w: torch.Tensor,
                      rows: int = ROWS) -> torch.Tensor:
    """Plain PyTorch version of K6: the JAX contract (``h % rows == 0``; w
    cast to x.dtype; fp32 accumulation; output in x.dtype) over
    :func:`conv3x3_plain`."""
    assert x.shape[1] % rows == 0, (x.shape, rows)
    return conv3x3_plain(x, w)


def conv3_igemm(x: torch.Tensor, w: torch.Tensor,
                rows: int = ROWS) -> torch.Tensor:
    """3x3 SAME conv as one implicit (pixels x 9c) @ (9c x cout) product
    per block of ``rows`` output rows (K6).

    Args:
        x: (b, h, w, c); on a CUDA tensor contiguous bf16 (the kernel has
            no fp32 version: an fp32 CUDA tensor raises).
        w: (3, 3, c, cout), fp32 in the JAX tool; cast to x.dtype.
        rows: the row block, output rows per tile; must divide h
            (asserted, as in the JAX tool); the kernel takes 1 .. 16.

    Returns:
        (b, h, w, cout) in x.dtype.
    """
    b, h, wd, c = x.shape
    assert h % rows == 0, (x.shape, rows)
    if x.device.type == "cpu":
        return conv3_igemm_plain(x, w, rows)
    _cuda_check("conv3_igemm", x, w, (torch.bfloat16,))
    lib = _igemm_lib()
    max_rows = lib.prgpt_conv3_igemm_max_rows()
    if not 1 <= rows <= max_rows:
        raise ValueError(f"conv3_igemm: rows={rows} outside [1, {max_rows}]")
    cout = w.shape[-1]
    # B = w reshaped to (9c, cout), tap-major then cin, in x.dtype
    wmat = w.reshape(9 * c, cout).to(x.dtype).contiguous()
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.prgpt_conv3_igemm(
            x.data_ptr(), wmat.data_ptr(), out.data_ptr(), b, h, wd, c, cout,
            rows, _sms(x.device),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "conv3_igemm")
    conv3_igemm.launches += 1
    return out


conv3_igemm.launches = 0


def _sms(device: torch.device) -> int:
    """The card's SM count: the persistent grid of the bf16 kernels."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _conv3x3_lib():
    return bind_conv3x3(_build.load("conv3x3"))


def _igemm_lib():
    return bind_igemm(_build.load("conv3_igemm"))


def _dw_lib():
    return bind_dw(_build.load("conv3_dw"))


def bind_conv3x3(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/conv3x3.cu`` (once per library)."""
    if not getattr(lib, "_prgpt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.prgpt_conv3x3.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.prgpt_conv3x3.restype = i
        lib.prgpt_conv3x3_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.prgpt_conv3x3_f32.restype = i
        lib.prgpt_conv3x3_max_c.argtypes = []
        lib.prgpt_conv3x3_max_c.restype = i
        lib._prgpt_typed = True
    return lib


def bind_igemm(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/conv3_igemm.cu`` (once per library)."""
    if not getattr(lib, "_prgpt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.prgpt_conv3_igemm.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        lib.prgpt_conv3_igemm.restype = i
        lib.prgpt_conv3_igemm_max_rows.argtypes = []
        lib.prgpt_conv3_igemm_max_rows.restype = i
        lib._prgpt_typed = True
    return lib


def bind_dw(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/conv3_dw.cu`` (once per library), and check that its tile and
    item are the ones :func:`dw_walk` mirrors."""
    if not getattr(lib, "_prgpt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.prgpt_conv3_dw.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.prgpt_conv3_dw.restype = i
        lib.prgpt_conv3_dw_dims.argtypes = [i]
        lib.prgpt_conv3_dw_dims.restype = i
        dims = tuple(lib.prgpt_conv3_dw_dims(k) for k in range(4))
        if dims != (DW_TILE_CI, DW_TILE_CO, DW_ROWS, DW_COLS):
            raise RuntimeError(f"conv3_dw: the library's tile and item "
                               f"{dims} are not ops/conv.py's")
        lib._prgpt_typed = True
    return lib


K5_TILE_ROWS = 16  # output rows per tile of K5's bf16 path (conv3x3.cu TR)
TILE_N = 64        # output channels per tile (conv3_tc.cuh BN)


def tile_cols(rows: int, cin: int) -> int:
    """Output columns per tile of K5 and K6 (conv3_igemm.cu): 64 up to 4
    rows, 32 up to 8, 16 above, so that a tile fills the block's 256
    pixels (4 warps of 64 whole-row pixels); 16 at any rows where cin > 64,
    whose weights leave room only for the 18 x 18 window. K5's 16-row tiles
    take 16."""
    if cin > 64 or rows > 8:
        return 16
    return 32 if rows > 4 else 64


def conv_tiles(b: int, h: int, w: int, cout: int, tile_rows: int,
               tile_cols: int, bn: int = TILE_N, blocks: int = 132) -> list:
    """The persistent tile walk of ``csrc/conv3_tc.cuh``, by the kernel's
    formula: tiles numbered column fastest, then row tile, image, n tile;
    block g of ``min(tiles, blocks)`` takes tiles g, g + G, ... Returns
    per block its tiles as ``(image, y0, x0, n0)``, in order."""
    col_tiles = -(-w // tile_cols)
    row_tiles = -(-h // tile_rows)
    spatial = b * row_tiles * col_tiles
    tiles = -(-cout // bn) * spatial
    grid = min(tiles, blocks)
    walk = []
    for g in range(grid):
        mine = []
        for t in range(g, tiles, grid):
            n, s = divmod(t, spatial)
            img, s = divmod(s, row_tiles * col_tiles)
            r, c = divmod(s, col_tiles)
            mine.append((img, r * tile_rows, c * tile_cols, n * bn))
        walk.append(mine)
    return walk


def work_conv(b: int, h: int, w: int, cin: int, cout: int,
              itemsize: int) -> dict:
    """Bytes and operations of one 3x3 conv (K5 or K6): x read once, the
    output written once, the weights read once; 2 * 9 * cin * cout
    operations per pixel."""
    return {"bytes": (b * h * w * (cin + cout) + 9 * cin * cout) * itemsize,
            "flops": 2 * b * h * w * cin * cout * 9}


def check_inputs_conv(b: int, h: int, w: int, cin: int, cout: int,
                      dtype: torch.dtype, device, seed: int = 0,
                      w_dtype: torch.dtype = None) -> tuple:
    """``(x, w)`` that hold K5 and K6 against their plain versions by
    max |got - ref| / max |ref|: x ~ N(0, 1) and w ~ N(0, 0.05^2) (the
    tools' draws), zero-mean, so that every tap, every input channel, the
    halo rows and the zero edges each move the output by a share of its
    size. w is in ``w_dtype`` (default: dtype)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin))
    wt = rng.normal(size=(3, 3, cin, cout)) * 0.05
    return (torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(wt, dtype=w_dtype or dtype, device=device))
