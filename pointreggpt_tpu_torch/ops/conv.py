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
  Pallas kernel).
- ``conv3_igemm`` is K6 (``csrc/conv3_igemm.cu``, which replaces
  ``conv3_igemm``): the same conv as one implicit (pixels x 9 cin) @
  (9 cin x cout) product on the tensor cores, bf16 only, through the same
  ``conv3_tc.cuh`` with ``rows`` output rows per tile.

Both bf16 kernels walk their tiles on a persistent grid of one block per
SM; :func:`conv_tiles` is that walk in Python.

A CPU tensor takes the plain version (``conv3x3_plain``,
``conv3_igemm_plain``); a CUDA tensor launches the kernel or raises.
``conv_shift9``, ``conv_pair`` and ``conv3_blockdiag`` are the tools' other
lowerings, plain PyTorch, for the tools to time; ``conv_library`` is
``torch.nn.functional.conv2d`` (cuDNN on the card), the yardstick the tools
time and compare with — no op here calls it.
"""

from __future__ import annotations

import ctypes

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


def _cuda_check(what: str, x: torch.Tensor, w: torch.Tensor,
                dtypes: tuple) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {x.dtype} (the kernel takes "
                         f"{', '.join(map(str, dtypes))})")
    if x.dim() != 4 or not x.is_contiguous() or min(x.shape) < 1:
        raise ValueError(f"{what}: x must be a contiguous nonempty (b, h, w, "
                         f"cin) tensor, got {tuple(x.shape)}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"{what}: w must be (3, 3, {x.shape[3]}, cout), got "
                         f"{tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"{what}: w on {w.device}, x on {x.device}")
    if x.shape[0] > 65535:
        raise ValueError(f"{what}: batch {x.shape[0]} > 65535")


def _k5(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5 on a CUDA tensor, its plain version on a CPU tensor; w is cast
    to x.dtype."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    _cuda_check("conv3x3", x, w, (torch.bfloat16, torch.float32))
    lib = _conv3x3_lib()
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    max_c = lib.prgpt_conv3x3_max_c()
    if not (cin <= max_c and 1 <= cout <= max_c):
        raise ValueError(f"conv3x3: cin={cin}, cout={cout} outside [1, "
                         f"{max_c}]")
    # the cast copy may be freed on return while the launch still runs:
    # the caching allocator hands its memory out again only in stream order.
    # The fp32 body reads B^T's rows: w repacked as (cout, 3, 3, cin)
    w = w.to(x.dtype)
    w = (w if x.dtype == torch.bfloat16 else w.permute(3, 0, 1, 2)
         ).contiguous()
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    rc = lib.prgpt_conv3x3(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h,
                           wd, cin, cout, int(x.dtype == torch.bfloat16),
                           _sms(x.device),
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "conv3x3")
    conv3x3.launches += 1
    return out


class Conv3x3Fn(torch.autograd.Function):
    """K5 forward; backward: dx by K5 on the flipped, channel-swapped
    weights, dw by nine fp32 products (the JAX ``custom_vjp`` of
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
        dw = _wgrad(x, dy)
        return dx.to(x.dtype), dw.to(w.dtype)


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
    rc = lib.prgpt_conv3_igemm(x.data_ptr(), wmat.data_ptr(), out.data_ptr(),
                               b, h, wd, c, cout, rows, _sms(x.device),
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


def bind_conv3x3(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/conv3x3.cu`` (once per library)."""
    if not getattr(lib, "_prgpt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.prgpt_conv3x3.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        lib.prgpt_conv3x3.restype = i
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
