"""Compare 3x3 conv lowerings at the U-Net's hot conv shapes on the card.

    python -m pointreggpt_tpu_torch.tools.profile_conv

The port of ``tools/profile_conv.py``. Variants per shape (NHWC, bf16,
3x3 SAME):

  conv    — the library conv, ``F.conv2d`` (cuDNN) on channels-last views
  shift9  — nine shifted (M, K) @ (K, N) products accumulated (K = cin)
  pair    — taps paired along the channel axis: 4 products with K = 2 cin
            and one K = cin remainder
  kernel  — K5 (``ops/conv.py::conv3x3``, ``csrc/conv3x3.cu``)

each with its time (CUDA events), its rate and share of the card's dense
bf16 peak, and its error max |got - ref| / max |ref| against
``conv3x3_plain``. Then forward + backward through ``conv3x3`` (K5 for y
and dx, fp32 products for dw, timed alone too) against autograd of the
library conv, and the gradients' errors against autograd of
``conv3x3_plain``. Lines go to
stderr; :func:`main` returns the measurements.

:func:`mask_main` times the route of the fp32 MaskUNet's 3x3 convs
(``ops/conv.py::conv2d``) at each of their shapes at the MaskTrainer's
batch of 4: the weight and bias gradient kernel ``conv3_dw`` beside its
bound (three TF32 passes' operations at 494.7 TFLOP/s, or the bytes at
3.35 TB/s), the plain ``_wgrad`` and cuDNN's fp32 weight gradient (TF32
off), and K5's fp32 forward (with the bias) and dx beside cuDNN's; the
gaps of each of the three, and of cuDNN's, to fp64. Run as a module, it
runs both.
"""

from __future__ import annotations

import sys

import torch

from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.ops import conv as K
from pointreggpt_tpu_torch.tools import device_name, errors, rate, time_ms

PEAK_TF32 = 494.7e12   # H100 SXM dense TF32 tensor-core rate, FLOP/s
HBM = 3.35e12          # its device memory, bytes/s

SHAPES = [
    (16, 256, 256, 64, 64),    # stage-1 resblock conv (train batch)
    (16, 256, 256, 128, 64),   # stage-1 up-path conv
    (8, 256, 256, 64, 64),     # generation batch
    (16, 128, 128, 128, 128),  # stage-2
]
# (b, h, w, cin, cout) of the fp32 MaskUNet's 3x3 convs at the
# MaskTrainer's batch (dim 64, mults 1, 2, 4, 8, 256^2), each shape once
MASK_SHAPES = [(4, h, h, cin, cout) for h, cin, cout in (
    (256, 64, 64), (256, 128, 64), (128, 64, 64), (128, 192, 128),
    (128, 128, 128), (128, 256, 128), (64, 128, 128), (64, 384, 256),
    (64, 256, 256), (64, 512, 256), (32, 256, 256), (32, 256, 512),
    (32, 512, 512), (32, 768, 512))]
VARIANTS = {"conv": K.conv_library, "shift9": K.conv_shift9,
            "pair": K.conv_pair, "kernel": K.conv3x3}


def log(m: str) -> None:
    print(m, file=sys.stderr, flush=True)


def grads(fn, x: torch.Tensor, w: torch.Tensor) -> tuple:
    """(dx, dw) of sum(fn(x, w)^2) in fp32, the tool's loss."""
    xx = x.detach().requires_grad_()
    ww = w.detach().requires_grad_()
    (fn(xx, ww).float() ** 2).sum().backward()
    return xx.grad, ww.grad


def main(shapes=SHAPES, iters: int = 5, device=None, seed: int = 0) -> dict:
    """Run every variant at each (b, h, w, cin, cout) of ``shapes``;
    returns ``{"device": name, "shapes": [per-shape dict]}``."""
    dev = resolve_device(device)
    card = device_name(dev)
    log(f"device={card}")
    rows = []
    for (b, h, w_, cin, cout) in shapes:
        x, w = K.check_inputs_conv(b, h, w_, cin, cout, torch.bfloat16, dev,
                                   seed)
        flops = K.work_conv(b, h, w_, cin, cout, 2)["flops"]
        tag = f"({b},{h},{w_},{cin}->{cout})"
        with torch.no_grad():
            ref = K.conv3x3_plain(x, w)
            row = dict(shape=[b, h, w_, cin, cout], flops=flops)
            for name, fn in VARIANTS.items():
                err = errors(fn(x, w), ref)
                ms = time_ms(lambda: fn(x, w), dev, iters)
                row[name] = dict(ms=ms, **err)
                log(f"{tag} {name}: {ms:.3f} ms ({rate(flops, ms, dev)}) "
                    f"err {err['rel_err']:.1e}")
            plain_ms = time_ms(lambda: K.conv3x3_plain(x, w), dev, 1)
        row["plain_ms"] = plain_ms
        # fwd + bwd: conv3x3 (K5 forward and dx, fp32 wgrad) against
        # autograd of the library conv; gradients against autograd of the
        # plain version
        g_ref = grads(K.conv3x3_plain, x, w)
        g_k = grads(K.conv3x3, x, w)
        row["grad_rel_err"] = dict(
            dx=errors(g_k[0], g_ref[0])["rel_err"],
            dw=errors(g_k[1], g_ref[1])["rel_err"])
        del g_ref, g_k
        t_cv = time_ms(lambda: grads(K.conv3x3, x, w), dev, iters)
        t_ad = time_ms(lambda: grads(K.conv_library, x, w), dev, iters)
        # dw alone: the nine fp32 products of conv3x3's backward
        dy = torch.ones((b, h, w_, cout), dtype=x.dtype, device=dev)
        t_wg = time_ms(lambda: K._wgrad(x, dy), dev, iters)
        row["fwd_bwd"] = dict(conv3x3_ms=t_cv, library_autograd_ms=t_ad,
                              wgrad_ms=t_wg)
        log(f"{tag} fwd+bwd: conv3x3 {t_cv:.3f} ms (dw {t_wg:.3f}) vs "
            f"library autograd {t_ad:.3f} ms ({card}); grad err dx "
            f"{row['grad_rel_err']['dx']:.1e} dw "
            f"{row['grad_rel_err']['dw']:.1e}")
        del dy
        rows.append(row)
        del x, w, ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"device": card, "shapes": rows}


def bound_ms(b: int, h: int, w: int, cin: int, cout: int) -> float:
    """The least time of one fp32 conv product set on the card: three TF32
    passes' operations at the TF32 rate, or its bytes (``work_conv``)."""
    wk = K.work_conv(b, h, w, cin, cout, 4)
    return max(3 * wk["flops"] / PEAK_TF32, wk["bytes"] / HBM) * 1e3


def _gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.double() - ref).norm() / ref.norm()).item()


def mask_main(shapes=MASK_SHAPES, iters: int = 5, device=None,
              seed: int = 0) -> dict:
    """Time the route's kernels and their yardsticks at each (b, h, w,
    cin, cout) of ``shapes`` in fp32 with TF32 off; returns ``{"device":
    name, "shapes": [per-shape dict], "launches": ...}``."""
    dev = resolve_device(device)
    card = device_name(dev)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = (K.conv3x3.launches, K.conv3_dw.launches)
    rows = []
    try:
        for (b, h, w_, cin, cout) in shapes:
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = torch.randn((b, h, w_, cin), generator=gen, device=dev)
            g = torch.randn((b, h, w_, cout), generator=gen, device=dev)
            wt = torch.randn((cout, 3, 3, cin), generator=gen,
                             device=dev) * 0.05
            bias = torch.randn(cout, generator=gen, device=dev)
            xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            wc = wt.permute(0, 3, 1, 2)

            def lib_dw(xc=xc, gc=gc, wc=wc):
                return torch.ops.aten.convolution_backward(
                    gc, xc, wc, [cout], [1, 1], [1, 1], [1, 1], False,
                    [0, 0], 1, [False, True, True])

            def lib_dx(xc=xc, gc=gc, wc=wc):
                return torch.ops.aten.convolution_backward(
                    gc, xc, wc, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                    1, [True, False, False])

            row = dict(shape=[b, h, w_, cin, cout],
                       split=K.dw_split(b, h, w_, cin, cout),
                       bound_ms=bound_ms(b, h, w_, cin, cout))
            if dev.type == "cuda":
                wflip = wc.flip((2, 3)).permute(1, 2, 3, 0).contiguous()
                row["dw_ms"] = time_ms(lambda: K.conv3_dw(x, g), dev, iters)
                row["fwd_ms"] = time_ms(lambda: K._k5_f32(x, wt, bias), dev,
                                        iters)
                row["dx_ms"] = time_ms(lambda: K._k5_f32(g, wflip), dev,
                                       iters)
            row["wgrad_plain_ms"] = time_ms(lambda: K._wgrad(x, g), dev, 1)
            row["library_dw_ms"] = time_ms(lib_dw, dev, iters)
            row["library_fwd_ms"] = time_ms(
                lambda: torch.nn.functional.conv2d(xc, wc, bias, padding=1),
                dev, iters)
            row["library_dx_ms"] = time_ms(lib_dx, dev, iters)
            if "dw_ms" in row:
                row["dw_bound_pct"] = 100 * row["bound_ms"] / row["dw_ms"]
                # the gaps to fp64 of both weight gradients
                _, ref_w, ref_b = torch.ops.aten.convolution_backward(
                    gc.double(), xc.double(), wc.double(), [cout], [1, 1],
                    [1, 1], [1, 1], False, [0, 0], 1, [False, True, True])
                dw, db = K.conv3_dw(x, g)
                _, lw, lb = lib_dw()
                row["dw_gap"] = _gap(dw.permute(0, 3, 1, 2), ref_w)
                row["db_gap"] = _gap(db, ref_b)
                row["library_dw_gap"] = _gap(lw, ref_w)
                row["library_db_gap"] = _gap(lb, ref_b)
                del ref_w, ref_b, dw, db, lw, lb
                # the gaps to fp64 of K5's forward (with the bias) and dx,
                # and of cuDNN's
                ref = torch.nn.functional.conv2d(
                    xc.double(), wc.double(), bias.double(), padding=1)
                row["fwd_gap"] = _gap(
                    K._k5_f32(x, wt, bias).permute(0, 3, 1, 2), ref)
                row["library_fwd_gap"] = _gap(torch.nn.functional.conv2d(
                    xc, wc, bias, padding=1), ref)
                ref = torch.ops.aten.convolution_backward(
                    gc.double(), xc.double(), wc.double(), None, [1, 1],
                    [1, 1], [1, 1], False, [0, 0], 1, [True, False, False])[0]
                row["dx_gap"] = _gap(K._k5_f32(g, wflip).permute(0, 3, 1, 2),
                                     ref)
                row["library_dx_gap"] = _gap(lib_dx()[0], ref)
                del ref
            log(f"({b},{h},{w_},{cin}->{cout}) split {row['split']}: "
                + ", ".join(f"{k} {v:.4g}" for k, v in row.items()
                            if isinstance(v, float)) + f" ({card})")
            rows.append(row)
            del x, g, wt, bias, xc, gc, wc
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    return {"device": card, "shapes": rows,
            "launches": {"conv3x3": K.conv3x3.launches - launches[0],
                         "conv3_dw": K.conv3_dw.launches - launches[1]}}


if __name__ == "__main__":
    main()
    mask_main()
