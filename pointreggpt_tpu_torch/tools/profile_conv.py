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
"""

from __future__ import annotations

import sys

import torch

from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.ops import conv as K
from pointreggpt_tpu_torch.tools import device_name, errors, rate, time_ms

SHAPES = [
    (16, 256, 256, 64, 64),    # stage-1 resblock conv (train batch)
    (16, 256, 256, 128, 64),   # stage-1 up-path conv
    (8, 256, 256, 64, 64),     # generation batch
    (16, 128, 128, 128, 128),  # stage-2
]
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


if __name__ == "__main__":
    main()
