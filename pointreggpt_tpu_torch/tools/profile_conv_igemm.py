"""Time the implicit-GEMM 3x3 conv (K6) against the library conv on the
card.

    python -m pointreggpt_tpu_torch.tools.profile_conv_igemm
    IGEMM_BATCHES=8,16 IGEMM_ROWS=8,16 IGEMM_BLOCKDIAG=1 python -m ...

The port of ``tools/profile_conv_igemm.py``: a correctness check at
(2, 32, 32, 64 -> 64), then at 256^2, 64 -> 64 for each batch of
``IGEMM_BATCHES`` (default 8, 16) the library conv (``F.conv2d``, cuDNN)
and K6 (``ops/conv.py::conv3_igemm``, ``csrc/conv3_igemm.cu``) at each row
block of ``IGEMM_ROWS`` (default 8), with times (CUDA events), shares of
the card's dense bf16 peak and K6's error max |got - ref| / max |ref|
against ``conv3_igemm_plain``; with ``IGEMM_BLOCKDIAG`` set also the
library conv on batch pairs folded into channels. :func:`main` returns the
measurements.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.ops import conv as K
from pointreggpt_tpu_torch.tools import device_name, errors, rate, time_ms


def _ints(name: str, default: str) -> tuple:
    return tuple(int(s) for s in os.environ.get(name, default).split(","))


def main(batches=None, rows_list=None, blockdiag=None, size: int = 256,
         iters: int = 10, device=None, seed: int = 0) -> dict:
    """Returns ``{"device", "correctness", "batches": [per-batch dict]}``;
    ``batches``, ``rows_list`` and ``blockdiag`` default to
    ``IGEMM_BATCHES``, ``IGEMM_ROWS`` and ``IGEMM_BLOCKDIAG``."""
    dev = resolve_device(device)
    card = device_name(dev)
    batches = batches or _ints("IGEMM_BATCHES", "8,16")
    rows_list = rows_list or _ints("IGEMM_ROWS", str(K.ROWS))
    if blockdiag is None:
        blockdiag = bool(os.environ.get("IGEMM_BLOCKDIAG"))
    print("device:", card)
    rng = np.random.default_rng(seed)
    w = torch.tensor(rng.normal(0, 0.05, (3, 3, 64, 64)), dtype=torch.float32,
                     device=dev)

    # correctness first (small shape)
    xs = torch.tensor(rng.normal(0, 1, (2, 32, 32, 64)), dtype=torch.bfloat16,
                      device=dev)
    got = K.conv3_igemm(xs, w)
    want = K.conv_library(xs, w)
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    plain = errors(got, K.conv3_igemm_plain(xs, w))
    print(f"correctness: max abs err {err:.4f} (rel {rel:.4f}; against the "
          f"plain version {plain['rel_err']:.1e})")
    assert rel < 0.05, "implicit-GEMM conv mismatch"
    out = {"device": card,
           "correctness": dict(shape=[2, 32, 32, 64, 64],
                               rel_err_library=rel, **plain),
           "batches": []}

    for batch in batches:
        x = torch.tensor(rng.normal(0, 1, (batch, size, size, 64)),
                         dtype=torch.bfloat16, device=dev)
        flops = K.work_conv(batch, size, size, 64, 64, 2)["flops"]
        t_lib = time_ms(lambda: K.conv_library(x, w), dev, iters)
        print(f"b{batch} {size}^2 64->64: library {t_lib:.3f} ms "
              f"({rate(flops, t_lib, dev)})")
        ref = K.conv3_igemm_plain(x, w)
        plain_ms = time_ms(lambda: K.conv3_igemm_plain(x, w), dev, 1)
        row = dict(batch=batch, shape=[batch, size, size, 64, 64],
                   flops=flops, library_ms=t_lib, plain_ms=plain_ms,
                   igemm=[])
        for rows in rows_list:
            e = errors(K.conv3_igemm(x, w, rows=rows), ref)
            t_ig = time_ms(lambda r=rows: K.conv3_igemm(x, w, rows=r), dev,
                           iters)
            row["igemm"].append(dict(rows=rows, ms=t_ig, **e))
            print(f"  igemm rows={rows}: {t_ig:.3f} ms "
                  f"({rate(flops, t_ig, dev)}) err {e['rel_err']:.1e}")
        if blockdiag:
            rel_bd = errors(K.conv3_blockdiag(x[:2], w),
                            K.conv_library(x[:2], w))["rel_err"]
            assert rel_bd < 0.05, f"blockdiag mismatch rel {rel_bd}"
            t_bd = time_ms(lambda: K.conv3_blockdiag(x, w), dev, iters)
            row["blockdiag_ms"] = t_bd
            print(f"  blockdiag c128: {t_bd:.3f} ms (useful "
                  f"{rate(flops, t_bd, dev)})")
        out["batches"].append(row)
        del x, ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
