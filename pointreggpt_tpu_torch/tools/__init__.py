"""Profiling tools of the port (``python -m pointreggpt_tpu_torch.tools.<name>``)
and what they share: timing, the card's peak rate and the launch and route
counters; and ``synthetic_3dmatch``, the synthetic 3DMatch trees of the tests.

Nothing here runs at import: the CPU tests import every module freely.
"""

from __future__ import annotations

import time

import torch

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core rate, FLOP/s


def time_ms(fn, device: torch.device, iters: int, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn`` after ``warmup`` calls: CUDA events
    around ``iters`` calls on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / iters


def device_name(device: torch.device) -> str:
    """The card's name, or ``cpu``: every line a tool prints names it."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def rate(flops: int, ms: float, device: torch.device) -> str:
    """The rate of a timed call and its share of the card's dense bf16
    peak, with the card's name; on the CPU only that the host clock timed
    it (no device metric comes from a CPU run)."""
    if device.type != "cuda":
        return "host clock, cpu"
    return (f"{flops / ms / 1e9:.1f} TF/s, "
            f"{100 * flops / ms / 1e-3 / PEAK_BF16:.1f}% of 989 TF/s dense "
            f"bf16, {device_name(device)}")


def errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """``rel_err`` = max |got - ref| / max |ref| and ``max_abs_err`` =
    max |got - ref|, in fp32."""
    ref = ref.float()
    abs_err = (got.float() - ref).abs().max().item()
    return dict(rel_err=abs_err / max(ref.abs().max().item(), 1e-30),
                max_abs_err=abs_err)


def counters() -> dict:
    """The port's launch counters now (K1 to K6, ``conv3_dw`` and the
    GroupNorm kernel, ``gn``), K1's and K3's calls routed to the plain
    version by shape, and the routes of ``ops/routes.py``; the change over
    a run is its counts."""
    from pointreggpt_tpu_torch.ops import attention as K2
    from pointreggpt_tpu_torch.ops import conv as KC
    from pointreggpt_tpu_torch.ops import group_norm as GN
    from pointreggpt_tpu_torch.ops import linear_attention as K1
    from pointreggpt_tpu_torch.ops.routes import ROUTES

    return dict(k1=K1.fused_linear_attention.launches,
                k1_plain=K1.fused_linear_attention.plain_routes,
                k3=K1.fused_linear_attention_bwd.launches,
                k3_plain=K1.fused_linear_attention_bwd.plain_routes,
                k4=K1.linear_attention_core.launches,
                k2=K2.multihead_attention.launches, k5=KC.conv3x3.launches,
                dw=KC.conv3_dw.launches, k6=KC.conv3_igemm.launches,
                gn=GN.group_norm_act.launches, **ROUTES)
