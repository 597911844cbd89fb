"""Profiling tools of the port (``python -m pointreggpt_tpu_torch.tools.<name>``)
and what they share: timing and the card's peak rate.

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
