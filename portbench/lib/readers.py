"""Arithmetic the metric readers share: medians, the rate over a window,
model-FLOP utilization, and kernel rooflines from a trace."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, Optional, Sequence

from portbench.lib import work


def median(xs: Sequence[float]) -> Optional[float]:
    return statistics.median(xs) if xs else None


def mean(xs: Sequence[float]) -> Optional[float]:
    return statistics.fmean(xs) if xs else None


def per_s(count: float, wall_s: float) -> Optional[float]:
    """``count`` over the window's wall seconds."""
    return count / wall_s if count and wall_s > 0 else None


def least_s(flops: Dict[str, float]) -> float:
    """The least time of ``flops`` ({dtype: operations}) at the card's
    peaks."""
    return sum(f / work.peak(d) for d, f in flops.items())


def mfu(flops: Dict[str, float], count: float, wall_s: float
        ) -> Optional[float]:
    """Percent of the window that ``count`` units of ``flops`` would take at
    the peaks."""
    if not count or wall_s <= 0:
        return None
    return 100.0 * count * least_s(flops) / wall_s


def idle_share(trace) -> Optional[float]:
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def roofline(trace, pick: Callable, bound_s: float) -> Optional[float]:
    """Percent: the least time of the calls over the device time of the
    kernels ``pick(activity)`` selects; None where none ran."""
    if trace is None:
        return None
    busy = sum((a.end - a.start) / 1e9 for a in trace.activities
               if a.is_kernel and pick(a))
    if busy <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / busy
