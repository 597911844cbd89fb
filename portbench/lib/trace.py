"""Host spans, and the reduction of a ``torch.profiler`` session to device
activity: busy time (the union of the device's intervals), idle gaps named
by the host span that was open, kernel time by kind, and the breakdown a
result line carries.

Host spans and the profiler's events share one clock: both are
nanoseconds of ``time.time_ns()``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# kernels the port wrote by hand, by kernel, from the names of
# ``pointreggpt_tpu_torch/ops/csrc``; K1's kernels A and B also run inside
# K3 (the statistics of its backward)
K1 = ("kv_partials_tc", "merge_context_tc", "emit_out_tc",
      "kv_partials_tf32", "merge_context_tf32", "emit_out_tf32")
K1_SHARED = ("kv_partials_tc", "merge_context_tc", "kv_partials_tf32",
             "merge_context_tf32")
K3 = ("bwd_kv_partials", "bwd_merge_context", "q_path_bwd", "kv_path_bwd",
      "wgrad_partials", "fold_context", "reduce_partials")
K2 = ("flash_fwd",)
K_OTHER = ("core_kv", "core_merge", "core_emit", "conv3_kernel")
# library matrix products and convolutions (cuDNN, cuBLAS, CUTLASS)
LIBRARY = ("cudnn", "xmma", "implicit_gemm", "implicit_convolve", "dgrad",
           "wgrad", "sm90_", "sm80_", "sm75_", "cutlass", "gemm", "gemv",
           "fft", "winograd", "conv2d", "convolve", "nchwToNhwc",
           "nhwcToNchw")


def _has(name: str, keys: Sequence[str]) -> bool:
    return any(k in name for k in keys)


def kind(name: str, on_main_thread: bool = True) -> str:
    """``k1``, ``k3``, ``k2``, ``kernel`` (another hand-written one),
    ``library`` or ``glue`` (all else: elementwise, norms, reductions,
    copies inside kernels)."""
    if _has(name, K3):
        return "k3"
    if _has(name, K1):
        if not on_main_thread and _has(name, K1_SHARED):
            return "k3"
        return "k1"
    if _has(name, K2):
        return "k2"
    if _has(name, K_OTHER):
        return "kernel"
    if _has(name, LIBRARY):
        return "library"
    return "glue"


@dataclass
class Activity:
    """One device activity: a kernel, a memcpy or a memset."""
    name: str
    start: int
    end: int
    is_kernel: bool = True
    main_thread: bool = True


class Spans:
    """Named host intervals, kept in memory."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def of(self, name: str) -> List[Tuple[int, int]]:
        return [(a, b) for n, a, b in self.items if n == name]

    def seconds(self, name: str) -> List[float]:
        return [(b - a) / 1e9 for a, b in self.of(name)]

    def open_at(self, t: int) -> Optional[str]:
        """The innermost span open at ``t`` (the latest started)."""
        best = None
        for n, a, b in self.items:
            if a <= t <= b and (best is None or a >= best[1]):
                best = (n, a)
        return None if best is None else best[0]


def union(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    busy, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def gaps(intervals: Iterable[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The idle intervals of [lo, hi] outside every interval."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end and a > lo:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Trace:
    """The device activity of a traced window [lo, hi] (ns)."""
    activities: List[Activity]
    lo: int
    hi: int
    spans: Spans = field(default_factory=Spans)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def busy_s(self) -> float:
        return union(((a.start, a.end) for a in self.activities),
                     self.lo, self.hi) / 1e9

    def kernel_s(self) -> Dict[str, float]:
        """Device seconds of the window's kernels by :func:`kind`."""
        out: Dict[str, float] = {}
        for a in self.activities:
            if a.is_kernel:
                k = kind(a.name, a.main_thread)
                out[k] = out.get(k, 0.0) + (a.end - a.start) / 1e9
        return out

    def share(self, *kinds: str) -> Optional[float]:
        """Percent of kernel time in ``kinds``; None with no kernel."""
        by = self.kernel_s()
        total = sum(by.values())
        if total <= 0:
            return None
        return 100.0 * sum(by.get(k, 0.0) for k in kinds) / total

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the host span open at its middle."""
        ops: Dict[str, float] = {}
        for a in self.activities:
            ops[a.name] = ops.get(a.name, 0.0) + (a.end - a.start) / 1e9
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        idle = gaps(((a.start, a.end) for a in self.activities),
                    self.lo, self.hi)
        idle = sorted(idle, key=lambda g: g[0] - g[1])[:top]
        named = [[self.spans.open_at((a + b) // 2) or "outside_spans",
                  (b - a) / 1e9] for a, b in idle]
        return {"device_ops": [[n[:120], s] for n, s in device_ops],
                "idle_gaps": named}


MARKER = "portbench.traced"


def from_profiler(prof, lo: int, hi: int, spans: Spans) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile`` session:
    its CUDA activities, each kernel marked by whether the host thread that
    launched it is the one that opened ``record_function(MARKER)`` (the
    autograd engine launches a backward from a thread of its own)."""
    import torch

    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    main_tid = next((e.start_thread_id() for e in events
                     if e.name() == MARKER), None)
    # ranges of record_function (the benchmark's, the port's, the
    # optimizer's) are mirrored on the device's timeline: not activity
    ranges = {e.name() for e in events
              if e.device_type() != cuda and e.is_user_annotation()}
    launch_tid = {}
    for e in events:
        if e.device_type() != cuda and e.name().startswith(("cuda", "cu")):
            launch_tid[e.correlation_id()] = e.start_thread_id()
    acts = []
    for e in events:
        name = e.name()
        if e.device_type() != cuda or e.is_user_annotation() or \
                name in ranges:
            continue
        start = e.start_ns()
        end = start + e.duration_ns()
        is_kernel = not name.startswith(("Memcpy", "Memset"))
        tid = launch_tid.get(e.correlation_id(), main_tid)
        acts.append(Activity(name, start, end, is_kernel, tid == main_tid))
    return Trace(acts, lo, hi, spans)
