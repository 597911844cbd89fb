"""The port's own spans (``pointreggpt_tpu_torch.utils.profiling``) against
a traced window: the device-idle time that falls inside them.

A reader intersects the idle intervals of ``run.trace`` (no device
activity; :func:`lib.trace.gaps`) with the union of the port's spans of
the given names that ran on the main thread inside [``lo``, ``hi``]. The
port stamps its spans with ``time.time_ns()``, the profiler's clock.
Every function returns None, and never raises, where there is no trace,
no recorder (a port without ``profiling.spans``) or no such span.
"""

from __future__ import annotations

import threading
from typing import Iterable, List, Optional, Sequence, Tuple

from portbench.lib.trace import gaps


def recorded() -> Optional[list]:
    """The port's recorded spans, or None where it keeps none."""
    try:
        from pointreggpt_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return list(read()) if callable(read) else None


def _main(run, names: Sequence[str]) -> Optional[List[Tuple[int, int]]]:
    """(start, end) of the main thread's spans named ``names`` that overlap
    the traced window; None where there is nothing to read."""
    if run.trace is None:
        return None
    got = recorded()
    if not got:
        return None
    main = threading.main_thread().ident
    lo, hi = run.trace.lo, run.trace.hi
    out = [(s.start, s.end) for s in got
           if s.name in names and s.thread == main and s.end > lo
           and s.start < hi]
    return out or None


def _merged(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap_ns(xs: Iterable[Tuple[int, int]],
               ys: Iterable[Tuple[int, int]]) -> int:
    """Length of the intersection of the unions of ``xs`` and ``ys``."""
    xs, ys = _merged(xs), _merged(ys)
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_s(run, names: Sequence[str]) -> Optional[float]:
    """Device-idle seconds of the traced window inside the port's spans
    named ``names``."""
    mine = _main(run, names)
    if mine is None:
        return None
    tr = run.trace
    idle = gaps(((a.start, a.end) for a in tr.activities), tr.lo, tr.hi)
    return overlap_ns(idle, mine) / 1e9


def idle_ms_per(run, names: Sequence[str], per: str) -> Optional[float]:
    """:func:`idle_s` in milliseconds over the number of the port's
    ``per`` spans (a step's) that start in the window."""
    idle = idle_s(run, names)
    steps = _main(run, (per,))
    if idle is None or steps is None:
        return None
    n = sum(1 for a, _ in steps if run.trace.lo <= a <= run.trace.hi)
    return 1e3 * idle / n if n else None
