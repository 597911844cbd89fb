"""Stage timing and device traces (``PRGPT_PROFILE``).

Port of ``pointreggpt_tpu/utils/profiling.py`` on ``torch.profiler``:

- :func:`trace`: a ``torch.profiler`` capture (CPU and, on the card, CUDA
  activity) of the enclosed block, written as a Chrome trace
  (``*.pt.trace.json``) under a directory;
- :class:`StepTraceCapture`: the same for steps [start, stop) of a loop;
- :func:`annotate`: a named region in the trace
  (``torch.profiler.record_function``);
- :class:`StageTimer`: wall-clock totals per stage, with the JAX text
  summary;
- :class:`LoopProfile`: the three together for one production loop
  (``Trainer.train``, ``Generator.generate``).

A stage's time is the host's. Stages named ``dispatch`` time the queueing
of device work only (the card runs it later, as in the JAX package); the
others end on a host read of device results (``loss_sync``,
``host_write``, ``save_and_sample``) or on host work alone
(``load_batch``, ``scene_setup``), so they include the device time they
wait for.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch
import torch.profiler as tprof


def profile_dir() -> Optional[str]:
    """The ``PRGPT_PROFILE`` output directory, or None when profiling is off.

    Setting ``PRGPT_PROFILE=<dir>`` turns on stage timing and a trace of a
    few steady-state steps in the production loops (``Trainer.train``,
    ``Generator.generate``): each prints a :class:`StageTimer` breakdown
    at its end and writes a Chrome trace under ``<dir>``, or under
    ``<dir>/rank-<r>`` in a data-parallel run.
    """
    root = os.environ.get("PRGPT_PROFILE") or None
    if root is None:
        return None
    from pointreggpt_tpu_torch.parallel import mesh

    if mesh.process_count() > 1:
        return os.path.join(root, f"rank-{mesh.process_index()}")
    return root


def _activities():
    acts = [tprof.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(tprof.ProfilerActivity.CUDA)
    return acts


def _profiler(log_dir: str) -> tprof.profile:
    return tprof.profile(activities=_activities(),
                         on_trace_ready=tprof.tensorboard_trace_handler(
                             log_dir))


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[tprof.profile]:
    """Capture a trace of the enclosed block under ``log_dir``; yields the
    profiler (``key_averages()`` sums it by operation)."""
    prof = _profiler(log_dir)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


class StepTraceCapture:
    """Capture a trace of steps [start, stop) of a loop.

    Call ``tick()`` at the END of each iteration; ``close()`` (idempotent)
    ends a trace still open when the loop stops before ``stop``.
    """

    def __init__(self, log_dir: str, *, start: int = 2, stop: int = 5):
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self._step = 0
        self._prof: Optional[tprof.profile] = None

    @property
    def tracing(self) -> bool:
        """True while the trace is open. Stage timing skips such steps:
        the profiler's own cost would be read as the loop's."""
        return self._prof is not None

    def tick(self) -> None:
        if self._step == self.start and self._prof is None:
            self._prof = _profiler(self.log_dir)
            self._prof.start()
        self._step += 1
        if self._step >= self.stop:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


def annotate(name: str):
    """Named region in the trace."""
    return tprof.record_function(name)


class StageTimer:
    """Accumulating wall-clock timers keyed by stage name.

    Example::

        timer = StageTimer()
        with timer.stage("load_batch"):
            batch = next(loader)
        print(timer.summary())
    """

    def __init__(self):
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def totals(self) -> Dict[str, float]:
        return dict(self._total)

    def summary(self) -> str:
        lines = []
        for name in sorted(self._total, key=self._total.get, reverse=True):
            t, c = self._total[name], self._count[name]
            lines.append(f"{name}: {t:.3f}s total / {c} calls "
                         f"({1e3 * t / max(c, 1):.1f} ms avg)")
        return "\n".join(lines)

    def reset(self) -> None:
        self._total.clear()
        self._count.clear()


class LoopProfile:
    """``PRGPT_PROFILE`` for one loop: stage timing, with a trace of
    iterations [start, stop) left out of the timing."""

    def __init__(self, log_dir: str, *, start: int, stop: int):
        self.log_dir = log_dir
        self.timer = StageTimer()
        self.capture = StepTraceCapture(log_dir, start=start, stop=stop)

    def stage(self, name: str):
        if self.capture.tracing:
            return contextlib.nullcontext()
        return self.timer.stage(name)

    def tick(self) -> None:
        self.capture.tick()

    def close(self) -> str:
        """End the trace; returns the breakdown to print."""
        self.capture.close()
        return (f"profile stages (trace in {self.log_dir}):\n"
                + self.timer.summary())


def loop_profile(start: int, stop: int) -> Optional[LoopProfile]:
    """A :class:`LoopProfile` under :func:`profile_dir`, or None when
    ``PRGPT_PROFILE`` is unset."""
    log_dir = profile_dir()
    if log_dir is None:
        return None
    return LoopProfile(log_dir, start=start, stop=stop)


def no_stage(name: str):
    """The stage of a loop that is not profiled."""
    return contextlib.nullcontext()
