"""The port's tracer: spans, stage timing and device traces
(``PRGPT_PROFILE``).

Port of ``pointreggpt_tpu/utils/profiling.py`` on ``torch.profiler``, with
the port's own spans:

- :func:`span`: a named interval at a layer boundary of the host loop or
  the device step: its start and end in ``time.time_ns()`` (the clock
  ``torch.profiler`` stamps its events with, so spans line up with a
  device trace), its parent span, its thread, a request identifier
  (``req``: a generation chunk's first scene index, a training step's
  count; children inherit their parent's) and attributes. Finished spans
  go into a bounded in-memory ring (:func:`spans`) with running totals
  per name (:func:`totals`), so a long run stays at constant memory;
- ``gc`` spans: the interpreter's garbage-collection pauses (a
  ``gc.callbacks`` hook, the generation in the attributes);
- the caching allocator's counts across a span given ``alloc=<cuda
  device>`` (:data:`ALLOC_COUNTS` deltas in its attributes);
- the change of a caller's counters across a span given
  ``counters=<dict of name to int>`` (each name's delta in its
  attributes, and in :class:`LoopProfile`'s summary);
- :func:`trace`: a ``torch.profiler`` capture (CPU and, on the card, CUDA
  activity) of the enclosed block, written as a Chrome trace
  (``*.pt.trace.json``) under a directory;
- :class:`StepTraceCapture`: the same for steps [start, stop) of a loop;
- :func:`annotate`: a named region in the trace
  (``torch.profiler.record_function``);
- :class:`StageTimer`: totals per stage from recorder spans, with the
  JAX text summary;
- :class:`LoopProfile`: the stages of one production loop
  (``Trainer.train``, ``Generator.generate``) from the recorder's totals,
  with a trace of a few iterations left out of them.

Spans are recorded only while a ``torch.profiler`` session records or
``PRGPT_PROFILE`` is set (read at import and at each :func:`profile_dir`,
which every loop calls as it starts). Otherwise :func:`span` returns one
shared no-op after reading two module flags: no clock read, no range.
While a profiler records, each span is also a
``record_function("prgpt.<name>")`` range, so it shows in the Chrome
traces ``PRGPT_PROFILE`` writes; the prefix keeps a range's name apart
from every kernel's.

A stage's time is the host's. Stages named ``dispatch`` time the queueing
of device work only (the card runs it later, as in the JAX package); the
others end on a host read of device results (``loss_sync``,
``host_write``, ``save_and_sample``) or on host work alone
(``load_batch``, ``scene_setup``), so they include the device time they
wait for.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from typing import (Deque, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple)

import torch
import torch.autograd.profiler as _autograd_profiler
import torch.profiler as tprof

# finished spans kept for readers; older ones fall out, their totals stay
RING = 1 << 14
# the caching allocator's counters a span given ``alloc`` records the
# change of (``torch.cuda.memory_stats``): cudaMalloc calls, frees and
# retries after an out-of-memory, and device-wide synchronizations
ALLOC_COUNTS = ("num_device_alloc", "num_alloc_retries",
                "num_sync_all_streams")

# re-entrant: a collection can start inside the recorder's own critical
# section, and its ``gc`` span records itself from there
_lock = threading.RLock()
_ring: Deque["Span"] = deque(maxlen=RING)
_totals: Dict[str, List[int]] = {}  # name -> [ns, count]
_alloc_totals: Dict[str, int] = dict.fromkeys(ALLOC_COUNTS, 0)
_counter_totals: Dict[str, int] = {}  # a span's ``counters``, by name
_ids = itertools.count(1)
_local = threading.local()
_env_on = bool(os.environ.get("PRGPT_PROFILE"))


def tracing() -> bool:
    """True while spans are recorded: a ``torch.profiler`` session records
    or ``PRGPT_PROFILE`` is set."""
    return _env_on or _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _alloc_counts(device: torch.device) -> List[int]:
    stats = torch.cuda.memory_stats(device)
    return [int(stats.get(k, 0)) for k in ALLOC_COUNTS]


class Span:
    """One recorded interval; a context manager that records itself into
    the ring when it closes."""

    __slots__ = ("name", "id", "parent", "thread", "req", "attrs", "start",
                 "end", "_range", "_alloc", "_counts0", "_counters",
                 "_counters0")

    def __init__(self, name: str, req=None, attrs: Optional[dict] = None,
                 alloc: Optional[torch.device] = None,
                 counters: Optional[Mapping[str, int]] = None):
        self.name = name
        self.req = req
        self.attrs = {} if attrs is None else attrs
        self.id = next(_ids)
        self.parent: Optional[int] = None
        self.thread = 0
        self.start = self.end = 0
        self._range = None
        self._alloc = alloc if alloc is not None and \
            torch.device(alloc).type == "cuda" else None
        self._counts0: Optional[List[int]] = None
        self._counters = counters
        self._counters0: Optional[Dict[str, int]] = None

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.req is None:
                self.req = top.req
        stack.append(self)
        self.thread = threading.get_ident()
        # the span holds its range and its allocator reads
        self.start = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(
                "prgpt." + self.name)
            self._range.__enter__()
        if self._alloc is not None:
            self._counts0 = _alloc_counts(self._alloc)
        if self._counters is not None:
            self._counters0 = dict(self._counters)
        return self

    def __exit__(self, *exc) -> bool:
        if self._counts0 is not None:
            deltas = [b - a for a, b in zip(self._counts0,
                                            _alloc_counts(self._alloc))]
            self.attrs.update(zip(ALLOC_COUNTS, deltas))
        if self._counters0 is not None:
            self.attrs.update((k, v - self._counters0[k])
                              for k, v in self._counters.items())
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.end = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        with _lock:
            _ring.append(self)
            tot = _totals.setdefault(self.name, [0, 0])
            tot[0] += self.end - self.start
            tot[1] += 1
            if self._counts0 is not None:
                for k in ALLOC_COUNTS:
                    _alloc_totals[k] += self.attrs[k]
            if self._counters0 is not None:
                for k in self._counters0:
                    _counter_totals[k] = (_counter_totals.get(k, 0)
                                          + self.attrs[k])
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"req={self.req!r}, {(self.end - self.start) / 1e3:.1f} us, "
                f"{self.attrs})")


class _Off:
    """The span of a run that is not traced."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, req=None, alloc: Optional[torch.device] = None,
         counters: Optional[Mapping[str, int]] = None, **attrs):
    """A span named ``name`` around the enclosed block, recorded while
    :func:`tracing`; the shared no-op otherwise. ``req``: the request
    identifier (inherited from the enclosing span when None); ``alloc``:
    a CUDA device whose allocator counts to record the change of;
    ``counters``: a dict of counts (name to int) to record the change of,
    read as the span opens and closes."""
    if not (_env_on or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return Span(name, req, attrs, alloc, counters)


def spans() -> List[Span]:
    """The ring's spans, oldest first (at most :data:`RING`)."""
    with _lock:
        return list(_ring)


def totals() -> Dict[str, Tuple[float, int]]:
    """Seconds and count of every span recorded so far, by name."""
    with _lock:
        return {k: (ns / 1e9, n) for k, (ns, n) in _totals.items()}


_gc_span: Optional[Span] = None


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a collection as a ``gc`` span."""
    global _gc_span
    if phase == "start":
        if tracing():
            _gc_span = Span("gc", attrs={"generation": info["generation"]})
            _gc_span.__enter__()
    elif _gc_span is not None:
        s, _gc_span = _gc_span, None
        s.attrs["collected"] = info["collected"]
        s.__exit__(None, None, None)


if _on_gc not in gc.callbacks:
    gc.callbacks.append(_on_gc)


def profile_dir() -> Optional[str]:
    """The ``PRGPT_PROFILE`` output directory, or None when profiling is off.

    Setting ``PRGPT_PROFILE=<dir>`` turns on the spans and, in the
    production loops (``Trainer.train``, ``Generator.generate``), a summary
    of their stages and a trace of a few steady-state steps: each prints a
    :class:`LoopProfile` breakdown at its end and writes a Chrome trace
    under ``<dir>``, or under ``<dir>/rank-<r>`` in a data-parallel run.
    """
    global _env_on
    root = os.environ.get("PRGPT_PROFILE") or None
    _env_on = root is not None
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
    """Accumulating wall-clock timers keyed by stage name; each stage is a
    recorder span (recorded whether or not :func:`tracing`).

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
        s = Span(name)
        try:
            with s:
                yield
        finally:
            self._total[name] += (s.end - s.start) / 1e9
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


def _snapshot(names: Sequence[str]) -> Dict[str, Tuple[int, int]]:
    with _lock:
        out = {n: tuple(_totals.get(n, (0, 0))) for n in names}
        out.update((k, (v, 0)) for k, v in _alloc_totals.items())
        out.update((k, (v, 0)) for k, v in _counter_totals.items())
    return out


def _minus(a: dict, b: dict) -> dict:
    zero = (0, 0)  # a counter first recorded after ``b``
    return {k: (a[k][0] - b.get(k, zero)[0], a[k][1] - b.get(k, zero)[1])
            for k in a}


class LoopProfile:
    """``PRGPT_PROFILE`` for one loop: the recorder's totals of the loop's
    ``stages`` (its top-level spans), of the GC pauses, of the
    allocator counts and of the spans' ``counters`` over the loop, with a
    trace of iterations [start, stop) left out of them."""

    def __init__(self, log_dir: str, *, start: int, stop: int,
                 stages: Sequence[str] = ()):
        self.log_dir = log_dir
        self.stages = tuple(stages)
        self.timer = StageTimer()
        self.capture = StepTraceCapture(log_dir, start=start, stop=stop)
        self._names = self.stages + ("gc",)
        self._start = _snapshot(self._names)
        self._traced = None  # totals as the trace opened
        self._left_out = _minus(self._start, self._start)

    def _follow(self, was_tracing: bool) -> None:
        if self.capture.tracing and not was_tracing:
            self._traced = _snapshot(self._names)
        elif was_tracing and not self.capture.tracing:
            during = _minus(_snapshot(self._names), self._traced)
            left, zero = self._left_out, (0, 0)
            self._left_out = {k: (v[0] + left.get(k, zero)[0],
                                  v[1] + left.get(k, zero)[1])
                              for k, v in during.items()}

    def tick(self) -> None:
        was = self.capture.tracing
        self.capture.tick()
        self._follow(was)

    def close(self) -> str:
        """End the trace; returns the breakdown to print."""
        was = self.capture.tracing
        self.capture.close()
        self._follow(was)
        d = _minus(_minus(_snapshot(self._names), self._start),
                   self._left_out)
        self.timer.reset()
        for name in self.stages:
            ns, n = d[name]
            if n:
                self.timer._total[name] = ns / 1e9
                self.timer._count[name] = n
        gc_ns, gc_n = d["gc"]
        alloc = ", ".join(f"{k} {d[k][0]}" for k in ALLOC_COUNTS)
        counters = ", ".join(f"{k} {d[k][0]}" for k in d
                             if k not in self._names
                             and k not in ALLOC_COUNTS)
        return (f"profile stages (trace in {self.log_dir}):\n"
                + self.timer.summary()
                + f"\ngc pauses: {gc_ns / 1e9:.3f}s in {gc_n} collections"
                + f"\nallocator: {alloc}"
                + (f"\ncounters: {counters}" if counters else ""))


def loop_profile(start: int, stop: int, stages: Sequence[str] = ()
                 ) -> Optional[LoopProfile]:
    """A :class:`LoopProfile` under :func:`profile_dir`, or None when
    ``PRGPT_PROFILE`` is unset."""
    log_dir = profile_dir()
    if log_dir is None:
        return None
    return LoopProfile(log_dir, start=start, stop=stop, stages=stages)
