#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (its entry in ``BENCHMARK.json``) names a configuration and a
traffic mix; the mix names the job (``jobs/<job>.py``) that drives the port of
``pointreggpt_tpu_torch``. A run makes its inputs and weights from the
seed, warms up (``setup_s``: process start to the first timed call),
measures for ``--seconds``, with ``--trace 1`` profiles a bounded steady
part after that, then frees the port's state and holds what the window
produced against the plain reference (``reference/``). The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error).

A run needs a CUDA card (it never falls back to the CPU), reads and writes
under the checkout and ``TMPDIR``, and fails without a result if JAX or
the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

os.environ.setdefault("USE_FLAX", "0")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def traced(job, spans):
    """Profile ``job.traced_segment()`` (CPU and CUDA activity, in memory)
    and reduce it to a :class:`lib.trace.Trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.lib.trace import MARKER, from_profiler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(MARKER):
            lo = time.time_ns()
            job.traced_segment()
            hi = time.time_ns()
    return from_profiler(prof, lo, hi, spans)


def read_metrics(cell, run) -> dict:
    out = {}
    for m in cell.metrics(run.trace is not None):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device=None, overrides=None, t_start: float = None) -> dict:
    """One run of cell ``name``; returns the result object. ``device``
    (tests: ``cpu``) skips the look for cards; ``overrides`` replace keys
    of the configuration and the traffic (tests: a size a CPU holds)."""
    from portbench.lib import card, checks, spec
    from portbench.lib.trace import Spans

    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.Cell(name, overrides=overrides)
    import torch

    if device is None:
        card.require_cards(cell.chips)
        device = torch.device("cuda", 0)
        print(f"card: {card.card_line()}", file=sys.stderr, flush=True)
    device = torch.device(device)
    spans = Spans()
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        job = cell.job().Job(cell, seed, device, workdir, spans)
        job.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        t0 = time.perf_counter()
        record = job.window(seconds)
        t1 = time.perf_counter()
        tr = traced(job, spans) if trace else None
        t2 = time.perf_counter()
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        steps = sorted(record.get("step_s", []))
        if steps:
            print(f"step seconds: n {len(steps)}, min {steps[0]!r}, median "
                  f"{steps[len(steps) // 2]!r}, max {steps[-1]!r}",
                  file=sys.stderr, flush=True)
        for line in job.counter_lines():
            print(line, file=sys.stderr, flush=True)
        job.release()
        numbers = job.check()
        phases = ", ".join(f"{n} {(b - a) / 1e9:.2f}"
                           for n, a, b in spans.items if n.startswith("setup"))
        print(f"seconds: setup {setup_s:.2f} ({phases}), window "
              f"{t1 - t0:.2f}, trace "
              f"{t2 - t1:.2f}, check {time.perf_counter() - t2:.2f}",
              file=sys.stderr, flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    run = SimpleNamespace(cell=cell, record=record, trace=tr, spans=spans,
                          setup_s=setup_s)
    result = {"correct": checks.verdict(numbers, cell.limits),
              "attempted": int(record["attempted"]),
              "failed": int(record["failed"]),
              "metrics": read_metrics(cell, run),
              "device": card.device(cell.chips, peak)}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks.report(numbers, cell.limits)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    from portbench.lib.card import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
