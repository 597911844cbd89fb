"""Device time of K4 (the LinearAttention core on packed qkv) by launch, at
(8, n, 384) for the U-Net's four n.

    python pointreggpt_tpu_torch/tools/profile_k4.py [--dtype both]
        [--calls 20]

For each n it runs ``linear_attention_core`` on ``check_inputs_core`` once
to warm up, then reports ``graph_ms`` (device time of one call: ``--calls``
calls captured in one CUDA graph, replayed 3 times between two events),
``event_ms`` (back-to-back calls timed with CUDA events, the host's time
per call included) and one call's device time by kernel name
(``torch.profiler``, after a warm-up step). Prints one JSON line per dtype with its shapes and
sums. It uses only the package's public wrapper, so it times whichever
``pointreggpt_tpu_torch`` is first on ``PYTHONPATH``: run as a file, with
``PYTHONPATH`` set to another checkout, it times that checkout's K4.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

N = [65536, 16384, 4096, 1024]  # the U-Net's n at 256^2, batch 8


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def profile_shape(torch, K1, n: int, dtype, calls: int = 20) -> dict:
    """One shape: graph_ms, event_ms and one call's device time by kernel
    name (names cut to 60 characters)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    qkv = K1.check_inputs_core(8, n, dtype, "cuda")

    def call():
        return K1.linear_attention_core(qkv)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # capture wants a warm-up off the default
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            call()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    graph_ms = start.elapsed_time(stop) / (3 * calls)
    del graph

    start.record()
    for _ in range(calls):
        call()
    stop.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(stop) / calls

    # one warm-up step, then the profiled call: a window that opens on the
    # call itself can lose its first launches
    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        for _ in range(2):
            call()
            torch.cuda.synchronize()
            prof.step()
    kernels = {}
    for ev in events:  # the kernels (the step's own span shows on the
        # device too)
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                not ev.name.startswith("ProfilerStep"):
            name = ev.name.replace("(anonymous namespace)::", "")[:60]
            kernels[name] = (kernels.get(name, 0.0)
                             + ev.time_range.elapsed_us() / 1e3)
    del qkv
    torch.cuda.empty_cache()
    return dict(n=n, graph_ms=graph_ms, event_ms=event_ms,
                device_ms=sum(kernels.values()), by_launch=kernels)


def run(torch, K1, dtype, calls: int = 20) -> dict:
    """Every n of ``N``, and the sums over them."""
    rows = [profile_shape(torch, K1, n, dtype, calls) for n in N]
    by_launch = {}
    for r in rows:
        for k, v in r["by_launch"].items():
            by_launch[k] = by_launch.get(k, 0.0) + v
    return dict(shapes=rows, **{k: sum(r[k] for r in rows)
                                for k in ("graph_ms", "event_ms",
                                          "device_ms")},
                by_launch=by_launch)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="both",
                    choices=["both", "bfloat16", "float32"])
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from pointreggpt_tpu_torch.ops import linear_attention as K1

    if not torch.cuda.is_available():
        raise SystemExit("profile_k4: needs a CUDA GPU")
    names = (["bfloat16", "float32"] if args.dtype == "both"
             else [args.dtype])
    out = []
    for name in names:
        res = run(torch, K1, getattr(torch, name), args.calls)
        out.append(dict(source=K1.__file__, card=card_line(), dtype=name,
                        **res))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
