"""Device time of K3 (the LinearAttention backward) by launch, at the eight
shapes of a dim-64 U-Net's training backward (and c = 2048).

    python pointreggpt_tpu_torch/tools/profile_k3.py [--dtype bfloat16]
        [--batch 32] [--wide] [--repeats 3]

For each (n, c) it runs ``fused_linear_attention_bwd`` on
``check_inputs_bwd`` once to warm up, times ``--repeats`` calls with CUDA
events, then profiles one call with ``torch.profiler`` and sums its device
time by kernel name. Prints one JSON line per shape and one with the sums
over the shapes (each of the two (65536, 64) calls counted). It uses only
the package's public wrapper, so it profiles whichever
``pointreggpt_tpu_torch`` is first on ``PYTHONPATH``: run as a file, with
``PYTHONPATH`` set to another checkout, it profiles that checkout's
kernels. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (n, c) of the eight LinearAttention calls of a dim-64 U-Net at 256^2
SHAPES = [(65536, 64), (16384, 64), (4096, 128), (1024, 256), (1024, 512),
          (4096, 256), (16384, 128), (65536, 64)]
WIDE = (1024, 2048)  # up_0 of a dim-256 U-Net


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def by_kernel(torch, prof) -> dict:
    """Device time (ms) and count of each kernel name in a profile."""
    out = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = out.get(ev.name, (0.0, 0))
        out[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
    return {k: {"ms": v[0], "launches": v[1]} for k, v in out.items()}


def profile_shape(torch, K1, batch: int, n: int, c: int, dtype,
                  repeats: int = 3) -> dict:
    """One shape: event time per call, and one call's device time by
    kernel name (names cut to 60 characters)."""
    from torch.profiler import ProfilerActivity, profile

    eps = 1e-3 if dtype == torch.bfloat16 else 1e-5
    args = K1.check_inputs_bwd(batch, n, c, dtype, "cuda")

    def call():
        return K1.fused_linear_attention_bwd(*args, eps=eps)

    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        call()
    stop.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = by_kernel(torch, prof)
    del args
    torch.cuda.empty_cache()
    return dict(n=n, c=c, batch=batch,
                event_ms=start.elapsed_time(stop) / repeats,
                device_ms=sum(v["ms"] for v in kernels.values()),
                kernels={k[:60]: v for k, v in sorted(
                    kernels.items(), key=lambda kv: -kv[1]["ms"])})


def run(torch, K1, batch: int, dtype, shapes, repeats: int = 3) -> dict:
    """Every shape of ``shapes``, and the sums over them by kernel name."""
    rows, total = [], {}
    for n, c in shapes:
        row = profile_shape(torch, K1, batch, n, c, dtype, repeats)
        rows.append(row)
        for k, v in row["kernels"].items():
            t = total.setdefault(k, {"ms": 0.0, "launches": 0})
            t["ms"] += v["ms"]
            t["launches"] += v["launches"]
    return dict(shapes=rows,
                event_ms=sum(r["event_ms"] for r in rows),
                device_ms=sum(r["device_ms"] for r in rows),
                kernels=dict(sorted(total.items(),
                                    key=lambda kv: -kv[1]["ms"])))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--wide", action="store_true",
                    help="also profile (n, c) = (1024, 2048), apart")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from pointreggpt_tpu_torch.ops import linear_attention as K1

    if not torch.cuda.is_available():
        raise SystemExit("profile_k3: needs a CUDA GPU")
    dtype = getattr(torch, args.dtype)
    res = run(torch, K1, args.batch, dtype, SHAPES, args.repeats)
    for row in res["shapes"]:
        print(json.dumps(dict(source=K1.__file__, dtype=args.dtype, **row)))
    out = dict(source=K1.__file__, card=card_line(), dtype=args.dtype,
               batch=args.batch, event_ms=res["event_ms"],
               device_ms=res["device_ms"], kernels=res["kernels"])
    if args.wide:
        out["wide"] = profile_shape(torch, K1, args.batch, *WIDE, dtype,
                                    args.repeats)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
