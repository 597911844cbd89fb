"""Time and device time by kernel of one fp32 MaskUNet forward: the
Generator's keep-mask net at the CLI default (dim 64, dim_mults (1, 2, 4,
8), fp32, 256^2, batch 8), random weights from a seed.

    python pointreggpt_tpu_torch/tools/profile_mask.py [--batch 8]
        [--repeats 10]

Times ``--repeats`` forwards with CUDA events after two warm-up forwards,
then profiles one forward with ``torch.profiler`` and sums its device time
by kernel name and by group: K1 (the fused LinearAttention's launches),
K2 (the bottleneck attention) and the rest. Prints one JSON line with the
card's ``nvidia-smi`` name and power limit. It uses only the package's
public builders, so run as a file with ``PYTHONPATH`` set to another
checkout it profiles that checkout's net and kernels (as
``profile_k3.py`` does). Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json

# kernel-name fragments of each group; first match wins
GROUPS = (("k1", ("kv_partials", "merge_context", "emit_out")),
          ("k2", ("flash_fwd",)))


def main(argv=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.tools.profile_k3 import by_kernel, card_line

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mask: no CUDA GPU visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    net = C.build_mask_unet(C.MaskModelConfig()).eval().to(
        "cuda", memory_format=torch.channels_last)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(args.batch, 1, 256, 256, device="cuda",
                    generator=gen).contiguous(
                        memory_format=torch.channels_last)
    with torch.inference_mode():
        for _ in range(2):
            net(x)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.repeats):
            net(x)
        stop.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            net(x)
            torch.cuda.synchronize()
    kernels = by_kernel(torch, prof)
    groups = {}
    for name, v in kernels.items():
        g = next((g for g, keys in GROUPS if any(k in name for k in keys)),
                 "rest")
        t = groups.setdefault(g, {"ms": 0.0, "launches": 0})
        t["ms"] += v["ms"]
        t["launches"] += v["launches"]
    res = dict(card=card_line(), batch=args.batch,
               forward_ms=start.elapsed_time(stop) / args.repeats,
               device_ms=sum(v["ms"] for v in kernels.values()),
               by_group=groups,
               top_kernels_ms=sorted(([k[:70], v["ms"]]
                                      for k, v in kernels.items()),
                                     key=lambda kv: -kv[1])[:10])
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
