"""GPU smoke run of the PyTorch port (``pointreggpt_tpu_torch``).

    python3 chip_smoke.py [--seed N] [--num_samples N]

Needs one CUDA GPU (an H100 is the target), the CUDA toolkit's ``nvcc``
and this repository; exits nonzero without a GPU and prints no result.
Phases, each printing one JSON line:

1. the card (``nvidia-smi`` name and power limit), torch / CUDA / nvcc;
2. build every hand-written kernel from ``pointreggpt_tpu_torch/ops/csrc``
   (one nvcc per source, all at once);
3. ``k1_*``: K1 (fused LinearAttention) against its plain version at the
   eight (8, n, c) shapes of a dim-64 U-Net forward at 256^2, in bf16 (the
   DiffusionUNet, tensor cores) and fp32 (the MaskUNet, three TF32 passes
   on the tensor cores), with times, bounds (fp32 also at the CUDA cores'
   rate), TFLOP/s, shares of the bound, errors and one call's device time
   by launch;
4. ``k2_*``: K2 (bottleneck attention) against its plain version on
   ``K2.check_inputs`` at (8, 1024, 4, 32) (generation) and (32, 1024, 4,
   32) (the training microbatch) in both types, beside
   ``F.scaled_dot_product_attention`` in the same type as the library
   yardstick — timed here only, never called by the port; kernel and SDPA
   each timed over 3 interleaved repeats, the median reported. K1's and
   K2's ``ms`` (and SDPA's) are device time, calls captured in a CUDA graph
   (``graph_ms``); ``event_ms`` times back-to-back launches, host included;
5. ``k3_*``: K3 (K1's backward) against its plain version (the autograd
   of K1's plain version) at the eight shapes and at (1024, 2048), up_0 of
   a dim-256 U-Net (reported apart), bf16 at microbatch 32 (the
   tensor-core body) and fp32 at batch 8: max |got - ref| / max |ref| per
   output, times, bounds, and one call's device time by launch
   (torch.profiler);
6. ``k4_*``: K4 (the LinearAttention core on packed qkv) driven through
   ``linear_attention_core`` at (8, n, 384) for the U-Net's four n, held
   against its plain version by max |got - ref| / max |ref| (3e-2 bf16,
   1e-4 fp32), with device time (a CUDA graph of 20 calls) beside event
   time, bounds, shares of the bound and one call's device time by launch
   (``tools/profile_k4.py``); also n = 1000 and, in fp32, the backward
   against autograd of the plain version;
7. ``conv_tools``: the two conv tools' entry points,
   ``pointreggpt_tpu_torch.tools.profile_conv.main`` (K5 through the
   ``conv3x3`` op at the U-Net's four hot conv shapes, bf16, against the
   shift9 and pair lowerings and cuDNN) and ``profile_conv_igemm.main``
   (K6 at (2, 32, 32, 64) and batches 8 and 16 at 256^2, 64 -> 64),
   launch counters reset just before each; K5 and K6 within 1e-2 relative
   of their plain versions at every shape, each shape's TFLOP/s and share
   of its bound beside cuDNN's, ``conv3x3``'s gradients against autograd
   of ``conv3x3_plain`` (fp32 at a small shape, 1e-4; bf16 at (16, 256,
   256, 128 -> 64), 3e-2); then K5's fp32 path (three TF32 passes on
   the tensor cores) at the same four shapes against its plain version
   (1e-5 relative) and fp32 cuDNN (TF32 off);
8. ``net_parity``: a small whole-U-Net forward on the card against the
   same net on the CPU (fp32, plain path);
9. ``forward_profile``: one production DiffusionUNet forward (bf16,
   256^2, batch 8): its time and device time by kernel category; and one
   fp32 MaskUNet forward, its time and device time by kernel category;
10. ``grad_parity``: the loss gradients of a dim-64 fp32 DiffusionUNet at
   64^2 on the card against the CPU, per parameter; ``wide_net``: the same
   for a dim-256 net (LinearAttention up to c = 2048, where K1 and K3 must
   launch with no plain route), K1 against its plain version at (8, 1024,
   2048) in both types (with its time and bound), and one bf16 forward +
   backward of that net;
   ``mask_fwd_bwd``: one fp32 MaskUNet forward + backward of the
   MaskTrainer's loss at its microbatch (4 x 256^2), the path that runs
   K1, K2 and K3 in fp32: launches (none routed to a plain version), the
   step's time (median, least and most of 10 steps after a warm-up that
   ends when the steps settle), the device time by kernel category of one
   more step, timed alike, and the gradients card vs CPU (at one image);
11. ``train_step``: one production optimizer step (microbatch 32 x
   accumulation 2, 256^2, bf16): seconds, img/s, peak memory, launches
   (16 K1, 16 K3, 2 K2), and the device time of one microbatch forward +
   backward by kernel category;
12. ``main_path``: ``pointreggpt_tpu_torch.cli.generate_dataset.main`` at
   the production configuration (dim 64, 256^2, batch 8, 250 DDIM steps,
   eta 1, MaskUNet on, memory 2^18) on a synthetic 3DMatch tree with
   random weights made from ``--seed``, two sample steps; checks the output
   contract and 2,016 K1, 252 K2 and no K3 launches per sample step;
13. ``train_path``: ``pointreggpt_tpu_torch.cli.
   train_successive_ddnm_diffusion.main`` at the production configuration
   on 64 synthetic depth frames, 3 steps with a milestone at step 3;
   checks the losses, the 5x5 sample grid, the checkpoint's reference
   layout, that ``Generator.load`` reads it, and the launches (16 K1,
   16 K3 and 2 K2 per optimizer step; the milestone's grid counted apart).

The last three lines are the kernel table (one JSON object: K1-K3's
launch counts from the two main paths, K4's from its op's drive, K5's and
K6's from their tools' entry points; K1's and K3's ``plain_routes``, the
calls routed to the plain version by shape, must be 0 on both paths), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MEM_BW = 3.35e12           # H100 SXM HBM3 bytes/s
# peak rates for the inputs' type: dense bf16 tensor cores; fp32-accurate
# products as three TF32 passes on the tensor cores (494.7 TFLOP/s dense
# TF32, a third of it), the fp32 kernels' math; and, beside the fp32
# bounds, the CUDA cores' fp32 rate
PEAK = {"bfloat16": 989e12, "float32": 494.7e12 / 3}
CUDA_CORE_FP32 = 67e12
K1_SHAPES = [(65536, 64), (16384, 64), (4096, 128), (1024, 256),
             (1024, 512), (4096, 256), (16384, 128), (65536, 64)]
# K1's output is an O(1) LayerNorm (inside (-2, 2) on its check inputs):
# bf16 keeps 8 mantissa bits and a few values round one or two bf16 steps
# (2^-7 each) apart; K2's is an fp32 softmax average of O(1) values,
# stored in the input type. fp32 differs by sum order only.
K_ATOL = {("k1", "bfloat16"): 3e-2, ("k1", "float32"): 1e-3,
          ("k2", "bfloat16"): 1e-2, ("k2", "float32"): 1e-4}
NET_ATOL = 2e-3  # fp32 U-Net, card vs CPU: summation order only


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(torch, fn, iters: int, reps: int = 3) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``reps`` times between two events. Unlike
    :func:`time_ms` it leaves out the host's time per call, which is what
    back-to-back launches of a kernel shorter than its wrapper's host
    time measure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # capture wants a warm-up off the default
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (reps * iters)


def bound(work: dict, peak: float) -> tuple:
    t_bytes = work["bytes"] / MEM_BW * 1e3
    t_ops = work["flops"] / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def summed_bound(works, peak: float) -> tuple:
    """:func:`bound` of the summed work of several calls."""
    return bound(summed(works), peak)


def summed(works) -> dict:
    return {k: sum(w[k] for w in works) for k in ("bytes", "flops")}


def cuda_core_bound(work: dict, name: str) -> dict:
    """For fp32 work, its bound at the CUDA cores' fp32 rate, beside the
    three-pass TF32 one: ``{"cuda_core_bound_ms": ms}``; {} for bf16."""
    if name != "float32":
        return {}
    return {"cuda_core_bound_ms": bound(work, CUDA_CORE_FP32)[0]}


def phase_k1(torch, K1, dev, dtype):
    """K1 against its plain version at the eight shapes of one forward,
    in ``dtype`` (bf16 for the DiffusionUNet, fp32 for the MaskUNet); each
    shape's device time by launch from one profiled call."""
    from pointreggpt_tpu_torch.tools.profile_k3 import by_kernel
    from torch.profiler import ProfilerActivity, profile

    name = str(dtype).split(".")[-1]
    atol, eps = K_ATOL[("k1", name)], (1e-3 if name == "bfloat16" else 1e-5)
    size, peak = torch.tensor([], dtype=dtype).element_size(), PEAK[name]
    rows, cache = [], {}
    for n, c in K1_SHAPES:
        if (n, c) not in cache:
            # inputs on which C^, every kv split, q's per-head softmax and
            # the bias all move the output (see K1.check_inputs)
            args = K1.check_inputs(8, n, c, dtype, dev)
            out = K1.fused_linear_attention(*args, eps=eps)
            ref = K1.fused_linear_attention_plain(*args, eps=eps)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not np.isfinite(err) or err > atol:
                raise AssertionError(f"K1 {name} at (8, {n}, {c}): max abs "
                                     f"err {err} > {atol}")
            ms = graph_ms(torch,
                          lambda: K1.fused_linear_attention(*args, eps=eps),
                          10)
            event_ms = time_ms(
                lambda: K1.fused_linear_attention(*args, eps=eps), 20)
            plain_ms = time_ms(
                lambda: K1.fused_linear_attention_plain(*args, eps=eps), 3, 1)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                K1.fused_linear_attention(*args, eps=eps)
                torch.cuda.synchronize()
            launches = by_kernel(torch, prof)
            wk = K1.work(8, n, c, size)
            b_ms, b_by = bound(wk, peak)
            cache[(n, c)] = dict(n=n, c=c, max_abs_err=err, ms=ms,
                                 event_ms=event_ms, plain_ms=plain_ms,
                                 bound_ms=b_ms,
                                 bound_by=b_by, **cuda_core_bound(wk, name),
                                 tflops=wk["flops"] / ms / 1e9,
                                 share_of_bound=b_ms / ms,
                                 by_launch={k[:40]: v["ms"]
                                            for k, v in launches.items()},
                                 **wk)
            del args, out, ref
            torch.cuda.empty_cache()
        rows.append(cache[(n, c)])
    emit(f"k1_{name}", shapes=rows, atol=atol)
    b_ms, b_by = summed_bound(rows, peak)
    ms = sum(r["ms"] for r in rows)
    by_launch = {}
    for r in rows:
        for k, v in r["by_launch"].items():
            by_launch[k] = by_launch.get(k, 0.0) + v
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows), ms=ms,
                event_ms=sum(r["event_ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=b_ms, bound_by=b_by,
                **cuda_core_bound(summed(rows), name),
                tflops=sum(r["flops"] for r in rows) / ms / 1e9,
                share_of_bound=b_ms / ms, by_launch=by_launch)


K3_ATOL = {"bfloat16": 3e-2, "float32": 1e-4}
K3_OUTPUTS = ("dx_q", "dx_kv", "dw_qkv", "dw_out", "db_out", "dg")


def k3_errors(torch, K1, args, eps) -> dict:
    """K3 against its plain version on ``args`` (``K1.check_inputs_bwd``):
    max |got - ref| / max |ref| and max |got - ref| for each of the six
    outputs."""
    got = K1.fused_linear_attention_bwd(*args, eps=eps)
    ref = K1.fused_linear_attention_bwd_plain(*args, eps=eps)
    torch.cuda.synchronize()
    rel, abs_ = {}, {}
    for name, a, r in zip(K3_OUTPUTS, got, ref):
        if a.shape != r.shape:
            raise AssertionError(f"K3 {name}: shape {tuple(a.shape)} != "
                                 f"{tuple(r.shape)}")
        abs_[name] = (a.float() - r.float()).abs().max().item()
        rel[name] = abs_[name] / r.float().abs().max().item()
    return rel, abs_


K3_WIDE = (1024, 2048)  # up_0 of a dim-256 U-Net at 256^2


def phase_k3(torch, K1, dev, dtype, batch):
    """K3 against its plain version at the eight shapes of one forward and
    at ``K3_WIDE``, in ``dtype`` at ``batch`` (bf16: the training
    microbatch of 32); each shape's device time by launch from one
    profiled call."""
    from pointreggpt_tpu_torch.tools.profile_k3 import by_kernel
    from torch.profiler import ProfilerActivity, profile

    name = str(dtype).split(".")[-1]
    atol, eps = K3_ATOL[name], (1e-3 if name == "bfloat16" else 1e-5)
    size, peak = torch.tensor([], dtype=dtype).element_size(), PEAK[name]
    rows, cache = [], {}
    for n, c in K1_SHAPES + [K3_WIDE]:
        if (n, c) not in cache:
            args = K1.check_inputs_bwd(batch, n, c, dtype, dev)
            errs, abs_errs = k3_errors(torch, K1, args, eps)
            bad = {k: v for k, v in errs.items()
                   if not np.isfinite(v) or v > atol}
            if bad:
                raise AssertionError(f"K3 {name} at ({batch}, {n}, {c}): "
                                     f"relative errors {bad} > {atol}")
            ms = time_ms(lambda: K1.fused_linear_attention_bwd(*args, eps=eps),
                         5, 1)
            plain_ms = time_ms(
                lambda: K1.fused_linear_attention_bwd_plain(*args, eps=eps),
                2, 1)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                K1.fused_linear_attention_bwd(*args, eps=eps)
                torch.cuda.synchronize()
            launches = by_kernel(torch, prof)
            wk = K1.work_bwd(batch, n, c, size)
            b_ms, b_by = bound(wk, peak)
            cache[(n, c)] = dict(n=n, c=c, rel_err=errs, abs_err=abs_errs,
                                 max_rel_err=max(errs.values()),
                                 max_abs_err=max(abs_errs.values()), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, **cuda_core_bound(wk, name),
                                 device_ms=sum(v["ms"]
                                               for v in launches.values()),
                                 by_launch={k[:60]: v
                                            for k, v in launches.items()},
                                 **wk)
            del args
            torch.cuda.empty_cache()
        rows.append(cache[(n, c)])
    wide, rows = rows[-1], rows[:-1]
    emit(f"k3_{name}", batch=batch, shapes=rows, wide=wide, atol=atol)
    b_ms, b_by = summed_bound(rows, peak)
    by_launch = {}
    for r in rows:
        for k, v in r["by_launch"].items():
            t = by_launch.setdefault(k, {"ms": 0.0, "launches": 0})
            t["ms"] += v["ms"]
            t["launches"] += v["launches"]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows + [wide]),
                max_rel_err=max(r["max_rel_err"] for r in rows + [wide]),
                ms=sum(r["ms"] for r in rows),
                device_ms=sum(r["device_ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=b_ms, bound_by=b_by,
                **cuda_core_bound(summed(rows), name), by_launch=by_launch,
                wide={k: wide[k] for k in ("n", "c", "max_rel_err", "ms",
                                           "device_ms", "plain_ms",
                                           "bound_ms", "bound_by")})


K2_BATCHES = (8, 32)  # generation's batch, the training microbatch


def phase_k2(torch, K2, dev, dtype):
    """K2 against its plain version at (b, 1024, 4, 32) for both batches
    on ``K2.check_inputs``, with SDPA in the same type timed as the library
    yardstick: kernel and SDPA in turns over 3 repeats, each as device time
    (:func:`graph_ms`) and as back-to-back launches (:func:`time_ms`,
    ``event_ms``), medians reported. Returns the batch-8 numbers, the
    training shape's beside them."""
    import torch.nn.functional as F

    name = str(dtype).split(".")[-1]
    atol = K_ATOL[("k2", name)]
    n, h, d = 1024, 4, 32
    scale = d**-0.5
    rows = []
    for b in K2_BATCHES:
        # a peaked softmax, so every k tile and the rescale move the output
        q, k, v = K2.check_inputs(b, n, h, d, dtype, dev)
        out = K2.multihead_attention(q, k, v, scale=scale)
        ref = K2.multihead_attention_plain(q, k, v, scale=scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not np.isfinite(err) or err > atol:
            raise AssertionError(f"K2 {name} at ({b}, {n}, {h}, {d}): max "
                                 f"abs err {err} > {atol}")
        qf, kf, vf = (t.transpose(1, 2) for t in (q, k, v))
        lib = F.scaled_dot_product_attention(qf, kf, vf, scale=scale)
        lib_err = (lib.transpose(1, 2).float() - ref.float()).abs().max()
        def kern():
            return K2.multihead_attention(q, k, v, scale=scale)

        def library():
            return F.scaled_dot_product_attention(qf, kf, vf, scale=scale)

        kern_ms, lib_ms, kern_ev, lib_ev = [], [], [], []
        for _ in range(3):
            kern_ms.append(graph_ms(torch, kern, 20))
            lib_ms.append(graph_ms(torch, library, 20))
            kern_ev.append(time_ms(kern, 50))
            lib_ev.append(time_ms(library, 50))
        plain_ms = time_ms(
            lambda: K2.multihead_attention_plain(q, k, v, scale=scale), 10)
        wk = K2.work(b, n, h, d, q.element_size())
        b_ms, b_by = bound(wk, PEAK[name])
        ms, library_ms = float(np.median(kern_ms)), float(np.median(lib_ms))
        rows.append(dict(shape=[b, n, h, d], max_abs_err=err,
                         library_max_abs_err=lib_err.item(), ms=ms,
                         ms_repeats=kern_ms, plain_ms=plain_ms,
                         library_ms=library_ms, library_ms_repeats=lib_ms,
                         event_ms=float(np.median(kern_ev)),
                         library_event_ms=float(np.median(lib_ev)),
                         vs_library=ms / library_ms, bound_ms=b_ms,
                         bound_by=b_by, **cuda_core_bound(wk, name),
                         tflops=wk["flops"] / ms / 1e9,
                         share_of_bound=b_ms / ms))
        del q, k, v, out, ref, lib
    emit(f"k2_{name}", atol=atol, shapes=rows)
    keys = ("ms", "event_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_event_ms", "vs_library") + (
                ("cuda_core_bound_ms",) if name == "float32" else ())
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                **{k: rows[0][k] for k in keys},
                training_shape={k: rows[1][k] for k in ("shape",) + keys})


K4_N = [65536, 16384, 4096, 1024]  # the U-Net's n at 256^2, batch 8
# max |got - ref| / max |ref|: the core's output is O(1/n) (a weighted mean
# of zero-mean v over ~n/e^4 rows, scaled by 32^-1/2 / n), so an absolute
# bound would pass a kernel that writes zeros; bf16 roundings where the
# plain version rounds, fp32 sums in another order
K4_RTOL = {"bfloat16": 3e-2, "float32": 1e-4}


def phase_k4(torch, K1, dev, dtype):
    """K4 driven through ``linear_attention_core`` at (8, n, 384) for the
    four n, against its plain version on ``K1.check_inputs_core``; each
    shape's device time (a CUDA graph of 20 calls), event time and one
    call's device time by launch (``tools/profile_k4.py``)."""
    from pointreggpt_tpu_torch.tools import errors
    from pointreggpt_tpu_torch.tools.profile_k4 import profile_shape

    name = str(dtype).split(".")[-1]
    rtol, size = K4_RTOL[name], torch.tensor([], dtype=dtype).element_size()
    inputs = {n: K1.check_inputs_core(8, n, dtype, dev) for n in K4_N}
    K1.linear_attention_core.launches = 0
    outs = {n: K1.linear_attention_core(qkv) for n, qkv in inputs.items()}
    torch.cuda.synchronize()
    launches = K1.linear_attention_core.launches
    if launches != len(K4_N):
        raise AssertionError(f"K4 {name}: {launches} launches for "
                             f"{len(K4_N)} calls")
    rows = []
    for n, qkv in inputs.items():
        ref = K1.linear_attention_core_plain(qkv)
        e = errors(outs.pop(n), ref)
        err = e["rel_err"]
        if not np.isfinite(err) or err > rtol:
            raise AssertionError(f"K4 {name} at (8, {n}): relative error "
                                 f"{err} > {rtol}")
        plain_ms = time_ms(lambda: K1.linear_attention_core_plain(qkv), 2, 1)
        del ref
        prof = profile_shape(torch, K1, n, dtype)
        wk = K1.work_core(8, n, size)
        b_ms, b_by = bound(wk, PEAK[name])
        rows.append(dict(n=n, **e, ms=prof["graph_ms"],
                         event_ms=prof["event_ms"], plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         share_of_bound=b_ms / prof["graph_ms"],
                         **cuda_core_bound(wk, name),
                         by_launch=prof["by_launch"], **wk))
    del inputs
    # a row count that is no multiple of the 64-row tile
    qkv = K1.check_inputs_core(8, 1000, dtype, dev)
    odd_err = errors(K1.linear_attention_core(qkv),
                     K1.linear_attention_core_plain(qkv))["rel_err"]
    if not odd_err <= rtol:
        raise AssertionError(f"K4 {name} at (8, 1000): {odd_err} > {rtol}")
    extra = dict(n1000_rel_err=odd_err)
    if name == "float32":
        # the backward: the gradient of the plain version, recomputed
        g = torch.randn(8, 4096, 128, device=dev)
        leaf = K1.check_inputs_core(8, 4096, dtype, dev).requires_grad_()
        K1.linear_attention_core(leaf).backward(g)
        ref = leaf.detach().clone().requires_grad_()
        K1.linear_attention_core_plain(ref).backward(g)
        grad_err = errors(leaf.grad, ref.grad)["rel_err"]
        if not grad_err <= 1e-4:
            raise AssertionError(f"K4 backward at (8, 4096): {grad_err} > "
                                 "1e-4")
        extra["backward_rel_err"] = grad_err
    torch.cuda.empty_cache()
    emit(f"k4_{name}", shapes=rows, rtol=rtol, launches=launches, **extra)
    b_ms, b_by = summed_bound(rows, PEAK[name])
    ms = sum(r["ms"] for r in rows)
    by_launch = {}
    for r in rows:
        for k, v in r["by_launch"].items():
            by_launch[k] = by_launch.get(k, 0.0) + v
    return dict(launches=launches,
                max_rel_err=max(r["rel_err"] for r in rows),
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=ms, event_ms=sum(r["event_ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
                **cuda_core_bound(summed(rows), name), by_launch=by_launch)


CONV_RTOL = 1e-2  # K5 and K6 against their plain versions, bf16
CONV_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 3e-2}


def conv_summary(rows, KC, launches) -> dict:
    """The kernels-line numbers of K5 or K6 from per-shape rows (each with
    shape, ms, plain_ms, library_ms, rel_err, max_abs_err): times summed
    over the shapes, the bound from the summed work."""
    b_ms, b_by = summed_bound([KC.work_conv(*r["shape"], 2) for r in rows],
                              PEAK["bfloat16"])
    ms = sum(r["ms"] for r in rows)
    library_ms = sum(r["library_ms"] for r in rows)
    return dict(launches=launches,
                max_rel_err=max(r["rel_err"] for r in rows),
                max_abs_err=max(r["max_abs_err"] for r in rows), ms=ms,
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, vs_library=ms / library_ms)


def phase_conv_tools(torch, dev):
    """Both conv tools' entry points at their default shapes, launch
    counters reset just before each; K5 and K6 against their plain
    versions at every shape they run, ``conv3x3``'s gradients."""
    from pointreggpt_tpu_torch.ops import conv as KC
    from pointreggpt_tpu_torch.tools import (errors, profile_conv,
                                             profile_conv_igemm)

    KC.conv3x3.launches = KC.conv3_igemm.launches = 0
    pc = profile_conv.main()
    torch.cuda.synchronize()
    k5_launches = KC.conv3x3.launches
    KC.conv3x3.launches = KC.conv3_igemm.launches = 0
    ig = profile_conv_igemm.main()
    torch.cuda.synchronize()
    k6_launches = KC.conv3_igemm.launches

    k5_rows = [dict(shape=r["shape"], **r["kernel"], plain_ms=r["plain_ms"],
                    library_ms=r["conv"]["ms"],
                    grad_rel_err=r["grad_rel_err"], fwd_bwd=r["fwd_bwd"])
               for r in pc["shapes"]]
    k6_rows = [dict(shape=r["shape"], **k, plain_ms=r["plain_ms"],
                    library_ms=r["library_ms"])
               for r in ig["batches"] for k in r["igemm"] if k["rows"] == 8]
    bad = [(r["shape"], r["rel_err"]) for r in k5_rows + k6_rows
           if not r["rel_err"] <= CONV_RTOL]
    if not ig["correctness"]["rel_err"] <= CONV_RTOL:
        bad.append(([2, 32, 32, 64, 64], ig["correctness"]["rel_err"]))
    if bad:
        raise AssertionError(f"conv kernels against their plain versions: "
                             f"{bad} > {CONV_RTOL}")
    (big,) = [r for r in k5_rows if r["shape"] == [16, 256, 256, 128, 64]]
    grad_errs = {"bfloat16": max(big["grad_rel_err"].values())}

    # fp32 gradients at a small shape with edges, cin != cout and a
    # partial tile in every direction
    x, w = KC.check_inputs_conv(2, 9, 37, 70, 36, torch.float32, dev)
    got = [t.detach().requires_grad_() for t in (x, w)]
    (KC.conv3x3(*got) ** 2).sum().backward()
    ref = [t.detach().requires_grad_() for t in (x, w)]
    (KC.conv3x3_plain(*ref) ** 2).sum().backward()
    grad_errs["float32"] = max(errors(a.grad, b.grad)["rel_err"]
                               for a, b in zip(got, ref))
    for name, err in grad_errs.items():
        if not err <= CONV_GRAD_RTOL[name]:
            raise AssertionError(f"conv3x3 gradients {name}: {err} > "
                                 f"{CONV_GRAD_RTOL[name]}")

    # each kernel's bound, rate and share of the bound beside cuDNN's, and
    # its factor against cuDNN, per shape
    for r in k5_rows + k6_rows:
        wk = KC.work_conv(*r["shape"], 2)
        r["bound_ms"], r["bound_by"] = bound(wk, PEAK["bfloat16"])
        r["vs_library"] = r["ms"] / r["library_ms"]
        r["tflops"] = wk["flops"] / r["ms"] / 1e9
        r["library_tflops"] = wk["flops"] / r["library_ms"] / 1e9
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["library_share_of_bound"] = r["bound_ms"] / r["library_ms"]
    fp32 = conv_fp32(torch, KC, dev)
    emit("conv_tools", card=card_line(), rtol=CONV_RTOL,
         grad_rel_err=grad_errs, grad_rtol=CONV_GRAD_RTOL,
         k5_launches=k5_launches, k6_launches=k6_launches, k5=k5_rows,
         k6_small=ig["correctness"], k6=k6_rows, k5_fp32=fp32)
    torch.cuda.empty_cache()
    return (dict(conv_summary(k5_rows, KC, k5_launches), fp32=fp32),
            conv_summary(k6_rows, KC, k6_launches))


CONV_FP32_RTOL = 1e-5  # three TF32 passes keep about 21 bits a product


def conv_fp32(torch, KC, dev) -> dict:
    """K5's fp32 path (three TF32 passes on the tensor cores,
    ``conv3_tf32.cuh``) at the four tool shapes, apart from the bf16 path:
    error against ``conv3x3_plain``, time, bound (three TF32 passes, and
    at the CUDA cores' rate) and fp32 cuDNN (TF32 off), per shape and
    summed."""
    from pointreggpt_tpu_torch.tools import errors, profile_conv

    rows = []
    for shape in profile_conv.SHAPES:
        x, w = KC.check_inputs_conv(*shape, torch.float32, dev)
        with torch.no_grad():
            e = errors(KC.conv3x3(x, w), KC.conv3x3_plain(x, w))
            if not e["rel_err"] <= CONV_FP32_RTOL:
                raise AssertionError(f"K5 fp32 at {shape}: {e['rel_err']} "
                                     f"> {CONV_FP32_RTOL}")
            ms = time_ms(lambda: KC.conv3x3(x, w), 5, 1)
            plain_ms = time_ms(lambda: KC.conv3x3_plain(x, w), 2, 1)
            library_ms = time_ms(lambda: KC.conv_library(x, w), 10)
        wk = KC.work_conv(*shape, 4)
        b_ms, b_by = bound(wk, PEAK["float32"])
        rows.append(dict(shape=list(shape), rel_err=e["rel_err"],
                         max_abs_err=e["max_abs_err"], ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         **cuda_core_bound(wk, "float32"),
                         vs_library=ms / library_ms,
                         tflops=wk["flops"] / ms / 1e9,
                         share_of_bound=b_ms / ms))
        del x, w
        torch.cuda.empty_cache()
    works = [KC.work_conv(*r["shape"], 4) for r in rows]
    b_ms, b_by = summed_bound(works, PEAK["float32"])
    ms = sum(r["ms"] for r in rows)
    library_ms = sum(r["library_ms"] for r in rows)
    return dict(shapes=rows, rtol=CONV_FP32_RTOL,
                max_rel_err=max(r["rel_err"] for r in rows),
                max_abs_err=max(r["max_abs_err"] for r in rows), ms=ms,
                plain_ms=sum(r["plain_ms"] for r in rows), bound_ms=b_ms,
                bound_by=b_by, **cuda_core_bound(summed(works), "float32"),
                library_ms=library_ms, vs_library=ms / library_ms)


def let_cores_count(torch, net, *inputs) -> None:
    """Let each LinearAttention's core, not its to_out bias, carry the
    block's output, as K1.check_inputs does: zero the bias and scale the
    weight by n^1.5 / 2 for the block's n pixels at the size of
    ``inputs`` (what ``net`` takes)."""
    from pointreggpt_tpu_torch.models.blocks import LinearAttention

    pixels = {}

    def count_pixels(mod, args):
        pixels[mod] = args[0].shape[2] * args[0].shape[3]

    hooks = [m.register_forward_pre_hook(count_pixels)
             for m in net.modules() if isinstance(m, LinearAttention)]
    with torch.inference_mode():
        net(*inputs)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        for m, n in pixels.items():
            m.to_out[0].bias.zero_()
            m.to_out[0].weight.mul_(n**1.5 / 2)


def phase_net_parity(torch, dev):
    """A dim-64 DiffusionUNet forward (fp32, 64^2) on the card against the
    same net on the CPU, with weights on which K1's core counts."""
    from pointreggpt_tpu_torch.models import DiffusionUNet

    torch.manual_seed(0)
    net = DiffusionUNet(dim=64).eval()
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(2, 1, 64, 64)), dtype=torch.float32)
    t = torch.tensor([10.0, 900.0])
    pc = torch.tensor(rng.uniform(100, 600, (2, 4)), dtype=torch.float32)
    cl = torch.channels_last
    let_cores_count(torch, net, x, t, pc)
    with torch.inference_mode():
        ref = net(x, t, pc)
        gpu = net.to(dev, memory_format=cl)(
            x.to(dev, memory_format=cl), t.to(dev), pc.to(dev)).cpu()
    err = (gpu - ref).abs().max().item()
    if not np.isfinite(err) or err > NET_ATOL:
        raise AssertionError(f"U-Net card vs CPU: {err} > {NET_ATOL}")
    emit("net_parity", max_abs_err=err, atol=NET_ATOL)


# first match wins: K3's kernels share K1's and cuDNN's name fragments
_CATEGORIES = (
    ("k3", ("bwd_kv_partials", "bwd_merge_context", "q_path_bwd",
            "fold_context", "kv_path_bwd", "wgrad_partials",
            "reduce_partials")),
    ("k1", ("kv_partials", "merge_context", "emit_out")),
    ("k2", ("flash_fwd",)),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad",
              "sm90_", "cutlass", "gemm", "nchw", "nhwc")),
    ("group_norm", ("group_norm", "groupnorm", "GroupNorm")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "unrolled",
                     "CatArray", "copy")),
)


def device_time(torch, prof) -> dict:
    """Device time of a profiled window: in all, by kernel category, and
    its twelve largest kernels (ms)."""
    cats, kernels, total, n = {}, {}, 0.0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        n += 1
        total += us
        kernels[ev.name] = kernels.get(ev.name, 0.0) + us
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in ev.name for k in keys)), "other")
        cats[cat] = cats.get(cat, 0.0) + us
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return dict(device_ms=total / 1e3, busy_ms=busy_ms(torch, prof),
                kernels_launched=n,
                by_category_ms={k: v / 1e3 for k, v in sorted(cats.items())},
                top_kernels_ms=[[k[:90], v / 1e3] for k, v in top])


def busy_ms(torch, prof) -> float:
    """The time in a profiled window when at least one device activity ran
    (the union of their intervals): unlike their sum it cannot exceed the
    window, where activities overlap."""
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def phase_forward_profile(torch, dev):
    """Device time of one production DiffusionUNet forward (dim 64, bf16,
    baked, 256^2, batch 8) and of one fp32 MaskUNet forward (dim 64, the
    keep-mask's), by kernel category, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.models.bake import bake_inference

    torch.manual_seed(0)
    net = bake_inference(C.build_diffusion_unet(C.ModelConfig()).eval(),
                         torch.bfloat16)
    net = net.to(dev, memory_format=torch.channels_last)
    x = torch.randn(8, 1, 256, 256, device=dev).contiguous(
        memory_format=torch.channels_last)
    t = torch.full((8,), 500.0, device=dev)
    pc = torch.tensor([[300.0, 300.0, 128.0, 128.0]] * 8, device=dev)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: net(x, t, pc), 10, warmup=3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            net(x, t, pc)
            torch.cuda.synchronize()
    mask = C.build_mask_unet(C.MaskModelConfig()).eval().to(
        dev, memory_format=torch.channels_last)
    with torch.inference_mode():
        mask_ms = time_ms(lambda: mask(x), 3, warmup=1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as mask_prof:
            mask(x)
            torch.cuda.synchronize()
    emit("forward_profile", forward_ms=fwd_ms, mask_forward_fp32_ms=mask_ms,
         mask_forward_fp32=device_time(torch, mask_prof),
         **device_time(torch, prof))
    del net, mask, x
    torch.cuda.empty_cache()


MASK_BATCH = 4  # the MaskTrainer's microbatch (its config's batch size)
MASK_PARITY_BATCH = 1  # card vs CPU: one image of it, for the CPU's time
MASK_STEPS = 10  # timed steps, after the warm-up
MASK_SETTLE = 0.05  # warm-up ends when three steps lie within 5%
MASK_WARMUP_MAX = 12


def mask_loss(torch, prob, target):
    """The MaskTrainer's loss: binary cross entropy on the keep
    probabilities, each log term floored at -100."""
    tiny = torch.finfo(torch.float32).tiny
    log_p = torch.log(prob.clamp_min(tiny)).clamp_min(-100.0)
    log_q = torch.log((1 - prob).clamp_min(tiny)).clamp_min(-100.0)
    return -(target * log_p + (1 - target) * log_q).mean()


def phase_mask_fwd_bwd(torch, K1, K2, dev):
    """One fp32 MaskUNet (``MaskModelConfig``: dim 64, (1, 2, 4, 8), 8
    groups) forward and backward of the MaskTrainer's loss at its
    microbatch, 4 x 256^2: K1, K2 and K3 launch in fp32 (counted; none
    routed to a plain version); the step's time by CUDA events once it has
    settled, and the device time by kernel category (summed and busy) of
    one more step, timed alike; the loss gradients card against CPU
    (fp32, ``GRAD_RTOL``) at ``MASK_PARITY_BATCH`` images, with each
    LinearAttention's core carrying its output."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.models.blocks import LinearAttention

    def inputs(batch, seed):
        rng = np.random.default_rng(seed)
        depth = rng.uniform(0.2, 1.0, (batch, 1, 256, 256))
        depth[rng.uniform(size=depth.shape) < 0.05] = 0.0  # invalid pixels
        target = (rng.uniform(size=depth.shape) < 0.7).astype(np.float64)
        return (torch.tensor(depth, dtype=torch.float32),
                torch.tensor(target, dtype=torch.float32))

    def step(net, depth, target):
        mask_loss(torch, net(depth), target).backward()

    torch.manual_seed(0)
    net = C.build_mask_unet(C.MaskModelConfig()).to(
        memory_format=torch.channels_last)
    n_attn = sum(isinstance(m, LinearAttention) for m in net.modules())
    depth, target = inputs(MASK_PARITY_BATCH, 5)
    let_cores_count(torch, net, depth)
    gpu_net = copy.deepcopy(net).to(dev, memory_format=torch.channels_last)
    step(net, depth, target)
    reset_counts(K1, K2)
    step(gpu_net, depth.to(dev), target.to(dev))
    torch.cuda.synchronize()
    worst, worst_name = grad_errors(torch, net, gpu_net)
    if worst > GRAD_RTOL:
        raise AssertionError(f"mask_fwd_bwd: {worst_name} card vs CPU "
                             f"{worst} > {GRAD_RTOL}")
    del net

    depth, target = (t.to(dev) for t in inputs(MASK_BATCH, 6))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)

    def timed_step() -> float:
        gpu_net.zero_grad(set_to_none=True)
        e0.record()
        step(gpu_net, depth, target)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    # warm up until the last three steps lie within MASK_SETTLE of their
    # median (the allocator's pool and cuDNN's workspaces grow in the first
    # steps), at most MASK_WARMUP_MAX steps
    warm = [timed_step() for _ in range(3)]
    while (len(warm) < MASK_WARMUP_MAX and
           np.ptp(warm[-3:]) > MASK_SETTLE * np.median(warm[-3:])):
        warm.append(timed_step())
    reset_counts(K1, K2)
    times = [timed_step() for _ in range(MASK_STEPS)]
    k1_n, k3_n, k2_n, routes = counts(K1, K2)
    want = (MASK_STEPS * n_attn, MASK_STEPS * n_attn, MASK_STEPS)
    if (k1_n, k3_n, k2_n) != want:
        raise AssertionError(f"mask_fwd_bwd launches K1, K3, K2 = "
                             f"{(k1_n, k3_n, k2_n)} over {MASK_STEPS} "
                             f"steps, want {want}")
    check_no_routes("mask_fwd_bwd", routes)
    bad = [n for n, p in gpu_net.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    if bad:
        raise AssertionError(f"mask_fwd_bwd: gradients not finite {bad[:4]}")
    # the profiled step follows the timed ones and is timed alike, so its
    # breakdown belongs to the settled steps it is reported beside
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed_step()
    emit("mask_fwd_bwd", card=card_line(), batch=MASK_BATCH, image=256,
         warmup_ms=warm, step_ms=float(np.median(times)),
         step_ms_min=min(times), step_ms_max=max(times), step_ms_all=times,
         profiled_step_ms=profiled_ms,
         k1_per_step=k1_n / MASK_STEPS, k3_per_step=k3_n / MASK_STEPS,
         k2_per_step=k2_n / MASK_STEPS, plain_routes=routes,
         grad_parity_batch=MASK_PARITY_BATCH, grad_max_rel_err=worst,
         grad_worst=worst_name, grad_rtol=GRAD_RTOL,
         fwd_bwd=device_time(torch, prof))
    del gpu_net, depth, target, prof
    torch.cuda.empty_cache()


def write_synthetic_tree(root: Path, n_scenes: int, seed: int):
    """A 3DMatch-style tree: per scene an rgbd frame (uint16 mm depth
    around 2-2.8 m), intrinsics, info files, and the train_info pool."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    rgbd, indoor = root / "rgbd", root / "indoor"
    info = {"src": [], "tgt": []}
    for s in range(n_scenes):
        name = f"scene-{s}"
        seq = rgbd / name / "seq-01"
        seq.mkdir(parents=True)
        np.savetxt(rgbd / name / "camera-intrinsics.txt",
                   np.array([[585.0, 0, 320.0], [0, 585.0, 240.0],
                             [0, 0, 1]]))
        yy, xx = np.mgrid[0:480, 0:640]
        depth = 2000 + 400 * np.sin(xx / 90.0 + s) * np.cos(yy / 70.0) + \
            rng.integers(0, 40, (480, 640))
        Image.fromarray(depth.astype(np.uint16)).save(
            seq / "frame-000000.depth.png")
        np.savetxt(seq / "frame-000000.pose.txt", np.eye(4))
        (indoor / name).mkdir(parents=True)
        for role in ("src", "tgt"):
            (indoor / name / f"{role}.info.txt").write_text(
                f"{name} seq-01 0 0\n")
            info[role].append(f"{name}/{role}.pth")
    with open(root / "train_info.pkl", "wb") as f:
        pickle.dump(info, f)
    return rgbd, indoor, root / "train_info.pkl"


def write_checkpoints(torch, root: Path, seed: int):
    """Random-weight checkpoints in the reference layout: the diffusion
    state dict holds the U-Net under ``model.``, the EMA wraps it again."""
    from pointreggpt_tpu_torch import config as C

    torch.manual_seed(seed)
    unet = C.build_diffusion_unet(C.ModelConfig())
    sd = {f"model.{k}": v for k, v in unet.state_dict().items()}
    ema = {f"ema_model.{k}": v for k, v in sd.items()}
    ema.update({f"online_model.{k}": v for k, v in sd.items()})
    ema["initted"] = torch.tensor(True)
    ema["step"] = torch.tensor(0)
    (root / "results").mkdir()
    torch.save({"step": 0, "model": sd, "ema": ema},
               root / "results" / "model-1.pt")
    mask = C.build_mask_unet(C.MaskModelConfig())
    (root / "depth_correction_results").mkdir()
    torch.save({"epoch": 0, "model": mask.state_dict()},
               root / "depth_correction_results" / "model-best.pt")


def reset_counts(K1, K2) -> None:
    """Launch counters of K1, K3 and K2, and K1's and K3's plain routes,
    to 0 just before an entry point runs."""
    for op in (K1.fused_linear_attention, K1.fused_linear_attention_bwd):
        op.launches = op.plain_routes = 0
    K2.multihead_attention.launches = 0


def counts(K1, K2) -> tuple:
    """(K1, K3, K2 launches, {"k1": K1's plain routes, "k3": K3's})."""
    return (K1.fused_linear_attention.launches,
            K1.fused_linear_attention_bwd.launches,
            K2.multihead_attention.launches,
            {"k1": K1.fused_linear_attention.plain_routes,
             "k3": K1.fused_linear_attention_bwd.plain_routes})


def check_no_routes(where: str, routes: dict) -> None:
    """The production paths give K1 and K3 only shapes they take."""
    if any(routes.values()):
        raise AssertionError(f"{where}: calls routed to the plain version "
                             f"by shape {routes}, want none")


def phase_main_path(torch, K1, K2, seed: int, num_samples: int):
    from pointreggpt_tpu_torch.cli import generate_dataset
    from pointreggpt_tpu_torch.core import plyio
    from pointreggpt_tpu_torch.generate import generator as gen_mod

    batch, image_size = 8, 256
    step_ms = []
    orig_step = gen_mod.Generator.step

    def timed_step(self, *a, **kw):
        # device time of each step, read by events (no host sync)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig_step(self, *a, **kw)
        e1.record()
        step_ms.append((e0, e1))
        return out

    with tempfile.TemporaryDirectory(prefix="prgpt_smoke_") as tmp:
        root = Path(tmp)
        rgbd, indoor, info = write_synthetic_tree(root, batch, seed)
        write_checkpoints(torch, root, seed)
        cwd = os.getcwd()
        os.chdir(root)
        gen_mod.Generator.step = timed_step
        reset_counts(K1, K2)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate_dataset.main([
                "--resume", "1", "--data", str(rgbd),
                "--train_info_path", str(info), "--data_root", str(indoor),
                "--results_folder", str(root / "results"),
                "-start", "0", "-stop", str(batch),
                "--batch_size", str(batch),
                "--num_samples", str(num_samples),
                "--image_size", str(image_size), "--seed", str(seed)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            gen_mod.Generator.step = orig_step
            os.chdir(cwd)
        k1_n, k3_n, k2_n, routes = counts(K1, K2)
        want = (2016 * num_samples, 0, 252 * num_samples)
        if (k1_n, k3_n, k2_n) != want:
            raise AssertionError(
                f"kernel launches on the main path: K1, K3, K2 = "
                f"{(k1_n, k3_n, k2_n)}, want {want}")
        check_no_routes("main_path", routes)

        out = root / "generated_dataset" / "data"
        for s in range(batch):
            scene = out / f"scene-{s:06d}"
            for f in ("camera-intrinsics.txt", "sample-000000.image.png",
                      "sample-000000.cloud.ply", "reprojected.image.png",
                      "corrected.image.png",
                      *(f"sample-{i:06d}.{ext}"
                        for i in range(1, num_samples + 1)
                        for ext in ("pose.txt", "image.png", "depth.png")),
                      "sample-000001.cloud.ply"):
                if not (scene / f).is_file():
                    raise AssertionError(f"missing output {scene / f}")
            pose = np.loadtxt(scene / "sample-000001.pose.txt")
            from PIL import Image
            depth = np.asarray(Image.open(scene / "sample-000001.depth.png"))
            cloud = plyio.read_ply(scene / "sample-000001.cloud.ply")
            if pose.shape != (4, 4) or not np.all(np.isfinite(pose)) or \
                    not np.allclose(pose[3], [0, 0, 0, 1], atol=1e-6):
                raise AssertionError(f"bad pose in {scene}")
            if depth.shape != (image_size, image_size):
                raise AssertionError(f"bad depth PNG shape {depth.shape}")
            if cloud.ndim != 2 or cloud.shape[1] != 3 or \
                    not np.all(np.isfinite(cloud)):
                raise AssertionError(f"bad cloud in {scene}")
    steps = [a.elapsed_time(b) / 1e3 for a, b in step_ms]
    sec_per_step = steps[-1]
    res = dict(wall_s=wall, num_samples=num_samples, batch=batch,
               step_device_s=steps, sec_per_sample_step=sec_per_step,
               pairs_per_min=batch * 60.0 / sec_per_step,
               k1_launches=k1_n, k3_launches=k3_n, k2_launches=k2_n,
               plain_routes=routes, k1_per_step=k1_n / num_samples,
               k3_per_step=k3_n / num_samples,
               k2_per_step=k2_n / num_samples)
    emit("main_path", card=card_line(), **res)
    return res


GRAD_RTOL = 2e-3  # fp32 gradients, card vs CPU, per parameter


def phase_grad_parity(torch, dev):
    """``p_losses`` gradients of a dim-64 fp32 DiffusionUNet at 64^2, batch
    2, on the card (K1, K3, K2 and its recompute) against the CPU (plain
    versions), with t and noise injected and each LinearAttention's core
    carrying its output."""
    import copy

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.models import DiffusionUNet

    torch.manual_seed(0)
    net = DiffusionUNet(dim=64).to(memory_format=torch.channels_last)
    rng = np.random.default_rng(3)
    x0 = torch.tensor(rng.uniform(-1, 1, (2, 64, 64, 1)), dtype=torch.float32)
    noise = torch.tensor(rng.normal(size=(2, 64, 64, 1)), dtype=torch.float32)
    t = torch.tensor([40, 730])
    pc = torch.tensor(rng.uniform(100, 600, (2, 4)), dtype=torch.float32)
    let_cores_count(torch, net, x0.permute(0, 3, 1, 2), t.float(), pc)
    diffusion = C.build_diffusion(C.DiffusionConfig(image_size=64))
    gpu_net = copy.deepcopy(net).to(dev, memory_format=torch.channels_last)
    diffusion.p_losses(net, x0, t, pc, noise=noise).backward()
    diffusion.p_losses(gpu_net, x0.to(dev), t.to(dev), pc.to(dev),
                       noise=noise.to(dev)).backward()
    worst, worst_name = grad_errors(torch, net, gpu_net)
    if worst > GRAD_RTOL:
        raise AssertionError(f"grad_parity: {worst_name} card vs CPU "
                             f"{worst} > {GRAD_RTOL}")
    emit("grad_parity", max_rel_err=worst, worst=worst_name,
         rtol=GRAD_RTOL)


def grad_errors(torch, net, gpu_net) -> tuple:
    """Largest per-parameter max |card - CPU| / max |CPU| of the loss
    gradients, and its parameter's name."""
    worst, worst_name = 0.0, ""
    for (name, p), q in zip(net.named_parameters(), gpu_net.parameters()):
        ref = p.grad.abs().max().item()
        err = (q.grad.cpu() - p.grad).abs().max().item() / max(ref, 1e-30)
        if not np.isfinite(err):
            raise AssertionError(f"gradient of {name} not finite")
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name


WIDE_DIM = 256  # a DiffusionUNet whose up_0 LinearAttention has c = 2048


def phase_wide_net(torch, K1, K2, dev):
    """A dim-256 DiffusionUNet, LinearAttention at c = 256 .. 2048: K1
    against its plain version at (8, 1024, 2048) in both types; the fp32
    ``p_losses`` gradients at 64^2, batch 2, card against CPU (2e-3), with
    all 8 K1 and 8 K3 calls launched and none routed to the plain version;
    one bf16 forward + backward of the same net on the card (finite
    gradients, launched, none routed)."""
    import copy

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.models import DiffusionUNet
    from pointreggpt_tpu_torch.models.blocks import LinearAttention

    k1_err, k1_wide = {}, {}
    for dtype, eps in ((torch.bfloat16, 1e-3), (torch.float32, 1e-5)):
        name = str(dtype).split(".")[-1]
        args = K1.check_inputs(8, *K3_WIDE, dtype, dev)
        err = (K1.fused_linear_attention(*args, eps=eps).float() -
               K1.fused_linear_attention_plain(*args, eps=eps).float()
               ).abs().max().item()
        if not err <= K_ATOL[("k1", name)]:
            raise AssertionError(f"K1 {name} at (8, {K3_WIDE}): {err}")
        k1_err[name] = err
        # its time (device time, as phase_k1 takes it) beside its bound
        wk = K1.work(8, *K3_WIDE, args[0].element_size())
        b_ms, b_by = bound(wk, PEAK[name])
        k1_wide[name] = dict(
            ms=graph_ms(torch, lambda: K1.fused_linear_attention(*args,
                                                                 eps=eps), 10),
            plain_ms=time_ms(lambda: K1.fused_linear_attention_plain(
                *args, eps=eps), 3, 1),
            bound_ms=b_ms, bound_by=b_by, **cuda_core_bound(wk, name))
        del args

    cl = torch.channels_last
    torch.manual_seed(0)
    net = DiffusionUNet(dim=WIDE_DIM).to(memory_format=cl)
    widths = sorted({m.to_qkv.in_channels for m in net.modules()
                     if isinstance(m, LinearAttention)})
    if max(widths) != 2048:
        raise AssertionError(f"dim-{WIDE_DIM} LinearAttention widths "
                             f"{widths}")
    rng = np.random.default_rng(4)
    x0 = torch.tensor(rng.uniform(-1, 1, (2, 64, 64, 1)), dtype=torch.float32)
    noise = torch.tensor(rng.normal(size=(2, 64, 64, 1)), dtype=torch.float32)
    t = torch.tensor([40, 730])
    pc = torch.tensor(rng.uniform(100, 600, (2, 4)), dtype=torch.float32)
    let_cores_count(torch, net, x0.permute(0, 3, 1, 2), t.float(), pc)
    diffusion = C.build_diffusion(C.DiffusionConfig(image_size=64))
    gpu_net = copy.deepcopy(net).to(dev, memory_format=cl)
    diffusion.p_losses(net, x0, t, pc, noise=noise).backward()
    reset_counts(K1, K2)
    gpu = (x0.to(dev), t.to(dev), pc.to(dev))
    diffusion.p_losses(gpu_net, *gpu, noise=noise.to(dev)).backward()
    torch.cuda.synchronize()
    k1_n, k3_n, _, routes = counts(K1, K2)
    if (k1_n, k3_n) != (8, 8):
        raise AssertionError(f"wide_net fp32 K1, K3 launches {(k1_n, k3_n)}"
                             ", want (8, 8)")
    check_no_routes("wide_net fp32", routes)
    worst, worst_name = grad_errors(torch, net, gpu_net)
    if worst > GRAD_RTOL:
        raise AssertionError(f"wide_net: {worst_name} card vs CPU {worst} "
                             f"> {GRAD_RTOL}")
    del net

    # bf16 compute, as the Trainer runs it: K1 bf16 at c = 2048 keeps its
    # tile of y in out's rows, K3 bf16 streams its weights
    bnet = DiffusionUNet(dim=WIDE_DIM, dtype=torch.bfloat16).to(
        dev, memory_format=cl)
    bnet.load_state_dict(gpu_net.state_dict())
    del gpu_net
    reset_counts(K1, K2)
    loss = diffusion.p_losses(bnet, *gpu, noise=noise.to(dev))
    loss.backward()
    torch.cuda.synchronize()
    bk1, bk3, _, broutes = counts(K1, K2)
    if (bk1, bk3) != (8, 8):
        raise AssertionError(f"wide_net bf16 K1, K3 launches {(bk1, bk3)}, "
                             "want (8, 8)")
    check_no_routes("wide_net bf16", broutes)
    bad = [n for n, p in bnet.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    if bad or not np.isfinite(loss.item()):
        raise AssertionError(f"wide_net bf16: loss {loss.item()}, "
                             f"gradients not finite {bad[:4]}")
    emit("wide_net", dim=WIDE_DIM, widths=widths, k1_wide_max_abs_err=k1_err,
         k1_wide=k1_wide,
         max_rel_err=worst, worst=worst_name, rtol=GRAD_RTOL,
         launches_fp32=[k1_n, k3_n], launches_bf16=[bk1, bk3],
         plain_routes=routes, bf16_loss=loss.item())
    del bnet
    torch.cuda.empty_cache()


def write_training_tree(root: Path, n_frames: int, seed: int):
    """A 3DMatch-RGBD-style training tree: ``n_frames`` 480x640 uint16 mm
    depth frames over 4 scenes with their intrinsics, and the gt.log that
    lists them; returns (folder, gt_log)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    folder, lines = root / "rgbd_train", []
    yy, xx = np.mgrid[0:480, 0:640]
    for f in range(n_frames):
        scene = folder / f"scene-{f % 4}"
        seq = scene / "seq-01"
        if not seq.exists():
            seq.mkdir(parents=True)
            np.savetxt(scene / "camera-intrinsics.txt",
                       np.array([[585.0, 0, 320.0], [0, 585.0, 240.0],
                                 [0, 0, 1]]))
        depth = 2000 + 600 * np.sin(xx / 70.0 + f) * np.cos(yy / 50.0) + \
            rng.integers(0, 60, (480, 640))
        name = f"frame-{f // 4:06d}.depth.png"
        Image.fromarray(depth.astype(np.uint16)).save(seq / name)
        lines.append(f"scene-{f % 4}/seq-01/{name}")
    gt_log = root / "gt.log"
    gt_log.write_text("\n".join(lines) + "\n")
    return str(folder), str(gt_log)


def phase_train_step(torch, K1, K2, folder: str, gt_log: str, tmp: Path):
    """One production optimizer step (microbatch 32 x accumulation 2,
    256^2, bf16 compute, fp32 params): seconds by CUDA events after two
    warm-up steps, img/s, peak memory, launches per step, and the device
    time of one microbatch forward + backward by kernel category."""
    from torch.profiler import ProfilerActivity, profile

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.train.trainer import Trainer

    cfg = C.TrainConfig()
    torch.manual_seed(0)
    trainer = Trainer(
        C.build_diffusion_unet(C.ModelConfig()),
        C.build_diffusion(C.DiffusionConfig()), folder,
        train_batch_size=cfg.train_batch_size,
        gradient_accumulate_every=cfg.gradient_accumulate_every,
        train_lr=cfg.train_lr, results_folder=str(tmp / "step_results"),
        samples_folder=str(tmp / "step_samples"), gt_log=gt_log)
    gen = torch.Generator(device="cuda").manual_seed(0)
    img, intr = trainer._upload(next(trainer.dl))
    for _ in range(2):
        trainer.train_step(img, intr, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K1, K2)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    loss = trainer.train_step(img, intr, gen)
    e1.record()
    torch.cuda.synchronize()
    *launched, routes = counts(K1, K2)
    if tuple(launched) != (16, 16, 2):
        raise AssertionError(f"train_step launches K1, K3, K2 = {launched}, "
                             "want (16, 16, 2)")
    check_no_routes("train_step", routes)
    sec = e0.elapsed_time(e1) / 1e3
    peak = torch.cuda.max_memory_allocated()
    times = [sec]
    for _ in range(2):
        e0.record()
        trainer.train_step(img, intr, gen)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / 1e3)
    if not np.isfinite(loss.item()):
        raise AssertionError(f"train_step: loss {loss.item()}")
    model, diffusion = trainer.model, trainer.diffusion
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        diffusion.training_loss(model, img[0], intr[0], gen).backward()
        torch.cuda.synchronize()
    sec = float(np.mean(times))
    res = dict(sec_per_step=sec, step_s=times,
               img_per_s=cfg.train_batch_size *
               cfg.gradient_accumulate_every / sec,
               peak_mem_gb=peak / 1e9, loss=loss.item(),
               k1_per_step=launched[0], k3_per_step=launched[1],
               k2_per_step=launched[2], plain_routes=routes)
    emit("train_step", card=card_line(), microbatch=cfg.train_batch_size,
         accum=cfg.gradient_accumulate_every, **res,
         microbatch_fwd_bwd=device_time(torch, prof))
    del trainer, model, img, intr, prof
    torch.cuda.empty_cache()


def phase_train_path(torch, K1, K2, folder: str, gt_log: str, tmp: Path):
    """The training main path: ``pointreggpt_tpu_torch.cli.
    train_successive_ddnm_diffusion.main`` at the production configuration
    for 3 steps with a milestone at step 3 (a 25-image EMA grid with 250
    DDIM steps, and model-0.pt); checks the losses, the grid, the
    checkpoint's layout, that the Generator loads it, and the launches."""
    from PIL import Image

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.cli import train_successive_ddnm_diffusion
    from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
    from pointreggpt_tpu_torch.generate import Generator
    from pointreggpt_tpu_torch.train import checkpoint as ckpt
    from pointreggpt_tpu_torch.train import trainer as trainer_mod

    losses, steps, marks = [], 3, []
    Trainer = trainer_mod.Trainer
    orig_step, orig_save = Trainer.train_step, Trainer._save_and_sample

    def launched():
        return counts(K1, K2)[:3]

    def recorded(self, *a, **kw):
        out = orig_step(self, *a, **kw)
        losses.append(out)
        return out

    def marked(self, *a, **kw):
        # the milestone's launches (the EMA grid) are counted apart from
        # the optimizer steps'
        marks.append(launched())
        orig_save(self, *a, **kw)
        marks.append(launched())

    results = tmp / "train_results"
    Trainer.train_step, Trainer._save_and_sample = recorded, marked
    try:
        torch.cuda.synchronize()
        reset_counts(K1, K2)
        t0 = time.perf_counter()
        train_successive_ddnm_diffusion.main([
            "--data", folder, "--gt_log", gt_log,
            "--results_folder", str(results),
            "--samples_folder", str(tmp / "train_samples"),
            "--train_num_steps", str(steps),
            "--save_and_sample_every", str(steps)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        *total, routes = counts(K1, K2)
    finally:
        Trainer.train_step, Trainer._save_and_sample = orig_step, orig_save
    if len(marks) != 2:
        raise AssertionError(f"train_path: {len(marks) // 2} milestones, "
                             "want 1")
    grid_n = tuple(b - a for a, b in zip(*marks))
    step_n = tuple(t - g for t, g in zip(total, grid_n))
    # per optimizer step 16 K1, 16 K3, 2 K2; the grid draws 250 DDIM
    # forwards of 8 K1 and 1 K2 each
    want_step, want_grid = (16 * steps, 16 * steps, 2 * steps), (2000, 0, 250)
    if (step_n, grid_n) != (want_step, want_grid):
        raise AssertionError(
            f"train_path launches K1, K3, K2: steps {step_n} (want "
            f"{want_step}), grid {grid_n} (want {want_grid})")
    check_no_routes("train_path", routes)
    losses = [v.item() for v in losses]
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"train_path losses {losses}")
    grid = Image.open(results / "sample-1.png")
    if grid.size != (5 * 256, 5 * 256):
        raise AssertionError(f"sample-1.png is {grid.size}, want a 5x5 "
                             "grid of 256^2 images")
    data = ckpt.load_checkpoint(results / "model-0.pt")
    net = C.build_diffusion_unet(C.ModelConfig())
    keys = set(net.state_dict())
    layout = (set(data) == {"step", "model", "opt", "ema", "version"}
              and data["step"] == steps
              and set(data["model"]) == {f"model.{k}" for k in keys}
              and {f"ema_model.model.{k}" for k in keys} <= set(data["ema"])
              and {f"online_model.model.{k}" for k in keys}
              <= set(data["ema"])
              and len(data["opt"]["state"]) == len(keys))
    if not layout:
        raise AssertionError("model-0.pt does not have the reference layout")
    gen = Generator(net, GaussianDiffusion(image_size=256), folder,
                    results_folder=str(results),
                    samples_folder=str(tmp / "gen_samples"))
    gen.load(0)
    for k, v in net.state_dict().items():
        if not torch.equal(v, data["ema"][f"ema_model.model.{k}"]):
            raise AssertionError(f"Generator.load: {k} differs")
    res = dict(wall_s=wall, steps=steps, losses=losses,
               k1_launches=total[0], k3_launches=total[1],
               k2_launches=total[2], plain_routes=routes,
               per_optimizer_step=[v / steps for v in step_n],
               grid_launches=list(grid_n))
    emit("train_path", card=card_line(), **res)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num_samples", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from pointreggpt_tpu_torch.ops import _build
    from pointreggpt_tpu_torch.ops import attention as K2
    from pointreggpt_tpu_torch.ops import linear_attention as K1

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[_build.library_path(n).name for n in _build.SOURCES])

    k1 = phase_k1(torch, K1, dev, torch.bfloat16)
    k1_f32 = phase_k1(torch, K1, dev, torch.float32)
    k2 = phase_k2(torch, K2, dev, torch.bfloat16)
    k2_f32 = phase_k2(torch, K2, dev, torch.float32)
    k3 = phase_k3(torch, K1, dev, torch.bfloat16, 32)
    k3_f32 = phase_k3(torch, K1, dev, torch.float32, 8)
    k4 = phase_k4(torch, K1, dev, torch.bfloat16)
    k4_f32 = phase_k4(torch, K1, dev, torch.float32)
    k5, k6 = phase_conv_tools(torch, dev)
    phase_net_parity(torch, dev)
    phase_forward_profile(torch, dev)
    phase_grad_parity(torch, dev)
    phase_wide_net(torch, K1, K2, dev)
    phase_mask_fwd_bwd(torch, K1, K2, dev)
    with tempfile.TemporaryDirectory(prefix="prgpt_train_") as tmp:
        tmp = Path(tmp)
        folder, gt_log = write_training_tree(tmp, 64, args.seed)
        phase_train_step(torch, K1, K2, folder, gt_log, tmp)
        main_res = phase_main_path(torch, K1, K2, args.seed,
                                   args.num_samples)
        train_res = phase_train_path(torch, K1, K2, folder, gt_log, tmp)
    sample_steps = main_res["num_samples"]

    # launches: both main paths (generation, then training), each counted
    # from 0 just before its entry point runs; per sample step of
    # generation, and per optimizer step of training (its milestone grid
    # counted apart)
    def launches(i, key):
        return dict(launches=main_res[key] + train_res[key],
                    launches_generate=main_res[key],
                    launches_train=train_res[key],
                    per_sample_step=main_res[key] / sample_steps,
                    per_optimizer_step=train_res["per_optimizer_step"][i],
                    launches_train_grid=train_res["grid_launches"][i])

    csrc = "pointreggpt_tpu_torch/ops/csrc/"
    KV_HEADER, TC_HEADER, BWD_TC_HEADER, CONV_HEADER, TF32_HEADER = (
        csrc + "linear_attention_kv.cuh", csrc + "linear_attention_tc.cuh",
        csrc + "linear_attention_bwd_tc.cuh", csrc + "conv3_tc.cuh",
        csrc + "linear_attention_tf32.cuh")
    BWD_TF32_HEADER, CONV_TF32_HEADER = (
        csrc + "linear_attention_bwd_tf32.cuh", csrc + "conv3_tf32.cuh")

    # calls routed to the plain version by shape on both main paths (each
    # phase checked them 0)
    def routes(key):
        return dict(plain_routes=main_res["plain_routes"][key] +
                    train_res["plain_routes"][key])
    kernels = [
        dict(name="fused_linear_attention", route="cuda",
             source="pointreggpt_tpu_torch/ops/csrc/linear_attention.cu",
             headers=[TC_HEADER, TF32_HEADER, KV_HEADER],
             replaces="pointreggpt_tpu/ops/linear_attention.py:202",
             **launches(0, "k1_launches"), **routes("k1"), library_ms=None,
             work="the 8 calls of one dim-64 U-Net forward, bf16, batch 8, "
                  "256^2 (times and bounds summed over the 8 shapes; ms is "
                  "device time, a CUDA graph of 10 calls, event_ms "
                  "back-to-back launches); bf16 "
                  "on the tensor cores (linear_attention_tc.cuh), fp32 "
                  "(under fp32) kernels A and C in three TF32 passes on "
                  "the tensor cores (linear_attention_tf32.cuh), bound_ms "
                  "at 494.7 / 3 TFLOP/s, cuda_core_bound_ms at 67",
             fp32=k1_f32, **k1),
        dict(name="multihead_attention", route="cuda",
             source="pointreggpt_tpu_torch/ops/csrc/attention.cu",
             replaces="pointreggpt_tpu/ops/attention.py:64",
             **launches(2, "k2_launches"),
             work="one call at (8, 1024, 4, 32) bf16 on K2.check_inputs "
                  "(training_shape: (32, 1024, 4, 32)); ms and library_ms "
                  "(F.scaled_dot_product_attention) are device times "
                  "(CUDA graph of 20 calls), medians of 3 interleaved "
                  "repeats; event_ms times back-to-back launches; bf16 on "
                  "the tensor cores (flash_fwd_tc), fp32 (under fp32) in "
                  "three TF32 passes on the tensor cores "
                  "(flash_fwd_tf32x3), bound_ms at 494.7 / 3 TFLOP/s, "
                  "cuda_core_bound_ms at 67",
             fp32=k2_f32, **k2),
        dict(name="fused_linear_attention_bwd", route="cuda",
             source="pointreggpt_tpu_torch/ops/csrc/linear_attention_bwd.cu",
             headers=[BWD_TC_HEADER, BWD_TF32_HEADER, TC_HEADER, TF32_HEADER,
                      KV_HEADER],
             replaces="pointreggpt_tpu/ops/linear_attention.py:316",
             **launches(1, "k3_launches"), **routes("k3"), library_ms=None,
             work="the 8 calls of one dim-64 U-Net backward, bf16, "
                  "microbatch 32, 256^2 (times and bounds summed over the "
                  "8 shapes; ms by CUDA events, device_ms and by_launch "
                  "from one profiled call per shape); wide: (32, 1024, "
                  "2048), apart; max_abs_err is the largest absolute error "
                  "of the six outputs, max_rel_err the one the check "
                  "bounds; bf16 on the tensor cores "
                  "(linear_attention_bwd_tc.cuh), fp32 (under fp32, batch "
                  "8) on the tensor cores in three TF32 passes: the q "
                  "path, kv path and weight gradients of "
                  "linear_attention_bwd_tf32.cuh after K1's fp32 kernels "
                  "A and B (linear_attention_tf32.cuh), bound_ms at "
                  "494.7 / 3 TFLOP/s, cuda_core_bound_ms at 67",
             fp32=k3_f32, **k3),
        dict(name="linear_attention_core", route="cuda",
             source="pointreggpt_tpu_torch/ops/csrc/linear_attention_core.cu",
             headers=[KV_HEADER, TC_HEADER, TF32_HEADER],
             replaces="pointreggpt_tpu/ops/linear_attention.py:95",
             library_ms=None,
             work="linear_attention_core at (8, n, 384) bf16 for n = 65536, "
                  "16384, 4096, 1024, one call each (times and bounds "
                  "summed over the 4 shapes; ms is device time, a CUDA "
                  "graph of 20 calls, event_ms back-to-back launches, "
                  "by_launch one profiled call's device time); launches "
                  "counted over those calls; max_rel_err is the one the "
                  "check bounds; bf16 and fp32 (under fp32, three TF32 "
                  "passes, bound_ms at 494.7 / 3 TFLOP/s) on the tensor "
                  "cores, kernels A, B and C of linear_attention_core.cu",
             fp32={k: v for k, v in k4_f32.items() if k != "launches"},
             **k4),
        dict(name="conv3x3", route="cuda",
             source="pointreggpt_tpu_torch/ops/csrc/conv3x3.cu",
             headers=[CONV_HEADER, CONV_TF32_HEADER],
             replaces="tools/profile_conv.py:111",
             work="profile_conv.main: the 4 shapes (16,256,256,64->64), "
                  "(16,256,256,128->64), (8,256,256,64->64), "
                  "(16,128,128,128->128), bf16, one forward each (times "
                  "and bounds summed over the 4 shapes; library_ms is "
                  "F.conv2d, cuDNN, bf16 channels-last); launches counted "
                  "over one call of the tool's main (forwards, and the "
                  "backward's dx, of its timing and gradient loops); the "
                  "bf16 kernel is conv3_tc.cuh's implicit GEMM; fp32 "
                  "(under fp32, the same 4 shapes, library_ms F.conv2d "
                  "fp32 with TF32 off) conv3_tf32.cuh's implicit GEMM in "
                  "three TF32 passes on the tensor cores, bound_ms at "
                  "494.7 / 3 TFLOP/s, cuda_core_bound_ms at 67",
             **k5),
        dict(name="conv3_igemm", route="cuda",
             source="pointreggpt_tpu_torch/ops/csrc/conv3_igemm.cu",
             headers=[CONV_HEADER],
             replaces="tools/profile_conv_igemm.py:37",
             work="profile_conv_igemm.main: batches 8 and 16 at 256^2, "
                  "64->64, bf16, rows 8 (times and bounds summed over the "
                  "2 shapes; library_ms is F.conv2d, cuDNN); launches "
                  "counted over one call of the tool's main",
             **k6),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
