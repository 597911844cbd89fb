"""Kernel table of the PyTorch port (``pointreggpt_tpu_torch``) on the card.

    python3 chip_smoke.py

Needs one CUDA GPU (an H100 is the target), the CUDA toolkit's ``nvcc``
and this repository; exits 2 without a GPU and prints no result. It holds
each hand-written kernel against its plain version and times it beside
its bound and its library yardstick. The entry points are checked on the
card by the card tests (``python -m pytest tests/test_torch_port_cuda*.py
-q --noconftest``) and timed by ``portbench/``. Phases, each printing one
JSON line:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch, CUDA,
   nvcc;
2. ``build``: every source of ``pointreggpt_tpu_torch/ops/csrc`` (one
   nvcc per source, all at once);
3. ``k1_bf16``, ``k1_fp32``: K1 (fused LinearAttention) against its plain
   version at the eight (8, n, c) shapes of a dim-64 U-Net forward at
   256^2, and apart (``wide``) at (8, 1024, 2048), up_0 of a dim-256
   U-Net; bf16 on the tensor cores, fp32 in three TF32 passes;
4. ``k2_bf16``, ``k2_fp32``: K2 (bottleneck attention) on
   ``K2.check_inputs`` at (8, 1024, 4, 32) (generation) and (32, 1024, 4,
   32) (the training microbatch), beside ``F.scaled_dot_product_attention``
   in the same type, the library yardstick timed here only (3 interleaved
   repeats, medians); ``k2_adm_bf16``: K2 at d = 64 at ADM's three shapes,
   heads 3 d apart (``legacy=True``), against its plain version in fp32;
5. ``k3_bf16`` (microbatch 32), ``k3_fp32`` (batch 8): K3 (K1's backward)
   against the autograd of K1's plain version at the eight shapes and
   ``wide``, max |got - ref| / max |ref| per output;
6. ``k4_bf16``, ``k4_fp32``: K4 through ``linear_attention_core`` at (8,
   n, 384) for the U-Net's four n and at n = 1000; in fp32 also its
   backward;
7. ``conv_tools``: ``tools/profile_conv.main`` (K5 bf16 at the U-Net's
   four hot conv shapes against the shift9 and pair lowerings and cuDNN),
   ``profile_conv_igemm.main`` (K6), ``conv3x3``'s gradients, K5 fp32 at
   the four shapes beside cuDNN fp32 (TF32 off), and
   ``profile_conv.mask_main``: the fp32 conv route at the MaskUNet's
   fourteen 3x3 shapes (K5's forward and dx within 8 x 2^-21 of fp64,
   ``conv3_dw`` at most twice cuDNN's gap);
8. ``group_norm_dim64_bf16``, ``_dim64_fp32``, ``_adm_bf16``: the
   GroupNorm kernel at every GroupNorm shape of a batch-8 forward of the
   dim-64 DiffusionUNet, the MaskUNet and ADM against its plain version in
   fp32, beside its bytes bound, the chain the nets ran before it
   (``library_ms``) and one elementwise pass over the same bytes
   (``one_pass_ms``).

A check past its bound raises. ``ms`` is device time (calls captured in a
CUDA graph) where a row's ``work`` says so, else CUDA events over
back-to-back calls. Then a ``phase_seconds`` line (each phase's wall and
the total from the build on); ``steps``, the counters of one untimed step
of each main path (:func:`phase_steps`), raising where a call went to a
plain version; and the last three lines: the kernel table (one
JSON object; rows K1, K2, K2 d = 64, K3, K4, K5 with ``dw``, K6 and GN,
each row's ``launches`` and routes those of the ``steps`` by path, its
``checked_launches`` those of its phases' checked calls), the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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
WIDE = (1024, 2048)  # up_0 of a dim-256 U-Net at 256^2, reported apart


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def counted(op, fn):
    """``fn()``'s result, the launches of the kernel op ``op`` it made and
    the calls it routed to the plain version by shape (``plain_routes``,
    K1's and K3's; 0 for the others)."""
    launches, routes = op.launches, getattr(op, "plain_routes", 0)
    out = fn()
    return (out, op.launches - launches,
            getattr(op, "plain_routes", 0) - routes)


def check_launched(kernel: str, launches: int, routes: int,
                   calls: int) -> None:
    """Each checked call launched the kernel once and none was routed to
    the plain version."""
    if (launches, routes) != (calls, 0):
        raise AssertionError(f"{kernel}: {launches} launches and {routes} "
                             f"plain routes for {calls} checked calls")


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
    """K1 against its plain version at the eight shapes of one forward
    and at ``WIDE``, in ``dtype`` (bf16 for the DiffusionUNet, fp32 for
    the MaskUNet); each shape's device time by launch from one profiled
    call."""
    from pointreggpt_tpu_torch.tools.profile_k3 import by_kernel
    from torch.profiler import ProfilerActivity, profile

    name = str(dtype).split(".")[-1]
    atol, eps = K_ATOL[("k1", name)], (1e-3 if name == "bfloat16" else 1e-5)
    size, peak = torch.tensor([], dtype=dtype).element_size(), PEAK[name]
    rows, cache, launched, routed = [], {}, 0, 0
    for n, c in K1_SHAPES + [WIDE]:
        if (n, c) not in cache:
            # inputs on which C^, every kv split, q's per-head softmax and
            # the bias all move the output (see K1.check_inputs)
            args = K1.check_inputs(8, n, c, dtype, dev)
            out, launches, routes = counted(
                K1.fused_linear_attention,
                lambda: K1.fused_linear_attention(*args, eps=eps))
            launched, routed = launched + launches, routed + routes
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
            kernels = by_kernel(torch, prof)
            wk = K1.work(8, n, c, size)
            b_ms, b_by = bound(wk, peak)
            cache[(n, c)] = dict(n=n, c=c, max_abs_err=err, ms=ms,
                                 event_ms=event_ms, plain_ms=plain_ms,
                                 bound_ms=b_ms,
                                 bound_by=b_by, **cuda_core_bound(wk, name),
                                 tflops=wk["flops"] / ms / 1e9,
                                 share_of_bound=b_ms / ms,
                                 by_launch={k[:40]: v["ms"]
                                            for k, v in kernels.items()},
                                 **wk)
            del args, out, ref
            torch.cuda.empty_cache()
        rows.append(cache[(n, c)])
    check_launched(f"K1 {name}", launched, routed, len(cache))
    wide, rows = rows[-1], rows[:-1]
    emit(f"k1_{name}", shapes=rows, wide=wide, atol=atol,
         launches=launched)
    b_ms, b_by = summed_bound(rows, peak)
    ms = sum(r["ms"] for r in rows)
    by_launch = {}
    for r in rows:
        for k, v in r["by_launch"].items():
            by_launch[k] = by_launch.get(k, 0.0) + v
    return dict(checked_launches=launched,
                max_abs_err=max(r["max_abs_err"] for r in rows + [wide]),
                ms=ms, event_ms=sum(r["event_ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=b_ms, bound_by=b_by,
                **cuda_core_bound(summed(rows), name),
                tflops=sum(r["flops"] for r in rows) / ms / 1e9,
                share_of_bound=b_ms / ms, by_launch=by_launch,
                wide={k: wide[k] for k in ("n", "c", "max_abs_err", "ms",
                                           "plain_ms", "bound_ms",
                                           "bound_by")})


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


def phase_k3(torch, K1, dev, dtype, batch):
    """K3 against its plain version at the eight shapes of one forward and
    at ``WIDE``, in ``dtype`` at ``batch`` (bf16: the training
    microbatch of 32); each shape's device time by launch from one
    profiled call."""
    from pointreggpt_tpu_torch.tools.profile_k3 import by_kernel
    from torch.profiler import ProfilerActivity, profile

    name = str(dtype).split(".")[-1]
    atol, eps = K3_ATOL[name], (1e-3 if name == "bfloat16" else 1e-5)
    size, peak = torch.tensor([], dtype=dtype).element_size(), PEAK[name]
    rows, cache, launched, routed = [], {}, 0, 0
    for n, c in K1_SHAPES + [WIDE]:
        if (n, c) not in cache:
            args = K1.check_inputs_bwd(batch, n, c, dtype, dev)
            (errs, abs_errs), launches, routes = counted(
                K1.fused_linear_attention_bwd,
                lambda: k3_errors(torch, K1, args, eps))
            launched, routed = launched + launches, routed + routes
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
            kernels = by_kernel(torch, prof)
            wk = K1.work_bwd(batch, n, c, size)
            b_ms, b_by = bound(wk, peak)
            cache[(n, c)] = dict(n=n, c=c, rel_err=errs, abs_err=abs_errs,
                                 max_rel_err=max(errs.values()),
                                 max_abs_err=max(abs_errs.values()), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, **cuda_core_bound(wk, name),
                                 device_ms=sum(v["ms"]
                                               for v in kernels.values()),
                                 by_launch={k[:60]: v
                                            for k, v in kernels.items()},
                                 **wk)
            del args
            torch.cuda.empty_cache()
        rows.append(cache[(n, c)])
    check_launched(f"K3 {name}", launched, routed, len(cache))
    wide, rows = rows[-1], rows[:-1]
    emit(f"k3_{name}", batch=batch, shapes=rows, wide=wide, atol=atol,
         launches=launched)
    b_ms, b_by = summed_bound(rows, peak)
    by_launch = {}
    for r in rows:
        for k, v in r["by_launch"].items():
            t = by_launch.setdefault(k, {"ms": 0.0, "launches": 0})
            t["ms"] += v["ms"]
            t["launches"] += v["launches"]
    return dict(checked_launches=launched,
                max_abs_err=max(r["max_abs_err"] for r in rows + [wide]),
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
    rows, launched = [], 0
    for b in K2_BATCHES:
        # a peaked softmax, so every k tile and the rescale move the output
        q, k, v = K2.check_inputs(b, n, h, d, dtype, dev)
        out, launches, _ = counted(
            K2.multihead_attention,
            lambda: K2.multihead_attention(q, k, v, scale=scale))
        launched += launches
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
    check_launched(f"K2 {name}", launched, 0, len(K2_BATCHES))
    emit(f"k2_{name}", atol=atol, shapes=rows, launches=launched)
    keys = ("ms", "event_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_event_ms", "vs_library") + (
                ("cuda_core_bound_ms",) if name == "float32" else ())
    return dict(checked_launches=launched,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                **{k: rows[0][k] for k in keys},
                training_shape={k: rows[1][k] for k in ("shape",) + keys})


# ADM's attention blocks at batch 8, 256^2: 8 heads over 32^2 tokens, 16
# over 16^2 and over 8^2, heads 64 wide
K2_ADM_SHAPES = [(8, 1024, 8, 64), (8, 256, 16, 64), (8, 64, 16, 64)]


def phase_k2_adm(torch, K2, dev):
    """K2 at d = 64 in bf16 (``flash_fwd_tc<64>``) at ADM's three shapes
    on ``K2.check_inputs(..., legacy=True)``: q, k and v read in place from
    the legacy per-head [q | k | v] projection, heads 3 d apart, as
    ``models/adm.py``'s blocks pass them. Each against its plain version
    computed in fp32 from the same bf16 inputs (K2's bf16 gate), beside
    SDPA in bf16 on the same views; device times (:func:`graph_ms`, medians
    of 3 interleaved repeats), event times and the bound of ``K2.work``."""
    import torch.nn.functional as F

    atol = K_ATOL[("k2", "bfloat16")]
    rows, launched = [], 0
    for b, n, h, d in K2_ADM_SHAPES:
        scale = d**-0.5
        q, k, v = K2.check_inputs(b, n, h, d, torch.bfloat16, dev,
                                  legacy=True)
        if q.stride(2) != 3 * d:
            raise AssertionError(f"legacy inputs: head stride {q.stride()}")
        out, launches, _ = counted(
            K2.multihead_attention,
            lambda: K2.multihead_attention(q, k, v, scale=scale))
        launched += launches
        ref = K2.multihead_attention_plain(q.float(), k.float(), v.float(),
                                           scale=scale)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        if not np.isfinite(err) or err > atol:
            raise AssertionError(f"K2 bf16 at ({b}, {n}, {h}, {d}), heads "
                                 f"3 d apart: max abs err {err} > {atol}")
        qf, kf, vf = (t.transpose(1, 2) for t in (q, k, v))
        lib_err = (F.scaled_dot_product_attention(qf, kf, vf, scale=scale)
                   .transpose(1, 2).float() - ref).abs().max().item()

        def kern():
            return K2.multihead_attention(q, k, v, scale=scale)

        def library():
            return F.scaled_dot_product_attention(qf, kf, vf, scale=scale)

        kern_ms, lib_ms, kern_ev = [], [], []
        for _ in range(3):
            kern_ms.append(graph_ms(torch, kern, 20))
            lib_ms.append(graph_ms(torch, library, 20))
            kern_ev.append(time_ms(kern, 50))
        wk = K2.work(b, n, h, d, q.element_size())
        b_ms, b_by = bound(wk, PEAK["bfloat16"])
        ms, library_ms = float(np.median(kern_ms)), float(np.median(lib_ms))
        rows.append(dict(shape=[b, n, h, d], head_stride=q.stride(2),
                         max_abs_err=err, library_max_abs_err=lib_err,
                         ms=ms, ms_repeats=kern_ms,
                         event_ms=float(np.median(kern_ev)),
                         library_ms=library_ms, vs_library=ms / library_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         tflops=wk["flops"] / ms / 1e9,
                         share_of_bound=b_ms / ms))
        del q, k, v, out, ref
    check_launched("K2 d = 64", launched, 0, len(K2_ADM_SHAPES))
    emit("k2_adm_bf16", atol=atol, shapes=rows, launches=launched)
    return dict(checked_launches=launched,
                max_abs_err=max(r["max_abs_err"] for r in rows), atol=atol,
                shapes=rows)


# GroupNorm kernel against its plain version in fp32: (|got - ref| - rel
# |ref|) / max |ref|, rel half a bf16 step with room (the kernel rounds
# once to bf16) or an fp32 step's few (sum order)
GN_REL = {"bfloat16": 2.0**-8, "float32": 1e-6}
GN_ATOL = 1e-5


def phase_group_norm(torch, dev):
    """The GroupNorm kernel (``ops/group_norm.py``, ``csrc/group_norm.cu``)
    at every GroupNorm shape of three forwards at batch 8: the dim-64
    DiffusionUNet's (bf16 in and out, the Block's scale-shift and SiLU),
    the MaskUNet's (fp32, SiLU) and ADM's (bf16, scale-shift and SiLU).
    Each shape against the plain version in fp32 (``GN_ATOL``), its device
    time (:func:`graph_ms`, 10 calls, median of 3) beside its bound (x read
    once, y written once at 3.35 TB/s) and ``library_ms``, the chain the
    nets ran before the kernel (the plain version on the channels-last
    input, whose ``F.group_norm`` works in NCHW, and the copy back to
    channels-last that the next conv made), timed here only; and
    ``one_pass_ms``, one PyTorch elementwise launch that reads x once and
    writes y once (``torch.neg`` into y), the floor of any design in one
    launch. Sums over a forward weight each shape by its calls; the
    launches a call are the kernel's counter over the check's call."""
    from pointreggpt_tpu_torch.ops import group_norm as GN

    sets = [("dim64_bf16", GN.DIM64_SHAPES, torch.bfloat16, True),
            ("dim64_fp32", GN.DIM64_SHAPES, torch.float32, False),
            ("adm_bf16", GN.ADM_SHAPES, torch.bfloat16, True)]
    out = {}
    for name, shapes, dtype, ss in sets:
        rows = []
        for c, size, groups, calls in shapes:
            x, gamma, beta, scale, shift = GN.check_inputs(
                8, c, size, size, groups, dtype, dev, seed=c + size)
            sc = (scale, shift) if ss else (None, None)

            def kern():
                return GN.group_norm_act(x, groups, gamma, beta, 1e-5, *sc,
                                         out_dtype=dtype)

            def library():
                return GN.group_norm_act_plain(
                    x, groups, gamma, beta, 1e-5, *sc,
                    out_dtype=dtype).contiguous(
                        memory_format=torch.channels_last)

            y = torch.empty_like(x)

            def one_pass():
                return torch.neg(x, out=y)

            with torch.no_grad():
                launches = GN.group_norm_act.launches
                got = kern()
                launches = GN.group_norm_act.launches - launches
                ref = GN.group_norm_act_plain(x, groups, gamma, beta, 1e-5,
                                              *sc)
                torch.cuda.synchronize()
                d = (got.float() - ref).abs() - GN_REL[str(dtype).split(
                    ".")[-1]] * ref.abs()
                err = (d.max() / ref.abs().max()).item()
                if not np.isfinite(err) or err > GN_ATOL:
                    raise AssertionError(f"group_norm {name} at (8, {c}, "
                                         f"{size}, {size}) / {groups}: "
                                         f"{err} > {GN_ATOL}")
                del got, ref, d
                ms, lib_ms, one_ms = [], [], []
                for _ in range(3):
                    ms.append(graph_ms(torch, kern, 10))
                    lib_ms.append(graph_ms(torch, library, 10))
                    one_ms.append(graph_ms(torch, one_pass, 10))
            wk = GN.work_group_norm(8, size * size, c, x.element_size(),
                                    x.element_size())
            b_ms = bound(wk, PEAK["bfloat16"])[0]
            rows.append(dict(shape=[8, c, size, size], groups=groups,
                             calls=calls, launches=launches, err=err,
                             ms=float(np.median(ms)),
                             library_ms=float(np.median(lib_ms)),
                             one_pass_ms=float(np.median(one_ms)),
                             bound_ms=b_ms,
                             share_of_bound=b_ms / float(np.median(ms))))
            del x, y, gamma, beta, scale, shift
        tot = {k: sum(r[k] * r["calls"] for r in rows)
               for k in ("launches", "ms", "library_ms", "one_pass_ms",
                         "bound_ms")}
        res = dict(launches_per_forward=tot["launches"],
                   ms=tot["ms"], library_ms=tot["library_ms"],
                   one_pass_ms=tot["one_pass_ms"], bound_ms=tot["bound_ms"],
                   share_of_bound=tot["bound_ms"] / tot["ms"],
                   vs_library=tot["ms"] / tot["library_ms"], shapes=rows)
        emit(f"group_norm_{name}", atol=GN_ATOL, **res)
        out[name] = res
    return out


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
    return dict(checked_launches=launches,
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
    return dict(checked_launches=launches,
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
    dw = conv_dw(KC, profile_conv)
    emit("conv_tools", card=card_line(), rtol=CONV_RTOL,
         grad_rel_err=grad_errs, grad_rtol=CONV_GRAD_RTOL,
         k5_launches=k5_launches, k6_launches=k6_launches, k5=k5_rows,
         k6_small=ig["correctness"], k6=k6_rows, k5_fp32=fp32,
         mask_route=dw)
    torch.cuda.empty_cache()
    return (dict(conv_summary(k5_rows, KC, k5_launches), fp32=fp32,
                 dw=dw), conv_summary(k6_rows, KC, k6_launches))


# K5's fp32 forward and dx against fp64 on the route: three TF32 passes
# keep about 21 bits a product, so a few 2^-21 (one TF32 pass: ~2^-11)
ROUTE_FP32_GAP = 8 * 2.0**-21


def conv_dw(KC, profile_conv) -> dict:
    """``profile_conv.mask_main``: the route's kernels at the fp32
    MaskUNet's 3x3 shapes at batch 4; ``conv3_dw``'s gaps to fp64 at most
    twice cuDNN's fp32 weight gradient's, and K5's forward (with the bias)
    and dx within ``ROUTE_FP32_GAP`` of fp64, at every shape. Returns the
    rows and the sums over the shapes."""
    KC.conv3_dw.launches = 0
    res = profile_conv.mask_main()
    rows = res["shapes"]
    bad = [(r["shape"], r["dw_gap"], r["library_dw_gap"]) for r in rows
           if not r["dw_gap"] <= 2 * r["library_dw_gap"]]
    if bad:
        raise AssertionError(f"conv3_dw against fp64: {bad} above twice "
                             f"cuDNN's gap")
    bad = [(r["shape"], k, r[k]) for r in rows for k in ("fwd_gap", "dx_gap")
           if not r[k] <= ROUTE_FP32_GAP]
    if bad:
        raise AssertionError(f"K5 fp32 on the route against fp64: {bad} > "
                             f"{ROUTE_FP32_GAP}")
    total = {k: sum(r[k] for r in rows) for k in (
        "dw_ms", "bound_ms", "wgrad_plain_ms", "library_dw_ms", "fwd_ms",
        "dx_ms", "library_fwd_ms", "library_dx_ms")}
    return dict(shapes=rows, checked_launches=res["launches"], **total,
                share_of_bound=total["bound_ms"] / total["dw_ms"],
                **{f"max_{k}": max(r[k] for r in rows) for k in (
                    "dw_gap", "library_dw_gap", "fwd_gap", "library_fwd_gap",
                    "dx_gap", "library_dx_gap")}, gap_rtol=ROUTE_FP32_GAP)


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


# no step of a main path routes a call to a plain version or copies an
# attention's or a GroupNorm's input (the MaskTrainer's step copies 79
# incoming tensors to NHWC for its convs, counted in ``conv_copies``)
NOT_ON_A_KERNEL = ("k1_plain", "k3_plain", "attn_copies", "norm_copies")


def phase_steps(torch, dev) -> dict:
    """One untimed step of each main path, its counters read just before
    and just after it: ``sample_step`` and ``adm_sample_step``, one
    ``Generator.step`` of ``generate_dataset``'s Generator with the dim-64
    DiffusionUNet or ADM, the fp32 MaskUNet and 250 DDIM steps, at batch 2
    and 64^2 (a step's counts are those of every size); ``train_step``, one
    optimizer step of the Trainer at ``ModelConfig()`` width (two
    microbatches of 2 at 256^2, bf16); ``mask_train_step``, one MaskTrainer
    step of the full-width MaskUNet at batch 2 and 64^2. Raises where a
    step ran a call ``NOT_ON_A_KERNEL``."""
    import contextlib
    import tempfile

    from portbench.lib.traffic import mask_pairs
    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.cli import generate_dataset
    from pointreggpt_tpu_torch.core import geometry as G
    from pointreggpt_tpu_torch.data.datasets import collate
    from pointreggpt_tpu_torch.tools import counters
    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR
    from pointreggpt_tpu_torch.train.mask_trainer import (MaskTrainer,
                                                          _to_device)

    steps = {}

    def count(name, step):
        before = counters()
        step()
        torch.cuda.synchronize()
        now = counters()
        steps[name] = {k: now[k] - before[k] for k in now}
        wrong = {k: steps[name][k] for k in NOT_ON_A_KERNEL if steps[name][k]}
        if wrong:
            raise AssertionError(f"{name}: {wrong}")

    def seeded():
        return torch.Generator(device=dev).manual_seed(0)

    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        rng = np.random.default_rng(0)
        intr = np.array([[72.0, 0, 32.0], [0, 72.0, 32.0], [0, 0, 1]],
                        np.float32)
        pts = torch.from_numpy(G.point_cloud_np(
            2.0 + 0.8 * rng.uniform(size=(64, 64)), intr,
            clip=(0.5, 10.0)).astype(np.float32))
        mem = torch.zeros(2, 4096, 3)
        mem[:, :len(pts)] = pts
        valid = torch.zeros(2, 4096, dtype=torch.bool)
        valid[:, :len(pts)] = True
        mem, valid = mem.to(dev), valid.to(dev)
        intr = torch.from_numpy(intr).expand(2, 3, 3).to(dev)
        for name, denoiser in (("sample_step", "unet"),
                               ("adm_sample_step", "adm")):
            torch.manual_seed(0)
            gen, _ = generate_dataset.build_generator(
                generate_dataset.parse_args([
                    "--resume", "1", "--denoiser", denoiser, "--data", tmp,
                    "--image_size", "64", "--batch_size", "2",
                    "--memory_capacity", "4096"]))
            gen.device_models()
            count(name, lambda: gen.step(mem, valid, intr,
                                         G.param_vector(intr), seeded()))
            del gen
        folder, gt_log = DR.write_depth_tree(Path(tmp), n_frames=8)
        tr = DR.build_trainer(folder, gt_log, tmp + "/results",
                              full_width=True, global_batch=2,
                              gradient_accumulate_every=2)
        img, img_intr = tr._upload(next(tr.dl))
        count("train_step", lambda: tr.train_step(img, img_intr, seeded()))
        del tr
        mt = MaskTrainer(C.build_mask_unet(C.MaskModelConfig()),
                         mask_pairs(Path(tmp) / "dc", 2, 1, 2, 64, 0),
                         image_size=64, train_batch_size=2, num_workers=1,
                         device=dev, results_folder=tmp + "/mask",
                         samples_folder=tmp + "/mask_samples")
        batch = _to_device(collate([mt.train_ds[i] for i in range(2)]),
                           ("input_img", "mask"), dev)
        count("mask_train_step", lambda: mt.train_step(*batch))
    emit("steps", **steps)
    return steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)

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

    t_start = t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[_build.library_path(n).name for n in _build.SOURCES])

    seconds = {}  # wall seconds of each phase

    def timed(name, phase, *a):
        t0 = time.perf_counter()
        out = phase(*a)
        seconds[name] = time.perf_counter() - t0
        return out

    k1 = timed("k1_bf16", phase_k1, torch, K1, dev, torch.bfloat16)
    k1_f32 = timed("k1_fp32", phase_k1, torch, K1, dev, torch.float32)
    k2 = timed("k2_bf16", phase_k2, torch, K2, dev, torch.bfloat16)
    k2_f32 = timed("k2_fp32", phase_k2, torch, K2, dev, torch.float32)
    k2_adm = timed("k2_adm", phase_k2_adm, torch, K2, dev)
    k3 = timed("k3_bf16", phase_k3, torch, K1, dev, torch.bfloat16, 32)
    k3_f32 = timed("k3_fp32", phase_k3, torch, K1, dev, torch.float32, 8)
    k4 = timed("k4_bf16", phase_k4, torch, K1, dev, torch.bfloat16)
    k4_f32 = timed("k4_fp32", phase_k4, torch, K1, dev, torch.float32)
    k5, k6 = timed("conv_tools", phase_conv_tools, torch, dev)
    gn = timed("group_norm", phase_group_norm, torch, dev)
    emit("phase_seconds", total=time.perf_counter() - t_start, **seconds)
    steps = phase_steps(torch, dev)

    def per_step(key):
        return {path: counts[key] for path, counts in steps.items()}

    csrc = "pointreggpt_tpu_torch/ops/csrc/"
    KV_HEADER, TC_HEADER, BWD_TC_HEADER, CONV_HEADER, TF32_HEADER = (
        csrc + "linear_attention_kv.cuh", csrc + "linear_attention_tc.cuh",
        csrc + "linear_attention_bwd_tc.cuh", csrc + "conv3_tc.cuh",
        csrc + "linear_attention_tf32.cuh")
    BWD_TF32_HEADER, CONV_TF32_HEADER = (
        csrc + "linear_attention_bwd_tf32.cuh", csrc + "conv3_tf32.cuh")
    kernels = [
        dict(row="K1", name="fused_linear_attention", route="cuda",
             source=csrc + "linear_attention.cu",
             headers=[TC_HEADER, TF32_HEADER, KV_HEADER],
             replaces="pointreggpt_tpu/ops/linear_attention.py:202",
             library_ms=None,
             work="the 8 calls of one dim-64 U-Net forward, bf16, batch 8, "
                  "256^2 (times and bounds summed over the 8 shapes; ms is "
                  "device time, a CUDA graph of 10 calls, event_ms "
                  "back-to-back launches); wide: (8, 1024, 2048), apart; "
                  "bf16 on the tensor cores (linear_attention_tc.cuh), fp32 "
                  "(under fp32) kernels A and C in three TF32 passes on "
                  "the tensor cores (linear_attention_tf32.cuh), bound_ms "
                  "at 494.7 / 3 TFLOP/s, cuda_core_bound_ms at 67; "
                  "checked_launches over the checked calls",
             launches=per_step("k1"), plain_routes=per_step("k1_plain"),
             fp32=k1_f32, **k1),
        dict(row="K2", name="multihead_attention", route="cuda",
             source=csrc + "attention.cu",
             replaces="pointreggpt_tpu/ops/attention.py:64",
             work="one call at (8, 1024, 4, 32) bf16 on K2.check_inputs "
                  "(training_shape: (32, 1024, 4, 32)); ms and library_ms "
                  "(F.scaled_dot_product_attention) are device times "
                  "(CUDA graph of 20 calls), medians of 3 interleaved "
                  "repeats; event_ms times back-to-back launches; bf16 on "
                  "the tensor cores (flash_fwd_tc), fp32 (under fp32) in "
                  "three TF32 passes on the tensor cores "
                  "(flash_fwd_tf32x3), bound_ms at 494.7 / 3 TFLOP/s, "
                  "cuda_core_bound_ms at 67; checked_launches over the "
                  "checked calls",
             launches=per_step("k2"), attn_k2_d32=per_step("attn_k2_d32"),
             attn_copies=per_step("attn_copies"), fp32=k2_f32, **k2),
        dict(row="K2 d = 64", name="multihead_attention", route="cuda",
             source=csrc + "attention.cu",
             replaces="none: ADM's attention, which has no TPU kernel",
             work="flash_fwd_tc<64> at ADM's three batch-8 shapes, bf16, "
                  "heads 3 d apart (K2.check_inputs legacy), each against "
                  "the plain version in fp32; ms and library_ms (SDPA) "
                  "device times, medians of 3 interleaved repeats",
             launches=per_step("attn_k2_d64"), **k2_adm),
        dict(row="K3", name="fused_linear_attention_bwd", route="cuda",
             source=csrc + "linear_attention_bwd.cu",
             headers=[BWD_TC_HEADER, BWD_TF32_HEADER, TC_HEADER, TF32_HEADER,
                      KV_HEADER],
             replaces="pointreggpt_tpu/ops/linear_attention.py:316",
             library_ms=None,
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
             launches=per_step("k3"), plain_routes=per_step("k3_plain"),
             fp32=k3_f32, **k3),
        dict(row="K4", name="linear_attention_core", route="cuda",
             source=csrc + "linear_attention_core.cu",
             headers=[KV_HEADER, TC_HEADER, TF32_HEADER],
             replaces="pointreggpt_tpu/ops/linear_attention.py:95",
             library_ms=None,
             work="linear_attention_core at (8, n, 384) bf16 for n = 65536, "
                  "16384, 4096, 1024, one call each (times and bounds "
                  "summed over the 4 shapes; ms is device time, a CUDA "
                  "graph of 20 calls, event_ms back-to-back launches, "
                  "by_launch one profiled call's device time); "
                  "checked_launches over those calls; max_rel_err is the one the "
                  "check bounds; bf16 and fp32 (under fp32, three TF32 "
                  "passes, bound_ms at 494.7 / 3 TFLOP/s) on the tensor "
                  "cores, kernels A, B and C of linear_attention_core.cu",
             launches=per_step("k4"), fp32=k4_f32, **k4),
        dict(row="K5", name="conv3x3", route="cuda",
             source=csrc + "conv3x3.cu",
             headers=[CONV_HEADER, CONV_TF32_HEADER],
             replaces="tools/profile_conv.py:111",
             work="profile_conv.main: the 4 shapes (16,256,256,64->64), "
                  "(16,256,256,128->64), (8,256,256,64->64), "
                  "(16,128,128,128->128), bf16, one forward each (times "
                  "and bounds summed over the 4 shapes; library_ms is "
                  "F.conv2d, cuDNN, bf16 channels-last); checked_launches "
                  "over one call of the tool's main (forwards, and the "
                  "backward's dx, of its timing and gradient loops); the "
                  "bf16 kernel is conv3_tc.cuh's implicit GEMM; fp32 "
                  "(under fp32, the same 4 shapes, library_ms F.conv2d "
                  "fp32 with TF32 off) conv3_tf32.cuh's implicit GEMM in "
                  "three TF32 passes on the tensor cores, bound_ms at "
                  "494.7 / 3 TFLOP/s, cuda_core_bound_ms at 67; dw: "
                  "profile_conv.mask_main, the fp32 MaskUNet's 14 3x3 "
                  "shapes at batch 4 (the route of ops/conv.py::conv2d, "
                  "on the MaskUNet path): conv3_dw.cu's weight and bias "
                  "gradient (dw_ms) beside its bound, _wgrad and cuDNN's "
                  "fp32 weight gradient, and K5's fp32 forward and dx "
                  "beside cuDNN's, summed over the shapes",
             launches=per_step("k5"), dw_launches=per_step("dw"),
             conv_k5=per_step("conv_k5"), conv_library=per_step("conv_library"),
             conv_copies=per_step("conv_copies"), **k5),
        dict(row="K6", name="conv3_igemm", route="cuda",
             source=csrc + "conv3_igemm.cu",
             headers=[CONV_HEADER],
             replaces="tools/profile_conv_igemm.py:37",
             work="profile_conv_igemm.main: batches 8 and 16 at 256^2, "
                  "64->64, bf16, rows 8 (times and bounds summed over the "
                  "2 shapes; library_ms is F.conv2d, cuDNN); "
                  "checked_launches over one call of the tool's main",
             launches=per_step("k6"), **k6),
        dict(row="GN", name="group_norm_act", route="cuda",
             source=csrc + "group_norm.cu",
             replaces="none: PyTorch's NCHW GroupNorm and the cast, copy, "
                      "scale-shift, SiLU and cast passes around it",
             launches=per_step("gn"), norm_fused=per_step("norm_fused"),
             norm_plain=per_step("norm_plain"),
             norm_copies=per_step("norm_copies"),
             checked_launches=sum(r["launches"] for g in gn.values()
                                  for r in g["shapes"]),
             work="every GroupNorm shape of one batch-8 forward, summed by "
                  "calls: dim64_bf16 the DiffusionUNet's (scale-shift, "
                  "SiLU), dim64_fp32 the MaskUNet's (SiLU), adm_bf16 "
                  "ADM's (scale-shift, SiLU); ms is device time (a CUDA "
                  "graph of 10 calls, median of 3), bound_ms x read once "
                  "and y written once at 3.35 TB/s, library_ms the plain "
                  "chain the nets ran before and the copy back to "
                  "channels-last (F.group_norm, elementwise ops), timed "
                  "here only, one_pass_ms one elementwise launch over "
                  "the same bytes (the floor of a one-launch design); "
                  "checked_launches counted by the kernel's counter over "
                  "the checked calls, two a call",
             **gn),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
