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
   ``k2_adm_bf16``: K2 at d = 64 (bf16) at ADM's shapes (8, 1024, 8, 64),
   (8, 256, 16, 64) and (8, 64, 16, 64) on ``K2.check_inputs(...,
   legacy=True)`` (heads 3 d apart, read in place) against its plain
   version in fp32, within the same 1e-2, with times, SDPA's and bounds;
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
   (1e-5 relative) and fp32 cuDNN (TF32 off); then ``profile_conv.mask_main``
   at the fp32 MaskUNet's fourteen 3x3 shapes at batch 4: ``conv3_dw``'s
   time, bound and gap to fp64 (at most twice cuDNN's fp32 weight
   gradient's), ``_wgrad``'s and cuDNN's times, K5's forward and dx beside
   cuDNN's;
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
   16 K3 and 2 K2 per optimizer step; the milestone's grid counted apart);
14. ``mask_train_path``: K1, K3 and K2 in fp32 against their plain
   versions at the MaskTrainer's batch of 4, then the depth-correction
   entry points at ``MaskModelConfig`` / ``MaskTrainConfig`` widths:
   ``make_depth_correction_data`` on 48 synthetic pairs whose frames
   differ by a camera motion, ``train_depth_correction`` for 2 epochs and
   a resumed third, ``test_depth_correction`` on 4 items; checks 8 K1,
   8 K3 and 1 K2 per optimizer step, the staircase learning rate, both
   checkpoints, the Generator's reading of ``model-best.pt`` and 8 GIFs,
   and reports each step's time by CUDA events beside ``mask_fwd_bwd``'s.

15. ``jax_parity``: the port's full-width outputs on the card against
   the JAX package's, computed once on the CPU and committed as
   ``tests/data/torch_port_jax_reference.npz`` (weights and inputs
   remade from a seed, ``pointreggpt_tpu_torch/utils/jax_parity.py``): a
   baked bf16 DiffusionUNet forward at batch 2, an fp32 MaskUNet forward
   at batch 4 and one ``Generator.step`` (10 DDIM steps, eta 0, DDNM,
   mask net, memory 2^18); each gap within twice the port's CPU gap plus
   the kernels' gap to their plain versions on the card, and a planted
   fault (a shuffled head) at least 5 times the forward gate;
16. ``gt_path``: ``pointreggpt_tpu_torch.cli.generate_gt.main`` on the
   dataset ``main_path`` wrote (the ``gt.log`` contract, seconds per
   pair), then ``generate_gt`` on 4 synthetic pairs of known overlap, card
   against the CPU;
17. ``tester_path``: ``pointreggpt_tpu_torch.cli.
   test_successive_ddnm_diffusion.main`` at ``ModelConfig()`` width with
   its defaults (4 scenes x 4 samples, 32 DDIM steps, eta 1) on seeded
   weights: the JAX Tester's file contract and 1,024 K1 and 128 K2
   launches; ``Tester.generate`` (4 scenes x 3 samples, memory 2^18); the
   ancestral chain through the CLI (1,000 steps, 8,000 K1, 1,000 K2);
18. ``fid_path``: the training CLI with ``--calculate_fid`` to one
   milestone (2 production steps, the 25-image EMA grid) on seeded
   Inception weights written as a ``.pth`` and reached through
   ``$PRGPT_INCEPTION_WEIGHTS``: a finite ``fid_score`` line; then
   ``InceptionFeatures`` at 299^2 on 32 seeded images against the port on
   the CPU and the JAX features committed in
   ``tests/data/torch_port_fid_import_reference.npz`` (gated as
   ``jax_parity``), ``fid_pools`` flipped as a planted fault (at least 10x
   the gate), the FID of two seeded sets card vs CPU (1e-2 relative),
   features a second and the milestone's FID seconds;
19. ``import_path``: the importer CLI on full-width reference-layout
   ``.pt`` files of seeded weights, then one ``Generator.step`` from its
   output equal bit for bit to the step from the un-imported nets; on the
   committed small-width JAX ``.ckpt`` pair, the imported nets' forwards
   against the JAX forwards; ``train_depth_correction --resume`` from the
   imported ``.ckpt``: one step, its Adam count the JAX count + 1;
20. ``mixture_path``: every item of both registration loaders
   (``MixtureDataset``, max_points 30000; ``MixturePairDataset`` with its
   correspondences) over ``main_path``'s generated tree (the gt.log
   ``gt_path`` wrote) and ``gt_path``'s synthetic pairs, card vs CPU: the
   fields bit for bit, the correspondences but for pairs within 1e-5 of
   the radius (counted); items a second.
21. ``dist_path``: data parallelism through the port's entry points on the
   one card. (a) The Trainer at ``ModelConfig()`` width (microbatch 8, 2
   steps) in a process group of one over NCCL, launched as torchrun
   launches it, bit for bit against the same run with no group (cuDNN's
   deterministic algorithms in both), and the all-reduce's time a step.
   (b) Two processes sharing ``cuda:0`` over gloo (NCCL takes one process
   per card; the backend is named in the output):
   ``tools/dryrun_multiprocess`` at full width, then in both processes
   the Trainer (global microbatch 8, 4 a process, 2 steps: replicas
   bit-identical after each step, the averaged gradient within 1e-2
   relative of one process's on the same global batch, the division by
   the process count skipped at least 10 times the gate, rank 1 on rank
   0's rows past it), the MaskTrainer (fp32, 2 a process against one
   process at 4: gradient within 1e-4, validation metrics within 1e-6,
   rank 0's checkpoints alone), ``generate_dataset -start 0 -stop 4
   --num_samples 2`` (250 steps: scenes by stride, rank 0's files bit for
   bit those of one process given [0, 2], rank 1's own poses) and the
   Tester's entry point in fp32 (4 scenes x 2 samples, 32 steps, 2 a
   process against one process at 4: each image's mean difference within
   1e-2, stated from the batch-composition gap measured in one process,
   a slice swap 10 times past it, one overview); K1, K3 and K2 launched
   on every process
   with no plain route. Two processes on one card check correctness, not
   scaling: their times are a record only. NCCL across cards is not
   exercised on a one-card machine;
22. ``profile_path``: ``PRGPT_PROFILE`` on the card: the Trainer (6 steps)
   and ``Generator.generate`` (3 sample steps of a 25-step chain, the
   production widths) print the JAX stage names
   and write Chrome traces holding device kernels; one MaskTrainer step
   under ``profiling.trace``, its device time by kernel category beside
   ``mask_fwd_bwd``'s;
23. ``surface_path``: the rest of the JAX surface at full width: (a)
   ``GaussianDiffusion.denoise`` (250 DDIM steps, eta 1, DDNM on, batch
   2, the bf16 DiffusionUNet of seeded weights) on ``image_condition`` of
   a synthetic depth under two ``random_sample_pose`` motions, every
   masked pixel equal to the condition, 2,000 K1 and 250 K2; (b)
   ``interpolate`` of its outputs from t = 999 (7,992 K1, 999 K2); (c)
   the four cases of ``tests/data/torch_port_jax_surface.npz`` (a 10-step
   denoise, a 10-step fp32 interpolation on the JAX draws, an fp32
   Fourier / learned-variance forward, ``image_condition``) gated as
   ``jax_parity``, the interpolation's weights swapped as a planted fault
   at least 5 times its gate; (d) ``Generator.load`` on a folder of the
   committed JAX ``.ckpt`` files, its step bit for bit the step from the
   importer's ``.pt``; (e) ``mixture.load_point_cloud`` on ascii,
   extra-property and face-trailing PLYs; (f) the native host library
   (g++, zlib found or not): ``load_depth_model_space`` native against
   PIL bit for bit on 640x480 and 480x640 PNGs, flip on and off, and
   frames a second of both routes; (g) the gradients of a dim-64 fp32
   Fourier / learned-variance net (learned and frozen frequencies, 8 K1,
   8 K3, 1 K2 each) card vs CPU within 2e-3; each chain's seconds;
24. ``main_path_adm``: ``generate_dataset.main --denoiser adm`` (guided-
   diffusion's 553 M ADM at its published flags, seeded weights, the
   production chain and MaskUNet, batch 8, one sample step) on a synthetic
   tree, the output contract of ``main_path``; launch and route counts
   reset just before: 4,002 K2 launches (4,000 at d = 64, 16 a forward,
   and the MaskUNet's 2 at d = 32), no layout copy for K2
   (``attn_copies`` 0), 16 K1 and no K3 a sample step;
25. ``group_norm_*``: the GroupNorm kernel (``ops/group_norm.py``,
   ``csrc/group_norm.cu``: statistics, affine, scale-shift, SiLU and the
   cast, channels-last) at every GroupNorm shape of a batch-8 forward of
   the dim-64 DiffusionUNet (bf16), the MaskUNet (fp32) and ADM (bf16),
   against its plain version in fp32, its device time summed over a
   forward beside its bound (x read once, y written once), the chain the
   nets ran before it as ``library_ms`` and one elementwise pass over the
   same bytes as ``one_pass_ms``. ``main_path`` and ``main_path_adm``
   also check that every GroupNorm of a sample step ran on it
   (``norm_fused`` 9,576 and 25,326, no plain route, no copy) and that its
   launch counter read two a call, and ``train_step`` that training's 76
   ran on the plain version.

A ``phase_seconds`` line gives each phase's wall seconds and the total
from the build on. The last three lines are the kernel table (one JSON
object: K1-K3's launch counts from the main paths, K4's from its op's
drive, K5's and K6's from their tools' entry points; K1's and K3's
``plain_routes``, the calls routed to the plain version by shape, must be
0 on each path; K2's ``d64`` holds ``k2_adm_bf16`` and ``main_path_adm``'s
counts, which its ``launches`` leave out), the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
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
    rows = []
    for b, n, h, d in K2_ADM_SHAPES:
        scale = d**-0.5
        q, k, v = K2.check_inputs(b, n, h, d, torch.bfloat16, dev,
                                  legacy=True)
        if q.stride(2) != 3 * d:
            raise AssertionError(f"legacy inputs: head stride {q.stride()}")
        out = K2.multihead_attention(q, k, v, scale=scale)
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
    emit("k2_adm_bf16", atol=atol, shapes=rows)
    return dict(atol=atol, shapes=rows)


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
    return dict(shapes=rows, launches=res["launches"], **total,
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


def phase_mask_fwd_bwd(torch, K1, K2, dev):
    """One fp32 MaskUNet (``MaskModelConfig``: dim 64, (1, 2, 4, 8), 8
    groups) forward and backward of the MaskTrainer's loss at its
    microbatch, 4 x 256^2: K1, K2 and K3 launch in fp32 (counted; none
    routed to a plain version), and its 3x3 convs on K5 and ``conv3_dw``
    (``mask_conv_want``, counted); the step's time by CUDA events once it has
    settled, and the device time by kernel category (summed and busy) of
    one more step, timed alike; the loss gradients card against CPU
    (fp32, ``GRAD_RTOL``) at ``MASK_PARITY_BATCH`` images, with each
    LinearAttention's core carrying its output."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.models.blocks import LinearAttention
    from pointreggpt_tpu_torch.train.mask_trainer import bce_loss

    def inputs(batch, seed):
        rng = np.random.default_rng(seed)
        depth = rng.uniform(0.2, 1.0, (batch, 1, 256, 256))
        depth[rng.uniform(size=depth.shape) < 0.05] = 0.0  # invalid pixels
        target = (rng.uniform(size=depth.shape) < 0.7).astype(np.float64)
        return (torch.tensor(depth, dtype=torch.float32),
                torch.tensor(target, dtype=torch.float32))

    def step(net, depth, target):
        bce_loss(net(depth), target).backward()

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
    conv_n = conv_counts()
    want = (MASK_STEPS * n_attn, MASK_STEPS * n_attn, MASK_STEPS)
    if (k1_n, k3_n, k2_n) != want:
        raise AssertionError(f"mask_fwd_bwd launches K1, K3, K2 = "
                             f"{(k1_n, k3_n, k2_n)} over {MASK_STEPS} "
                             f"steps, want {want}")
    if conv_n != mask_conv_want(MASK_STEPS):
        raise AssertionError(f"mask_fwd_bwd convs routed to K5, left to "
                             f"F.conv2d, K5 and conv3_dw launches = "
                             f"{conv_n} over {MASK_STEPS} steps, want "
                             f"{mask_conv_want(MASK_STEPS)}")
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
    fwd_bwd = device_time(torch, prof)
    emit("mask_fwd_bwd", card=card_line(), batch=MASK_BATCH, image=256,
         warmup_ms=warm, step_ms=float(np.median(times)),
         step_ms_min=min(times), step_ms_max=max(times), step_ms_all=times,
         profiled_step_ms=profiled_ms,
         k1_per_step=k1_n / MASK_STEPS, k3_per_step=k3_n / MASK_STEPS,
         k2_per_step=k2_n / MASK_STEPS, plain_routes=routes,
         conv_per_step=dict(zip(("k5", "library", "k5_launches",
                                 "dw_launches"),
                                (n / MASK_STEPS for n in conv_n))),
         grad_parity_batch=MASK_PARITY_BATCH, grad_max_rel_err=worst,
         grad_worst=worst_name, grad_rtol=GRAD_RTOL, fwd_bwd=fwd_bwd)
    del gpu_net, depth, target, prof
    torch.cuda.empty_cache()
    return {"step_ms": float(np.median(times)), "step_ms_all": times,
            "fwd_bwd": fwd_bwd}


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


def write_checkpoints(torch, root: Path, seed: int, denoiser: str = "unet"):
    """Checkpoints of seeded weights (``utils/seeded_weights.py``: the
    MaskUNet's keep probability far above 0.99, so the generated frames
    keep their pixels and ``gt_path`` scores real clouds) in the reference
    layout: the diffusion state dict holds the U-Net under ``model.``, the
    EMA wraps it again. ``denoiser`` ``adm``: guided-diffusion's ADM at
    its published flags (``config.ADMConfig()``), its EMA alone (2.2 GB
    in fp32)."""
    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.utils.seeded_weights import fill_seeded

    if denoiser == "adm":
        unet = fill_seeded(C.build_adm_unet(C.ADMConfig()), seed)
    else:
        unet = fill_seeded(C.build_diffusion_unet(C.ModelConfig()), seed)
    sd = {f"model.{k}": v for k, v in unet.state_dict().items()}
    ema = {f"ema_model.{k}": v for k, v in sd.items()}
    if denoiser != "adm":
        ema.update({f"online_model.{k}": v for k, v in sd.items()})
    ema["initted"] = torch.tensor(True)
    ema["step"] = torch.tensor(0)
    (root / "results").mkdir()
    torch.save({"step": 0, "ema": ema} if denoiser == "adm" else
               {"step": 0, "model": sd, "ema": ema},
               root / "results" / "model-1.pt")
    del unet, sd, ema
    mask = fill_seeded(C.build_mask_unet(C.MaskModelConfig()), seed + 1)
    (root / "depth_correction_results").mkdir()
    torch.save({"epoch": 0, "model": mask.state_dict()},
               root / "depth_correction_results" / "model-best.pt")


def reset_counts(K1, K2) -> None:
    """Launch counters of K1, K3, K2 and the GroupNorm kernel, K1's and
    K3's plain routes, the attention route's counts (``K2.ROUTES``: K2 by
    head size, layout copies), the conv route's (``conv_counts``) and the
    GroupNorm route's to 0 just before an entry point runs."""
    from pointreggpt_tpu_torch.ops import conv as KC
    from pointreggpt_tpu_torch.ops import group_norm as GN

    for k in GN.ROUTES:
        GN.ROUTES[k] = 0
    GN.group_norm_act.launches = 0

    for op in (K1.fused_linear_attention, K1.fused_linear_attention_bwd):
        op.launches = op.plain_routes = 0
    K2.multihead_attention.launches = 0
    for k in K2.ROUTES:
        K2.ROUTES[k] = 0
    KC.conv3x3.launches = KC.conv3_dw.launches = 0
    for k in KC.ROUTES:
        KC.ROUTES[k] = 0


def conv_counts() -> tuple:
    """(3x3 convs routed to K5, convs left to ``F.conv2d``, K5 launches,
    forward and dx, ``conv3_dw`` launches)."""
    from pointreggpt_tpu_torch.ops import conv as KC

    return (KC.ROUTES["conv_k5"], KC.ROUTES["conv_library"],
            KC.conv3x3.launches, KC.conv3_dw.launches)


# the fp32 MaskUNet's convs a forward: 3x3 SAME ones routed to K5, the
# rest (7x7, 4x4 stride 2, 1x1) left to F.conv2d
MASK_K5_CONVS, MASK_LIBRARY_CONVS = 43, 15


def mask_conv_want(fwd_bwd: int, fwd: int = 0) -> tuple:
    """``conv_counts`` of ``fwd_bwd`` MaskUNet forwards and backwards and
    ``fwd`` forwards alone."""
    n = fwd_bwd + fwd
    return (MASK_K5_CONVS * n, MASK_LIBRARY_CONVS * n,
            MASK_K5_CONVS * (2 * fwd_bwd + fwd), MASK_K5_CONVS * fwd_bwd)


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


MASK_PAIRS = 48  # 36 train pairs (9 steps an epoch at batch 4), 12 val
MASK_VAL_FRACTION = 0.25  # 12 val pairs: batches of 8 and a ragged 4
MASK_EPOCHS = 2  # then a resumed call runs the third
MASK_ATOL = 1e-5  # keep probabilities, the Generator's net vs the trainer's


def mask_batch_checks(torch, K1, K2) -> dict:
    """K1, K3 and K2 in fp32 against their plain versions at the
    MaskTrainer's batch (``MASK_BATCH``), on the shapes its step gives
    them: K1 and K3 at the MaskUNet's eight (n, c) (``K1_SHAPES``; the kv
    split layout and its merge depend on the batch,
    ``ops/linear_attention.py::_splits``), K2 at (4, 1024, 4, 32); the
    gates of ``phase_k1``, ``phase_k3`` and ``phase_k2``. Returns the
    largest error of each."""
    dev, f32, eps = torch.device("cuda"), torch.float32, 1e-5
    k1_atol, k2_atol = K_ATOL[("k1", "float32")], K_ATOL[("k2", "float32")]
    k3_rtol = K3_ATOL["float32"]
    k1_err = k3_rel = 0.0
    for n, c in sorted(set(K1_SHAPES)):
        args = K1.check_inputs(MASK_BATCH, n, c, f32, dev)
        out = K1.fused_linear_attention(*args, eps=eps)
        ref = K1.fused_linear_attention_plain(*args, eps=eps)
        err = (out - ref).abs().max().item()
        if not err <= k1_atol:
            raise AssertionError(f"K1 float32 at ({MASK_BATCH}, {n}, {c}): "
                                 f"max abs err {err} > {k1_atol}")
        k1_err = max(k1_err, err)
        del args, out, ref
        rel, _ = k3_errors(torch, K1, K1.check_inputs_bwd(
            MASK_BATCH, n, c, f32, dev), eps)
        bad = {k: v for k, v in rel.items() if not v <= k3_rtol}
        if bad:
            raise AssertionError(f"K3 float32 at ({MASK_BATCH}, {n}, {c}): "
                                 f"relative errors {bad} > {k3_rtol}")
        k3_rel = max(k3_rel, *rel.values())
        torch.cuda.empty_cache()
    q, k, v = K2.check_inputs(MASK_BATCH, 1024, 4, 32, f32, dev)
    k2_err = (K2.multihead_attention(q, k, v, scale=32**-0.5) -
              K2.multihead_attention_plain(q, k, v, scale=32**-0.5)
              ).abs().max().item()
    if not k2_err <= k2_atol:
        raise AssertionError(f"K2 float32 at ({MASK_BATCH}, 1024, 4, 32): "
                             f"max abs err {k2_err} > {k2_atol}")
    return dict(batch=MASK_BATCH, k1_max_abs_err=k1_err, k1_atol=k1_atol,
                k3_max_rel_err=k3_rel, k3_rtol=k3_rtol,
                k2_max_abs_err=k2_err, k2_atol=k2_atol)


def phase_mask_train_path(torch, K1, K2, seed: int, tmp: Path,
                          fwd_bwd: dict):
    """The depth-correction path through its three entry points at the
    production configuration (``MaskModelConfig``: dim 64, (1, 2, 4, 8),
    fp32; ``MaskTrainConfig``: batch 4 at 256^2, lr 4e-5, gamma 0.95,
    validation batch 8), cut in depth only (48 pairs, 3 epochs):
    ``make_depth_correction_data`` on a synthetic tree whose fragment
    pairs differ by a camera motion, ``train_depth_correction`` for 2
    epochs and again with ``--resume latest`` for a third, then
    ``test_depth_correction`` on 4 items. Checks 8 K1, 8 K3 and 1 K2 per
    optimizer step (8 K1 and 1 K2 per validation batch, and the forward
    that records the best net's output, counted apart), the conv route's
    counts alike (``mask_conv_want``: 43 convs on K5 with 43 forward, 43
    dx and 43 ``conv3_dw`` launches and 15 on ``F.conv2d`` a step), no
    plain route, finite losses, the staircase learning rate, both
    checkpoints, the Generator's reading of ``model-best.pt`` (its net's
    keep probabilities on a validation input against the trainer's net's
    when it saved them, within ``MASK_ATOL``) and the 8 GIFs; reports each
    step's device time (CUDA events) beside ``mask_fwd_bwd``'s median.
    First, apart from the counted run, :func:`mask_batch_checks`."""
    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.cli import make_depth_correction_data
    from pointreggpt_tpu_torch.cli import test_depth_correction
    from pointreggpt_tpu_torch.cli import train_depth_correction
    from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
    from pointreggpt_tpu_torch.generate import Generator
    from pointreggpt_tpu_torch.models.blocks import LinearAttention
    from pointreggpt_tpu_torch.tools.synthetic_3dmatch import (
        write_motion_tree)
    from pointreggpt_tpu_torch.train import checkpoint as ckpt
    from pointreggpt_tpu_torch.train import mask_trainer as mt

    checks = mask_batch_checks(torch, K1, K2)
    root = tmp / "mask_path"
    rgbd, data_root, info_path, _ = write_motion_tree(root, MASK_PAIRS, seed)
    cfg = C.MaskTrainConfig()
    pairs, results = root / "pairs", root / "results"
    steps, epochs, evals, best_probs, saves = [], [], [], [], []
    Trainer = mt.MaskTrainer
    orig = (Trainer.train_step, Trainer.train_one_epoch,
            Trainer.eval_one_epoch, Trainer.save)

    def train_step(self, *a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        loss = orig[0](self, *a)
        e1.record()
        steps.append((self.epoch, e0, e1, loss,
                      self.opt.param_groups[0]["lr"]))
        return loss

    def train_one_epoch(self):
        t0 = time.perf_counter()
        out = orig[1](self)
        epochs.append((self.epoch, time.perf_counter() - t0))
        return out

    def launches():  # K1, K3, K2, then conv_counts
        return counts(K1, K2)[:3] + conv_counts()

    def eval_one_epoch(self):
        before = launches()
        t0 = time.perf_counter()
        orig[2](self)
        evals.append((self.epoch, time.perf_counter() - t0,
                      tuple(b - a for a, b in zip(before, launches()))))

    def save(self, milestone):
        if milestone == "best":
            # the net's keep probabilities when it is saved as the best,
            # its launches counted apart
            before = launches()
            with torch.inference_mode():
                best_probs[:] = [self.model.eval()(val_input()).cpu()]
            saves.append(tuple(b - a for a, b in zip(before, launches())))
        orig[3](self, milestone)

    def val_input():
        item = mt.PairedDepthDataset(str(pairs), "val", cfg.image_size)[0]
        return torch.from_numpy(item["input_img"][None]).permute(
            0, 3, 1, 2).cuda()

    cwd = os.getcwd()
    os.chdir(root)  # the tester reads ./dataset/indoor/data
    try:
        t0 = time.perf_counter()
        make_depth_correction_data.main([
            "--data", str(rgbd), "--train_info", str(info_path),
            "--data_root", str(data_root), "--out", str(pairs),
            "--image_size", str(cfg.image_size),
            "--num_pairs", str(MASK_PAIRS),
            "--val_fraction", str(MASK_VAL_FRACTION), "--seed", str(seed)])
        make_s = time.perf_counter() - t0
        flags = ["--data", str(pairs), "--results_folder", str(results),
                 "--samples_folder", str(root / "samples")]
        (Trainer.train_step, Trainer.train_one_epoch,
         Trainer.eval_one_epoch, Trainer.save) = (
            train_step, train_one_epoch, eval_one_epoch, save)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(K1, K2)
        t0 = time.perf_counter()
        train_depth_correction.main(flags + ["--epochs", str(MASK_EPOCHS)])
        train_depth_correction.main(flags + [
            "--epochs", str(MASK_EPOCHS + 1), "--resume", "latest"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        *total, routes = counts(K1, K2)
        total += conv_counts()
        peak = torch.cuda.max_memory_allocated()
        (Trainer.train_step, Trainer.train_one_epoch,
         Trainer.eval_one_epoch, Trainer.save) = orig
        t0 = time.perf_counter()
        test_depth_correction.main([
            "--resume", "best", "--data", str(rgbd),
            "--info", str(info_path), "--limit", "4",
            "--image_size", str(cfg.image_size),
            "--results_folder", str(results),
            "--samples_folder", str(root / "test_samples")])
        test_s = time.perf_counter() - t0
    finally:
        (Trainer.train_step, Trainer.train_one_epoch,
         Trainer.eval_one_epoch, Trainer.save) = orig
        os.chdir(cwd)

    n_train = len(json.loads((pairs / "metadata/train.json").read_text()))
    per_epoch = n_train // cfg.train_batch_size
    n_steps = len(steps)
    if [e for e, _ in epochs] != list(range(MASK_EPOCHS + 1)) or \
            n_steps != per_epoch * (MASK_EPOCHS + 1) or per_epoch < 8:
        raise AssertionError(
            f"mask_train_path: epochs {[e for e, _ in epochs]} with "
            f"{n_steps} steps, want 0..{MASK_EPOCHS} (the last resumed) "
            f"of {per_epoch} >= 8 steps")
    val_batches = -(-len(json.loads((pairs / "metadata/val.json")
                                    .read_text())) // cfg.val_batch_size)
    mask = C.build_mask_unet(C.MaskModelConfig())
    n_attn = sum(isinstance(m, LinearAttention) for m in mask.modules())
    n_evals = val_batches * len(evals)
    eval_n = tuple(sum(e[2][i] for e in evals) for i in range(7))
    want_eval = (n_attn * n_evals, 0, n_evals) + mask_conv_want(0, n_evals)
    save_n = tuple(sum(n[i] for n in saves) for i in range(7))
    want_save = (n_attn * len(saves), 0, len(saves)) + mask_conv_want(
        0, len(saves))
    step_n = tuple(t - v - b for t, v, b in zip(total, eval_n, save_n))
    want_step = (n_attn * n_steps, n_attn * n_steps, n_steps) + \
        mask_conv_want(n_steps)
    if (step_n, eval_n, save_n) != (want_step, want_eval, want_save) or \
            len(evals) != 3:
        raise AssertionError(
            f"mask_train_path launches K1, K3, K2, then convs routed to "
            f"K5, left to F.conv2d, K5 and conv3_dw launches: steps "
            f"{step_n} (want {want_step}), validation {eval_n} (want "
            f"{want_eval}), best-net forwards {save_n} (want {want_save})")
    check_no_routes("mask_train_path", routes)
    losses = [v.item() for _, _, _, v, _ in steps]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"mask_train_path losses {losses}")
    lrs = {e: lr for e, _, _, _, lr in steps}
    want_lrs = {e: cfg.train_lr * cfg.lr_gamma**e for e in lrs}
    if any(abs(lrs[e] - want_lrs[e]) > 1e-12 for e in lrs):
        raise AssertionError(f"mask_train_path learning rates {lrs}, want "
                             f"{want_lrs}")
    for name in ("model-best.pt", "model-latest.pt"):
        if not (results / name).is_file():
            raise AssertionError(f"mask_train_path: no {name}")
    data = ckpt.load_checkpoint(results / "model-latest.pt")
    if data["epoch"] != MASK_EPOCHS or \
            len(data["loss_hist"]) != MASK_EPOCHS + 1:
        raise AssertionError("mask_train_path: model-latest.pt holds epoch "
                             f"{data['epoch']}, {data['loss_hist']}")

    # the port's Generator reads model-best.pt as generation does
    gen = Generator(C.build_diffusion_unet(C.ModelConfig(dim=8)),
                    GaussianDiffusion(image_size=cfg.image_size), str(rgbd),
                    depth_correction_model=mask,
                    depth_correction_results=str(results),
                    samples_folder=str(root / "gen_samples"))
    gen._load_depth_correction()
    dc = gen.device_models()[1]
    with torch.inference_mode():
        prob = dc(val_input()).cpu()
    gen_err = (prob - best_probs[0]).abs().max().item()
    if not gen_err <= MASK_ATOL:
        raise AssertionError(f"mask_train_path: the Generator's mask net "
                             f"{gen_err} from the trainer's > {MASK_ATOL}")
    gifs = sorted(p.name for p in (root / "test_samples").iterdir())
    if len(gifs) != 8 or not all(g.endswith(".gif") for g in gifs):
        raise AssertionError(f"mask_train_path: test GIFs {gifs}")

    step_ms = [a.elapsed_time(b) for _, a, b, _, _ in steps]
    # the first epoch carries the warm-up (cuDNN's workspaces, the
    # allocator's pool); the settled steps are the later epochs'
    settled = step_ms[per_epoch:]
    med = float(np.median(settled))
    res = dict(
        pairs=MASK_PAIRS, train_pairs=n_train, steps_per_epoch=per_epoch,
        batch=cfg.train_batch_size, image=cfg.image_size,
        val_batch=cfg.val_batch_size, val_batches=val_batches,
        make_pairs_s=make_s, train_s=train_s, test_s=test_s,
        epoch_wall_s=[s for _, s in epochs],
        val_wall_s=[s for _, s, _ in evals],
        step_ms=med, step_ms_min=min(settled), step_ms_max=max(settled),
        step_ms_first_epoch=step_ms[:per_epoch], step_ms_all=step_ms,
        img_per_s=cfg.train_batch_size * 1e3 / med,
        img_per_s_epoch=[per_epoch * cfg.train_batch_size / s
                         for _, s in epochs],
        fwd_bwd_step_ms=fwd_bwd["step_ms"],
        step_over_fwd_bwd=med / fwd_bwd["step_ms"], batch_checks=checks,
        peak_mem_gb=peak / 1e9, losses=losses,
        lr_by_epoch=[lrs[e] for e in sorted(lrs)],
        k1_per_step=step_n[0] / n_steps, k3_per_step=step_n[1] / n_steps,
        k2_per_step=step_n[2] / n_steps,
        k1_per_val_batch=eval_n[0] / n_evals,
        k2_per_val_batch=eval_n[2] / n_evals,
        conv_per_step=dict(zip(("k5", "library", "k5_launches",
                                "dw_launches"),
                               (n / n_steps for n in step_n[3:]))),
        k1_launches=total[0], k3_launches=total[1], k2_launches=total[2],
        plain_routes=routes, generator_max_abs_err=gen_err,
        generator_atol=MASK_ATOL, gifs=len(gifs))
    emit("mask_train_path", card=card_line(), **res)
    return res


# per sample step of the production chain (250 DDIM steps, two MaskUNet
# passes): (K1, K3, K2) launches, and K2's routes (``K2.ROUTES``) where a
# denoiser's are required; ADM has 16 attention blocks a forward, each one
# K2 call at d = 64 on its qkv conv's output read in place (no copy)
MAIN_PATH_LAUNCHES = {"unet": (2016, 0, 252), "adm": (16, 0, 4002)}
# and every GroupNorm on the kernel with no layout copy: 38 a
# DiffusionUNet or MaskUNet forward (250 + 2 a step), 101 an ADM forward
MAIN_PATH_ROUTES = {
    "unet": {"norm_fused": 38 * 252, "norm_plain": 0, "norm_copies": 0},
    "adm": {"attn_k2_d32": 2, "attn_k2_d64": 4000, "attn_copies": 0,
            "norm_fused": 101 * 250 + 38 * 2, "norm_plain": 0,
            "norm_copies": 0}}


def phase_main_path(torch, K1, K2, seed: int, num_samples: int,
                    root: Path, denoiser: str = "unet"):
    """``generate_dataset.main`` under ``root`` (its dataset stays there
    for ``gt_path``) with the ``denoiser`` it names: ``unet`` the
    DiffusionUNet, ``adm`` guided-diffusion's ADM at its published flags
    (``--denoiser adm``), each of seeded weights; the launches and routes
    of :data:`MAIN_PATH_LAUNCHES` and :data:`MAIN_PATH_ROUTES` a sample
    step."""
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

    root.mkdir(parents=True)
    rgbd, indoor, info = write_synthetic_tree(root, batch, seed)
    write_checkpoints(torch, root, seed, denoiser)
    cwd = os.getcwd()
    os.chdir(root)
    gen_mod.Generator.step = timed_step
    reset_counts(K1, K2)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_dataset.main([
            "--denoiser", denoiser, "--resume", "1", "--data", str(rgbd),
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
    from pointreggpt_tpu_torch.ops import group_norm as GN
    from pointreggpt_tpu_torch.ops.routes import ROUTES
    attn = {k: ROUTES[k] for k in (*K2.ROUTES, "norm_fused", "norm_plain",
                                   "norm_copies")}
    norm_launches = GN.group_norm_act.launches
    if norm_launches != 2 * attn["norm_fused"]:
        raise AssertionError(f"GroupNorm kernel launches on the {denoiser} "
                             f"main path: {norm_launches}, want two for "
                             f"each of {attn['norm_fused']} calls")
    want = tuple(n * num_samples for n in MAIN_PATH_LAUNCHES[denoiser])
    if (k1_n, k3_n, k2_n) != want:
        raise AssertionError(
            f"kernel launches on the {denoiser} main path: K1, K3, K2 = "
            f"{(k1_n, k3_n, k2_n)}, want {want}")
    want_attn = {k: n * num_samples
                 for k, n in MAIN_PATH_ROUTES.get(denoiser, {}).items()}
    if any(attn[k] != n for k, n in want_attn.items()):
        raise AssertionError(f"attention and norm routes on the "
                             f"{denoiser} main path: {attn}, want "
                             f"{want_attn}")
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
               norm_launches=norm_launches, plain_routes=routes, k1_per_step=k1_n / num_samples,
               k3_per_step=k3_n / num_samples,
               k2_per_step=k2_n / num_samples, attention_routes=attn,
               attention_routes_per_step={k: v / num_samples
                                          for k, v in attn.items()})
    emit("main_path" if denoiser == "unet" else f"main_path_{denoiser}",
         card=card_line(), denoiser=denoiser, **res)
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
    from pointreggpt_tpu_torch.ops import group_norm as GN
    if GN.ROUTES["norm_fused"] or GN.ROUTES["norm_plain"] != 38 * 2:
        raise AssertionError(f"train_step GroupNorm routes {GN.ROUTES}, "
                             f"want the 76 of two microbatches plain")
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
        total += conv_counts()
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


# ---------------------------------------------------------------------------
# jax_parity, gt_path and tester_path

JAX_REFERENCE = REPO / "tests" / "data" / "torch_port_jax_reference.npz"
# card vs JAX: the keep mask may differ where a fused multiply-add moves a
# splatted point across a pixel edge (the card-vs-CPU rule of
# tests/test_torch_port_cuda.py, TestDataset: at most 0.1% of pixels)
KEEP_SHARE = 1e-3
# each gate is this times (the port's CPU gap to JAX, stored beside the
# reference, + the kernels' gap to their plain versions on the card,
# measured here): the port's plain path on the card is a second draw of
# the CPU's rounding, not the same one
GATE_FACTOR = 2.0
FAULT_MARGIN = 5.0  # the planted fault misses the forward gate by this


@contextlib.contextmanager
def plain_attention(K1, K2):
    """K1's and K2's plain versions in the U-Net blocks, on the card:
    the port's path with its two kernels taken out, to measure their part
    of a gap. Never used on a counted run."""
    from pointreggpt_tpu_torch.models import blocks

    saved = blocks.fused_linear_attention, blocks.multihead_attention
    blocks.fused_linear_attention = K1.fused_linear_attention_plain
    blocks.multihead_attention = K2.multihead_attention_plain
    try:
        yield
    finally:
        blocks.fused_linear_attention, blocks.multihead_attention = saved


def jax_parity_report(torch, K1, K2, tmp: Path, cases=None) -> dict:
    """The port's full-width outputs on the card (K1 and K2 in bf16 for
    the DiffusionUNet, in fp32 for the MaskUNet) against the JAX
    package's (``JAX_REFERENCE``): each gap beside its gate, built from
    the CPU gap and the kernels' gap measured here; the launches of the
    run; and the gap of a planted fault (a shuffled head,
    ``jax_parity.plant_fault``) on the forward case."""
    from pointreggpt_tpu_torch.utils import jax_parity as J

    cases = J.CASES if cases is None else cases
    ref = dict(np.load(JAX_REFERENCE))
    nets = J.nets()
    tmp.mkdir(parents=True, exist_ok=True)
    reset_counts(K1, K2)
    t0 = time.perf_counter()
    card = J.run_port("cuda", cases=cases, nets_=nets, tmp_dir=str(tmp))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1_n, k3_n, k2_n, routes = counts(K1, K2)
    with plain_attention(K1, K2):
        plain = J.run_port("cuda", cases=cases, nets_=nets,
                           tmp_dir=str(tmp))
    card_gap, kernel_gap = J.gaps(card, ref), J.gaps(card, plain)
    cpu_gap = {k: float(ref[f"cpu_gap_{k}"]) for k in card_gap}
    gate = {k: GATE_FACTOR * (cpu_gap[k] + kernel_gap[k])
            for k in card_gap}
    if "step_keep" in gate:
        gate["step_keep"] = KEEP_SHARE
    fault = None
    if "forward" in cases:
        fault = J.gaps(J.run_port("cuda", cases=("forward",),
                                  nets_=(J.plant_fault(nets[0]),) +
                                  nets[1:]), ref)["forward"]
    forwards = {"forward": 1, "mask": 1,
                "step": J.STEP_SAMPLING_TIMESTEPS + 2}
    n_fwd = sum(forwards[c] for c in cases)
    return dict(cases=list(cases), seconds=seconds, card_gap=card_gap,
                cpu_gap=cpu_gap, kernel_gap=kernel_gap,
                plain_gap=J.gaps(plain, ref), gate=gate,
                failed={k: v for k, v in card_gap.items()
                        if not v <= gate[k]},
                fault_gap=fault,
                fault_over_gate=(fault / gate["forward"]
                                 if fault is not None else None),
                launches={"k1": k1_n, "k3": k3_n, "k2": k2_n},
                want_launches={"k1": 8 * n_fwd, "k3": 0, "k2": n_fwd},
                plain_routes=routes)


def phase_jax_parity(torch, K1, K2, tmp: Path) -> dict:
    """:func:`jax_parity_report` on the three cases; fails on any gap over
    its gate, on a planted fault within ``FAULT_MARGIN`` of the forward
    gate, and on launches other than 8 K1 and 1 K2 a forward."""
    res = jax_parity_report(torch, K1, K2, tmp / "jax_parity")
    emit("jax_parity", card=card_line(), **res)
    if res["failed"]:
        raise AssertionError(f"jax_parity: card vs JAX over the gate "
                             f"{res['failed']} (gates {res['gate']})")
    if not res["fault_over_gate"] >= FAULT_MARGIN:
        raise AssertionError(f"jax_parity: the planted fault reads "
                             f"{res['fault_gap']}, under {FAULT_MARGIN} x "
                             f"the forward gate {res['gate']['forward']}")
    if res["launches"] != res["want_launches"]:
        raise AssertionError(f"jax_parity: launches {res['launches']}, "
                             f"want {res['want_launches']}")
    check_no_routes("jax_parity", res["plain_routes"])
    return res


GT_PAIRS = 4  # synthetic scenes of two frames each, for gt_path (b)
# gt.log prints ratios to 4 decimals: two half-unit roundings apart
GT_PRINT = 1e-4


def write_overlap_tree(data: Path, n_pairs: int, seed: int) -> None:
    """``n_pairs`` scenes of two clouds with known overlap: the two depth
    frames of ``tools/synthetic_3dmatch.py``'s pairs (480x640, a wall and
    a floating plate seen from camera poses 2-5 degrees and 5-15 cm
    apart), back-projected into the world frame."""
    from PIL import Image

    from pointreggpt_tpu_torch.core import geometry as G
    from pointreggpt_tpu_torch.core import plyio
    from pointreggpt_tpu_torch.tools import synthetic_3dmatch as syn

    rgbd, _, _, _ = syn.write_motion_tree(data.parent / "frames", n_pairs,
                                          seed)
    for s in range(n_pairs):
        scene = data / f"scene-{s:06d}"
        scene.mkdir(parents=True)
        for f in range(2):
            seq = rgbd / f"scene-{s}" / "seq-01"
            depth = np.asarray(Image.open(seq / f"frame-{f:06d}.depth.png"),
                               np.float32) / 1000.0
            pose = np.loadtxt(seq / f"frame-{f:06d}.pose.txt")
            pc = G.point_cloud_np(depth, syn.K, clip=(0.0, 10.0))
            world = pc @ pose[:3, :3].T + pose[:3, 3]
            plyio.write_ply(scene / f"sample-{f:06d}.cloud.ply",
                            world.astype(np.float32))


def read_gt_lines(path: Path):
    return [line.split("\t") for line in path.read_text().splitlines()]


def phase_gt_path(torch, seed: int, main_root: Path, tmp: Path) -> dict:
    """The port's ``generate_gt`` CLI (a) on the dataset ``main_path``
    wrote (8 scenes of 256^2 frames, ``num_samples`` 2): a ``gt.log`` in
    each scene, ``metadata/gt.log`` their concatenation, every line parsed
    by ``parse_gt_log``, and the seconds per scored pair; (b) on
    ``write_overlap_tree``'s scenes, card against the same functions on
    the CPU: the same pair lines, each ratio within one point of its
    downsampled cloud (1 / n) and the print's rounding."""
    import shutil

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.cli import generate_gt
    from pointreggpt_tpu_torch.core import plyio
    from pointreggpt_tpu_torch.core import pointops as P
    from pointreggpt_tpu_torch.generate import gt

    cfg = C.GtLogConfig()
    n_scenes = 8
    data = main_root / cfg.dataset_name / "data"
    sizes = [[len(plyio.read_ply(data / f"scene-{s:06d}" /
                                 f"sample-{i:06d}.cloud.ply"))
              for i in range(cfg.num_samples)] for s in range(n_scenes)]
    scored = sum(min(z) >= cfg.min_points for z in sizes)
    cwd = os.getcwd()
    os.chdir(main_root)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_gt.main(["-start", "0", "-stop", str(n_scenes),
                          "--disable_tqdm"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    logs = [(data / f"scene-{s:06d}" / "gt.log").read_text()
            for s in range(n_scenes)]
    meta = main_root / cfg.dataset_name / "metadata" / "gt.log"
    if meta.read_text() != "".join(logs):
        raise AssertionError("gt_path: metadata/gt.log is not the "
                             "concatenation of the scenes' gt.log")
    records = gt.parse_gt_log(meta)
    if not scored:
        raise AssertionError(f"gt_path: no scene of main_path has two "
                             f"clouds of {cfg.min_points} points {sizes}")
    if len(records) != sum(len(x.splitlines()) for x in logs) or any(
            not (0.0 <= r["overlap_src"] <= 1.0 and
                 0.0 <= r["overlap_tgt"] <= 1.0) for r in records):
        raise AssertionError(f"gt_path: gt.log records {records}")

    root = tmp / "gt_overlap"
    write_overlap_tree(root / "cuda" / "data", GT_PAIRS, seed)
    shutil.copytree(root / "cuda" / "data", root / "cpu" / "data")
    walls = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gt.generate_gt("syn", 0, GT_PAIRS, 2, root=str(root / dev / "data"),
                       verbose=False, device=dev)
        torch.cuda.synchronize()
        walls[dev] = time.perf_counter() - t0
        gt.gather_gt("syn", 0, GT_PAIRS, root=str(root / dev / "data"),
                     metadata=str(root / dev / "metadata" / "gt.log"))
    got = read_gt_lines(root / "cuda" / "metadata" / "gt.log")
    want = read_gt_lines(root / "cpu" / "metadata" / "gt.log")
    if [g[:3] for g in got] != [w[:3] for w in want] or \
            len(got) != GT_PAIRS:
        raise AssertionError(f"gt_path: card pairs {got}, CPU {want}")
    worst = 0.0
    for g, w in zip(got, want):
        scene = root / "cpu" / "data" / g[0]
        for k in range(2):
            pts = torch.from_numpy(plyio.read_ply(
                scene / f"sample-{k:06d}.cloud.ply").astype(np.float32))
            n = int(P.voxel_downsample(pts, torch.ones(len(pts), dtype=bool),
                                       cfg.voxel_size)[1].sum())
            d = abs(float(g[3 + k]) - float(w[3 + k]))
            worst = max(worst, d * n)
            if not d <= 1.0 / n + GT_PRINT:
                raise AssertionError(f"gt_path: {g} on the card, {w} on "
                                     f"the CPU: past 1 / {n}")
    res = dict(scenes=n_scenes, cloud_points=sizes, pairs_scored=scored,
               lines=len(records), cli_wall_s=wall,
               s_per_pair=wall / max(scored, 1),
               overlap_pairs=GT_PAIRS,
               overlap_ratios=[[float(x) for x in g[3:]] for g in got],
               overlap_card_s=walls["cuda"], overlap_cpu_s=walls["cpu"],
               overlap_worst_points=worst)
    emit("gt_path", card=card_line(), **res)
    return res


TESTER_SCENES, TESTER_SAMPLES, TESTER_BATCH = 4, 4, 4  # the CLI's defaults


def phase_tester_path(torch, K1, K2, seed: int, tmp: Path) -> dict:
    """The Tester at ``ModelConfig()`` width (dim 64, (1, 2, 4, 8), 256^2,
    bf16) on a ``model-1.pt`` of seeded weights: (1) the CLI
    ``test_successive_ddnm_diffusion.main`` with its defaults (4 scenes x
    4 samples, batch 4, 32 DDIM steps, eta 1): the JAX Tester's file
    names and PNG sizes, 4 sample calls x 32 forwards = 1,024 K1 and 128
    K2 launches, no K3, no plain route, the device time of each sample
    call; (2) ``Tester.generate`` at 4 scenes x 3 samples, voxel 0.005,
    memory 2^18: ``scene-{sid}.ply`` and ``-memory.ply``; (3) the
    ancestral chain through the CLI, ``--sampling_timesteps 1000``, 1
    scene x 1 sample at batch 1: 8,000 K1 and 1,000 K2."""
    from PIL import Image

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.cli import test_successive_ddnm_diffusion as tc
    from pointreggpt_tpu_torch.core import plyio
    from pointreggpt_tpu_torch.diffusion import gaussian
    from pointreggpt_tpu_torch.generate.tester import Tester
    from pointreggpt_tpu_torch.utils.seeded_weights import fill_seeded

    root = tmp / "tester"
    (root / "results").mkdir(parents=True)
    unet = fill_seeded(C.build_diffusion_unet(C.ModelConfig()), seed)
    sd = {f"model.{k}": v for k, v in unet.state_dict().items()}
    torch.save({"step": 1, "model": sd,
                "ema": {f"ema_model.{k}": v for k, v in sd.items()}},
               root / "results" / "model-1.pt")
    calls = []
    orig = gaussian.GaussianDiffusion.sample

    def timed_sample(self, *a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(self, *a, **kw)
        e1.record()
        calls.append((e0, e1))
        return out

    def run(fn, want):
        calls.clear()
        reset_counts(K1, K2)
        gaussian.GaussianDiffusion.sample = timed_sample
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            gaussian.GaussianDiffusion.sample = orig
        k1_n, k3_n, k2_n, routes = counts(K1, K2)
        if (k1_n, k3_n, k2_n) != want:
            raise AssertionError(f"tester_path: K1, K3, K2 = "
                                 f"{(k1_n, k3_n, k2_n)}, want {want}")
        check_no_routes("tester_path", routes)
        return dict(wall_s=wall, k1=k1_n, k3=k3_n, k2=k2_n,
                    sample_call_s=[a.elapsed_time(b) / 1e3
                                   for a, b in calls])

    steps = tc.TEST_DIFFUSION.sampling_timesteps
    cli_args = ["--resume", "1", "--results_folder", str(root / "results")]
    n_calls = -(-TESTER_SCENES // TESTER_BATCH) * TESTER_SAMPLES
    cli = run(lambda: tc.main(cli_args + ["--samples_folder",
                                          str(root / "sample")]),
              (8 * steps * n_calls, 0, steps * n_calls))
    out = root / "sample"
    h = C.DiffusionConfig().image_size
    for sid in range(TESTER_SCENES):
        for k in range(TESTER_SAMPLES):
            with Image.open(out / f"scene-{sid}-sample-{k}.png") as im:
                if im.size != (3 * h, h):
                    raise AssertionError(f"tester_path: {im.size} PNG")
            cloud = plyio.read_ply(out / f"scene-{sid}-sample-{k}.ply")
            if cloud.ndim != 2 or not np.all(np.isfinite(cloud)):
                raise AssertionError("tester_path: bad PLY")
        if np.loadtxt(out / f"scene-{sid}-camera-intrinsics.txt"
                      ).shape != (3, 3):
            raise AssertionError("tester_path: bad intrinsics")
    with Image.open(out / "overview.png") as im:
        if im.size != (TESTER_SAMPLES * 3 * h, TESTER_SCENES * h):
            raise AssertionError(f"tester_path: overview {im.size}")

    gen_samples = 3
    tester = Tester(C.build_diffusion_unet(C.ModelConfig()),
                    C.build_diffusion(tc.TEST_DIFFUSION),
                    batch_size=TESTER_BATCH,
                    results_folder=str(root / "results"),
                    samples_folder=str(root / "generate"))
    tester.load(1)
    n_gen = gen_samples * -(-TESTER_SCENES // TESTER_BATCH)
    generate = run(lambda: tester.generate(
        TESTER_SCENES, gen_samples, voxel_size=0.005,
        memory_capacity=1 << 18), (8 * steps * n_gen, 0, steps * n_gen))
    clouds = {}
    for sid in range(TESTER_SCENES):
        for name in (f"scene-{sid}.ply", f"scene-{sid}-memory.ply"):
            pts = plyio.read_ply(root / "generate" / name)
            if len(pts) == 0 or not np.all(np.isfinite(pts)):
                raise AssertionError(f"tester_path: {name} {pts.shape}")
            clouds[name] = len(pts)
    del tester
    torch.cuda.empty_cache()

    t = C.DiffusionConfig().timesteps
    ancestral = run(lambda: tc.main(cli_args + [
        "--samples_folder", str(root / "ancestral"),
        "--sampling_timesteps", str(t), "--num_scenes", "1",
        "--num_samples", "1", "--batch_size", "1"]), (8 * t, 0, t))
    with Image.open(root / "ancestral" / "scene-0-sample-0.png") as im:
        if im.size != (3 * h, h):
            raise AssertionError(f"tester_path: ancestral {im.size}")

    res = dict(cli=cli, cli_sample_calls=n_calls,
               s_per_sample_call=float(np.median(cli["sample_call_s"])),
               generate=generate, generate_clouds=clouds,
               ancestral=ancestral, ancestral_forwards=t)
    emit("tester_path", card=card_line(), **res)
    return res


# ---------------------------------------------------------------------------
# fid_path, import_path and mixture_path

FID_REFERENCE = REPO / "tests" / "data" / "torch_port_fid_import_reference.npz"
FID_FAULT_MARGIN = 10.0  # the flipped pools miss the features gate by this
# card vs CPU fid_score, relative: feature noise of 3e-7 (the port's CPU
# gap to JAX) moves the score by 0.6-1.7e-4 on the CPU
FID_SCORE_RTOL = 1e-2
FID_STEPS = 2  # optimizer steps of fid_path's training run, one milestone
MIXTURE_EDGE = 1e-5  # a pair within this of the radius may flip in fp32


def fid_features_report(torch) -> dict:
    """``InceptionFeatures`` at 299^2 on ``jax_parity.fid_images()`` (32
    images, one chunk of 32) on the card, against the port on the CPU and
    the JAX features in ``FID_REFERENCE``: the gap to JAX beside its gate
    (``GATE_FACTOR`` x (the CPU gap stored with the reference + the card's
    gap to the CPU)), the gap of a planted fault (``fid_pools`` flipped in
    the port's module), the features a second, the ``fid_score`` of two
    seeded sets on the card and on the CPU."""
    from pointreggpt_tpu_torch.eval import fid, inception
    from pointreggpt_tpu_torch.utils import jax_parity as J

    ref = np.load(FID_REFERENCE)
    sd = inception.init_random_params(J.INCEPTION_SEED)
    imgs, other = J.fid_images(), J.fid_images(J.SEED + 1)
    card = fid.InceptionFeatures(state_dict=sd, device="cuda")
    cpu = fid.InceptionFeatures(state_dict=sd, device="cpu")
    got, plain = card(imgs), cpu(imgs)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card(imgs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    want = ref["fid_features"]
    card_gap = float(np.abs(got - want).max())
    kernel_gap = float(np.abs(got - plain).max())
    cpu_gap = float(ref["cpu_gap_fid_features"])
    gate = GATE_FACTOR * (cpu_gap + kernel_gap)
    card.model.fid_pools = not card.model.fid_pools
    fault_gap = float(np.abs(card(imgs) - want).max())
    card.model.fid_pools = not card.model.fid_pools
    t0 = time.perf_counter()
    score = fid.fid_score(imgs, other, card)
    score_s = time.perf_counter() - t0
    score_cpu = fid.fid_score(imgs, other, cpu)
    return dict(images=list(imgs.shape), chunk=card.chunk,
                card_gap=card_gap, cpu_gap=cpu_gap, kernel_gap=kernel_gap,
                gate=gate, fault_gap=fault_gap,
                fault_over_gate=fault_gap / gate if gate else float("inf"),
                feature_spread=float(np.abs(got[0] - got[1]).max()),
                features_per_s=len(imgs) / float(np.median(walls)),
                chunk_wall_s=walls, fid_score=score, fid_score_cpu=score_cpu,
                fid_score_rel=abs(score - score_cpu) / abs(score_cpu),
                fid_score_s=score_s)


def phase_fid_path(torch, K1, K2, folder: str, gt_log: str, tmp: Path):
    """FID on the card: (a) the training CLI with ``--calculate_fid`` to
    one milestone (``FID_STEPS`` production steps, the default 25-image
    EMA grid) on ``inception.init_random_params(0)`` weights written as a
    ``.pth`` and reached through ``$PRGPT_INCEPTION_WEIGHTS``: a finite
    ``fid_score`` line in its log, the launches; (b)-(d)
    :func:`fid_features_report`: the features within their gate of JAX's,
    the flipped pools at least ``FID_FAULT_MARGIN`` x the gate, the score
    within ``FID_SCORE_RTOL`` of the CPU's."""
    from pointreggpt_tpu_torch.cli import train_successive_ddnm_diffusion
    from pointreggpt_tpu_torch.eval import fid, inception
    from pointreggpt_tpu_torch.train import metrics

    weights = tmp / "fid" / "inception.pth"
    weights.parent.mkdir(parents=True)
    torch.save(inception.init_random_params(0), weights)
    logged, fid_s = [], []
    orig_info, orig_score = metrics.Logger.info, fid.fid_score

    def info(self, message):
        logged.append(message)
        orig_info(self, message)

    def timed_score(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_score(*a, **kw)
        fid_s.append(time.perf_counter() - t0)
        return out

    saved_env = os.environ.get("PRGPT_INCEPTION_WEIGHTS")
    os.environ["PRGPT_INCEPTION_WEIGHTS"] = str(weights)
    metrics.Logger.info, fid.fid_score = info, timed_score
    try:
        torch.cuda.synchronize()
        reset_counts(K1, K2)
        t0 = time.perf_counter()
        train_successive_ddnm_diffusion.main([
            "--data", folder, "--gt_log", gt_log, "--calculate_fid", "true",
            "--results_folder", str(tmp / "fid" / "results"),
            "--samples_folder", str(tmp / "fid" / "samples"),
            "--train_num_steps", str(FID_STEPS),
            "--save_and_sample_every", str(FID_STEPS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        *launched, routes = counts(K1, K2)
    finally:
        metrics.Logger.info, fid.fid_score = orig_info, orig_score
        if saved_env is None:
            del os.environ["PRGPT_INCEPTION_WEIGHTS"]
        else:
            os.environ["PRGPT_INCEPTION_WEIGHTS"] = saved_env
    scores = [float(m.split(": ", 1)[1]) for m in logged
              if m.startswith("fid_score: ")]
    if len(scores) != 1 or not np.isfinite(scores[0]):
        raise AssertionError(f"fid_path: fid_score lines {scores}, want "
                             "one finite")
    want = (16 * FID_STEPS + 2000, 16 * FID_STEPS, 2 * FID_STEPS + 250)
    if tuple(launched) != want:
        raise AssertionError(f"fid_path launches K1, K3, K2 = {launched}, "
                             f"want {want}")
    check_no_routes("fid_path", routes)

    rep = fid_features_report(torch)
    res = dict(train_wall_s=wall, train_fid_score=scores[0],
               milestone_fid_s=fid_s[0], k1_launches=launched[0],
               k3_launches=launched[1], k2_launches=launched[2],
               plain_routes=routes, fid_score_rtol=FID_SCORE_RTOL, **rep)
    emit("fid_path", card=card_line(), **res)
    if not rep["card_gap"] <= rep["gate"]:
        raise AssertionError(f"fid_path: features {rep['card_gap']} from "
                             f"JAX's, over the gate {rep['gate']}")
    if not rep["fault_over_gate"] >= FID_FAULT_MARGIN:
        raise AssertionError(f"fid_path: the flipped pools read "
                             f"{rep['fault_gap']}, under {FID_FAULT_MARGIN} "
                             f"x the gate {rep['gate']}")
    if not rep["fid_score_rel"] <= FID_SCORE_RTOL:
        raise AssertionError(f"fid_path: fid_score {rep['fid_score']} on "
                             f"the card, {rep['fid_score_cpu']} on the CPU")
    return res


def write_reference_pts(torch, root: Path) -> None:
    """Full-width reference-layout checkpoints of seeded weights, with the
    reference's extra keys: ``model-official.pt`` (the EMA U-Net is
    ``jax_parity``'s bf16 net, the online one another seed) and
    ``model-best.pt`` (``jax_parity``'s step MaskUNet)."""
    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.utils import jax_parity as J
    from pointreggpt_tpu_torch.utils.seeded_weights import fill_seeded

    ema, _, mask = J.nets()
    online = fill_seeded(C.build_diffusion_unet(C.ModelConfig()), J.SEED + 7)
    root.mkdir(parents=True)
    torch.save({
        "step": 1000,
        "model": {**{f"model.{k}": v for k, v in online.state_dict().items()},
                  "betas": torch.zeros(1000)},
        "opt": {"state": {}, "param_groups": []},
        "ema": {"initted": torch.tensor(True), "step": torch.tensor(990),
                **{f"ema_model.model.{k}": v
                   for k, v in ema.state_dict().items()},
                "ema_model.betas": torch.zeros(1000)},
        "scaler": {"scale": 65536.0}}, root / "model-official.pt")
    torch.save({"epoch": 99, "model": mask.state_dict(),
                "opt": {"state": {}, "param_groups": []},
                "scheduler": {"last_epoch": 99}, "scaler": None,
                "loss_hist": [0.5, 0.25],
                "metrics": {"best": {"SAE": torch.tensor(0.125)}}},
               root / "model-best.pt")


def import_step_report(torch, K1, K2, tmp: Path) -> dict:
    """The importer CLI on :func:`write_reference_pts`'s files, then one
    ``Generator.step`` (``jax_parity``'s step case) from the nets the
    Generator's loaders fill from its output, against the same step from
    the un-imported nets: equal bit for bit (same weights, same seed).
    The launches are those of the imported run."""
    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.cli import import_torch_checkpoint
    from pointreggpt_tpu_torch.generate.generator import load_ema_unet
    from pointreggpt_tpu_torch.utils import jax_parity as J
    from pointreggpt_tpu_torch.utils.jax_params import \
        load_reference_checkpoint

    src, out = tmp / "reference", tmp / "imported"
    write_reference_pts(torch, src)
    import_torch_checkpoint.main([
        "--diffusion", str(src / "model-official.pt"),
        "--depth_correction", str(src / "model-best.pt"),
        "--diffusion_out", str(out / "results"),
        "--dc_out", str(out / "dc")])
    unet = C.build_diffusion_unet(C.ModelConfig())
    load_ema_unet(unet, out / "results" / "model-official.pt")
    mask = C.build_mask_unet(C.MaskModelConfig())
    mask.load_state_dict(load_reference_checkpoint(
        out / "dc" / "model-best.pt")["model"])
    reset_counts(K1, K2)
    got = J.run_port("cuda", cases=("step",), nets_=(unet, None, mask),
                     tmp_dir=str(tmp))
    k1_n, k3_n, k2_n, routes = counts(K1, K2)
    ema, _, mask0 = J.nets()
    want = J.run_port("cuda", cases=("step",), nets_=(ema, None, mask0),
                      tmp_dir=str(tmp))
    differ = sorted(k for k in want if not np.array_equal(got[k], want[k]))
    return dict(differ=differ, k1_launches=k1_n, k3_launches=k3_n,
                k2_launches=k2_n, plain_routes=routes,
                # 10 DDIM forwards and 2 MaskUNet forwards, 8 K1 and 1 K2
                # each (jax_parity_report's count)
                want_launches=[8 * (J.STEP_SAMPLING_TIMESTEPS + 2), 0,
                               J.STEP_SAMPLING_TIMESTEPS + 2])


def write_mask_pairs(root: Path, n_train: int, n_val: int, size: int,
                     seed: int) -> str:
    """A depth-correction pair root (``data/*.depth.png``,
    ``metadata/{train,val}.json``) of uint16 mm frames, each label the
    input plus a few mm of noise and large offsets on some pixels."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "data").mkdir(parents=True)
    (root / "metadata").mkdir()
    for subset, count in (("train", n_train), ("val", n_val)):
        entries = []
        for i in range(count):
            base = rng.integers(500, 9000, (size, size))
            label = base + rng.integers(0, 30, base.shape)
            off = rng.uniform(size=base.shape) < 0.3
            label[off] += rng.integers(60, 2000, int(off.sum()))
            names = (f"{subset}-{i:06d}-input.depth.png",
                     f"{subset}-{i:06d}-label.depth.png")
            for name, a in zip(names, (base, label)):
                Image.fromarray(a.astype(np.uint16)).save(root / "data" /
                                                          name)
            entries.append({"input_path": names[0], "label_path": names[1]})
        (root / "metadata" / f"{subset}.json").write_text(
            json.dumps(entries))
    return str(root)


def phase_import_path(torch, K1, K2, tmp: Path) -> dict:
    """The importer CLI on the card's machine: (1)
    :func:`import_step_report` at full width (``ModelConfig()``,
    ``MaskModelConfig()``); (2) the committed JAX ``.ckpt`` pair
    (``tests/data/torch_port_jax_*.ckpt``, dim 8): the imported nets'
    forwards on the card against the JAX forwards in ``FID_REFERENCE``,
    gated as ``jax_parity`` (``GATE_FACTOR`` x (CPU gap + the card's gap
    to the port on the CPU)); (3) ``train_depth_correction --resume`` from
    the imported MaskTrainer checkpoint: one optimizer step (4 train
    pairs at batch 4), its Adam count the JAX count + 1."""
    from pointreggpt_tpu_torch.cli import (import_torch_checkpoint,
                                           train_depth_correction)
    from pointreggpt_tpu_torch.train import checkpoint as ckpt
    from pointreggpt_tpu_torch.utils import jax_parity as J

    root = tmp / "import"
    t0 = time.perf_counter()
    step = import_step_report(torch, K1, K2, root)
    step_s = time.perf_counter() - t0
    if step["differ"]:
        raise AssertionError(f"import_path: the imported step differs in "
                             f"{step['differ']}")
    got_launches = [step["k1_launches"], step["k3_launches"],
                    step["k2_launches"]]
    if got_launches != step["want_launches"]:
        raise AssertionError(f"import_path: step launches K1, K3, K2 = "
                             f"{got_launches}, want {step['want_launches']}")
    check_no_routes("import_path", step["plain_routes"])

    data = REPO / "tests" / "data"
    out = root / "ckpt"
    import_torch_checkpoint.main([
        "--diffusion", str(data / "torch_port_jax_diffusion.ckpt"),
        "--depth_correction", str(data / "torch_port_jax_mask.ckpt"),
        "--milestone", "7", "--diffusion_out", str(out / "results"),
        "--dc_out", str(out / "dc"), *J.SMALL_FLAGS])
    pts = (out / "results" / "model-7.pt", out / "dc" / "model-7.pt")
    ref = np.load(FID_REFERENCE)
    card = J.import_forwards(*pts, "cuda")
    plain = J.import_forwards(*pts, "cpu")
    forwards = {}
    for k in ("diffusion_forward", "mask_forward"):
        gap = float(np.abs(card[k] - ref[k]).max())
        gate = GATE_FACTOR * (float(ref[f"cpu_gap_{k}"]) +
                              float(np.abs(card[k] - plain[k]).max()))
        forwards[k] = dict(card_gap=gap, gate=gate)
        if not gap <= gate:
            raise AssertionError(f"import_path: {k} {gap} from JAX's, over "
                                 f"the gate {gate}")

    jax_count = adam_count_of(ckpt.load_checkpoint(pts[1]))
    pairs = write_mask_pairs(root / "pairs", 4, 2, 64, 0)
    reset_counts(K1, K2)
    train_depth_correction.main([
        "--data", pairs, "--resume", "7", "--results_folder",
        str(out / "dc"), "--samples_folder", str(root / "dc_samples"),
        "--image_size", "64", "--epochs", "3", "--num_workers", "1",
        "--dim", "8", "--dim_mults", "1,1"])
    torch.cuda.synchronize()
    k1_n, k3_n, k2_n, routes = counts(K1, K2)
    check_no_routes("import_path resume", routes)
    resumed = ckpt.load_checkpoint(out / "dc" / "model-latest.pt")
    count = adam_count_of(resumed)
    if (jax_count, count, resumed["epoch"]) != (3, 4, 2):
        raise AssertionError(f"import_path: Adam count {jax_count} in the "
                             f"JAX checkpoint, {count} after the resumed "
                             f"step (epoch {resumed['epoch']}); want 3, 4, "
                             "epoch 2")
    launched = [a + b for a, b in zip(got_launches, (k1_n, k3_n, k2_n))]
    res = dict(step_s=step_s, step_differ=step["differ"],
               step_launches=got_launches,
               want_step_launches=step["want_launches"],
               forwards=forwards, jax_adam_count=jax_count,
               resumed_adam_count=count, resume_launches=[k1_n, k3_n, k2_n],
               k1_launches=launched[0], k3_launches=launched[1],
               k2_launches=launched[2])
    emit("import_path", card=card_line(), **res)
    return res


def adam_count_of(checkpoint: dict) -> int:
    """The Adam step of a port checkpoint's ``opt`` (all parameters
    together)."""
    steps = {int(s["step"]) for s in checkpoint["opt"]["state"].values()}
    if len(steps) != 1:
        raise AssertionError(f"Adam steps {steps}")
    return steps.pop()


def pair_differences(got, want, src, tgt, transform, radius) -> int:
    """How many (src_idx, tgt_idx) pairs one array has and the other not;
    raises unless every one lies within ``MIXTURE_EDGE`` of ``radius``
    (float64 distance after ``transform``)."""
    diff = set(map(tuple, got.tolist())) ^ set(map(tuple, want.tolist()))
    if not diff:
        if not np.array_equal(got, want):
            raise AssertionError("mixture_path: the same pairs in another "
                                 "order")
        return 0
    i, j = np.array(sorted(diff)).T
    s = np.asarray(src, np.float64)[i] @ np.asarray(
        transform, np.float64)[:3, :3].T + np.asarray(transform,
                                                      np.float64)[:3, 3]
    d = np.linalg.norm(s - np.asarray(tgt, np.float64)[j], axis=1)
    if not (np.abs(d - radius) < MIXTURE_EDGE).all():
        raise AssertionError(f"mixture_path: pairs {sorted(diff)[:5]} differ "
                             f"at distances {d[:5]} (radius {radius})")
    return len(diff)


def mixture_report(torch, root: Path, seed: int) -> dict:
    """Every item of ``MixtureDataset`` (Predator's defaults, max_points
    30000) and of ``MixturePairDataset`` (GeoTransformer's 3DMatch
    training settings: point_limit 30000, augmentation, matching radius
    0.05, the correspondences) over the generated tree ``root``, on the
    card and on the CPU from one seed: every field equal bit for bit, the
    correspondences equal but for pairs within ``MIXTURE_EDGE`` of the
    radius (counted); the items a second on the card."""
    from pointreggpt_tpu_torch.dataloaders import mixture

    def datasets(dev):
        return {
            "predator": mixture.MixtureDataset(
                {"src": [], "tgt": [], "rot": [], "trans": []},
                extra_root=str(root), max_points=30000, seed=seed,
                device=dev),
            "geotransformer": mixture.MixturePairDataset(
                str(root), point_limit=30000, use_augmentation=True,
                return_corr_indices=True, matching_radius=0.05, seed=seed,
                device=dev)}

    out = {}
    for name, ds in datasets("cuda").items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items = [ds[i] for i in range(len(ds))]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        plain = datasets("cpu")[name]
        edge, points, pairs = 0, [], []
        for i, got in enumerate(items):
            want = plain[i]
            if name == "predator":
                fields = [k for k in range(10) if k != 6]
                tsfm = np.eye(4)
                tsfm[:3, :3], tsfm[:3, 3] = got[4], got[5][:, 0]
                corr = (got[6], want[6], got[0], got[1], tsfm,
                        ds.overlap_radius)
                points.append([len(got[0]), len(got[1])])
            else:
                fields = [k for k in want if k != "corr_indices"]
                corr = (got["corr_indices"][:, ::-1],
                        want["corr_indices"][:, ::-1], got["src_points"],
                        got["ref_points"], got["transform"],
                        ds.matching_radius)
                points.append([len(got["ref_points"]),
                               len(got["src_points"])])
            for k in fields:
                g, w = got[k], want[k]
                if isinstance(w, np.ndarray):
                    same = g.dtype == w.dtype and np.array_equal(g, w)
                else:
                    same = g == w
                if not same:
                    raise AssertionError(f"mixture_path: {name} item {i} "
                                         f"field {k} differs from the CPU")
            edge += pair_differences(*corr)
            pairs.append(len(corr[0]))
        out[name] = dict(items=len(items), wall_s=wall,
                         items_per_s=len(items) / wall if wall else None,
                         points=points, correspondences=pairs,
                         edge_pairs=edge)
    return out


def phase_mixture_path(torch, seed: int, main_root: Path,
                       tmp: Path) -> dict:
    """The registration loaders on the card, after ``gt_path``: (1) over
    ``main_path``'s generated tree (12.5-15k-point clouds, the gt.log
    ``gt_path`` wrote), (2) over ``gt_path``'s synthetic pairs of known
    overlap (480x640 frames back-projected, capped at 30000 points):
    :func:`mixture_report` on each."""
    trees = {"generated": main_root / "generated_dataset",
             "synthetic": tmp / "gt_overlap" / "cuda"}
    res = {name: mixture_report(torch, root, seed)
           for name, root in trees.items()}
    if not res["generated"]["predator"]["items"]:
        raise AssertionError("mixture_path: gt_path's gt.log lists no pair")
    emit("mixture_path", card=card_line(), **res)
    return res


# ---------------------------------------------------------------------------
# dist_path and profile_path: more than one process (one card here)

DIST_LAUNCH_S = 600  # wall-clock limit of each launch of dist_path
DIST_TRAIN_BATCH = 8  # the global microbatch: 4 rows a process in (b)
DIST_TRAIN_STEPS = 2
# (b)'s averaged bf16 gradient against one process's on the same global
# batch: the U-Net's bf16 products of a microbatch of 4 and of 8 round
# apart (cuDNN may pick another algorithm by batch), ~1e-3 relative
DIST_GRAD_RTOL = 1e-2
DIST_MASK_RTOL = 1e-4  # fp32 MaskUNet, batch 2 per process against 4
DIST_METRIC_RTOL = 1e-6  # validation metrics, summed over the processes
DIST_FAULT_MARGIN = 10.0  # each planted fault misses its gate by this
DIST_MASK_PAIRS = (4, 5)  # train, val: one step of 4, val batches of 3
DIST_SCENES = 4  # generate_dataset -start 0 -stop 4, and the Tester's
DIST_SAMPLES = 2
# the Tester's images, fp32, two processes at 2 against one at 4: the
# largest mean |difference| of an image. The batch-composition gap (the
# same blocks of 2 run in one process against a batch of 4) measured
# 2.76e-3 on an H100 80GB HBM3, 700 W (this script's dist_path): rounding
# that moves a reprojected point across a pixel edge flips that pixel's
# DDNM condition, and the pixel then differs by the whole depth range, so
# the largest difference is no gate (1.0 seen). A swapped slice: 0.46
TESTER_MEAN_GATE = 1e-2
PNG_LEVEL = 1.0 / 255  # one level of the 8-bit PNGs the Tester writes


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms and no TF32 for the block: (a)
    compares parameters bit for bit across two processes."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _port_kernels():
    from pointreggpt_tpu_torch.ops import attention as K2
    from pointreggpt_tpu_torch.ops import linear_attention as K1
    return K1, K2


def _counted(K1, K2, fn):
    """``fn()``'s result and the K1, K3, K2 launches and plain routes it
    made."""
    reset_counts(K1, K2)
    out = fn()
    k1_n, k3_n, k2_n, routes = counts(K1, K2)
    return out, dict(k1=k1_n, k3=k3_n, k2=k2_n, plain_routes=routes)


def _rel_to(torch, got, ref_path) -> float:
    """|got - ref| / |ref| in fp64, ``ref`` a saved flat gradient."""
    ref = torch.load(ref_path).to(got.device, torch.float64)
    return (torch.linalg.vector_norm(got.double() - ref) /
            torch.linalg.vector_norm(ref)).item()


def dist_trainer_part(root: str, results: str, ref: str = None) -> dict:
    """``DIST_TRAIN_STEPS`` Trainer steps at ``ModelConfig()`` width on the
    global microbatch, in this process's group (or none): the parameter
    and EMA digest after each step, each step's and each all-reduce's
    device time, launches; the gradient step 1 hands the clip is saved to
    ``ref`` (the one-process run) or held against it, with the
    process's own gradient before the all-reduce (rank 1 given rank 0's
    rows would average to rank 0's alone)."""
    import torch

    from pointreggpt_tpu_torch.parallel import mesh as M
    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR
    from pointreggpt_tpu_torch.train import trainer as T

    K1, K2 = _port_kernels()
    grads, digests, step_ev, reduce_ev = {}, [], [], []
    clip, reduce = T.clip_by_global_norm_, M.all_reduce_mean_

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def spy_clip(gs, max_norm):
        grads.setdefault("averaged",
                         torch.cat([g.reshape(-1) for g in gs]).clone())
        return clip(gs, max_norm)

    def spy_reduce(tensors):
        tensors = list(tensors)
        grads.setdefault("local", torch.cat(
            [t.reshape(-1) for t in tensors[:-1]]).clone())
        ev = events()
        ev[0].record()
        reduce(tensors)
        ev[1].record()
        reduce_ev.append(ev)

    T.clip_by_global_norm_, M.all_reduce_mean_ = spy_clip, spy_reduce
    try:
        with deterministic_cudnn(torch):
            tr = DR.build_trainer(str(Path(root) / "rgbd"),
                                  str(Path(root) / "gt.log"), results,
                                  full_width=True,
                                  global_batch=DIST_TRAIN_BATCH,
                                  steps=DIST_TRAIN_STEPS)
            step = tr.train_step

            def recorded(*a):
                ev = events()
                ev[0].record()
                loss = step(*a)
                ev[1].record()
                step_ev.append(ev)
                digests.append(DR.digest(tr.ema))
                return loss

            tr.train_step = recorded
            _, launched = _counted(K1, K2, lambda: tr.train(log_every=1))
            torch.cuda.synchronize()
    finally:
        T.clip_by_global_norm_, M.all_reduce_mean_ = clip, reduce
    out = dict(digests=digests, launched=launched,
               rows=list(tr.rows),
               step_ms=[a.elapsed_time(b) for a, b in step_ev],
               all_reduce_ms=[a.elapsed_time(b) for a, b in reduce_ev],
               grad_sha=hashlib.sha256(grads["averaged"].cpu().numpy()
                                          .tobytes()).hexdigest())
    if ref is not None and not Path(ref).exists():
        torch.save(grads["averaged"].cpu(), ref)
    elif ref is not None:
        out.update(grad_rel=_rel_to(torch, grads["averaged"], ref),
                   rows_swapped_rel=_rel_to(torch, grads["local"], ref),
                   no_division_rel=_rel_to(
                       torch, grads["averaged"] * M.process_count(), ref))
    del tr
    torch.cuda.empty_cache()
    return out


def dist_mask_part(folder: str, results: str, rank_batch: int,
                   ref: str) -> dict:
    """The MaskTrainer at ``MaskModelConfig`` width, fp32, 256^2: the
    validation metrics of the initial weights, then one epoch (one step of
    the batch, validation, checkpoints); the gradient step 1 hands the
    clip saved to ``ref`` or held against it."""
    import torch

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.train import mask_trainer as MT

    K1, K2 = _port_kernels()
    grads = {}
    clip = MT.clip_by_global_norm_

    def spy_clip(gs, max_norm):
        grads.setdefault("averaged",
                         torch.cat([g.reshape(-1) for g in gs]).clone())
        return clip(gs, max_norm)

    MT.clip_by_global_norm_ = spy_clip
    try:
        with deterministic_cudnn(torch):
            torch.manual_seed(0)
            tr = MT.MaskTrainer(
                C.build_mask_unet(C.MaskModelConfig()), folder,
                image_size=256, train_batch_size=rank_batch, train_lr=4e-5,
                epochs=1, results_folder=results, samples_folder=results,
                num_workers=2, val_batch_size=3)
            tr.eval_one_epoch()
            metrics = {k: float(v) for k, v in tr.metrics["current"].items()}
            _, launched = _counted(K1, K2, tr.train_and_eval)
    finally:
        MT.clip_by_global_norm_ = clip
    out = dict(batch=tr.batch_size, metrics=metrics, launched=launched,
               losses=tr.loss_hist,
               wrote=sorted(p.name for p in Path(results).glob("*.pt")))
    if Path(ref).exists():
        out["grad_rel"] = _rel_to(torch, grads["averaged"], ref)
    else:
        torch.save(grads["averaged"].cpu(), ref)
    del tr
    torch.cuda.empty_cache()
    return out


def dist_generate_part(root: str, argv: list) -> dict:
    """``generate_dataset.main(argv)`` from ``root``: the chunks of scenes
    this process set up, and its launches."""
    import torch

    from pointreggpt_tpu_torch.cli import generate_dataset
    from pointreggpt_tpu_torch.generate import generator as G

    K1, K2 = _port_kernels()
    chunks, setup = [], G.Generator._setup_chunk

    def spy(self, chunk, *a):
        chunks.append(list(chunk))
        return setup(self, chunk, *a)

    cwd = os.getcwd()
    G.Generator._setup_chunk = spy
    os.chdir(root)
    try:
        _, launched = _counted(K1, K2, lambda: generate_dataset.main(argv))
    finally:
        G.Generator._setup_chunk = setup
        os.chdir(cwd)
    torch.cuda.empty_cache()
    return dict(chunks=chunks, launched=launched)


def dist_tester_part(argv: list) -> dict:
    """The Tester's entry point: each triptych's new image by file name,
    the overviews this process wrote, its launches."""
    from pointreggpt_tpu_torch.cli import test_successive_ddnm_diffusion
    from pointreggpt_tpu_torch.generate import tester as TS

    K1, K2 = _port_kernels()
    images, overviews = {}, []
    triptych, imsave = TS.save_triptych, TS._imsave

    def spy_triptych(path, prev, rpj, new, cmap="gray"):
        images[Path(path).name] = np.array(new)
        return triptych(path, prev, rpj, new, cmap)

    def spy_imsave(path, vis, cmap):
        if Path(path).name == "overview.png":
            overviews.append(list(vis.shape))
        return imsave(path, vis, cmap)

    TS.save_triptych, TS._imsave = spy_triptych, spy_imsave
    try:
        _, launched = _counted(
            K1, K2, lambda: test_successive_ddnm_diffusion.main(argv))
    finally:
        TS.save_triptych, TS._imsave = triptych, imsave
    return dict(images=images, overviews=overviews, launched=launched)


def dist_ws1_rank(root: str) -> dict:
    """(a): the Trainer in a process group of one (NCCL)."""
    import torch.distributed as dist

    out = dist_trainer_part(root, str(Path(root) / "results-ws1"))
    out["backend"] = str(dist.get_backend())
    return out


def dist_rank(paths: dict) -> dict:
    """(b): one of two processes sharing the card over gloo: the Trainer,
    the MaskTrainer, generate_dataset and the Tester in turn."""
    import torch.distributed as dist

    from pointreggpt_tpu_torch.parallel import mesh as M

    rank = M.process_index()
    out = dict(rank=rank, backend=str(dist.get_backend()), part_s={})
    parts = dict(
        trainer=lambda: dist_trainer_part(
            paths["train"], str(Path(paths["train"]) / f"results-{rank}"),
            paths["train_ref"]),
        mask=lambda: dist_mask_part(
            paths["pairs"],
            str(Path(paths["pairs"]).parent / f"mask-{rank}"),
            paths["mask_rank_batch"], paths["mask_ref"]),
        generate=lambda: dist_generate_part(paths["gen_root"],
                                            paths["gen_argv"]),
        tester=lambda: dist_tester_part(paths["tester_argv"]))
    for name, part in parts.items():
        t0 = time.perf_counter()
        out[name] = part()
        out["part_s"][name] = time.perf_counter() - t0
    return out


def _image_gap(got: dict, want: dict, pairs) -> dict:
    """Over image pairs: the largest mean |difference| of a pair, the
    largest |difference|, and the largest share of a pair's pixels more
    than one PNG level apart."""
    diffs = [np.abs(got[a] - want[b]) for a, b in pairs]
    return dict(mean_abs=max(float(d.mean()) for d in diffs),
                max_abs=max(float(d.max()) for d in diffs),
                share_past_level=max(float((d > PNG_LEVEL).mean())
                                     for d in diffs))


def phase_dist_path(torch, K1, K2, seed: int, tmp: Path) -> dict:
    """Data parallelism through the port's entry points, on the one card:
    (a) the Trainer in a process group of one over NCCL, bit for bit
    against the same run with no group, and the all-reduce's time; (b)
    two processes sharing ``cuda:0`` over gloo (NCCL takes one process
    per card): ``tools/dryrun_multiprocess`` at full width, then the
    Trainer (replicas bit-identical after each step, the averaged
    gradient against one process's on the same global batch, two planted
    faults), the MaskTrainer (gradient, validation metrics, rank 0's
    checkpoints), ``generate_dataset -start 0 -stop 4`` (the scenes by
    stride, rank 0's files bit for bit those of one process given [0, 2],
    rank 1's own poses) and the Tester's entry point (each scene against
    one process, a planted slice swap, one overview); K1, K3 and K2 on
    every process with no plain route. Two processes on one card check
    correctness, not scaling: their times are a record only."""
    from pointreggpt_tpu_torch.cli import generate_dataset
    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR

    root = tmp / "dist"
    train_root = root / "train"
    train_root.mkdir(parents=True)
    DR.write_depth_tree(train_root, n_frames=2 * DIST_TRAIN_BATCH)
    pairs = write_mask_pairs(root / "pairs", *DIST_MASK_PAIRS, 256, seed)
    gen_root, ref_root = root / "gen", root / "gen_ref"
    gen_root.mkdir()
    rgbd, indoor, info = write_synthetic_tree(gen_root, DIST_SCENES, seed)
    write_checkpoints(torch, gen_root, seed)
    ref_root.mkdir()
    for d in ("results", "depth_correction_results"):
        (ref_root / d).symlink_to(gen_root / d)
    gen_argv = ["--resume", "1", "--data", str(rgbd), "--train_info_path",
                str(info), "--data_root", str(indoor), "--results_folder",
                str(gen_root / "results"), "-start", "0", "-stop",
                str(DIST_SCENES), "--num_samples", str(DIST_SAMPLES),
                "--seed", str(seed)]
    # the Tester in fp32: with seeded (untrained) weights the bf16 chain
    # turns the rounding of a batch of 2 against one of 4 into other
    # images (mean gap 0.30 on the card), where fp32 keeps it small
    tester_argv = ["--resume", "1", "--results_folder",
                   str(gen_root / "results"), "--num_scenes",
                   str(DIST_SCENES), "--num_samples", str(DIST_SAMPLES),
                   "--bf16", "false"]
    paths = dict(train=str(train_root),
                 train_ref=str(root / "train_g1.pt"), pairs=pairs,
                 mask_rank_batch=2, mask_ref=str(root / "mask_g1.pt"),
                 gen_root=str(gen_root), gen_argv=gen_argv,
                 tester_argv=tester_argv + [
                     "--batch_size", "2", "--samples_folder",
                     str(root / "tester_dist")])

    # the one-process runs: no group, this process
    one_s = {}
    t0 = time.perf_counter()
    one_train = dist_trainer_part(paths["train"],
                                  str(train_root / "results-one"),
                                  paths["train_ref"])
    one_s["trainer"] = time.perf_counter() - t0
    one_mask = dist_mask_part(pairs, str(root / "mask-one"), 4,
                              paths["mask_ref"])
    one_s["mask"] = time.perf_counter() - t0 - sum(one_s.values())
    cwd = os.getcwd()
    os.chdir(ref_root)  # the entry point's folders are relative
    try:
        gen, cfg = generate_dataset.build_generator(
            generate_dataset.build_parser().parse_args(gen_argv))
        gen.load(1)
        _, one_gen = _counted(K1, K2, lambda: gen.generate(
            0, DIST_SCENES, cfg.num_samples,
            memory_voxel_size=cfg.memory_voxel_size,
            save_voxel_size=cfg.save_voxel_size,
            has_refine_step=cfg.has_refine_step, scene_indices=[0, 2],
            verbose=False))
    finally:
        os.chdir(cwd)
    del gen
    one_s["generate"] = time.perf_counter() - t0 - sum(one_s.values())
    one_tester = dist_tester_part(tester_argv + [
        "--batch_size", "4", "--samples_folder", str(root / "tester_one")])
    names = sorted(one_tester["images"])
    one_s["tester"] = time.perf_counter() - t0 - sum(one_s.values())

    # (a): one process in a group of one, NCCL
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (ws1,) = DR.launch(dist_ws1_rank, 1, args=(str(train_root),),
                       timeout_s=DIST_LAUNCH_S, threads=None)
    ws1_s = time.perf_counter() - t0
    if ws1["digests"] != one_train["digests"]:
        raise AssertionError("dist_path (a): the Trainer in a group of one "
                             "differs from the run with no group: "
                             f"{ws1['digests']} != {one_train['digests']}")
    if ws1["grad_sha"] != one_train["grad_sha"]:
        raise AssertionError("dist_path (a): step 1's gradient differs")

    # (b): two processes on cuda:0 over gloo
    t0 = time.perf_counter()
    dry = DR.dryrun(2, full_width=True, local_ranks=[0, 0], backend="gloo",
                    timeout_s=DIST_LAUNCH_S)
    dry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # a rank may run a part ahead of the other by tens of seconds before
    # their next collective: a longer collective timeout than the default
    ranks = DR.launch(dist_rank, 2, args=(paths,), local_ranks=[0, 0],
                      backend="gloo", timeout_s=DIST_LAUNCH_S,
                      collective_timeout_s=DIST_LAUNCH_S / 2, threads=4)
    ranks_s = time.perf_counter() - t0
    if [r["backend"] for r in ranks] != ["gloo", "gloo"]:
        raise AssertionError(f"dist_path (b): backends {ranks}")

    tr = [r["trainer"] for r in ranks]
    if tr[0]["digests"] != tr[1]["digests"] or \
            len(tr[0]["digests"]) != DIST_TRAIN_STEPS:
        raise AssertionError("dist_path (b): the Trainer's replicas differ")
    if tr[0]["grad_sha"] != tr[1]["grad_sha"]:
        raise AssertionError("dist_path (b): the averaged gradients differ")
    if tr[0]["grad_rel"] > DIST_GRAD_RTOL:
        raise AssertionError(f"dist_path (b): gradient {tr[0]['grad_rel']} "
                             f"from one process's, gate {DIST_GRAD_RTOL}")
    # planted faults: the division by the process count skipped must miss
    # the gate tenfold; rank 1 given rank 0's rows must miss it too (a
    # half batch's gradient is near the whole batch's: 6.5% apart in the
    # CPU rehearsal at dim 8)
    faults = dict(no_division=tr[0]["no_division_rel"],
                  rows_swapped=tr[0]["rows_swapped_rel"])
    if faults["no_division"] < DIST_FAULT_MARGIN * DIST_GRAD_RTOL or \
            faults["rows_swapped"] <= DIST_GRAD_RTOL:
        raise AssertionError(f"dist_path (b): planted faults {faults}, gate "
                             f"{DIST_GRAD_RTOL}")

    mk = [r["mask"] for r in ranks]
    for m in mk:
        if m["batch"] != one_mask["batch"] or \
                m["grad_rel"] > DIST_MASK_RTOL:
            raise AssertionError(f"dist_path (b): MaskTrainer batch "
                                 f"{m['batch']}, gradient {m['grad_rel']}")
        for k, v in one_mask["metrics"].items():
            if abs(m["metrics"][k] - v) > DIST_METRIC_RTOL * max(abs(v),
                                                                1e-30):
                raise AssertionError(f"dist_path (b): metric {k} "
                                     f"{m['metrics'][k]} != {v}")
    if [m["wrote"] for m in mk] != [["model-best.pt", "model-latest.pt"],
                                    []]:
        raise AssertionError(f"dist_path (b): MaskTrainer checkpoints by "
                             f"rank {[m['wrote'] for m in mk]}")

    gn = [r["generate"] for r in ranks]
    if [g["chunks"] for g in gn] != [[[0, 2]], [[1, 3]]]:
        raise AssertionError(f"dist_path (b): scene chunks "
                             f"{[g['chunks'] for g in gn]}")
    out = gen_root / "generated_dataset" / "data"
    scenes = sorted(p.name for p in out.iterdir())
    if scenes != [f"scene-{s:06d}" for s in range(DIST_SCENES)]:
        raise AssertionError(f"dist_path (b): scenes written {scenes}")
    ref = ref_root / "generated_dataset" / "data"
    for s in (0, 2):
        name = f"scene-{s:06d}"
        got = {p.relative_to(out / name): p.read_bytes()
               for p in sorted((out / name).rglob("*")) if p.is_file()}
        want = {p.relative_to(ref / name): p.read_bytes()
                for p in sorted((ref / name).rglob("*")) if p.is_file()}
        if got != want:
            raise AssertionError(f"dist_path (b): rank 0's {name} differs "
                                 "from one process's")
    poses = [np.loadtxt(out / f"scene-{s:06d}" / "sample-000001.pose.txt")
             for s in (0, 1)]
    if np.allclose(*poses):
        raise AssertionError("dist_path (b): rank 1 drew rank 0's poses")

    ts = [r["tester"] for r in ranks]
    got = {**ts[0]["images"], **ts[1]["images"]}
    if sorted(got) != names:
        raise AssertionError(f"dist_path (b): Tester files {sorted(got)}")
    tester = dict(gap=_image_gap(got, one_tester["images"],
                                 [(n, n) for n in names]),
                  gate=TESTER_MEAN_GATE,
                  swapped=_image_gap(got, one_tester["images"], [
                      (f"scene-{s - 2}-sample-{k}.png",
                       f"scene-{s}-sample-{k}.png")
                      for s in (2, 3) for k in range(DIST_SAMPLES)]))
    tester_ok = (tester["gap"]["mean_abs"] <= TESTER_MEAN_GATE and
                 tester["swapped"]["mean_abs"] >=
                 DIST_FAULT_MARGIN * TESTER_MEAN_GATE)
    if [len(t["overviews"]) for t in ts] != [1, 0] or \
            ts[0]["overviews"] != one_tester["overviews"]:
        raise AssertionError(f"dist_path (b): overviews "
                             f"{[t['overviews'] for t in ts]}")

    # launches: each process runs the kernels; no plain route anywhere
    parts = dict(trainer=one_train["launched"], mask=one_mask["launched"],
                 generate=one_gen, tester=one_tester["launched"])
    launches = {}
    for part, one in parts.items():
        per_rank = [r[part]["launched"] for r in ranks]
        for c in per_rank + [one]:
            check_no_routes(f"dist_path {part}", c["plain_routes"])
        if min(c[k] for c in per_rank for k in ("k1", "k2")) == 0:
            raise AssertionError(f"dist_path {part}: a process launched no "
                                 f"K1 or K2 {per_rank}")
        if part in ("trainer", "generate", "tester") and \
                any({k: c[k] for k in ("k1", "k3", "k2")} !=
                    {k: one[k] for k in ("k1", "k3", "k2")}
                    for c in per_rank):
            # each process does one process's work on its share
            raise AssertionError(f"dist_path {part}: launches {per_rank}, "
                                 f"one process {one}")
        if part == "mask" and any(c["k3"] != one["k3"] for c in per_rank):
            raise AssertionError(f"dist_path mask: K3 {per_rank} {one}")
        launches[part] = dict(
            ranks=[{k: c[k] for k in ("k1", "k3", "k2")} for c in per_rank],
            one_process={k: one[k] for k in ("k1", "k3", "k2")})
    ws1_l = ws1["launched"]
    res = dict(
        card=card_line(),
        a=dict(backend=ws1["backend"], bit_identical=True,
               all_reduce_ms=ws1["all_reduce_ms"],
               step_ms=ws1["step_ms"], no_group_step_ms=one_train["step_ms"],
               launched={k: ws1_l[k] for k in ("k1", "k3", "k2")},
               wall_s=ws1_s),
        b=dict(backend="gloo, both processes on cuda:0", dryrun=dry,
               dryrun_s=dry_s, wall_s=ranks_s,
               rank_part_s=[r["part_s"] for r in ranks],
               trainer=dict(grad_rel=tr[0]["grad_rel"],
                            gate=DIST_GRAD_RTOL, faults=faults,
                            step_ms=[t["step_ms"] for t in tr],
                            all_reduce_ms=[t["all_reduce_ms"] for t in tr],
                            one_process_step_ms=one_train["step_ms"]),
               mask=dict(grad_rel=[m["grad_rel"] for m in mk],
                         gate=DIST_MASK_RTOL, metrics=mk[0]["metrics"],
                         one_process_metrics=one_mask["metrics"],
                         losses=[m["losses"] for m in mk],
                         one_process_losses=one_mask["losses"]),
               generate=dict(chunks=[g["chunks"] for g in gn],
                             scenes=scenes, rank0_bit_equal=True),
               tester=tester,
               launches=launches),
        one_process_s=one_s)
    emit("dist_path", **res)
    if not tester_ok:
        raise AssertionError(f"dist_path (b): Tester {tester}")
    totals = {k: sum(r[p]["launched"][k] for r in ranks for p in parts) +
              ws1_l[k] for k in ("k1", "k3", "k2")}
    return dict(k1_launches=totals["k1"], k3_launches=totals["k3"],
                k2_launches=totals["k2"])


PROFILE_DDIM_STEPS = 25  # profile_path's chain: the stages, not its depth


def phase_profile_path(torch, tmp: Path, fwd_bwd: dict) -> dict:
    """``PRGPT_PROFILE`` on the card: the Trainer (``ModelConfig()``
    width, microbatch 8) for 6 steps and ``Generator.generate`` (the
    production widths, 2 scenes, a 25-step chain) for 3 sample steps, each
    with the
    JAX stage names and a Chrome trace holding device kernels; then one
    MaskTrainer step (``MaskModelConfig``, batch 4, 256^2) under
    ``profiling.trace``, its device time by kernel category and largest
    kernels beside ``mask_fwd_bwd``'s bare forward + backward."""
    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.cli import generate_dataset
    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR
    from pointreggpt_tpu_torch.train import mask_trainer as MT
    from pointreggpt_tpu_torch.utils import profiling

    root = tmp / "profile"
    made = []
    loop_profile = profiling.loop_profile

    def spy(*a):
        made.append(loop_profile(*a))
        return made[-1]

    def trace_kernels(folder: Path) -> int:
        files = sorted(folder.rglob("*.pt.trace.json"))
        if not files:
            raise AssertionError(f"profile_path: no trace under {folder}")
        events = json.loads(files[0].read_text())["traceEvents"]
        return sum(1 for e in events if e.get("cat") == "kernel")

    res = {}
    profiling.loop_profile = spy
    try:
        os.environ["PRGPT_PROFILE"] = str(root / "train")
        tr = DR.build_trainer(str(tmp / "dist" / "train" / "rgbd"),
                              str(tmp / "dist" / "train" / "gt.log"),
                              str(root / "train_results"), full_width=True,
                              global_batch=DIST_TRAIN_BATCH, steps=6)
        tr.save_and_sample_every, tr.sample_on_save = 6, False
        t0 = time.perf_counter()
        tr.train(log_every=1)
        res["train"] = dict(wall_s=time.perf_counter() - t0,
                            stages_s=made[-1].timer.totals(),
                            trace_kernels=trace_kernels(root / "train"))
        del tr
        os.environ["PRGPT_PROFILE"] = str(root / "generate")
        gen_root = tmp / "dist" / "gen"
        argv = ["--resume", "1", "--data", str(gen_root / "rgbd"),
                "--train_info_path", str(gen_root / "train_info.pkl"),
                "--data_root", str(gen_root / "indoor"), "--results_folder",
                str(gen_root / "results"), "--batch_size", "2",
                "--num_samples", "3", "--dataset_name", "profiled",
                "--sampling_timesteps", str(PROFILE_DDIM_STEPS)]
        cwd = os.getcwd()
        os.chdir(gen_root)  # the entry point's folders are relative
        try:
            gen, cfg = generate_dataset.build_generator(
                generate_dataset.build_parser().parse_args(argv))
            gen.load(1)
            t0 = time.perf_counter()
            gen.generate(0, 2, 3, memory_voxel_size=cfg.memory_voxel_size,
                         save_voxel_size=cfg.save_voxel_size,
                         has_refine_step=cfg.has_refine_step, verbose=False)
        finally:
            os.chdir(cwd)
        res["generate"] = dict(wall_s=time.perf_counter() - t0,
                               stages_s=made[-1].timer.totals(),
                               trace_kernels=trace_kernels(
                                   root / "generate"))
        del gen
    finally:
        profiling.loop_profile = loop_profile
        os.environ.pop("PRGPT_PROFILE", None)
    want = {"train": {"load_batch", "dispatch", "loss_sync",
                      "save_and_sample"},
            "generate": {"scene_setup", "dispatch", "host_write"}}
    for loop, names in want.items():
        if set(res[loop]["stages_s"]) != names or \
                res[loop]["trace_kernels"] == 0:
            raise AssertionError(f"profile_path {loop}: stages "
                                 f"{sorted(res[loop]['stages_s'])}, "
                                 f"{res[loop]['trace_kernels']} kernels")

    torch.manual_seed(0)
    mt = MT.MaskTrainer(C.build_mask_unet(C.MaskModelConfig()),
                        str(tmp / "dist" / "pairs"), image_size=256,
                        train_batch_size=MASK_BATCH, train_lr=4e-5,
                        epochs=1, results_folder=str(root / "mask"),
                        samples_folder=str(root / "mask"), num_workers=2)
    batch = next(iter(mt._loader(0)))
    x, m = MT._to_device(batch, ("input_img", "mask"), mt.device)
    for _ in range(2):  # warm-up: cuDNN's workspaces and the allocator
        mt.train_step(x, m)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profiling.trace(str(root / "mask_step")) as prof:
        e0.record()
        mt.train_step(x, m)
        e1.record()
        torch.cuda.synchronize()
    res["mask_step"] = dict(step_ms=e0.elapsed_time(e1),
                            **device_time(torch, prof))
    res["mask_fwd_bwd"] = dict(step_ms=fwd_bwd["step_ms"],
                               **fwd_bwd["fwd_bwd"])
    emit("profile_path", card=card_line(), **res)
    del mt, x, m, prof
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# surface_path: the rest of the JAX package's surface

SURFACE_REFERENCE = REPO / "tests" / "data" / "torch_port_jax_surface.npz"
SURFACE_BATCH = 2
SURFACE_INTERP_T = 999  # interpolate from the top of the chain
SURFACE_FRAMES = 48  # PNGs decoded per route for the frame rate


def surface_parity_report(torch, K1, K2, cases=None) -> dict:
    """The port's outputs of ``jax_surface``'s cases on the card (the bf16
    denoise chain, the fp32 interpolation, the fp32 Fourier /
    learned-variance forward, ``image_condition``) against the JAX
    package's (``SURFACE_REFERENCE``), gated as ``jax_parity`` gates
    (``GATE_FACTOR`` x (CPU gap + the kernels' gap to their plain
    versions on the card); the condition's share of differing pixels at
    ``KEEP_SHARE``), the launches of the counted run, and a planted fault:
    the interpolation's weights swapped (lambda -> 1 - lambda)."""
    from pointreggpt_tpu_torch.utils import jax_surface as JS

    cases = JS.CASES if cases is None else cases
    ref = dict(np.load(SURFACE_REFERENCE))
    nets = JS.nets()
    reset_counts(K1, K2)
    t0 = time.perf_counter()
    card = JS.run_port("cuda", ref, cases=cases, nets_=nets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1_n, k3_n, k2_n, routes = counts(K1, K2)
    with plain_attention(K1, K2):
        plain = JS.run_port("cuda", ref, cases=cases, nets_=nets)
    card_gap, kernel_gap = JS.gaps(card, ref), JS.gaps(card, plain)
    cpu_gap = {k: float(ref[f"cpu_gap_{k}"]) for k in card_gap}
    gate = {k: GATE_FACTOR * (cpu_gap[k] + kernel_gap[k])
            for k in card_gap}
    if "condition" in gate:
        gate["condition"] = KEEP_SHARE
    fault = None
    if "interpolate" in cases:
        fault = JS.gaps(JS.run_port("cuda", ref, cases=("interpolate",),
                                    nets_=nets, lam=1 - JS.INTERP_LAM),
                        ref)["interpolate"]
    forwards = {"condition": 0, "denoise": JS.DENOISE_STEPS,
                "interpolate": JS.INTERP_T, "fourier": 1}
    n_fwd = sum(forwards[c] for c in cases)
    return dict(cases=list(cases), seconds=seconds, card_gap=card_gap,
                cpu_gap=cpu_gap, kernel_gap=kernel_gap,
                plain_gap=JS.gaps(plain, ref), gate=gate,
                failed={k: v for k, v in card_gap.items()
                        if not v <= gate[k]},
                fault_gap=fault,
                fault_over_gate=(fault / gate["interpolate"]
                                 if fault is not None else None),
                launches={"k1": k1_n, "k3": k3_n, "k2": k2_n},
                want_launches={"k1": 8 * n_fwd, "k3": 0, "k2": n_fwd},
                plain_routes=routes)


def surface_chains(torch, K1, K2, seed: int) -> dict:
    """(a) ``denoise`` at the production configuration (250 DDIM steps,
    eta 1, DDNM on; the bf16 DiffusionUNet of seeded weights) at batch 2
    on the condition ``image_condition`` makes of a synthetic depth under
    two ``random_sample_pose`` motions: every masked pixel equals the
    condition; (b) ``interpolate`` of its two outputs from t = 999. Each
    with its seconds and its launches, counted from 0 just before."""
    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.core import geometry as G
    from pointreggpt_tpu_torch.core import sampling as S
    from pointreggpt_tpu_torch.generate.generator import place_for_inference
    from pointreggpt_tpu_torch.utils import jax_parity as J
    from pointreggpt_tpu_torch.utils import jax_surface as JS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = JS.inputs(seed)
    intr = torch.from_numpy(J._intrinsics(SURFACE_BATCH)).to(dev)
    pose = S.random_sample_pose(gen, SURFACE_BATCH, device=dev)
    cond = G.image_condition(torch.from_numpy(x["depth01"]).to(dev), intr,
                             pose)
    pc = G.param_vector(intr)
    net = place_for_inference(J.nets(seed)[0], dev)
    diffusion = C.build_diffusion(C.DiffusionConfig(ddim_sampling_eta=1.0),
                                  net)
    res = {}
    reset_counts(K1, K2)
    t0 = time.perf_counter()
    out = diffusion.denoise(net, param_cond=pc, img_cond=cond,
                            generator=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1_n, k3_n, k2_n, routes = counts(K1, K2)
    mask = G.mask_from_image_condition(cond)
    pinned = G.unnormalize_to_zero_to_one(cond[..., 0])
    res["denoise"] = dict(
        seconds=seconds, steps=diffusion.sampling_timesteps,
        launches=[k1_n, k3_n, k2_n], plain_routes=routes,
        want_launches=[8 * diffusion.sampling_timesteps, 0,
                       diffusion.sampling_timesteps],
        finite=bool(torch.isfinite(out).all()),
        shape=list(out.shape), mask_share=float(mask.float().mean()),
        masked_unequal=int((out[..., 0][mask] != pinned[mask]).sum()))
    x0 = G.normalize_to_neg_one_to_one(out)
    reset_counts(K1, K2)
    t0 = time.perf_counter()
    mid = diffusion.interpolate(net, x0, x0.flip(0), pc,
                                t=SURFACE_INTERP_T, generator=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1_n, k3_n, k2_n, routes = counts(K1, K2)
    res["interpolate"] = dict(
        seconds=seconds, t=SURFACE_INTERP_T, launches=[k1_n, k3_n, k2_n],
        plain_routes=routes,
        want_launches=[8 * SURFACE_INTERP_T, 0, SURFACE_INTERP_T],
        finite=bool(torch.isfinite(mid).all()), shape=list(mid.shape))
    return res


SURFACE_GRAD_OPTIONS = {
    "learned": dict(learned_sinusoidal_cond=True, learned_variance=True),
    "frozen": dict(random_fourier_features=True, learned_variance=True)}


def surface_fourier_grads(torch, K1, K2) -> dict:
    """(g) The gradients of a dim-64 fp32 DiffusionUNet with the Fourier
    time embedding (learned and frozen frequencies) and the
    learned-variance head, at 64^2, batch 2, of a fixed weighted sum of
    its two output channels: on the card (K1, K3, K2) against the CPU
    (plain versions), per parameter within ``GRAD_RTOL``; the frozen
    frequencies get no gradient on either side, the learned ones one.
    The launches are those of the card's forwards and backwards."""
    import copy

    from pointreggpt_tpu_torch.models import DiffusionUNet

    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=(2, 1, 64, 64)), dtype=torch.float32)
    t = torch.tensor([40.0, 730.0])
    pc = torch.tensor(rng.uniform(100, 600, (2, 4)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(2, 2, 64, 64)), dtype=torch.float32)
    dev = torch.device("cuda")
    res, launched = {}, [0, 0, 0]
    for name, kw in SURFACE_GRAD_OPTIONS.items():
        torch.manual_seed(0)
        net = DiffusionUNet(dim=64, **kw).to(
            memory_format=torch.channels_last)
        let_cores_count(torch, net, x, t, pc)
        gpu_net = copy.deepcopy(net).to(dev,
                                        memory_format=torch.channels_last)
        (net(x, t, pc) * w).sum().backward()
        reset_counts(K1, K2)
        (gpu_net(x.to(dev), t.to(dev), pc.to(dev)) * w.to(dev)).sum() \
            .backward()
        torch.cuda.synchronize()
        k1_n, k3_n, k2_n, routes = counts(K1, K2)
        check_no_routes(f"surface_path grads {name}", routes)
        launched = [a + b for a, b in zip(launched, (k1_n, k3_n, k2_n))]
        worst, worst_name = 0.0, ""
        for (pname, p), q in zip(net.named_parameters(),
                                 gpu_net.parameters()):
            if not p.requires_grad:
                if p.grad is not None or q.grad is not None:
                    raise AssertionError(f"surface_path: frozen {pname} "
                                         "has a gradient")
                continue
            err = ((q.grad.cpu() - p.grad).abs().max() /
                   p.grad.abs().max().clamp_min(1e-30)).item()
            if not np.isfinite(err):
                raise AssertionError(f"surface_path: gradient of {pname} "
                                     "not finite")
            if err > worst:
                worst, worst_name = err, pname
        weights = net.time_mlp[0].weights
        res[name] = dict(max_rel_err=worst, worst=worst_name,
                         frequencies_grad=(None if weights.grad is None else
                                           weights.grad.abs().max().item()),
                         launches=[k1_n, k3_n, k2_n])
    return dict(res, rtol=GRAD_RTOL, launches=launched,
                want_launches=[8 * len(SURFACE_GRAD_OPTIONS),
                               8 * len(SURFACE_GRAD_OPTIONS),
                               len(SURFACE_GRAD_OPTIONS)],
                plain_routes={"k1": 0, "k3": 0})


def surface_ckpt_report(torch, K1, K2, tmp: Path) -> dict:
    """(d) A results folder holding only the committed JAX ``.ckpt``
    files (``results/model-7.ckpt``, ``dc/model-best.ckpt``):
    ``Generator.load`` and its depth-correction loader fill the nets, and
    one ``Generator.step`` (``jax_parity``'s step case) from them equals
    bit for bit the step from the nets the importer's ``.pt`` files fill.
    The launches are those of the ``.ckpt`` run."""
    import shutil

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.cli import import_torch_checkpoint
    from pointreggpt_tpu_torch.generate import Generator
    from pointreggpt_tpu_torch.utils import jax_parity as J

    data = REPO / "tests" / "data"
    jax_dir, pt_dir = tmp / "jax", tmp / "pt"
    (jax_dir / "results").mkdir(parents=True)
    (jax_dir / "dc").mkdir()
    shutil.copy(data / "torch_port_jax_diffusion.ckpt",
                jax_dir / "results" / "model-7.ckpt")
    shutil.copy(data / "torch_port_jax_mask.ckpt",
                jax_dir / "dc" / "model-best.ckpt")
    import_torch_checkpoint.main([
        "--diffusion", str(jax_dir / "results" / "model-7.ckpt"),
        "--depth_correction", str(jax_dir / "dc" / "model-best.ckpt"),
        "--diffusion_out", str(pt_dir / "results"),
        "--dc_out", str(pt_dir / "dc"), *J.SMALL_FLAGS])

    def loaded(folder):
        gen = Generator(C.build_diffusion_unet(J.SMALL_MODEL),
                        C.build_diffusion(C.DiffusionConfig()), str(folder),
                        batch_size=1, results_folder=str(folder / "results"),
                        samples_folder=str(folder / "samples"),
                        depth_correction_model=C.build_mask_unet(
                            J.SMALL_MASK),
                        depth_correction_results=str(folder / "dc"),
                        device="cuda")
        gen.load(7)
        gen._load_depth_correction()
        return gen.model, None, gen.depth_correction_model

    files = sorted(p.name for p in jax_dir.rglob("*") if p.is_file())
    reset_counts(K1, K2)
    got = J.run_port("cuda", cases=("step",), nets_=loaded(jax_dir),
                     tmp_dir=str(tmp))
    k1_n, k3_n, k2_n, routes = counts(K1, K2)
    want = J.run_port("cuda", cases=("step",), nets_=loaded(pt_dir),
                      tmp_dir=str(tmp))
    # 10 DDIM forwards and 2 MaskUNet forwards, each with one K1 a
    # LinearAttention block (2 a stage: 4 at dim_mults (1, 1)) and one K2
    forwards = J.STEP_SAMPLING_TIMESTEPS + 2
    per_forward = 2 * len(J.SMALL_MODEL.dim_mults)
    return dict(files=files,
                differ=sorted(k for k in want
                              if not np.array_equal(got[k], want[k])),
                launches=[k1_n, k3_n, k2_n], plain_routes=routes,
                want_launches=[per_forward * forwards, 0, forwards])


def surface_ply_report(tmp: Path) -> dict:
    """(e) ``mixture.load_point_cloud`` on PLY files the port's writer
    does not make (ascii with normals and colours, binary with uchar
    colours, ascii and binary with a trailing face element): the x/y/z
    written, exactly."""
    from pointreggpt_tpu_torch.dataloaders import mixture

    rng = np.random.default_rng(0)
    xyz = np.round(rng.uniform(-2, 2, (64, 3)), 4)
    extra = rng.integers(0, 255, (64, 3))
    tmp.mkdir(parents=True)
    out = {}
    for name, fmt, props, faces in (
            ("ascii_normals_colours", "ascii",
             ["float nx", "float ny", "float nz", "uchar red",
              "uchar green", "uchar blue"], 0),
            ("binary_colours", "binary_little_endian",
             ["uchar red", "uchar green", "uchar blue"], 0),
            ("ascii_faces", "ascii", [], 2),
            ("binary_faces", "binary_little_endian", ["float nx"], 2)):
        head = ["ply", f"format {fmt} 1.0", "element vertex 64",
                "property float x", "property float y", "property float z",
                *[f"property {p}" for p in props]]
        if faces:
            head += [f"element face {faces}",
                     "property list uchar int vertex_indices"]
        data = ("\n".join(head + ["end_header"]) + "\n").encode()
        cols = [xyz[:, i] for i in range(3)]
        cols += [extra[:, i % 3] for i in range(len(props))]
        if fmt == "ascii":
            lines = [" ".join(str(c[i]) for c in cols) for i in range(64)]
            data += ("\n".join(lines + ["3 0 1 2"] * faces) + "\n").encode()
            want = xyz
        else:
            dt = np.dtype([(f"c{i}", "<f4" if i < 3 or "float" in
                            props[i - 3] else "u1")
                           for i in range(len(cols))])
            rec = np.zeros(64, dt)
            for i, c in enumerate(cols):
                rec[f"c{i}"] = c
            data += rec.tobytes()
            data += (bytes([3]) + np.array([0, 1, 2], "<i4").tobytes()) * \
                faces
            want = xyz.astype(np.float32).astype(np.float64)
        path = tmp / f"{name}.ply"
        path.write_bytes(data)
        out[name] = bool(np.array_equal(
            mixture.load_point_cloud(str(path)), want))
    return out


def surface_native_report(tmp: Path) -> dict:
    """(f) The native host library built on the card's machine (g++ -O3,
    zlib found or not): ``load_depth_model_space`` native against PIL, bit
    for bit, on synthetic 16-bit PNGs of 640x480 and 480x640, flip on and
    off, at 256^2; frames a second of both routes over
    ``SURFACE_FRAMES`` files."""
    from PIL import Image

    from pointreggpt_tpu_torch import native
    from pointreggpt_tpu_torch.core import imageio16

    t0 = time.perf_counter()
    available = native.is_available()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    tmp.mkdir(parents=True)
    paths = []
    for i in range(SURFACE_FRAMES):
        shape = (480, 640) if i % 2 == 0 else (640, 480)
        a = rng.integers(300, 12000, shape).astype(np.uint16)
        a[rng.uniform(size=shape) < 0.1] = 0
        paths.append(tmp / f"frame-{i:03d}.depth.png")
        Image.fromarray(a).save(paths[-1])
    unequal = []
    for path in paths[:2]:
        for flip in (False, True):
            got = imageio16.load_depth_model_space(path, 256, flip=flip)
            want = imageio16.load_depth_model_space(path, 256, flip=flip,
                                                    use_native=False)
            if got.dtype != want.dtype or not np.array_equal(got, want):
                unequal.append(f"{path.name} flip={flip}")
    rate = {}
    for route, use_native in (("native", True), ("pil", False)):
        t0 = time.perf_counter()
        for path in paths:
            imageio16.load_depth_model_space(path, 256,
                                             use_native=use_native)
        rate[route] = len(paths) / (time.perf_counter() - t0)
    return dict(available=available, zlib=native.has_zlib(),
                build_or_load_s=build_s,
                library=native.library_path(native.has_zlib()).name,
                unequal=unequal, frames_per_s=rate)


def phase_surface_path(torch, K1, K2, seed: int, tmp: Path) -> dict:
    """(a) ``denoise`` and (b) ``interpolate`` at full width
    (:func:`surface_chains`), (c) :func:`surface_parity_report`, (g)
    :func:`surface_fourier_grads`, (d) :func:`surface_ckpt_report`, (e)
    :func:`surface_ply_report`, (f) :func:`surface_native_report`; fails
    on any of them."""
    root = tmp / "surface"
    res = surface_chains(torch, K1, K2, seed)
    res["jax"] = surface_parity_report(torch, K1, K2)
    res["grads"] = surface_fourier_grads(torch, K1, K2)
    res["ckpt"] = surface_ckpt_report(torch, K1, K2, root / "ckpt")
    res["ply"] = surface_ply_report(root / "ply")
    res["native"] = surface_native_report(root / "native")
    emit("surface_path", card=card_line(), **res)
    for part in ("denoise", "interpolate", "grads", "ckpt"):
        r = res[part]
        if r["launches"] != r["want_launches"]:
            raise AssertionError(f"surface_path {part}: launches K1, K3, K2 "
                                 f"= {r['launches']}, want "
                                 f"{r['want_launches']}")
        check_no_routes(f"surface_path {part}", r["plain_routes"])
    for part in ("denoise", "interpolate"):
        if not res[part]["finite"]:
            raise AssertionError(f"surface_path {part}: non-finite output")
    if res["denoise"]["masked_unequal"] or not \
            0.2 < res["denoise"]["mask_share"] < 1.0:
        raise AssertionError(f"surface_path denoise: {res['denoise']}")
    jax = res["jax"]
    if jax["failed"]:
        raise AssertionError(f"surface_path: card vs JAX over the gate "
                             f"{jax['failed']} (gates {jax['gate']})")
    if not jax["fault_over_gate"] >= FAULT_MARGIN:
        raise AssertionError(f"surface_path: the swapped interpolation "
                             f"reads {jax['fault_gap']}, under "
                             f"{FAULT_MARGIN} x its gate "
                             f"{jax['gate']['interpolate']}")
    if jax["launches"] != jax["want_launches"]:
        raise AssertionError(f"surface_path: parity launches "
                             f"{jax['launches']}, want "
                             f"{jax['want_launches']}")
    check_no_routes("surface_path jax", jax["plain_routes"])
    grads = res["grads"]
    if not (grads["learned"]["max_rel_err"] <= GRAD_RTOL and
            grads["frozen"]["max_rel_err"] <= GRAD_RTOL and
            grads["learned"]["frequencies_grad"] and
            grads["frozen"]["frequencies_grad"] is None):
        raise AssertionError(f"surface_path: Fourier net gradients {grads}")
    if res["ckpt"]["differ"]:
        raise AssertionError(f"surface_path: the .ckpt folder's step "
                             f"differs in {res['ckpt']['differ']}")
    if not all(res["ply"].values()):
        raise AssertionError(f"surface_path: PLY reads {res['ply']}")
    if not res["native"]["available"] or res["native"]["unequal"]:
        raise AssertionError(f"surface_path: native {res['native']}")
    # the phase's launches of each kernel, every counted run summed
    for i, key in enumerate(("k1_launches", "k3_launches", "k2_launches")):
        res[key] = (res["denoise"]["launches"][i] +
                    res["interpolate"]["launches"][i] +
                    jax["launches"][("k1", "k3", "k2")[i]] +
                    grads["launches"][i] + res["ckpt"]["launches"][i])
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

    t_start = t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[_build.library_path(n).name for n in _build.SOURCES])

    seconds = {}  # wall seconds of each phase, for the time limit

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
    timed("net_parity", phase_net_parity, torch, dev)
    timed("forward_profile", phase_forward_profile, torch, dev)
    timed("grad_parity", phase_grad_parity, torch, dev)
    timed("wide_net", phase_wide_net, torch, K1, K2, dev)
    fwd_bwd = timed("mask_fwd_bwd", phase_mask_fwd_bwd, torch, K1, K2, dev)
    with tempfile.TemporaryDirectory(prefix="prgpt_train_") as tmp:
        tmp = Path(tmp)
        folder, gt_log = write_training_tree(tmp, 64, args.seed)
        timed("train_step", phase_train_step, torch, K1, K2, folder, gt_log,
              tmp)
        main_res = timed("main_path", phase_main_path, torch, K1, K2,
                         args.seed, args.num_samples, tmp / "main")
        train_res = timed("train_path", phase_train_path, torch, K1, K2,
                          folder, gt_log, tmp)
        mask_res = timed("mask_train_path", phase_mask_train_path, torch,
                         K1, K2, args.seed, tmp, fwd_bwd)
        timed("jax_parity", phase_jax_parity, torch, K1, K2, tmp)
        timed("gt_path", phase_gt_path, torch, args.seed, tmp / "main", tmp)
        tester_res = timed("tester_path", phase_tester_path, torch, K1, K2,
                           args.seed, tmp)
        fid_res = timed("fid_path", phase_fid_path, torch, K1, K2, folder,
                        gt_log, tmp)
        import_res = timed("import_path", phase_import_path, torch, K1, K2,
                           tmp)
        timed("mixture_path", phase_mixture_path, torch, args.seed,
              tmp / "main", tmp)
        dist_res = timed("dist_path", phase_dist_path, torch, K1, K2,
                         args.seed, tmp)
        timed("profile_path", phase_profile_path, torch, tmp, fwd_bwd)
        surface_res = timed("surface_path", phase_surface_path, torch, K1,
                            K2, args.seed, tmp)
        adm_res = timed("main_path_adm", phase_main_path, torch, K1, K2,
                        args.seed, 1, tmp / "adm", "adm")
    emit("phase_seconds", total=time.perf_counter() - t_start, **seconds)
    sample_steps = main_res["num_samples"]

    # launches: the main paths (generation, diffusion training,
    # depth-correction training, the Tester's three runs, the training
    # run with FID, the imported checkpoints' step and resumed training,
    # dist_path's processes, summed over them, and surface_path's
    # denoise, interpolation, JAX cases and .ckpt step), each counted from 0
    # just before its entry point runs; per sample
    # step of generation, per optimizer step of diffusion training (its
    # milestone grid counted apart), per optimizer step of the MaskTrainer
    # (its validation counted apart) and per sample call of the Tester's
    # CLI
    def launches(i, key):
        mask_key = ("k1_per_step", "k3_per_step", "k2_per_step")[i]
        tester = [tester_res[run][("k1", "k3", "k2")[i]]
                  for run in ("cli", "generate", "ancestral")]
        return dict(launches=main_res[key] + train_res[key] +
                    mask_res[key] + sum(tester) + fid_res[key] +
                    import_res[key] + dist_res[key] + surface_res[key],
                    launches_generate=main_res[key],
                    launches_train=train_res[key],
                    launches_mask_train=mask_res[key],
                    launches_tester=tester[0],
                    launches_tester_generate=tester[1],
                    launches_tester_ancestral=tester[2],
                    launches_fid_train=fid_res[key],
                    launches_import=import_res[key],
                    launches_dist=dist_res[key],
                    launches_surface=surface_res[key],
                    per_sample_step=main_res[key] / sample_steps,
                    per_optimizer_step=train_res["per_optimizer_step"][i],
                    launches_train_grid=train_res["grid_launches"][i],
                    per_mask_optimizer_step=mask_res[mask_key],
                    per_tester_sample_call=tester[0] /
                    tester_res["cli_sample_calls"])

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
                    train_res["plain_routes"][key] +
                    mask_res["plain_routes"][key])
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
                  "cuda_core_bound_ms at 67; d64: flash_fwd_tc<64> at "
                  "ADM's three shapes, bf16, heads 3 d apart "
                  "(K2.check_inputs legacy), and adm_path's generate_dataset "
                  "--denoiser adm run (one 250-step sample step, counted "
                  "apart from launches)",
             fp32=k2_f32, **k2,
             d64=dict(**k2_adm, launches_adm_path=adm_res["k2_launches"],
                      attention_routes=adm_res["attention_routes"],
                      per_sample_step=adm_res["attention_routes_per_step"],
                      per_forward=adm_res["attention_routes"]["attn_k2_d64"]
                      / (250 * adm_res["num_samples"]))),
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
                  "494.7 / 3 TFLOP/s, cuda_core_bound_ms at 67; dw: "
                  "profile_conv.mask_main, the fp32 MaskUNet's 14 3x3 "
                  "shapes at batch 4 (the route of ops/conv.py::conv2d, "
                  "on the MaskUNet path): conv3_dw.cu's weight and bias "
                  "gradient (dw_ms) beside its bound, _wgrad and cuDNN's "
                  "fp32 weight gradient, and K5's fp32 forward and dx "
                  "beside cuDNN's, summed over the shapes",
             **k5),
        dict(name="group_norm_act", route="cuda",
             source="pointreggpt_tpu_torch/ops/csrc/group_norm.cu",
             replaces="none: PyTorch's NCHW GroupNorm and the cast, copy, "
                      "scale-shift, SiLU and cast passes around it",
             launches_per_sample_step=main_res["norm_launches"]
             / sample_steps,
             launches_per_adm_sample_step=adm_res["norm_launches"]
             / adm_res["num_samples"],
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
                  "launches counted by the kernel's counter",
             **gn),
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
