"""GPU smoke run of the PyTorch port (``pointreggpt_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (an H100 is the target), the CUDA toolkit's ``nvcc``
and this repository; exits nonzero without a GPU and prints no result.
Phases, each printing one JSON line:

1. the card (``nvidia-smi`` name and power limit), torch / CUDA / nvcc;
2. build every hand-written kernel from ``pointreggpt_tpu_torch/ops/csrc``
   (one nvcc per source, all at once);
3. K1 (fused LinearAttention) against its plain version at the eight
   (8, n, c) shapes of a dim-64 U-Net forward at 256^2, in bf16 (the
   DiffusionUNet) and fp32 (the MaskUNet), with times, bounds and errors;
4. K2 (bottleneck attention) against its plain version at (8, 1024, 4, 32)
   in both types, plus ``F.scaled_dot_product_attention`` (fp32) as the
   library yardstick — timed here only, never called by the port;
5. a small whole-U-Net forward on the card against the same net on the
   CPU (fp32, plain path), the repo's own parity check;
6. one production DiffusionUNet forward (bf16, 256^2, batch 8): its time
   and its device time by kernel category (torch.profiler); and the time
   of one fp32 MaskUNet forward at the same size;
7. the main path: ``pointreggpt_tpu_torch.cli.generate_dataset.main`` at
   the production configuration (dim 64, 256^2, batch 8, 250 DDIM steps,
   eta 1, MaskUNet on, memory 2^18) on a synthetic 3DMatch tree with
   random weights made from ``--seed``, two sample steps; checks the output
   contract and that the kernel counters read 2,016 K1 and 252 K2 launches
   per sample step.

The last three lines are the kernel table (one JSON object), the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
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
# peak rates for the inputs' type: dense bf16 tensor cores, fp32 outside
# the tensor cores (the fp32 MaskUNet's math)
PEAK = {"bfloat16": 989e12, "float32": 67e12}
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


def bound(work: dict, peak: float) -> tuple:
    t_bytes = work["bytes"] / MEM_BW * 1e3
    t_ops = work["flops"] / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_k1(torch, K1, dev, dtype):
    """K1 against its plain version at the eight shapes of one forward,
    in ``dtype`` (bf16 for the DiffusionUNet, fp32 for the MaskUNet)."""
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
            ms = time_ms(lambda: K1.fused_linear_attention(*args, eps=eps),
                         20)
            plain_ms = time_ms(
                lambda: K1.fused_linear_attention_plain(*args, eps=eps), 3, 1)
            wk = K1.work(8, n, c, size)
            b_ms, b_by = bound(wk, peak)
            cache[(n, c)] = dict(n=n, c=c, max_abs_err=err, ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, **wk)
            del args, out, ref
            torch.cuda.empty_cache()
        rows.append(cache[(n, c)])
    emit(f"k1_{name}", shapes=rows, atol=atol)
    t_bytes = sum(r["bytes"] for r in rows) / MEM_BW * 1e3
    t_ops = sum(r["flops"] for r in rows) / peak * 1e3
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_k2(torch, K2, dev, dtype):
    """K2 against its plain version at (8, 1024, 4, 32), with SDPA (fp32)
    timed as the library yardstick."""
    import torch.nn.functional as F

    name = str(dtype).split(".")[-1]
    atol = K_ATOL[("k2", name)]
    rng = np.random.default_rng(1)
    b, n, h, d = 8, 1024, 4, 32
    qkv = torch.tensor(rng.normal(size=(b, n, 3, h, d)), dtype=dtype,
                       device=dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = d**-0.5
    out = K2.multihead_attention(q, k, v, scale=scale)
    ref = K2.multihead_attention_plain(q, k, v, scale=scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not np.isfinite(err) or err > atol:
        raise AssertionError(f"K2 {name}: max abs err {err} > {atol}")
    ms = time_ms(lambda: K2.multihead_attention(q, k, v, scale=scale), 50)
    plain_ms = time_ms(
        lambda: K2.multihead_attention_plain(q, k, v, scale=scale), 10)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qf, kf, vf, scale=scale)
    lib_err = (lib.transpose(1, 2) - ref.float()).abs().max().item()
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qf, kf, vf, scale=scale), 50)
    b_ms, b_by = bound(K2.work(b, n, h, d, q.element_size()), PEAK[name])
    res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=library_ms)
    emit(f"k2_{name}", shape=[b, n, h, d], atol=atol,
         library_max_abs_err=lib_err, **res)
    return res


def phase_net_parity(torch, dev):
    """A dim-64 DiffusionUNet forward (fp32, 64^2) on the card against the
    same net on the CPU, with weights on which K1's core counts."""
    from pointreggpt_tpu_torch.models import DiffusionUNet
    from pointreggpt_tpu_torch.models.blocks import LinearAttention

    torch.manual_seed(0)
    net = DiffusionUNet(dim=64).eval()
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(2, 1, 64, 64)), dtype=torch.float32)
    t = torch.tensor([10.0, 900.0])
    pc = torch.tensor(rng.uniform(100, 600, (2, 4)), dtype=torch.float32)
    cl = torch.channels_last
    # let each LinearAttention's core, not its to_out bias, carry the
    # block's output, as K1.check_inputs does: zero the bias and scale the
    # weight by n^1.5 / 2 for the block's n pixels
    pixels = {}

    def count_pixels(mod, args):
        pixels[mod] = args[0].shape[2] * args[0].shape[3]

    hooks = [m.register_forward_pre_hook(count_pixels)
             for m in net.modules() if isinstance(m, LinearAttention)]
    with torch.inference_mode():
        net(x, t, pc)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        for m, n in pixels.items():
            m.to_out[0].bias.zero_()
            m.to_out[0].weight.mul_(n**1.5 / 2)
    with torch.inference_mode():
        ref = net(x, t, pc)
        gpu = net.to(dev, memory_format=cl)(
            x.to(dev, memory_format=cl), t.to(dev), pc.to(dev)).cpu()
    err = (gpu - ref).abs().max().item()
    if not np.isfinite(err) or err > NET_ATOL:
        raise AssertionError(f"U-Net card vs CPU: {err} > {NET_ATOL}")
    emit("net_parity", max_abs_err=err, atol=NET_ATOL)


_CATEGORIES = (
    ("k1", ("kv_partials", "merge_context", "emit_out")),
    ("k2", ("flash_fwd",)),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad",
              "sm90_", "cutlass", "gemm", "nchw", "nhwc")),
    ("group_norm", ("group_norm", "groupnorm", "GroupNorm")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "unrolled",
                     "CatArray", "copy")),
)


def phase_forward_profile(torch, dev):
    """Device time of one production DiffusionUNet forward (dim 64, bf16,
    baked, 256^2, batch 8), by kernel category, from torch.profiler."""
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
    mask = C.build_mask_unet(C.MaskModelConfig()).eval().to(
        dev, memory_format=torch.channels_last)
    with torch.inference_mode():
        mask_ms = time_ms(lambda: mask(x), 3, warmup=1)
    emit("forward_profile", forward_ms=fwd_ms, mask_forward_fp32_ms=mask_ms,
         device_ms=total / 1e3,
         kernels_launched=n,
         by_category_ms={k: v / 1e3 for k, v in sorted(cats.items())},
         top_kernels_ms=[[k[:90], v / 1e3] for k, v in top])
    del net, mask, x
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
        K1.fused_linear_attention.launches = 0
        K2.multihead_attention.launches = 0
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
        k1_n = K1.fused_linear_attention.launches
        k2_n = K2.multihead_attention.launches
        want_k1, want_k2 = 2016 * num_samples, 252 * num_samples
        if (k1_n, k2_n) != (want_k1, want_k2):
            raise AssertionError(
                f"kernel launches on the main path: K1 {k1_n} (want "
                f"{want_k1}), K2 {k2_n} (want {want_k2})")

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
               k1_launches=k1_n, k2_launches=k2_n,
               k1_per_step=k1_n / num_samples,
               k2_per_step=k2_n / num_samples)
    emit("main_path", card=card_line(), **res)
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
    phase_net_parity(torch, dev)
    phase_forward_profile(torch, dev)
    main_res = phase_main_path(torch, K1, K2, args.seed, args.num_samples)

    kernels = [
        dict(name="fused_linear_attention", route="cuda",
             source="pointreggpt_tpu_torch/ops/csrc/linear_attention.cu",
             replaces="pointreggpt_tpu/ops/linear_attention.py:202",
             launches=main_res["k1_launches"], library_ms=None,
             work="the 8 calls of one dim-64 U-Net forward, bf16, batch 8, "
                  "256^2 (times and bounds summed over the 8 shapes)",
             fp32=k1_f32, **k1),
        dict(name="multihead_attention", route="cuda",
             source="pointreggpt_tpu_torch/ops/csrc/attention.cu",
             replaces="pointreggpt_tpu/ops/attention.py:64",
             launches=main_res["k2_launches"],
             work="one call at (8, 1024, 4, 32) bf16", fp32=k2_f32, **k2),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
