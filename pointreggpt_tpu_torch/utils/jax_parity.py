"""The port's side of its parity check against JAX output, at full width.

The JAX package computes three outputs once, on the CPU, from weights and
inputs that this module rebuilds from a seed with numpy alone
(``tests/make_torch_port_jax_reference.py`` writes them to
``tests/data/torch_port_jax_reference.npz``). The port recomputes them on
any device and is held to that file:

- ``forward``: one baked bf16 DiffusionUNet forward (``ModelConfig()``) at
  (2, 256, 256, 1), the forward of every chain step of the Generator;
- ``mask``: one fp32 MaskUNet forward (``MaskModelConfig()``) at (4, 256,
  256, 1), the MaskTrainer's batch; its output bias is left at its seeded
  value so the probabilities lie where the sigmoid is steep;
- ``step``: one ``Generator.step`` at batch 2 (10 DDIM steps, eta 0, DDNM
  on, the MaskUNet with its raised output bias, memory 2^18 seeded from one
  back-projected synthetic frame, the pose and x_T injected), summarized
  as its images, its keep mask, its overflow, and per row the count of
  valid memory voxels and the sum of their centroids.

A second file, ``tests/data/torch_port_fid_import_reference.npz`` (written
by ``tests/make_torch_port_fid_import_reference.py``), holds the JAX
InceptionV3 features of :func:`fid_images` (``fid_features``) and, beside
the JAX package's two small-width ``.ckpt`` files in ``tests/data/``, the
JAX forwards of their weights on :func:`small_inputs`
(``diffusion_forward``, ``mask_forward``); :func:`import_forwards` is the
port's side, from the checkpoints the importer CLI wrote.
"""

from __future__ import annotations

import copy
import math
from typing import Dict

import numpy as np
import torch

from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch.core import geometry as G
from pointreggpt_tpu_torch.ops.linear_attention import DIM_HEAD, HIDDEN
from pointreggpt_tpu_torch.utils.seeded_weights import fill_seeded

SEED = 0
H = 256
FORWARD_BATCH = 2
MASK_BATCH = 4
STEP_BATCH = 2
STEP_SAMPLING_TIMESTEPS = 10
MEMORY_CAPACITY = 1 << 18
MEMORY_VOXEL = 0.002  # the Generator's default
CASES = ("forward", "mask", "step")


def nets(seed: int = SEED):
    """(DiffusionUNet bf16, MaskUNet for ``mask``, MaskUNet for ``step``),
    fp32 parameters from ``seed``; the two mask nets differ only in the
    output bias."""
    unet = fill_seeded(C.build_diffusion_unet(C.ModelConfig()), seed)
    mask = fill_seeded(C.build_mask_unet(C.MaskModelConfig()), seed + 1,
                       mask_out_bias=None)
    mask_step = fill_seeded(C.build_mask_unet(C.MaskModelConfig()), seed + 1)
    return unet, mask, mask_step


def _intrinsics(b: int) -> np.ndarray:
    """The most common 3DMatch camera at 256^2 (resize + center crop)."""
    intr = np.tile(np.array([[570.342205, 0.0, 320.0],
                             [0.0, 570.342205, 240.0],
                             [0.0, 0.0, 1.0]], np.float32), (b, 1, 1))
    return G.intrinsic_transform(intr, resize=H,
                                 centercrop=H).astype(np.float32)


def _param_vector(intr: np.ndarray) -> np.ndarray:
    return np.stack([intr[:, 0, 0], intr[:, 1, 1], intr[:, 0, 2],
                     intr[:, 1, 2]], axis=-1)


def _pose(rng: np.random.Generator, b: int) -> np.ndarray:
    """Camera motions as the Generator draws them: pitch in +-pi/24, yaw
    in +-pi/12 about a pivot 3 m ahead, an in-plane translation / 3."""
    out = np.tile(np.eye(4), (b, 1, 1))
    for i in range(b):
        a = (rng.uniform() * 2 - 1) * math.pi / 24
        c = (rng.uniform() * 2 - 1) * math.pi / 12
        rx = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)],
                       [0, math.sin(a), math.cos(a)]])
        ry = np.array([[math.cos(c), 0, math.sin(c)], [0, 1, 0],
                       [-math.sin(c), 0, math.cos(c)]])
        rot = rx @ ry
        center = np.array([0.0, 0.0, 3.0])
        trans = rng.normal(size=3) / 3.0
        trans[2] = 0.0
        out[i, :3, :3] = rot
        out[i, :3, 3] = center - rot @ center + trans
    return out.astype(np.float32)


def inputs(seed: int = SEED) -> Dict[str, np.ndarray]:
    """Every input of the three cases, from ``seed``."""
    rng = np.random.default_rng(seed)
    intr = _intrinsics(STEP_BATCH)
    x = rng.standard_normal((FORWARD_BATCH, H, H, 1)).astype(np.float32)
    t = rng.integers(0, 1000, FORWARD_BATCH).astype(np.float32)
    pc = _param_vector(_intrinsics(FORWARD_BATCH))
    mask_x = rng.uniform(0.0, 1.0, (MASK_BATCH, H, H, 1)).astype(np.float32)

    # one synthetic frame per row, 2-2.8 m, back-projected into the memory
    yy, xx = np.mgrid[0:H, 0:H]
    mem = np.zeros((STEP_BATCH, MEMORY_CAPACITY, 3), np.float32)
    valid = np.zeros((STEP_BATCH, MEMORY_CAPACITY), bool)
    for i in range(STEP_BATCH):
        depth = (2.4 + 0.4 * np.sin(xx / 40.0 + i) * np.cos(yy / 30.0) +
                 0.01 * rng.uniform(size=(H, H))).astype(np.float32)
        pts = G.point_cloud_np(depth, intr[i], clip=(0.5, 10.0))
        mem[i, :len(pts)] = pts
        valid[i, :len(pts)] = True
    return dict(x=x, t=t, param_cond=pc, mask_x=mask_x, mem=mem,
                mem_valid=valid, intrinsic=intr,
                step_param_cond=_param_vector(intr),
                pose=_pose(rng, STEP_BATCH),
                x_init=rng.standard_normal((STEP_BATCH, H, H, 1)
                                           ).astype(np.float32))


def summarize_step(images, keep, mem_pts, mem_valid, overflow
                   ) -> Dict[str, np.ndarray]:
    """What ``step`` keeps of a Generator step (host numpy in, out)."""
    mem_valid = np.asarray(mem_valid)
    pts = np.where(mem_valid[..., None], np.asarray(mem_pts, np.float64), 0)
    return dict(step_images=np.asarray(images, np.float32),
                step_keep=np.asarray(keep, bool),
                step_overflow=np.asarray(overflow, np.int64),
                step_mem_count=mem_valid.sum(axis=1).astype(np.int64),
                step_mem_sum=pts.sum(axis=1))


@torch.inference_mode()
def run_port(device, seed: int = SEED, cases=CASES, nets_=None,
             tmp_dir: str = ".") -> Dict[str, np.ndarray]:
    """The port's outputs of ``cases`` on ``device``, through the entry
    points (``place_for_inference``, ``Generator.step``). ``nets_`` may
    pass (unet, mask, mask_step), e.g. with a planted fault."""
    from pointreggpt_tpu_torch.generate.generator import (
        Generator, place_for_inference)

    device = torch.device(device)
    unet, mask, mask_step = nets(seed) if nets_ is None else nets_
    x = inputs(seed)
    out = {}
    if "forward" in cases:
        net = place_for_inference(unet, device)
        y = net(torch.from_numpy(x["x"]).to(device).permute(0, 3, 1, 2),
                torch.from_numpy(x["t"]).to(device),
                torch.from_numpy(x["param_cond"]).to(device))
        out["forward"] = y.permute(0, 2, 3, 1).float().cpu().numpy()
        del net
    if "mask" in cases:
        net = place_for_inference(mask, device)
        y = net(torch.from_numpy(x["mask_x"]).to(device).permute(0, 3, 1, 2))
        out["mask"] = y.permute(0, 2, 3, 1).float().cpu().numpy()
        del net
    if "step" in cases:
        diffusion = C.build_diffusion(C.DiffusionConfig(
            sampling_timesteps=STEP_SAMPLING_TIMESTEPS,
            ddim_sampling_eta=0.0))
        gen = Generator(unet, diffusion, tmp_dir, batch_size=STEP_BATCH,
                        samples_folder=tmp_dir,
                        depth_correction_model=mask_step,
                        memory_capacity=MEMORY_CAPACITY, device=device)

        def d(k):
            return torch.from_numpy(x[k]).to(device)

        s = gen.step(d("mem"), d("mem_valid"), d("intrinsic"),
                     d("step_param_cond"), pose=d("pose"),
                     x_init=d("x_init"), memory_voxel=MEMORY_VOXEL)
        out.update(summarize_step(
            s.images.cpu().numpy(), s.keep_mask.cpu().numpy(),
            s.mem_pts.cpu().numpy(), s.mem_valid.cpu().numpy(),
            s.overflow.cpu().numpy()))
        del gen, s
    return out


FAULT_KEY = "downs.0.2.fn.fn.to_qkv.weight"  # the first LinearAttention


def plant_fault(unet):
    """A copy of ``unet`` with one head shuffled: in the first
    LinearAttention block, head 0 reads head 1's values and head 1 head
    0's (their v rows of ``to_qkv`` swapped), as a kernel that indexed the
    heads' values wrongly would compute."""
    bad = copy.deepcopy(unet)
    sd = bad.state_dict()
    w = sd[FAULT_KEY]
    v0 = 2 * HIDDEN  # to_qkv rows: [q | k | v], head-major in each
    head0 = w[v0:v0 + DIM_HEAD].clone()
    w[v0:v0 + DIM_HEAD] = w[v0 + DIM_HEAD:v0 + 2 * DIM_HEAD]
    w[v0 + DIM_HEAD:v0 + 2 * DIM_HEAD] = head0
    bad.load_state_dict(sd)
    return bad


# outputs held by their largest absolute difference; the memory's voxel
# count and centroid sum by it over their largest magnitude
ABSOLUTE = ("forward", "mask", "step_images", "step_overflow")
RELATIVE = ("step_mem_count", "step_mem_sum")


def gaps(got: Dict[str, np.ndarray], ref) -> Dict[str, float]:
    """Differences of each output present in ``got`` to ``ref``: largest
    absolute (``ABSOLUTE``) or relative to ``ref``'s largest magnitude
    (``RELATIVE``), and the keep mask's share of differing pixels. The
    step's images are compared where the two keep masks agree: a pixel
    kept by one side only is pinned to the condition on that side."""
    out = {}
    for k in ABSOLUTE + RELATIVE:
        if k not in got:
            continue
        g = np.asarray(got[k], np.float64)
        r = np.asarray(ref[k], np.float64)
        if k == "step_images":
            agree = got["step_keep"] == ref["step_keep"]
            g, r = g[..., 0][agree], r[..., 0][agree]
        d = np.abs(g - r).max()
        out[k] = float(d / np.abs(r).max() if k in RELATIVE else d)
    if "step_keep" in got:
        out["step_keep"] = float((got["step_keep"] !=
                                  ref["step_keep"]).mean())
    return out


# ---------------------------------------------------------------------------
# FID features and imported small-width checkpoints

FID_BATCH = 32  # InceptionFeatures' chunk
FID_IMAGE = 256  # the Trainer's images, resized up to 299
INCEPTION_SEED = 0
SMALL_H, SMALL_BATCH = 64, 2
SMALL_MODEL = C.ModelConfig(dim=8, dim_mults=(1, 1), bf16=False)
SMALL_MASK = C.MaskModelConfig(dim=8, dim_mults=(1, 1))
# the importer CLI's flags for the two small nets
SMALL_FLAGS = ["--dim", "8", "--dim_mults", "1,1", "--bf16", "false",
               "--dc_dim", "8", "--dc_dim_mults", "1,1"]


def fid_images(seed: int = SEED) -> np.ndarray:
    """(32, 256, 256, 1) images in [0, 1]: a smooth field per image plus
    uniform noise."""
    rng = np.random.default_rng(seed + 1)
    yy, xx = np.mgrid[0:FID_IMAGE, 0:FID_IMAGE] / FID_IMAGE
    out = np.empty((FID_BATCH, FID_IMAGE, FID_IMAGE, 1), np.float32)
    for i in range(FID_BATCH):
        fx, fy, ph = rng.uniform(1, 6), rng.uniform(1, 6), rng.uniform(0, 6)
        field = 0.5 + 0.35 * np.sin(fx * 6.28 * xx + ph) * np.cos(
            fy * 6.28 * yy)
        out[i, ..., 0] = field + 0.1 * rng.uniform(-1, 1, field.shape)
    return np.clip(out, 0.0, 1.0)


def small_inputs(seed: int = SEED) -> Dict[str, np.ndarray]:
    """The inputs of the two small-width forwards, NHWC."""
    rng = np.random.default_rng(seed + 2)
    b, h = SMALL_BATCH, SMALL_H
    return dict(
        x=rng.standard_normal((b, h, h, 1)).astype(np.float32),
        t=rng.integers(0, 1000, b).astype(np.float32),
        param_cond=rng.uniform(0.5, 1.5, (b, 4)).astype(np.float32),
        mask_x=rng.uniform(0.0, 1.0, (b, h, h, 1)).astype(np.float32))


@torch.inference_mode()
def import_forwards(diffusion_pt, mask_pt, device) -> Dict[str, np.ndarray]:
    """Forwards of the online U-Net of a port diffusion checkpoint and of
    the MaskUNet of a port depth-correction checkpoint (the importer's
    outputs, at ``SMALL_MODEL`` / ``SMALL_MASK``) on :func:`small_inputs`,
    on ``device``, as NHWC numpy."""
    from pointreggpt_tpu_torch.utils.jax_params import (
        load_reference_checkpoint, strip_prefix)

    device = torch.device(device)
    x = {k: torch.from_numpy(v).to(device) for k, v in small_inputs().items()}
    unet = C.build_diffusion_unet(SMALL_MODEL)
    unet.load_state_dict(strip_prefix(
        load_reference_checkpoint(diffusion_pt)["model"], "model."))
    mask = C.build_mask_unet(SMALL_MASK)
    mask.load_state_dict(load_reference_checkpoint(mask_pt)["model"])
    unet, mask = unet.to(device).eval(), mask.to(device).eval()
    y = unet(x["x"].permute(0, 3, 1, 2), x["t"], x["param_cond"])
    m = mask(x["mask_x"].permute(0, 3, 1, 2))
    return {"diffusion_forward": y.permute(0, 2, 3, 1).float().cpu().numpy(),
            "mask_forward": m.permute(0, 2, 3, 1).float().cpu().numpy()}
