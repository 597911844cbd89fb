"""Generator: the production dataset factory, on torch + CUDA.

Port of ``pointreggpt_tpu/generate/generator.py``. For each scene drawn
from the 3DMatch ``train_info.pkl`` pair pool: read the real source depth
frame, crop to the bbox [-1.5,-1.5,0.5]..[1.5,1.5,3.5], seed the scene
memory cloud; then per sample: random SE(3) pose -> z-buffer splat of the
memory -> depth-correction mask #1 (0.99 threshold) -> DDIM + DDNM chain ->
depth-correction pass #2 -> back-projection -> memory voxel update, and
the host writes.

All scenes of a batch advance together through one device step per sample
(:meth:`Generator.step`), which queues on the stream without a host sync.
Step k + 1 is queued before the host writes step k; step k's outputs reach
the host through pinned buffers and an event, so the PNG/PLY encoding
overlaps step k + 1 on the card.

Under torchrun each process generates its own scenes
(``parallel.local_scene_range``, passed by the CLI as ``scene_indices``),
with ``batch_size`` scenes a step on its GPU and a pose stream of its own.

Output contract (unchanged): ``scene-%06d/{camera-intrinsics.txt,
sample-%06d.pose.txt, sample-%06d.image.png, sample-%06d.depth.png,
sample-%06d.cloud.ply}`` plus the ``reprojected.image.png`` /
``corrected.image.png`` debug snapshots.
"""

from __future__ import annotations

import pickle
import shutil
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.core import geometry as G
from pointreggpt_tpu_torch.core import imageio16, plyio
from pointreggpt_tpu_torch.core import pointops as P
from pointreggpt_tpu_torch.core import sampling as S
from pointreggpt_tpu_torch.data.datasets import resolve_frame_record
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.models.bake import bake_inference
from pointreggpt_tpu_torch.parallel import mesh as M
from pointreggpt_tpu_torch.train import checkpoint as ckpt
from pointreggpt_tpu_torch.utils import profiling
from pointreggpt_tpu_torch.utils.jax_params import strip_prefix

BBOX_MIN = (-1.5, -1.5, 0.5)
BBOX_MAX = (1.5, 1.5, 3.5)


class StepOutputs(NamedTuple):
    pose: torch.Tensor          # (b, 4, 4)
    images_raw: torch.Tensor    # (b, h, w) splat, [0, 1] model units
    images_rpj: torch.Tensor    # (b, h, w) after depth correction #1
    keep_mask: torch.Tensor     # (b, h, w) condition mask after #1
    images: torch.Tensor        # (b, h, w, 1) sampled, after #2
    world: torch.Tensor         # (b, h*w, 3) new frame, world frame
    world_valid: torch.Tensor   # (b, h*w)
    mem_pts: torch.Tensor       # (b, capacity, 3)
    mem_valid: torch.Tensor     # (b, capacity)
    overflow: torch.Tensor      # (b,)


def voxel_downsample_host(pts_np: np.ndarray, voxel: float) -> np.ndarray:
    """Voxel-downsample a host cloud on the CPU, compacted. The host writes
    run while the card works on the next step, so they stay off its
    stream."""
    pts = torch.from_numpy(np.ascontiguousarray(pts_np, np.float32))
    out, ok = P.voxel_downsample(pts, torch.ones(pts.shape[0], dtype=bool),
                                 voxel)
    return out[ok].numpy()


def load_ema_unet(model, path) -> None:
    """Load the EMA U-Net of a diffusion checkpoint ({step, model, ema},
    the reference layout: the EMA wraps the GaussianDiffusion, whose
    ``model`` is the U-Net, so its keys sit under ``ema_model.model.``; a
    bare ``ema_model.`` U-Net loads too; a JAX package ``.ckpt`` is
    converted to that layout) into ``model``."""
    data = ckpt.load_diffusion_checkpoint(path, model)
    sd = strip_prefix(data["ema"], "ema_model.")
    if any(k.startswith("model.") for k in sd):
        sd = strip_prefix(sd, "model.")
    model.load_state_dict(sd)
    if data.get("version"):
        print(f"loading from version {data['version']}")


def place_for_inference(model, device):
    """``model`` baked for its compute dtype, channels-last on ``device``,
    in eval mode."""
    model = bake_inference(model.eval(), model.dtype)
    return model.to(device, memory_format=torch.channels_last).eval()


class Generator:
    """Batched scene generator.

    Args:
        model: DiffusionUNet (fp32 params; baked for its compute dtype at
            first use).
        diffusion: the sampling process (250-step DDIM + DDNM in
            production).
        folder: 3DMatch-RGBD train root (scene dirs with intrinsics).
        batch_size: scenes a step, on this process's GPU (the JAX
            package's is per host, split over its chips).
        depth_correction_model: optional MaskUNet.
        memory_capacity: padded scene-memory size per scene.
        device: ``cuda`` unless asked otherwise (see ``resolve_device``).
    """

    def __init__(self, model, diffusion: GaussianDiffusion, folder: str, *,
                 batch_size: int = 16,
                 results_folder: str = "./results",
                 samples_folder: str = "./samples",
                 depth_correction_model=None,
                 depth_correction_results: str = "./depth_correction_results",
                 train_info_path: str = "./dataset/indoor/metadata/train_info.pkl",
                 data_root: str = "./dataset/indoor/data",
                 memory_capacity: int = 1 << 18,
                 seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.diffusion = diffusion
        self.folder = folder
        self.batch_size = batch_size
        self.image_size = diffusion.image_size
        self.results_folder = Path(results_folder)
        self.samples_folder = Path(samples_folder)
        self.samples_folder.mkdir(parents=True, exist_ok=True)
        self.depth_correction_model = depth_correction_model
        self.depth_correction_results = Path(depth_correction_results)
        self.train_info_path = train_info_path
        self.data_root = data_root
        self.memory_capacity = memory_capacity
        self.seed = seed
        self._loaded = False
        self._dc_stamp = None  # (mtime_ns, size) of the loaded model-best
        self._device_models = None  # (ema, dc) baked, on the device

    # ------------------------------------------------------------------
    def load(self, milestone) -> None:
        """Load the EMA weights of ``model-{milestone}.pt``, or of the JAX
        package's ``model-{milestone}.ckpt`` (see :func:`load_ema_unet`)."""
        load_ema_unet(self.model,
                      ckpt.milestone_path(self.results_folder, milestone))
        self._loaded = True
        self._device_models = None

    def _load_depth_correction(self) -> None:
        """Load ``model-best.pt`` ({epoch, model}), or the JAX package's
        ``model-best.ckpt``; cached on the file's (path, mtime, size), so
        an overwritten checkpoint is picked up."""
        if self.depth_correction_model is None:
            return
        path = ckpt.milestone_path(self.depth_correction_results, "best")
        st = path.stat()
        stamp = (path, st.st_mtime_ns, st.st_size)
        if self._dc_stamp == stamp:
            return
        data = ckpt.load_mask_checkpoint(path, self.depth_correction_model)
        self.depth_correction_model.load_state_dict(data["model"])
        self._dc_stamp = stamp
        self._device_models = None

    def device_models(self):
        """(diffusion net, mask net or None), baked and on the device;
        built once and reused until a load invalidates it."""
        if self._device_models is None:
            dc = self.depth_correction_model
            self._device_models = (
                place_for_inference(self.model, self.device),
                place_for_inference(dc, self.device)
                if dc is not None else None)
        return self._device_models

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self, mem_pts: torch.Tensor, mem_valid: torch.Tensor,
             intrinsic: torch.Tensor, param_cond: torch.Tensor,
             generator: Optional[torch.Generator] = None, *,
             pose: Optional[torch.Tensor] = None,
             x_init: Optional[torch.Tensor] = None,
             has_refine_step: bool = False,
             memory_voxel: float = 0.002) -> StepOutputs:
        """Advance a whole batch by one sample. ``pose`` and ``x_init``
        override the random draws (tests make the step deterministic with
        them and eta 0)."""
        ema, dc = self.device_models()
        H = self.image_size
        b = mem_pts.shape[0]
        if pose is None:
            pose = S.random_sample_pose(generator, b, device=mem_pts.device)

        pts = G.transform_points(mem_pts, pose)
        depth_rpj, mask_rpj = G.points_to_depth(pts, mem_valid, intrinsic,
                                                image_size=(H, H))
        images_raw = depth_rpj * 0.1  # meters -> [0, 1] model units
        images_rpj = images_raw
        if dc is not None:
            keep = dc(images_rpj[:, None])[:, 0] > 0.99
            images_rpj = torch.where(keep, images_rpj,
                                     torch.zeros_like(images_rpj))
            mask_rpj = mask_rpj & keep
        img_cond = G.normalize_to_neg_one_to_one(
            torch.stack([images_rpj, mask_rpj.float()], dim=-1))

        images = self.diffusion.sample(
            ema, param_cond=param_cond, img_cond=img_cond,
            generator=generator, has_refine_step=has_refine_step,
            x_init=x_init)
        if dc is not None:
            prob2 = dc(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            images = torch.where(prob2 > 0.99, images,
                                 torch.zeros_like(images))

        # back-project the new frame to world: p' = R^T (p - t)
        new_pts, new_valid = G.depth_to_points(images[..., 0] * 10.0,
                                               intrinsic, clip=(0.5, 10.0))
        world = G.rotate_transposed(pose[:, :3, :3],
                                    new_pts - pose[:, None, :3, 3])
        mem_pts_new, mem_valid_new, overflow = P.memory_voxel_update(
            mem_pts, mem_valid, world, new_valid, memory_voxel,
            self.memory_capacity)
        return StepOutputs(pose, images_raw, images_rpj, mask_rpj, images,
                           world, new_valid, mem_pts_new, mem_valid_new,
                           overflow)

    # ------------------------------------------------------------------
    def _scene_source(self, info_train: Dict, abs_scene_idx: int):
        """src/tgt swap by scene index."""
        pool = len(info_train["src"])
        if (abs_scene_idx // pool) % 2 == 0:
            return info_train["src"][abs_scene_idx % pool]
        return info_train["tgt"][abs_scene_idx % pool]

    def _to_host(self, outs: StepOutputs):
        """Queue the copies the host writes need; returns (tensors, event).
        On the card the copies go to pinned buffers behind the step, and
        the event marks them done."""
        keep = (outs.pose, outs.images_raw, outs.images_rpj, outs.images,
                outs.world, outs.world_valid, outs.overflow)
        if self.device.type != "cuda":
            return keep, None
        host = []
        for t in keep:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            host.append(buf)
        event = torch.cuda.Event()
        event.record()
        return tuple(host), event

    def _generator_seed(self, start_scene_index: int) -> int:
        """The seed of the pose and noise stream: rank 0's (and a single
        process's) is ``seed + start``; every other process folds its rank
        in, so the processes draw distinct poses."""
        base = self.seed + start_scene_index
        rank = M.process_index()
        if rank == 0:
            return base
        return int(np.random.SeedSequence([base, rank]).generate_state(1)[0])

    # ------------------------------------------------------------------
    def generate(self, start_scene_index: int, stop_scene_index: int,
                 num_samples: int, *,
                 memory_voxel_size: float = 0.002,
                 save_voxel_size: float = 0.025,
                 has_refine_step: bool = True,
                 info_train: Optional[Dict] = None,
                 scene_indices: Optional[Sequence[int]] = None,
                 verbose: bool = True) -> None:
        """Generate scenes [start, stop) with ``num_samples`` frames each.

        Args:
            scene_indices: the scenes to generate instead of [start, stop):
                under torchrun the CLI passes this process's strided share
                (``parallel.local_scene_range``).

        ``PRGPT_PROFILE=<dir>`` (``utils/profiling.py``): the wall time of
        ``scene_setup`` (a chunk's host set-up), ``dispatch`` (queueing a
        sample step; the card runs it later) and ``host_write`` (waiting
        for a step's outputs and writing them, which overlaps the next
        step on the card), printed at the end, and a trace of the third
        sample step, which the breakdown leaves out.
        """
        cap = self.memory_capacity
        self._load_depth_correction()
        if not self._loaded:
            raise RuntimeError("call load() first")
        # step 0 pays the first launches; one traced step is plenty (each
        # is a whole DDIM chain)
        prof = profiling.loop_profile(1, 3)
        stage = prof.stage if prof is not None else profiling.no_stage
        if info_train is None:
            with open(self.train_info_path, "rb") as f:
                info_train = pickle.load(f)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._generator_seed(start_scene_index))

        if scene_indices is None:
            scene_indices = list(range(start_scene_index, stop_scene_index))
        scene_indices = list(scene_indices)
        for c0 in range(0, len(scene_indices), self.batch_size):
            chunk = scene_indices[c0:c0 + self.batch_size]
            batch = len(chunk)
            # resume: skip a chunk whose every member has its completion
            # marker (cloud index 1, written at the last sample); a partly
            # complete chunk is regenerated whole
            done = [(self.samples_folder /
                     f"scene-{s:0>6d}/sample-000001.cloud.ply").is_file()
                    for s in chunk]
            if all(done):
                if verbose:
                    print("Skip completed scenes "
                          f"{chunk[0]:0>6d} - {chunk[-1]:0>6d}.")
                continue

            intrinsic = np.zeros((batch, 3, 3), np.float32)
            mem_pts = np.zeros((batch, cap, 3), np.float32)
            mem_valid = np.zeros((batch, cap), bool)
            fragment_clouds = [None] * batch
            fragment_poses = [None] * batch
            with stage("scene_setup"):
                self._setup_chunk(chunk, info_train, intrinsic, mem_pts,
                                  mem_valid, save_voxel_size)

            mem_pts_d = torch.from_numpy(mem_pts).to(self.device)
            mem_valid_d = torch.from_numpy(mem_valid).to(self.device)
            intr_d = torch.from_numpy(intrinsic).to(self.device)
            param_cond = G.param_vector(intr_d)

            pending = None  # (sample_idx, host outputs, event) of step k
            for sample_idx in range(num_samples):
                with stage("dispatch"), profiling.annotate("generator_step"):
                    outs = self.step(mem_pts_d, mem_valid_d, intr_d,
                                     param_cond, gen,
                                     has_refine_step=has_refine_step,
                                     memory_voxel=memory_voxel_size)
                    mem_pts_d, mem_valid_d = outs.mem_pts, outs.mem_valid
                    host = (sample_idx,) + self._to_host(outs)
                if pending is not None:
                    with stage("host_write"):
                        self._write_sample_outputs(
                            chunk, pending, num_samples, fragment_clouds,
                            fragment_poses, save_voxel_size, verbose)
                pending = host
                if prof is not None:
                    prof.tick()
            if pending is not None:
                with stage("host_write"):
                    self._write_sample_outputs(
                        chunk, pending, num_samples, fragment_clouds,
                        fragment_poses, save_voxel_size, verbose)
        if prof is not None:
            print(prof.close())

    # ------------------------------------------------------------------
    def _setup_chunk(self, chunk, info_train, intrinsic, mem_pts, mem_valid,
                     save_voxel_size) -> None:
        """Per-scene host setup: real frame -> memory seed, plus
        camera-intrinsics.txt, the sample-0 image and the seed cloud."""
        cap = self.memory_capacity
        for i, sid in enumerate(chunk):
            scene_dir = self.samples_folder / f"scene-{sid:0>6d}"
            if scene_dir.exists():
                shutil.rmtree(scene_dir, ignore_errors=True)
            scene_dir.mkdir(parents=True, exist_ok=True)

            rel = self._scene_source(info_train, sid)
            depth01, intr = resolve_frame_record(
                self.data_root, self.folder, rel, self.image_size)
            intrinsic[i] = intr
            np.savetxt(scene_dir / "camera-intrinsics.txt", intr)
            Image.fromarray(imageio16.to_uint8_image(depth01)).save(
                scene_dir / "sample-000000.image.png")

            pc = G.point_cloud_np(depth01 * 10.0, intr, clip=(0.5, 10.0))
            inside = np.all((pc >= BBOX_MIN) & (pc <= BBOX_MAX), axis=-1)
            pc = pc[inside]
            n = min(pc.shape[0], cap)
            mem_pts[i, :n] = pc[:n]
            mem_valid[i, :n] = True
            plyio.write_ply(scene_dir / "sample-000000.cloud.ply",
                            voxel_downsample_host(pc[:n], save_voxel_size))

    # ------------------------------------------------------------------
    def _write_sample_outputs(self, chunk, pending, num_samples,
                              fragment_clouds, fragment_poses,
                              save_voxel_size, verbose) -> None:
        """Host side of one generation step."""
        sample_idx, outs, event = pending
        if event is not None:
            event.synchronize()
        (pose_np, images_raw_np, images_rpj_np, images_np, world_np,
         world_valid_np, overflow_np) = (t.numpy() for t in outs)
        cap = self.memory_capacity
        for i, dropped in enumerate(overflow_np):
            if dropped > 0:
                print(f"WARNING: scene {chunk[i]:0>6d} memory "
                      f"overflow: dropped {int(dropped)} "
                      f"farthest-from-origin voxels (capacity {cap})")

        for i, sid in enumerate(chunk):
            scene_dir = self.samples_folder / f"scene-{sid:0>6d}"
            out_idx = sample_idx + 1
            np.savetxt(scene_dir / f"sample-{out_idx:0>6d}.pose.txt",
                       np.linalg.inv(pose_np[i]))
            Image.fromarray(imageio16.to_uint8_image(images_raw_np[i])).save(
                scene_dir / "reprojected.image.png")
            Image.fromarray(imageio16.to_uint8_image(images_rpj_np[i])).save(
                scene_dir / "corrected.image.png")
            img01 = images_np[i, ..., 0]
            Image.fromarray(imageio16.to_uint8_image(img01)).save(
                scene_dir / f"sample-{out_idx:0>6d}.image.png")
            imageio16.write_depth_png(
                scene_dir / f"sample-{out_idx:0>6d}.depth.png", img01)

            wp = world_np[i][world_valid_np[i]]
            if sample_idx == 0:
                fragment_clouds[i] = wp
                fragment_poses[i] = pose_np[i]
            else:
                fragment_clouds[i] = np.concatenate(
                    [fragment_clouds[i], wp], axis=0)

            if sample_idx == num_samples - 1:
                frag = fragment_clouds[i]
                fpose = fragment_poses[i]
                # to the first-sample camera frame, crop, voxel, back
                cam = frag @ fpose[:3, :3].T + fpose[:3, 3]
                inside = np.all((cam >= BBOX_MIN) & (cam <= BBOX_MAX),
                                axis=-1)
                cam = cam[inside].astype(np.float32)
                if cam.shape[0]:
                    down = voxel_downsample_host(cam, save_voxel_size)
                    inv = np.linalg.inv(fpose)
                    down = down @ inv[:3, :3].T + inv[:3, 3]
                else:
                    down = cam
                plyio.write_ply(scene_dir / "sample-000001.cloud.ply", down)

        if verbose:
            print(f"scenes {chunk[0]}-{chunk[-1]}: "
                  f"{sample_idx + 1}/{num_samples}")
