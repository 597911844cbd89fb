"""Tester: qualitative successive scene synthesis on torch + CUDA.

Port of ``pointreggpt_tpu/generate/tester.py``:

- ``sample``: an unconditional first frame, then successive frames under a
  fixed forward motion (t = [0, 0, 0.5]); per step a triptych PNG
  (previous | reprojected | generated) and a PLY in the accumulated world
  frame, and one ``overview.png`` of every scene;
- ``generate``: the same with a voxel-downsampled scene memory that grows
  with each frame and is splatted under a random FoV-bounded rotation;
  ``scene-{sid}.ply`` (voxel 0.025) and ``scene-{sid}-memory.ply`` at the
  end;
- ``sample_uncondition``: one unconditional grid.

The device work of a step (reproject or splat, occlusion filter, condition
image, sampling chain, memory update) queues on the card; the host writes
PNG and PLY files. The PNGs go through PIL and the colormap tables of
:mod:`pointreggpt_tpu_torch.core.colormaps`. The FID helpers
(``compute_inception_features``, ``calculate_activation_statistics``,
``fid_score``) run the port's InceptionV3 on the same device
(:mod:`pointreggpt_tpu_torch.eval.fid`).

Under torchrun (:mod:`pointreggpt_tpu_torch.parallel.mesh`) a batch holds
``batch_size`` scenes per process, split in contiguous blocks as
``np.array_split`` splits them (a tail batch may leave a process idle).
Every process makes the batch's random draws (intrinsics, x_T, the
chain's noise, the poses) for the whole batch and keeps its rows, so N
processes draw what one process draws; each writes its own scenes' files,
named by global scene id, and rank 0 gathers the rows of ``overview.png``
and writes it once. ``compute_inception_features`` splits its images the
same way and gathers the features on rank 0.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
from PIL import Image

from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.core import colormaps
from pointreggpt_tpu_torch.core import geometry as G
from pointreggpt_tpu_torch.core import plyio
from pointreggpt_tpu_torch.core import pointops as P
from pointreggpt_tpu_torch.core import sampling as S
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.generate.generator import (load_ema_unet,
                                                      place_for_inference)
from pointreggpt_tpu_torch.parallel import mesh as M
from pointreggpt_tpu_torch.train import checkpoint as ckpt

SAVE_VOXEL = 0.025  # scene-{sid}.ply


def _imsave(path, vis: np.ndarray, cmap: str) -> None:
    """A [0, 1] image (clipped) to an RGBA PNG through ``cmap`` (``gray``
    in ``sample``, ``plasma`` in ``generate``)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(colormaps.to_rgba(np.clip(vis, 0.0, 1.0), cmap),
                    "RGBA").save(path)


def save_triptych(path, image_prev: np.ndarray, image_rpj: np.ndarray,
                  image_new: np.ndarray, cmap: str = "gray") -> np.ndarray:
    """Save [prev | reprojected | new] as one PNG; returns the row, for
    the overview grid."""
    vis = np.concatenate([image_prev, image_rpj, image_new], axis=-1)
    _imsave(path, vis, cmap)
    return vis


class TesterStep(NamedTuple):
    depth_rpj: torch.Tensor  # (b, h, w) meters, after the occlusion filter
    img_cond: torch.Tensor   # (b, h, w, 2) condition in [-1, 1]
    images: torch.Tensor     # (b, h, w, 1) sampled, [0, 1]


class Tester:
    """Successive-generation sampler around a trained diffusion model.

    Args:
        model: DiffusionUNet (fp32 params; baked for its compute dtype at
            :meth:`load`).
        diffusion: the sampling process (32-step DDIM, eta 1, in the CLI).
        batch_size: scenes a batch on each process's GPU (the JAX
            package's is per host, split over its chips).
        device: ``cuda`` unless asked otherwise (see ``resolve_device``).
    """

    def __init__(self, model, diffusion: GaussianDiffusion, *,
                 batch_size: int = 16,
                 results_folder: str = "./results",
                 samples_folder: str = "./samples",
                 seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.diffusion = diffusion
        self.batch_size = batch_size
        self.image_size = diffusion.image_size
        self.results_folder = Path(results_folder)
        self.samples_folder = Path(samples_folder)
        self.samples_folder.mkdir(parents=True, exist_ok=True)
        self.seed = seed
        self.ema_model = None  # baked, on the device
        self._inception = None  # built on the first FID call

    # ------------------------------------------------------------------
    def load(self, milestone) -> None:
        """Load the EMA U-Net of ``model-{milestone}.pt`` (or of the JAX
        package's ``model-{milestone}.ckpt``), baked and on the device, as
        the Generator places it."""
        load_ema_unet(self.model,
                      ckpt.milestone_path(self.results_folder, milestone))
        self.ema_model = place_for_inference(self.model, self.device)

    # ------------------------------------------------------------------
    # FID helpers (the reference Tester's)
    def compute_inception_features(self, samples01: np.ndarray
                                   ) -> Optional[np.ndarray]:
        """(n, h, w, 1|3) [0, 1] images -> (n, 2048) activations. Under
        torchrun each process computes its block of the images and rank 0
        gets all n rows (the other processes None)."""
        from pointreggpt_tpu_torch.eval.fid import InceptionFeatures

        if self._inception is None:
            self._inception = InceptionFeatures(device=self.device)
        samples01 = np.asarray(samples01)
        rows = M.rank_rows(samples01.shape[0])
        parts = M.gather_to_main(self._inception(rows.take(samples01)))
        return None if parts is None else np.concatenate(parts, axis=0)

    @staticmethod
    def calculate_activation_statistics(features: np.ndarray):
        """(n, d) activations -> (mu, sigma)."""
        from pointreggpt_tpu_torch.eval.fid import activation_statistics

        return activation_statistics(features)

    def fid_score(self, real_features: np.ndarray,
                  fake_features: np.ndarray) -> float:
        """FID between two activation sets."""
        from pointreggpt_tpu_torch.eval.fid import calculate_frechet_distance

        m1, s1 = self.calculate_activation_statistics(real_features)
        m2, s2 = self.calculate_activation_statistics(fake_features)
        return calculate_frechet_distance(m1, s1, m2, s2)

    # ------------------------------------------------------------------
    def _ema(self):
        if self.ema_model is None:
            raise RuntimeError("call load() first")
        return self.ema_model

    def _generator(self) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        return gen

    def _random_intrinsics(self, generator: torch.Generator,
                           batch: int) -> np.ndarray:
        intr = S.random_sample_intrinsic(generator, batch).cpu().numpy()
        return G.intrinsic_transform(
            intr, resize=self.image_size,
            centercrop=self.image_size).astype(np.float32)

    def _batches(self, num_scenes: int):
        """(first global scene id, this process's rows) of each batch of
        ``batch_size`` scenes per process."""
        per = self.batch_size * M.process_count()
        for first in range(0, num_scenes, per):
            yield first, M.rank_rows(min(per, num_scenes - first))

    @staticmethod
    def _condition(depth: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
        return G.normalize_to_neg_one_to_one(
            torch.stack([depth * 0.1, mask.float()], dim=-1))

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self, images: torch.Tensor, intrinsic: torch.Tensor,
             param_cond: torch.Tensor, relative_pose: torch.Tensor,
             apply_occlusion: bool,
             generator: Optional[torch.Generator] = None, *,
             x_init: Optional[torch.Tensor] = None,
             rows: Optional[M.Rows] = None) -> TesterStep:
        """One successive frame for a batch: reproject the previous frame
        ``images`` (b, h, w, 1) under ``relative_pose``, filter occlusions
        when ``apply_occlusion``, build the condition image and run the
        chain. ``x_init`` overrides the x_T draw (tests); ``rows``: the
        batch's rows of a global batch, whose draws the chain makes."""
        depth, mask = G.reproject(images[..., 0] * 10.0, intrinsic,
                                  relative_pose)
        if apply_occlusion:
            depth, mask = G.occlusion_filter(depth, mask)
        img_cond = self._condition(depth, mask)
        out = self.diffusion.sample(self._ema(), param_cond=param_cond,
                                    img_cond=img_cond, generator=generator,
                                    x_init=x_init, rows=rows)
        return TesterStep(depth, img_cond, out)

    def _sample_uncond(self, param_cond: torch.Tensor,
                       generator: torch.Generator,
                       rows: Optional[M.Rows] = None) -> torch.Tensor:
        return self.diffusion.sample(self._ema(), param_cond=param_cond,
                                     generator=generator, rows=rows)

    def _write_overview(self, rows_here, cmap: str) -> None:
        """Rank 0 writes every process's overview rows, in scene order."""
        parts = M.gather_to_main(rows_here)
        if parts is None:
            return
        overview_rows = [r for part in parts for r in part]
        if overview_rows:
            _imsave(self.samples_folder / "overview.png",
                    np.concatenate(overview_rows, axis=0), cmap)

    # ------------------------------------------------------------------
    def sample_uncondition(self, num_samples: int = 25
                           ) -> Optional[np.ndarray]:
        """An unconditional grid, ``unconditional.png``; returns its
        images (under torchrun each process samples its block, and rank 0
        writes and returns the grid; the others return None)."""
        from pointreggpt_tpu_torch.train.trainer import save_image_grid

        gen = self._generator()
        rows = M.rank_rows(num_samples)
        intrinsic = rows.take(self._random_intrinsics(gen, num_samples))
        param_cond = G.param_vector(
            torch.from_numpy(intrinsic).to(self.device))
        h, c = self.image_size, self.diffusion.channels
        images = (self._sample_uncond(param_cond, gen, rows).cpu().numpy()
                  if rows.size else np.zeros((0, h, h, c), np.float32))
        parts = M.gather_to_main(images)
        if parts is None:
            return None
        images = np.concatenate(parts, axis=0)
        save_image_grid(images, self.samples_folder / "unconditional.png",
                        nrow=int(math.isqrt(num_samples)))
        return images

    # ------------------------------------------------------------------
    def sample(self, num_scenes: int, num_samples: int) -> None:
        """Successive conditional generation under a fixed forward motion."""
        gen = self._generator()
        overview_rows = []  # one triptych strip per scene
        for first, rows in self._batches(num_scenes):
            batch = rows.size
            intrinsic = rows.take(self._random_intrinsics(gen, rows.total))
            if batch == 0:
                continue  # an idle process in the last batch
            intr_d = torch.from_numpy(intrinsic).to(self.device)
            param_cond = G.param_vector(intr_d)
            absolute_pose = np.tile(np.eye(4, dtype=np.float32),
                                    (batch, 1, 1))

            images_d = self._sample_uncond(param_cond, gen, rows)
            images = images_d.cpu().numpy()

            scene_rows = [[] for _ in range(batch)]
            for scene_idx in range(batch):
                sid = first + rows.start + scene_idx
                img = images[scene_idx, ..., 0]
                scene_rows[scene_idx].append(save_triptych(
                    self.samples_folder / f"scene-{sid}-sample-0.png",
                    np.zeros_like(img), np.zeros_like(img), img))
                pc = G.point_cloud_np(img * 10, intrinsic[scene_idx],
                                      clip=(0.5, 3.5))
                plyio.write_ply(
                    self.samples_folder / f"scene-{sid}-sample-0.ply", pc)
                np.savetxt(
                    self.samples_folder /
                    f"scene-{sid}-camera-intrinsics.txt",
                    intrinsic[scene_idx])

            for sample_idx in range(1, num_samples):
                relative_pose = np.tile(np.eye(4, dtype=np.float32),
                                        (batch, 1, 1))
                relative_pose[:, :3, 3] = [0.0, 0.0, 0.5]
                absolute_pose = relative_pose @ absolute_pose
                apply_occ = bool(np.sum(absolute_pose[..., :3, 3]**2) != 0)

                out = self.step(images_d, intr_d, param_cond,
                                torch.from_numpy(relative_pose).to(
                                    self.device), apply_occ, gen, rows=rows)
                images_rpj = out.depth_rpj.cpu().numpy() * 0.1
                images_last = images
                images_d = out.images
                images = images_d.cpu().numpy()

                for scene_idx in range(batch):
                    sid = first + rows.start + scene_idx
                    scene_rows[scene_idx].append(save_triptych(
                        self.samples_folder /
                        f"scene-{sid}-sample-{sample_idx}.png",
                        images_last[scene_idx, ..., 0],
                        images_rpj[scene_idx],
                        images[scene_idx, ..., 0]))
                    pc = G.point_cloud_np(images[scene_idx, ..., 0] * 10,
                                          intrinsic[scene_idx],
                                          clip=(0.5, 3.5))
                    # accumulated world frame: p' = (p - t) @ R
                    pc = (pc - absolute_pose[scene_idx, :3, 3]) @ \
                        absolute_pose[scene_idx, :3, :3]
                    plyio.write_ply(
                        self.samples_folder /
                        f"scene-{sid}-sample-{sample_idx}.ply", pc)

            overview_rows += [np.concatenate(r, axis=-1)
                              for r in scene_rows]

        self._write_overview(overview_rows, "gray")

    # ------------------------------------------------------------------
    def _splat_memory(self, mem_pts, mem_valid, pose, intrinsic):
        """Depth of the memory seen under ``pose``, occlusion-filtered, and
        its condition image."""
        H = self.image_size
        pts = G.transform_points(mem_pts, pose)
        depth, mask = G.points_to_depth(pts, mem_valid, intrinsic,
                                        image_size=(H, H))
        depth, mask = G.occlusion_filter(depth, mask)
        return depth, self._condition(depth, mask)

    @staticmethod
    def _update_memory(mem_pts, mem_valid, images, pose, intrinsic,
                       voxel_size: float, capacity: int):
        """Back-project the new frame to the world (p' = R^T (p - t)) and
        merge it into the memory; returns (points, valid, overflow)."""
        new_pts, new_valid = G.depth_to_points(
            images[..., 0] * 10.0, intrinsic, clip=(0.5, 10.0))
        world = G.rotate_transposed(pose[:, :3, :3],
                                    new_pts - pose[:, None, :3, 3])
        return P.memory_voxel_update(mem_pts, mem_valid, world, new_valid,
                                     voxel_size, capacity)

    @torch.inference_mode()
    def generate(self, num_scenes: int, num_samples: int,
                 voxel_size: float = 0.005,
                 memory_capacity: int = 1 << 18) -> None:
        """Scene-memory successive generation: each step splats the
        accumulated memory under a random FoV-bounded rotation."""
        gen = self._generator()
        overview_rows = []  # plasma overview grid rows
        for first, rows in self._batches(num_scenes):
            batch = rows.size
            # the whole batch's intrinsics: the pose draws depend on them
            intr_all_d = torch.from_numpy(
                self._random_intrinsics(gen, rows.total)).to(self.device)
            if batch == 0:
                continue  # an idle process in the last batch
            intr_d = rows.take(intr_all_d)
            param_cond = G.param_vector(intr_d)

            images_d = self._sample_uncond(param_cond, gen, rows)
            images = images_d.cpu().numpy()

            mem_pts, mem_valid = G.depth_to_points(
                images_d[..., 0] * 10.0, intr_d, clip=(0.5, 10.0))
            # a seed frame larger than the memory keeps its points
            # nearest the origin, as the running memory does
            mem_pts, mem_valid, _ = P.keep_nearest(mem_pts, mem_valid,
                                                   memory_capacity)

            scene_rows = [[] for _ in range(batch)]
            for scene_idx in range(batch):
                sid = first + rows.start + scene_idx
                img = images[scene_idx, ..., 0]
                scene_rows[scene_idx].append(save_triptych(
                    self.samples_folder / f"scene-{sid}-sample-0.png",
                    np.zeros_like(img), np.zeros_like(img), img,
                    cmap="plasma"))

            for sample_idx in range(1, num_samples):
                pose = rows.take(S.random_sample_transform(
                    gen, intr_all_d, self.image_size))
                depth_rpj, img_cond = self._splat_memory(
                    mem_pts, mem_valid, pose, intr_d)
                images_rpj = depth_rpj.cpu().numpy() * 0.1
                images_last = images
                images_d = self.diffusion.sample(
                    self._ema(), param_cond=param_cond, img_cond=img_cond,
                    generator=gen, rows=rows)
                images = images_d.cpu().numpy()
                mem_pts, mem_valid, overflow = self._update_memory(
                    mem_pts, mem_valid, images_d, pose, intr_d, voxel_size,
                    memory_capacity)
                for scene_idx, dropped in enumerate(overflow.cpu().numpy()):
                    if dropped > 0:
                        sid = first + rows.start + scene_idx
                        print(f"WARNING: scene {sid} memory overflow: "
                              f"dropped {int(dropped)} farthest voxels "
                              f"(capacity {memory_capacity})")

                for scene_idx in range(batch):
                    sid = first + rows.start + scene_idx
                    scene_rows[scene_idx].append(save_triptych(
                        self.samples_folder /
                        f"scene-{sid}-sample-{sample_idx}.png",
                        images_last[scene_idx, ..., 0],
                        images_rpj[scene_idx], images[scene_idx, ..., 0],
                        cmap="plasma"))

            # the final clouds: scene-{sid}.ply at voxel 0.025, and the
            # full-resolution memory
            save_pts, save_valid = P.voxel_downsample_batched(
                mem_pts, mem_valid, SAVE_VOXEL)
            save_np, savev_np = save_pts.cpu().numpy(), \
                save_valid.cpu().numpy()
            mem_np, memv_np = mem_pts.cpu().numpy(), mem_valid.cpu().numpy()
            for scene_idx in range(batch):
                sid = first + rows.start + scene_idx
                plyio.write_ply(
                    self.samples_folder / f"scene-{sid}.ply",
                    save_np[scene_idx][savev_np[scene_idx]])
                plyio.write_ply(
                    self.samples_folder / f"scene-{sid}-memory.ply",
                    mem_np[scene_idx][memv_np[scene_idx]])

            overview_rows += [np.concatenate(r, axis=-1)
                              for r in scene_rows]

        self._write_overview(overview_rows, "plasma")
