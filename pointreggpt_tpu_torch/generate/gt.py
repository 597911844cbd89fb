"""gt.log: pairwise overlap ratios of generated PLY fragments.

Port of ``pointreggpt_tpu/generate/gt.py``. For every scene, every pair of
sample clouds: skip a cloud under ``min_points`` points, compute the
bidirectional overlap (voxel 0.025, radius x 1.5), keep pairs whose ratios
hold no NaN and reach ``min_overlap`` in one direction, write the
per-scene TSV ``gt.log``, then concatenate them into ``metadata/gt.log``.

Each scene's clouds are read and voxel-downsampled once, in one batched
call, and all its pairs are scored in one batched call of
:func:`pointreggpt_tpu_torch.core.pointops.overlap_ratio`. The clouds are
zero-padded to the scene's largest; the JAX package's power-of-two buckets
only bounded its compiles.
"""

from __future__ import annotations

import os
from itertools import combinations
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.core import plyio
from pointreggpt_tpu_torch.core import pointops as P

MIN_POINTS = 1000
MIN_OVERLAP = 0.1


def _stack(clouds: List[np.ndarray], device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Host clouds -> (k, n_max, 3) zero-padded points, (k, n_max) valid."""
    n = max(1, max(c.shape[0] for c in clouds))
    pts = np.zeros((len(clouds), n, 3), np.float32)
    valid = np.zeros((len(clouds), n), bool)
    for i, c in enumerate(clouds):
        pts[i, :c.shape[0]] = c
        valid[i, :c.shape[0]] = True
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(valid).to(device))


def compute_overlap_ratio_np(pc1: np.ndarray, pc2: np.ndarray, *,
                             voxel_size: float = 0.025,
                             overlap_factor: float = 1.5,
                             device=None) -> Tuple[float, float]:
    """Bidirectional overlap between two host clouds, on ``device``."""
    pts, valid = _stack([np.asarray(pc1, np.float32),
                         np.asarray(pc2, np.float32)], resolve_device(device))
    ov1, ov2 = P.overlap_ratio(pts[0], valid[0], pts[1], valid[1],
                               voxel_size=voxel_size,
                               overlap_factor=overlap_factor)
    return float(ov1), float(ov2)


def score_pairs(clouds: dict, pair_list, *, voxel_size: float,
                overlap_factor: float, device) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """Overlap ratios of ``pair_list`` over the host ``clouds`` ({index:
    (n, 3)}): each cloud downsampled once, then every pair in one call."""
    idx = sorted(clouds)
    pts, valid = _stack([clouds[i] for i in idx], device)
    down, down_ok = P.voxel_downsample_batched(pts, valid, voxel_size)
    # the occupied voxels are a leading prefix: cut the padding to the
    # largest downsampled cloud before the pairwise products
    n_down = max(1, int(down_ok.sum(dim=1).max()))
    down, down_ok = down[:, :n_down], down_ok[:, :n_down]
    row = {c: k for k, c in enumerate(idx)}
    s = torch.tensor([row[a] for a, _ in pair_list], device=device)
    t = torch.tensor([row[b] for _, b in pair_list], device=device)
    ov1, ov2 = P.overlap_ratio(down[s], down_ok[s], down[t], down_ok[t],
                               voxel_size=voxel_size,
                               overlap_factor=overlap_factor,
                               downsample=False)
    return ov1.cpu().numpy(), ov2.cpu().numpy()


def generate_gt(dataset_name: str,
                start_scene_index: int,
                stop_scene_index: int,
                num_samples: int,
                *,
                root: Optional[str] = None,
                min_points: int = MIN_POINTS,
                min_overlap: float = MIN_OVERLAP,
                voxel_size: float = 0.025,
                overlap_factor: float = 1.5,
                verbose: bool = True,
                device=None) -> None:
    """Write per-scene gt.log files (TSV: scene, src, tgt, ov_src, ov_tgt).

    A scene whose gt.log exists is skipped (a rerun resumes).
    """
    device = resolve_device(device)
    root_path = Path(root or f"./{dataset_name}/data")

    for scene_idx in range(start_scene_index, stop_scene_index):
        scene_name = "scene-{:0>6d}".format(scene_idx)
        scene_path = root_path / scene_name
        gt_path = scene_path / "gt.log"

        if gt_path.exists():
            if verbose:
                print("scene gt log has existed, skip over it")
            continue

        clouds = {}
        for idx in range(num_samples):
            ply_path = scene_path / "sample-{:0>6d}.cloud.ply".format(idx)
            if not ply_path.exists():
                continue
            pts = plyio.read_ply(ply_path).astype(np.float32)
            if pts.shape[0] < min_points:
                continue
            clouds[idx] = pts

        pair_list = [(s, t) for s, t in combinations(range(num_samples), 2)
                     if s in clouds and t in clouds]
        gt_infos: List[str] = []
        if pair_list:
            ov1_all, ov2_all = score_pairs(
                clouds, pair_list, voxel_size=voxel_size,
                overlap_factor=overlap_factor, device=device)
            for k, (src_idx, tgt_idx) in enumerate(pair_list):
                ov_src, ov_tgt = float(ov1_all[k]), float(ov2_all[k])
                if verbose:
                    print(f"{scene_name} src:{src_idx:0>2d} "
                          f"tgt:{tgt_idx:0>2d} ov_src:{ov_src:.3f} "
                          f"ov_tgt:{ov_tgt:.3f}")
                if np.isnan(ov_src) or np.isnan(ov_tgt):
                    continue
                if ov_src < min_overlap and ov_tgt < min_overlap:
                    continue
                gt_infos.append("{}\t{}\t{}\t{:.4f}\t{:.4f}\n".format(
                    scene_name, src_idx, tgt_idx, ov_src, ov_tgt))

        gt_path.parent.mkdir(parents=True, exist_ok=True)
        with open(gt_path, "w") as f:
            f.writelines(gt_infos)


def gather_gt(dataset_name: str,
              start_index: int,
              stop_index: int,
              *,
              root: Optional[str] = None,
              metadata: Optional[str] = None) -> None:
    """Concatenate the per-scene gt.log files into metadata/gt.log."""
    root_path = Path(root or f"./{dataset_name}/data")
    final_gt_path = Path(metadata or f"./{dataset_name}/metadata/gt.log")
    final_gt_path.parent.mkdir(parents=True, exist_ok=True)
    if final_gt_path.exists():
        os.remove(final_gt_path)

    with open(final_gt_path, "w") as out:
        for scene_idx in range(start_index, stop_index):
            scene_gt = root_path / "scene-{:0>6d}".format(scene_idx) / "gt.log"
            if scene_gt.exists():
                out.write(scene_gt.read_text())


def parse_gt_log(path) -> List[dict]:
    """Parse a gt.log TSV into record dicts (the registration dataloaders'
    contract)."""
    records = []
    with open(path, "r") as f:
        for line in f.readlines():
            if not line.strip():
                continue
            scene_name, src_idx, tgt_idx, ov_src, ov_tgt = line.split("\t")
            records.append({
                "scene_name": scene_name,
                "src_idx": int(src_idx),
                "tgt_idx": int(tgt_idx),
                "overlap_src": float(ov_src),
                "overlap_tgt": float(ov_tgt),
            })
    return records
