"""A synthetic 3DMatch tree whose fragment pairs differ by a camera motion.

``write_motion_tree`` renders, for each pair, one depth frame from each
of two camera poses of the same analytic scene: a wall, and a plate
floating in front of it. The poses differ by a few degrees of rotation and
5-15 cm of translation, so reprojecting one frame into the other's view
shows the disocclusions and the points seen through the plate's edges
that the depth-correction MaskUNet learns to mask. The tree has the
layout the 3DMatch readers take:

    rgbd/scene-{s}/camera-intrinsics.txt
    rgbd/scene-{s}/seq-01/frame-{000000,000001}.{depth.png,pose.txt}
    data_root/scene-{s}/{src,tgt}.info.txt      "scene-{s} seq-01 <frame> 0"
    info.pkl                                    {"src": [...], "tgt": [...]}

Depth frames are 480x640 uint16 millimeters, the poses camera-to-world.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image

K = np.array([[585.0, 0.0, 320.0], [0.0, 585.0, 240.0], [0.0, 0.0, 1.0]])
WALL_Z = 3.0  # meters, world frame


def _rotation(axis: np.ndarray, degrees: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(degrees)
    x = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * x + (1 - np.cos(a)) * x @ x


def render_depth(pose: np.ndarray, plate: Tuple[float, float, float, float,
                                                float]) -> np.ndarray:
    """(480, 640) uint16 mm depth of the wall and the plate ``(x0, x1,
    y0, y1, z)`` (world frame) seen from the camera-to-world ``pose``."""
    v, u = np.mgrid[0:480, 0:640].astype(np.float64)
    d_cam = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                      np.ones_like(u)], axis=-1)
    d = d_cam @ pose[:3, :3].T  # world direction of a unit camera depth
    o = pose[:3, 3]
    depth = (WALL_Z - o[2]) / d[..., 2]
    x0, x1, y0, y1, z = plate
    s = (z - o[2]) / d[..., 2]
    px, py = o[0] + s * d[..., 0], o[1] + s * d[..., 1]
    on_plate = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1) & (s > 0)
    depth = np.where(on_plate & (s < depth), s, depth)
    return np.round(depth * 1000.0).astype(np.uint16)


def write_motion_tree(root: Path, n_pairs: int, seed: int = 0
                      ) -> Tuple[Path, Path, Path, Dict[str, List[str]]]:
    """``n_pairs`` scenes of one src and one tgt fragment each under
    ``root``; returns (rgbd folder, data_root, info pickle, info)."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    rgbd, data_root = root / "rgbd", root / "dataset" / "indoor" / "data"
    info: Dict[str, List[str]] = {"src": [], "tgt": []}
    for s in range(n_pairs):
        name = f"scene-{s}"
        seq = rgbd / name / "seq-01"
        seq.mkdir(parents=True)
        np.savetxt(rgbd / name / "camera-intrinsics.txt", K)
        cx, cy = rng.uniform(-0.4, 0.4, 2)
        plate = (cx - 0.35, cx + 0.35, cy - 0.3, cy + 0.3,
                 rng.uniform(1.4, 2.2))
        src = np.eye(4)
        src[:3, 3] = rng.uniform(-0.05, 0.05, 3)
        tgt = np.eye(4)
        tgt[:3, :3] = _rotation(rng.normal(size=3), rng.uniform(2.0, 5.0))
        step = rng.normal(size=3)
        tgt[:3, 3] = src[:3, 3] + step / np.linalg.norm(step) * \
            rng.uniform(0.05, 0.15)
        (data_root / name).mkdir(parents=True)
        for f, (role, pose) in enumerate((("src", src), ("tgt", tgt))):
            Image.fromarray(render_depth(pose, plate)).save(
                seq / f"frame-{f:06d}.depth.png")
            np.savetxt(seq / f"frame-{f:06d}.pose.txt", pose)
            (data_root / name / f"{role}.info.txt").write_text(
                f"{name} seq-01 {f} 0\n")
            info[role].append(f"{name}/{role}.pth")
    info_path = root / "info.pkl"
    with open(info_path, "wb") as fh:
        pickle.dump(info, fh)
    return rgbd, data_root, info_path, info
