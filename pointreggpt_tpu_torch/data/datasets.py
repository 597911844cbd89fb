"""Resolve a 3DMatch train_info fragment record to its first depth frame.

Own copy of ``resolve_frame_record`` from
``pointreggpt_tpu/data/datasets.py``: the ``.pth -> .info.txt`` lookup,
first-line parse, ``frame-%06d.depth.png`` path and the intrinsic
adjustment for the resize + center crop.
"""

from __future__ import annotations

import os

import numpy as np

from pointreggpt_tpu_torch.core import imageio16
from pointreggpt_tpu_torch.core.geometry import intrinsic_transform


def resolve_frame_record(data_root: str, folder: str, rel_path: str,
                         image_size: int, *, with_pose: bool = False):
    """``(depth01, intrinsic)`` or ``(depth01, pose, intrinsic)`` of the
    first frame of a fragment record."""
    info_path = os.path.join(data_root, rel_path.replace(".pth", ".info.txt"))
    with open(info_path, "r") as f:
        first = f.readlines()[0].strip()
    scene_name, seq_name, frame_start_idx, _ = first.split()
    scene_path = os.path.join(folder, scene_name)
    frame_path = os.path.join(
        scene_path, seq_name,
        "frame-{:0>6d}.depth.png".format(int(frame_start_idx)))
    image = imageio16.load_depth_model_space(frame_path, image_size)
    intrinsic = intrinsic_transform(
        np.loadtxt(os.path.join(scene_path, "camera-intrinsics.txt")),
        resize=image_size, centercrop=image_size,
    ).astype(np.float32)
    if with_pose:
        pose = np.loadtxt(frame_path.replace("depth.png", "pose.txt"))
        return image, pose, intrinsic
    return image, intrinsic
