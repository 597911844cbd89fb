"""Camera / depth-map geometry on torch tensors.

Port of ``pointreggpt_tpu/core/geometry.py``. Public functions keep the JAX
layout: points ``(b, n, 3)`` with a ``(b, n)`` bool validity mask, depth
``(b, h, w)`` in meters, intrinsics ``(b, 3, 3)``, poses ``(b, 4, 4)``
applied as ``p' = R p + t``.

3x3 rotations are written as broadcast multiply-adds, never as matmuls, so
they stay true fp32 whatever the TF32 flags say (a rotation rounded to
10 mantissa bits moves splatted pixels).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def intrinsic_transform(
    intrinsic: np.ndarray,
    resize: Optional[Union[int, Tuple[int, int]]] = None,
    centercrop: Optional[Union[int, Tuple[int, int]]] = None,
) -> np.ndarray:
    """Adjust pinhole intrinsics for a resize followed by a center crop.

    Host-side numpy. An int ``resize`` scales the short side to that value
    and the long side proportionally (floor); the image size is inferred as
    ``(2*cy, 2*cx)``.
    """
    intrinsic = np.asarray(intrinsic)
    old_fx = intrinsic[..., 0, 0]
    old_fy = intrinsic[..., 1, 1]
    old_cx = intrinsic[..., 0, 2]
    old_cy = intrinsic[..., 1, 2]

    old_w = np.int32(old_cx * 2)
    old_h = np.int32(old_cy * 2)

    new_fx, new_fy = old_fx, old_fy
    new_cx, new_cy = old_cx, old_cy
    new_w, new_h = old_w, old_h

    if resize is not None:
        if isinstance(resize, (int, np.integer)):
            if np.all(old_w < old_h):
                new_w = np.int32(resize)
                new_h = np.int32(np.floor(resize * old_h / old_w))
            else:
                new_w = np.int32(np.floor(resize * old_w / old_h))
                new_h = np.int32(resize)
        else:
            new_h = np.int32(resize[0])
            new_w = np.int32(resize[1])
        new_fx = np.float32(old_fx * new_w / old_w)
        new_fy = np.float32(old_fy * new_h / old_h)
        new_cx = np.float32(new_w / 2)
        new_cy = np.float32(new_h / 2)

    if centercrop is not None:
        if isinstance(centercrop, (int, np.integer)):
            crop_w = crop_h = int(centercrop)
        else:
            crop_h, crop_w = int(centercrop[0]), int(centercrop[1])
        crop_left = np.int32(np.round((new_w - crop_w) / 2.0))
        crop_top = np.int32(np.round((new_h - crop_h) / 2.0))
        new_cx = new_cx - crop_left
        new_cy = new_cy - crop_top

    out = np.zeros_like(intrinsic, dtype=np.float64)
    out[..., 0, 0] = new_fx
    out[..., 1, 1] = new_fy
    out[..., 0, 2] = new_cx
    out[..., 1, 2] = new_cy
    out[..., 2, 2] = 1.0
    return out.astype(intrinsic.dtype)


def param_vector(intrinsic: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) intrinsic -> (..., 4) [fx, fy, cx, cy]."""
    return torch.stack([intrinsic[..., 0, 0], intrinsic[..., 1, 1],
                        intrinsic[..., 0, 2], intrinsic[..., 1, 2]], dim=-1)


def depth_to_points(
    depth: torch.Tensor,
    intrinsic: torch.Tensor,
    *,
    clip: Optional[Tuple[float, float]] = (0.0, 10.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Back-project (b, h, w) depth to (b, h*w, 3) points + (b, h*w) mask.

    Invalid entries (outside ``clip``) are zeroed and flagged False.
    """
    b, h, w = depth.shape
    fx = intrinsic[:, 0, 0][:, None, None]
    fy = intrinsic[:, 1, 1][:, None, None]
    cx = intrinsic[:, 0, 2][:, None, None]
    cy = intrinsic[:, 1, 2][:, None, None]
    r = torch.arange(h, dtype=depth.dtype, device=depth.device)[None, :, None]
    c = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, None, :]

    if clip is None:
        valid = torch.ones_like(depth, dtype=torch.bool)
    else:
        valid = (depth > clip[0]) & (depth < clip[1])
    zero = depth.new_zeros(())
    z = torch.where(valid, depth, zero)
    x = torch.where(valid, (c - cx) * z / fx, zero)
    y = torch.where(valid, (r - cy) * z / fy, zero)
    points = torch.stack([x, y, z], dim=-1).reshape(b, h * w, 3)
    return points, valid.reshape(b, h * w)


def points_to_depth(
    points: torch.Tensor,
    valid: torch.Tensor,
    intrinsic: torch.Tensor,
    *,
    image_size: Sequence[int] = (480, 640),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Z-buffer splat: nearest point wins per pixel (scatter-min).

    ``scatter_reduce_(..., "amin", include_self=False)`` over ``b*h*w``
    flat indices, the reference's own op; the mask is a second scatter of
    ``ok``. Points that miss the image go to slot 0 with a +inf payload.

    Returns:
        depth (b, h, w) float32, 0 where no point landed; mask (b, h, w).
    """
    b, n, _ = points.shape
    h, w = int(image_size[0]), int(image_size[1])
    fx = intrinsic[:, 0, 0][:, None]
    fy = intrinsic[:, 1, 1][:, None]
    cx = intrinsic[:, 0, 2][:, None]
    cy = intrinsic[:, 1, 2][:, None]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    z_safe = torch.where(z == 0, torch.ones_like(z), z)
    # torch.round is round-half-to-even, like jnp.round
    c = torch.round(x * fx / z_safe + cx).to(torch.int64)
    r = torch.round(y * fy / z_safe + cy).to(torch.int64)
    ok = valid & (c >= 0) & (c < w) & (r >= 0) & (r < h) & (z > 0)

    base = torch.arange(b, device=points.device)[:, None] * (h * w)
    idx = (base + torch.where(ok, r * w + c, torch.zeros_like(c))).reshape(-1)
    payload = torch.where(ok, z, torch.full_like(z, float("inf")))
    depth = torch.full((b * h * w,), float("inf"), dtype=torch.float32,
                       device=points.device)
    depth.scatter_reduce_(0, idx, payload.reshape(-1).float(), "amin",
                          include_self=False)
    hit = torch.zeros((b * h * w,), dtype=torch.float32,
                      device=points.device)
    hit.scatter_reduce_(0, idx, ok.reshape(-1).float(), "amax",
                        include_self=True)
    mask = hit > 0
    depth = torch.where(mask, depth, torch.zeros_like(depth))
    return depth.reshape(b, h, w), mask.reshape(b, h, w)


def rotate(rot: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``R p`` for (b, 3, 3) rotations and (b, n, 3) points, as fp32
    multiply-adds."""
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    return (rot[:, None, :, 0] * x + rot[:, None, :, 1] * y +
            rot[:, None, :, 2] * z)


def rotate_transposed(rot: torch.Tensor, points: torch.Tensor
                      ) -> torch.Tensor:
    """``R^T p`` for (b, 3, 3) rotations and (b, n, 3) points."""
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    return (rot[:, None, 0, :] * x + rot[:, None, 1, :] * y +
            rot[:, None, 2, :] * z)


def transform_points(points: torch.Tensor, pose: torch.Tensor
                     ) -> torch.Tensor:
    """Apply SE(3) poses ``p' = R p + t``; points (b, n, 3), pose
    (b, 4, 4) or (b, 3, 4)."""
    return rotate(pose[:, :3, :3], points) + pose[:, None, :3, 3]


def reproject(
    depth: torch.Tensor,
    intrinsic: torch.Tensor,
    relative_pose: torch.Tensor,
    *,
    clip: Optional[Tuple[float, float]] = (0.0, 10.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, h, w) depth in meters seen from another camera pose: back-project,
    apply the (b, 4, 4) ``relative_pose``, z-buffer at the same (b, 3, 3)
    intrinsics. Returns (depth (b, h, w), mask (b, h, w))."""
    b, h, w = depth.shape
    points, valid = depth_to_points(depth, intrinsic, clip=clip)
    points = transform_points(points, relative_pose)
    return points_to_depth(points, valid, intrinsic, image_size=(h, w))


def min_pool(depth: torch.Tensor, *, window: int = 3,
             stride: int = 1) -> torch.Tensor:
    """Min-pool with +inf padding ("SAME") over (b, h, w)."""
    pad = (window - 1) // 2
    return -F.max_pool2d(-depth[:, None], window, stride, pad)[:, 0]


def occlusion_filter(depth_rpj: torch.Tensor, mask_rpj: torch.Tensor, *,
                     threshold: float = 0.0375
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Suppress see-through speckle after re-projection: a pixel more than
    ``threshold`` above the minimum of its valid 3x3 neighbourhood takes
    that minimum. The mask passes through unchanged.

    Args:
        depth_rpj: (b, h, w) meters.  mask_rpj: (b, h, w) bool.
    """
    depth_pre = torch.where(mask_rpj, depth_rpj,
                            torch.full_like(depth_rpj, float("inf")))
    min_neighbors = min_pool(depth_pre, window=3, stride=1)
    keep = (depth_rpj - min_neighbors) < threshold
    return torch.where(keep, depth_rpj, min_neighbors), mask_rpj


def normalize_to_neg_one_to_one(img: torch.Tensor) -> torch.Tensor:
    return img * 2.0 - 1.0


def unnormalize_to_zero_to_one(img: torch.Tensor) -> torch.Tensor:
    return (img + 1.0) * 0.5


def image_condition(
    depth01: torch.Tensor,
    intrinsic: torch.Tensor,
    relative_pose: torch.Tensor,
    *,
    depth_unit: float = 10.0,
    depth_clip: Tuple[float, float] = (0.0, 10.0),
    use_occlusion_filter: bool = False,
) -> torch.Tensor:
    """The 2-channel DDNM condition: the depth re-projected to
    ``relative_pose`` (unit-normalized) and its validity mask, both mapped
    to [-1, 1].

    Args:
        depth01: (b, h, w) depth in [0, 1] model units (1.0 == depth_unit m).

    Returns:
        (b, h, w, 2) in [-1, 1] (NHWC).
    """
    depth_rpj, mask_rpj = reproject(depth01 * depth_unit, intrinsic,
                                    relative_pose, clip=depth_clip)
    if use_occlusion_filter:
        depth_rpj, mask_rpj = occlusion_filter(depth_rpj, mask_rpj)
    cond = torch.stack([depth_rpj / depth_unit, mask_rpj.to(depth_rpj.dtype)],
                       dim=-1)
    return normalize_to_neg_one_to_one(cond)


def null_image_condition(batch_size: int, image_size: int,
                         dtype: torch.dtype = torch.float32,
                         device: Union[str, torch.device, None] = None
                         ) -> torch.Tensor:
    """The all -1 condition: an empty mask (unconditional)."""
    return -torch.ones((batch_size, image_size, image_size, 2), dtype=dtype,
                       device=device)


def mask_from_image_condition(img_cond: torch.Tensor) -> torch.Tensor:
    """(b, h, w, 2) condition in [-1, 1] -> (b, h, w) bool validity mask."""
    return unnormalize_to_zero_to_one(img_cond[..., 1]) > 0.5


def point_cloud_np(depth: np.ndarray,
                   intrinsic: np.ndarray,
                   clip: Tuple[float, float] = (0.0, 10.0)) -> np.ndarray:
    """Back-project one depth map to a compacted (n, 3) array (host)."""
    fx, fy = intrinsic[0][0], intrinsic[1][1]
    cx, cy = intrinsic[0][2], intrinsic[1][2]
    rows, cols = depth.shape
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    valid = (depth > clip[0]) & (depth < clip[1])
    z = depth
    x = (c - cx) * z / fx
    y = (r - cy) * z / fy
    pc = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    return pc[valid.reshape(-1)].astype(np.float32)


def depth_image_np(pc: np.ndarray,
                   intrinsic: np.ndarray,
                   image_size: Tuple[int, int] = (480, 640)
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Forward-project an (n, 3) host point array to a depth image and its
    mask (host): pixels indexed ``[row, col]``, the nearest point wins a
    pixel. The device path is :func:`points_to_depth`.

    Returns:
        (depth (h, w) float32, 0 where empty; mask (h, w) bool).
    """
    rows, cols = image_size
    fx, fy = intrinsic[0][0], intrinsic[1][1]
    cx, cy = intrinsic[0][2], intrinsic[1][2]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.round(x * fx / np.where(z == 0, 1, z) + cx).astype(np.int64)
        r = np.round(y * fy / np.where(z == 0, 1, z) + cy).astype(np.int64)
    ok = (c >= 0) & (c < cols) & (r >= 0) & (r < rows) & (z > 0)
    depth = np.full((rows, cols), np.inf, np.float32)
    np.minimum.at(depth, (r[ok], c[ok]), z[ok].astype(np.float32))
    mask = np.isfinite(depth)
    return np.where(mask, depth, 0.0).astype(np.float32), mask
