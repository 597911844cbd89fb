"""Plain reference of the generation step's geometry: the scene memory
splatted into the sampled camera (the DDNM condition), back-projection of a
sampled frame to the world, the voxel grid (Open3D's: origin at the
cloud's minimum less half a voxel, one centroid per occupied voxel), the
scene memory after a sample, and the fragment cloud that is written.

Rotations are products (``rnd`` rounds their operands), so the control's
lower precision reaches every point.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor
BBOX_MIN = (-1.5, -1.5, 0.5)
BBOX_MAX = (1.5, 1.5, 3.5)


def splat(points: Tensor, valid: Tensor, pose: Tensor, intrinsic: Tensor,
          size: int, rnd) -> Tensor:
    """The scene memory seen from the sampled camera, as the condition's
    depth: p_cam = R p + t, projected with the intrinsics to the nearest
    pixel (half to even), the nearest point of each pixel (a z-buffer).
    (b, n, 3) world points and (b, n) validity -> (b, size, size) metres,
    0 where no point lands."""
    b, dev = points.shape[0], points.device
    rot, trans = pose[:, :3, :3].float(), pose[:, :3, 3].float()
    cam = rnd.out(torch.matmul(rnd(points.float()),
                               rnd(rot.transpose(1, 2)))) + trans[:, None, :]
    x, y, z = cam.unbind(-1)
    fx, fy = intrinsic[:, 0, 0, None].float(), intrinsic[:, 1, 1, None].float()
    cx, cy = intrinsic[:, 0, 2, None].float(), intrinsic[:, 1, 2, None].float()
    zs = torch.where(z == 0, torch.ones_like(z), z)
    col = torch.round(x * fx / zs + cx).to(torch.int64)
    row = torch.round(y * fy / zs + cy).to(torch.int64)
    ok = valid & (z > 0) & (col >= 0) & (col < size) & (row >= 0) & \
        (row < size)
    pix = torch.arange(b, device=dev)[:, None] * size * size + \
        row * size + col
    depth = torch.full((b * size * size,), float("inf"), device=dev)
    depth.scatter_reduce_(0, pix[ok], z[ok], "amin")
    depth = torch.where(torch.isinf(depth), torch.zeros_like(depth), depth)
    return depth.reshape(b, size, size)


def splat_gap(got: Tensor, want: Tensor, tol: float) -> float:
    """Pixels where two splats differ, over the pixels the reference's
    covers: one covers a pixel the other does not, or both do at depths
    more than ``tol`` apart."""
    hit_g, hit_w = got > 0, want > 0
    off = (hit_g != hit_w) | (hit_g & hit_w & ((got - want).abs() > tol))
    return float(off.sum()) / max(int(hit_w.sum()), 1)


def back_project(depth_m: Tensor, intrinsic: Tensor, pose: Tensor, rnd,
                 clip=(0.5, 10.0)):
    """(b, h, w) metres in the sampled camera -> world points (b, h*w, 3)
    and validity (b, h*w): p_world = R^T (p_cam - t)."""
    b, h, w = depth_m.shape
    dev = depth_m.device
    rows = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    cols = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    fx, fy = intrinsic[:, 0, 0, None, None], intrinsic[:, 1, 1, None, None]
    cx, cy = intrinsic[:, 0, 2, None, None], intrinsic[:, 1, 2, None, None]
    valid = (depth_m > clip[0]) & (depth_m < clip[1])
    z = torch.where(valid, depth_m, torch.zeros_like(depth_m))
    cam = torch.stack([(cols - cx) * z / fx, (rows - cy) * z / fy, z],
                      dim=-1).reshape(b, h * w, 3)
    cam = torch.where(valid.reshape(b, -1, 1), cam, torch.zeros_like(cam))
    rot, trans = pose[:, :3, :3].float(), pose[:, :3, 3].float()
    world = rnd.out(torch.matmul(rnd(cam - trans[:, None, :]), rnd(rot)))
    return world, valid.reshape(b, h * w)


def voxel_centroids(points: Tensor, voxel: float) -> Tensor:
    """(n, 3) valid points -> (m, 3) centroids of the occupied voxels."""
    if points.shape[0] == 0:
        return points
    origin = points.amin(dim=0) - 0.5 * voxel
    q = torch.floor((points - origin) / voxel).to(torch.int64)
    _, inv = torch.unique(q, dim=0, return_inverse=True)
    m = int(inv.max()) + 1
    sums = torch.zeros((m, 3), dtype=torch.float64, device=points.device)
    sums.index_add_(0, inv, points.double())
    counts = torch.bincount(inv, minlength=m).double()
    return (sums / counts[:, None]).float()


def memory_after(mem: Tensor, world: Tensor, voxel: float,
                 capacity: int) -> Tensor:
    """One scene's memory after a sample: its points and the new frame's,
    voxelized, the ``capacity`` nearest the origin kept."""
    cents = voxel_centroids(torch.cat([mem, world], dim=0), voxel)
    if cents.shape[0] > capacity:
        order = torch.argsort((cents.double() ** 2).sum(-1), stable=True)
        cents = cents[order[:capacity]]
    return cents


def fragment_cloud(world: Tensor, pose: Tensor, voxel: float, rnd) -> Tensor:
    """The cloud written for a one-sample fragment: the new frame's world
    points in the sampled camera's frame, cropped to the box, voxelized,
    and back to the world."""
    rot, trans = pose[:3, :3].float(), pose[:3, 3].float()
    cam = torch.matmul(rnd(world), rnd(rot.T)) + trans
    lo = torch.tensor(BBOX_MIN, device=cam.device)
    hi = torch.tensor(BBOX_MAX, device=cam.device)
    cam = cam[((cam >= lo) & (cam <= hi)).all(dim=-1)]
    down = voxel_centroids(cam, voxel)
    return torch.matmul(rnd(down - trans), rnd(rot))


def set_gap(got: np.ndarray, want: np.ndarray, voxel: float) -> float:
    """Distance between two voxelized clouds, in voxels: the relative gap
    of their point counts plus the largest gap of their mean coordinates
    over the voxel size."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if want.shape[0] == 0:
        return float(got.shape[0])
    if got.shape[0] == 0:
        return float(want.shape[0])
    count = abs(got.shape[0] - want.shape[0]) / want.shape[0]
    mean = np.abs(got.mean(axis=0) - want.mean(axis=0)).max() / voxel
    return float(count + mean)
