"""Voxel downsampling, the scene-memory update, the nearest-to-origin bound,
the radius overlap and the registration loaders' distances on torch
tensors.

Port of ``crop_bbox``, ``voxel_downsample`` (and its batched form),
``memory_voxel_update``, ``keep_nearest``, ``any_within_radius``,
``overlap_ratio``, ``overlap_region``, ``min_dist_sq`` and
``correspondences_np`` from ``pointreggpt_tpu/core/pointops.py``. The JAX package built the voxel
functions scatter-free for the TPU (packed-key sort + segmented scan); on
the GPU the plain route is a sort and ``index_add_`` sums:

1. quantize with the Open3D origin (per-row min bound minus half a voxel);
2. order the points by voxel ``(qx, qy, qz)`` with three stable sorts
   (a lexsort, so no packed-key range limit), invalid points last;
3. segment ids = cumsum of key changes (what ``unique_consecutive(...,
   return_inverse=True)`` gives, without its host sync), then
   ``index_add_`` sums of points and counts per segment.

Nothing but ``correspondences_np`` (a host-facing call of the loaders)
reads a value back to the host, so a generation step stays asynchronous on the stream and the next step can be queued before the host
writes the previous one.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_SENTINEL = torch.iinfo(torch.int64).max


def _quantize(points: Tensor, valid: Tensor, voxel_size: float) -> Tensor:
    """(b, n, 3) -> (b, n, 3) int64 voxel indices, Open3D origin per row.
    Invalid points get the sentinel so they sort last."""
    big = torch.full_like(points, 1e30)
    origin = torch.where(valid[..., None], points, big).amin(dim=1)
    origin = origin - 0.5 * voxel_size
    q = torch.floor((points - origin[:, None, :]) / voxel_size)
    q = q.to(torch.int64)
    return torch.where(valid[..., None], q, torch.full_like(q, _SENTINEL))


def _voxel_segments(points: Tensor, valid: Tensor, voxel_size: float
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Group (b, n) points by voxel.

    Returns:
        centroid: (b, n, 3) per-segment centroids, segment j of each row in
            voxel-key order at index j (zeros past the last segment).
        seg_ok: (b, n) bool — segment j holds at least one valid point.
        nseg: (b,) int64 occupied-voxel count.
    """
    b, n, _ = points.shape
    q = _quantize(points, valid, voxel_size)
    order = torch.arange(n, device=points.device).expand(b, n)
    for axis in (2, 1, 0):  # stable lexsort: last key first
        key = torch.gather(q[..., axis], 1, order)
        _, perm = torch.sort(key, dim=1, stable=True)
        order = torch.gather(order, 1, perm)
    q_s = torch.gather(q, 1, order[..., None].expand(b, n, 3))
    pts_s = torch.gather(points, 1, order[..., None].expand(b, n, 3))
    w = torch.gather(valid, 1, order).to(points.dtype)

    is_first = torch.ones((b, n), dtype=torch.bool, device=points.device)
    is_first[:, 1:] = (q_s[:, 1:] != q_s[:, :-1]).any(dim=-1)
    seg = torch.cumsum(is_first.to(torch.int64), dim=1) - 1
    flat = (seg + torch.arange(b, device=points.device)[:, None] * n
            ).reshape(-1)
    sums = torch.zeros((b * n, 3), dtype=points.dtype, device=points.device)
    sums.index_add_(0, flat, (pts_s * w[..., None]).reshape(-1, 3))
    counts = torch.zeros((b * n,), dtype=points.dtype, device=points.device)
    counts.index_add_(0, flat, w.reshape(-1))
    sums, counts = sums.reshape(b, n, 3), counts.reshape(b, n)
    seg_ok = counts > 0
    centroid = sums / counts.clamp(min=1.0)[..., None]
    centroid = torch.where(seg_ok[..., None], centroid,
                           torch.zeros_like(centroid))
    return centroid, seg_ok, seg_ok.sum(dim=1)


def crop_bbox(points: Tensor, valid: Tensor, min_bound, max_bound
              ) -> Tensor:
    """``valid`` with the points outside the axis-aligned box
    [min_bound, max_bound] (bounds included) masked out; nothing is
    compacted.

    Args:
        points: (..., n, 3); valid: (..., n) bool; bounds: three values.
    """
    lo = torch.as_tensor(min_bound, dtype=points.dtype, device=points.device)
    hi = torch.as_tensor(max_bound, dtype=points.dtype, device=points.device)
    return valid & ((points >= lo) & (points <= hi)).all(dim=-1)


def voxel_downsample(points: Tensor, valid: Tensor, voxel_size: float
                     ) -> Tuple[Tensor, Tensor]:
    """Voxel-grid downsample (centroid per occupied voxel), padded.

    Args:
        points: (n, 3).  valid: (n,) bool.

    Returns:
        (n, 3) centroids, zero-padded, the occupied voxels a leading prefix
        in voxel-key order; (n,) validity mask.
    """
    centroid, seg_ok, _ = _voxel_segments(points[None], valid[None],
                                          voxel_size)
    return centroid[0], seg_ok[0]


def voxel_downsample_batched(points: Tensor, valid: Tensor,
                             voxel_size: float) -> Tuple[Tensor, Tensor]:
    """:func:`voxel_downsample` of each row, origin per row.

    Args:
        points: (b, n, 3).  valid: (b, n) bool.

    Returns:
        (b, n, 3) centroids, each row's occupied voxels a leading prefix in
        voxel-key order; (b, n) validity mask.
    """
    centroid, seg_ok, _ = _voxel_segments(points, valid, voxel_size)
    return centroid, seg_ok


def keep_nearest(points: Tensor, valid: Tensor, capacity: int
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """Bound a padded cloud to ``capacity`` points, keeping the valid ones
    nearest the origin.

    The output is sorted by squared distance to the origin (invalid points
    last), ties broken by index with a stable sort, as ``lax.top_k`` breaks
    them in the JAX package. The JAX package skips the sort when no row
    overflows and keeps the valid points in their input order instead: the
    same points, in another order. When ``capacity >= n`` the cloud is only
    padded, as there.

    Args:
        points: (..., n, 3).  valid: (..., n) bool.

    Returns:
        (..., capacity, 3) points, (..., capacity) bool, and (...,) int64
        overflow: the number of valid points dropped.
    """
    n = points.shape[-2]
    occupied = valid.sum(dim=-1)
    if capacity >= n:
        pad = capacity - n
        points = torch.cat(
            [points, points.new_zeros(points.shape[:-2] + (pad, 3))], dim=-2)
        valid = torch.cat(
            [valid, valid.new_zeros(valid.shape[:-1] + (pad,))], dim=-1)
        return points, valid, torch.zeros_like(occupied)
    d2 = (points * points).sum(dim=-1)
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    _, order = torch.sort(d2, dim=-1, stable=True)
    order = order[..., :capacity]
    out = torch.gather(points, -2,
                       order[..., None].expand(order.shape + (3,)))
    return (out, torch.gather(valid, -1, order),
            (occupied - capacity).clamp(min=0))


def memory_voxel_update(
    mem_pts: Tensor,
    mem_valid: Tensor,
    new_pts: Tensor,
    new_valid: Tensor,
    voxel_size: float,
    capacity: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Merge a new frame into the scene memory, voxel-downsample the union,
    keep the ``capacity`` centroids nearest the origin.

    Output is sorted by squared distance to the origin, ties broken stably
    in voxel-key order; ``overflow = max(nseg - capacity, 0)``. When
    ``capacity >= n`` nothing is selected: the voxel-order centroids are
    padded to ``capacity``, as the JAX package's composition does.

    Args:
        mem_pts: (b, m, 3); mem_valid: (b, m); new_pts: (b, k, 3);
        new_valid: (b, k) bool.

    Returns:
        (b, capacity, 3) points, (b, capacity) bool, (b,) int64 overflow.
    """
    pts = torch.cat([mem_pts, new_pts], dim=1)
    valid = torch.cat([mem_valid, new_valid], dim=1)
    b, n, _ = pts.shape
    centroid, seg_ok, nseg = _voxel_segments(pts, valid, voxel_size)
    if capacity >= n:
        pad = capacity - n
        out = torch.cat([centroid, centroid.new_zeros((b, pad, 3))], dim=1)
        out_valid = torch.cat([seg_ok, seg_ok.new_zeros((b, pad))], dim=1)
        return out, out_valid, torch.zeros_like(nseg)

    d2 = (centroid * centroid).sum(dim=-1)
    key = torch.where(seg_ok, d2, torch.full_like(d2, float("inf")))
    key_s, order = torch.sort(key, dim=1, stable=True)
    order = order[:, :capacity]
    out = torch.gather(centroid, 1, order[..., None].expand(b, capacity, 3))
    out_valid = torch.isfinite(key_s[:, :capacity])
    out = torch.where(out_valid[..., None], out, torch.zeros_like(out))
    return out, out_valid, (nseg - capacity).clamp(min=0)


def _sq_norm(p: Tensor) -> Tensor:
    """|p|^2 over the last axis of (..., 3), summed x, y, z in order."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return x * x + y * y + z * z


def any_within_radius(src: Tensor, src_valid: Tensor, tgt: Tensor,
                      tgt_valid: Tensor, radius: float, *,
                      block: int = 512) -> Tensor:
    """For each valid src point: does any valid tgt point lie within
    ``radius``?

    The JAX package's blocked formula: ``|s|^2 + |t|^2 - 2 s.t <= r^2`` in
    fp32 over target blocks of ``block`` points, so a point at the radius
    edge falls on the same side. The product is ``torch.matmul``, which is
    fp32 only while TF32 is off (``torch.backends.cuda.matmul.allow_tf32``):
    the entry points turn it off.

    Args:
        src: (..., n, 3); src_valid: (..., n) bool; tgt: (..., m, 3);
        tgt_valid: (..., m) bool, the same leading shape.

    Returns:
        (..., n) bool hit mask, False for invalid src points.
    """
    src, tgt = src.float(), tgt.float()
    r_sq = float(torch.tensor(radius * radius, dtype=torch.float32))
    s_sq = _sq_norm(src)[..., None]
    hit = torch.zeros_like(src_valid)
    for j in range(0, tgt.shape[-2], block):
        t = tgt[..., j:j + block, :]
        d_sq = (s_sq + _sq_norm(t)[..., None, :] -
                2.0 * torch.matmul(src, t.transpose(-1, -2)))
        ok = (d_sq <= r_sq) & tgt_valid[..., None, j:j + block]
        hit = hit | ok.any(dim=-1)
    return hit & src_valid


def _downsample_rows(points: Tensor, valid: Tensor, voxel_size: float
                     ) -> Tuple[Tensor, Tensor]:
    """:func:`voxel_downsample_batched` over any leading shape."""
    out, ok = voxel_downsample_batched(
        points.reshape((-1,) + points.shape[-2:]),
        valid.reshape(-1, valid.shape[-1]), voxel_size)
    return out.reshape(points.shape), ok.reshape(valid.shape)


def overlap_ratio(pc1: Tensor, valid1: Tensor, pc2: Tensor, valid2: Tensor,
                  *, voxel_size: float = 0.025, overlap_factor: float = 1.5,
                  downsample: bool = True) -> Tuple[Tensor, Tensor]:
    """Bidirectional overlap ratios of padded clouds: voxel-downsample
    each (unless ``downsample`` is False), then the share of each cloud's
    points with a point of the other within ``voxel_size *
    overlap_factor``. An empty cloud gives NaN (0 / 0), as in the JAX
    package.

    Args:
        pc1: (..., n, 3); valid1: (..., n); pc2: (..., m, 3); valid2:
            (..., m), the same leading shape.

    Returns:
        (overlap_1, overlap_2), fp32 of the leading shape.
    """
    if downsample:
        pc1, valid1 = _downsample_rows(pc1, valid1, voxel_size)
        pc2, valid2 = _downsample_rows(pc2, valid2, voxel_size)
    radius = voxel_size * overlap_factor
    hits1 = any_within_radius(pc1, valid1, pc2, valid2, radius)
    hits2 = any_within_radius(pc2, valid2, pc1, valid1, radius)
    n1, n2 = valid1.float().sum(dim=-1), valid2.float().sum(dim=-1)
    return hits1.float().sum(dim=-1) / n1, hits2.float().sum(dim=-1) / n2


def min_dist_sq(src: Tensor, src_valid: Tensor, tgt: Tensor,
                tgt_valid: Tensor, *, block: int = 512) -> Tensor:
    """Least squared distance from each src point to the valid tgt set.

    The JAX package's blocked formula, ``|s|^2 + |t|^2 - 2 s.t`` in fp32
    over target blocks of ``block`` points, with ``torch.matmul`` (fp32
    only while TF32 is off). +inf for invalid src points and where no tgt
    point is valid.

    Args:
        src: (n, 3); src_valid: (n,) bool; tgt: (m, 3); tgt_valid: (m,)
            bool.

    Returns:
        (n,) fp32.
    """
    src, tgt = src.float(), tgt.float()
    s_sq = _sq_norm(src)[:, None]
    inf = torch.tensor(float("inf"), device=src.device)
    best = torch.full((src.shape[0],), float("inf"), device=src.device)
    for j in range(0, tgt.shape[0], block):
        t = tgt[j:j + block]
        d_sq = s_sq + _sq_norm(t)[None, :] - 2.0 * torch.matmul(src, t.T)
        d_sq = torch.where(tgt_valid[None, j:j + block], d_sq, inf)
        best = torch.minimum(best, d_sq.amin(dim=1))
    return torch.where(src_valid, best, inf)


def overlap_region(src: Tensor, src_valid: Tensor, tgt: Tensor,
                   tgt_valid: Tensor, *, voxel_size: float = 0.025
                   ) -> Tensor:
    """Per-src-point overlap mask: does a centroid of the voxel-downsampled
    tgt lie within 1.5 × ``voxel_size``? src is not downsampled.

    Args:
        src: (n, 3); src_valid: (n,) bool; tgt: (m, 3); tgt_valid: (m,)
            bool.

    Returns:
        (n,) bool, False for invalid src points.
    """
    tgt_d, tgt_dv = voxel_downsample(tgt, tgt_valid, voxel_size)
    radius = voxel_size * 1.5
    r_sq = float(torch.tensor(radius * radius, dtype=torch.float32))
    return min_dist_sq(src, src_valid, tgt_d, tgt_dv) <= r_sq


def correspondences_np(src: np.ndarray, tgt: np.ndarray,
                       transform: np.ndarray, radius: float, *,
                       block: int = 2048, device=None) -> np.ndarray:
    """Every (src, tgt) index pair within ``radius`` once ``transform`` is
    applied to src: the registration loaders' ``get_correspondences``.

    src is transformed in float64 on the host and cast to fp32; distances
    are the blocked formula of :func:`min_dist_sq` on ``device``, ``d^2 <=
    r^2`` in fp32, a block of ``block`` src rows against all of tgt. The
    JAX package pads both clouds to power-of-two buckets of far-apart
    sentinels, only so that XLA compiles a handful of shapes; eager torch
    compiles nothing, so nothing is padded here.

    Args:
        src: (n, 3); tgt: (m, 3); transform: (4, 4).
        device: where the distances are computed (``cuda`` unless asked
            otherwise, see ``resolve_device``).

    Returns:
        (k, 2) int64 ``[src_idx, tgt_idx]``, src-major then tgt in order;
        (0, 2) when either cloud is empty.
    """
    from pointreggpt_tpu_torch import resolve_device

    n, m = src.shape[0], tgt.shape[0]
    if n == 0 or m == 0:
        return np.zeros((0, 2), dtype=np.int64)
    dev = resolve_device(device)
    src_t = (src @ transform[:3, :3].T + transform[:3, 3]).astype(np.float32)
    s_all = torch.from_numpy(src_t).to(dev)
    t = torch.from_numpy(np.ascontiguousarray(tgt, np.float32)).to(dev)
    t_sq = _sq_norm(t)[None, :]
    r_sq = float(np.float32(radius * radius))
    pairs = []
    for start in range(0, n, block):
        s = s_all[start:start + block]
        d_sq = _sq_norm(s)[:, None] + t_sq - 2.0 * torch.matmul(s, t.T)
        ij = torch.nonzero(d_sq <= r_sq)
        ij[:, 0] += start
        pairs.append(ij)
    return torch.cat(pairs).cpu().numpy().astype(np.int64)
