"""Registration mixture loaders: real pairs plus the generated ones.

Port of ``pointreggpt_tpu/dataloaders/mixture.py``: drop-in datasets for
Predator / CoFiNet (:class:`MixtureDataset`, their 10-tuple) and
GeoTransformer (:class:`MixturePairDataset`, its dict) that append the
pairs of a generated tree's ``metadata/gt.log`` to a host repo's real
3DMatch pairs. Numpy in, numpy out; the distance work
(:func:`~pointreggpt_tpu_torch.core.pointops.correspondences_np` and
``min_dist_sq``) runs on ``device``.

Every draw comes from the dataset's ``np.random.Generator`` by the same
calls in the same order as in the JAX package, so one seed gives the same
items, apart from a correspondence whose distance lies within rounding of
the radius.

Pose convention for generated pairs: sample a Haar-uniform rotation and a
Gaussian translation and apply the inverse to the src cloud, ``src' =
(src - t) @ R``, so the stored (rot, trans) aligns src' onto tgt.

A ``torch.utils.data.DataLoader`` with worker processes must build the
dataset with ``device="cpu"``, or start its workers with the ``spawn``
method (``multiprocessing_context="spawn"``): CUDA cannot start in a
forked worker.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.core import plyio
from pointreggpt_tpu_torch.core.pointops import (correspondences_np,
                                                 min_dist_sq)
from pointreggpt_tpu_torch.generate.gt import parse_gt_log


def uniform_sample_rotation(rng: np.random.Generator) -> np.ndarray:
    """Haar-uniform SO(3) rotation via QR."""
    z = rng.standard_normal((3, 3))
    while np.linalg.matrix_rank(z) != 3:
        z = rng.standard_normal((3, 3))
    q, r = np.linalg.qr(z)
    d = np.diag(r)
    q = q @ np.diag(d / np.abs(d))
    return q / np.linalg.det(q)


def gaussian_sample_translation(rng: np.random.Generator,
                                factor: float = 1.0) -> np.ndarray:
    """Gaussian translation."""
    return rng.standard_normal(3) * factor


def random_sample_rotation(rng: np.random.Generator,
                           rotation_factor: float = 1.0) -> np.ndarray:
    """The host repos' augmentation rotation:
    ``Rotation.from_euler("zyx", rand(3) * 2 pi / factor)``."""
    from scipy.spatial.transform import Rotation

    euler = rng.random(3) * 2.0 * np.pi / rotation_factor
    return Rotation.from_euler("zyx", euler).as_matrix()


def random_sample_rotation_v2(rng: np.random.Generator) -> np.ndarray:
    """GeoTransformer's ``random_sample_rotation_v2``: a random axis
    scaled by an angle in [0, pi), read as zyx Euler angles (the epsilon
    is added after normalizing, as there)."""
    from scipy.spatial.transform import Rotation

    axis = rng.random(3) - 0.5
    axis = axis / np.linalg.norm(axis) + 1e-8
    theta = np.pi * rng.random()
    return Rotation.from_euler("zyx", axis * theta).as_matrix()


def load_point_cloud(file_path: str) -> np.ndarray:
    """A PLY, a KITTI ``.bin`` (x, y, z, intensity) or a ``.pth`` cloud."""
    if file_path.endswith(".ply"):
        return plyio.read_ply(file_path)
    if file_path.endswith(".bin"):
        return np.fromfile(file_path, dtype=np.float32).reshape(-1, 4)[:, :3]
    if file_path.endswith(".pth"):
        # GeoTransformer's 3DMatch clouds are pickled numpy arrays, which
        # the weights-only unpickler refuses
        points = torch.load(file_path, weights_only=False)
        return points.numpy() if not isinstance(points, np.ndarray) \
            else points
    raise ValueError(f"Cannot recognize point cloud format: {file_path}")


def generated_pair_paths(extra_root: str) -> List[Dict]:
    """The pairs of ``{extra_root}/metadata/gt.log`` as src / tgt PLY path
    records."""
    records = []
    for rec in parse_gt_log(os.path.join(extra_root, "metadata", "gt.log")):
        scene_dir = os.path.join(extra_root, "data", rec["scene_name"])
        records.append({
            "scene_name": rec["scene_name"],
            "src_path": os.path.join(
                scene_dir, "sample-{:0>6d}.cloud.ply".format(rec["src_idx"])),
            "tgt_path": os.path.join(
                scene_dir, "sample-{:0>6d}.cloud.ply".format(rec["tgt_idx"])),
            "overlap": rec["overlap_src"],
            "frag_id0": rec["src_idx"],
            "frag_id1": rec["tgt_idx"],
        })
    return records


class MixtureDataset:
    """Predator / CoFiNet mixture: real 3DMatch pairs + generated pairs.

    ``infos`` is the host repo's dict ``{"src": [...], "tgt": [...],
    "rot": [...], "trans": [...]}``; generated pairs are appended from
    ``extra_root`` and posed with fresh Haar-uniform rotations at fetch
    time.

    An item is the host repos' 10-tuple ``(src_pcd, tgt_pcd, src_feats,
    tgt_feats, rot, trans, correspondences, src_pcd, tgt_pcd,
    sample_weight)``: the clouds float32, the correspondences a (k, 2)
    int64 ``[src_idx, tgt_idx]`` array at ``overlap_radius``, the weight
    ``np.ones(1)``.
    """

    def __init__(self,
                 infos: Dict[str, list],
                 *,
                 base_dir: str = "",
                 extra_root: str,
                 overlap_radius: float = 0.0375,
                 data_augmentation: bool = True,
                 augment_noise: float = 0.005,
                 rot_factor: float = 1.0,
                 max_points: int = 30000,
                 seed: Optional[int] = None,
                 device=None):
        self.infos = {k: list(v) for k, v in infos.items()}
        self.overlap_radius = overlap_radius
        self.data_augmentation = data_augmentation
        self.augment_noise = augment_noise
        self.rot_factor = rot_factor
        self.max_points = max_points
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

        self.num_real = len(self.infos.get("rot", []))
        for key in ("src", "tgt"):
            self.infos[key] = [os.path.join(base_dir, p)
                               for p in self.infos[key]]
        for rec in generated_pair_paths(extra_root):
            self.infos["src"].append(rec["src_path"])
            self.infos["tgt"].append(rec["tgt_path"])

    def __len__(self) -> int:
        return len(self.infos["tgt"])

    def _cap(self, pcd: np.ndarray) -> np.ndarray:
        if pcd.shape[0] > self.max_points:
            pcd = pcd[self.rng.permutation(pcd.shape[0])[:self.max_points]]
        return pcd

    def __getitem__(self, item: int):
        src_pcd = load_point_cloud(self.infos["src"][item]).astype(np.float64)
        tgt_pcd = load_point_cloud(self.infos["tgt"][item]).astype(np.float64)

        if item < self.num_real:
            rot = np.asarray(self.infos["rot"][item], np.float64)
            trans = np.asarray(self.infos["trans"][item], np.float64)
        else:
            rot = uniform_sample_rotation(self.rng)
            trans = gaussian_sample_translation(self.rng)
            src_pcd = (src_pcd - trans) @ rot  # the inverse pose
        src_pcd = self._cap(src_pcd)
        tgt_pcd = self._cap(tgt_pcd)

        if self.data_augmentation:
            # a scaled-Euler rotation of one side, then uniform noise
            rot_ab = random_sample_rotation(self.rng, self.rot_factor)
            if self.rng.random() > 0.5:
                src_pcd = (rot_ab @ src_pcd.T).T
                rot = rot @ rot_ab.T
            else:
                tgt_pcd = (rot_ab @ tgt_pcd.T).T
                rot = rot_ab @ rot
                trans = rot_ab @ trans
            src_pcd += (self.rng.random(src_pcd.shape) - 0.5) * \
                self.augment_noise
            tgt_pcd += (self.rng.random(tgt_pcd.shape) - 0.5) * \
                self.augment_noise

        trans_col = trans.reshape(3, 1)
        tsfm = np.eye(4)
        tsfm[:3, :3] = rot
        tsfm[:3, 3] = trans_col[:, 0]
        correspondences = correspondences_np(
            src_pcd, tgt_pcd, tsfm, self.overlap_radius, device=self.device)

        src_feats = np.ones((src_pcd.shape[0], 1), np.float32)
        tgt_feats = np.ones((tgt_pcd.shape[0], 1), np.float32)
        src_out = src_pcd.astype(np.float32)
        tgt_out = tgt_pcd.astype(np.float32)
        return (src_out, tgt_out, src_feats, tgt_feats,
                rot.astype(np.float32), trans_col.astype(np.float32),
                correspondences, src_out, tgt_out, np.ones(1, np.float32))


class MixturePairDataset:
    """GeoTransformer mixture: its real ``train.pkl`` metadata merged with
    the generated gt.log pairs. An item is a dict of ref / src points,
    unit features, the aligning transform and, with
    ``return_corr_indices``, the (k, 2) ``[ref_idx, src_idx]``
    correspondences at ``matching_radius``."""

    def __init__(self,
                 dataset_root: str,
                 *,
                 real_metadata: Optional[Sequence[Dict]] = None,
                 real_data_root: str = "",
                 point_limit: Optional[int] = None,
                 use_augmentation: bool = False,
                 augmentation_noise: float = 0.005,
                 augmentation_rotation: float = 1.0,
                 overlap_threshold: Optional[float] = None,
                 return_corr_indices: bool = False,
                 matching_radius: Optional[float] = None,
                 rotated: bool = False,
                 seed: Optional[int] = None,
                 device=None):
        self.point_limit = point_limit
        self.use_augmentation = use_augmentation
        self.aug_noise = augmentation_noise
        self.aug_rotation = augmentation_rotation
        self.rotated = rotated
        self.return_corr_indices = return_corr_indices
        self.matching_radius = matching_radius
        if return_corr_indices and matching_radius is None:
            raise ValueError(
                '"matching_radius" is None but "return_corr_indices" is set.')
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

        self.metadata_list: List[Dict] = []
        for meta in (real_metadata or []):
            if (overlap_threshold is not None
                    and meta["overlap"] <= overlap_threshold):
                continue
            m = dict(meta)
            m["pcd0"] = os.path.join(real_data_root, meta["pcd0"])
            m["pcd1"] = os.path.join(real_data_root, meta["pcd1"])
            self.metadata_list.append(m)
        for rec in generated_pair_paths(dataset_root):
            self.metadata_list.append({
                "scene_name": rec["scene_name"],
                "frag_id0": rec["frag_id0"],
                "frag_id1": rec["frag_id1"],
                "overlap": rec["overlap"],
                "pcd0": rec["src_path"],
                "pcd1": rec["tgt_path"],
            })

    def __len__(self) -> int:
        return len(self.metadata_list)

    def _load(self, path: str) -> np.ndarray:
        points = load_point_cloud(path)
        if self.point_limit is not None and points.shape[0] > self.point_limit:
            idx = self.rng.permutation(points.shape[0])[:self.point_limit]
            points = points[idx]
        return points

    def cube_crop(self, ref_points: np.ndarray, src_points: np.ndarray,
                  size: float = 3.0):
        """Random rotated-cube crop around a shared overlap point
        (GeoTransformer's ``_cube_crop``, which its ``__getitem__`` does
        not call either).

        Picks a random ref point with a src point within 5 cm (by
        :func:`min_dist_sq` on ``device``), then keeps the points of each
        cloud inside an axis-aligned cube of side ``size`` centred there,
        tested after a fresh random rotation about the centre; the points
        kept are the original ones. With no such ref point both clouds
        come back as they were.
        """
        ref = np.asarray(ref_points, np.float64)
        src = np.asarray(src_points, np.float64)
        d2 = min_dist_sq(
            torch.from_numpy(ref.astype(np.float32)).to(self.device),
            torch.ones(ref.shape[0], dtype=torch.bool, device=self.device),
            torch.from_numpy(src.astype(np.float32)).to(self.device),
            torch.ones(src.shape[0], dtype=torch.bool, device=self.device),
        ).cpu().numpy()
        ref_overlap = ref[d2 < 0.05 * 0.05]
        if ref_overlap.shape[0] == 0:
            return ref_points, src_points

        center = ref_overlap[self.rng.integers(ref_overlap.shape[0])]
        lo = center - size / 2
        hi = center + size / 2

        def crop(points):
            rot = random_sample_rotation(self.rng)
            tmp = (points - center) @ rot.T + center
            return points[np.all((tmp > lo) & (tmp < hi), axis=1)]

        return crop(ref_points), crop(src_points)

    def __getitem__(self, index: int) -> Dict:
        meta = self.metadata_list[index]
        ref_points = self._load(meta["pcd0"]).astype(np.float64)
        src_points = self._load(meta["pcd1"]).astype(np.float64)
        rotation = np.asarray(meta.get("rotation", np.eye(3)), np.float64)
        translation = np.asarray(meta.get("translation", np.zeros(3)),
                                 np.float64)

        if self.use_augmentation:
            # a scaled-Euler rotation of one side, then uniform noise
            aug_rot = random_sample_rotation(self.rng, self.aug_rotation)
            if self.rng.random() > 0.5:
                ref_points = ref_points @ aug_rot.T
                rotation = aug_rot @ rotation
                translation = aug_rot @ translation
            else:
                src_points = src_points @ aug_rot.T
                rotation = rotation @ aug_rot.T
            ref_points += (self.rng.random(ref_points.shape) - 0.5) * \
                self.aug_noise
            src_points += (self.rng.random(src_points.shape) - 0.5) * \
                self.aug_noise

        if self.rotated:
            # independent whole-cloud rotations
            ref_rot = random_sample_rotation_v2(self.rng)
            ref_points = ref_points @ ref_rot.T
            rotation = ref_rot @ rotation
            translation = ref_rot @ translation
            src_rot = random_sample_rotation_v2(self.rng)
            src_points = src_points @ src_rot.T
            rotation = rotation @ src_rot.T

        transform = np.eye(4)
        transform[:3, :3] = rotation
        transform[:3, 3] = translation

        data_dict = {
            "scene_name": meta["scene_name"],
            "ref_frame": meta["frag_id0"],
            "src_frame": meta["frag_id1"],
            "overlap": meta["overlap"],
            "ref_points": ref_points.astype(np.float32),
            "src_points": src_points.astype(np.float32),
            "ref_feats": np.ones((ref_points.shape[0], 1), np.float32),
            "src_feats": np.ones((src_points.shape[0], 1), np.float32),
            "transform": transform.astype(np.float32),
            "index": index,
        }
        if self.return_corr_indices:
            # GeoTransformer's columns are (ref_idx, src_idx); the copy
            # drops the [:, ::-1] negative stride, which torch.from_numpy
            # in the host repo's collate rejects
            data_dict["corr_indices"] = np.ascontiguousarray(
                correspondences_np(src_points, ref_points, transform,
                                   self.matching_radius,
                                   device=self.device)[:, ::-1])
        return data_dict
