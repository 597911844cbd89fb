"""PyTorch port: geometry, pose sampling, point ops and host I/O against
the JAX package, on the CPU. Inputs come from a numpy seed and go through
both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointreggpt_tpu.core import geometry as JG
from pointreggpt_tpu.core import imageio16 as JIO
from pointreggpt_tpu.core import plyio as JPLY
from pointreggpt_tpu.core import pointops as JP
from pointreggpt_tpu.core import sampling as JS
from pointreggpt_tpu.data.datasets import resolve_frame_record as j_resolve
from test_torch_port_generator import single_torch_thread  # noqa: F401
from pointreggpt_tpu_torch.core import geometry as G
from pointreggpt_tpu_torch.core import imageio16 as IO
from pointreggpt_tpu_torch.core import plyio as PLY
from pointreggpt_tpu_torch.core import pointops as P
from pointreggpt_tpu_torch.core import sampling as S
from pointreggpt_tpu_torch.data.datasets import resolve_frame_record

T = torch.from_numpy


def _intrinsics(b, h=32):
    k = np.zeros((b, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 30.0 + np.arange(b)
    k[:, 0, 2] = k[:, 1, 2] = h / 2
    k[:, 2, 2] = 1
    return k


def _pose(b, seed):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-0.2, 0.2, (b, 3)).astype(np.float32)
    rot = np.asarray(JS.euler_xyz_intrinsic_to_matrix(jnp.asarray(ang)))
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose[:, :3, :3] = rot
    pose[:, :3, 3] = rng.normal(size=(b, 3)) * 0.1
    return pose


def test_depth_to_points_matches():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0, 4, (2, 32, 32)).astype(np.float32)
    k = _intrinsics(2)
    jp, jv = JG.depth_to_points(jnp.asarray(depth), jnp.asarray(k),
                                clip=(0.5, 3.5))
    tp, tv = G.depth_to_points(T(depth), T(k), clip=(0.5, 3.5))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)


def test_splat_of_identical_points_is_exact():
    # exact: the same fp32 camera-frame points must land on the same
    # pixels with the same z-buffer winners
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-1, 1, (2, 3000)),
                    rng.uniform(-1, 1, (2, 3000)),
                    rng.uniform(-0.2, 3, (2, 3000))], -1).astype(np.float32)
    valid = rng.uniform(size=(2, 3000)) > 0.1
    k = _intrinsics(2)
    jd, jm = JG.points_to_depth(jnp.asarray(pts), jnp.asarray(valid),
                                jnp.asarray(k), image_size=(32, 32))
    td, tm = G.points_to_depth(T(pts), T(valid), T(k), image_size=(32, 32))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tm.any() and not tm.all()


def test_transform_and_inverse_rotation_match():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(3, 500, 3)).astype(np.float32)
    pose = _pose(3, 2)
    ref = JG.transform_points(jnp.asarray(pts), jnp.asarray(pose))
    got = G.transform_points(T(pts), T(pose))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    back = G.rotate_transposed(T(pose[:, :3, :3]),
                               got - T(pose[:, None, :3, 3]))
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-5)


def test_min_pool_and_condition_helpers():
    rng = np.random.default_rng(3)
    d = rng.uniform(0, 1, (2, 16, 16)).astype(np.float32)
    d[0, :3, :3] = np.inf
    np.testing.assert_array_equal(
        G.min_pool(T(d)).numpy(), np.asarray(JG.min_pool(jnp.asarray(d))))
    cond = rng.uniform(-1, 1, (2, 8, 8, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        G.mask_from_image_condition(T(cond)).numpy(),
        np.asarray(JG.mask_from_image_condition(jnp.asarray(cond))))
    k = _intrinsics(2)
    np.testing.assert_array_equal(G.param_vector(T(k)).numpy(),
                                  np.asarray(JG.param_vector(jnp.asarray(k))))


def test_intrinsic_transform_and_point_cloud_np_match():
    k = np.array([[585.0, 0, 320.0], [0, 585.0, 240.0], [0, 0, 1]])
    np.testing.assert_array_equal(
        G.intrinsic_transform(k, resize=256, centercrop=256),
        JG.intrinsic_transform(k, resize=256, centercrop=256))
    depth = np.random.default_rng(4).uniform(0, 4, (24, 24))
    np.testing.assert_array_equal(
        G.point_cloud_np(depth, k, clip=(0.5, 3.5)),
        JG.point_cloud_np(depth, k, clip=(0.5, 3.5)))


def test_euler_matches_and_pose_statistics():
    rng = np.random.default_rng(5)
    ang = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    ref = JS.euler_xyz_intrinsic_to_matrix(jnp.asarray(ang))
    got = S.euler_xyz_intrinsic_to_matrix(T(ang))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)

    # the two packages draw different numbers: hold the distribution
    gen = torch.Generator().manual_seed(0)
    pose = S.random_sample_pose(gen, 4096).numpy()
    rot, t = pose[:, :3, :3], pose[:, :3, 3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)
    np.testing.assert_allclose(pose[:, 3], np.broadcast_to([0, 0, 0, 1],
                                                           (4096, 4)))
    pitch = np.arcsin(np.clip(rot[:, 2, 1], -1, 1))  # -Rx row: sin(a)cos(b)
    assert np.abs(pitch).max() <= np.pi / 24 + 1e-3
    yaw = np.arcsin(np.clip(rot[:, 0, 2], -1, 1))
    assert np.abs(yaw).max() <= np.pi / 12 + 1e-4
    assert np.abs(yaw).max() > np.pi / 12 * 0.95
    # pivot about (0, 0, 3): t = c - R c + noise (z of the noise zeroed)
    c = np.array([0, 0, 3.0])
    noise = t - (c - rot @ c)
    np.testing.assert_allclose(noise[:, 2], 0, atol=1e-5)
    assert abs(noise[:, :2].std() - 1 / 3) < 0.02
    j = np.asarray(JS.random_sample_pose(jax.random.PRNGKey(0), 4096))
    j_noise = j[:, :3, 3] - (c - j[:, :3, :3] @ c)
    assert abs(j_noise[:, :2].std() - noise[:, :2].std()) < 0.02


def _cloud(seed, b=2, n=3000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32)
    pts[..., 2] += 2.0
    valid = rng.uniform(size=(b, n)) > 0.2
    return pts, valid


def test_voxel_downsample_matches_in_voxel_order():
    pts, valid = _cloud(6)
    jp, jv = JP.voxel_downsample(jnp.asarray(pts[0]), jnp.asarray(valid[0]),
                                 0.1)
    tp, tv = P.voxel_downsample(T(pts[0]), T(valid[0]), 0.1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # centroids compared in output (voxel) order; fp32 sums reassociate
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)


@pytest.mark.parametrize("capacity", [300, 8192])
def test_memory_voxel_update_matches(capacity):
    mem, mem_valid = _cloud(7)
    new, new_valid = _cloud(8)
    new += 0.05
    args = (mem, mem_valid, new, new_valid)
    jp, jv, jo = JP.memory_voxel_update(*map(jnp.asarray, args), 0.05,
                                        capacity)
    tp, tv, to = P.memory_voxel_update(*map(T, args), 0.05, capacity)
    # voxel count and overflow exact; centroids in output order to 1e-6
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    if capacity == 300:
        assert (to.numpy() > 0).all()
        d2 = (tp.numpy() ** 2).sum(-1)
        assert (np.diff(d2, axis=1) >= 0).all()  # nearest first


def test_png_ply_and_frame_record(tmp_path):
    rng = np.random.default_rng(9)
    depth01 = rng.uniform(0, 0.5, (20, 30))
    IO.write_depth_png(tmp_path / "a.png", depth01)
    JIO.write_depth_png(tmp_path / "b.png", depth01)
    np.testing.assert_array_equal(IO.read_depth_png(tmp_path / "a.png"),
                                  JIO.read_depth_png(tmp_path / "b.png",
                                                     use_native=False))
    np.testing.assert_array_equal(IO.to_uint8_image(depth01),
                                  JIO.to_uint8_image(depth01))
    pts = rng.normal(size=(50, 3))
    PLY.write_ply(tmp_path / "a.ply", pts)
    JPLY.write_ply(tmp_path / "b.ply", pts)
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()
    np.testing.assert_array_equal(PLY.read_ply(tmp_path / "a.ply"),
                                  JPLY.read_ply(tmp_path / "b.ply"))

    # a 3DMatch frame record resolves to the same depth and intrinsics
    seq = tmp_path / "rgbd/scene-0/seq-01"
    seq.mkdir(parents=True)
    np.savetxt(tmp_path / "rgbd/scene-0/camera-intrinsics.txt",
               [[585.0, 0, 320.0], [0, 585.0, 240.0], [0, 0, 1]])
    IO.write_depth_png(seq / "frame-000000.depth.png",
                       rng.uniform(0.1, 0.4, (480, 640)))
    (tmp_path / "indoor/scene-0").mkdir(parents=True)
    (tmp_path / "indoor/scene-0/src.info.txt").write_text(
        "scene-0 seq-01 0 0\n")
    args = (str(tmp_path / "indoor"), str(tmp_path / "rgbd"),
            "scene-0/src.pth", 64)
    d, k = resolve_frame_record(*args)
    jd, jk = j_resolve(*args)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(k, jk)
