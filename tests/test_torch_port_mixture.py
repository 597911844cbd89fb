"""PyTorch port, the registration mixture loaders, against the JAX
package on the CPU: ``min_dist_sq`` and ``correspondences_np``, both
datasets item for item from one seed over a generated tree, ``cube_crop``
(with its no-overlap return) and the cloud formats. A pair whose distance
lies within ``EDGE`` of the radius may fall on either side of it in fp32
(the packages fuse the blocked formula differently): the correspondence
test keeps its points off that band, and the dataset tests let only such
pairs differ."""

import numpy as np
import pytest
import torch

from pointreggpt_tpu.core import pointops as JP
from pointreggpt_tpu.dataloaders import mixture as jmix
from test_torch_port_generator import single_torch_thread  # noqa: F401
from pointreggpt_tpu_torch.core import plyio
from pointreggpt_tpu_torch.core import pointops as P
from pointreggpt_tpu_torch.dataloaders import mixture as mix

EDGE = 1e-5  # distance band around the radius where fp32 may disagree
RADIUS = 0.05


def _edge_pairs(src, tgt, transform, radius):
    """(n,) count per src point of tgt points whose float64 distance
    after ``transform`` lies within ``EDGE`` of ``radius``."""
    s = np.asarray(src, np.float64) @ transform[:3, :3].T + transform[:3, 3]
    d = np.sqrt(((s[:, None, :] - np.asarray(tgt, np.float64)[None]) ** 2
                 ).sum(-1))
    return (np.abs(d - radius) < EDGE).sum(axis=1)


def _assert_same_pairs(got, want, src, tgt, transform):
    """The two (k, 2) [src_idx, tgt_idx] arrays are equal, in order, but
    for pairs within ``EDGE`` of the radius."""
    diff = set(map(tuple, got)) ^ set(map(tuple, want))
    if not diff:
        np.testing.assert_array_equal(got, want)
        return
    i, j = np.array(sorted(diff)).T
    s = np.asarray(src, np.float64)[i] @ transform[:3, :3].T + \
        transform[:3, 3]
    d = np.linalg.norm(s - np.asarray(tgt, np.float64)[j], axis=1)
    assert (np.abs(d - RADIUS) < EDGE).all(), (sorted(diff), d)


def _cloud(rng, n, shift=(0.0, 0.0, 0.0)):
    return (rng.uniform(0, 1, (n, 3)) + shift).astype(np.float32)


def test_min_dist_sq_matches_jax():
    rng = np.random.default_rng(0)
    src, tgt = _cloud(rng, 700), _cloud(rng, 1100, (0.2, 0, 0))
    sv, tv = rng.uniform(size=700) > 0.1, rng.uniform(size=1100) > 0.3
    want = np.asarray(JP.min_dist_sq(src, sv, tgt, tv))
    got = P.min_dist_sq(torch.from_numpy(src), torch.from_numpy(sv),
                        torch.from_numpy(tgt), torch.from_numpy(tv)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want)) and \
        np.isinf(got).sum() == (~sv).sum()
    ok = np.isfinite(want)
    # fp32 rounding of |s|^2 + |t|^2 - 2 s.t (values up to 1.4)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=2e-6)
    none = P.min_dist_sq(torch.from_numpy(src), torch.from_numpy(sv),
                         torch.from_numpy(tgt), torch.zeros(1100, dtype=bool))
    assert torch.isinf(none).all()


@pytest.mark.parametrize("n,m", [(3000, 900), (500, 2500)])
def test_correspondences_match_jax(n, m):
    rng = np.random.default_rng(n)
    src = rng.uniform(0, 1, (n, 3))
    tgt = _cloud(rng, m)
    tsfm = np.eye(4)
    tsfm[:3, :3] = mix.uniform_sample_rotation(rng)
    tsfm[:3, 3] = rng.normal(size=3) * 0.1
    src = (src - tsfm[:3, 3]) @ tsfm[:3, :3]  # lands on [0, 1]^3 again
    src = src[_edge_pairs(src, tgt, tsfm, RADIUS) == 0]  # off the edge
    want = JP.correspondences_np(src, tgt, tsfm, RADIUS)
    got = P.correspondences_np(src, tgt, tsfm, RADIUS, device="cpu")
    assert got.dtype == np.int64 and got.shape[1] == 2 and len(got) > 100
    np.testing.assert_array_equal(got, want)
    for a, b in ((src[:0], tgt), (src, tgt[:0])):
        assert P.correspondences_np(a, b, tsfm, RADIUS,
                                    device="cpu").shape == (0, 2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A generated tree of two scenes (two overlapping clouds each, one
    over the point cap) and its gt.log, and one real pair."""
    root = tmp_path_factory.mktemp("mixture")
    rng = np.random.default_rng(3)
    lines = []
    for s, n in enumerate((900, 1300)):
        scene = root / "data" / f"scene-{s:06d}"
        scene.mkdir(parents=True)
        a = _cloud(rng, n)
        b = (a + [0.01, 0.004, 0.0] + rng.normal(0, 0.002, a.shape)
             ).astype(np.float32)
        plyio.write_ply(scene / "sample-000000.cloud.ply", a)
        plyio.write_ply(scene / "sample-000001.cloud.ply", b)
        lines.append(f"scene-{s:06d}\t0\t1\t0.{8 + s}000\t0.8500\n")
    (root / "metadata").mkdir()
    (root / "metadata" / "gt.log").write_text("".join(lines))
    real = root / "real"
    real.mkdir()
    plyio.write_ply(real / "a.ply", _cloud(rng, 600))
    _cloud(rng, 500).astype(np.float32).tofile(real / "b.bin")
    pts = np.concatenate([_cloud(rng, 500), np.zeros((500, 1), np.float32)],
                         axis=1)
    pts.tofile(real / "b.bin")
    torch.save(torch.from_numpy(_cloud(rng, 700)), real / "c.pth")
    return root


def _infos():
    rot = mix.uniform_sample_rotation(np.random.default_rng(11))
    return {"src": ["real/a.ply"], "tgt": ["real/b.bin"],
            "rot": [rot], "trans": [np.array([[0.1], [0.0], [-0.2]])]}


@pytest.mark.parametrize("augment", [True, False])
def test_mixture_dataset_items_match_jax(tree, augment):
    kw = dict(base_dir=str(tree), extra_root=str(tree),
              overlap_radius=RADIUS, data_augmentation=augment,
              max_points=1000, seed=5)
    jds = jmix.MixtureDataset(_infos(), **kw)
    ds = mix.MixtureDataset(_infos(), device="cpu", **kw)
    assert len(ds) == len(jds) == 3 and ds.num_real == 1
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert len(got) == 10
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype, (i, k)
            if k != 6:
                np.testing.assert_array_equal(g, w, err_msg=f"item {i} [{k}]")
        tsfm = np.eye(4)
        tsfm[:3, :3], tsfm[:3, 3] = got[4], got[5][:, 0]
        _assert_same_pairs(got[6], want[6], got[0], got[1], tsfm)
        assert got[7] is got[0] and got[8] is got[1]
        if i:  # the generated pairs overlap
            assert len(got[6]) > 100
        assert got[0].shape[0] <= 1000


@pytest.mark.parametrize("rotated", [False, True])
def test_pair_dataset_items_match_jax(tree, rotated):
    real = [{"scene_name": "real", "frag_id0": 0, "frag_id1": 1,
             "overlap": 0.6, "pcd0": "real/a.ply", "pcd1": "real/c.pth",
             "rotation": np.eye(3), "translation": np.zeros(3)},
            {"scene_name": "real", "frag_id0": 2, "frag_id1": 3,
             "overlap": 0.1, "pcd0": "real/a.ply", "pcd1": "real/c.pth"}]
    kw = dict(real_metadata=real, real_data_root=str(tree), point_limit=1000,
              use_augmentation=True, overlap_threshold=0.3,
              return_corr_indices=True, matching_radius=RADIUS,
              rotated=rotated, seed=6)
    jds = jmix.MixturePairDataset(str(tree), **kw)
    ds = mix.MixturePairDataset(str(tree), device="cpu", **kw)
    assert len(ds) == len(jds) == 3  # the low-overlap real pair is left out
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert got.keys() == want.keys()
        _assert_same_pairs(got["corr_indices"][:, ::-1],
                           want["corr_indices"][:, ::-1], got["src_points"],
                           got["ref_points"],
                           got["transform"].astype(np.float64))
        for k, w in want.items():
            if k == "corr_indices":
                assert got[k].dtype == w.dtype
            elif isinstance(w, np.ndarray):
                assert got[k].dtype == w.dtype, k
                np.testing.assert_array_equal(got[k], w, err_msg=k)
            else:
                assert got[k] == w, k
        assert got["corr_indices"].flags["C_CONTIGUOUS"]
    with pytest.raises(ValueError, match="matching_radius"):
        mix.MixturePairDataset(str(tree), return_corr_indices=True,
                               device="cpu")


def test_cube_crop_matches_jax(tree):
    jds = jmix.MixturePairDataset(str(tree), seed=7)
    ds = mix.MixturePairDataset(str(tree), seed=7, device="cpu")
    rng = np.random.default_rng(8)
    ref = rng.uniform(0, 6, (1500, 3))
    src = ref + rng.normal(0, 0.01, ref.shape)
    for _ in range(3):  # the same draws, call after call
        got, want = ds.cube_crop(ref, src), jds.cube_crop(ref, src)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert 0 < len(got[0]) < len(ref)
    far = src + 10.0  # no ref point has a src point within 5 cm
    out = ds.cube_crop(ref, far)
    assert out[0] is ref and out[1] is far


def test_cloud_formats(tree):
    a = mix.load_point_cloud(str(tree / "real" / "b.bin"))
    np.testing.assert_array_equal(
        a, jmix.load_point_cloud(str(tree / "real" / "b.bin")))
    assert a.shape == (500, 3)
    c = mix.load_point_cloud(str(tree / "real" / "c.pth"))
    assert isinstance(c, np.ndarray) and c.shape == (700, 3)
    with pytest.raises(ValueError, match="format"):
        mix.load_point_cloud(str(tree / "metadata" / "gt.log"))
    assert mix.generated_pair_paths(str(tree)) == \
        jmix.generated_pair_paths(str(tree))
