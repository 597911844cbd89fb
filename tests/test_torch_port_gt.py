"""PyTorch port: gt.log (the radius search, overlap ratios, generate_gt,
gather_gt, parse_gt_log, the CLI and its config) against the JAX package
on the CPU."""

import dataclasses
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pointreggpt_tpu import config as JC
from pointreggpt_tpu.core import pointops as JP
from pointreggpt_tpu.generate import gt as jgt
from test_torch_port_generator import (CAP, H, make_nets,  # noqa: F401
                                       save_port_checkpoints,
                                       single_torch_thread, write_tree)
from test_torch_port_tester import _flags, _jax_cli
from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch.cli import generate_dataset
from pointreggpt_tpu_torch.cli import generate_gt as cli
from pointreggpt_tpu_torch.core import plyio
from pointreggpt_tpu_torch.core import pointops as P
from pointreggpt_tpu_torch.generate import gt

t_ = torch.from_numpy
EPS32 = float(np.finfo(np.float32).eps)


def test_gt_log_config_matches_jax():
    got = [(f.name, f.type, f.default) for f in
           dataclasses.fields(C.GtLogConfig)]
    want = [(f.name, f.type, f.default) for f in
            dataclasses.fields(JC.GtLogConfig)]
    assert got == want


def _clouds(seed, n=3000, m=2500, batch=()):
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1, 1, batch + (n, 3)).astype(np.float32)
    t = rng.uniform(-1, 1, batch + (m, 3)).astype(np.float32)
    return s, rng.uniform(size=batch + (n,)) < 0.9, t, \
        rng.uniform(size=batch + (m,)) < 0.9


def _near_edge(s, t, tv, r):
    """Src points with a valid tgt point whose exact squared distance lies
    within the fp32 formula's rounding (a few ulps of |s|^2 + |t|^2) of
    r^2: the only points where two fp32 sum orders may disagree."""
    s64, t64 = s.astype(np.float64), t.astype(np.float64)
    d = ((s64[:, None, :] - t64[None, :, :])**2).sum(-1)
    scale = (s64**2).sum(-1)[:, None] + (t64**2).sum(-1)[None, :]
    return ((np.abs(d - r * r) <= 8 * EPS32 * scale) & tv[None]).any(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_any_within_radius_matches_jax(seed):
    r = 0.1125
    s, sv, t, tv = _clouds(seed)
    # plant a src point at exactly the radius from a valid tgt point
    tv[7] = True
    sv[11] = True
    s[11] = t[7] + np.float32(r) * np.array([0.6, 0.0, 0.8], np.float32)
    ref = np.asarray(JP.any_within_radius(s, sv, t, tv, r))
    got = P.any_within_radius(t_(s), t_(sv), t_(t), t_(tv), r).numpy()
    edge = _near_edge(s, t, tv, r)
    assert edge[11]
    # exact everywhere a point is not within rounding of the radius
    np.testing.assert_array_equal(got[~edge], ref[~edge])
    assert (got != ref).sum() <= edge.sum()
    assert 100 < ref.sum() < len(ref)


def test_any_within_radius_batched_rows():
    s, sv, t, tv = _clouds(3, n=600, m=1100, batch=(3,))
    got = P.any_within_radius(t_(s), t_(sv), t_(t), t_(tv), 0.1).numpy()
    for i in range(3):
        row = P.any_within_radius(t_(s[i]), t_(sv[i]), t_(t[i]), t_(tv[i]),
                                  0.1).numpy()
        np.testing.assert_array_equal(got[i], row)
        np.testing.assert_array_equal(
            row, np.asarray(JP.any_within_radius(s[i], sv[i], t[i], tv[i],
                                                 0.1)))


@pytest.mark.parametrize("seed", [0, 1])
def test_overlap_ratio_matches_jax(seed):
    s, sv, t, tv = _clouds(seed)
    t[:1200] += 0.5  # partial overlap
    ref = [float(x) for x in JP.overlap_ratio(s, sv, t, tv,
                                              voxel_size=0.1)]
    got = [float(x) for x in P.overlap_ratio(t_(s), t_(sv), t_(t), t_(tv),
                                             voxel_size=0.1)]
    # the centroids' sums run in another order: a point at the radius edge
    # may flip, one point of the downsampled cloud each (1 / n)
    n = [int(P.voxel_downsample(t_(c), t_(v), 0.1)[1].sum())
         for c, v in ((s, sv), (t, tv))]
    for g, w, k in zip(got, ref, n):
        assert abs(g - w) <= 1.0 / k
    assert 0.2 < got[0] < 0.99
    np.testing.assert_allclose(
        gt.compute_overlap_ratio_np(s[sv], t[tv], voxel_size=0.1,
                                    device="cpu"),
        jgt.compute_overlap_ratio_np(s[sv], t[tv], voxel_size=0.1),
        atol=1.0 / min(n), rtol=0)


def test_overlap_ratio_of_an_empty_cloud_is_nan():
    s, sv, t, tv = _clouds(4, n=300, m=300)
    sv[:] = False
    ref = [float(x) for x in JP.overlap_ratio(s, sv, t, tv)]
    got = [float(x) for x in P.overlap_ratio(t_(s), t_(sv), t_(t), t_(tv))]
    assert np.isnan(ref[0]) and np.isnan(got[0])
    assert got[1] == ref[1] == 0.0


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """A dataset tree written by the port's generate_dataset on the CPU:
    3 scenes, clouds ``sample-000000`` (the seed frame) and
    ``sample-000001`` (the generated fragment)."""
    root = tmp_path_factory.mktemp("gen")
    *_, tm, tdc = make_nets()
    folder, data_root, info = write_tree(root, n_scenes=3)
    with open(root / "info.pkl", "wb") as f:
        pickle.dump(info, f)
    save_port_checkpoints(root, tm, tdc)
    (root / "depth_correction_results").symlink_to(root / "dc_results")
    mp = pytest.MonkeyPatch()
    mp.chdir(root)
    mp.setenv("PRGPT_PLATFORM", "cpu")
    try:
        generate_dataset.main([
            "--resume", "1", "--data", folder, "--train_info_path",
            str(root / "info.pkl"), "--data_root", data_root,
            "--results_folder", str(root / "results"), "-start", "0",
            "-stop", "3", "--batch_size", "3", "--num_samples", "1",
            "--image_size", str(H), "--dim", "8", "--dim_mults", "1,2",
            "--dc_dim", "8", "--dc_dim_mults", "1,2", "--timesteps", "16",
            "--sampling_timesteps", "4", "--memory_capacity", str(CAP),
            "--save_voxel_size", "0.01"])
    finally:
        mp.undo()
    return root / "generated_dataset"


def _run_both(tree: Path, tmp: Path, num_samples: int, **kw):
    """generate_gt + gather_gt of both packages on copies of ``tree``;
    returns the two dataset roots."""
    out = []
    for name, mod, extra in (("jax", jgt, {}), ("port", gt,
                                                {"device": "cpu"})):
        root = tmp / name
        shutil.copytree(tree, root)
        mod.generate_gt("d", 0, 3, num_samples, root=str(root / "data"),
                        verbose=False, **kw, **extra)
        mod.gather_gt("d", 0, 3, root=str(root / "data"),
                      metadata=str(root / "metadata" / "gt.log"))
        out.append(root)
    return out


def _downsampled_count(ply: Path, voxel: float) -> int:
    pts = t_(plyio.read_ply(ply).astype(np.float32))
    return int(P.voxel_downsample(pts, torch.ones(len(pts), dtype=bool),
                                  voxel)[1].sum())


def test_generate_gt_matches_jax_on_generated_clouds(generated, tmp_path):
    jroot, proot = _run_both(generated, tmp_path, 2, min_points=50,
                             min_overlap=0.0)
    for s in range(3):
        scene = f"scene-{s:06d}"
        want = (jroot / "data" / scene / "gt.log").read_text().splitlines()
        got = (proot / "data" / scene / "gt.log").read_text().splitlines()
        assert len(got) == len(want) == 1
        n = [_downsampled_count(proot / "data" / scene /
                                f"sample-{i:06d}.cloud.ply", 0.025)
             for i in (0, 1)]
        for g, w in zip(got, want):
            g, w = g.split("\t"), w.split("\t")
            assert g[:3] == w[:3] == [scene, "0", "1"]
            for k in (0, 1):
                # each ratio within one point of its downsampled cloud,
                # and the two 4-decimal prints' half-unit roundings
                assert abs(float(g[3 + k]) - float(w[3 + k])) <= \
                    1.0 / n[k] + 1e-4, (g, w, n)
    meta = (proot / "metadata" / "gt.log").read_text()
    assert meta == "".join((proot / "data" / f"scene-{s:06d}" / "gt.log"
                            ).read_text() for s in range(3))
    records = gt.parse_gt_log(proot / "metadata" / "gt.log")
    assert records == jgt.parse_gt_log(proot / "metadata" / "gt.log")
    assert [r["scene_name"] for r in records] == [
        f"scene-{s:06d}" for s in range(3)]


def _write_rules_tree(root: Path):
    """Three scenes of four clouds that exercise each rule:
    scene 0: cloud 1 under min_points (its pairs skipped), clouds 0 and 2
    overlap, cloud 3 far away (its pairs under min_overlap both ways);
    scene 1: cloud 1 empty with min_points 0 (NaN ratios, skipped);
    scene 2: a gt.log already there (the scene is skipped)."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    clouds = {
        0: [base, base[:40], base + [0.3, 0, 0], base + [9.0, 0, 0]],
        1: [base, base[:0], base + [0.5, 0, 0], base],
        2: [base, base, base, base],
    }
    for s, cs in clouds.items():
        d = root / "data" / f"scene-{s:06d}"
        d.mkdir(parents=True)
        for i, c in enumerate(cs):
            plyio.write_ply(d / f"sample-{i:06d}.cloud.ply", c)
    (root / "data" / "scene-000002" / "gt.log").write_text(
        "scene-000002\t0\t1\t0.5000\t0.5000\n")


@pytest.mark.parametrize("min_points", [0, 100])
def test_skip_and_resume_rules_match_jax(tmp_path, min_points):
    _write_rules_tree(tmp_path / "tree")
    jroot, proot = _run_both(tmp_path / "tree", tmp_path, 4,
                             min_points=min_points, voxel_size=0.05)
    for s in range(3):
        scene = f"data/scene-{s:06d}/gt.log"
        got = (proot / scene).read_text().splitlines()
        want = (jroot / scene).read_text().splitlines()
        assert [g.split("\t")[:3] for g in got] == \
            [w.split("\t")[:3] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(
                [float(x) for x in g.split("\t")[3:]],
                [float(x) for x in w.split("\t")[3:]], atol=1e-3)
    pairs = [(r["scene_name"][-1], r["src_idx"], r["tgt_idx"])
             for r in gt.parse_gt_log(proot / "metadata" / "gt.log")]
    # cloud 3 of scene 0 is 9 m away: under min_overlap with every cloud
    assert not any(p[0] == "0" and 3 in p[1:] for p in pairs)
    # cloud 1 of scene 0 (40 points) counts only without a floor
    assert any(p[:1] == ("0",) and 1 in p[1:] for p in pairs) == \
        (min_points == 0)
    # the empty cloud's pairs are NaN and never written
    assert not any(p[0] == "1" and 1 in p[1:] for p in pairs)
    # the existing gt.log is kept as it was
    assert ("2", 0, 1) in pairs and len([p for p in pairs
                                         if p[0] == "2"]) == 1


def test_cli_flags_match_jax_and_run_on_the_cpu(tmp_path, monkeypatch,
                                                 capsys):
    ref = _jax_cli("generate_gt", monkeypatch)
    assert _flags(cli.build_parser()) == _flags(ref.build_parser())

    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    _write_rules_tree(tmp_path / "ds")
    cli.main(["-start", "0", "-stop", "2", "--dataset_name", "ds",
              "--num_samples", "4", "--voxel_size", "0.05"])
    printed = capsys.readouterr().out
    assert "scene-000000 src:00 tgt:02" in printed
    records = gt.parse_gt_log(tmp_path / "ds/metadata/gt.log")
    assert {(r["scene_name"], r["src_idx"], r["tgt_idx"])
            for r in records} >= {("scene-000000", 0, 2),
                                  ("scene-000001", 0, 2)}
    cli.main(["-start", "0", "-stop", "2", "--dataset_name", "ds",
              "--disable_tqdm"])
    assert capsys.readouterr().out == ""
