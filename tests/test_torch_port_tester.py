"""PyTorch port: the Tester and what it calls (occlusion filter, the
FoV-bounded rotation, ``keep_nearest``, batched voxel downsampling, the
ancestral chain, the colormapped PNGs, the CLI) against the JAX package on
the CPU."""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pointreggpt_tpu.core import geometry as JG
from pointreggpt_tpu.core import pointops as JP
from pointreggpt_tpu.core import sampling as JS
from pointreggpt_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from pointreggpt_tpu.generate import Tester as JTester
from test_torch_port_generator import (H, make_nets,  # noqa: F401
                                       save_port_checkpoints,
                                       single_torch_thread)
from pointreggpt_tpu_torch.cli import test_successive_ddnm_diffusion as cli
from pointreggpt_tpu_torch.core import geometry as G
from pointreggpt_tpu_torch.core import pointops as P
from pointreggpt_tpu_torch.core import sampling as S
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.generate import tester as tester_mod
from pointreggpt_tpu_torch.generate.tester import Tester as SceneTester

# fp32 chain parity: the repo's bound for a short chain of a dim-8 net
# (tests/test_torch_parity.py, test_step_matches_jax_step_body)
ATOL, RTOL = 5e-4, 1e-3
T = 8  # timesteps of the test chains
t_ = torch.from_numpy


@pytest.fixture(scope="module")
def nets():
    return make_nets()


def _intrinsics(b):
    intr = np.asarray(JS.INTRINSIC_CANDIDATES)[[4, 0, 5, 2][:b]]
    return JG.intrinsic_transform(intr, resize=256,
                                  centercrop=256).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_occlusion_filter_matches_jax(seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 3.0, (2, 24, 20)).astype(np.float32)
    depth[:, 5:9, 5:9] += 0.2  # a see-through patch behind a near surface
    mask = rng.uniform(size=depth.shape) < 0.7
    ref = JG.occlusion_filter(jnp.asarray(depth), jnp.asarray(mask))
    got = G.occlusion_filter(t_(depth), t_(mask))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert (got[0].numpy() != depth).any()


def test_random_sample_transform_from_jax_uniforms():
    intr = _intrinsics(4)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(JS.random_sample_transform(key, jnp.asarray(intr), 256))
    # the JAX sampler's own draws: pitch, yaw, roll from three split keys
    u = np.stack([np.asarray(jax.random.uniform(k, (4,)))
                  for k in jax.random.split(key, 3)])
    got = S.transform_from_uniforms(t_(u), t_(intr), 256).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    # and the port's own draws give rotations of the same kind
    pose = S.random_sample_transform(torch.Generator().manual_seed(0),
                                     t_(intr), 256).numpy()
    rot = pose[:, :3, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-6)
    np.testing.assert_array_equal(pose[:, :3, 3], 0.0)


def _tied_cloud():
    """(2, 12, 3) points with planted distance ties and invalid entries.
    The ties are sign flips of one point, whose squared norms are equal
    in any rounding (an axis swap is not: the JAX package's compiled sum
    fuses multiply-adds, so x^2 + y^2 and y^2 + x^2 round apart)."""
    base = np.array([[0.3, 0.4, 1.2], [0.5, 0.1, 0.2], [1.0, 1.0, 0.0]],
                    np.float32)
    rows = []
    for r in range(2):
        pts = np.concatenate([base[[1, 0, 2]] * [[1, -1, 1]],
                              base * [[-1, 1, 1]], base * [[1, 1, -1]],
                              base], axis=0)[np.roll(np.arange(12), r)]
        rows.append(pts)
    valid = np.ones((2, 12), bool)
    valid[0, [2, 7]] = False
    valid[1, 0] = False
    return np.stack(rows).astype(np.float32), valid


@pytest.mark.parametrize("capacity", [3, 5, 9])
def test_keep_nearest_breaks_ties_as_jax(capacity):
    pts, valid = _tied_cloud()
    ref = JP.keep_nearest(jnp.asarray(pts), jnp.asarray(valid), capacity)
    got = P.keep_nearest(t_(pts), t_(valid), capacity)
    assert (np.asarray(ref[2]) > 0).all()  # every row overflows
    # the same points in the same order, ties by index
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[2].dtype == torch.int64


@pytest.mark.parametrize("capacity", [11, 12, 16])
def test_keep_nearest_without_overflow(capacity):
    """No row overflows: the JAX package keeps the valid points in input
    order (its prefix fast path), the port sorts them by distance; the
    same points either way, and the padding of capacity >= n exact."""
    pts, valid = _tied_cloud()
    ref = JP.keep_nearest(jnp.asarray(pts), jnp.asarray(valid), capacity)
    got = P.keep_nearest(t_(pts), t_(valid), capacity)
    np.testing.assert_array_equal(got[2].numpy(), 0)
    np.testing.assert_array_equal(got[1].numpy().sum(1),
                                  np.asarray(ref[1]).sum(1))
    for r in range(2):
        kept = got[0].numpy()[r][got[1].numpy()[r]]
        want = np.asarray(ref[0])[r][np.asarray(ref[1])[r]]
        np.testing.assert_array_equal(np.sort(kept, axis=0),
                                      np.sort(want, axis=0))
        if capacity < pts.shape[1]:  # selected: nearest first
            d2 = (kept * kept).sum(-1)
            assert (np.diff(d2) >= 0).all()
    if capacity >= pts.shape[1]:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_voxel_downsample_batched_matches_jax_and_rows():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.2, 0.2, (3, 700, 3)).astype(np.float32)
    pts[1] += 5.0  # another origin per row
    valid = rng.uniform(size=(3, 700)) < 0.8
    valid[2] = False  # an empty row
    ref = JP.voxel_downsample_batched(jnp.asarray(pts), jnp.asarray(valid),
                                      0.05)
    got = P.voxel_downsample_batched(t_(pts), t_(valid), 0.05)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    # centroids: sums in another order, a few fp32 ulps of a 5 m value
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               atol=2e-6, rtol=0)
    for r in range(3):
        row = P.voxel_downsample(t_(pts[r]), t_(valid[r]), 0.05)
        np.testing.assert_array_equal(got[0][r].numpy(), row[0].numpy())
        np.testing.assert_array_equal(got[1][r].numpy(), row[1].numpy())


def _jax_diffusion(nets, **kw):
    jm = nets[0]
    return JGaussianDiffusion(
        apply_fn=lambda p, x, t, pc: jm.apply(p, x, t, pc), image_size=H,
        timesteps=T, objective="pred_x0", beta_schedule="sigmoid", **kw)


def _condition(b, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(b, H, H)) > 0.5).astype(np.float32)
    depth = rng.uniform(0.1, 0.4, (b, H, H)).astype(np.float32)
    return (np.stack([depth, mask], -1) * 2.0 - 1.0).astype(np.float32)


@pytest.mark.parametrize("refine", [False, True])
def test_p_sample_loop_matches_jax_with_its_noise(nets, refine):
    _, params, *_, tm, _ = nets
    jd = _jax_diffusion(nets, sampling_timesteps=T)
    td = GaussianDiffusion(image_size=H, timesteps=T, objective="pred_x0",
                           beta_schedule="sigmoid")
    assert not jd.is_ddim_sampling and not td.is_ddim_sampling
    b = 2
    rng = np.random.default_rng(4)
    x_init = rng.normal(size=(b, H, H, 1)).astype(np.float32)
    pc = np.array([[40.0, 40.0, 16.0, 16.0], [35.0, 36.0, 16.0, 16.0]],
                  np.float32)
    cond = _condition(b, 5)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jax.jit(lambda k: jd.p_sample_loop(
        params, k, jnp.asarray(pc), jnp.asarray(cond), (b, H, H, 1),
        has_refine_step=refine, x_init=jnp.asarray(x_init)))(key))
    # the chain's own draws: step i (t = T - 1 - i) takes the second half
    # of the i-th key split from the scan key
    _, k_scan, _ = jax.random.split(key, 3)
    noise = {T - 1 - i: np.array(jax.random.normal(
        jax.random.split(k)[1], (b, H, H, 1), jnp.float32))
        for i, k in enumerate(jax.random.split(k_scan, T))}
    got = td.p_sample_loop(tm, t_(pc), t_(cond), (b, H, H, 1),
                           has_refine_step=refine, x_init=t_(x_init),
                           noise=lambda t: t_(noise[t])).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    # the draws matter: other noise moves the output far past the bound
    other = td.p_sample_loop(tm, t_(pc), t_(cond), (b, H, H, 1),
                             has_refine_step=refine, x_init=t_(x_init),
                             generator=torch.Generator().manual_seed(0))
    assert np.abs(other.numpy() - ref).max() > 100 * ATOL


def _tester(nets, root: Path, **kw):
    *_, tm, tdc = nets
    if not (root / "results").exists():
        save_port_checkpoints(root, tm, tdc)
    diffusion = GaussianDiffusion(image_size=H, timesteps=T,
                                  objective="pred_x0",
                                  beta_schedule="sigmoid", **kw)
    tester = SceneTester(type(tm)(dim=8, dim_mults=(1, 2)), diffusion,
                    batch_size=2, results_folder=str(root / "results"),
                    samples_folder=str(root / "samples"), device="cpu")
    tester.load(1)
    return tester


@pytest.mark.parametrize("apply_occlusion", [False, True])
def test_tester_step_matches_jax(nets, tmp_path, apply_occlusion):
    _, params, *_ = nets
    jd = _jax_diffusion(nets, sampling_timesteps=4, ddim_sampling_eta=0.0)
    tester = _tester(nets, tmp_path, sampling_timesteps=4,
                     ddim_sampling_eta=0.0)
    b = 2
    intr = np.zeros((b, 3, 3), np.float32)
    intr[:, 0, 0] = intr[:, 1, 1] = 36.0
    intr[:, 0, 2] = intr[:, 1, 2] = H / 2
    intr[:, 2, 2] = 1.0
    rng = np.random.default_rng(8)
    images = rng.uniform(0.15, 0.3, (b, H, H, 1)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose[:, :3, 3] = [0.0, 0.0, 0.5]
    x_init = rng.normal(size=(b, H, H, 1)).astype(np.float32)
    pc = np.array(JG.param_vector(jnp.asarray(intr)))

    depth_ref, cond_ref = JTester._reproject_impl(
        None, jnp.asarray(images), jnp.asarray(intr), jnp.asarray(pose),
        jnp.asarray(float(apply_occlusion)))
    ref = np.asarray(jd.sample(params, jax.random.PRNGKey(0),
                               param_cond=jnp.asarray(pc), img_cond=cond_ref,
                               x_init=jnp.asarray(x_init)))
    out = tester.step(t_(images), t_(intr), t_(pc), t_(pose),
                      apply_occlusion, x_init=t_(x_init))
    # the same splat: depths carry transform_points' last-ulp sum order
    np.testing.assert_allclose(out.depth_rpj.numpy(), np.asarray(depth_ref),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out.img_cond.numpy()[..., 1],
                                  np.asarray(cond_ref)[..., 1])
    assert (np.asarray(cond_ref)[..., 1] > 0).mean() > 0.3
    np.testing.assert_allclose(out.images.numpy(), ref, atol=ATOL,
                               rtol=RTOL)


def _png_sizes(folder: Path):
    return {p.name: Image.open(p).size for p in folder.glob("*.png")}


def test_tester_writes_the_jax_testers_files(nets, tmp_path):
    _, params, *_ = nets
    jd = _jax_diffusion(nets, sampling_timesteps=2)
    jt = JTester(nets[0], jd, batch_size=2,
                 results_folder=str(tmp_path / "jr"),
                 samples_folder=str(tmp_path / "jax"))
    jt.ema_params = params
    tester = _tester(nets, tmp_path, sampling_timesteps=2)
    for t in (jt, tester):
        t.sample(num_scenes=3, num_samples=2)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "samples"
    names = sorted(p.name for p in jax_dir.iterdir())
    assert sorted(p.name for p in port_dir.iterdir()) == names
    assert "overview.png" in names and "scene-2-sample-1.ply" in names
    assert _png_sizes(port_dir) == _png_sizes(jax_dir)
    assert _png_sizes(port_dir)["overview.png"] == (3 * H * 2, 3 * H)
    for t in (jt, tester):
        t.generate(num_scenes=3, num_samples=2, voxel_size=0.05,
                   memory_capacity=H * H // 2)
    names = sorted(p.name for p in jax_dir.iterdir())
    assert sorted(p.name for p in port_dir.iterdir()) == names
    assert "scene-2.ply" in names and "scene-2-memory.ply" in names
    assert _png_sizes(port_dir) == _png_sizes(jax_dir)
    im = np.asarray(Image.open(port_dir / "overview.png"))
    assert im.shape == (3 * H, 3 * H * 2, 4) and (im[..., 3] == 255).all()


def test_sample_uncondition_grid(nets, tmp_path):
    tester = _tester(nets, tmp_path, sampling_timesteps=2)
    images = tester.sample_uncondition(num_samples=4)
    assert images.shape == (4, H, H, 1)
    assert np.isfinite(images).all()
    assert Image.open(tmp_path / "samples/unconditional.png").size == (
        2 * H, 2 * H)


@pytest.mark.parametrize("cmap", ["gray", "plasma"])
def test_pngs_match_matplotlib_pixel_for_pixel(tmp_path, cmap):
    from matplotlib import image as mpimg

    rng = np.random.default_rng(2)
    x = rng.uniform(-0.2, 1.2, (40, 120)).astype(np.float32)
    x[0, :6] = [0.0, 1.0, 0.5, 255 / 256, 1 / 256, np.nan]
    mpimg.imsave(str(tmp_path / "ref.png"), np.clip(x, 0.0, 1.0),
                 cmap=cmap, vmin=0, vmax=1)
    tester_mod._imsave(tmp_path / "got.png", x, cmap)
    ref = np.asarray(Image.open(tmp_path / "ref.png"))
    got = np.asarray(Image.open(tmp_path / "got.png"))
    assert got.shape == ref.shape == (40, 120, 4)
    np.testing.assert_array_equal(got, ref)


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.required,
                     a.nargs, getattr(a.type, "__name__", None))
            for a in parser._actions if a.dest != "help"}


def _jax_cli(name, monkeypatch):
    # the JAX CLI modules set a persistent compile cache at import
    monkeypatch.setenv("PRGPT_COMP_CACHE", "0")
    return importlib.import_module(f"pointreggpt_tpu.cli.{name}")


def test_cli_flags_and_defaults_match_jax(monkeypatch, capsys):
    ref = _jax_cli("test_successive_ddnm_diffusion", monkeypatch)
    got, want = _flags(cli.build_parser()), _flags(ref.build_parser())
    assert got.keys() == want.keys()
    for k in want:
        # bool and tuple flags use each package's own parse function
        assert got[k][:4] == want[k][:4], k
    assert got["sampling_timesteps"][1] == 32
    assert got["ddim_sampling_eta"][1] == 1.0
    with pytest.raises(SystemExit):
        cli.main([])
    assert "--resume is required" in capsys.readouterr().err


def test_cli_runs_on_the_cpu(nets, tmp_path, monkeypatch):
    *_, tm, tdc = nets
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    save_port_checkpoints(tmp_path, tm, tdc)
    cli.main(["--resume", "1", "--results_folder", str(tmp_path / "results"),
              "--samples_folder", str(tmp_path / "s"), "--num_scenes", "3",
              "--num_samples", "2", "--batch_size", "2", "--dim", "8",
              "--dim_mults", "1,2", "--image_size", str(H), "--timesteps",
              str(T), "--sampling_timesteps", "2"])
    sizes = _png_sizes(tmp_path / "s")
    assert sizes["scene-0-sample-1.png"] == (3 * H, H)
    assert sizes["overview.png"] == (3 * H * 2, 3 * H)
    for sid in range(3):
        assert (tmp_path / "s" / f"scene-{sid}-camera-intrinsics.txt"
                ).is_file()
