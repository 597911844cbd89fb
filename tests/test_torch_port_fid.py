"""PyTorch port, FID, against the JAX package on the CPU: the Fréchet
distance (its eps fallback and its raise), the activation statistics, the
InceptionV3 features at ``resize_to=75`` for both pool modes (75 as the
JAX package's own ``tests/test_inception.py``: the architecture does not
care about the size past its stem, and XLA's CPU compile stays short), the
bilinear resize up and down against ``jax.image.resize``, the weight
sources, the Trainer's ``calculate_fid`` and the Tester's FID methods."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointreggpt_tpu.eval import fid as jfid
from pointreggpt_tpu.eval import inception as JI
from pointreggpt_tpu.generate.tester import Tester as JTester
from test_torch_port_generator import single_torch_thread  # noqa: F401
from test_torch_port_train import _trainer, write_depth_tree
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.eval import fid
from pointreggpt_tpu_torch.eval import inception as I
from pointreggpt_tpu_torch.generate import tester as port_tester
from pointreggpt_tpu_torch.models import DiffusionUNet

RESIZE = 75
# port vs JAX features at resize 75, measured 2.1e-7 (FID pools) and
# 2.5e-7 (torchvision pools) with features up to 0.64; the tolerance is
# about 8x that, well inside JAX's own ceiling for this comparison (rtol
# 5e-3, atol 5e-4)
FEATURE_ATOL = 2e-6
# the resize alone, up (256 -> 299) and down (480x640 -> 299): measured
# 1.2e-7 on [-1, 1] (one fp32 rounding of the weights' sums)
RESIZE_ATOL = 1e-6


@pytest.fixture(scope="module")
def weights():
    return JI.init_random_params(0), I.init_random_params(0)


@pytest.fixture
def small_extractor(monkeypatch):
    """InceptionFeatures resized to 75 instead of 299, for CPU time."""
    monkeypatch.setattr(fid.InceptionFeatures, "resize_to", RESIZE)


def _jax_features(params, imgs, fid_pools=True):
    return np.asarray(jax.jit(lambda p, x: JI.features(
        p, x, resize_to=RESIZE, fid_pools=fid_pools))(params, imgs))


def _port_model(sd, fid_pools=True):
    return I.load_weights(I.InceptionV3(fid_pools).eval(), sd)


def _images(seed, shape=(2, 60, 80, 1)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def test_random_weights_are_the_jax_draw(weights):
    jp, sd = weights
    assert sd.keys() == I.InceptionV3().state_dict().keys()
    for name, p in jp.items():
        np.testing.assert_array_equal(
            sd[f"{name}.conv.weight"].numpy(),
            p["kernel"].transpose(3, 2, 0, 1))
        for jk, tk in (("scale", "bn.weight"), ("bias", "bn.bias"),
                       ("mean", "bn.running_mean"),
                       ("var", "bn.running_var")):
            np.testing.assert_array_equal(sd[f"{name}.{tk}"].numpy(), p[jk])
    assert I.CONV_SPECS == JI.CONV_SPECS
    assert I.FEATURE_DIM == JI.FEATURE_DIM == 2048


@pytest.mark.parametrize("fid_pools", [True, False])
def test_features_match_jax(weights, fid_pools):
    jp, sd = weights
    imgs = _images(1)
    want = _jax_features(jp, imgs, fid_pools)
    with torch.no_grad():
        got = I.features(_port_model(sd, fid_pools), torch.from_numpy(imgs),
                         RESIZE).numpy()
    assert got.shape == (2, I.FEATURE_DIM)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_ATOL)
    # the features depend on the input: the two images differ by far more
    # than the tolerance (measured 6.4e-3 apart)
    assert np.abs(got[0] - got[1]).max() > 100 * FEATURE_ATOL
    # a planted fault, the pools of the other mode, misses by far more
    model = _port_model(sd, not fid_pools)
    with torch.no_grad():
        bad = I.features(model, torch.from_numpy(imgs), RESIZE).numpy()
    assert np.abs(bad - want).max() > 1000 * FEATURE_ATOL


@pytest.mark.parametrize("shape", [(2, 256, 256, 1), (2, 480, 640, 3)],
                         ids=["up", "down"])
def test_resize_matches_jax_image_resize(shape):
    imgs = _images(2, shape)
    x = jnp.asarray(imgs)
    if shape[-1] == 1:
        x = jnp.repeat(x, 3, axis=-1)
    want = np.asarray(jax.image.resize(
        x, (shape[0], 299, 299, 3), method="bilinear",
        antialias=False)) * 2.0 - 1.0
    got = I.preprocess(torch.from_numpy(imgs)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_load_weights_is_strict(weights):
    _, sd = weights
    # a torchvision-named dict with its classifier heads loads as it is
    tv = dict(sd, **{"fc.weight": torch.zeros(1008, 2048),
                     "fc.bias": torch.zeros(1008),
                     "AuxLogits.conv0.conv.weight": torch.zeros(128, 768,
                                                                1, 1)})
    model = _port_model(tv)
    torch.testing.assert_close(model.Mixed_7c.branch_pool.conv.weight,
                               sd["Mixed_7c.branch_pool.conv.weight"],
                               rtol=0, atol=0)
    bad = dict(sd, **{"Conv2d_1a_3x3.conv.weight": torch.zeros(32, 3, 5, 5)})
    with pytest.raises(RuntimeError, match="Conv2d_1a_3x3"):
        _port_model(bad)
    missing = {k: v for k, v in sd.items() if not k.startswith("Mixed_6b")}
    with pytest.raises(RuntimeError, match="Mixed_6b"):
        _port_model(missing)


def _frechet_cases():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(40, 16)), rng.normal(size=(30, 16)) * 1.3 + 0.2
    return {
        "random": (*jfid.activation_statistics(a),
                   *jfid.activation_statistics(b)),
        "rank_deficient": (*jfid.activation_statistics(a[:6]),
                           *jfid.activation_statistics(b[:5])),
        "zero_covariance": (np.zeros(4), np.zeros((4, 4)), np.zeros(4),
                            np.eye(4)),
        "isotropic": (np.zeros(4), 2.0 * np.eye(4), np.ones(4) * 0.5,
                      0.5 * np.eye(4)),
    }


@pytest.mark.parametrize("case", sorted(_frechet_cases()))
def test_frechet_distance_matches_jax(case):
    args = _frechet_cases()[case]
    want = jfid.calculate_frechet_distance(*args)
    got = fid.calculate_frechet_distance(*args)
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-12,
                                                     abs=1e-12)
    if case == "isotropic":  # |dmu|^2 + d (a + b - 2 sqrt(ab))
        assert got == pytest.approx(4 * 0.25 + 4 * (2.5 - 2.0), rel=1e-9)


def test_frechet_distance_raises_on_an_imaginary_root():
    args = (np.zeros(2), np.eye(2), np.zeros(2), np.diag([-1.0, 1.0]))
    for f in (jfid.calculate_frechet_distance,
              fid.calculate_frechet_distance):
        with pytest.raises(ValueError, match="Imaginary"):
            f(*args)


def test_activation_statistics_match_jax():
    feats = np.random.default_rng(4).normal(size=(50, 12)).astype(np.float32)
    for got, want in zip(fid.activation_statistics(feats),
                         jfid.activation_statistics(feats)):
        np.testing.assert_array_equal(got, want)


def test_extractor_chunks_unpadded_and_weight_sources(
        weights, small_extractor, tmp_path, monkeypatch):
    _, sd = weights
    path = tmp_path / "inception.pth"
    torch.save(sd, path)
    monkeypatch.setenv("PRGPT_INCEPTION_WEIGHTS", str(path))
    ext = fid.InceptionFeatures(chunk=2, device="cpu")
    assert ext.fid_pools and ext.model.fid_pools
    imgs = _images(5, (5, 32, 32, 1))
    feats = ext(imgs)
    assert feats.shape == (5, 2048) and feats.dtype == np.float32
    # chunks of 2, 2 and an unpadded 1 against one chunk of 8; gray is
    # three equal channels
    whole = fid.InceptionFeatures(state_dict=sd, chunk=8, device="cpu")
    np.testing.assert_allclose(feats, whole(imgs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(feats, whole(np.repeat(imgs, 3, -1)),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="2048"):
        fid.InceptionFeatures(block_dim=768, state_dict=sd, device="cpu")

    # no file and neither package: an ImportError that names the variable
    # (and no download)
    monkeypatch.delenv("PRGPT_INCEPTION_WEIGHTS")
    monkeypatch.setitem(sys.modules, "pytorch_fid", None)
    monkeypatch.setitem(sys.modules, "torchvision", None)
    with pytest.raises(ImportError, match="PRGPT_INCEPTION_WEIGHTS") as e:
        fid.InceptionFeatures(device="cpu")
    assert "http" not in str(e.value)


def test_fid_score_uses_the_smaller_set(weights, small_extractor,
                                        monkeypatch):
    _, sd = weights
    ext = fid.InceptionFeatures(state_dict=sd, device="cpu")
    a, b = _images(6, (6, 32, 32, 1)), _images(7, (4, 32, 32, 1))
    seen = []  # the statistics handed to the distance (a 2048-d sqrtm
    # takes seconds; the distance itself is held to JAX's above)
    monkeypatch.setattr(fid, "calculate_frechet_distance",
                        lambda *args: seen.append(args) or 1.5)
    assert fid.fid_score(a, b, ext) == 1.5
    want = (*fid.activation_statistics(ext(a[:4])),
            *fid.activation_statistics(ext(b)))
    for got, w in zip(seen[0], want):
        np.testing.assert_array_equal(got, w)


def test_trainer_logs_a_finite_fid_at_each_milestone(
        weights, small_extractor, tmp_path, monkeypatch):
    _, sd = weights
    torch.save(sd, tmp_path / "inception.pth")
    monkeypatch.setenv("PRGPT_INCEPTION_WEIGHTS",
                       str(tmp_path / "inception.pth"))
    folder, gt_log = write_depth_tree(tmp_path, n_scenes=1, n_frames=4)
    tr = _trainer(tmp_path, folder, gt_log, image_size=16,
                  calculate_fid=True, train_num_steps=2)
    logged = []
    monkeypatch.setattr(tr.logger, "info", logged.append)
    tr.train(log_every=100)
    scores = [float(m.split(": ")[1]) for m in logged
              if m.startswith("fid_score: ")]
    assert len(scores) == 1 and np.isfinite(scores[0]), logged
    # the real set is the last training batch, at its [0, 1] scale
    assert tr._last_batch["img"].shape == (4, 16, 16, 1)
    assert 0.0 <= tr._last_batch["img"].min() <= \
        tr._last_batch["img"].max() <= 1.0


def test_tester_fid_methods_match_jax(weights, small_extractor, tmp_path,
                                      monkeypatch):
    jp, sd = weights
    torch.save(sd, tmp_path / "inception.pth")
    monkeypatch.setenv("PRGPT_INCEPTION_WEIGHTS",
                       str(tmp_path / "inception.pth"))
    tester = port_tester.Tester(DiffusionUNet(dim=8, dim_mults=(1, 2)),
                    GaussianDiffusion(image_size=16, timesteps=16),
                    samples_folder=str(tmp_path / "smp"), device="cpu")
    jt = object.__new__(JTester)  # its FID methods read no other state
    jt._inception = jfid.InceptionFeatures(params=jp)
    jt._inception._fn = jax.jit(
        lambda p, x: JI.features(p, x, resize_to=RESIZE))
    imgs = _images(8, (3, 40, 40, 1))
    got = tester.compute_inception_features(imgs)
    assert tester._inception is not None  # built once, on the first call
    np.testing.assert_allclose(got, jt.compute_inception_features(imgs),
                               rtol=0, atol=FEATURE_ATOL)

    rng = np.random.default_rng(9)
    real, fake = rng.normal(size=(40, 16)), rng.normal(size=(35, 16)) + 0.3
    for g, w in zip(tester.calculate_activation_statistics(real),
                    JTester.calculate_activation_statistics(real)):
        np.testing.assert_array_equal(g, w)
    assert tester.fid_score(real, fake) == pytest.approx(
        jt.fid_score(real, fake), rel=1e-12)
