"""PyTorch port: the rest of the JAX package's surface against the JAX
package on the CPU: the PLY reader, ``image_condition`` and the geometry /
point helpers, the Haar rotation, ``depth_downsample``, the Fourier time
embedding and the DiffusionUNet's optional heads (forwards and
gradients), the posterior helpers, ``denoise`` and ``interpolate`` on the
JAX draws, ``build_diffusion``'s refusals, JAX ``.ckpt`` files read by
every loader and CLI, and the native host library."""

import io
import pickle
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from pointreggpt_tpu import config as JC
from pointreggpt_tpu import native as jnative
from pointreggpt_tpu.core import geometry as JG
from pointreggpt_tpu.core import plyio as JPLY
from pointreggpt_tpu.core import pointops as JP
from pointreggpt_tpu.core import sampling as JS
from pointreggpt_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from pointreggpt_tpu.models import DiffusionUNet as JDiffusionUNet
from pointreggpt_tpu.models import blocks as JB
from pointreggpt_tpu.train import checkpoint as jckpt
from pointreggpt_tpu.utils import torch_port
from test_torch_port_generator import (_template, make_nets,  # noqa: F401
                                       single_torch_thread, write_tree)
from test_torch_port_mask import write_motion_tree
from test_torch_port_train import write_depth_tree
from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch import native
from pointreggpt_tpu_torch.cli import generate_dataset
from pointreggpt_tpu_torch.cli import import_torch_checkpoint as import_cli
from pointreggpt_tpu_torch.cli import test_depth_correction as mask_test_cli
from pointreggpt_tpu_torch.cli import test_successive_ddnm_diffusion as \
    tester_cli
from pointreggpt_tpu_torch.cli import train_depth_correction as mask_cli
from pointreggpt_tpu_torch.cli import train_successive_ddnm_diffusion as \
    train_cli
from pointreggpt_tpu_torch.core import geometry as G
from pointreggpt_tpu_torch.core import imageio16
from pointreggpt_tpu_torch.core import plyio as PLY
from pointreggpt_tpu_torch.core import pointops as P
from pointreggpt_tpu_torch.core import sampling as S
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.generate import Generator
from pointreggpt_tpu_torch.generate.generator import load_ema_unet
from pointreggpt_tpu_torch.models import DiffusionUNet
from pointreggpt_tpu_torch.models import blocks as B
from pointreggpt_tpu_torch.train import checkpoint as ckpt
from pointreggpt_tpu_torch.utils import jax_params
from pointreggpt_tpu_torch.utils import jax_parity as J
from pointreggpt_tpu_torch.utils.seeded_weights import seeded_state_dict

DATA = Path(__file__).resolve().parent / "data"
DIFFUSION_CKPT = DATA / "torch_port_jax_diffusion.ckpt"
MASK_CKPT = DATA / "torch_port_jax_mask.ckpt"
H = 16
T = 8  # timesteps of the test chains
t_ = torch.from_numpy
# tolerances by kind of output: geometry, fp32 nets, short chains
GEOMETRY, NET, CHAIN = 1e-6, 1e-5, 1e-4


# ---------------------------------------------------------------------------
# PLY reading


def _ply(path: Path, fmt: str, props, rows, *, faces=0, newline="\n",
         before=None):
    """A PLY file of ``rows`` (one tuple per vertex) with ``props`` [(type,
    name)], ``faces`` trailing triangles, optional element ``before`` the
    vertex one."""
    head = ["ply", f"format {fmt} 1.0"]
    if before:
        head += [f"element {before} 1", "property int id"]
    head += [f"element vertex {len(rows)}"]
    head += [f"property {t} {n}" for t, n in props]
    if faces:
        head += [f"element face {faces}",
                 "property list uchar int vertex_indices"]
    head += ["end_header"]
    data = newline.join(head).encode() + newline.encode()
    if fmt == "ascii":
        lines = [" ".join(str(v) for v in r) for r in rows]
        lines += ["3 0 1 2"] * faces
        data += ("\n".join(lines) + "\n").encode()
    else:
        dt = np.dtype([(n, np.dtype(JPLY._DTYPES[t]).newbyteorder("<"))
                       for t, n in props])
        data += np.array([tuple(r) for r in rows], dtype=dt).tobytes()
        for _ in range(faces):
            data += bytes([3]) + np.array([0, 1, 2], "<i4").tobytes()
    path.write_bytes(data)
    return path


def _rows(n, extra, seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.round(rng.uniform(-2, 2, (n, 3)), 4)
    return [tuple(p) + tuple(e) for p, e in zip(xyz, extra(rng, n))]


XYZ = [("float", "x"), ("float", "y"), ("float", "z")]
NORMALS = [("float", "nx"), ("float", "ny"), ("float", "nz")]
COLOURS = [("uchar", "red"), ("uchar", "green"), ("uchar", "blue")]
LAYOUTS = {
    "ascii_normals_colours": ("ascii", XYZ + NORMALS + COLOURS, 0, "\n"),
    "binary_uchar_colours": ("binary_little_endian", XYZ + COLOURS, 0, "\n"),
    "binary_double": ("binary_little_endian",
                      [("double", "x"), ("double", "y"), ("double", "z")],
                      0, "\n"),
    "binary_every_scalar": ("binary_little_endian",
                            [("char", "a"), ("short", "b"), ("ushort", "c"),
                             ("float32", "x"), ("int", "d"), ("uint", "e"),
                             ("float64", "y"), ("uint8", "f"),
                             ("int16", "g"), ("float", "z")], 0, "\n"),
    "ascii_faces": ("ascii", XYZ, 2, "\n"),
    "binary_faces_crlf": ("binary_little_endian", XYZ + NORMALS, 3, "\r\n"),
    "ascii_crlf": ("ascii", [("float", "z"), ("float", "y"),
                             ("float", "x")], 0, "\r\n"),
}


def _extra(props):
    n_extra = len(props) - 3

    def draw(rng, n):
        return rng.integers(0, 100, (n, n_extra))
    return draw


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_read_ply_reads_what_jax_reads(tmp_path, layout):
    """Each layout the JAX reader takes, read exactly as JAX reads it: a
    reader of only the x/y/z-only binary file that ``write_ply`` makes
    raises on all of them but ``binary_double``."""
    fmt, props, faces, nl = LAYOUTS[layout]
    if layout == "binary_every_scalar":
        rng = np.random.default_rng(1)
        rows = [(int(rng.integers(-100, 100)), int(rng.integers(-999, 999)),
                 int(rng.integers(0, 999)), float(np.float32(rng.normal())),
                 int(rng.integers(-9, 9)), int(rng.integers(0, 9)),
                 float(rng.normal()), int(rng.integers(0, 255)),
                 int(rng.integers(-9, 9)), float(np.float32(rng.normal())))
                for _ in range(5)]
    else:
        rows = _rows(5, _extra(props))
    path = _ply(tmp_path / "a.ply", fmt, props, rows, faces=faces,
                newline=nl)
    got = PLY.read_ply(path)
    want = JPLY.read_ply(path)
    assert got.dtype == np.float64 and got.shape == (5, 3)
    np.testing.assert_array_equal(got, want)


def _bad_plys(tmp_path):
    """{name: path} of files both readers must reject."""
    rows = _rows(3, _extra(XYZ))
    raw = {
        "no_end_header": b"ply\nformat ascii 1.0\n",
        "truncated_header": b"ply\nformat ascii 1.0\nelement vertex 1\n"
                            b"end_header",
        "list_in_vertex": b"ply\nformat ascii 1.0\nelement vertex 1\n"
                          b"property float x\nproperty list uchar int i\n"
                          b"end_header\n0 0\n",
        "no_vertex": b"ply\nformat ascii 1.0\nelement face 0\nend_header\n",
    }
    out = {name: tmp_path / f"{name}.ply" for name in raw}
    for name, data in raw.items():
        out[name].write_bytes(data)
    out["vertex_not_first"] = _ply(tmp_path / "b.ply",
                                   "binary_little_endian", XYZ, rows,
                                   before="camera")
    out["missing_axis"] = _ply(tmp_path / "f.ply", "ascii", XYZ[:2],
                               [(1, 2), (3, 4)])
    out["big_endian"] = _ply(tmp_path / "g.ply", "binary_big_endian", XYZ,
                             rows)
    return out


def test_read_ply_rejects_what_jax_rejects(tmp_path):
    bad = _bad_plys(tmp_path)
    assert len(bad) == 7
    for name, path in bad.items():
        with pytest.raises(ValueError) as want:
            JPLY.read_ply(path)
        with pytest.raises(ValueError) as got:
            PLY.read_ply(path)
        assert str(got.value) == str(want.value), name


def test_mixture_loader_reads_other_plys(tmp_path):
    from pointreggpt_tpu_torch.dataloaders import mixture

    fmt, props, faces, nl = LAYOUTS["ascii_normals_colours"]
    rows = _rows(6, _extra(props), seed=3)
    path = _ply(tmp_path / "a.ply", fmt, props, rows, faces=faces)
    np.testing.assert_array_equal(mixture.load_point_cloud(str(path)),
                                  np.array([r[:3] for r in rows]))


# ---------------------------------------------------------------------------
# geometry, point ops, sampling


def _frames(b=2, h=24, w=20, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    depth = np.stack([0.24 + 0.04 * np.sin(xx / 5.0 + i) * np.cos(yy / 4.0)
                      + 0.001 * rng.uniform(size=(h, w)) for i in range(b)])
    depth[0, 3:6, 4:9] = 0.0  # holes
    intr = np.tile(np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]],
                            np.float32), (b, 1, 1))
    pose = J._pose(rng, b)
    pose[:, :3, 3] *= 0.2
    return (depth.astype(np.float32), intr, pose.astype(np.float32))


@pytest.mark.parametrize("occlusion", [False, True])
def test_image_condition_matches_jax(occlusion):
    depth, intr, pose = _frames()
    want = np.asarray(JG.image_condition(
        jnp.asarray(depth), jnp.asarray(intr), jnp.asarray(pose),
        use_occlusion_filter=occlusion))
    got = G.image_condition(t_(depth), t_(intr), t_(pose),
                            use_occlusion_filter=occlusion).numpy()
    assert got.shape == (2, 24, 20, 2)
    np.testing.assert_allclose(got, want, atol=GEOMETRY, rtol=0)
    assert 0.2 < (want[..., 1] > 0).mean() < 1.0  # a partial mask


def test_null_image_condition_matches_jax():
    want = np.asarray(JG.null_image_condition(3, 8))
    got = G.null_image_condition(3, 8).numpy()
    np.testing.assert_array_equal(got, want)
    assert not G.mask_from_image_condition(t_(got)).any()


def test_depth_image_np_matches_jax():
    rng = np.random.default_rng(2)
    pc = rng.uniform([-1, -1, 0.5], [1, 1, 3], (500, 3)).astype(np.float32)
    pc[:20, 2] = 0.0  # behind the camera plane: dropped
    pc[20:30] = pc[30:40] * [1, 1, 1.5]  # ties: the nearest wins
    intr = np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]])
    want = JG.depth_image_np(pc, intr, (60, 80))
    got = G.depth_image_np(pc, intr, (60, 80))
    np.testing.assert_allclose(got[0], want[0], atol=GEOMETRY, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.float32 and 100 < got[1].sum() < 480


@pytest.mark.parametrize("batched", [False, True])
def test_crop_bbox_matches_jax(batched):
    rng = np.random.default_rng(3)
    shape = (2, 300, 3) if batched else (300, 3)
    pts = rng.uniform(-2, 4, shape).astype(np.float32)
    pts[..., :5, :] = [1.5, -1.5, 3.5]  # on the box's faces: inside
    valid = rng.uniform(size=shape[:-1]) < 0.9
    valid[..., :5] = True
    lo, hi = (-1.5, -1.5, 0.5), (1.5, 1.5, 3.5)
    want = np.asarray(JP.crop_bbox(jnp.asarray(pts), jnp.asarray(valid),
                                   lo, hi))
    got = P.crop_bbox(t_(pts), t_(valid), lo, hi).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[..., :5].all() and 0.1 < want.mean() < 0.9


def test_overlap_region_matches_jax():
    rng = np.random.default_rng(4)
    src = rng.uniform(0, 0.5, (400, 3)).astype(np.float32)
    tgt = (src[:300] + rng.normal(0, 0.01, (300, 3))).astype(np.float32)
    tgt = np.concatenate([tgt, rng.uniform(2, 3, (100, 3))]).astype(
        np.float32)
    src_valid = rng.uniform(size=400) < 0.95
    tgt_valid = rng.uniform(size=400) < 0.95
    want = np.asarray(JP.overlap_region(
        jnp.asarray(src), jnp.asarray(src_valid), jnp.asarray(tgt),
        jnp.asarray(tgt_valid), voxel_size=0.02))
    got = P.overlap_region(t_(src), t_(src_valid), t_(tgt), t_(tgt_valid),
                           voxel_size=0.02).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.95 and not got[~src_valid].any()


def test_haar_uniform_rotation_matches_jax_on_its_draw():
    key = jax.random.PRNGKey(11)
    want = np.asarray(JS.haar_uniform_rotation(key, 16))
    z = np.asarray(jax.random.normal(key, (16, 3, 3)))
    got = S.haar_uniform_rotation(16, z=t_(z)).numpy()
    np.testing.assert_allclose(got, want, atol=GEOMETRY, rtol=0)
    own = S.haar_uniform_rotation(64, generator=torch.Generator()
                                  .manual_seed(0)).numpy()
    np.testing.assert_allclose(own @ own.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), own.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(own), 1.0, atol=1e-5)


@pytest.mark.parametrize("hw", [(16, 20), (15, 21)])
def test_depth_downsample_matches_jax(hw):
    rng = np.random.default_rng(5)
    d = rng.uniform(0.1, 1.0, (2,) + hw + (1,)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.4] = 0.0
    d[0, :2, :2] = 0.0  # an all-invalid window keeps its zero
    want = np.asarray(JB.DepthDownsample().apply({}, jnp.asarray(d)))
    got = B.depth_downsample(t_(d).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=GEOMETRY, rtol=0)
    assert got[0, 0, 0, 0] == 0.0


@pytest.mark.parametrize("is_random", [False, True])
def test_fourier_embedding_matches_jax(is_random):
    emb = B.RandomOrLearnedSinusoidalPosEmb(16, is_random=is_random)
    assert emb.weights.requires_grad is not is_random
    t = np.array([0.0, 3.0, 517.0, 999.0], np.float32)
    want = np.asarray(JB.RandomOrLearnedSinusoidalPosEmb(
        16, is_random=is_random).apply(
        {"params": {"weights": emb.weights.detach().numpy()}},
        jnp.asarray(t)))
    got = emb(t_(t)).detach().numpy()
    assert got.shape == (4, 17)
    np.testing.assert_allclose(got, want, atol=GEOMETRY, rtol=0)


# ---------------------------------------------------------------------------
# the DiffusionUNet's optional surface

OPTIONS = {
    "learned_variance": dict(learned_variance=True),
    "learned_sinusoidal_cond": dict(learned_sinusoidal_cond=True,
                                    learned_sinusoidal_dim=8),
    "fourier_and_variance": dict(random_fourier_features=True,
                                 learned_variance=True),
}


def _jax_option_net(kw, seed=0):
    """A port DiffusionUNet (dim 8) with the options ``kw`` from torch's
    init, and its JAX twin's params through ``torch_port``."""
    torch.manual_seed(seed)
    net = DiffusionUNet(dim=8, dim_mults=(1, 2), **kw)
    jm = JDiffusionUNet(dim=8, dim_mults=(1, 2), **kw)
    params = torch_port.port_diffusion_unet(
        net.state_dict(), _template(jm, jnp.zeros((1, H, H, 1)),
                                    jnp.zeros((1,)), jnp.zeros((1, 4))),
        num_stages=2)
    return jm, params, net


def _net_inputs(seed=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, H, H, 1)).astype(np.float32),
            np.array([40.0, 730.0], np.float32),
            rng.uniform(0.5, 1.5, (2, 4)).astype(np.float32),
            rng.standard_normal((2, H, H, 2)).astype(np.float32))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_forward_and_gradients_match_jax(option):
    """fp32 forward within 1e-5 of the output's largest magnitude, every
    gradient within 1e-5 of the net's largest gradient (measured: 5e-6 /
    8 and 6.6e-6 at most); the frozen frequencies get no gradient, as
    JAX's stop-gradient gives them none."""
    kw = OPTIONS[option]
    jm, params, net = _jax_option_net(kw)
    x, t, pc, w = _net_inputs()
    channels = 2 if kw.get("learned_variance") else 1
    w = w[..., :channels]

    def loss(p):
        y = jm.apply(p, x, t, pc)
        return jnp.sum(y * w), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want = np.asarray(want)
    ref = jax_params.diffusion_unet_from_jax(
        jax.tree_util.tree_map(np.asarray, grads), net)
    y = net(t_(x).permute(0, 3, 1, 2), t_(t), t_(pc)).permute(0, 2, 3, 1)
    assert y.shape == (2, H, H, channels)
    np.testing.assert_allclose(y.detach().numpy(), want,
                               atol=NET * np.abs(want).max(), rtol=0)
    (y * t_(w)).sum().backward()
    g_max = max(float(v.abs().max()) for v in ref.values())
    for name, prm in net.named_parameters():
        r = ref[name].numpy()
        if not prm.requires_grad:  # the frozen Fourier frequencies
            assert name == "time_mlp.0.weights" and prm.grad is None
            np.testing.assert_array_equal(r, 0.0)
            continue
        np.testing.assert_allclose(prm.grad.numpy(), r, atol=NET * g_max,
                                   rtol=0, err_msg=name)
    if kw.get("learned_sinusoidal_cond"):
        assert np.abs(ref["time_mlp.0.weights"].numpy()).max() > 0


def test_default_net_keeps_its_state_dict():
    net = C.build_diffusion_unet(C.ModelConfig(dim=8, dim_mults=(1, 2)))
    sd = net.state_dict()
    assert "time_mlp.0.weights" not in sd
    assert sd["time_mlp.1.weight"].shape == (32, 8)
    assert sd["final_conv.weight"].shape == (1, 8, 1, 1)
    fourier = C.build_diffusion_unet(C.ModelConfig(
        dim=8, dim_mults=(1, 2), random_fourier_features=True,
        learned_variance=True, learned_sinusoidal_dim=6))
    fsd = fourier.state_dict()
    assert set(fsd) - set(sd) == {"time_mlp.0.weights"}
    assert fsd["time_mlp.0.weights"].shape == (3,)
    assert fsd["time_mlp.1.weight"].shape == (32, 7)
    assert fsd["final_conv.weight"].shape == (2, 8, 1, 1)
    seeded = seeded_state_dict(fourier, 0)
    assert 0.3 < float(seeded["time_mlp.0.weights"].abs().mean()) < 3.0


def test_build_diffusion_refuses_as_jax_does():
    cfg = C.DiffusionConfig(image_size=H)
    for kw in ({"learned_variance": True},
               {"learned_sinusoidal_cond": True},
               {"random_fourier_features": True}):
        mc = dict(dim=8, dim_mults=(1, 2), **kw)
        with pytest.raises(ValueError) as want:
            JC.build_diffusion(JC.DiffusionConfig(image_size=H),
                               JC.build_diffusion_unet(JC.ModelConfig(**mc)))
        with pytest.raises(ValueError) as got:
            C.build_diffusion(cfg, C.build_diffusion_unet(C.ModelConfig(
                **mc)))
        assert str(got.value) == str(want.value)
    model = C.build_diffusion_unet(C.ModelConfig(dim=8, channels=1))
    assert C.build_diffusion(cfg, model).channels == 1


def test_train_cli_fails_where_jax_fails(tmp_path, monkeypatch):
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="learned_variance=True doubles"):
        train_cli.main(["--learned_variance", "true", "--dim", "8",
                        "--results_folder", str(tmp_path / "r")])


# ---------------------------------------------------------------------------
# posterior helpers, denoise, interpolate


@pytest.fixture(scope="module")
def nets():
    return make_nets()


def _diffusions(nets, **kw):
    jm, params = nets[0], nets[1]
    base = dict(image_size=H, timesteps=T, objective="pred_x0",
                beta_schedule="sigmoid", **kw)
    return (JGaussianDiffusion(apply_fn=lambda p, x, t, c: jm.apply(
        p, x, t, c), **base), params, GaussianDiffusion(**base), nets[4])


def test_posterior_helpers_match_jax(nets):
    jd, _, td, _ = _diffusions(nets)
    assert td.num_timesteps == jd.num_timesteps == T
    rng = np.random.default_rng(7)
    a, b = (rng.standard_normal((3, H, H, 1)).astype(np.float32)
            for _ in range(2))
    t = np.array([0, 3, T - 1], np.int32)
    for name in ("predict_start_from_noise", "predict_noise_from_start",
                 "predict_start_from_v"):
        want = np.asarray(getattr(jd, name)(jnp.asarray(a), jnp.asarray(t),
                                            jnp.asarray(b)))
        got = getattr(td, name)(t_(a), t_(t), t_(b)).numpy()
        np.testing.assert_allclose(got, want, atol=GEOMETRY,
                                   rtol=GEOMETRY, err_msg=name)
    want = jd.q_posterior(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))
    got = td.q_posterior(t_(a), t_(b), t_(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GEOMETRY,
                                   rtol=GEOMETRY)


def _condition(b, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(b, H, H)) > 0.5).astype(np.float32)
    depth = rng.uniform(0.1, 0.4, (b, H, H)).astype(np.float32)
    return (np.stack([depth, mask], -1) * 2.0 - 1.0).astype(np.float32)


def _chain_draws(key, b, n_steps, first_t, ddim_pairs=None):
    """The JAX chain's own draws, replayed from its key: x_T, and per
    step t its keep-mask uniforms and its noise (each step's key split in
    two, dropout first)."""
    k_init, k_scan, _ = jax.random.split(key, 3)
    shape = (b, H, H, 1)
    x_t = np.asarray(jax.random.normal(k_init, shape))
    ts = ([int(p[0]) for p in ddim_pairs] if ddim_pairs is not None
          else [first_t - i for i in range(n_steps)])
    unif, noise = {}, {}
    for t, k in zip(ts, jax.random.split(k_scan, n_steps)):
        k_drop, k_noise = jax.random.split(k)
        unif[t] = np.asarray(jax.random.uniform(k_drop, shape))
        noise[t] = np.asarray(jax.random.normal(k_noise, shape,
                                                jnp.float32))
    return x_t, unif, noise


@pytest.mark.parametrize("ddnm", [True, False])
@pytest.mark.parametrize("chain", ["ddim", "ancestral"])
def test_denoise_matches_jax_on_its_draws(nets, chain, ddnm):
    from pointreggpt_tpu.diffusion import schedules as jsched

    steps = 4 if chain == "ddim" else T
    jd, params, td, tm = _diffusions(nets, sampling_timesteps=steps,
                                     is_ddnm_sampling=ddnm,
                                     ddim_sampling_eta=1.0)
    assert jd.is_ddim_sampling == (chain == "ddim")
    b = 2
    pc = np.array([[40.0, 40.0, 8.0, 8.0], [35.0, 36.0, 8.0, 8.0]],
                  np.float32)
    cond = _condition(b, 8)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(lambda k: jd.denoise(
        params, k, param_cond=jnp.asarray(pc), img_cond=jnp.asarray(cond)))(
        key))
    pairs = (jsched.ddim_time_pairs(T, steps) if chain == "ddim" else None)
    x_t, unif, noise = _chain_draws(key, b, steps, T - 1, pairs)
    got = td.denoise(tm, param_cond=t_(pc), img_cond=t_(cond),
                     x_init=t_(x_t), noise=lambda t: t_(noise[t]),
                     uniforms=lambda t: t_(unif[t])).numpy()
    np.testing.assert_allclose(got, want, atol=CHAIN, rtol=0)
    mask = cond[..., 1] > 0
    if ddnm:  # DDNM's table (zero) wins: the masked pixels are pinned
        np.testing.assert_array_equal(got[..., 0][mask],
                                      (cond[..., 0][mask] + 1) / 2)
    # the draws matter: other ones move the output far past the bound
    other = td.denoise(tm, param_cond=t_(pc), img_cond=t_(cond),
                       generator=torch.Generator().manual_seed(0)).numpy()
    assert np.abs(other - want).max() > 100 * CHAIN


@pytest.mark.parametrize("lam", [0.3, 0.5])
def test_interpolate_matches_jax_on_its_draws(nets, lam):
    jd, params, td, tm = _diffusions(nets)
    rng = np.random.default_rng(9)
    x1, x2 = (np.clip(rng.standard_normal((2, H, H, 1)), -1, 1)
              .astype(np.float32) for _ in range(2))
    pc = np.array([[40.0, 40.0, 8.0, 8.0]] * 2, np.float32)
    key = jax.random.PRNGKey(4)
    t = 5
    want = np.asarray(jax.jit(lambda k, a, b: jd.interpolate(
        params, k, a, b, jnp.asarray(pc), t=t, lam=lam))(key, x1, x2))
    k_n1, k_n2, k_scan = jax.random.split(key, 3)
    q = [t_(np.asarray(jax.random.normal(k, x1.shape)))
         for k in (k_n1, k_n2)]
    noise = {t - 1 - i: np.asarray(jax.random.normal(
        jax.random.split(k)[1], x1.shape, jnp.float32))
        for i, k in enumerate(jax.random.split(k_scan, t))}
    got = td.interpolate(tm, t_(x1), t_(x2), t_(pc), t=t, lam=lam,
                         q_noise=q, noise=lambda s: t_(noise[s])).numpy()
    np.testing.assert_allclose(got, want, atol=CHAIN, rtol=0)
    swapped = td.interpolate(tm, t_(x1), t_(x2), t_(pc), t=t, lam=1 - lam,
                             q_noise=q, noise=lambda s: t_(noise[s]))
    if lam != 0.5:
        assert np.abs(swapped.numpy() - want).max() > 100 * CHAIN


@pytest.mark.parametrize("t", [0, T, -1])
def test_interpolate_refuses_t_outside_the_chain(nets, t):
    jd, params, td, tm = _diffusions(nets)
    x = np.zeros((1, H, H, 1), np.float32)
    pc = np.ones((1, 4), np.float32)
    with pytest.raises(ValueError, match="outside"):
        jd.interpolate(params, jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(x), jnp.asarray(pc), t=t)
    with pytest.raises(ValueError, match="outside"):
        td.interpolate(tm, t_(x), t_(x), t_(pc), t=t)


# ---------------------------------------------------------------------------
# JAX .ckpt files read by every loader

SMALL_FLAGS = J.SMALL_FLAGS
DIFFUSION_FLAGS = SMALL_FLAGS[:6]  # --dim, --dim_mults, --bf16


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """``jax``: a results folder holding only the committed JAX ``.ckpt``
    files (the diffusion milestone 7, the depth-correction ``best``);
    ``pt``: the importer's ``.pt`` files of the same two."""
    root = tmp_path_factory.mktemp("ckpt_folders")
    (root / "jax" / "results").mkdir(parents=True)
    (root / "jax" / "dc").mkdir()
    shutil.copy(DIFFUSION_CKPT, root / "jax" / "results" / "model-7.ckpt")
    shutil.copy(MASK_CKPT, root / "jax" / "dc" / "model-best.ckpt")
    import_cli.main(["--diffusion", str(root / "jax" / "results" /
                                        "model-7.ckpt"),
                     "--depth_correction", str(root / "jax" / "dc" /
                                               "model-best.ckpt"),
                     "--diffusion_out", str(root / "pt" / "results"),
                     "--dc_out", str(root / "pt" / "dc"), *SMALL_FLAGS])
    return root


def _equal_trees(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal_trees(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("which", ["diffusion", "mask"])
def test_ckpt_payload_equals_the_importers_pt(folders, which):
    if which == "diffusion":
        net = C.build_diffusion_unet(J.SMALL_MODEL)
        got = ckpt.load_diffusion_checkpoint(
            ckpt.milestone_path(folders / "jax" / "results", 7), net,
            lr=C.TrainConfig().train_lr)
        want = ckpt.load_checkpoint(folders / "pt" / "results" /
                                    "model-7.pt")
    else:
        net = C.build_mask_unet(J.SMALL_MASK)
        got = ckpt.load_mask_checkpoint(
            ckpt.milestone_path(folders / "jax" / "dc", "best"), net,
            lr=C.MaskTrainConfig().train_lr)
        want = ckpt.load_checkpoint(folders / "pt" / "dc" / "model-best.pt")
    _equal_trees(got, want)


def test_milestone_path_prefers_pt_and_names_both_when_missing(folders,
                                                               tmp_path):
    shutil.copytree(folders / "jax" / "results", tmp_path / "r")
    assert ckpt.milestone_path(tmp_path / "r", 7).suffix == ".ckpt"
    shutil.copy(folders / "pt" / "results" / "model-7.pt", tmp_path / "r")
    assert ckpt.milestone_path(tmp_path / "r", 7).suffix == ".pt"
    with pytest.raises(FileNotFoundError) as err:
        ckpt.milestone_path(tmp_path / "r", 8)
    assert "model-8.pt" in str(err.value)
    assert "model-8.ckpt" in str(err.value)


def _generator(root, sub):
    diffusion = C.build_diffusion(C.DiffusionConfig(image_size=H))
    return Generator(C.build_diffusion_unet(J.SMALL_MODEL), diffusion,
                     str(root), batch_size=1,
                     results_folder=str(root / sub / "results"),
                     samples_folder=str(root / "s"),
                     depth_correction_model=C.build_mask_unet(J.SMALL_MASK),
                     depth_correction_results=str(root / sub / "dc"),
                     device="cpu")


def _same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_generator_and_tester_load_a_ckpt_folder(folders, capsys):
    from pointreggpt_tpu_torch.generate.tester import Tester

    gens = {}
    for sub in ("jax", "pt"):
        gen = _generator(folders, sub)
        gen.load(7)
        gen._load_depth_correction()
        gens[sub] = gen
    printed = capsys.readouterr().out
    assert "model-7.ckpt" in printed and "model-best.ckpt" in printed
    _same_weights(gens["jax"].model, gens["pt"].model)
    _same_weights(gens["jax"].depth_correction_model,
                  gens["pt"].depth_correction_model)
    testers = []
    for sub in ("jax", "pt"):
        tester = Tester(C.build_diffusion_unet(J.SMALL_MODEL),
                        C.build_diffusion(C.DiffusionConfig(image_size=H)),
                        batch_size=1,
                        results_folder=str(folders / sub / "results"),
                        samples_folder=str(folders / "ts"), device="cpu")
        tester.load(7)
        testers.append(tester.model)
    _same_weights(*testers)
    _same_weights(testers[0], gens["jax"].model)


def test_mask_tester_loads_a_ckpt_folder(folders):
    from pointreggpt_tpu_torch.train.mask_trainer import MaskTester

    nets = []
    for sub in ("jax", "pt"):
        mt = MaskTester(C.build_mask_unet(J.SMALL_MASK), str(folders),
                        info={"src": [], "tgt": []}, image_size=H,
                        results_folder=str(folders / sub / "dc"),
                        samples_folder=str(folders / "ms"), device="cpu")
        mt.load("best")
        nets.append(mt.model)
    _same_weights(*nets)


@pytest.fixture()
def cpu_cli(monkeypatch):
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    # the entry points turn TF32 off process-wide; restore it after
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_generate_dataset_from_a_ckpt_folder_writes_the_pt_files(
        folders, tmp_path, monkeypatch, cpu_cli):
    folder, data_root, info = write_tree(tmp_path, n_scenes=2)
    with open(tmp_path / "info.pkl", "wb") as f:
        pickle.dump(info, f)
    out = {}
    for sub in ("jax", "pt"):
        work = tmp_path / f"run_{sub}"
        work.mkdir()
        monkeypatch.chdir(work)
        (work / "depth_correction_results").symlink_to(folders / sub / "dc")
        generate_dataset.main([
            "--resume", "7", "--data", folder, "--train_info_path",
            str(tmp_path / "info.pkl"), "--data_root", data_root,
            "--results_folder", str(folders / sub / "results"), "-start",
            "0", "-stop", "2", "--batch_size", "2", "--num_samples", "1",
            "--image_size", str(H), "--timesteps", "16",
            "--sampling_timesteps", "4", "--memory_capacity", "4096",
            *SMALL_FLAGS])
        out[sub] = _files(work / "generated_dataset")
    assert len(out["jax"]) > 8
    assert out["jax"] == out["pt"]


def test_tester_cli_runs_from_a_ckpt_folder(folders, tmp_path, cpu_cli):
    tester_cli.main(["--resume", "7", "--results_folder",
                     str(folders / "jax" / "results"), "--samples_folder",
                     str(tmp_path / "s"), "--num_scenes", "1",
                     "--num_samples", "1", "--batch_size", "1",
                     "--image_size", str(H), "--timesteps", str(T),
                     "--sampling_timesteps", "2", *DIFFUSION_FLAGS])
    assert (tmp_path / "s" / "overview.png").is_file()


def test_mask_test_cli_runs_from_a_ckpt_folder(folders, tmp_path,
                                               monkeypatch, cpu_cli):
    rgbd, _, _, _ = write_motion_tree(tmp_path, 1, seed=5)
    with open(tmp_path / "test.pkl", "wb") as f:
        pickle.dump({"src": ["scene-0/src.pth"], "tgt": ["scene-0/tgt.pth"]},
                    f)
    monkeypatch.chdir(tmp_path)
    shutil.copytree(folders / "jax" / "dc", tmp_path /
                    "depth_correction_results")
    mask_test_cli.main(["--resume", "best", "--data", str(rgbd), "--info",
                        "test.pkl", "--image_size", str(H), "--limit", "2",
                        "--dim", "8", "--dim_mults", "1,1"])
    assert len(list((tmp_path / "depth_correction_samples").iterdir())) == 4


def _mask_pairs(root: Path, n_train: int, n_val: int):
    """A depth-correction pair root of uint16 mm frames at H^2."""
    import json

    rng = np.random.default_rng(0)
    (root / "data").mkdir(parents=True)
    (root / "metadata").mkdir()
    for subset, count in (("train", n_train), ("val", n_val)):
        entries = []
        for i in range(count):
            base = rng.integers(500, 9000, (H, H))
            label = base + rng.integers(0, 300, base.shape)
            names = (f"{subset}-{i}-input.depth.png",
                     f"{subset}-{i}-label.depth.png")
            for name, a in zip(names, (base, label)):
                Image.fromarray(a.astype(np.uint16)).save(root / "data" /
                                                          name)
            entries.append({"input_path": names[0], "label_path": names[1]})
        (root / "metadata" / f"{subset}.json").write_text(
            json.dumps(entries))
    return str(root)


def _adam_steps(data) -> set:
    return {int(s["step"]) for s in data["opt"]["state"].values()}


def test_trainer_clis_resume_from_a_ckpt_folder(folders, tmp_path,
                                                monkeypatch, cpu_cli):
    """Both trainers' ``--resume`` on a folder of JAX ``.ckpt`` files go on
    from the JAX step and Adam count (3) by one step."""
    monkeypatch.chdir(tmp_path)
    folder, gt_log = write_depth_tree(tmp_path, n_scenes=1, n_frames=2)
    shutil.copytree(folders / "jax" / "results", tmp_path / "res")
    train_cli.main(["--data", folder, "--gt_log", gt_log, "--image_size",
                    str(H), "--timesteps", "16", "--sampling_timesteps", "4",
                    "--train_batch_size", "2", "--gradient_accumulate_every",
                    "1", "--save_and_sample_every", "4", "--num_samples",
                    "4", "--num_workers", "1", "--results_folder", "res",
                    "--samples_folder", "smp", "--train_num_steps", "4",
                    "--resume", "7", *DIFFUSION_FLAGS])
    # milestone 1, floored to hundreds as the reference names it
    data = ckpt.load_checkpoint(tmp_path / "res" / "model-0.pt")
    assert data["step"] == 4 and _adam_steps(data) == {4}

    pairs = _mask_pairs(tmp_path / "pairs", 4, 2)
    (tmp_path / "dcres").mkdir()
    shutil.copy(MASK_CKPT, tmp_path / "dcres" / "model-7.ckpt")
    mask_cli.main(["--data", pairs, "--image_size", str(H),
                   "--train_batch_size", "4", "--val_batch_size", "4",
                   "--num_workers", "1", "--epochs", "3", "--resume", "7",
                   "--results_folder", "dcres", "--samples_folder", "dcs",
                   "--dim", "8", "--dim_mults", "1,1"])
    latest = ckpt.load_checkpoint(tmp_path / "dcres" / "model-latest.pt")
    assert latest["epoch"] == 2 and _adam_steps(latest) == {4}


def test_diffusion_trainer_resume_continues_the_jax_count(folders, tmp_path):
    from pointreggpt_tpu_torch.train.trainer import Trainer

    folder, gt_log = write_depth_tree(tmp_path, n_scenes=1, n_frames=2)
    shutil.copytree(folders / "jax" / "results", tmp_path / "res")
    trainers = []
    for res in ("res", "pt"):
        if res == "pt":
            shutil.copytree(folders / "pt" / "results", tmp_path / "pt")
        trainer = Trainer(C.build_diffusion_unet(J.SMALL_MODEL),
                          C.build_diffusion(C.DiffusionConfig(image_size=H)),
                          folder, train_batch_size=2, gt_log=gt_log,
                          results_folder=str(tmp_path / res),
                          samples_folder=str(tmp_path / "smp"),
                          train_lr=C.TrainConfig().train_lr, num_workers=1,
                          device="cpu")
        trainer.load(7)
        trainers.append(trainer)
    a, b = trainers
    assert a.step == b.step == 3
    _equal_trees(a.opt.state_dict(), b.opt.state_dict())
    _equal_trees(a.ema.state_dict(), b.ema.state_dict())
    _same_weights(a.model, b.model)


# ---------------------------------------------------------------------------
# the JAX .ckpt and reference .pt of a Fourier / learned-variance net


def _fourier_jax_state(seed=0):
    kw = OPTIONS["fourier_and_variance"]
    jm, params, net = _jax_option_net(kw, seed)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(8e-5, b1=0.9, b2=0.99))
    opt_state = tx.init(params)
    return kw, net, {"step": 2, "params": params, "opt_state": opt_state,
                     "ema": {"params": params, "step": 2, "initted": False}}


def test_importer_carries_the_fourier_weights_and_the_two_channel_head(
        tmp_path):
    kw, net, state = _fourier_jax_state()
    jckpt.save_checkpoint(tmp_path / "model-3.ckpt", state)
    flags = ["--dim", "8", "--dim_mults", "1,2", "--bf16", "false",
             "--random_fourier_features", "true", "--learned_variance",
             "true"]
    import_cli.main(["--diffusion", str(tmp_path / "model-3.ckpt"),
                     "--diffusion_out", str(tmp_path / "out"), *flags])
    # a reference .pt of the same net: time_mlp.0.weights by name
    sd = {f"model.{k}": v for k, v in net.state_dict().items()}
    torch.save({"step": 2, "model": sd,
                "ema": {f"ema_model.model.{k}": v
                        for k, v in net.state_dict().items()}},
               tmp_path / "model-ref.pt")
    import_cli.main(["--diffusion", str(tmp_path / "model-ref.pt"),
                     "--diffusion_out", str(tmp_path / "out"), *flags])
    for milestone in ("3", "ref"):
        model = C.build_diffusion_unet(C.ModelConfig(
            dim=8, dim_mults=(1, 2), bf16=False, **kw))
        load_ema_unet(model, tmp_path / "out" / f"model-{milestone}.pt")
        _same_weights(model, net)
        assert not model.time_mlp[0].weights.requires_grad
    # the .ckpt read directly gives the same net
    model = C.build_diffusion_unet(C.ModelConfig(
        dim=8, dim_mults=(1, 2), bf16=False, **kw))
    load_ema_unet(model, tmp_path / "model-3.ckpt")
    _same_weights(model, net)


# ---------------------------------------------------------------------------
# the native host library


def _png16(path, shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 20000, shape).astype(np.uint16)
    a[rng.uniform(size=shape) < 0.1] = 0
    Image.fromarray(a).save(path)
    return a


@pytest.fixture(scope="module")
def built():
    assert native.is_available() and native.has_zlib()
    assert jnative.is_available()


@pytest.mark.parametrize("shape", [(480, 640), (640, 480), (37, 53)])
@pytest.mark.parametrize("flip", [False, True])
def test_native_depth_matches_pil_and_the_jax_library(built, tmp_path,
                                                      shape, flip):
    raw = _png16(tmp_path / "a.png", shape, 1)
    data = (tmp_path / "a.png").read_bytes()
    got = imageio16.load_depth_model_space(tmp_path / "a.png", 32, flip=flip)
    pil = imageio16.load_depth_model_space(tmp_path / "a.png", 32, flip=flip,
                                           use_native=False)
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(
        got, jnative.png16_depth_preprocess(data, 32, flip=flip))
    np.testing.assert_array_equal(native.depth_preprocess(raw, 32, flip),
                                  jnative.depth_preprocess(raw, 32, flip))
    np.testing.assert_array_equal(native.png16_decode(data), raw)
    np.testing.assert_array_equal(imageio16.read_depth_png(tmp_path /
                                                           "a.png"), raw)


def test_native_point_ops_and_ply_match_the_jax_library(built):
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.voxel_downsample_host(pts, 0.1),
                                  jnative.voxel_downsample_host(pts, 0.1))
    np.testing.assert_array_equal(native.radius_hits_host(pts, tgt, 0.03),
                                  jnative.radius_hits_host(pts, tgt, 0.03))
    assert native.ply_pack(pts) == jnative.ply_pack(pts)


@pytest.mark.parametrize("kind", ["uint8", "rgb", "not_png"])
def test_other_images_go_to_pil(built, tmp_path, kind):
    rng = np.random.default_rng(3)
    path = tmp_path / "a.png"
    if kind == "uint8":
        Image.fromarray(rng.integers(0, 255, (40, 60)).astype(np.uint8)).save(
            path)
    elif kind == "rgb":
        Image.fromarray(rng.integers(0, 255, (40, 60, 3)).astype(
            np.uint8)).save(path)
    else:  # a TIFF named .png: PIL decodes by content
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 9000, (40, 60)).astype(
            np.uint16)).save(buf, format="TIFF")
        path.write_bytes(buf.getvalue())
    data = path.read_bytes()
    assert native.png16_decode(data) is None
    np.testing.assert_array_equal(imageio16.read_depth_png(path),
                                  np.asarray(Image.open(path)))
    if kind != "rgb":
        np.testing.assert_array_equal(
            imageio16.load_depth_model_space(path, 32),
            imageio16.load_depth_model_space(path, 32, use_native=False))


def test_a_build_without_zlib_drops_only_the_png_functions(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "ZLIB_FLAGS",
                        ["-DPRGPT_HAVE_ZLIB", "-include",
                         str(tmp_path / "missing_zlib.h")])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    with pytest.warns(RuntimeWarning, match="without zlib"):
        assert native.is_available()
    assert not native.has_zlib()
    assert [p.name for p in tmp_path.glob("*.so")] == [
        native.library_path(False).name]
    raw = _png16(tmp_path / "a.png", (48, 64), 4)
    assert native.png16_decode((tmp_path / "a.png").read_bytes()) is None
    np.testing.assert_array_equal(
        imageio16.load_depth_model_space(tmp_path / "a.png", 32),
        imageio16.load_depth_model_space(tmp_path / "a.png", 32,
                                         use_native=False))
    np.testing.assert_array_equal(native.depth_preprocess(raw, 32),
                                  jnative.depth_preprocess(raw, 32))
