"""PyTorch port: the Generator's per-sample step and the generate_dataset
entry point against the JAX package, on the CPU; the port's import and
device rules. Also the set-up the other ``test_torch_port_*`` files share:
a synthetic 3DMatch tree, port U-Nets with their JAX twins, port
checkpoints, and one torch thread per test module."""

import os
import pickle
import subprocess
import sys
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
from pointreggpt_tpu.models import DiffusionUNet as JDiffusionUNet
from pointreggpt_tpu.models import MaskUNet as JMaskUNet
from pointreggpt_tpu.utils import torch_port
from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.cli import generate_dataset
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.generate import Generator
from pointreggpt_tpu_torch.models import DiffusionUNet, MaskUNet

REPO = Path(__file__).resolve().parent.parent
VOXEL = 0.02
H = 32
CAP = 4096
DIFF_KW = dict(image_size=H, timesteps=16, sampling_timesteps=4,
               objective="pred_x0", beta_schedule="sigmoid")


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    """One torch intra-op thread per test module that imports this
    fixture: the suite runs several worker processes at once, and torch's
    default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_tree(root: Path, n_scenes: int = 2):
    """One uint16 mm depth frame per scene around 2-2.8 m (inside the
    generation bbox), intrinsics, info files; returns (folder, data_root,
    train_info)."""
    rng = np.random.default_rng(0)
    info = {"src": [], "tgt": []}
    for s in range(n_scenes):
        name = f"scene-{s}"
        seq = root / "rgbd" / name / "seq-01"
        seq.mkdir(parents=True)
        np.savetxt(root / "rgbd" / name / "camera-intrinsics.txt",
                   [[585.0, 0, 320.0], [0, 585.0, 240.0], [0, 0, 1]])
        depth = 2000 + rng.integers(0, 800, (480, 640))
        Image.fromarray(depth.astype(np.uint16)).save(
            seq / "frame-000000.depth.png")
        np.savetxt(seq / "frame-000000.pose.txt", np.eye(4))
        (root / "indoor" / name).mkdir(parents=True)
        for role in ("src", "tgt"):
            (root / "indoor" / name / f"{role}.info.txt").write_text(
                f"{name} seq-01 0 0\n")
            info[role].append(f"{name}/{role}.pth")
    return str(root / "rgbd"), str(root / "indoor"), info


def _template(module, *inputs):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def make_nets(seed: int = 0, dim_mults=(1, 2)):
    """(jm, params, jdc, dc_params, tm, tdc): port U-Nets (dim 8) with
    random torch init, and the JAX twins carrying the same weights through
    ``torch_port``. The mask net's output bias is raised so its keep
    probability sits far above the 0.99 threshold: the keep decision is
    then the same in both packages and the DDNM condition is non-empty."""
    torch.manual_seed(seed)
    tm = DiffusionUNet(dim=8, dim_mults=dim_mults).eval()
    tdc = MaskUNet(dim=8, dim_mults=dim_mults).eval()
    with torch.no_grad():
        tdc.final_conv[0].bias.fill_(12.0)
    jm = JDiffusionUNet(dim=8, dim_mults=dim_mults)
    jdc = JMaskUNet(dim=8, dim_mults=dim_mults)
    stages = len(dim_mults)
    params = torch_port.port_diffusion_unet(
        tm.state_dict(), _template(jm, jnp.zeros((1, H, H, 1)),
                                   jnp.zeros((1,)), jnp.zeros((1, 4))),
        num_stages=stages)
    dc_params = torch_port.port_mask_unet(
        tdc.state_dict(), _template(jdc, jnp.zeros((1, H, H, 1))),
        num_stages=stages)
    return jm, params, jdc, dc_params, tm, tdc


def save_port_checkpoints(root: Path, tm, tdc) -> None:
    """``results/model-1.pt`` ({step, model, ema}, the U-Net under
    ``model.`` and the EMA copy under ``ema_model.model.``, as the
    reference saves them) and ``dc_results/model-best.pt`` ({epoch,
    model})."""
    sd = {f"model.{k}": v for k, v in tm.state_dict().items()}
    (root / "results").mkdir()
    torch.save({"step": 0, "model": sd,
                "ema": {f"ema_model.{k}": v for k, v in sd.items()}},
               root / "results" / "model-1.pt")
    (root / "dc_results").mkdir()
    torch.save({"epoch": 0, "model": tdc.state_dict()},
               root / "dc_results" / "model-best.pt")


def files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


@pytest.fixture(scope="module")
def nets():
    return make_nets()


def _seed_memory(b=2):
    rng = np.random.default_rng(5)
    intr = np.zeros((b, 3, 3), np.float32)
    intr[:, 0, 0] = intr[:, 1, 1] = 36.0
    intr[:, 0, 2] = intr[:, 1, 2] = H / 2
    intr[:, 2, 2] = 1.0
    mem = np.zeros((b, CAP, 3), np.float32)
    valid = np.zeros((b, CAP), bool)
    for i in range(b):
        depth = (2.0 + 0.3 * rng.uniform(size=(H, H))).astype(np.float32)
        pc = JG.point_cloud_np(depth, intr[i], clip=(0.5, 10.0))
        mem[i, :len(pc)] = pc
        valid[i, :len(pc)] = True
    return mem, valid, intr


def _jax_step(nets, diffusion, mem, valid, intr, pose, x_init):
    """The JAX Generator's step body (generate/generator.py, _build_step_fn)
    with the pose and x_T injected."""
    jm, params, jdc, dc_params, *_ = nets
    pts = JG.transform_points(mem, pose)
    depth_rpj, mask_rpj = JG.points_to_depth(pts, valid, intr,
                                             image_size=(H, H))
    images_rpj = depth_rpj * 0.1
    keep = jdc.apply(dc_params, images_rpj[..., None])[..., 0] > 0.99
    images_rpj = jnp.where(keep, images_rpj, 0.0)
    mask_rpj = mask_rpj & keep
    img_cond = JG.normalize_to_neg_one_to_one(
        jnp.stack([images_rpj, mask_rpj.astype(jnp.float32)], axis=-1))
    images = diffusion.sample(params, jax.random.PRNGKey(0),
                              param_cond=JG.param_vector(intr),
                              img_cond=img_cond, x_init=x_init)
    images = jnp.where(jdc.apply(dc_params, images) > 0.99, images, 0.0)
    new_pts, new_valid = JG.depth_to_points(images[..., 0] * 10.0, intr,
                                            clip=(0.5, 10.0))
    world = jnp.einsum("bji,bnj->bni", pose[:, :3, :3],
                       new_pts - pose[:, :3, 3][:, None, :],
                       precision=jax.lax.Precision.HIGHEST)
    mem_new, valid_new, overflow = JP.memory_voxel_update(
        mem, valid, world, new_valid, VOXEL, CAP)
    return dict(images_raw=depth_rpj * 0.1, keep=mask_rpj, images=images,
                world=world, world_valid=new_valid, mem=mem_new,
                mem_valid=valid_new, overflow=overflow)


def test_step_matches_jax_step_body(nets, tmp_path):
    jm, params, jdc, dc_params, tm, tdc = nets
    mem, valid, intr = _seed_memory()
    rng = np.random.default_rng(6)
    x_init = rng.normal(size=(2, H, H, 1)).astype(np.float32)
    pose = np.asarray(JS.random_sample_pose(jax.random.PRNGKey(3), 2))

    jd = JGaussianDiffusion(apply_fn=lambda p, x, t, pc: jm.apply(p, x, t, pc),
                            ddim_sampling_eta=0.0, **DIFF_KW)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda *a: _jax_step(nets, jd, *a))(mem, valid, intr, pose, x_init))

    gen = Generator(tm, GaussianDiffusion(ddim_sampling_eta=0.0, **DIFF_KW),
                    str(tmp_path), batch_size=2,
                    samples_folder=str(tmp_path / "out"),
                    depth_correction_model=tdc, memory_capacity=CAP,
                    device="cpu")
    t = torch.tensor
    out = gen.step(t(mem), t(valid), t(intr), t(intr[:, [0, 1, 0, 1],
                                                      [0, 1, 2, 2]]),
                   pose=t(pose), x_init=t(x_init), memory_voxel=VOXEL)

    # the splat of the same memory under the same pose: the same pixels
    # win; depths carry transform_points' last-ulp sum-order difference
    # (its 1e-6 bound, in model units x 0.1)
    np.testing.assert_array_equal(out.keep_mask.numpy(), ref["keep"])
    np.testing.assert_allclose(out.images_raw.numpy(), ref["images_raw"],
                               atol=1e-7, rtol=0)
    assert ref["keep"].any()
    # fp32 chain: the repo's chain bound (tests/test_torch_parity.py)
    np.testing.assert_allclose(out.images.numpy(), ref["images"],
                               atol=5e-4, rtol=1e-3)
    # world points: depth = 10 x image, so the chain bound times 10
    np.testing.assert_array_equal(out.world_valid.numpy(),
                                  ref["world_valid"])
    np.testing.assert_allclose(out.world.numpy(), ref["world"], atol=1e-2)
    # memory: voxel count and overflow exact; centroids in output order
    np.testing.assert_array_equal(out.mem_valid.numpy(), ref["mem_valid"])
    np.testing.assert_array_equal(out.overflow.numpy(), ref["overflow"])
    np.testing.assert_allclose(out.mem_pts.numpy(), ref["mem"], atol=1e-2)


def test_cli_runs_on_cpu_and_resumes(nets, tmp_path, monkeypatch, capsys):
    *_, tm, tdc = nets
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    folder, data_root, info = write_tree(tmp_path, n_scenes=3)
    with open(tmp_path / "info.pkl", "wb") as f:
        pickle.dump(info, f)
    save_port_checkpoints(tmp_path, tm, tdc)
    (tmp_path / "depth_correction_results").symlink_to(tmp_path /
                                                       "dc_results")
    argv = ["--resume", "1", "--data", folder, "--train_info_path",
            str(tmp_path / "info.pkl"), "--data_root", data_root,
            "--results_folder", str(tmp_path / "results"), "-start", "0",
            "-stop", "3", "--batch_size", "2", "--num_samples", "1",
            "--image_size", str(H), "--dim", "8", "--dim_mults", "1,2",
            "--dc_dim", "8", "--dc_dim_mults", "1,2", "--timesteps", "16",
            "--sampling_timesteps", "4", "--memory_capacity", str(CAP)]
    generate_dataset.main(argv)
    out = tmp_path / "generated_dataset/data"
    assert all((out / f"scene-{s:06d}/sample-000001.cloud.ply").is_file()
               for s in range(3))
    assert "Skip" not in capsys.readouterr().out
    # every member of a chunk is probed: remove one marker of chunk 0
    (out / "scene-000000/sample-000001.cloud.ply").unlink()
    generate_dataset.main(argv)
    printed = capsys.readouterr().out
    assert "Skip completed scenes 000002 - 000002." in printed
    assert "Skip completed scenes 000000" not in printed
    assert (out / "scene-000000/sample-000001.cloud.ply").is_file()


def test_next_step_is_queued_before_the_host_writes(nets, tmp_path,
                                                    monkeypatch):
    *_, tm, tdc = nets
    monkeypatch.chdir(tmp_path)
    folder, data_root, info = write_tree(tmp_path, n_scenes=1)
    save_port_checkpoints(tmp_path, tm, tdc)
    gen = Generator(tm, GaussianDiffusion(sampling_timesteps=2,
                                          **{k: v for k, v in DIFF_KW.items()
                                             if k != "sampling_timesteps"}),
                    folder, batch_size=1,
                    results_folder=str(tmp_path / "results"),
                    samples_folder=str(tmp_path / "g/data"),
                    data_root=data_root, memory_capacity=CAP, device="cpu")
    gen.load(1)
    calls = []
    step, write = Generator.step, Generator._write_sample_outputs
    monkeypatch.setattr(Generator, "step", lambda self, *a, **k: (
        calls.append("step"), step(self, *a, **k))[1])
    monkeypatch.setattr(Generator, "_write_sample_outputs",
                        lambda self, chunk, pending, *a: (
                            calls.append(f"write{pending[0]}"),
                            write(self, chunk, pending, *a))[1])
    gen.generate(0, 1, num_samples=3, has_refine_step=False,
                 info_train=info, verbose=False)
    assert calls == ["step", "step", "write0", "step", "write1", "write2"]


@pytest.mark.parametrize("prefix", ["ema_model.model.", "ema_model."])
def test_load_takes_the_ema_unet(nets, tmp_path, prefix):
    *_, tm, _ = nets
    sd = {k: v + 1.0 for k, v in tm.state_dict().items()}
    (tmp_path / "results").mkdir()
    torch.save({"step": 3, "model": {},
                "ema": {**{prefix + k: v for k, v in sd.items()},
                        "step": torch.tensor(3)}},
               tmp_path / "results" / "model-7.pt")
    fresh = type(tm)(dim=8, dim_mults=(1, 2))
    gen = Generator(fresh, GaussianDiffusion(**DIFF_KW), str(tmp_path),
                    results_folder=str(tmp_path / "results"),
                    samples_folder=str(tmp_path / "out"), device="cpu")
    gen.load(7)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_device_resolution(monkeypatch):
    monkeypatch.delenv("PRGPT_PLATFORM", raising=False)
    assert resolve_device("cpu").type == "cpu"
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    assert resolve_device().type == "cpu"
    monkeypatch.delenv("PRGPT_PLATFORM")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="PRGPT_PLATFORM=cpu"):
            resolve_device()
    else:
        assert resolve_device().type == "cuda"


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pointreggpt_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'pointreggpt_tpu',\n"
        "              'matplotlib', 'msgpack', 'torchvision',\n"
        "              'pytorch_fid'))\n"
        "print('MODULES', len([n for n in sys.modules\n"
        "      if n.startswith('pointreggpt_tpu_torch')]))\n"
        "print('TRAIN', all(m in sys.modules for m in (\n"
        "    'pointreggpt_tpu_torch.train.trainer',\n"
        "    'pointreggpt_tpu_torch.data.datasets',\n"
        "    'pointreggpt_tpu_torch.cli.train_successive_ddnm_diffusion')))\n"
        "print('TESTER', all(m in sys.modules for m in (\n"
        "    'pointreggpt_tpu_torch.generate.gt',\n"
        "    'pointreggpt_tpu_torch.generate.tester',\n"
        "    'pointreggpt_tpu_torch.cli.generate_gt',\n"
        "    'pointreggpt_tpu_torch.cli.test_successive_ddnm_diffusion')))\n"
        "print('LOADERS', all(m in sys.modules for m in (\n"
        "    'pointreggpt_tpu_torch.eval.fid',\n"
        "    'pointreggpt_tpu_torch.eval.inception',\n"
        "    'pointreggpt_tpu_torch.dataloaders.mixture',\n"
        "    'pointreggpt_tpu_torch.cli.import_torch_checkpoint')))\n"
        "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD []" in r.stdout, r.stdout
    assert "TRAIN True" in r.stdout, r.stdout
    assert "TESTER True" in r.stdout, r.stdout
    assert "LOADERS True" in r.stdout, r.stdout
    assert int(r.stdout.split("MODULES ")[1].split()[0]) >= 25
