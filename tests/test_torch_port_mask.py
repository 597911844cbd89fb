"""PyTorch port, depth correction against the JAX package on the CPU: the
validation metrics, the BCE loss and its gradient, the paired and test
datasets, the MaskUNet's gradient, the MaskTrainer's steps, schedule,
validation, checkpoints and resume, the GIF writer, the pair maker, and
the three entry points."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from PIL import Image, ImageSequence

from pointreggpt_tpu.data import PairedDepthDataset as JPairedDepthDataset
from pointreggpt_tpu.data import TestDataset as JTestDataset
from pointreggpt_tpu.models import MaskUNet as JMaskUNet
from pointreggpt_tpu.train import MaskTrainer as JMaskTrainer
from pointreggpt_tpu.train import mask_trainer as jmt
from pointreggpt_tpu.train.metrics import mask_metrics as jmask_metrics
from pointreggpt_tpu.utils import torch_port
from test_torch_port_generator import single_torch_thread  # noqa: F401
from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch.cli import make_depth_correction_data as make_cli
from pointreggpt_tpu_torch.cli import test_depth_correction as test_cli
from pointreggpt_tpu_torch.cli import train_depth_correction as train_cli
from pointreggpt_tpu_torch.data.datasets import PairedDepthDataset
from pointreggpt_tpu_torch.data.datasets import TestDataset as PTestDataset
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.generate import Generator
from pointreggpt_tpu_torch.models import DiffusionUNet, MaskUNet
from pointreggpt_tpu_torch.tools.synthetic_3dmatch import write_motion_tree
from pointreggpt_tpu_torch.train import checkpoint as ckpt
from pointreggpt_tpu_torch.train.mask_trainer import (MaskTester,
                                                      MaskTrainer,
                                                      adam_count, bce_loss,
                                                      make_gif)
from pointreggpt_tpu_torch.train.metrics import mask_metrics
from pointreggpt_tpu_torch.utils import jax_params

H = 32
NET = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=4)
# fp32 on both sides; the depth errors sum 1024 pixels in another order
METRIC_RTOL = 1e-5


def write_pairs(root, n_train=6, n_val=5, size=H, seed=0):
    """A depth-correction pair root: uint16 PNGs (some raw values above
    10000, which load as 0), labels equal to the input but for a few mm of
    noise on most pixels and large offsets on some."""
    rng = np.random.default_rng(seed)
    (root / "data").mkdir(parents=True)
    (root / "metadata").mkdir()
    for subset, count in (("train", n_train), ("val", n_val)):
        entries = []
        for i in range(count):
            base = rng.integers(500, 9000, (size, size))
            base[rng.uniform(size=base.shape) < 0.05] = 12000
            label = base + rng.integers(0, 30, base.shape)
            off = rng.uniform(size=base.shape) < 0.3
            label[off] += rng.integers(60, 2000, int(off.sum()))
            names = (f"{subset}-{i:06d}-input.depth.png",
                     f"{subset}-{i:06d}-label.depth.png")
            for name, a in zip(names, (base, label)):
                Image.fromarray(a.astype(np.uint16)).save(root / "data" / name)
            entries.append({"input_path": names[0], "label_path": names[1]})
        (root / "metadata" / f"{subset}.json").write_text(json.dumps(entries))
    return str(root)


def _jitter(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.05
                   ).astype(np.float32), tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(seed):
    """Jittered JAX MaskUNet params, ported from a seeded port net (flax's
    eager ``init`` of a U-Net takes tens of seconds on the CPU; the tree's
    structure comes from tracing it)."""
    torch.manual_seed(seed)
    template = jax.eval_shape(JMaskUNet(**NET).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, H, H, 1)))
    return _jitter(torch_port.port_mask_unet(
        MaskUNet(**NET).state_dict(), template, num_stages=2), seed)


class _Preset:
    """A JAX MaskUNet whose ``init`` returns the given params, for the JAX
    trainer and tester, which call ``init`` eagerly."""

    dtype = jnp.float32

    def __init__(self, params):
        self.module, self.params = JMaskUNet(**NET), params

    def init(self, *args):
        return self.params

    def apply(self, *args):
        return self.module.apply(*args)


# ---------------------------------------------------------------------------
# metrics and loss


def _metric_inputs(seed=0):
    """Four (16, 16, 1) items; item 2 keeps every pixel in both masks
    (class 0 absent: its IoU is nan and the mean leaves it out), item 3
    drops every pixel in both."""
    rng = np.random.default_rng(seed)
    shape = (4, 16, 16, 1)
    inp = rng.uniform(0, 1, shape).astype(np.float32)
    lab = rng.uniform(0, 1, shape).astype(np.float32)
    lmask = (rng.uniform(size=shape) < 0.6).astype(np.float32)
    prob = rng.uniform(0.97, 1.0, shape).astype(np.float32)
    lmask[2], prob[2] = 1.0, 1.0
    lmask[3], prob[3] = 0.0, 0.0
    return inp, lab, lmask, prob


def test_mask_metrics_match_jax_per_item_and_per_batch():
    arrays = _metric_inputs()
    got = mask_metrics(*map(torch.from_numpy, arrays))
    for i in range(4):
        want = jmask_metrics(*(a[i:i + 1] for a in arrays))
        for k, v in want.items():
            np.testing.assert_allclose(got[k][i].item(), float(v),
                                       rtol=METRIC_RTOL, err_msg=(i, k))
    # the whole batch as one item is the JAX function on the batch
    whole = mask_metrics(*(torch.from_numpy(a[None]) for a in arrays))
    for k, v in jmask_metrics(*arrays).items():
        np.testing.assert_allclose(whole[k][0].item(), float(v),
                                   rtol=METRIC_RTOL, err_msg=k)
    assert got["mIoU"][2].item() == 1.0 and got["mIoU"][3].item() == 1.0
    assert got["FP"][2].item() == 0.0


def test_bce_loss_and_gradient_match_jax_grad():
    tiny = np.finfo(np.float32).tiny
    prob = np.array([0.0, 1.0, 1e-40, tiny / 4, 0.5, 1 - 2**-24, 0.3,
                     0.999, 1e-30, 0.0, 1.0, 0.7], np.float32)
    target = np.array([1, 0, 1, 1, 1, 0, 0, 1, 1, 0, 1, 0.4], np.float32)
    want, want_g = jax.value_and_grad(jmt.bce_loss)(jnp.asarray(prob),
                                                    jnp.asarray(target))
    p = torch.from_numpy(prob).requires_grad_(True)
    loss = bce_loss(p, torch.from_numpy(target))
    loss.backward()
    # fp32, one mean of 12 terms in another order
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=0)
    # confidently wrong below fp32-tiny: the largest loss the floor allows,
    # and a gradient of exactly 0 (the clamp's constant branch)
    for i in (0, 1, 2, 3):
        assert p.grad[i].item() == 0.0
    assert np.isfinite(p.grad.numpy()).all()


# ---------------------------------------------------------------------------
# datasets


def test_paired_dataset_items_are_bit_identical(tmp_path):
    folder = write_pairs(tmp_path / "dc")
    for subset in ("train", "val"):
        ds, jds = (PairedDepthDataset(folder, subset, H),
                   JPairedDepthDataset(folder, subset, H))
        assert len(ds) == len(jds)
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            assert set(got) == set(want) == {"input_img", "label_img",
                                             "mask"}
            for k in want:
                assert got[k].dtype == want[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    item = PairedDepthDataset(folder, "train", H)[0]
    assert 0.2 < item["mask"].mean() < 0.9  # both classes present
    assert (item["input_img"] == 0).any()  # raw 12000 loads as 0


def test_test_dataset_reprojection_matches_jax(tmp_path):
    rgbd, data_root, _, info = write_motion_tree(tmp_path, 2, seed=1)
    ds = PTestDataset(info, str(rgbd), 64, data_root=str(data_root),
                      device="cpu")
    jds = JTestDataset(info, str(rgbd), 64, data_root=str(data_root))
    assert len(ds) == len(jds) == 4
    for i in range(4):
        got, want = ds[i], jds[i]
        for k in ("input_img", "label_img"):
            assert got[k].shape == want[k].shape == (64, 64, 1)
            # the same z-buffer on the same points: pixel for pixel equal
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=(i, k))
        # a real camera motion: disocclusions are masked out
        assert 0.5 < (got["input_img"] > 0).mean() < 0.98


# ---------------------------------------------------------------------------
# the net


def _mask_batch(seed, n=2, size=H):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, size, size, 1)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.1] = 0.0
    m = (rng.uniform(size=x.shape) < 0.7).astype(np.float32)
    return x, m


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_mask_unet_grad_matches_jax_grad():
    jm = JMaskUNet(**NET)
    params = _jax_params(1)
    x, m = _mask_batch(3)
    ref_loss, ref_g = jax.jit(jax.value_and_grad(
        lambda p: jmt.bce_loss(jm.apply(p, x), m)))(params)
    ref = jax_params.mask_unet_from_jax(_np(ref_g))
    net = MaskUNet(**NET)
    net.load_state_dict(jax_params.mask_unet_from_jax(params, net))
    loss = bce_loss(net(_nchw(x)), _nchw(m))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for n, p in net.named_parameters():
        # fp32 U-Nets on two frameworks, scaled by each gradient's size
        r = ref[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-3,
                                   atol=2e-4 * max(1e-3, np.abs(r).max()),
                                   err_msg=n)


# ---------------------------------------------------------------------------
# the trainer against the JAX MaskTrainer

LR, GAMMA, BATCH = 1e-3, 0.5, 2  # 6 train pairs: 3 steps an epoch
VAL_BATCH = 3  # 5 val pairs: a batch of 3 and a ragged one of 2


def _jax_trainer(folder, tmp):
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    tr = JMaskTrainer(_Preset(_jax_params(2)), folder, image_size=H,
                      train_batch_size=BATCH, train_lr=LR, epochs=2,
                      lr_gamma=GAMMA, results_folder=str(tmp / "jr"),
                      samples_folder=str(tmp / "js"), num_workers=1,
                      val_batch_size=VAL_BATCH, mesh=mesh)
    losses = []
    step = tr._train_step

    def recorded(state, batch):
        state, loss = step(state, batch)
        losses.append(float(loss))
        return state, loss

    tr._train_step = recorded
    return tr, losses


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two JAX MaskTrainer epochs from jittered weights: the losses of each
    step, params and optax state after each epoch, and the validation
    meters after the first."""
    tmp = tmp_path_factory.mktemp("jax_mask")
    folder = write_pairs(tmp / "dc")
    tr, losses = _jax_trainer(folder, tmp)
    out = {"folder": folder, "params0": _np(tr.state.params)}
    tr.train_one_epoch()
    out.update(losses0=list(losses), params1=_np(tr.state.params),
               opt1=_np(tr.state.opt_state))
    tr.eval_one_epoch()
    out["meters"] = {k: float(v) for k, v in tr.metrics["current"].items()}
    del losses[:]
    tr.state = tr.state._replace(epoch=jnp.asarray(1, jnp.int32))
    tr.train_one_epoch()
    out.update(losses1=list(losses), params2=_np(tr.state.params))
    schedule = optax.exponential_decay(LR, transition_steps=3,
                                       decay_rate=GAMMA, staircase=True)
    out["lrs"] = [float(schedule(c)) for c in range(7)]
    return out


def _port_trainer(folder, tmp, **kw):
    args = dict(image_size=H, train_batch_size=BATCH, train_lr=LR, epochs=2,
                lr_gamma=GAMMA, results_folder=str(tmp / "results"),
                samples_folder=str(tmp / "samples"), num_workers=1,
                val_batch_size=VAL_BATCH, device="cpu")
    args.update(kw)
    torch.manual_seed(0)
    tr = MaskTrainer(MaskUNet(**NET), folder, **args)
    losses = []
    step = tr.train_step

    def recorded(*a):
        loss = step(*a)
        losses.append(loss.item())
        return loss

    tr.train_step = recorded
    return tr, losses


def _load_jax_params(tr, params):
    tr.model.load_state_dict(jax_params.mask_unet_from_jax(params, tr.model))


# fp32 on both sides, Adam at lr 1e-3. From a zero Adam state the first
# step moves every parameter by lr times the sign of its gradient, whatever
# the gradient's size, and later steps divide by running scales: where a
# parameter's gradients nearly cancel, the frameworks' relative differences
# of about 1e-6 grow (2e-5 seen). 5e-5 is 5% of one step; a wrong
# gradient moves parameters by whole steps. The losses are means of 2048
# BCE terms.
P_ATOL, LOSS_RTOL = 5e-5, 1e-5


def _assert_params(tr, params, what):
    want = jax_params.mask_unet_from_jax(params, tr.model)
    for n, p in tr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=P_ATOL, rtol=0, err_msg=(what, n))


def test_trainer_steps_schedule_and_validation_match_jax(jax_run, tmp_path):
    tr, losses = _port_trainer(jax_run["folder"], tmp_path)
    _load_jax_params(tr, jax_run["params0"])
    assert tr.steps_per_epoch == 3
    np.testing.assert_allclose([tr.lr_at(c) for c in range(7)],
                               jax_run["lrs"], rtol=1e-6)

    tr.train_one_epoch()
    np.testing.assert_allclose(losses, jax_run["losses0"], rtol=LOSS_RTOL)
    _assert_params(tr, jax_run["params1"], "epoch 0")
    assert tr.count == adam_count(tr.opt) == 3

    # 5 validation pairs at batch 3: the ragged last batch is padded with
    # copies of its last item, and only its 2 real items reach the meters
    tr.eval_one_epoch()
    got = {k: float(v) for k, v in tr.metrics["current"].items()}
    assert set(got) == set(jax_run["meters"])
    for k, v in jax_run["meters"].items():
        np.testing.assert_allclose(got[k], v, rtol=METRIC_RTOL, err_msg=k)
    assert tr.metrics["current"]["SAE"].count == 5

    del losses[:]
    tr.epoch = 1
    tr.train_one_epoch()
    assert tr.opt.param_groups[0]["lr"] == pytest.approx(LR * GAMMA)
    np.testing.assert_allclose(losses, jax_run["losses1"], rtol=LOSS_RTOL)
    _assert_params(tr, jax_run["params2"], "epoch 1")


def test_trainer_continues_a_jax_state(jax_run, tmp_path):
    tr, losses = _port_trainer(jax_run["folder"], tmp_path)
    _load_jax_params(tr, jax_run["params1"])
    tr.opt.load_state_dict(jax_params.mask_adam_state_from_jax(
        jax_run["opt1"], tr.model, lr=LR))
    tr.count, tr.epoch = adam_count(tr.opt), 1
    assert tr.count == 3
    tr.train_one_epoch()
    np.testing.assert_allclose(losses, jax_run["losses1"], rtol=LOSS_RTOL)
    _assert_params(tr, jax_run["params2"], "carried")

    # the carry refuses a state whose schedule ran on another clock
    adam, sched = jax_run["opt1"][1]
    bad = (jax_run["opt1"][0], (adam, sched._replace(count=np.int32(2))))
    with pytest.raises(ValueError, match="schedule's count"):
        jax_params.mask_adam_state_from_jax(bad, tr.model)


def test_checkpoint_resume_continues_identically_and_generator_loads(
        tmp_path):
    folder = write_pairs(tmp_path / "dc", seed=4)
    straight, s_losses = _port_trainer(folder, tmp_path / "a")
    straight.train_and_eval()

    first, _ = _port_trainer(folder, tmp_path / "b", epochs=1)
    first.train_and_eval()
    results = tmp_path / "b" / "results"
    data = ckpt.load_checkpoint(results / "model-latest.pt")
    assert set(data) == {"epoch", "model", "opt", "loss_hist",
                         "best_metrics"}
    assert data["epoch"] == 0 and set(data["best_metrics"]) == {"SAE"}
    assert set(data["model"]) == set(first.model.state_dict())
    assert (results / "model-best.pt").is_file()

    resumed, r_losses = _port_trainer(folder, tmp_path / "b")
    resumed.load("latest")
    assert (resumed.epoch, resumed.count) == (1, 3)
    resumed.train_and_eval()
    assert resumed.loss_hist == straight.loss_hist
    assert r_losses == s_losses[3:]
    for (n, p), q in zip(straight.model.named_parameters(),
                         resumed.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=n)
    assert resumed.metrics["best"] == straight.metrics["best"]

    # the port's Generator reads the trainer's model-best.pt as it is
    best = ckpt.load_checkpoint(results / "model-best.pt")
    mask = MaskUNet(**NET)
    gen = Generator(DiffusionUNet(**NET), GaussianDiffusion(image_size=H),
                    folder, depth_correction_model=mask,
                    depth_correction_results=str(results),
                    samples_folder=str(tmp_path / "gen"), device="cpu")
    gen._load_depth_correction()
    for k, v in mask.state_dict().items():
        torch.testing.assert_close(v, best["model"][k], rtol=0, atol=0)


def test_trainer_refuses_multi_gpu(tmp_path, monkeypatch):
    folder = write_pairs(tmp_path / "dc")
    # data parallel is ported (tests/test_torch_port_parallel.py): a
    # process that torchrun started and that never joined its process
    # group is refused
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="maybe_initialize_distributed"):
        _port_trainer(folder, tmp_path)


# ---------------------------------------------------------------------------
# GIFs, the tester and the entry points


def _gif_frames(path):
    im = Image.open(path)
    frames = [(np.asarray(f.convert("L")), f.info["duration"])
              for f in ImageSequence.Iterator(im)]
    return frames, im.info.get("loop")


def test_make_gif_writes_millisecond_frames_as_jax_does(tmp_path):
    a = np.full((8, 8), 40, np.uint8)
    b = np.arange(64, dtype=np.uint8).reshape(8, 8)
    make_gif(tmp_path / "p.gif", [a, b])
    jmt.make_gif(tmp_path / "j.gif", [a, b])
    assert (tmp_path / "p.gif").read_bytes() == \
        (tmp_path / "j.gif").read_bytes()
    frames, loop = _gif_frames(tmp_path / "p.gif")
    assert loop == 0 and [d for _, d in frames] == [1000, 1000]
    np.testing.assert_array_equal(frames[1][0], b)
    # identical consecutive frames merge, their durations summed
    make_gif(tmp_path / "same.gif", [a, a])
    assert [d for _, d in _gif_frames(tmp_path / "same.gif")[0]] == [2000]


def test_make_depth_correction_data_matches_the_jax_cli(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("PRGPT_COMP_CACHE", "0")  # no cache under HOME
    from pointreggpt_tpu.cli import make_depth_correction_data as jax_cli

    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")

    rgbd, data_root, info_path, _ = write_motion_tree(tmp_path, 6, seed=2)
    # one unreadable pair: skipped by both
    (data_root / "scene-3" / "tgt.info.txt").unlink()
    outs = {}
    for name, cli in (("port", make_cli), ("jax", jax_cli)):
        outs[name] = tmp_path / name
        cli.main(["--data", str(rgbd), "--train_info", str(info_path),
                  "--data_root", str(data_root), "--out", str(outs[name]),
                  "--image_size", str(H), "--num_pairs", "6",
                  "--val_fraction", "0.2", "--seed", "3"])
    for split in ("train", "val"):
        got = json.loads((outs["port"] / "metadata" /
                          f"{split}.json").read_text())
        assert got == json.loads((outs["jax"] / "metadata" /
                                  f"{split}.json").read_text())
    names = sorted(p.name for p in (outs["jax"] / "data").iterdir())
    assert names == sorted(p.name for p in (outs["port"] / "data").iterdir())
    assert len(names) == 10  # 5 usable pairs of 6
    for name in names:
        got, want = (np.asarray(Image.open(outs[k] / "data" / name),
                                np.int64) for k in ("port", "jax"))
        # ``depth * 1e4`` truncated to uint16: one unit of rounding
        assert np.abs(got - want).max() <= 1, name

    # fewer than 2 usable pairs: refused
    with pytest.raises(SystemExit, match="need >= 2"):
        make_cli.main(["--data", str(rgbd), "--train_info", str(info_path),
                       "--data_root", str(tmp_path / "nowhere"),
                       "--out", str(tmp_path / "none"),
                       "--image_size", str(H)])


def test_tester_writes_the_gifs_jax_writes(tmp_path, monkeypatch):
    rgbd, data_root, _, info = write_motion_tree(tmp_path, 1, seed=5)
    monkeypatch.chdir(tmp_path)  # the default data_root is relative
    params = _jax_params(3)
    # a final bias that puts the keep probabilities around the threshold
    params["params"]["final_conv"]["bias"][:] = np.log(0.99 / 0.01)
    from pointreggpt_tpu.train import checkpoint as jckpt

    jckpt.save_checkpoint(tmp_path / "jr" / "model-best.ckpt",
                          {"epoch": 0, "params": params})
    net = MaskUNet(**NET)
    sd = jax_params.mask_unet_from_jax(params, net)
    ckpt.save_checkpoint(tmp_path / "pr" / "model-best.pt",
                         {"epoch": 0, "model": sd})
    jt = jmt.MaskTester(_Preset(params), str(rgbd), info=info, image_size=H,
                        results_folder=str(tmp_path / "jr"),
                        samples_folder=str(tmp_path / "js"))
    jt.load("best")
    jt.test(limit=2)
    pt = MaskTester(net, str(rgbd), info=info, image_size=H,
                    results_folder=str(tmp_path / "pr"),
                    samples_folder=str(tmp_path / "ps"), device="cpu")
    with pytest.raises(RuntimeError, match="load"):
        pt.test()
    pt.load("best")
    pt.test(limit=2)
    for idx in range(2):
        for kind in ("input", "output"):
            name = f"{idx:06d}-{kind}.gif"
            got, _ = _gif_frames(tmp_path / "ps" / name)
            want, _ = _gif_frames(tmp_path / "js" / name)
            assert [d for _, d in got] == [d for _, d in want], name
            for (g, _), (w, _) in zip(got, want):
                # uint8 previews of fp32 depths; a pixel near the 0.99
                # threshold may land on the other side of it
                assert (g != w).mean() <= 0.01, name


def test_the_three_entry_points_on_the_cpu(tmp_path, monkeypatch):
    rgbd, data_root, info_path, _ = write_motion_tree(tmp_path, 6, seed=6)
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    # the entry points turn TF32 off process-wide; restore it after
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    make_cli.main(["--data", str(rgbd), "--train_info", str(info_path),
                   "--data_root", str(data_root), "--out", "dc",
                   "--image_size", str(H), "--val_fraction", "0.34"])
    assert len(json.loads((tmp_path / "dc/metadata/val.json").read_text())) \
        == 2
    net = ["--dim", "8", "--dim_mults", "1,2"]
    flags = net + ["--data", "dc", "--image_size", str(H),
                   "--train_batch_size", "2", "--val_batch_size", "4",
                   "--num_workers", "1"]
    train_cli.main(flags + ["--epochs", "1"])
    res = tmp_path / "depth_correction_results"
    assert ckpt.load_checkpoint(res / "model-latest.pt")["epoch"] == 0
    assert not torch.backends.cudnn.allow_tf32
    train_cli.main(flags + ["--epochs", "2", "--resume", "latest"])
    data = ckpt.load_checkpoint(res / "model-latest.pt")
    assert data["epoch"] == 1 and len(data["loss_hist"]) == 2
    assert np.isfinite(data["loss_hist"]).all()
    assert (res / "model-best.pt").is_file()
    info = {"src": ["scene-0/src.pth"], "tgt": ["scene-0/tgt.pth"]}
    with open(tmp_path / "test.pkl", "wb") as f:
        pickle.dump(info, f)
    test_cli.main(net + ["--resume", "best", "--data", str(rgbd),
                         "--info", "test.pkl", "--image_size", str(H),
                         "--limit", "4"])
    gifs = sorted(p.name for p in
                  (tmp_path / "depth_correction_samples").iterdir())
    # the pair in both directions: 2 items, input and output each
    assert gifs == ["000000-input.gif", "000000-output.gif",
                    "000001-input.gif", "000001-output.gif"]


def test_config_copies_the_jax_mask_train_config():
    from pointreggpt_tpu import config as JC

    assert vars(C.MaskTrainConfig()) == vars(JC.MaskTrainConfig())
