"""PyTorch port, diffusion training against the JAX package on the CPU:
whole-net gradients of the loss (with and without remat), the clip + Adam
step, the EMA, the data loader, the Trainer's checkpoints and resume, and
the training entry point."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from pointreggpt_tpu.data import DepthDataset as JDepthDataset
from pointreggpt_tpu.data import PrefetchLoader as JPrefetchLoader
from pointreggpt_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from pointreggpt_tpu.models import DiffusionUNet as JDiffusionUNet
from pointreggpt_tpu.train import ema as ema_lib
from test_torch_port_generator import single_torch_thread  # noqa: F401
from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch.cli import train_successive_ddnm_diffusion as cli
from pointreggpt_tpu_torch.data.datasets import DepthDataset, PrefetchLoader
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.generate import Generator
from pointreggpt_tpu_torch.models import DiffusionUNet
from pointreggpt_tpu_torch.models.blocks import PreNormResidual
from pointreggpt_tpu_torch.ops import attention as K2
from pointreggpt_tpu_torch.ops import linear_attention as K1
from pointreggpt_tpu_torch.train import checkpoint as ckpt
from pointreggpt_tpu_torch.train.ema import EMA
from pointreggpt_tpu_torch.train.trainer import Trainer, clip_by_global_norm_
from pointreggpt_tpu_torch.utils import jax_params

H = 32
LOSS_KW = dict(image_size=H, timesteps=1000, loss_type="l1",
               objective="pred_x0", beta_schedule="sigmoid")


def write_depth_tree(root, n_scenes=2, n_frames=4, seed=0):
    """3DMatch-style frames (480x640 uint16 mm depth, written with PIL),
    intrinsics and a gt.log listing every frame; returns (folder, gt_log).
    """
    rng = np.random.default_rng(seed)
    folder = root / "rgbd"
    lines = []
    for s in range(n_scenes):
        seq = folder / f"scene-{s}" / "seq-01"
        seq.mkdir(parents=True)
        np.savetxt(folder / f"scene-{s}" / "camera-intrinsics.txt",
                   [[585.0 - 10 * s, 0, 320.0], [0, 585.0, 240.0],
                    [0, 0, 1]])
        for f in range(n_frames):
            depth = rng.integers(500, 9000, (480, 640)).astype(np.uint16)
            Image.fromarray(depth).save(seq / f"frame-{f:06d}.depth.png")
            lines.append(f"scene-{s}/seq-01/frame-{f:06d}.depth.png")
    gt_log = root / "gt.log"
    gt_log.write_text("\n".join(lines) + "\n")
    return str(folder), str(gt_log)


def _jitter(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.05
                   ).astype(np.float32), tree)


@pytest.fixture(scope="module")
def jax_net():
    jm = JDiffusionUNet(dim=8, dim_mults=(1, 2))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, H, H, 1)), jnp.zeros((1,)),
        jnp.zeros((1, 4))))
    return jm, _jitter(params, 1)


def _port_net(params, **kw):
    net = DiffusionUNet(dim=8, dim_mults=(1, 2), **kw)
    net.load_state_dict(jax_params.diffusion_unet_from_jax(params, net))
    return net.to(memory_format=torch.channels_last)


def _loss_inputs(seed=2):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (2, H, H, 1)).astype(np.float32)
    noise = rng.normal(size=(2, H, H, 1)).astype(np.float32)
    t = np.array([40, 730], np.int32)
    pc = rng.uniform(100, 600, (2, 4)).astype(np.float32)
    return x0, noise, t, pc


# fp32 on both sides: the repo's bound for torch vs JAX U-Nets, scaled by
# each gradient's size (the pred_x0 loss weight is the SNR, ~1e2 at t=40)
G_RTOL = 1e-3


@pytest.mark.parametrize("remat", [False, True])
def test_loss_gradients_match_jax_grad(jax_net, remat):
    jm, params = jax_net
    x0, noise, t, pc = _loss_inputs()
    jd = JGaussianDiffusion(apply_fn=lambda p, x, tt, c: jm.apply(p, x, tt,
                                                                  c),
                            **LOSS_KW)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jd.p_losses(p, None, x0, t, pc, noise=noise)))(params)
    ref = jax_params.diffusion_unet_from_jax(
        jax.tree_util.tree_map(np.asarray, ref_grads))

    net = _port_net(params, remat=remat)
    loss = GaussianDiffusion(**LOSS_KW).p_losses(
        net, torch.from_numpy(x0), torch.from_numpy(t).long(),
        torch.from_numpy(pc), noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5,
                               rtol=1e-6)
    for name, prm in net.named_parameters():
        r = ref[name].numpy()
        atol = 2e-4 * max(1.0, np.abs(r).max())
        np.testing.assert_allclose(prm.grad.numpy(), r, atol=atol,
                                   rtol=G_RTOL, err_msg=name)


def test_remat_leaves_gradients_unchanged(jax_net):
    _, params = jax_net
    x0, noise, t, pc = map(torch.from_numpy, _loss_inputs(3))
    diffusion = C.build_diffusion(C.DiffusionConfig(image_size=H))
    grads = []
    for remat in (False, True):
        net = _port_net(params, remat=remat)
        diffusion.p_losses(net, x0, t.long(), pc, noise=noise).backward()
        grads.append([p.grad for p in net.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_config_builds_the_training_objects():
    diffusion = C.build_diffusion(C.DiffusionConfig(loss_type="l2"))
    assert diffusion.loss_type == "l2"
    assert C.build_diffusion(C.DiffusionConfig()).loss_type == "l1"
    net = C.build_diffusion_unet(C.ModelConfig(dim=8, dim_mults=(1, 2),
                                               remat=True))
    assert net.remat and net.dtype == torch.bfloat16
    assert all(m.remat for m in net.modules()
               if type(m).__name__ == "ResnetBlock")
    assert C.TrainConfig().train_batch_size == 32
    assert C.TrainConfig().gradient_accumulate_every == 2


def test_backward_reaches_every_attention_parameter(jax_net):
    """Every parameter of every LinearAttention block and of mid_attn gets
    a nonzero gradient, through the ops' autograd Functions."""
    _, params = jax_net
    net = _port_net(params)
    outs = []
    la_fn, mha_fn = K1.fused_linear_attention, K2.multihead_attention
    blocks = __import__("pointreggpt_tpu_torch.models.blocks",
                        fromlist=["blocks"])

    def record(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            outs.append(out)
            return out
        return wrapped

    x0, noise, t, pc = map(torch.from_numpy, _loss_inputs(4))
    mp = pytest.MonkeyPatch()
    mp.setattr(blocks, "fused_linear_attention", record(la_fn))
    mp.setattr(blocks, "multihead_attention", record(mha_fn))
    try:
        GaussianDiffusion(**LOSS_KW).p_losses(
            net, x0, t.long(), pc, noise=noise).backward()
    finally:
        mp.undo()
    assert sorted(type(o.grad_fn).__name__ for o in outs) == \
        ["FusedLinearAttentionFnBackward"] * 4 + \
        ["MultiheadAttentionFnBackward"]
    mods = [m for m in net.modules() if isinstance(m, PreNormResidual)]
    assert len(mods) == 5
    for m in mods:
        for name, prm in m.named_parameters():
            assert prm.grad is not None and prm.grad.abs().max() > 0, name


def test_training_loss_draws_t_then_noise(jax_net):
    _, params = jax_net
    net = _port_net(params)
    d = GaussianDiffusion(**LOSS_KW)
    img01 = torch.rand(2, H, H, 1, generator=torch.Generator().manual_seed(0))
    intr = torch.tensor([[[585.0, 0, 128.0], [0, 585.0, 128.0],
                          [0, 0, 1]]] * 2)
    with torch.no_grad():
        got = d.training_loss(net, img01, intr,
                              torch.Generator().manual_seed(9))
        g = torch.Generator().manual_seed(9)
        t = torch.randint(0, 1000, (2,), generator=g)
        noise = torch.randn(img01.shape, generator=g)
        want = d.p_losses(net, img01 * 2 - 1, t,
                          intr[:, [0, 1, 0, 1], [0, 1, 2, 2]], noise=noise)
    assert got.item() == want.item()


def test_p_losses_rejects_a_wrong_output_shape():
    d = GaussianDiffusion(**LOSS_KW)
    two = lambda x, t, pc: torch.cat([x, x], dim=1)
    with pytest.raises(ValueError, match="out channels"):
        d.p_losses(two, torch.zeros(1, H, H, 1), torch.tensor([3]),
                   torch.zeros(1, 4))


@pytest.mark.parametrize("objective,loss_type,min_snr",
                         [("pred_noise", "l2", False),
                          ("pred_v", "l1", True)])
def test_other_objectives_match_jax(objective, loss_type, min_snr):
    rng = np.random.default_rng(7)
    x0, noise, out = (rng.normal(size=(2, 8, 8, 1)).astype(np.float32)
                      for _ in range(3))
    t = np.array([5, 900], np.int32)
    kw = dict(image_size=8, timesteps=1000, objective=objective,
              loss_type=loss_type, min_snr_loss_weight=min_snr)
    jd = JGaussianDiffusion(apply_fn=lambda p, x, tt, c: jnp.asarray(out),
                            **kw)
    ref = jd.p_losses(None, None, x0, t, None, noise=noise)
    got = GaussianDiffusion(**kw).p_losses(
        lambda x, tt, c: torch.from_numpy(out).permute(0, 3, 1, 2),
        torch.from_numpy(x0), torch.from_numpy(t).long(), None,
        noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def _grad_tree(params, seed, norm):
    """A random params-shaped tree with global norm ``norm``."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
    total = np.sqrt(sum(np.sum(a**2) for a in jax.tree_util.tree_leaves(
        tree)))
    return jax.tree_util.tree_map(
        lambda a: (a * (norm / total)).astype(np.float32), tree)


def test_clip_and_adam_continue_a_jax_state(jax_net):
    _, params = jax_net
    lr, betas = 8e-5, (0.9, 0.99)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(lr, b1=betas[0], b2=betas[1]))
    state = tx.init(params)
    jp = params
    for i, norm in enumerate((3.0, 0.5)):  # two steps before the carry
        upd, state = tx.update(_grad_tree(params, 10 + i, norm), state, jp)
        jp = optax.apply_updates(jp, upd)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    state = jax.tree_util.tree_map(np.asarray, state)

    net = _port_net(jp)
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=betas, eps=1e-8)
    opt.load_state_dict(jax_params.adam_state_from_jax(state, net, lr=lr,
                                                       betas=betas))
    names = [n for n, _ in net.named_parameters()]
    for i, norm in enumerate((5.0, 0.2, 1.0)):  # clip, no clip, at the edge
        g = _grad_tree(params, 20 + i, norm)
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        g_sd = jax_params.diffusion_unet_from_jax(g, net)
        for n, p in net.named_parameters():
            p.grad = g_sd[n].clone()
        clip_by_global_norm_([p.grad for p in net.parameters()], 1.0)
        opt.step()
    want = jax_params.diffusion_unet_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), net)
    for n, p in zip(names, net.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-6, rtol=0, err_msg=n)


def test_clip_follows_the_optax_formula():
    g = [torch.full((4,), 3.0), torch.full((2,), 4.0)]
    norm = clip_by_global_norm_(g, 2.0)
    want = np.sqrt(4 * 9 + 2 * 16)
    assert norm.item() == pytest.approx(want)
    np.testing.assert_allclose(g[0].numpy(), 3.0 * 2.0 / want, rtol=1e-6)
    small = [torch.full((3,), 0.1)]
    clip_by_global_norm_(small, 2.0)
    assert torch.equal(small[0], torch.full((3,), 0.1))


def test_ema_matches_jax_over_250_updates():
    rng = np.random.default_rng(8)
    online = torch.nn.Linear(3, 2)
    ema = EMA(online)  # production: 0.995, every 10, after 100
    with torch.no_grad():
        online.weight.zero_()
        online.bias.zero_()
    state = ema_lib.init({"w": np.zeros((2, 3), np.float32),
                          "b": np.zeros(2, np.float32)})
    for _ in range(250):
        w = rng.normal(size=(2, 3)).astype(np.float32)
        b = rng.normal(size=2).astype(np.float32)
        with torch.no_grad():
            online.weight.copy_(torch.from_numpy(w))
            online.bias.copy_(torch.from_numpy(b))
        ema.update()
        state = ema_lib.update(state, {"w": w, "b": b})
    np.testing.assert_allclose(ema.ema_model.weight.numpy(),
                               np.asarray(state.params["w"]), atol=1e-6)
    np.testing.assert_allclose(ema.ema_model.bias.numpy(),
                               np.asarray(state.params["b"]), atol=1e-6)
    assert int(ema.step) == int(state.step) == 250
    assert bool(ema.initted) == bool(state.initted) is True
    sd = ema.state_dict()
    assert set(sd) == {"ema_model.weight", "ema_model.bias",
                       "online_model.weight", "online_model.bias",
                       "initted", "step"}
    again = EMA(torch.nn.Linear(3, 2))
    again.load_state_dict(sd)
    assert (again._step, again._initted) == (250, True)


def _batches(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("start_epoch", [0, 3])
def test_loader_batches_match_jax_bit_for_bit(tmp_path, start_epoch):
    folder, gt_log = write_depth_tree(tmp_path, n_scenes=2, n_frames=3)
    kw = dict(gt_log=gt_log, augment_horizontal_flip=True, seed=7)
    lkw = dict(shuffle=True, infinite=True, num_workers=2, seed=7,
               start_epoch=start_epoch)
    ours = _batches(PrefetchLoader(DepthDataset(folder, H, **kw), 4, **lkw),
                    4)
    ref = _batches(JPrefetchLoader(JDepthDataset(folder, H, **kw), 4, **lkw),
                   4)
    flips = 0
    for a, b in zip(ours, ref):
        assert set(a) == set(b) == {"img", "intrinsic"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert ours[0]["img"].shape == (4, H, H, 1)
    # the flip is on for some items and off for others
    ds = DepthDataset(folder, H, **kw)
    flips = {np.array_equal(ds.getitem_at_epoch(i, 0)["img"],
                            DepthDataset(folder, H, gt_log=gt_log)[i]["img"])
             for i in range(len(ds))}
    assert flips == {True, False}


def test_loader_reraises_decode_errors_and_releases_abandoned_threads(
        tmp_path):
    import threading

    folder, gt_log = write_depth_tree(tmp_path, n_scenes=1, n_frames=4)
    ds = DepthDataset(folder, H, gt_log=gt_log)
    it = iter(PrefetchLoader(ds, 2, infinite=True, num_workers=1))
    next(it)
    it.close()  # abandoned: its producer must stop
    for _ in range(50):
        if not any(t.name == "prgpt-prefetch" and t.is_alive()
                   for t in threading.enumerate()):
            break
        threading.Event().wait(0.1)
    assert not any(t.name == "prgpt-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    os.remove(ds.paths[0])
    with pytest.raises(FileNotFoundError):
        for _ in PrefetchLoader(ds, 2, shuffle=False, num_workers=1):
            pass


def _trainer(tmp_path, folder, gt_log, image_size=H, **kw):
    torch.manual_seed(0)
    args = dict(train_batch_size=2, gradient_accumulate_every=2,
                train_lr=1e-3, train_num_steps=3, save_and_sample_every=2,
                num_samples=4, results_folder=str(tmp_path / "results"),
                samples_folder=str(tmp_path / "samples"), gt_log=gt_log,
                num_workers=1, ema_update_every=1, device="cpu")
    args.update(kw)
    diffusion = GaussianDiffusion(image_size=image_size, timesteps=16,
                                  sampling_timesteps=4, ddim_sampling_eta=0.0)
    return Trainer(DiffusionUNet(dim=8, dim_mults=(1, 2)), diffusion, folder,
                   **args)


def test_trainer_checkpoint_resume_and_generator_load(tmp_path):
    folder, gt_log = write_depth_tree(tmp_path, n_scenes=2, n_frames=4)
    tr = _trainer(tmp_path, folder, gt_log)
    tr.train(log_every=1)
    assert tr.step == 3
    grid = Image.open(tmp_path / "results" / "sample-1.png")
    assert grid.size == (2 * H, 2 * H)  # 4 samples, 2 per row
    data = ckpt.load_checkpoint(tmp_path / "results" / "model-0.pt")
    assert set(data) == {"step", "model", "opt", "ema", "version"}
    assert data["step"] == 2
    unet_keys = set(tr.model.state_dict())
    assert set(data["model"]) == {f"model.{k}" for k in unet_keys}
    assert set(data["ema"]) == ({f"ema_model.model.{k}" for k in unet_keys}
                                | {f"online_model.model.{k}"
                                   for k in unet_keys}
                                | {"initted", "step"})
    assert int(data["ema"]["step"]) == 2
    assert set(data["opt"]) == {"state", "param_groups"}
    assert ckpt.latest_milestone(tmp_path / "results") == "0"

    # the port's Generator reads the EMA U-Net of what the trainer wrote
    fresh = DiffusionUNet(dim=8, dim_mults=(1, 2))
    gen = Generator(fresh, tr.diffusion, folder,
                    results_folder=str(tmp_path / "results"),
                    samples_folder=str(tmp_path / "gen"), device="cpu")
    gen.load(0)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, data["ema"][f"ema_model.model.{k}"],
                                   rtol=0, atol=0)

    # resume: step, EMA and Adam state; the loader at the step's epoch; a
    # fresh (t, noise) stream
    again = _trainer(tmp_path, folder, gt_log)
    again.load(0)
    assert again.step == 2
    assert (again.ema._step, again.ema._initted) == (2, False)  # warmup
    for k, v in again.ema.state_dict().items():
        torch.testing.assert_close(v, data["ema"][k], rtol=0, atol=0)
    st = again.opt.state_dict()["state"]
    for i, s in data["opt"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(st[i][k], s[k], rtol=0, atol=0)
    # 8 frames / global batch 4 = 2 batches per epoch: step 2 is epoch 1
    want = next(iter(PrefetchLoader(again.ds, 4, infinite=True,
                                    num_workers=1, seed=0, start_epoch=1)))
    got = next(again.dl)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    tr.step = 0
    draws = [torch.randint(0, 16, (32,), generator=torch.Generator()
                           .manual_seed(t._generator_seed()))
             for t in (tr, again)]
    assert not torch.equal(*draws)
    again.train(log_every=1)
    assert again.step == 3


def test_trainer_loss_falls_on_four_fixed_images(tmp_path):
    folder, gt_log = write_depth_tree(tmp_path, n_scenes=1, n_frames=4)
    tr = _trainer(tmp_path, folder, gt_log, image_size=16,
                  train_batch_size=4, gradient_accumulate_every=1,
                  train_lr=2e-3, train_num_steps=150,
                  save_and_sample_every=10**6, track_losses=True,
                  augment_horizontal_flip=False)
    tr.train(log_every=1000)
    losses = tr.loss_hist
    assert len(losses) == 150 and np.all(np.isfinite(losses))
    first, last = np.mean(losses[:10]), np.mean(losses[-20:])
    # measured 0.59 on this set; a wrong sign or a dead gradient sits at
    # or above 1
    assert last <= 0.7 * first, (first, last)


def test_trainer_refuses_what_is_not_ported(tmp_path, monkeypatch):
    folder, gt_log = write_depth_tree(tmp_path, n_scenes=1, n_frames=4)
    # FID is ported: with no Inception weights to read it is refused at
    # start-up, not at the first milestone
    monkeypatch.delenv("PRGPT_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.setitem(sys.modules, "pytorch_fid", None)
    monkeypatch.setitem(sys.modules, "torchvision", None)
    with pytest.raises(ImportError, match="PRGPT_INCEPTION_WEIGHTS"):
        _trainer(tmp_path, folder, gt_log, calculate_fid=True)
    # data parallel is ported: a process that torchrun started and that
    # never joined its process group is refused
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="maybe_initialize_distributed"):
        _trainer(tmp_path, folder, gt_log)


def test_cli_trains_on_cpu_and_resumes(tmp_path, monkeypatch):
    folder, gt_log = write_depth_tree(tmp_path, n_scenes=1, n_frames=4)
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    # the CLI turns TF32 off process-wide; restore it after the test
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    flags = ["--data", folder, "--gt_log", gt_log, "--dim", "8",
             "--dim_mults", "1,2", "--bf16", "false", "--image_size", "16",
             "--timesteps", "16", "--sampling_timesteps", "4",
             "--train_batch_size", "2", "--gradient_accumulate_every", "2",
             "--save_and_sample_every", "2", "--num_samples", "4",
             "--num_workers", "1", "--results_folder", "res",
             "--samples_folder", "smp"]
    cli.main(flags + ["--train_num_steps", "2"])
    assert (tmp_path / "res" / "model-0.pt").is_file()
    assert Image.open(tmp_path / "res" / "sample-1.png").size == (32, 32)
    assert not torch.backends.cudnn.allow_tf32
    cli.main(flags + ["--train_num_steps", "4", "--resume", "0"])
    assert ckpt.load_checkpoint(tmp_path / "res" / "model-0.pt")["step"] == 4
