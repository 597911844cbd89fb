"""The port's entry points on the card (``-m cuda``): the launches and
routes of a sample step and of both trainers' steps, gradients and
outputs against the CPU and against the JAX package's committed outputs,
the Tester, FID, the importer, the loaders, more than one process and the
rest of the JAX surface; they skip without a card. The kernels alone are
``tests/test_torch_port_cuda.py``'s.

Run on a machine with an H100:
    python -m pytest tests/test_torch_port_cuda*.py -q --noconftest
"""

import contextlib
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch.models import DiffusionUNet
from pointreggpt_tpu_torch.models.blocks import LinearAttention
from pointreggpt_tpu_torch.ops import attention as K2
from pointreggpt_tpu_torch.ops import graph
from pointreggpt_tpu_torch.ops import linear_attention as K1
from pointreggpt_tpu_torch.tools import counters
from test_torch_port_cuda import cuda, fp32_exact  # noqa: F401 (fixtures)

pytestmark = pytest.mark.cuda

DATA = Path(__file__).resolve().parent / "data"
# fp32 gradients, card (K1, K3, K2 and the 3x3 convs' K5 and conv3_dw in
# three TF32 passes, cuDNN fp32 for the other convs) vs CPU (plain
# versions): per parameter, relative to its largest gradient
GRAD_RTOL = 2e-3
# card vs JAX: each gate is this times (the port's CPU gap to JAX, stored
# beside the reference, + the kernels' gap to their plain versions on the
# card, measured here): the port's plain path on the card is a second draw
# of the CPU's rounding, not the same one
GATE_FACTOR = 2.0
# the keep mask or the condition may differ where a fused multiply-add
# moves a splatted point across a pixel edge: at most 0.1% of pixels
KEEP_SHARE = 1e-3
FAULT_MARGIN = 5.0  # a planted fault misses the forward gate by this


def since(before: dict, *keys) -> dict:
    """How far the counters of ``keys`` moved since ``before``."""
    now = counters()
    return {k: now[k] - before[k] for k in keys}


def let_cores_count(net, *inputs) -> None:
    """Let each LinearAttention's core, not its to_out bias, carry the
    block's output, as K1.check_inputs does: zero the bias and scale the
    weight by n^1.5 / 2 for the block's n pixels at the size of
    ``inputs`` (what ``net`` takes)."""
    pixels = {}

    def count_pixels(mod, args):
        pixels[mod] = args[0].shape[2] * args[0].shape[3]

    hooks = [m.register_forward_pre_hook(count_pixels)
             for m in net.modules() if isinstance(m, LinearAttention)]
    with torch.inference_mode():
        net(*inputs)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        for m, n in pixels.items():
            m.to_out[0].bias.zero_()
            m.to_out[0].weight.mul_(n**1.5 / 2)


def worst_grad(net, gpu_net) -> tuple:
    """The largest per-parameter max |card - CPU| / max |CPU| of the
    gradients, and its parameter's name; a parameter with no gradient on
    the CPU must be frozen and have none on the card."""
    worst, worst_name = 0.0, ""
    for (name, p), q in zip(net.named_parameters(), gpu_net.parameters()):
        if p.grad is None:
            assert not p.requires_grad and q.grad is None, name
            continue
        err = ((q.grad.cpu() - p.grad).abs().max() /
               p.grad.abs().max().clamp_min(1e-30)).item()
        assert np.isfinite(err), name
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name


@contextlib.contextmanager
def plain_attention():
    """K1's and K2's plain versions in the U-Net blocks, on the card: the
    port's path with its two kernels taken out, to measure their part of
    a gap."""
    from pointreggpt_tpu_torch.models import blocks

    saved = blocks.fused_linear_attention, blocks.multihead_attention
    blocks.fused_linear_attention = K1.fused_linear_attention_plain
    blocks.multihead_attention = K2.multihead_attention_plain
    try:
        yield
    finally:
        blocks.fused_linear_attention, blocks.multihead_attention = saved


# ---------------------------------------------------------------------------
# launches and routes of the main paths' steps

# a sample step of the production chain (250 DDIM steps, the MaskUNet
# twice): 8 K1 and 1 K2 a dim-64 DiffusionUNet or MaskUNet forward; ADM's
# 16 attention blocks a forward each one K2 call at d = 64 on its qkv
# conv's output read in place (no copy), and 2 at d = 32 the MaskUNet's;
# every GroupNorm on the kernel with no copy: 38 a dim-64 forward, 101 an
# ADM forward
SAMPLE_STEP = {
    "unet": dict(k1=2016, k3=0, k2=252, norm_fused=38 * 252),
    "adm": dict(k1=16, k3=0, k2=4002, attn_k2_d32=2, attn_k2_d64=4000,
                attn_copies=0, norm_fused=101 * 250 + 38 * 2)}


@pytest.mark.parametrize("denoiser", sorted(SAMPLE_STEP))
def test_sample_step_runs_every_call_on_its_kernel(cuda, fp32_exact,
                                                   tmp_path, monkeypatch,
                                                   denoiser):
    """One ``Generator.step`` of ``generate_dataset``'s Generator at the
    production widths and chain (the DiffusionUNet, or guided-diffusion's
    ADM at its published flags; the fp32 MaskUNet; 250 DDIM steps) at
    batch 2 and 64^2, whose counts are those of every size: K1, K3 and K2
    launches and K2's routes as ``SAMPLE_STEP`` says, none routed to the
    plain version, every GroupNorm on the kernel (two launches a call)."""
    from pointreggpt_tpu_torch.cli import generate_dataset
    from pointreggpt_tpu_torch.core import geometry as G

    monkeypatch.chdir(tmp_path)  # the Generator's samples folder
    torch.manual_seed(0)
    gen, _ = generate_dataset.build_generator(generate_dataset.parse_args([
        "--resume", "1", "--denoiser", denoiser, "--data", str(tmp_path),
        "--image_size", "64", "--batch_size", "2",
        "--memory_capacity", "4096"]))
    rng = np.random.default_rng(0)
    intr = np.array([[72.0, 0, 32.0], [0, 72.0, 32.0], [0, 0, 1]],
                    np.float32)
    pts = G.point_cloud_np(2.0 + 0.8 * rng.uniform(size=(64, 64)), intr,
                           clip=(0.5, 10.0)).astype(np.float32)
    mem = torch.zeros(2, 4096, 3)
    mem[:, :len(pts)] = torch.from_numpy(pts)
    valid = torch.zeros(2, 4096, dtype=torch.bool)
    valid[:, :len(pts)] = True
    intr = torch.from_numpy(intr).expand(2, 3, 3).to(cuda)
    gen.device_models()
    before = counters()
    out = gen.step(mem.to(cuda), valid.to(cuda), intr, G.param_vector(intr),
                   torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    want = dict(SAMPLE_STEP[denoiser], k1_plain=0, k3_plain=0, norm_plain=0,
                norm_copies=0)
    got = since(before, "gn", *want)
    assert got.pop("gn") == 2 * got["norm_fused"], got
    assert got == want
    # the chain's 250 denoiser calls: a fresh wrapper's first runs
    # eagerly, its second captures, and the graph replays the rest
    assert since(before, *graph.ROUTES) == dict(
        graph_eager=1, graph_captures=1, graph_replays=248)
    assert torch.isfinite(out.images).all()


def test_trainer_step_launches_and_leaves_group_norm_to_autograd(
        cuda, tmp_path):
    """One optimizer step of the Trainer at ``ModelConfig()`` width (two
    microbatches of 2 at 256^2, bf16): 16 K1, 16 K3 and 2 K2 launches, none
    routed to the plain version, and the 76 GroupNorms of its two forwards
    on the plain chain, which autograd differentiates (the kernel has no
    backward)."""
    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR

    folder, gt_log = DR.write_depth_tree(tmp_path, n_frames=8)
    tr = DR.build_trainer(folder, gt_log, str(tmp_path / "results"),
                          full_width=True, global_batch=2,
                          gradient_accumulate_every=2)
    img, intr = tr._upload(next(tr.dl))
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = counters()
    loss = tr.train_step(img, intr, gen)
    torch.cuda.synchronize()
    want = dict(k1=16, k3=16, k2=2, k1_plain=0, k3_plain=0, norm_fused=0,
                norm_plain=76)
    assert since(before, *want) == want
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# the denoiser's CUDA graphs (ops/graph.py)

def _graph_chain(fn, x, cond, n: int) -> list:
    """``n`` denoiser calls along a chain: each x moves towards the last
    output's first channel, at a time of its own; returns the outputs."""
    b = x.shape[0]
    outs = []
    for k in range(n):
        out = fn(x, torch.full((b,), 900.0 - 150 * k, device=x.device), cond)
        outs.append(out)
        x = (0.8 * x + 0.2 * out[:, :1].float()).permute(0, 2, 3, 1) \
            .contiguous().permute(0, 3, 1, 2)
    return outs


@pytest.mark.parametrize("denoiser", sorted(SAMPLE_STEP))
def test_graphed_denoiser_replays_the_eager_forward_bit_for_bit(
        cuda, fp32_exact, tmp_path, monkeypatch, denoiser):
    """The Generator's denoiser (``device_models()``'s wrapper; the
    DiffusionUNet or the ADM at production widths, bf16) at batch 2 and
    64^2, under inference mode: six chain calls run one eagerly, capture
    one and replay four, with outputs equal bit for bit to the same calls
    through ``.net``, the kernel and route counts of six eager calls, and
    each returned output left as it was by the calls after it; a batch of
    3 runs eagerly once and captures once more."""
    from pointreggpt_tpu_torch.cli import generate_dataset
    from pointreggpt_tpu_torch.core import geometry as G

    monkeypatch.chdir(tmp_path)
    torch.manual_seed(0)
    gen, _ = generate_dataset.build_generator(generate_dataset.parse_args([
        "--resume", "1", "--denoiser", denoiser, "--data", str(tmp_path),
        "--image_size", "64", "--batch_size", "2",
        "--memory_capacity", "4096"]))
    wrapped = gen.device_models()[0]
    assert isinstance(wrapped, graph.GraphedForward)
    g = torch.Generator(device=cuda).manual_seed(1)

    def start(b):
        intr = torch.tensor([[72.0, 0, 32.0], [0, 72.0, 32.0], [0, 0, 1]],
                            device=cuda).expand(b, 3, 3)
        x = torch.randn(b, 64, 64, 1, generator=g, device=cuda)
        return x.permute(0, 3, 1, 2), G.param_vector(intr)

    def kernels(before):
        return {k: v for k, v in since(before, *counters()).items()
                if k not in graph.ROUTES}

    x, cond = start(2)
    kept = []

    def call(*args):
        out = wrapped(*args)
        kept.append((out, out.clone()))
        return out

    with torch.inference_mode():
        before = counters()
        got = _graph_chain(call, x, cond, 6)
        torch.cuda.synchronize()
        by_graph = kernels(before)
        assert since(before, *graph.ROUTES) == dict(
            graph_eager=1, graph_captures=1, graph_replays=4)
        before = counters()
        want = _graph_chain(wrapped.net, x, cond, 6)
        torch.cuda.synchronize()
        assert by_graph == kernels(before)
        assert by_graph["k2"] > 0 and by_graph["gn"] > 0
        for k, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and a.stride() == b.stride(), k
            assert torch.equal(a, b), k
        for out, copy in kept:
            assert torch.equal(out, copy)
        before = counters()
        _graph_chain(wrapped, *start(3), 2)
        torch.cuda.synchronize()
        assert since(before, *graph.ROUTES) == dict(
            graph_eager=1, graph_captures=1, graph_replays=0)


# ---------------------------------------------------------------------------
# gradients and outputs, card against the CPU

NET_ATOL = 2e-3  # fp32 U-Net forward, card vs CPU: summation order only


def test_diffusion_unet_forward_on_the_card_matches_the_cpu(cuda, fp32_exact):
    """A dim-64 fp32 DiffusionUNet forward at 64^2 under inference mode
    (K1, K2 and the GroupNorm kernel in fp32) against the same net on the
    CPU, with each LinearAttention's core carrying its block's output."""
    torch.manual_seed(0)
    net = DiffusionUNet(dim=64).eval()
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(2, 1, 64, 64)), dtype=torch.float32)
    t = torch.tensor([10.0, 900.0])
    pc = torch.tensor(rng.uniform(100, 600, (2, 4)), dtype=torch.float32)
    cl = torch.channels_last
    let_cores_count(net, x, t, pc)
    with torch.inference_mode():
        ref = net(x, t, pc)
        got = net.to(cuda, memory_format=cl)(
            x.to(cuda, memory_format=cl), t.to(cuda), pc.to(cuda)).cpu()
    assert (got - ref).abs().max().item() <= NET_ATOL


@pytest.mark.parametrize("dim", [64, 256])
def test_loss_gradients_on_the_card_match_the_cpu(cuda, fp32_exact, dim):
    """``p_losses`` gradients of an fp32 DiffusionUNet at 64^2, batch 2, t
    and noise injected, on the card (K1, K3, K2 and its recompute) against
    the CPU (plain versions), per parameter within ``GRAD_RTOL``, each
    LinearAttention's core carrying its output; all 8 K1 and 8 K3 calls
    launched, none routed to the plain version (dim 256: c = 256 ...
    2048, the kernels' widest)."""
    torch.manual_seed(0)
    net = DiffusionUNet(dim=dim).to(memory_format=torch.channels_last)
    widths = {m.to_qkv.in_channels for m in net.modules()
              if isinstance(m, LinearAttention)}
    assert max(widths) == 8 * dim
    rng = np.random.default_rng(3)
    x0 = torch.tensor(rng.uniform(-1, 1, (2, 64, 64, 1)), dtype=torch.float32)
    noise = torch.tensor(rng.normal(size=(2, 64, 64, 1)), dtype=torch.float32)
    t = torch.tensor([40, 730])
    pc = torch.tensor(rng.uniform(100, 600, (2, 4)), dtype=torch.float32)
    let_cores_count(net, x0.permute(0, 3, 1, 2), t.float(), pc)
    diffusion = C.build_diffusion(C.DiffusionConfig(image_size=64))
    gpu_net = copy.deepcopy(net).to(cuda, memory_format=torch.channels_last)
    diffusion.p_losses(net, x0, t, pc, noise=noise).backward()
    before = counters()
    diffusion.p_losses(gpu_net, x0.to(cuda), t.to(cuda), pc.to(cuda),
                       noise=noise.to(cuda)).backward()
    torch.cuda.synchronize()
    want = dict(k1=8, k3=8, k1_plain=0, k3_plain=0)
    assert since(before, *want) == want
    worst, name = worst_grad(net, gpu_net)
    assert worst <= GRAD_RTOL, (name, worst)


# ---------------------------------------------------------------------------
# the depth-correction path on the card


def _write_pairs(root, size, n=2, seed=0):
    """``n`` train pairs and one val pair of uint16 depth PNGs."""
    import json

    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "data").mkdir(parents=True)
    (root / "metadata").mkdir()
    for subset, count in (("train", n), ("val", 1)):
        entries = []
        for i in range(count):
            base = rng.integers(500, 9000, (size, size))
            label = base + rng.integers(0, 30, base.shape)
            off = rng.uniform(size=base.shape) < 0.3
            label[off] += rng.integers(60, 2000, int(off.sum()))
            names = [f"{subset}-{i}-{k}.depth.png" for k in ("in", "lb")]
            for name, a in zip(names, (base, label)):
                Image.fromarray(a.astype(np.uint16)).save(root / "data" / name)
            entries.append({"input_path": names[0], "label_path": names[1]})
        (root / "metadata" / f"{subset}.json").write_text(
            json.dumps(entries))
    return str(root)


# the small width has 2 channels a group: with 1 (dim 8, 8 groups) the
# bias of the conv before each GroupNorm has a gradient of exactly 0, and
# both sides hold rounding noise there
@pytest.mark.parametrize("dim,mults,groups,size", [
    (8, (1, 2), 4, 32), (64, (1, 2, 4, 8), 8, 64)])
def test_mask_trainer_step_on_the_card_matches_the_cpu(cuda, fp32_exact,
                                                       tmp_path, dim,
                                                       mults, groups, size):
    """One MaskTrainer step on the card against the CPU: every gradient
    within ``GRAD_RTOL``, Adam's first step alike; on the card one K1, K3
    call a LinearAttention block and one K2 (8, 8 and 1 at full width),
    none routed to the plain version, and (full width) its 43 3x3 convs on
    K5, its 15 other convs on ``F.conv2d``."""
    from pointreggpt_tpu_torch.data.datasets import collate
    from pointreggpt_tpu_torch.models import MaskUNet
    from pointreggpt_tpu_torch.train.mask_trainer import (MaskTrainer,
                                                          _to_device)

    folder = _write_pairs(tmp_path / "dc", size)
    torch.manual_seed(0)
    kw = dict(dim=dim, dim_mults=mults, resnet_block_groups=groups)
    net = MaskUNet(**kw)
    trainers = [MaskTrainer(MaskUNet(**kw), folder,
                            image_size=size, train_batch_size=2,
                            train_lr=4e-5, num_workers=1, device=dev,
                            results_folder=str(tmp_path / f"r{dev}"),
                            samples_folder=str(tmp_path / f"s{dev}"))
                for dev in ("cpu", "cuda")]
    batch = collate([trainers[0].train_ds[i] for i in range(2)])
    for tr in trainers:
        tr.model.load_state_dict(net.state_dict())
        before = counters()
        tr.train_step(*_to_device(batch, ("input_img", "mask"), tr.device))
    torch.cuda.synchronize()
    n_attn = 2 * len(mults)
    want = dict(k1=n_attn, k3=n_attn, k2=1, k1_plain=0, k3_plain=0)
    if dim == 64:
        want.update(conv_k5=43, conv_library=15)
    assert since(before, *want) == want
    lr = trainers[0].lr_at(0)
    for (name, p), q in zip(trainers[0].model.named_parameters(),
                            trainers[1].model.parameters()):
        g, gq = p.grad, q.grad.cpu()
        scale = g.abs().max().item()
        assert (gq - g).abs().max().item() <= GRAD_RTOL * scale, name
        # Adam's first step moves each parameter by lr times the sign of
        # its gradient: where the gradient is larger than the card-vs-CPU
        # bound, both sides take the same step, equal to fp32 rounding of
        # the O(1) parameter; elsewhere the sign may differ (at most 2 lr)
        diff = (q.detach().cpu() - p.detach()).abs()
        sure = g.abs() > 2 * GRAD_RTOL * scale
        assert diff[sure].max().item() <= 1e-6, name
        assert diff.max().item() <= 2 * lr * 1.001, name


def test_test_dataset_item_on_the_card_matches_the_cpu(cuda, tmp_path):
    from pointreggpt_tpu_torch.data import datasets
    from pointreggpt_tpu_torch.tools.synthetic_3dmatch import (
        write_motion_tree)

    rgbd, data_root, _, info = write_motion_tree(tmp_path, 1, seed=3)
    got, want = (datasets.TestDataset(info, str(rgbd), 256,
                                      data_root=str(data_root),
                                      device=dev)[0]
                 for dev in ("cuda", "cpu"))
    for k in ("input_img", "label_img"):
        # the same fp32 arithmetic; the card may fuse a multiply-add, which
        # can move a point across a pixel edge: at most 0.1% of pixels
        off = np.abs(got[k] - want[k]) > 1e-6
        assert off.mean() <= KEEP_SHARE, (k, off.mean())
    assert (got["input_img"] > 0).mean() > 0.5


# ---------------------------------------------------------------------------
# the port against JAX output, gt.log and the Tester on the card


@pytest.mark.parametrize("case", ["forward", "mask", "step"])
def test_jax_parity_on_the_card(cuda, fp32_exact, tmp_path, case):
    """The port's full-width outputs on the card (K1 and K2 bf16 in the
    DiffusionUNet, fp32 in the MaskUNet) against the JAX package's,
    ``tests/data/torch_port_jax_reference.npz`` (a baked bf16 forward at
    batch 2, an fp32 MaskUNet forward at batch 4, one 10-step
    ``Generator.step``): each gap within ``GATE_FACTOR`` x (the port's CPU
    gap + the kernels' gap to their plain versions on the card), 8 K1 and
    1 K2 a forward; a shuffled head (``jax_parity.plant_fault``) at least
    ``FAULT_MARGIN`` x the forward's gate."""
    from pointreggpt_tpu_torch.utils import jax_parity as J

    ref = dict(np.load(DATA / "torch_port_jax_reference.npz"))
    nets = J.nets()
    before = counters()
    card = J.run_port("cuda", cases=(case,), nets_=nets, tmp_dir=str(tmp_path))
    torch.cuda.synchronize()
    forwards = {"forward": 1, "mask": 1,
                "step": J.STEP_SAMPLING_TIMESTEPS + 2}[case]
    want = dict(k1=8 * forwards, k3=0, k2=forwards, k1_plain=0, k3_plain=0)
    assert since(before, *want) == want
    with plain_attention():
        plain = J.run_port("cuda", cases=(case,), nets_=nets,
                           tmp_dir=str(tmp_path))
    card_gap, kernel_gap = J.gaps(card, ref), J.gaps(card, plain)
    for k, gap in card_gap.items():
        gate = (KEEP_SHARE if k == "step_keep" else
                GATE_FACTOR * (float(ref[f"cpu_gap_{k}"]) + kernel_gap[k]))
        assert gap <= gate, (k, gap, gate, kernel_gap[k])
    if case == "forward":
        fault = J.gaps(J.run_port("cuda", cases=("forward",),
                                  nets_=(J.plant_fault(nets[0]),) +
                                  nets[1:]), ref)["forward"]
        gate = GATE_FACTOR * (float(ref["cpu_gap_forward"]) +
                              kernel_gap["forward"])
        assert fault >= FAULT_MARGIN * gate, (fault, gate)


def test_overlap_ratio_on_the_card_matches_the_cpu(cuda, fp32_exact):
    from pointreggpt_tpu_torch.core import pointops as P

    rng = np.random.default_rng(0)
    s = rng.uniform(-1, 1, (3, 4000, 3)).astype(np.float32)
    t = s + rng.normal(0, 0.05, s.shape).astype(np.float32)
    t[:, :1500] += 0.8
    sv = rng.uniform(size=s.shape[:2]) < 0.9
    tv = rng.uniform(size=t.shape[:2]) < 0.9
    sv[2] = False  # an empty cloud: NaN on both
    args = [torch.from_numpy(a) for a in (s, sv, t, tv)]
    got = [o.cpu().numpy() for o in P.overlap_ratio(
        *(a.to(cuda) for a in args), voxel_size=0.05)]
    want = [o.numpy() for o in P.overlap_ratio(*args, voxel_size=0.05)]
    # a point within rounding of the radius may land on the other side:
    # one point of its downsampled cloud (1 / n)
    for g, w, (pts, ok) in zip(got, want, ((s, sv), (t, tv))):
        n = np.array([int(P.voxel_downsample(torch.from_numpy(p),
                                             torch.from_numpy(v), 0.05)[1]
                          .sum()) for p, v in zip(pts, ok)])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        fin = ~np.isnan(w)
        assert (np.abs(g - w)[fin] <= 1.0 / np.maximum(n, 1)[fin]).all()
    assert np.isnan(got[0][2]) and 0.3 < got[0][0] < 0.9


def _small_tester(device, tmp, **kw):
    from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
    from pointreggpt_tpu_torch.generate.generator import place_for_inference
    from pointreggpt_tpu_torch.generate.tester import Tester
    from pointreggpt_tpu_torch.utils.seeded_weights import fill_seeded

    net = fill_seeded(DiffusionUNet(dim=8, dim_mults=(1, 2)), 0)
    diffusion = GaussianDiffusion(image_size=32, timesteps=8,
                                  objective="pred_x0",
                                  beta_schedule="sigmoid", **kw)
    tester = Tester(net, diffusion, batch_size=2, device=device,
                    samples_folder=str(tmp / str(device)))
    tester.ema_model = place_for_inference(net, tester.device)
    return tester


# fp32 dim-8 net, card (K1 and K2 fp32, cuDNN fp32) vs CPU (plain
# versions): the chain bound of the CPU tests against JAX
CHAIN_ATOL, CHAIN_RTOL = 5e-4, 1e-3


def test_tester_step_on_the_card_matches_the_cpu(cuda, fp32_exact,
                                                 tmp_path):
    rng = np.random.default_rng(1)
    b, h = 2, 32
    intr = np.zeros((b, 3, 3), np.float32)
    intr[:, 0, 0] = intr[:, 1, 1] = 36.0
    intr[:, 0, 2] = intr[:, 1, 2] = h / 2
    intr[:, 2, 2] = 1.0
    pc = intr[:, [0, 1, 0, 1], [0, 1, 2, 2]]
    images = rng.uniform(0.15, 0.3, (b, h, h, 1)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose[:, :3, 3] = [0.0, 0.0, 0.5]
    x_init = rng.normal(size=(b, h, h, 1)).astype(np.float32)
    outs = []
    for dev in ("cuda", "cpu"):
        tester = _small_tester(dev, tmp_path, sampling_timesteps=4,
                               ddim_sampling_eta=0.0)
        before = K1.fused_linear_attention.launches
        out = tester.step(*(torch.from_numpy(a).to(dev)
                            for a in (images, intr, pc, pose)), True,
                          x_init=torch.from_numpy(x_init).to(dev))
        outs.append([o.cpu().numpy() for o in out])
        if dev == "cuda":
            assert K1.fused_linear_attention.launches == before + 4 * 4
    (d_gpu, c_gpu, i_gpu), (d_cpu, c_cpu, i_cpu) = outs
    # the splat may move a point across a pixel edge (a fused
    # multiply-add): at most 0.1% of pixels, as TestDataset's rule
    off = np.abs(d_gpu - d_cpu) > 1e-5
    assert off.mean() <= KEEP_SHARE, off.mean()
    same = ~off.any(axis=0, keepdims=True).repeat(b, 0)
    np.testing.assert_allclose(i_gpu[..., 0][same], i_cpu[..., 0][same],
                               atol=CHAIN_ATOL, rtol=CHAIN_RTOL)
    assert (c_cpu[..., 1] > 0).mean() > 0.3


def test_p_sample_loop_on_the_card_matches_the_cpu(cuda, fp32_exact,
                                                   tmp_path):
    rng = np.random.default_rng(2)
    b, h, t = 2, 32, 8
    x_init = rng.normal(size=(b, h, h, 1)).astype(np.float32)
    noise = rng.normal(size=(t, b, h, h, 1)).astype(np.float32)
    pc = np.array([[40.0, 40.0, 16.0, 16.0], [35.0, 36.0, 16.0, 16.0]],
                  np.float32)
    mask = (rng.uniform(size=(b, h, h)) > 0.5).astype(np.float32)
    depth = rng.uniform(0.1, 0.4, (b, h, h)).astype(np.float32)
    cond = (np.stack([depth, mask], -1) * 2.0 - 1.0).astype(np.float32)
    outs = []
    for dev in ("cuda", "cpu"):
        tester = _small_tester(dev, tmp_path, sampling_timesteps=t)
        assert not tester.diffusion.is_ddim_sampling
        before = K2.multihead_attention.launches
        out = tester.diffusion.p_sample_loop(
            tester.ema_model, torch.from_numpy(pc).to(dev),
            torch.from_numpy(cond).to(dev), (b, h, h, 1),
            has_refine_step=True, x_init=torch.from_numpy(x_init).to(dev),
            noise=lambda s: torch.from_numpy(noise[s]))
        outs.append(out.cpu().numpy())
        if dev == "cuda":
            # t chain steps and the refine step, one K2 each
            assert K2.multihead_attention.launches == before + t + 1
    np.testing.assert_allclose(outs[0], outs[1], atol=CHAIN_ATOL,
                               rtol=CHAIN_RTOL)


# ---------------------------------------------------------------------------
# FID, the checkpoint importer and the registration loaders on the card

FID_REFERENCE = DATA / "torch_port_fid_import_reference.npz"
FID_FAULT_MARGIN = 10.0  # the flipped pools miss the features gate by this
# card vs CPU fid_score, relative: feature noise of 3e-7 (the port's CPU
# gap to JAX) moves the score by 0.6-1.7e-4 on the CPU
FID_SCORE_RTOL = 1e-2


def test_inception_features_on_the_card_match_the_cpu_and_jax(cuda,
                                                              fp32_exact):
    """``InceptionFeatures`` at 299^2 on ``jax_parity.fid_images()`` (32
    images, one chunk) on the card against the port on the CPU and the
    JAX features committed in ``FID_REFERENCE``, gated as the JAX parity
    test gates; ``fid_pools`` flipped as a planted fault at least
    ``FID_FAULT_MARGIN`` x the gate; the FID of two seeded sets card vs
    CPU within ``FID_SCORE_RTOL``."""
    from pointreggpt_tpu_torch.eval import fid, inception
    from pointreggpt_tpu_torch.utils import jax_parity as J

    ref = np.load(FID_REFERENCE)
    sd = inception.init_random_params(J.INCEPTION_SEED)
    imgs, other = J.fid_images(), J.fid_images(J.SEED + 1)
    card = fid.InceptionFeatures(state_dict=sd, device="cuda")
    cpu = fid.InceptionFeatures(state_dict=sd, device="cpu")
    got, plain = card(imgs), cpu(imgs)
    want = ref["fid_features"]
    gate = GATE_FACTOR * (float(ref["cpu_gap_fid_features"]) +
                          float(np.abs(got - plain).max()))
    assert np.abs(got - want).max() <= gate
    card.model.fid_pools = not card.model.fid_pools
    fault = float(np.abs(card(imgs) - want).max())
    card.model.fid_pools = not card.model.fid_pools
    assert fault >= FID_FAULT_MARGIN * gate, (fault, gate)
    score = fid.fid_score(imgs, other, card)
    score_cpu = fid.fid_score(imgs, other, cpu)
    assert abs(score - score_cpu) <= FID_SCORE_RTOL * abs(score_cpu)


MIXTURE_EDGE = 1e-5  # a pair within this of the radius may flip in fp32


def pair_differences(got, want, src, tgt, transform, radius) -> int:
    """How many (src_idx, tgt_idx) pairs one array has and the other not;
    fails unless every one lies within ``MIXTURE_EDGE`` of ``radius``
    (float64 distance after ``transform``)."""
    diff = set(map(tuple, got.tolist())) ^ set(map(tuple, want.tolist()))
    if not diff:
        np.testing.assert_array_equal(got, want)  # the same order
        return 0
    i, j = np.array(sorted(diff)).T
    rot = np.asarray(transform, np.float64)
    s = np.asarray(src, np.float64)[i] @ rot[:3, :3].T + rot[:3, 3]
    d = np.linalg.norm(s - np.asarray(tgt, np.float64)[j], axis=1)
    assert (np.abs(d - radius) < MIXTURE_EDGE).all(), (sorted(diff)[:5],
                                                        d[:5])
    return len(diff)


def test_correspondences_on_the_card_match_the_cpu(cuda, fp32_exact):
    from pointreggpt_tpu_torch.core import pointops as P
    from pointreggpt_tpu_torch.dataloaders.mixture import (
        uniform_sample_rotation)

    rng = np.random.default_rng(0)
    tgt = rng.uniform(0, 2, (20000, 3)).astype(np.float32)
    tsfm = np.eye(4)
    tsfm[:3, :3] = uniform_sample_rotation(rng)
    tsfm[:3, 3] = rng.normal(size=3)
    src = (tgt[:15000] + rng.normal(0, 0.01, (15000, 3)) - tsfm[:3, 3]) @ \
        tsfm[:3, :3]
    got = P.correspondences_np(src, tgt, tsfm, 0.0375, device="cuda")
    want = P.correspondences_np(src, tgt, tsfm, 0.0375, device="cpu")
    assert len(want) > 15000
    # only pairs within 1e-5 of the radius may differ
    pair_differences(got, want, src, tgt, tsfm, 0.0375)
    args = [torch.from_numpy(a) for a in (
        src.astype(np.float32), np.ones(15000, bool), tgt,
        rng.uniform(size=20000) > 0.2)]
    d_gpu = P.min_dist_sq(*(a.to(cuda) for a in args)).cpu()
    torch.testing.assert_close(d_gpu, P.min_dist_sq(*args), rtol=0,
                               atol=2e-6)


def test_imported_checkpoint_drives_a_generator_step_on_the_card(
        cuda, fp32_exact, tmp_path):
    """Full-width reference-layout ``.pt`` files of seeded weights with the
    reference's extra keys (``model-official.pt``: the EMA U-Net is the
    JAX parity test's bf16 net, the online one another seed;
    ``model-best.pt``: its step MaskUNet) through the importer CLI, then
    one ``Generator.step`` (the JAX parity step case) from the nets the
    Generator's loaders fill from its output, equal bit for bit to the
    step from the un-imported nets, with 8 K1 and 1 K2 a forward."""
    from pointreggpt_tpu_torch.cli import import_torch_checkpoint
    from pointreggpt_tpu_torch.generate.generator import load_ema_unet
    from pointreggpt_tpu_torch.utils import jax_parity as J
    from pointreggpt_tpu_torch.utils.jax_params import \
        load_reference_checkpoint
    from pointreggpt_tpu_torch.utils.seeded_weights import fill_seeded

    src, out = tmp_path / "reference", tmp_path / "imported"
    ema, _, mask0 = J.nets()
    online = fill_seeded(C.build_diffusion_unet(C.ModelConfig()), J.SEED + 7)
    src.mkdir()
    torch.save({
        "step": 1000,
        "model": {**{f"model.{k}": v for k, v in online.state_dict().items()},
                  "betas": torch.zeros(1000)},
        "opt": {"state": {}, "param_groups": []},
        "ema": {"initted": torch.tensor(True), "step": torch.tensor(990),
                **{f"ema_model.model.{k}": v
                   for k, v in ema.state_dict().items()},
                "ema_model.betas": torch.zeros(1000)},
        "scaler": {"scale": 65536.0}}, src / "model-official.pt")
    torch.save({"epoch": 99, "model": mask0.state_dict(),
                "opt": {"state": {}, "param_groups": []},
                "scheduler": {"last_epoch": 99}, "scaler": None,
                "loss_hist": [0.5, 0.25],
                "metrics": {"best": {"SAE": torch.tensor(0.125)}}},
               src / "model-best.pt")
    import_torch_checkpoint.main([
        "--diffusion", str(src / "model-official.pt"),
        "--depth_correction", str(src / "model-best.pt"),
        "--diffusion_out", str(out / "results"),
        "--dc_out", str(out / "dc")])
    unet = C.build_diffusion_unet(C.ModelConfig())
    load_ema_unet(unet, out / "results" / "model-official.pt")
    mask = C.build_mask_unet(C.MaskModelConfig())
    mask.load_state_dict(load_reference_checkpoint(
        out / "dc" / "model-best.pt")["model"])
    before = counters()
    got = J.run_port("cuda", cases=("step",), nets_=(unet, None, mask),
                     tmp_dir=str(tmp_path))
    forwards = J.STEP_SAMPLING_TIMESTEPS + 2
    want = dict(k1=8 * forwards, k3=0, k2=forwards, k1_plain=0, k3_plain=0)
    assert since(before, *want) == want
    ref = J.run_port("cuda", cases=("step",), nets_=(ema, None, mask0),
                     tmp_dir=str(tmp_path))
    assert all(np.array_equal(got[k], ref[k]) for k in ref)


def test_imported_jax_checkpoints_forward_on_the_card_as_on_the_cpu(
        cuda, fp32_exact, tmp_path):
    """The committed JAX ``.ckpt`` pair (``tests/data/torch_port_jax_*.ckpt``,
    dim 8) through the importer CLI: the imported nets' fp32 forwards on
    the card against the same forwards on the CPU, within ``NET_ATOL``
    (``test_torch_port_import.py`` holds the CPU's against JAX)."""
    from pointreggpt_tpu_torch.cli import import_torch_checkpoint
    from pointreggpt_tpu_torch.utils import jax_parity as J

    out = tmp_path / "ckpt"
    import_torch_checkpoint.main([
        "--diffusion", str(DATA / "torch_port_jax_diffusion.ckpt"),
        "--depth_correction", str(DATA / "torch_port_jax_mask.ckpt"),
        "--milestone", "7", "--diffusion_out", str(out / "results"),
        "--dc_out", str(out / "dc"), *J.SMALL_FLAGS])
    pts = (out / "results" / "model-7.pt", out / "dc" / "model-7.pt")
    card = J.import_forwards(*pts, "cuda")
    plain = J.import_forwards(*pts, "cpu")
    for k in ("diffusion_forward", "mask_forward"):
        assert np.abs(card[k] - plain[k]).max() <= NET_ATOL, k


# ---------------------------------------------------------------------------
# more than one process (dim 8, 32^2, fp32)

def _deterministic_fp32() -> None:
    """cuDNN's deterministic algorithms, and fp32 products in fp32, in
    this process (each launched process sets them for itself)."""
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def card_flags(monkeypatch):
    """Restore cuDNN's and cuBLAS's flags that a run in this process sets."""
    for flag in ("deterministic", "benchmark", "allow_tf32"):
        monkeypatch.setattr(torch.backends.cudnn, flag,
                            getattr(torch.backends.cudnn, flag))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _small_trainer_run(root: str, results: str) -> dict:
    """Two Trainer steps at a global microbatch of 4 with cuDNN's
    deterministic algorithms; the replica digest and the device."""
    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR

    _deterministic_fp32()
    tr = DR.build_trainer(str(Path(root) / "rgbd"),
                          str(Path(root) / "gt.log"), results,
                          full_width=False, global_batch=4, steps=2)
    tr.train(log_every=10**9)
    return dict(digest=DR.digest(tr.ema), device=str(tr.device))


def _group_of_one_rank(root: str) -> dict:
    import torch.distributed as dist

    return dict(backend=str(dist.get_backend()),
                **_small_trainer_run(root, root + "/results-ws1"))


def test_trainer_in_a_group_of_one_over_nccl_is_bit_identical(
        cuda, tmp_path, card_flags):
    """One process in a group of one over NCCL trains bit for bit as with
    no group (the all-reduce of one and the division by 1 are exact)."""
    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR

    DR.write_depth_tree(tmp_path, n_frames=8)
    one = _small_trainer_run(str(tmp_path), str(tmp_path / "results-one"))
    (ws1,) = DR.launch(_group_of_one_rank, 1, args=(str(tmp_path),),
                       timeout_s=300, threads=None)
    assert "nccl" in ws1["backend"]
    assert ws1["device"] == "cuda:0"
    assert ws1["digest"] == one["digest"]


def _card_trainer_run(root: str, results: str) -> dict:
    from test_torch_port_parallel import _trainer_run

    _deterministic_fp32()
    return _trainer_run(root, results)


def _card_trainer_rank(root: str) -> dict:
    from pointreggpt_tpu_torch.parallel import mesh as M

    return _card_trainer_run(root, f"{root}/results-{M.process_index()}")


# two processes' averaged fp32 gradient against one process's on the same
# global batch, both on the card: the batch mean and the all-reduce sum
# the same terms in another order, and cuDNN may pick another algorithm
# for a microbatch of 2 than of 4 (4.3e-7 on an H100)
DIST_GRAD_RTOL = 1e-5


def test_two_process_trainer_on_the_card_matches_one_process(
        cuda, tmp_path, card_flags):
    """``test_torch_port_parallel``'s Trainer comparison on the card: two
    processes on ``cuda:0`` over gloo (dim 8, 32^2, fp32, two steps of a
    global microbatch of 4) against one process; replicas identical after
    each step, step 1's averaged gradient within ``DIST_GRAD_RTOL`` of
    the one process's, and a planted fault (no division by the process
    count) at least 100 x the gate."""
    from test_torch_port_parallel import TRAIN_STEPS, _rel

    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR

    DR.write_depth_tree(tmp_path, n_frames=8)
    ranks = DR.launch(_card_trainer_rank, 2, args=(str(tmp_path),),
                      local_ranks=[0, 0], backend="gloo", timeout_s=300)
    one = _card_trainer_run(str(tmp_path), str(tmp_path / "results-one"))
    assert ranks[0]["digests"] == ranks[1]["digests"]
    assert len(ranks[0]["grads"]) == TRAIN_STEPS
    for g0, g1 in zip(ranks[0]["grads"], ranks[1]["grads"]):
        np.testing.assert_array_equal(g0, g1)
    rel = _rel(ranks[0]["grads"][0], one["grads"][0])
    assert rel <= DIST_GRAD_RTOL, rel
    fault = _rel(2 * ranks[0]["grads"][0], one["grads"][0])
    assert fault >= 100 * DIST_GRAD_RTOL, fault


def test_two_processes_share_the_card_over_gloo(cuda):
    """The dry run in two processes on ``cuda:0`` over gloo (NCCL takes
    one process per card): replicas identical, scenes by stride, rank 0's
    checkpoint alone."""
    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR

    out = DR.dryrun(2, local_ranks=[0, 0], backend="gloo", timeout_s=300)
    assert out["devices"] == ["cuda:0", "cuda:0"]


def test_profiled_trainer_traces_device_kernels(cuda, tmp_path,
                                                monkeypatch):
    """``PRGPT_PROFILE`` on the card writes a trace that holds the step's
    kernels."""
    import json

    from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR

    folder, gt_log = DR.write_depth_tree(tmp_path, n_frames=4)
    monkeypatch.setenv("PRGPT_PROFILE", str(tmp_path / "prof"))
    tr = DR.build_trainer(folder, gt_log, str(tmp_path / "r"),
                          full_width=False, global_batch=2, steps=6)
    tr.sample_on_save = False
    tr.train(log_every=1)
    (trace,) = (tmp_path / "prof").rglob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


# ---------------------------------------------------------------------------
# the rest of the JAX surface


@pytest.mark.parametrize("case", ["condition", "denoise", "interpolate",
                                  "fourier"])
def test_surface_parity_on_the_card(cuda, fp32_exact, case):
    """The port's outputs of ``jax_surface``'s cases on the card (the bf16
    denoise chain, the fp32 interpolation, the fp32 Fourier /
    learned-variance forward, ``image_condition``) against
    ``tests/data/torch_port_jax_surface.npz``, gated as the JAX parity
    test gates (the condition's share of differing pixels at
    ``KEEP_SHARE``), 8 K1 and 1 K2 a forward; the interpolation's weights
    swapped (lambda -> 1 - lambda) at least ``FAULT_MARGIN`` times its
    gate."""
    from pointreggpt_tpu_torch.utils import jax_surface as JS

    ref = dict(np.load(DATA / "torch_port_jax_surface.npz"))
    nets = JS.nets()
    before = counters()
    card = JS.run_port("cuda", ref, cases=(case,), nets_=nets)
    torch.cuda.synchronize()
    forwards = {"condition": 0, "denoise": JS.DENOISE_STEPS,
                "interpolate": JS.INTERP_T, "fourier": 1}[case]
    want = dict(k1=8 * forwards, k3=0, k2=forwards, k1_plain=0, k3_plain=0)
    assert since(before, *want) == want
    with plain_attention():
        plain = JS.run_port("cuda", ref, cases=(case,), nets_=nets)
    card_gap, kernel_gap = JS.gaps(card, ref), JS.gaps(card, plain)
    gate = {k: (KEEP_SHARE if k == "condition" else
                GATE_FACTOR * (float(ref[f"cpu_gap_{k}"]) + kernel_gap[k]))
            for k in card_gap}
    assert all(card_gap[k] <= gate[k] for k in gate), (card_gap, gate)
    if case == "interpolate":
        fault = JS.gaps(JS.run_port("cuda", ref, cases=("interpolate",),
                                    nets_=nets, lam=1 - JS.INTERP_LAM),
                        ref)["interpolate"]
        assert fault >= FAULT_MARGIN * gate["interpolate"], (fault, gate)


def test_surface_ckpt_folder_drives_a_generator_step_on_the_card(
        cuda, fp32_exact, tmp_path):
    """A results folder holding only the committed JAX ``.ckpt`` files:
    ``Generator.load`` and its depth-correction loader fill the nets, and
    one ``Generator.step`` (the JAX parity step case) from them equals bit
    for bit the step from the nets the importer's ``.pt`` files fill; 10
    DDIM forwards and 2 MaskUNet forwards, each one K1 a LinearAttention
    block (4 at dim_mults (1, 1)) and one K2."""
    import shutil

    from pointreggpt_tpu_torch.cli import import_torch_checkpoint
    from pointreggpt_tpu_torch.generate import Generator
    from pointreggpt_tpu_torch.utils import jax_parity as J

    jax_dir, pt_dir = tmp_path / "jax", tmp_path / "pt"
    (jax_dir / "results").mkdir(parents=True)
    (jax_dir / "dc").mkdir()
    shutil.copy(DATA / "torch_port_jax_diffusion.ckpt",
                jax_dir / "results" / "model-7.ckpt")
    shutil.copy(DATA / "torch_port_jax_mask.ckpt",
                jax_dir / "dc" / "model-best.ckpt")
    import_torch_checkpoint.main([
        "--diffusion", str(jax_dir / "results" / "model-7.ckpt"),
        "--depth_correction", str(jax_dir / "dc" / "model-best.ckpt"),
        "--diffusion_out", str(pt_dir / "results"),
        "--dc_out", str(pt_dir / "dc"), *J.SMALL_FLAGS])

    def loaded(folder):
        gen = Generator(C.build_diffusion_unet(J.SMALL_MODEL),
                        C.build_diffusion(C.DiffusionConfig()), str(folder),
                        batch_size=1, results_folder=str(folder / "results"),
                        samples_folder=str(folder / "samples"),
                        depth_correction_model=C.build_mask_unet(
                            J.SMALL_MASK),
                        depth_correction_results=str(folder / "dc"),
                        device="cuda")
        gen.load(7)
        gen._load_depth_correction()
        return gen.model, None, gen.depth_correction_model

    before = counters()
    got = J.run_port("cuda", cases=("step",), nets_=loaded(jax_dir),
                     tmp_dir=str(tmp_path))
    forwards = J.STEP_SAMPLING_TIMESTEPS + 2
    per_forward = 2 * len(J.SMALL_MODEL.dim_mults)
    want = dict(k1=per_forward * forwards, k3=0, k2=forwards)
    assert since(before, *want) == want
    ref = J.run_port("cuda", cases=("step",), nets_=loaded(pt_dir),
                     tmp_dir=str(tmp_path))
    assert all(np.array_equal(got[k], ref[k]) for k in ref)


def test_surface_native_decode_on_the_cards_machine(cuda, tmp_path):
    """The native host library builds on the card's machine (g++ -O3, zlib
    found or not) and ``load_depth_model_space`` decodes 16-bit PNGs of
    640x480 and 480x640 as PIL does, bit for bit, flip on and off."""
    from PIL import Image

    from pointreggpt_tpu_torch import native
    from pointreggpt_tpu_torch.core import imageio16

    assert native.is_available()
    rng = np.random.default_rng(0)
    for shape in ((480, 640), (640, 480)):
        a = rng.integers(300, 12000, shape).astype(np.uint16)
        a[rng.uniform(size=shape) < 0.1] = 0
        path = tmp_path / f"frame-{shape[0]}.depth.png"
        Image.fromarray(a).save(path)
        for flip in (False, True):
            got = imageio16.load_depth_model_space(path, 256, flip=flip)
            want = imageio16.load_depth_model_space(path, 256, flip=flip,
                                                    use_native=False)
            assert got.dtype == want.dtype and np.array_equal(got, want)


SURFACE_GRAD_OPTIONS = {
    "learned": dict(learned_sinusoidal_cond=True, learned_variance=True),
    "frozen": dict(random_fourier_features=True, learned_variance=True)}


@pytest.mark.parametrize("option", sorted(SURFACE_GRAD_OPTIONS))
def test_surface_fourier_gradients_on_the_card(cuda, fp32_exact, option):
    """The gradients of a dim-64 fp32 DiffusionUNet with the Fourier time
    embedding (learned or frozen frequencies) and the learned-variance
    head, at 64^2, batch 2, of a fixed weighted sum of its two output
    channels: on the card (8 K1, 8 K3, 1 K2) against the CPU (plain
    versions), per parameter within ``GRAD_RTOL``; the frozen frequencies
    get no gradient on either side, the learned ones one."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=(2, 1, 64, 64)), dtype=torch.float32)
    t = torch.tensor([40.0, 730.0])
    pc = torch.tensor(rng.uniform(100, 600, (2, 4)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(2, 2, 64, 64)), dtype=torch.float32)
    torch.manual_seed(0)
    net = DiffusionUNet(dim=64, **SURFACE_GRAD_OPTIONS[option]).to(
        memory_format=torch.channels_last)
    let_cores_count(net, x, t, pc)
    gpu_net = copy.deepcopy(net).to(cuda, memory_format=torch.channels_last)
    (net(x, t, pc) * w).sum().backward()
    before = counters()
    (gpu_net(x.to(cuda), t.to(cuda), pc.to(cuda)) * w.to(cuda)).sum() \
        .backward()
    torch.cuda.synchronize()
    want = dict(k1=8, k3=8, k2=1, k1_plain=0, k3_plain=0)
    assert since(before, *want) == want
    worst, name = worst_grad(net, gpu_net)
    assert worst <= GRAD_RTOL, (name, worst)
    frequencies = net.time_mlp[0].weights
    assert (frequencies.grad is None) == (option == "frozen")
    if option == "learned":
        assert frequencies.grad.abs().max() > 0
