"""guided-diffusion's ADM in the port (``models/adm.py``) against the plain
reference ``portbench/reference/adm.py`` on the CPU at a small size: 32
channels, multipliers (1, 2, 2), attention at downsampling rates 2 and 4,
heads 16 wide, 32^2 inputs, one depth channel in and two out, with the
benchmark's seeded draw (``portbench/lib/adm_weights.py``). Also its state
dict against guided-diffusion's layout, the chain with a learned-variance
head, the bake, and ``generate_dataset --denoiser adm`` end to end."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch.models import ADMUNet, DiffusionUNet
from pointreggpt_tpu_torch.models.bake import bake_inference
from pointreggpt_tpu_torch.ops import attention
from portbench.lib import adm_weights, adm_work, weights
from portbench.reference import adm as R
from portbench.reference.precision import rounding

H = 32
SMALL = C.ADMConfig(num_channels=32, channel_mult=(1, 2, 2),
                    attention_resolutions=(16, 8), num_head_channels=16,
                    use_fp16=False)
REF_KW = dict(channel_mult=(1, 2, 2), num_res_blocks=2, num_head_channels=16)
SEEDS = (3, 2 ** 31 + 11, 7919)
# bf16 against the fp32 reference, max |d| / max |ref|: measured 0.024 -
# 0.037 over SEEDS (bf16 operands, 2^-8 relative, through 21 ResBlocks and 11
# attention blocks of peaked softmaxes); fp8 operands read 0.30 - 0.41
BF16_LIMIT = 0.08


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _net(cfg=SMALL, seed=3):
    net = C.build_adm_unet(cfg, H)
    sd = adm_weights.seeded(weights.layout_of(net), seed, "cpu",
                            cfg.num_head_channels)
    net.load_state_dict(sd)
    return net.eval(), sd


def _inputs(seed=0, b=2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, 1, H, H, generator=g),
            torch.tensor([17.0, 903.0][:b]))


def _gap(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("seed", SEEDS)
def test_fp32_forward_matches_the_reference(seed):
    """max |d| / max |ref| <= 1e-5: the same fp32 products, summed in
    another order (measured 1.0-1.3e-6)."""
    net, sd = _net(seed=seed)
    x, t = _inputs(seed)
    with torch.no_grad():
        got = net(x, t)
        ref = R.adm_unet(sd, x, t, **REF_KW)
    assert got.shape == (2, 2, H, H) and got.dtype == torch.float32
    assert _gap(got, ref) <= 1e-5


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_forward_within_its_limit_and_fp8_beyond(seed):
    net, sd = _net(dataclasses.replace(SMALL, use_fp16=True), seed)
    x, t = _inputs(seed)
    with torch.no_grad():
        got = bake_inference(net, torch.bfloat16)(x, t)
        ref = R.adm_unet(sd, x, t, **REF_KW)
        fp8 = R.adm_unet(sd, x, t, rnd=rounding("fp8"), **REF_KW)
    assert _gap(got, ref) <= BF16_LIMIT
    assert _gap(fp8, ref) > BF16_LIMIT


@pytest.mark.parametrize("cfg,image", [
    (SMALL, H), (C.ADMConfig(), 256), (C.ADMConfig(in_channels=3), 256)])
def test_state_dict_is_guided_diffusions_layout(cfg, image):
    with torch.device("meta"):
        net = C.build_adm_unet(cfg, image)
    want = R.layout(cfg.in_channels, cfg.num_channels,
                    2 * cfg.in_channels, cfg.num_res_blocks,
                    [image // r for r in cfg.attention_resolutions],
                    cfg.channel_mult, cfg.num_head_channels)
    assert weights.layout_of(net) == want
    if image == 256:  # 256x256_diffusion_uncond at 3 channels: 552.81 M
        n = sum(math.prod(s) for s in want.values())
        assert n == (552_814_086 if cfg.in_channels == 3 else 552_800_258)
        blocks = sum(isinstance(m, type(net.middle_block[1]))
                     for m in net.modules())
        assert blocks == 16


def test_a_reference_state_dict_loads_and_gives_the_same_output():
    layout = R.layout(1, 32, 2, 2, (2, 4), (1, 2, 2), 16)
    g = torch.Generator().manual_seed(5)
    sd = {k: torch.randn(s, generator=g) / math.sqrt(math.prod(s[1:]) or 1)
          for k, s in layout.items()}
    net = C.build_adm_unet(SMALL, H)
    net.load_state_dict(sd, strict=True)
    x, t = _inputs(1)
    with torch.no_grad():
        assert _gap(net(x, t), R.adm_unet(sd, x, t, **REF_KW)) <= 1e-5


def test_the_attention_matters_under_the_benchmarks_draw():
    """Each attention block's output taken out (``proj_out`` zero) moves
    the reference's output by more than 1% of its largest value, and so
    does the last one alone."""
    _, sd = _net(seed=11)
    x, t = _inputs(11)
    attn = sorted({k.rsplit(".proj_out", 1)[0] for k in sd
                   if ".proj_out." in k})
    assert len(attn) == 11
    with torch.no_grad():
        ref = R.adm_unet(sd, x, t, **REF_KW)
        for drop in (attn, attn[-1:]):
            cut = {k: torch.zeros_like(v) if k.rsplit(".proj_out", 1)[0]
                   in drop else v for k, v in sd.items()}
            assert _gap(R.adm_unet(cut, x, t, **REF_KW), ref) > 0.01


def test_learned_variance_chain_reads_the_noise_half():
    """A 3-step DDIM + DDNM chain (eta 1, linear betas, pred_noise) with
    the 2-channel net equals the same chain with a net that returns only
    its first channel."""
    net, _ = _net()

    class NoiseHalf(torch.nn.Module):
        def forward(self, x, t, cond=None):
            return net(x, t, cond)[:, :1]

    diff = C.build_diffusion(C.DiffusionConfig(
        image_size=H, timesteps=1000, sampling_timesteps=3,
        objective="pred_noise", beta_schedule="linear",
        ddim_sampling_eta=1.0), net)
    g = torch.Generator().manual_seed(2)
    cond = torch.rand(2, H, H, 2, generator=g) * 2 - 1
    x_init = torch.randn(2, H, H, 1, generator=g)
    noise = {t: torch.randn(2, H, H, 1, generator=g) for t in range(1000)}
    outs = [diff.ddim_sample(m, torch.zeros(2, 4), cond, (2, H, H, 1),
                             x_init=x_init, noise=noise.__getitem__)
            for m in (net, NoiseHalf())]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], diff.ddim_sample(
        lambda x, t, c: net(x, t, c)[:, 1:], torch.zeros(2, 4), cond,
        (2, H, H, 1), x_init=x_init, noise=noise.__getitem__))


def test_training_refuses_a_learned_variance_net():
    """The ADM builds a diffusion for sampling, and its training loss
    refuses it (L_hybrid is not ported); a learned-variance DiffusionUNet
    is still refused at build, as the JAX package refuses it."""
    net, _ = _net()
    cfg = C.DiffusionConfig(image_size=H, objective="pred_noise",
                            beta_schedule="linear")
    with pytest.raises(ValueError, match="learned_variance=True doubles"):
        C.build_diffusion(cfg, C.build_diffusion_unet(C.ModelConfig(
            dim=8, learned_variance=True)))
    diff = C.build_diffusion(cfg, net)
    with pytest.raises(ValueError, match="L_hybrid"):
        diff.training_loss(net, torch.rand(1, H, H, 1),
                           torch.eye(3)[None])
    with pytest.raises(ValueError, match="L_hybrid"):
        diff.p_losses(net, torch.rand(1, H, H, 1),
                      torch.zeros(1, dtype=torch.long), torch.zeros(1, 4))


def test_bake_casts_the_adm_and_keeps_the_unets_raise():
    net, _ = _net(dataclasses.replace(SMALL, use_fp16=True))
    baked = bake_inference(net, torch.bfloat16)
    cast = {f"{n}.weight" for n, m in net.named_modules()
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d,
                              torch.nn.Linear)) and n != "out.2"}
    # the first conv and time_embed's two linears, 21 ResBlocks' two
    # convs and a linear, 10 skip convs, 11 attention blocks' two 1x1s
    assert len(cast) == 3 + 21 * 3 + 10 + 11 * 2
    for name, p in baked.named_parameters():  # biases and norms stay fp32
        want = torch.bfloat16 if name in cast else torch.float32
        assert p.dtype == want, name
    x, t = _inputs(4)
    with torch.no_grad():  # the per-forward cast gives the baked weights
        assert torch.equal(baked(x, t), net(x, t))
    with pytest.raises(ValueError, match="standardized no WSConv"):
        bake_inference(torch.nn.Sequential(torch.nn.Linear(2, 2)),
                       torch.bfloat16)
    unet = DiffusionUNet(dim=8, dim_mults=(1, 2))
    assert bake_inference(unet, torch.bfloat16) is not unet


def test_attention_rows_count_copies():
    x = torch.randn(2, 8, 4, 4)
    before = attention.ROUTES["attn_copies"]
    rows = attention.rows(x.contiguous(memory_format=torch.channels_last))
    assert attention.ROUTES["attn_copies"] == before
    assert rows.shape == (2, 16, 8)
    assert torch.equal(attention.rows(x), rows)
    assert attention.ROUTES["attn_copies"] == before + 1


def test_legacy_head_strides_match_packed_ones():
    """K2's plain version on q, k, v with heads 3 d apart (ADM's legacy
    order) gives what it gives on the same values packed heads d apart."""
    a = attention.check_inputs(2, 20, 3, 64, torch.float32, "cpu", seed=4)
    b = attention.check_inputs(2, 20, 3, 64, torch.float32, "cpu", seed=4,
                               legacy=True)
    assert b[0].stride()[2] == 3 * 64 and a[0].stride()[2] == 64
    assert torch.equal(attention.multihead_attention(*a, scale=0.125),
                       attention.multihead_attention(*b, scale=0.125))


def test_work_counts_what_the_flop_counter_counts():
    """``lib/adm_work.py`` against ``torch.utils.flop_counter`` on the
    reference's forward, and K2's calls against the net's blocks."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = {"num_channels": 32, "channel_mult": [1, 2, 2],
           "num_res_blocks": 2, "attention_resolutions": [16, 8],
           "num_head_channels": 16, "in_channels": 1, "out_channels": 2,
           "compute_dtype": "bf16"}
    _, sd = _net()
    x, t = _inputs(0, b=1)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        R.adm_unet(sd, x, t, **REF_KW)
    want = adm_work.forward_flops(cfg, 1, H)
    assert want["bf16"] + want["fp32"] == fc.get_total_flops()
    assert want["fp32"] == 2 * H * H * 32 * 2 * 9
    calls = adm_work.k2_calls(cfg, H)
    assert len(calls) == 11
    assert sorted(set(calls)) == [(64, 4, 16), (256, 4, 16)]


def test_generate_dataset_runs_the_adm_on_the_cpu(tmp_path, monkeypatch,
                                                   capsys):
    """``generate_dataset --denoiser adm`` through ``Generator.generate``:
    files written, the dispatch spans tagged ``adm``, the route counters
    on the summary's line (no K2 launch and no copy on the CPU)."""
    from pointreggpt_tpu_torch.cli import generate_dataset
    from pointreggpt_tpu_torch.models import MaskUNet
    from pointreggpt_tpu_torch.utils import profiling
    from portbench.lib import traffic

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    monkeypatch.setenv("PRGPT_PROFILE", str(tmp_path / "prof"))
    monkeypatch.setattr(profiling, "_env_on", True)
    rgbd, indoor, info = traffic.scene_pool(tmp_path, 2, 48, 64, 0)
    net, sd = _net()
    traffic.save_diffusion_checkpoint(tmp_path / "results" / "model-1.pt",
                                      sd)
    mask = MaskUNet(dim=8, dim_mults=(1, 2))
    with torch.no_grad():
        mask.final_conv[0].bias.fill_(12.0)
    traffic.save_mask_checkpoint(
        tmp_path / "depth_correction_results" / "model-best.pt",
        mask.state_dict())
    mark = max((s.id for s in profiling.spans()), default=-1)
    generate_dataset.main([
        "--denoiser", "adm", "--resume", "1", "--data", str(rgbd),
        "--train_info_path", str(tmp_path / "train_info.pkl"),
        "--data_root", str(indoor), "--results_folder",
        str(tmp_path / "results"), "-start", "0", "-stop", "2",
        "--batch_size", "2", "--image_size", str(H),
        "--sampling_timesteps", "2", "--memory_capacity", "4096",
        "--adm_num_channels", "32", "--adm_channel_mult", "1,2,2",
        "--adm_attention_resolutions", "16,8",
        "--adm_num_head_channels", "16", "--adm_use_fp16", "false",
        "--dc_dim", "8", "--dc_dim_mults", "1,2"])
    out = tmp_path / "generated_dataset" / "data"
    for s in range(2):
        assert (out / f"scene-{s:06d}" / "sample-000001.cloud.ply").is_file()
        depth = np.asarray(__import__("PIL.Image").Image.open(
            out / f"scene-{s:06d}" / "sample-000001.depth.png"))
        assert depth.shape == (H, H)
    printed = capsys.readouterr().out
    assert "attn_k2_d32 0, attn_k2_d64 0, attn_copies 0" in printed
    dispatch = [s for s in profiling.spans()
                if s.id > mark and s.name == "dispatch"]
    assert dispatch and all(s.attrs["denoiser"] == "adm" for s in dispatch)
    assert all(s.attrs["attn_copies"] == 0 for s in dispatch)


def test_generate_dataset_takes_the_adms_diffusion_defaults():
    from pointreggpt_tpu_torch.cli import generate_dataset

    adm = generate_dataset.parse_args(["--resume", "1", "--denoiser", "adm"])
    unet = generate_dataset.parse_args(["--resume", "1"])
    assert (adm.beta_schedule, adm.objective) == ("linear", "pred_noise")
    assert (unet.beta_schedule, unet.objective) == ("sigmoid", "pred_x0")
    assert adm.adm_attention_resolutions == (32, 16, 8)
    with torch.device("meta"):
        net = C.build_adm_unet(C.from_args(adm, C.ADMConfig, "adm_"), 256)
    assert isinstance(net, ADMUNet) and net.learned_variance


# the two cells this configuration brought, at a size the CPU holds: the
# ADM's published flags cut in width and depth here only
TINY_MASK = {"net": "MaskUNet", "dim": 8, "dim_mults": [1, 2],
             "resnet_block_groups": 4, "compute_dtype": "fp32",
             "ws_eps": 1e-5, "image_size": 32, "mask_out_bias": 6.0,
             "control": "tf32"}
TINY_TRAFFIC = {"batch": 2, "scene_pool": 3, "frame_height": 48,
                "frame_width": 64, "memory_capacity": 4096,
                "reference_rows": 2}
CELLS = {
    "gen.adm256_uncond.b8": {
        "config": {"num_channels": 32, "channel_mult": [1, 2],
                   "attention_resolutions": [16], "num_head_channels": 16,
                   "image_size": 32, "sampling_timesteps": 4,
                   "mask_net": TINY_MASK},
        "traffic": TINY_TRAFFIC},
    "gen.ddnm_unet64.b4": {
        "config": {"dim": 8, "dim_mults": [1, 2], "resnet_block_groups": 4,
                   "image_size": 32, "sampling_timesteps": 4,
                   "mask_net": TINY_MASK},
        "traffic": TINY_TRAFFIC}}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_new_cells_run_and_their_control_fails(cell):
    """Each new cell end to end on the CPU (the port's plain paths): every
    check within its limit, the per-layer metrics that read the CPU's run
    present, and the control (fp8 for the bf16 net) not correct."""
    from portbench.control import readings
    from portbench.run import run_cell

    seed = 2 ** 33 + 5
    r = run_cell(cell, seed, 1, True, device="cpu", overrides=CELLS[cell])
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert {"mfu.gen", "setup_idle_s.gen", "write_idle_s.gen"} <= \
        set(r["metrics"])
    ctrl = readings(cell, seed + 1, 1, device="cpu", overrides=CELLS[cell])
    assert ctrl["port_correct"] and not ctrl["control_correct"]
    assert ctrl["control"]["unet_gap"] > 3 * ctrl["port"]["unet_gap"]
