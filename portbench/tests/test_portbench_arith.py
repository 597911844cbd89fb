"""The yardstick's arithmetic on made-up numbers: the idle union, the
kernel table, window rates, MFU and rooflines, the frozen work copies, and
the FLOP count from shapes against ``torch.utils.flop_counter`` on the
plain reference."""

from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.lib import flops, readers, spec, trace, work
from portbench.reference import unet as runet
from portbench.reference.precision import rounding


def test_union_and_gaps():
    iv = [(10, 20), (15, 30), (40, 50), (5, 8)]
    assert trace.union(iv, 0, 60) == 3 + 20 + 10
    assert trace.union(iv, 12, 45) == 18 + 5
    assert trace.gaps(iv, 0, 60) == [(0, 5), (8, 10), (30, 40), (50, 60)]
    assert trace.gaps([], 0, 7) == [(0, 7)]


@pytest.mark.parametrize("name,main,want", [
    ("void kv_partials_tc<64>(...)", True, "k1"),
    ("void kv_partials_tc<64>(...)", False, "k3"),
    ("emit_out_tc", False, "k1"),
    ("q_path_bwd_tc", True, "k3"),
    ("flash_fwd_tf32x3", True, "k2"),
    ("sm80_xmma_gemm_cf32cf32_f32f32", True, "library"),
    ("void cudnn::winograd::generateWinogradTilesKernel", True, "library"),
    ("void at::native::vectorized_elementwise_kernel<4>", True, "glue"),
    ("void at::native::(anonymous)::RowwiseMomentsCUDAKernel", True, "glue"),
])
def test_kernel_kinds(name, main, want):
    assert trace.kind(name, main) == want


def _trace():
    acts = [trace.Activity("emit_out_tc", 0, 40),
            trace.Activity("elementwise_kernel", 40, 70),
            trace.Activity("cudnn_conv", 100, 130),
            trace.Activity("Memcpy HtoD", 130, 140, is_kernel=False)]
    spans = trace.Spans()
    spans.items = [("step_dispatch", 0, 90), ("host_write", 90, 200)]
    return trace.Trace(acts, 0, 200, spans)


def test_trace_reductions():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(110e-9)
    assert tr.share("glue") == pytest.approx(100 * 30 / 100)
    assert tr.share("library") == pytest.approx(30.0)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["emit_out_tc", pytest.approx(40e-9)]
    assert bd["idle_gaps"][0] == ["host_write", pytest.approx(60e-9)]
    assert bd["idle_gaps"][1] == ["step_dispatch", pytest.approx(30e-9)]
    assert readers.idle_share(tr) == pytest.approx(45.0)


def test_window_rates_and_utilization():
    rec = {"pairs": 32, "calls": 4, "wall_s": 48.0, "steps_per_call": 1,
           "step_s": [10.0, 10.5, 10.2, 10.1],
           "chunk_s": [11.0, 12.0, 11.0, 11.5],
           "flops": {"bf16": 989e12, "fp32": 494.7e12}}
    run = SimpleNamespace(record=rec, trace=None, setup_s=3.0)
    assert spec.Cell.reader("pairs_per_min").read(run) == 40.0
    assert spec.Cell.reader("host_s_per_chunk.gen").read(run) == \
        pytest.approx(1.2)
    assert spec.Cell.reader("sample_step_s.gen").read(run) == \
        pytest.approx(10.15)
    assert spec.Cell.reader("mfu.gen").read(run) == pytest.approx(
        100 * 4 * 2.0 / 48.0)
    assert spec.Cell.reader("glue_share.gen").read(run) is None
    assert spec.Cell.reader("setup_s").read(run) == 3.0
    train = SimpleNamespace(record={"images": 640, "steps": 10,
                                    "wall_s": 8.0, "step_s": [0.7] * 10,
                                    "loader_wait_s": [0.0, 0.002],
                                    "flops_per_step": {"bf16": 989e12}},
                            trace=None)
    assert spec.Cell.reader("train_img_per_s").read(train) == 80.0
    assert spec.Cell.reader("loader_wait_ms.train").read(train) == \
        pytest.approx(1.0)
    assert spec.Cell.reader("mfu.train").read(train) == pytest.approx(125.0)


def test_rooflines_read_nothing_without_their_kernels():
    tr = _trace()
    k1 = lambda a: trace.kind(a.name) == "k1"  # noqa: E731
    assert readers.roofline(tr, k1, 20e-9) == pytest.approx(50.0)
    assert readers.roofline(tr, lambda a: False, 1.0) is None
    assert readers.roofline(None, k1, 1.0) is None


def test_frozen_work_matches_the_port_today():
    from pointreggpt_tpu_torch.ops import attention, conv
    from pointreggpt_tpu_torch.ops import linear_attention as la

    for args in [(8, 65536, 64, 2), (32, 1024, 512, 4)]:
        assert work.linear_attention(*args) == la.work(*args)
        assert work.linear_attention_bwd(*args) == la.work_bwd(*args)
    assert work.linear_attention_core(8, 4096, 2) == la.work_core(8, 4096, 2)
    assert work.attention(8, 1024, 4, 32, 2) == \
        attention.work(8, 1024, 4, 32, 2)
    assert work.conv3x3(8, 64, 64, 128, 128, 4) == \
        conv.work_conv(8, 64, 64, 128, 128, 4)
    assert work.bound_s({"bytes": 3.35e12, "flops": 0}, "bf16") == 1.0


TINY = {"dim": 8, "dim_mults": [1, 2, 4], "resnet_block_groups": 4}


@pytest.mark.parametrize("net", ["DiffusionUNet", "MaskUNet"])
def test_flop_count_matches_flop_counter(net):
    from pointreggpt_tpu_torch import config as C
    from portbench.lib import weights

    cfg = dict(TINY, net=net, compute_dtype="bf16" if net == "DiffusionUNet"
               else "fp32", ws_eps=1e-5)
    b, s = 2, 32
    if net == "DiffusionUNet":
        port = C.build_diffusion_unet(C.ModelConfig(
            dim=8, dim_mults=(1, 2, 4), resnet_block_groups=4))
    else:
        port = C.build_mask_unet(C.MaskModelConfig(
            dim=8, dim_mults=(1, 2, 4), resnet_block_groups=4))
    sd = weights.seeded(weights.layout_of(port), 3, "cpu",
                        mask_out_bias=6.0 if net == "MaskUNet" else None)
    fwd = runet.forward_fn(cfg, rounding("fp32"))
    x = torch.rand(b, 1, s, s)
    with FlopCounterMode(display=False) as fc:
        if net == "DiffusionUNet":
            fwd(sd, x, torch.tensor([3.0, 500.0]), torch.rand(b, 4))
        else:
            fwd(sd, x)
    assert sum(flops.forward_flops(cfg, b, s).values()) == \
        fc.get_total_flops()


def test_published_sizes():
    for net, want in [("DiffusionUNet", 236.3), ("MaskUNet", 237.1)]:
        cfg = {"net": net, "dim": 64, "dim_mults": [1, 2, 4, 8],
               "compute_dtype": "bf16" if net == "DiffusionUNet" else "fp32"}
        got = sum(flops.forward_flops(cfg, 1, 256).values()) / 1e9
        assert got == pytest.approx(want, abs=0.05)


def test_roundings():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -9, 3.0, -0.1])
    t = rounding("tf32")(x)
    assert t[0] == 1.0 and t[1] == 1.0 + 2 ** -9 and t[2] == 3.0
    f = rounding("fp8")(torch.linspace(-1, 1, 1001))
    err = (f - torch.linspace(-1, 1, 1001)).abs().max()
    assert 1e-3 < err < 0.07
    assert torch.equal(rounding("fp32")(x), x)
