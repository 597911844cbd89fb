"""The denoiser's CUDA graph wrapper (``ops/graph.py``) on the CPU: off the
card and under autograd it runs ``.net`` and counts nothing of its own;
its bookkeeping (a signature's eager call, capture and replays, the
counters of launched kernels taken back from the capture and added at
each replay, the copy it returns) held with a stand-in for the capture,
since a CPU has no graphs; and ``Generator.device_models()``'s wrapper.
The card's own graphs are ``tests/test_torch_port_cuda_paths.py``'s."""

import pytest
import torch

from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch.generate import Generator
from pointreggpt_tpu_torch.generate.generator import place_for_inference
from pointreggpt_tpu_torch.models import DiffusionUNet
from pointreggpt_tpu_torch.ops import attention, graph, group_norm, routes
from pointreggpt_tpu_torch.ops import conv as KC
from pointreggpt_tpu_torch.tools import counters

H = 16
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
    torch.manual_seed(0)
    return place_for_inference(DiffusionUNet(dim=8, dim_mults=(1, 2)), CPU)


def inputs(b: int, seed: int = 0) -> tuple:
    """(x, time, param_cond) as the chain passes them: x an NCHW view of a
    (b, h, w, 1) image."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, H, H, 1, generator=g).permute(0, 3, 1, 2)
    return (x, torch.full((b,), 500.0), torch.randn(b, 4, generator=g))


def kernel_counts() -> dict:
    """The counters of launched kernels and routes, without the graph's."""
    return {k: v for k, v in counters().items() if k not in graph.ROUTES}


def moved(before: dict, now: dict) -> dict:
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


class StandInGraphs(graph.GraphedForward):
    """The wrapper with a stand-in for the card's graphs: it takes CPU
    calls where autograd records nothing; its capture runs the net once on
    the buffers, counting as a capture would not (the wrapper takes that
    back); its replay runs the net again into the output's buffer and
    leaves the counters as a replay does, untouched."""

    def _engages(self, args):
        return not torch.is_grad_enabled()

    def _capture(self, static):
        out = self.net(*static)

        def replay():
            before = graph.counts()
            out.copy_(self.net(*static))
            graph.take_back(before)
        return replay, out


def chain(fn, n: int, b: int = 2) -> list:
    """``n`` calls of ``fn`` along a chain: each x moves towards the last
    output, at a time of its own."""
    x, _, cond = inputs(b)
    outs = []
    for k in range(n):
        out = fn(x, torch.full((b,), 900.0 - 150 * k), cond)
        outs.append(out)
        x = (0.8 * x + 0.2 * out).permute(0, 2, 3, 1).contiguous() \
            .permute(0, 3, 1, 2)
    return outs


@pytest.mark.parametrize("mode", ["inference", "autograd"])
def test_off_the_card_the_wrapper_runs_the_net_and_counts_nothing(net, mode):
    """A CPU call, under inference mode or with autograd recording: the
    net's own output (with its graph under autograd), the kernel counters
    moved as by the net's own call, and no graph counter moved."""
    wrapped = graph.GraphedForward(net)
    args = inputs(2)
    ctx = torch.inference_mode() if mode == "inference" else \
        torch.enable_grad()
    with ctx:
        before = kernel_counts()
        want = net(*args)
        by_net = moved(before, kernel_counts())
        routes0 = dict(graph.ROUTES)
        before = kernel_counts()
        got = wrapped(*args)
        assert moved(before, kernel_counts()) == by_net
    assert by_net  # the CPU routes the convs and norms it ran
    assert dict(graph.ROUTES) == routes0
    assert torch.equal(got, want)
    if mode == "autograd":
        assert got.requires_grad
        got.sum().backward()
        assert all(p.grad is not None for p in net.parameters()
                   if p.requires_grad)
        net.zero_grad(set_to_none=True)


def test_a_signature_runs_eagerly_then_captures_then_replays(net):
    """Six chain calls through the stand-in: the first eager, the second
    captured, four replayed; outputs equal to the net's bit for bit; the
    kernel counters moved as by six calls of the net; each call's output
    left as it was by the calls after it. A second batch size runs
    eagerly once and captures once more."""
    wrapped = StandInGraphs(net)
    with torch.inference_mode():
        before = kernel_counts()
        want = chain(net, 6)
        by_net = moved(before, kernel_counts())
        routes0 = dict(graph.ROUTES)
        before = kernel_counts()
        kept = []

        def call(*args):
            out = wrapped(*args)
            kept.append((out, out.clone()))
            return out

        got = chain(call, 6)
        assert moved(before, kernel_counts()) == by_net
        assert moved(routes0, dict(graph.ROUTES)) == {
            "graph_eager": 1, "graph_captures": 1, "graph_replays": 4}
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        for out, copy in kept:
            assert torch.equal(out, copy)
        assert len({o.data_ptr() for o, _ in kept}) == len(kept)
        chain(wrapped, 2, b=3)
    assert moved(routes0, dict(graph.ROUTES)) == {
        "graph_eager": 2, "graph_captures": 2, "graph_replays": 4}


def test_the_capture_increments_are_taken_back_and_added_per_replay():
    """``take_back`` sets the counters back and returns what a forward
    added; ``add`` adds that once a replay."""
    before = graph.counts()
    kernels = kernel_counts()
    x = torch.randn(1, 8, 4, 4)
    group_norm.group_norm_act(x, 2, None, None, 1e-5)
    KC.conv2d(x, torch.randn(8, 8, 3, 3), padding=1)
    attention.multihead_attention.launches += 3  # as a card call would
    gained = graph.take_back(before)
    assert graph.counts() == before
    for _ in range(2):
        graph.add(gained)
    assert moved(kernels, kernel_counts()) == {
        "norm_plain": 2, "conv_library": 2, "k2": 6}
    graph.take_back(before)


def test_a_failed_capture_raises_and_leaves_the_counters(net):
    """A capture that raises reaches the caller, with the kernel counters
    as they were before it and no capture counted."""

    class Failing(StandInGraphs):
        def _capture(self, static):
            self.net(*static)
            raise RuntimeError("capture failed")

    wrapped = Failing(net)
    with torch.inference_mode():
        wrapped(*inputs(2))
        before, routes0 = kernel_counts(), dict(graph.ROUTES)
        with pytest.raises(RuntimeError, match="capture failed"):
            wrapped(*inputs(2))
    assert kernel_counts() == before
    assert dict(graph.ROUTES) == routes0


def test_signature_reads_layout_dtype_and_inference_mode():
    """Batch, strides, dtype, a missing input and the inference mode each
    make another signature; the values and the stride of a dimension of
    size 1 do not."""
    x, t, p = inputs(2)
    with torch.inference_mode():
        key = graph.signature((x, t, p))
        assert graph.signature((x + 1, t * 2, p - 1)) == key
        c1 = torch.empty_strided(x.shape, (H * H, H * H, H, 1))
        assert graph.signature((c1, t, p)) == key
        others = [(inputs(3)), (x.transpose(2, 3), t, p),
                  (x.double(), t, p), (x, t, None)]
        keys = {graph.signature(a) for a in others}
    assert key not in keys and len(keys) == len(others)
    assert graph.signature((x, t, p)) != key


def test_routes_chain_the_graph_counters():
    """``ops/routes.py`` records the three call counters beside the
    routes, and the counters helper reads them."""
    assert set(graph.ROUTES) == {"graph_captures", "graph_replays",
                                 "graph_eager"}
    assert set(graph.ROUTES) <= set(routes.ROUTES)
    graph.ROUTES["graph_eager"] += 1
    try:
        assert routes.ROUTES["graph_eager"] == graph.ROUTES["graph_eager"]
        assert counters()["graph_eager"] == graph.ROUTES["graph_eager"]
    finally:
        graph.ROUTES["graph_eager"] -= 1
    # the conv route still leads the recorded counters
    assert next(iter(routes.ROUTES)) == "conv_k5"


def test_generator_wraps_its_denoiser_alone(tmp_path):
    """``device_models()``: the denoiser in a wrapper whose ``.net`` is the
    baked module, the mask net bare; one pair reused until a load."""
    torch.manual_seed(0)
    model = C.build_diffusion_unet(C.ModelConfig(dim=8, dim_mults=(1, 2)))
    mask = C.build_mask_unet(C.MaskModelConfig(dim=8, dim_mults=(1, 2)))
    gen = Generator(model, C.build_diffusion(C.DiffusionConfig(
        image_size=H, timesteps=16, sampling_timesteps=4)), str(tmp_path),
        samples_folder=str(tmp_path / "out"), depth_correction_model=mask,
        device="cpu")
    ema, dc = gen.device_models()
    assert isinstance(ema, graph.GraphedForward)
    assert isinstance(ema.net, DiffusionUNet) and not ema.net.training
    assert not isinstance(dc, graph.GraphedForward) and not dc.training
    assert gen.device_models() == (ema, dc)
    gen._device_models = None  # as a load leaves it
    assert gen.device_models()[0] is not ema
