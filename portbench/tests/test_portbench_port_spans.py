"""The readers of the port's own spans (``lib/port_spans.py`` and the six
``*_idle_*`` metrics): device-idle time inside the port's spans on a made
trace, None wherever there is nothing to read, and each cell's traced CPU
run reporting its two."""

import threading
from types import SimpleNamespace

import pytest
import torch

from portbench.lib import port_spans, spec
from portbench.lib.trace import Activity, Trace
from portbench.run import run_cell
from portbench.tests.tiny import OVERRIDES

SEED = 2 ** 31 + 23
MAIN = threading.main_thread().ident
NEW = {"gen.ddnm_unet64.b8": ("setup_idle_s.gen", "write_idle_s.gen"),
       "train.ddnm_unet64": ("upload_idle_ms.train",
                             "dispatch_idle_ms.train"),
       "mask_train.mask_unet64": ("upload_idle_ms.mask",
                                  "dispatch_idle_ms.mask")}


def _span(name, start, end, thread=MAIN):
    return SimpleNamespace(name=name, start=start, end=end, thread=thread)


def _run(acts, lo=0, hi=1000):
    return SimpleNamespace(trace=Trace([Activity("k", a, b)
                                        for a, b in acts], lo, hi))


def _read(metric, run):
    return spec.Cell.reader(metric).read(run)


# busy [100, 200) and [150, 300) overlap, [500, 600) and [550, 560)
# nest: idle is [0, 100), [300, 500), [600, 1000)
ACTS = [(100, 200), (150, 300), (500, 600), (550, 560)]


def test_idle_inside_spans_on_a_made_trace(monkeypatch):
    monkeypatch.setattr(port_spans, "recorded", lambda: [
        _span("upload", -50, 50),                 # 0-50 of idle [0, 100)
        _span("loader_wait", 40, 120),            # 50-100 more, 40 overlap
        _span("train_step", 120, 700),            # 300-500, 600-700
        _span("forward", 130, 400),               # nested: adds nothing
        _span("train_step", 800, 1200),           # 800-1000, clipped
        _span("upload", 350, 450, thread=MAIN + 1),  # another thread
        _span("train_step", 1100, 1300),          # outside the window
    ])
    run = _run(ACTS)
    assert port_spans.idle_s(run, ("upload",)) == pytest.approx(50e-9)
    assert port_spans.idle_s(run, ("upload", "loader_wait")) == \
        pytest.approx(100e-9)
    assert port_spans.idle_s(run, ("train_step", "forward")) == \
        pytest.approx(500e-9)
    # per step: the two train_step spans that start in the window
    assert _read("upload_idle_ms.train", run) == pytest.approx(100e-6 / 2)
    assert _read("dispatch_idle_ms.mask", run) == pytest.approx(500e-6 / 2)


def test_generation_readers_on_a_made_trace(monkeypatch):
    monkeypatch.setattr(port_spans, "recorded", lambda: [
        _span("scene_setup", 0, 90), _span("chunk_upload", 90, 110),
        _span("dispatch", 110, 480), _span("host_write", 480, 1000),
        _span("encode", 600, 700)])
    run = _run(ACTS)
    assert _read("setup_idle_s.gen", run) == pytest.approx(100e-9)
    assert _read("write_idle_s.gen", run) == pytest.approx(420e-9)


@pytest.mark.parametrize("metric", sorted(m for ms in NEW.values()
                                          for m in ms))
def test_readers_read_none_where_there_is_nothing(metric, monkeypatch):
    from pointreggpt_tpu_torch.utils import profiling

    assert _read(metric, SimpleNamespace(trace=None)) is None
    run = _run(ACTS)
    monkeypatch.setattr(port_spans, "recorded", lambda: [])
    assert _read(metric, run) is None
    monkeypatch.setattr(port_spans, "recorded", lambda: [
        _span("other", 0, 1000)])
    assert _read(metric, run) is None
    monkeypatch.undo()
    # a port with no recorder, as before its spans
    monkeypatch.delattr(profiling, "spans")
    assert port_spans.recorded() is None
    assert _read(metric, run) is None


def test_overlap_of_unions():
    xs = [(0, 10), (5, 20), (30, 40)]
    ys = [(15, 35), (18, 19), (38, 50)]
    assert port_spans.overlap_ns(xs, ys) == 5 + 5 + 2
    assert port_spans.overlap_ns([], ys) == 0


@pytest.fixture
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_cpu_run_reports_the_port_span_metrics(cell, _few_threads):
    r = run_cell(cell, SEED, 1, True, device="cpu",
                 overrides=OVERRIDES[cell])
    for name in NEW[cell]:
        got = r["metrics"][name]
        assert got["value"] > 0, (name, got)
    # no card: the whole window is idle, so the spans' idle is their time
    assert r["device"]["window_s"] > 0
