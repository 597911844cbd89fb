"""PyTorch port, ``PRGPT_PROFILE`` on the CPU: the StageTimer's text
against the JAX package's, the step capture's window, and the stage names
and trace files of a profiled Trainer run and ``Generator.generate`` run.
"""

import gc
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from pointreggpt_tpu_torch.models.blocks import Conv2d
from pointreggpt_tpu_torch.parallel import mesh as M
from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR
from pointreggpt_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traces(folder: Path):
    return sorted(Path(folder).rglob("*.pt.trace.json"))


@pytest.mark.parametrize("totals", [
    {"dispatch": (0.0123, 4), "load_batch": (1.5, 3), "loss_sync": (0, 0)},
    {"host_write": (12.3456789, 250)},
    {},
])
def test_stage_timer_summary_is_the_jax_text(totals):
    from pointreggpt_tpu.utils import profiling as jprof

    ours, theirs = profiling.StageTimer(), jprof.StageTimer()
    for timer in (ours, theirs):
        for name, (t, c) in totals.items():
            timer._total[name] = t
            timer._count[name] = c
    assert ours.summary() == theirs.summary()
    assert ours.totals() == theirs.totals()


def test_stage_timer_times_its_stages():
    timer = profiling.StageTimer()
    for _ in range(2):
        with timer.stage("sleep"):
            time.sleep(0.01)
    assert timer.totals()["sleep"] >= 0.02
    assert "sleep: " in timer.summary() and "/ 2 calls" in timer.summary()
    timer.reset()
    assert timer.summary() == ""


def test_step_capture_opens_at_start_and_closes_at_stop(tmp_path):
    capture = profiling.StepTraceCapture(str(tmp_path / "a"), start=1,
                                         stop=3)
    seen = []
    for _ in range(4):
        torch.ones(4).sum()
        capture.tick()
        seen.append(capture.tracing)
    # opened after the tick of step 1, closed by the tick that reaches 3
    assert seen == [False, True, False, False]
    assert len(_traces(tmp_path / "a")) == 1


def test_step_capture_closes_on_close(tmp_path):
    capture = profiling.StepTraceCapture(str(tmp_path / "b"), start=0,
                                         stop=10)
    capture.tick()
    assert capture.tracing
    capture.close()
    capture.close()  # idempotent
    assert not capture.tracing
    assert len(_traces(tmp_path / "b")) == 1


def test_trace_yields_the_profiler(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("block"):
            torch.ones(8).cumsum(0)
    names = {e.key for e in prof.key_averages()}
    assert "block" in names
    assert len(_traces(tmp_path)) == 1


def test_profile_dir_is_per_rank_under_torchrun(monkeypatch, tmp_path):
    monkeypatch.delenv("PRGPT_PROFILE", raising=False)
    assert profiling.profile_dir() is None
    assert profiling.loop_profile(1, 3) is None
    monkeypatch.setenv("PRGPT_PROFILE", str(tmp_path))
    assert profiling.profile_dir() == str(tmp_path)
    monkeypatch.setattr(M, "process_count", lambda: 2)
    monkeypatch.setattr(M, "process_index", lambda: 1)
    assert profiling.profile_dir() == str(tmp_path / "rank-1")


def _stage_names(text: str):
    head = text.split("profile stages (trace in ", 1)[1]
    return {line.split(":")[0] for line in head.splitlines()[1:]
            if " calls (" in line}


def test_trainer_run_prints_the_jax_stages_and_a_trace(tmp_path, monkeypatch,
                                                      capsys):
    folder, gt_log = DR.write_depth_tree(tmp_path, n_frames=4)
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    monkeypatch.setenv("PRGPT_PROFILE", str(tmp_path / "prof"))
    tr = DR.build_trainer(folder, gt_log, str(tmp_path / "r"),
                          full_width=False, global_batch=2, steps=6)
    tr.save_and_sample_every = 6
    tr.sample_on_save = False
    tr.train(log_every=1)
    out = capsys.readouterr().out
    # steps 3-4 are traced and left out of the timing
    assert _stage_names(out) == {"load_batch", "dispatch", "loss_sync",
                                 "save_and_sample"}
    assert "/ 4 calls" in out.split("dispatch: ", 1)[1].splitlines()[0]
    assert len(_traces(tmp_path / "prof")) == 1


def test_generator_run_prints_the_jax_stages_and_a_trace(tmp_path,
                                                        monkeypatch, capsys):
    from test_torch_port_parallel import _save_mask, write_generation_tree

    from pointreggpt_tpu_torch.cli import generate_dataset

    flags, mask = write_generation_tree(tmp_path, n_scenes=2)
    _save_mask(tmp_path, mask)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    monkeypatch.setenv("PRGPT_PROFILE", str(tmp_path / "prof"))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    generate_dataset.main(flags[:flags.index("--num_samples")] + [
        "--num_samples", "3"] + flags[flags.index("--num_samples") + 2:] +
        ["-start", "0", "-stop", "2"])
    out = capsys.readouterr().out
    assert _stage_names(out) == {"scene_setup", "dispatch", "host_write"}
    # sample step 3 is traced: 2 dispatches timed
    assert "/ 2 calls" in out.split("dispatch: ", 1)[1].splitlines()[0]
    assert len(_traces(tmp_path / "prof")) == 1


# -- the port's spans ---------------------------------------------------------


@pytest.fixture
def spans_on(monkeypatch):
    """Spans recorded as under ``PRGPT_PROFILE``, without a loop."""
    monkeypatch.setattr(profiling, "_env_on", True)


def _since(mark: int):
    return [s for s in profiling.spans() if s.id > mark]


def _mark() -> int:
    return max((s.id for s in profiling.spans()), default=0)


def test_span_off_records_nothing_reads_no_clock_opens_no_range(
        monkeypatch):
    monkeypatch.delenv("PRGPT_PROFILE", raising=False)
    assert profiling.profile_dir() is None and not profiling.tracing()

    def boom(*a, **k):
        raise AssertionError("read or opened while tracing is off")

    mark, before = _mark(), profiling.totals()
    monkeypatch.setattr(profiling, "time", SimpleNamespace(time_ns=boom))
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        boom)
    monkeypatch.setattr(profiling, "Span", boom)
    first = profiling.span("train_step", 3, alloc=torch.device("cpu"))
    with first, profiling.span("forward", micro=0) as inner:
        torch.ones(4).sum()
    assert inner is first  # the one shared no-op
    monkeypatch.undo()
    assert _since(mark) == [] and profiling.totals() == before


def test_span_shares_the_profilers_clock_and_names_its_range(spans_on):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("block", 7):
            torch.ones(64).cumsum(0)
    mine = [s for s in profiling.spans() if s.name == "block"][-1]
    events = prof.profiler.kineto_results.events()
    ranges = [e for e in events if e.name() == "prgpt.block"]
    assert len(ranges) == 1 and ranges[0].is_user_annotation()
    aten = [e for e in events if e.name() == "aten::cumsum"]
    assert aten
    for e in aten + ranges:
        assert mine.start <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= mine.end
    assert mine.thread == threading.main_thread().ident
    assert mine.req == 7 and mine.parent is None


def test_ring_is_bounded_and_totals_count_every_span(spans_on, monkeypatch):
    """Threads record 2.5 rings of spans while the collector runs often
    (a collection can start inside the recorder's critical section and
    record its own span there): the ring holds the newest ``RING``, the
    totals count every one. A recorder that deadlocks fails the test
    within a minute instead of hanging it."""
    per, workers = profiling.RING * 5 // 8, 4
    before = {k: profiling.totals().get(k, (0.0, 0))[1]
              for k in ("stress", "gc")}
    threshold = gc.get_threshold()
    interval = sys.getswitchinterval()

    def work():
        for i in range(per):
            with profiling.span("stress", i):
                [object() for _ in range(3)]

    gc.set_threshold(20)
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, daemon=True)
                   for _ in range(workers)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        gc.set_threshold(*threshold)
        sys.setswitchinterval(interval)
        # this thread's own collections stop recording before the check
        monkeypatch.setattr(profiling, "_env_on", False)
    assert not any(t.is_alive() for t in threads)
    assert len(profiling.spans()) == profiling.RING
    assert profiling.totals()["stress"][1] - before["stress"] == \
        per * workers
    assert profiling.totals()["gc"][1] > before["gc"]


def test_a_collection_is_a_gc_span(spans_on):
    mark = _mark()
    with profiling.span("outer", 5):
        gc.collect()
    got = _since(mark)
    outer = next(s for s in got if s.name == "outer")
    pauses = [s for s in got if s.name == "gc" and s.parent == outer.id]
    assert pauses and pauses[-1].attrs["generation"] == 2
    assert "collected" in pauses[-1].attrs and pauses[-1].req == 5


def _tree(got):
    by_id = {s.id: s for s in got}
    return by_id, lambda s: by_id.get(s.parent)


def test_generate_records_the_chunk_span_tree(tmp_path, monkeypatch,
                                              capsys):
    from test_torch_port_parallel import _save_mask, write_generation_tree

    from pointreggpt_tpu_torch.cli import generate_dataset

    flags, mask = write_generation_tree(tmp_path, n_scenes=2)
    _save_mask(tmp_path, mask)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    monkeypatch.setenv("PRGPT_PROFILE", str(tmp_path / "prof"))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    mark = _mark()
    generate_dataset.main(flags[:flags.index("--num_samples")] + [
        "--num_samples", "2"] + flags[flags.index("--num_samples") + 2:] +
        ["-start", "0", "-stop", "2"])
    out = capsys.readouterr().out
    assert "\ngc pauses: " in out and "\nallocator: num_device_alloc 0" in out
    # the CPU routes no conv to K5
    assert "\ncounters: conv_k5 0, conv_library " in out
    got = [s for s in _since(mark) if s.name != "gc"]
    _, parent = _tree(got)
    top = [s.name for s in got if s.parent is None]
    assert top == ["scene_setup", "chunk_upload", "dispatch", "dispatch",
                   "host_write", "host_write"]
    assert {s.req for s in got} == {0}  # the chunk's first scene
    want = {"scene_dir": "scene_setup", "frame_read": "scene_setup",
            "seed_outputs": "scene_setup", "step": "dispatch",
            "to_host": "dispatch", "encode": "host_write",
            "fragment": "host_write"}
    for s in got:
        if s.parent is not None:
            assert parent(s).name == want[s.name], s
    counts = {n: sum(s.name == n for s in got) for n in want}
    # two scenes, two samples; the fragment at the last sample
    assert counts == {"scene_dir": 2, "frame_read": 2, "seed_outputs": 2,
                      "step": 2, "to_host": 2, "encode": 4,
                      "fragment": 2}
    assert [s.attrs["sample"] for s in got if s.name == "host_write"] == \
        [0, 1]


def test_trainer_step_records_each_microbatch_under_the_step(
        tmp_path, monkeypatch, spans_on):
    folder, gt_log = DR.write_depth_tree(tmp_path, n_frames=4)
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    tr = DR.build_trainer(folder, gt_log, str(tmp_path / "r"),
                          full_width=False, global_batch=1,
                          gradient_accumulate_every=2)
    tr.step = 41
    mark = _mark()
    img, intrinsic = tr._upload(next(tr.dl))
    tr.train_step(img, intrinsic, torch.Generator().manual_seed(0))
    got = [s for s in _since(mark) if s.name != "gc"]
    main = threading.main_thread().ident
    mine = [s for s in got if s.thread == main]
    _, parent = _tree(mine)
    step = next(s for s in mine if s.name == "train_step")
    assert [s.name for s in mine if s.parent is None] == [
        "loader_wait", "upload", "train_step"]
    kids = [(s.name, s.attrs.get("micro")) for s in mine
            if s.parent == step.id]
    assert kids == [("forward", 0), ("backward", 0), ("forward", 1),
                    ("backward", 1), ("all_reduce", None), ("clip", None),
                    ("adam", None), ("ema", None)]
    assert all(s.req == 41 for s in mine if s.name != "loader_wait")
    assert all(parent(s) is step for s in mine
               if s.parent is not None)
    # on the CPU no allocator counts; the conv route's counts
    assert not set(profiling.ALLOC_COUNTS) & set(step.attrs)
    assert step.attrs["conv_k5"] == step.attrs["conv_copies"] == 0
    assert step.attrs["conv_library"] > 0
    loader = {s.name for s in got if s.thread != main}
    assert {"loader_decode", "loader_collate"} <= loader


def test_mask_trainer_step_records_its_span_tree(tmp_path, monkeypatch,
                                                 spans_on):
    from test_torch_port_mask import write_pairs

    from pointreggpt_tpu_torch.models import MaskUNet
    from pointreggpt_tpu_torch.train import mask_trainer as MT

    folder = write_pairs(tmp_path / "dc", n_train=4, n_val=2)
    torch.manual_seed(0)
    tr = MT.MaskTrainer(MaskUNet(dim=8, dim_mults=(1, 2),
                                 resnet_block_groups=4),
                        folder, image_size=32, train_batch_size=2,
                        results_folder=str(tmp_path / "r"),
                        samples_folder=str(tmp_path / "r"), num_workers=1,
                        device="cpu")
    tr.count = 12
    mark = _mark()
    x, m = MT._to_device(next(iter(tr._loader(0))), ("input_img", "mask"),
                         tr.device, step=tr.count)
    tr.train_step(x, m)
    main = threading.main_thread().ident
    mine = [s for s in _since(mark) if s.thread == main and s.name != "gc"]
    step = next(s for s in mine if s.name == "train_step")
    assert [s.name for s in mine if s.parent is None] == [
        "loader_wait", "upload", "train_step"]
    assert [s.name for s in mine if s.parent == step.id] == [
        "forward", "backward", "all_reduce", "clip", "adam"]
    assert {s.req for s in mine if s.name != "loader_wait"} == {12}
    # every conv of the net's forward left to F.conv2d on the CPU
    n_conv = sum(isinstance(mod, Conv2d) for mod in tr.model.modules())
    assert (step.attrs["conv_k5"], step.attrs["conv_library"],
            step.attrs["conv_copies"]) == (0, n_conv, 0)
