"""PyTorch port, ``PRGPT_PROFILE`` on the CPU: the StageTimer's text
against the JAX package's, the step capture's window, and the stage names
and trace files of a profiled Trainer run and ``Generator.generate`` run.
"""

import time
from pathlib import Path

import pytest
import torch

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
