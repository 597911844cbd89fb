"""Each cell end to end on the CPU at a size a test holds (the look for a
card skipped; the port's plain paths run): the result line's shape, the
port against the plain reference, the control, and ``correct`` coming out
false with the timed path broken underneath, once for each fault the cell
can have: its state left unchanged; half of the batch left out, the mean
taken over the rest; an answer altered where it is produced (a written
depth pixel; in training, one leaf's change doubled); in the trainers
also the EMA left unchanged and the learning rate left at its start. One
chip, so no exchange to leave out."""

import math

import pytest
import torch

from portbench.control import readings
from portbench.run import run_cell
from portbench.tests.tiny import OVERRIDES, TINY_LIMITS

CELLS = sorted(OVERRIDES)
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _run(cell, trace=False):
    return run_cell(cell, SEED, 1, trace, device="cpu",
                    overrides=OVERRIDES[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_holds_the_reference(cell):
    r = _run(cell, trace=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "breakdown", "checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["device"]["window_s"] > 0
    assert set(r["checks"]) == set(TINY_LIMITS[cell])
    for name, c in r["checks"].items():
        assert math.isfinite(c["value"]), name
        assert c["value"] <= TINY_LIMITS[cell][name], (name, c)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_above_the_port(cell):
    out = readings(cell, SEED + 1, 1, device="cpu",
                   overrides=OVERRIDES[cell])
    port, ctrl = out["port"], out["control"]
    assert max(ctrl[k] / max(port[k], 1e-30) for k in ctrl) > 3


def _patch_generation(fault, monkeypatch):
    from pointreggpt_tpu_torch.core import imageio16, pointops
    from pointreggpt_tpu_torch.models.unet import DiffusionUNet

    if fault == "state_unchanged":
        real = pointops.memory_voxel_update

        def unchanged(mem_pts, mem_valid, *a, **kw):
            out, ok, over = real(mem_pts, mem_valid, *a, **kw)
            return (torch.zeros_like(out), torch.zeros_like(ok), over)
        monkeypatch.setattr(pointops, "memory_voxel_update", unchanged)
    elif fault == "half_batch":
        real = DiffusionUNet.forward

        def half(self, x, t, c):
            h = x.shape[0] // 2
            out = real(self, x[:h], t[:h], c[:h])
            return torch.cat([out, out], dim=0)
        monkeypatch.setattr(DiffusionUNet, "forward", half)
    else:
        real = imageio16.write_depth_png

        def altered(path, depth01):
            depth01 = depth01.copy()
            depth01[0, 0] += 0.01
            real(path, depth01)
        monkeypatch.setattr(imageio16, "write_depth_png", altered)


def _patch_training(cell, fault, monkeypatch):
    from pointreggpt_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from pointreggpt_tpu_torch.parallel.mesh import Rows
    from pointreggpt_tpu_torch.train.mask_trainer import MaskTrainer

    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif fault == "half_batch" and cell.startswith("train"):
        real = GaussianDiffusion.training_loss

        def half(self, model, img01, intrinsic, generator=None, rows=None):
            h = img01.shape[0] // 2
            return real(self, model, img01[:h], intrinsic[:h], generator,
                        rows=Rows(0, h, h))
        monkeypatch.setattr(GaussianDiffusion, "training_loss", half)
    elif fault == "half_batch":
        real = MaskTrainer.train_step

        def half(self, x, m):
            h = x.shape[0] // 2
            return real(self, x[:h], m[:h])
        monkeypatch.setattr(MaskTrainer, "train_step", half)
    else:
        real = torch.optim.Adam.step

        def doubled(self, closure=None):
            p = max((p for g in self.param_groups for p in g["params"]),
                    key=lambda p: p.numel())
            before = p.detach().clone()
            out = real(self, closure)
            with torch.no_grad():
                p.add_(p - before)
            return out
        monkeypatch.setattr(torch.optim.Adam, "step", doubled)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    if cell.startswith("gen"):
        _patch_generation(fault, monkeypatch)
    else:
        _patch_training(cell, fault, monkeypatch)
    r = _run(cell)
    assert r["correct"] is False, r["checks"]


def test_an_ema_left_unchanged_is_not_correct(monkeypatch):
    from pointreggpt_tpu_torch.train.ema import EMA

    def counts_only(self):
        self._step += 1
        self.step.fill_(self._step)
    monkeypatch.setattr(EMA, "update", counts_only)
    r = _run("train.ddnm_unet64")
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["ema_gap"]["value"] > 0.5


def test_a_learning_rate_left_at_its_start_is_not_correct(monkeypatch):
    from pointreggpt_tpu_torch.train.mask_trainer import MaskTrainer

    monkeypatch.setattr(MaskTrainer, "lr_at",
                        lambda self, count: self.train_lr)
    r = _run("mask_train.mask_unet64")
    assert r["correct"] is False, r["checks"]
