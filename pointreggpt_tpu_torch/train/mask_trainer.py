"""Depth-correction trainer (one GPU, or one process per GPU) and tester
(MaskUNet).

Port of ``pointreggpt_tpu/train/mask_trainer.py``: BCE epochs with
global-norm clipping and Adam, a learning rate that falls by ``lr_gamma``
at every epoch, per-item validation metrics at threshold 0.99, ``best``
(on SAE) and ``latest`` checkpoints; and the tester's input / output GIFs
over 3DMatch test reprojections.

The step is eager PyTorch whose host loop never waits for the card inside
an epoch: the Adam step count lives on the host, losses and metrics stay
on the device until the epoch's end reads them, and batches go up from
pinned memory without blocking.

One divergence from the JAX package, on resume only: epoch ``e`` always
draws its batch order from ``(seed, e)``, so a resumed run sees the
batches an uninterrupted one would (the JAX loader restarts at epoch 0's
order).

Under torchrun (:mod:`pointreggpt_tpu_torch.parallel.mesh`) the batch is
``train_batch_size`` times the process count, as the JAX MaskTrainer
scales it by its device count: each process decodes and trains on its
``train_batch_size`` rows of every batch, and the gradients are averaged
by one all-reduce before the clip. Each process scores its block of the
validation pairs; the sums behind each metric are added over the
processes and divided once. Rank 0 alone writes the log and the
checkpoints.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from PIL import Image

from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.core import imageio16
from pointreggpt_tpu_torch.data.datasets import (PairedDepthDataset,
                                                 PrefetchLoader, TestDataset)
from pointreggpt_tpu_torch.models.bake import bake_inference
from pointreggpt_tpu_torch.parallel import mesh as M
from pointreggpt_tpu_torch.train import checkpoint as ckpt
from pointreggpt_tpu_torch.train.metrics import (METRIC_NAMES, AverageMeter,
                                                 Logger, mask_metrics)
from pointreggpt_tpu_torch.train.trainer import clip_by_global_norm_

MASK_THRESHOLD = 0.99


def bce_loss(prob: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on probabilities, each log term of a
    probability clamped at fp32-tiny and floored at -100 (torch's
    ``BCELoss`` floor; the clamp reaches about -87.3 first).

    Below fp32-tiny ``clamp_min`` routes the gradient to the constant, so
    it is exactly 0 there, as with ``jnp.maximum`` in the JAX package.
    """
    tiny = torch.finfo(torch.float32).tiny
    log_p = torch.log(prob.clamp_min(tiny)).clamp_min(-100.0)
    log_q = torch.log((1.0 - prob).clamp_min(tiny)).clamp_min(-100.0)
    return -(target * log_p + (1.0 - target) * log_q).mean()


def _to_device(batch: Dict[str, np.ndarray], keys: Sequence[str],
               device: torch.device) -> List[torch.Tensor]:
    """(b, h, w, 1) numpy images as (b, 1, h, w) tensors on ``device``,
    from pinned memory without a host wait on the card."""
    out = []
    for key in keys:
        t = torch.from_numpy(batch[key])
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t.permute(0, 3, 1, 2))
    return out


class MaskTrainer:
    """Epoch trainer for the depth-correction MaskUNet.

    Production configuration (train_depth_correction): batch 4, lr 4e-5
    falling by 0.95 an epoch, Adam betas (0.9, 0.99), clip 1.0, 100
    epochs, validation batch 8.

    Args:
        model: the MaskUNet (fp32 parameters); moved to ``device`` and,
            under torchrun, made rank 0's.
        folder: the pair root (``data/``, ``metadata/{train,val}.json``).
        train_batch_size: images per optimizer step on each process.
        device: ``cuda`` unless asked otherwise (see ``resolve_device``).
    """

    def __init__(self, model: nn.Module, folder: str, *,
                 image_size: int = 256,
                 train_batch_size: int = 4,
                 train_lr: float = 1e-4,
                 epochs: int = 100,
                 adam_betas: Tuple[float, float] = (0.9, 0.99),
                 lr_gamma: float = 0.95,
                 results_folder: str = "./results",
                 samples_folder: str = "./samples",
                 grad_clip: float = 1.0,
                 num_workers: Optional[int] = None,
                 val_batch_size: int = 8,
                 seed: int = 0,
                 device=None):
        world = M.process_count()
        self.device = resolve_device(device)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        M.broadcast_module_(self.model)
        self.epochs = epochs
        self.image_size = image_size
        # the global batch; this process's rows of it
        self.batch_size = train_batch_size * world
        self.rows = M.rank_rows(self.batch_size)
        self.val_batch_size = val_batch_size
        self.grad_clip = grad_clip
        self.num_workers = num_workers
        self.seed = seed
        self.results_folder = Path(results_folder)
        self.samples_folder = Path(samples_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.samples_folder.mkdir(parents=True, exist_ok=True)

        self.train_ds = PairedDepthDataset(folder, "train", image_size)
        self.val_ds = PairedDepthDataset(folder, "val", image_size)
        self.steps_per_epoch = max(1, len(self._loader(0)))

        self.train_lr, self.lr_gamma = train_lr, lr_gamma
        self.params = list(self.model.parameters())
        self.opt = torch.optim.Adam(self.params, lr=train_lr,
                                    betas=adam_betas, eps=1e-8)
        self.count = 0  # Adam steps taken: the schedule's clock
        self.epoch = 0
        self.loss_hist: List[float] = []
        self.metrics: Dict[str, dict] = {"best": {}, "current": {}}
        main = M.is_main_process()
        self.logger = Logger(str(self.results_folder / "train.log")
                             if main else None, is_main=main)

    def _loader(self, epoch: int) -> PrefetchLoader:
        return PrefetchLoader(self.train_ds, self.batch_size, shuffle=True,
                              num_workers=self.num_workers, seed=self.seed,
                              start_epoch=epoch,
                              rows=range(self.rows.start, self.rows.stop))

    def lr_at(self, count: int) -> float:
        """optax's ``exponential_decay(lr, steps_per_epoch, gamma,
        staircase=True)`` at Adam step ``count``."""
        return self.train_lr * self.lr_gamma ** (count //
                                                 self.steps_per_epoch)

    # ------------------------------------------------------------------
    def train_step(self, input_img: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
        """One optimizer step on a (b, 1, h, w) batch (this process's
        rows); returns the loss (over every process) as a device scalar."""
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        loss = bce_loss(self.model(input_img), mask)
        loss.backward()
        grads = [p.grad for p in self.params]
        loss = loss.detach().reshape(1)
        # before the clip, which sees the global gradient; the loss rides
        # in the same all-reduce
        M.all_reduce_mean_(grads + [loss])
        clip_by_global_norm_(grads, self.grad_clip)
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.opt.step()
        self.count += 1
        return loss[0]

    def train_one_epoch(self) -> float:
        meter = AverageMeter()
        t0 = time.time()
        losses = []
        for batch in self._loader(self.epoch):
            x, m = _to_device(batch, ("input_img", "mask"), self.device)
            losses.append(self.train_step(x, m))
        # one transfer at the epoch's end: a read per step would make the
        # next batch's upload wait for this step
        for v in torch.stack(losses).tolist() if losses else ():
            meter.update(v)
        self.logger.info(
            f"Epoch {self.epoch + 1}/{self.epochs} loss {float(meter):.4e} "
            f"batch {self.batch_size} ({time.time() - t0:.1f}s)")
        self.loss_hist.append(float(meter))
        return float(meter)

    @torch.inference_mode()
    def eval_one_epoch(self) -> None:
        """Per-item metrics over the validation pairs, averaged per item.
        The ragged last batch is padded to ``val_batch_size`` (one shape
        for every forward), and the padding is dropped before the meters
        see it. Under torchrun each process scores its contiguous block of
        the pairs, and the meters' sums and counts are added over the
        processes."""
        self.model.eval()
        vb = self.val_batch_size
        val = self.val_ds
        block = M.rank_rows(len(val))
        val = Subset(val, range(block.start, block.stop))
        outs = []
        for batch in PrefetchLoader(val, vb, shuffle=False,
                                    drop_last=False, num_workers=1):
            n_real = next(iter(batch.values())).shape[0]
            if n_real < vb:
                batch = {k: np.concatenate(
                    [v, np.repeat(v[-1:], vb - n_real, axis=0)], axis=0)
                    for k, v in batch.items()}
            x, label, mask = _to_device(
                batch, ("input_img", "label_img", "mask"), self.device)
            outs.append((mask_metrics(x, label, mask, self.model(x),
                                      mask_threshold=MASK_THRESHOLD),
                         n_real))
        meters = {}
        for k in outs[0][0] if outs else ():
            stacked = torch.stack([o[k] for o, _ in outs]).cpu().numpy()
            meters[k] = AverageMeter()
            for row, (_, n_real) in zip(stacked, outs):
                meters[k].update(float(row[:n_real].mean()), num=n_real)
        if M.in_process_group():
            meters = _meters_over_processes(meters)
        self.metrics["current"] = meters
        if meters:
            self.logger.info(
                "Epoch {}/{} mIoU {:.4e} PAcc {:.4e} FP {:.1f}".format(
                    self.epoch + 1, self.epochs, float(meters["mIoU"]),
                    float(meters["PAcc"]), float(meters["FP"])))

    def better_than_best_metrics(self, name: str = "SAE") -> bool:
        """Model selection on SAE: the current epoch is the best when its
        value is at most the best so far."""
        if name not in self.metrics["current"]:
            return False
        current = float(self.metrics["current"][name])
        best = self.metrics["best"].get(name)
        if best is None or current <= best:
            self.metrics["best"][name] = current
            return True
        return False

    def train_and_eval(self) -> None:
        for epoch in range(self.epoch, self.epochs):
            self.epoch = epoch
            self.train_one_epoch()
            self.eval_one_epoch()
            if self.better_than_best_metrics():
                self.save("best")
            self.save("latest")
            M.barrier()  # the epoch's checkpoints are on disk

    # ------------------------------------------------------------------
    def save(self, milestone: str) -> None:
        """``model-{milestone}.pt`` as ``{epoch, model, opt, loss_hist,
        best_metrics}``; ``model`` holds the reference MaskUnet names,
        which ``Generator`` reads. Written by rank 0 alone."""
        if not M.is_main_process():
            return
        ckpt.save_checkpoint(
            self.results_folder / f"model-{milestone}.pt",
            {"epoch": self.epoch,
             "model": self.model.state_dict(),
             "opt": self.opt.state_dict(),
             "loss_hist": [float(x) for x in self.loss_hist],
             "best_metrics": {k: float(v)
                              for k, v in self.metrics["best"].items()}})

    def load(self, milestone: str) -> None:
        """Restore a milestone: weights, Adam state and the schedule's
        count; training goes on at the epoch after the saved one. Every
        process reads the file; rank 0's weights are then broadcast.
        ``model-{milestone}.pt`` wins; else the JAX package's
        ``model-{milestone}.ckpt`` is read (optax's count carries the
        schedule's clock)."""
        group = self.opt.param_groups[0]
        data = ckpt.load_mask_checkpoint(
            ckpt.milestone_path(self.results_folder, milestone), self.model,
            lr=self.train_lr, betas=group["betas"], eps=group["eps"])
        self.model.load_state_dict(data["model"])
        M.broadcast_module_(self.model)
        self.opt.load_state_dict(data["opt"])
        self.count = adam_count(self.opt)
        self.epoch = int(data["epoch"]) + 1
        self.loss_hist = list(data.get("loss_hist", []))
        self.metrics["best"] = dict(data.get("best_metrics", {}))


class Subset:
    """Items ``indices`` of a dataset with ``getitem_at_epoch``."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset, self.indices = dataset, list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def getitem_at_epoch(self, index: int, epoch: int):
        return self.dataset.getitem_at_epoch(self.indices[index], epoch)


def _meters_over_processes(meters: Dict[str, AverageMeter]
                           ) -> Dict[str, AverageMeter]:
    """Each metric's sum and count added over the processes (a process
    with no pairs adds zeros), then divided once."""
    local = np.array([[meters[k].sum, meters[k].count] if k in meters
                      else [0.0, 0.0] for k in METRIC_NAMES])
    totals = M.all_reduce_sum_host(local)
    out = {}
    for k, (total, count) in zip(METRIC_NAMES, totals):
        if count > 0:
            m = out[k] = AverageMeter()
            m.sum, m.count = float(total), int(count)
            m.val = m.avg = m.sum / m.count
    return out


def adam_count(opt: torch.optim.Optimizer) -> int:
    """The step count of an Adam whose parameters all stepped together (0
    before the first step)."""
    steps = {int(s["step"]) for s in opt.state.values() if "step" in s}
    if len(steps) > 1:
        raise ValueError(f"Adam parameters at different steps {steps}")
    return steps.pop() if steps else 0


def make_gif(path, frames_u8, *, frame_ms: int = 1000) -> None:
    """Write a looping GIF whose frames last ``frame_ms`` MILLISECONDS
    each, through PIL (whose GIF ``duration`` is milliseconds).

    PIL merges identical consecutive frames and sums their durations: an
    input equal to its label becomes one 2000 ms frame.
    """
    imgs = [Image.fromarray(np.asarray(f)) for f in frames_u8]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(frame_ms), loop=0)


class MaskTester:
    """Qualitative evaluation: per test pair an input GIF (reprojected
    input, label) and an output GIF (input kept where the net's keep
    probability passes ``mask_threshold``, label).

    Args:
        model: the MaskUNet; :meth:`load` fills and places it.
        folder: 3DMatch-RGBD test root.
        info: the test pairs, ``{"src": [...], "tgt": [...]}``.
        device: ``cuda`` unless asked otherwise (see ``resolve_device``).
    """

    def __init__(self, model: nn.Module, folder: str, *, info=None,
                 image_size: int = 256,
                 results_folder: str = "./results",
                 samples_folder: str = "./samples",
                 mask_threshold: float = MASK_THRESHOLD,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.folder = folder
        self.info = info
        self.image_size = image_size
        self.mask_threshold = mask_threshold
        self.results_folder = Path(results_folder)
        self.samples_folder = Path(samples_folder)
        self.samples_folder.mkdir(parents=True, exist_ok=True)
        self.net = None

    def load(self, milestone: str) -> None:
        """Read ``model-{milestone}.pt`` (or the JAX package's
        ``model-{milestone}.ckpt``) and place the baked net on the device
        once."""
        data = ckpt.load_mask_checkpoint(
            ckpt.milestone_path(self.results_folder, milestone), self.model)
        self.model.load_state_dict(data["model"])
        net = bake_inference(self.model.eval(), self.model.dtype)
        self.net = net.to(self.device,
                          memory_format=torch.channels_last).eval()

    @torch.inference_mode()
    def test(self, *, limit: Optional[int] = None) -> None:
        if self.net is None:
            raise RuntimeError("MaskTester.test: call load() first")
        ds = TestDataset(self.info, self.folder, self.image_size,
                         device=self.device)
        n = len(ds) if limit is None else min(limit, len(ds))
        for idx in range(n):
            item = ds[idx]
            x = torch.from_numpy(item["input_img"][None]).permute(0, 3, 1, 2)
            prob = self.net(x.to(self.device))[0, 0].cpu().numpy()
            corrected = np.where(prob[..., None] > self.mask_threshold,
                                 item["input_img"], 0.0)

            def to_u8(img):
                return imageio16.to_uint8_image(img[..., 0])

            label = to_u8(item["label_img"])
            make_gif(self.samples_folder / f"{idx:06d}-input.gif",
                     [to_u8(item["input_img"]), label])
            make_gif(self.samples_folder / f"{idx:06d}-output.gif",
                     [to_u8(corrected), label])
