"""Data-parallel diffusion trainer: one GPU, or one process per GPU.

Port of ``pointreggpt_tpu/train/trainer.py``: gradient accumulation over
microbatches, global-norm clipping, Adam, an EMA tick, and at every
milestone an EMA sample grid, with ``calculate_fid`` its FID against the
last training batch (``fid_score: <value>`` in the log), and a checkpoint.
The JAX package runs the whole optimizer step as one jitted program; here
it is eager PyTorch whose host loop never waits for the card inside a
step: the step counter lives on the host, losses stay on the device until
a log line reads them, and batches go up from pinned memory without
blocking.

Under torchrun (:mod:`pointreggpt_tpu_torch.parallel.mesh`) the global
microbatch divides over the processes: each decodes its block of every
microbatch, draws the global t and noise and keeps its rows, and the
gradients (with the loss) are averaged by one all-reduce before the clip.
Rank 0 alone writes logs, sample grids, FID lines and checkpoints; the
others send it their rows of the last batch (FID's real set is the whole
global batch) and wait for it at a barrier.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from PIL import Image

from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.core import geometry as G
from pointreggpt_tpu_torch.core import imageio16
from pointreggpt_tpu_torch.core import sampling as S
from pointreggpt_tpu_torch.data.datasets import DepthDataset, PrefetchLoader
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.parallel import mesh as M
from pointreggpt_tpu_torch.train import checkpoint as ckpt
from pointreggpt_tpu_torch.train.ema import EMA
from pointreggpt_tpu_torch.train.metrics import Logger
from pointreggpt_tpu_torch.utils import profiling

VERSION = "pointreggpt-tpu-torch"


def save_image_grid(images01: np.ndarray, path, nrow: int) -> None:
    """Save a (n, h, w, 1) [0, 1] batch as a tiled grayscale PNG grid with
    ``nrow`` images per row."""
    images01 = np.asarray(images01)[..., 0]
    n, h, w = images01.shape
    rows = -(-n // nrow)
    grid = np.zeros((rows * h, nrow * w), np.float32)
    for i in range(n):
        r, c = divmod(i, nrow)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = images01[i]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(imageio16.to_uint8_image(grid)).save(path)


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place as optax's ``clip_by_global_norm``:
    ``g * max_norm / |g|`` when the global norm ``|g|`` reaches
    ``max_norm``, else ``g`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6
    to the norm and clips below it). Returns the norm, on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm >= max_norm, max_norm / norm,
                        torch.ones_like(norm))
    torch._foreach_mul_(grads, scale)
    return norm


class Trainer:
    """Diffusion trainer with the reference's hyperparameter surface.

    Production configuration (train_successive_ddnm_diffusion): microbatch
    32, accumulation 2, lr 8e-5, Adam betas (0.9, 0.99), clip 1.0, EMA
    0.995 every 10 steps, h-flip, a 25-image EMA grid and a checkpoint
    every 1000 steps.

    Args:
        model: the DiffusionUNet (fp32 parameters); moved to ``device``
            and, under torchrun, made rank 0's.
        diffusion: the GaussianDiffusion process.
        folder: 3DMatch-RGBD train root, with the frames ``gt_log`` lists.
        train_batch_size: images per microbatch over all processes (the
            global microbatch, as in the JAX package); the process count
            must divide it.
        device: ``cuda`` unless asked otherwise (see ``resolve_device``).
    """

    def __init__(self, model: nn.Module, diffusion: GaussianDiffusion,
                 folder: str, *,
                 train_batch_size: int = 16,
                 gradient_accumulate_every: int = 1,
                 augment_horizontal_flip: bool = True,
                 train_lr: float = 1e-4,
                 train_num_steps: int = 100000,
                 ema_update_every: int = 10,
                 ema_decay: float = 0.995,
                 adam_betas: Tuple[float, float] = (0.9, 0.99),
                 save_and_sample_every: int = 1000,
                 num_samples: int = 25,
                 results_folder: str = "./results",
                 samples_folder: str = "./samples",
                 gt_log: str = "./dataset/3DMatch/metadata/gt.log",
                 sample_on_save: bool = True,
                 calculate_fid: bool = False,
                 grad_clip: float = 1.0,
                 num_workers: Optional[int] = None,
                 track_losses: bool = False,
                 seed: int = 0,
                 device=None):
        world = M.process_count()
        if train_batch_size % world != 0:
            raise ValueError(
                f"global batch {train_batch_size} must divide over "
                f"{world} processes")
        # this process's rows of each global microbatch (all of them with
        # no process group)
        self.rows = M.rank_rows(train_batch_size)
        self.device = resolve_device(device)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self.diffusion = diffusion
        self.batch_size = train_batch_size
        self.gradient_accumulate_every = gradient_accumulate_every
        self.train_num_steps = train_num_steps
        self.save_and_sample_every = save_and_sample_every
        self.num_samples = num_samples
        self.sample_on_save = sample_on_save
        self.grad_clip = grad_clip
        self.image_size = diffusion.image_size
        self.results_folder = Path(results_folder)
        self.samples_folder = Path(samples_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.samples_folder.mkdir(parents=True, exist_ok=True)
        self.seed = seed
        self.logger = Logger(is_main=M.is_main_process())
        # losses stay on the device inside the loop and come to the host
        # once, when train() returns (off in production: 2M steps)
        self.track_losses = track_losses
        self.loss_hist: List[float] = []
        # FID (off by default, as in the reference): the extractor is
        # built once; the last global batch's images are the real set
        self.calculate_fid = calculate_fid
        self._fid_extractor = None
        if calculate_fid and M.is_main_process():
            from pointreggpt_tpu_torch.eval.fid import InceptionFeatures

            self._fid_extractor = InceptionFeatures(device=self.device)
        self._last_batch = None

        self.ds = DepthDataset(folder, self.image_size, gt_log=gt_log,
                               augment_horizontal_flip=augment_horizontal_flip,
                               seed=seed)
        self.num_workers = num_workers
        self.dl = self._loader(0)

        self.params = list(self.model.parameters())
        self.opt = torch.optim.Adam(self.params, lr=train_lr,
                                    betas=adam_betas, eps=1e-8)
        # the reference's EMA wraps its GaussianDiffusion, whose `model` is
        # the U-Net: keep that nesting, so checkpoints hold the EMA U-Net
        # under ema_model.model.
        self.ema = EMA(nn.ModuleDict({"model": self.model}), beta=ema_decay,
                       update_every=ema_update_every)
        # rank 0's weights and EMA on every process (the EMA holds both)
        M.broadcast_module_(self.ema)
        self.step = 0

    @property
    def local_batch(self) -> int:
        """This process's rows of each microbatch."""
        return self.rows.size

    def _loader(self, start_epoch: int):
        # the process's block of each of the accum microbatches
        rows = [i * self.batch_size + r
                for i in range(self.gradient_accumulate_every)
                for r in range(self.rows.start, self.rows.stop)]
        return iter(PrefetchLoader(
            self.ds, self.batch_size * self.gradient_accumulate_every,
            shuffle=True, infinite=True, num_workers=self.num_workers,
            seed=self.seed, start_epoch=start_epoch, rows=rows))

    def _generator_seed(self) -> int:
        """The seed of the (t, noise) stream from ``self.step`` on: a
        resumed run folds its step in, so it never replays the draws of
        the steps it already took."""
        if self.step == 0:
            return self.seed + 1
        return int(np.random.SeedSequence(
            [self.seed + 1, self.step]).generate_state(1)[0])

    # ------------------------------------------------------------------
    def _upload(self, batch: Dict[str, np.ndarray]):
        """(accum, b, h, w, 1) images and (accum, b, 3, 3) intrinsics on
        the device, b this process's rows; from pinned memory without a
        host wait on the card."""
        a, b = self.gradient_accumulate_every, self.local_batch
        out = []
        for key in ("img", "intrinsic"):
            t = torch.from_numpy(batch[key])
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t.reshape((a, b) + t.shape[1:]))
        return out

    def train_step(self, img: torch.Tensor, intrinsic: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
        """One optimizer step over ``accum`` microbatches; returns the mean
        microbatch loss (over every process) as a device scalar."""
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=self.device)
        for i in range(self.gradient_accumulate_every):
            loss = self.diffusion.training_loss(
                self.model, img[i], intrinsic[i], generator, rows=self.rows)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        grads = [p.grad for p in self.params]
        # where JAX's psum sits: before the clip, which sees the global
        # gradient; the loss rides in the same all-reduce
        M.all_reduce_mean_(grads + [loss_sum.reshape(1)])
        torch._foreach_div_(grads, float(self.gradient_accumulate_every))
        clip_by_global_norm_(grads, self.grad_clip)
        self.opt.step()
        self.ema.update()
        return loss_sum / self.gradient_accumulate_every

    def train(self, *, log_every: int = 50) -> None:
        """Run the loop to ``train_num_steps``.

        ``PRGPT_PROFILE=<dir>`` (``utils/profiling.py``): the wall time of
        the stages ``load_batch`` (waiting for the decoded batch),
        ``dispatch`` (upload and queueing of the step; the card runs it
        later), ``loss_sync`` (the log line's read of the loss) and
        ``save_and_sample``, printed at the end, and a trace of steps 3-4,
        whose steps the breakdown leaves out.
        """
        prof = profiling.loop_profile(2, 5)
        stage = prof.stage if prof is not None else profiling.no_stage
        generator = torch.Generator(device=self.device).manual_seed(
            self._generator_seed())
        device_losses = []
        t0 = time.time()
        while self.step < self.train_num_steps:
            with stage("load_batch"):
                batch = next(self.dl)
            if self.calculate_fid:
                self._last_batch = batch
            with stage("dispatch"), profiling.annotate("train_step"):
                img, intrinsic = self._upload(batch)
                loss = self.train_step(img, intrinsic, generator)
            if self.track_losses:
                device_losses.append(loss)
            self.step += 1
            if self.step % log_every == 0:
                with stage("loss_sync"):
                    loss_v = loss.item()
                # the global batch: every process's rows
                rate = log_every * self.batch_size * \
                    self.gradient_accumulate_every / (time.time() - t0)
                self.logger.info(
                    f"step {self.step}/{self.train_num_steps} "
                    f"loss {loss_v:.4f} ({rate:.1f} img/s)")
                t0 = time.time()
            if self.step % self.save_and_sample_every == 0:
                with stage("save_and_sample"):
                    self._save_and_sample(self.step)
                # the milestone's sampling would deflate the next rate
                t0 = time.time()
            if prof is not None:
                prof.tick()
        if device_losses:
            self.loss_hist.extend(torch.stack(device_losses).tolist())
        if prof is not None:
            self.logger.info(prof.close())
        self.logger.info("training complete")

    # ------------------------------------------------------------------
    def _save_and_sample(self, step: int) -> None:
        """Rank 0 samples the EMA grid and writes it, the FID line and the
        checkpoint; the other processes send it their rows of the last
        batch (FID's real set) and wait at a barrier, which keeps the
        milestones in step."""
        real = None
        if self.calculate_fid and self.sample_on_save and \
                self._last_batch is not None:
            real = self._global_images(self._last_batch["img"])
        if M.is_main_process():
            self._save_and_sample_main(step, real)
        M.barrier()

    def _global_images(self, img: np.ndarray) -> Optional[np.ndarray]:
        """The whole global batch of ``img`` (every process's rows of each
        microbatch, in the order one process decodes them) on rank 0;
        None on the other processes."""
        parts = M.gather_to_main(img)
        if parts is None:
            return None
        a = self.gradient_accumulate_every
        return np.concatenate(
            [p.reshape((a, -1) + p.shape[1:]) for p in parts],
            axis=1).reshape((-1,) + img.shape[1:])

    def _save_and_sample_main(self, step: int,
                              real: Optional[np.ndarray]) -> None:
        milestone = step // self.save_and_sample_every
        if self.sample_on_save:
            images = self.sample_ema(self.num_samples,
                                     seed=self.seed + milestone)
            save_image_grid(images,
                            self.results_folder / f"sample-{milestone}.png",
                            nrow=int(math.isqrt(self.num_samples)))
            if real is not None:
                from pointreggpt_tpu_torch.eval.fid import fid_score

                score = fid_score(real, images, self._fid_extractor)
                self.logger.info(f"fid_score: {score}")
        # milestone floored to hundreds, like the reference
        self.save(milestone // 100 * 100)

    def sample_ema(self, num_samples: int, *, seed: int = 0) -> np.ndarray:
        """(n, h, w, 1) unconditional images in [0, 1] from the EMA U-Net,
        with intrinsics drawn from the 3DMatch distribution."""
        host = torch.Generator().manual_seed(seed)
        intrinsic = G.intrinsic_transform(
            S.random_sample_intrinsic(host, num_samples).numpy(),
            resize=self.image_size, centercrop=self.image_size,
        ).astype(np.float32)
        param_cond = G.param_vector(torch.from_numpy(intrinsic)).to(
            self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        net = self.ema.ema_model["model"].eval()
        images = self.diffusion.sample(net, param_cond=param_cond,
                                       generator=gen)
        return images.cpu().numpy()

    # ------------------------------------------------------------------
    def save(self, milestone) -> None:
        """``model-{milestone}.pt`` as ``{step, model, opt, ema,
        version}``, the reference layout; written by rank 0 alone."""
        if not M.is_main_process():
            return
        ckpt.save_checkpoint(
            self.results_folder / f"model-{milestone}.pt",
            {"step": self.step,
             "model": {f"model.{k}": v
                       for k, v in self.model.state_dict().items()},
             "opt": self.opt.state_dict(),
             "ema": self.ema.state_dict(),
             "version": VERSION})

    def load(self, milestone) -> None:
        """Restore a milestone: weights, Adam and EMA state, and the step;
        the loader restarts at the epoch that step had reached. Every
        process reads the file; rank 0's weights are then broadcast.

        ``model-{milestone}.pt`` wins; else the JAX package's
        ``model-{milestone}.ckpt`` is read, its Adam moments and count
        carried into this trainer's Adam (its own learning rate, as the
        JAX trainer's optax closure has it)."""
        group = self.opt.param_groups[0]
        data = ckpt.load_diffusion_checkpoint(
            ckpt.milestone_path(self.results_folder, milestone), self.model,
            lr=group["lr"], betas=group["betas"], eps=group["eps"])
        self.model.load_state_dict(
            {k[len("model."):]: v for k, v in data["model"].items()})
        self.opt.load_state_dict(data["opt"])
        self.ema.load_state_dict(data["ema"])
        M.broadcast_module_(self.ema)
        self.step = int(data["step"])
        global_batch = self.batch_size * self.gradient_accumulate_every
        self.dl = self._loader(
            self.step // max(1, len(self.ds) // global_batch))
        if data.get("version"):
            self.logger.info(f"loaded checkpoint version {data['version']}")
