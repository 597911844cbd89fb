"""Depth-correction training: ``MaskTrainer.train_step`` on batches from the
MaskTrainer's own loader, epoch after epoch as ``train_one_epoch`` runs
them (validation, once an epoch, left out), on synthetic pairs.

Set-up writes a milestone at the end of epoch ``resume_epoch`` (the
seeded weights, Adam at that epoch's last count with zero moments) and
resumes the MaskTrainer from it through ``MaskTrainer.load``, so that the
learning rate has fallen by ``lr_gamma`` once an epoch. It then takes the
first ``captured_steps`` steps through the window's loop and captures
them (:mod:`lib.training`); the step draws nothing, so the reference
needs only the batches.
"""

from __future__ import annotations

import math

import torch

from portbench.lib import traffic, training, weights
from portbench.reference import unet as runet
from portbench.reference.precision import rounding


def bce(prob: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on probabilities, each log floored at -100
    (``torch.nn.BCELoss``; a probability is first kept off 0 and 1 by
    fp32's smallest normal, so the floor's gradient is 0 and not nan)."""
    tiny = torch.finfo(torch.float32).tiny
    log_p = torch.log(prob.clamp_min(tiny)).clamp_min(-100.0)
    log_q = torch.log((1.0 - prob).clamp_min(tiny)).clamp_min(-100.0)
    return -(target * log_p + (1.0 - target) * log_q).mean()


class Job(training.TrainingJob):
    def setup(self) -> None:
        from pointreggpt_tpu_torch import config as C
        from pointreggpt_tpu_torch.train.mask_trainer import MaskTrainer

        # as train_depth_correction: fp32 stays fp32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg, tr = self.cfg, self.tr
        with self.spans.span("setup.inputs"):
            folder = traffic.mask_pairs(self.root / "pairs",
                                        tr["train_pairs"], tr["val_pairs"],
                                        tr["distinct_pairs"],
                                        cfg["image_size"], self.seed)
        with self.spans.span("setup.program"):
            model = C.build_mask_unet(C.MaskModelConfig(
                dim=cfg["dim"], dim_mults=tuple(cfg["dim_mults"]),
                resnet_block_groups=cfg["resnet_block_groups"],
                bf16=cfg["compute_dtype"] == "bf16"))
            self.sd = weights.seeded(weights.layout_of(model),
                                     2 * self.seed + 1, self.device,
                                     mask_out_bias=cfg["mask_out_bias"])
            self.trainer = MaskTrainer(
                model, folder, image_size=cfg["image_size"],
                train_batch_size=tr["batch"], train_lr=tr["lr"],
                epochs=1 << 30, adam_betas=tuple(tr["adam_betas"]),
                lr_gamma=tr["lr_gamma"],
                results_folder=str(self.root / "results"),
                samples_folder=str(self.root / "samples"),
                grad_clip=tr["grad_clip"],
                num_workers=tr["loader_threads"], seed=self.seed,
                device=self.device)
            self.steps_per_epoch = self.trainer.steps_per_epoch
            self._resume()
            self.batches = self._epochs()
            self.images_per_step = tr["batch"]
        with self.spans.span("setup.first_steps"):
            self._first_steps()

    def _resume(self) -> None:
        """Write the milestone ``resume`` in the MaskTrainer's layout and
        load it through ``MaskTrainer.load``: training goes on at the next
        epoch, the schedule's count at that epoch's start."""
        t, epoch = self.trainer, self.tr["resume_epoch"]
        self.count = (epoch + 1) * self.steps_per_epoch
        path = self.root / "results" / "model-resume.pt"
        torch.save({"epoch": epoch,
                    "model": {k: v.detach().cpu() for k, v in self.sd.items()},
                    "opt": training.zero_adam_state(
                        t.opt, self.count, self.device.type != "cpu"),
                    "loss_hist": [], "best_metrics": {}}, path)
        t.load("resume")
        path.unlink()

    def _epochs(self):
        t = self.trainer
        while True:
            for batch in t._loader(t.epoch):
                yield batch
            t.epoch += 1

    def _keep(self, batch) -> dict:
        return {k: v.copy() for k, v in batch.items()}

    def _step(self, batch) -> torch.Tensor:
        from pointreggpt_tpu_torch.train.mask_trainer import _to_device

        with self.spans.span("upload"):
            x, m = _to_device(batch, ("input_img", "mask"), self.device)
        with self.spans.span("step_dispatch"):
            return self.trainer.train_step(x, m)

    def own_loss(self, s: int, outs) -> float:
        """The reference's loss of step ``s`` from ``outs``, the net's keep
        probabilities (nan unless every row is there)."""
        m = self.cap.inputs[s]["mask"]
        if len(outs) != 1 or outs[0].shape[0] != m.shape[0]:
            return math.nan
        m = torch.from_numpy(m).to(self.device).permute(0, 3, 1, 2)
        return float(bce(outs[0], m))

    def reference(self, precision: str, *, half_batch: bool = False) -> dict:
        """The reference's steps at ``precision``, with the fault of
        ``jobs/train.py``'s :meth:`reference`."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        tr = self.tr
        fwd = runet.forward_fn(self.cfg, rounding(precision))
        dev = self.device

        def to_dev(a):
            return torch.from_numpy(a).to(dev).permute(0, 3, 1, 2)

        def grads_of(params, s):
            inp = self.cap.inputs[s]
            x, m = to_dev(inp["input_img"]), to_dev(inp["mask"])
            used = x.shape[0] // 2 if half_batch else x.shape[0]
            prob = fwd(params, x)
            loss = bce(prob[:used], m[:used])
            loss.backward()
            return float(loss.detach()), [prob.detach()]

        def lr_of(s):
            return tr["lr"] * tr["lr_gamma"] ** (
                (self.count + s) // self.steps_per_epoch)

        return training.reference_steps(
            self.sd, tr["captured_steps"], grads_of, lr_of,
            tuple(tr["adam_betas"]), 1e-8, tr["grad_clip"], count=self.count)
