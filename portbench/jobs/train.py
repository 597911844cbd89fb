"""Diffusion training: ``Trainer.train_step`` on batches from the Trainer's
own loader (``Trainer.dl``, the ``PrefetchLoader`` decoding PNGs) through
``_upload``, as ``Trainer.train`` runs them, on a synthetic 3DMatch-RGBD
tree. No milestone falls in a window.

Set-up writes a milestone at step ``resume_step`` (the seeded weights, a
second seeded draw as the EMA, Adam at that count with zero moments) and
resumes the Trainer from it through ``Trainer.load``, so that the EMA is
past its warm-up and moves by its decay. It then takes the first
``captured_steps`` steps through the window's loop and captures them
(:mod:`lib.training`), with each step's batch and the state of the
(t, noise) generator before it; the reference replays t and the noise
from that state (``torch.randint`` then ``torch.randn`` per microbatch,
the order ``GaussianDiffusion.training_loss`` draws them) and the EMA's
updates (every ``ema_update_every`` steps of its count, a copy up to
``ema_update_after_step``, then the decay ``1 - (1 + k)^-power`` capped at
``ema_decay``, k the count past the warm-up).
"""

from __future__ import annotations

import math

import torch

from portbench.lib import traffic, training, weights
from portbench.reference import diffusion as rdiff
from portbench.reference import unet as runet
from portbench.reference.precision import rounding


class Job(training.TrainingJob):
    def setup(self) -> None:
        from pointreggpt_tpu_torch import config as C
        from pointreggpt_tpu_torch.train.trainer import Trainer

        cfg, tr = self.cfg, self.tr
        with self.spans.span("setup.inputs"):
            folder, gt_log = traffic.training_tree(
                self.root, tr["frames"], tr["distinct_frames"],
                tr["frame_height"], tr["frame_width"], self.seed)
        with self.spans.span("setup.program"):
            model = C.build_diffusion_unet(C.ModelConfig(
                dim=cfg["dim"], dim_mults=tuple(cfg["dim_mults"]),
                resnet_block_groups=cfg["resnet_block_groups"],
                param_cond_dim=cfg["param_cond_dim"],
                bf16=cfg["compute_dtype"] == "bf16"))
            layout = weights.layout_of(model)
            self.sd = weights.seeded(layout, 2 * self.seed, self.device)
            ema_sd = weights.seeded(layout, 2 * self.seed + 1, self.device)
            diffusion = C.build_diffusion(C.DiffusionConfig(
                image_size=cfg["image_size"], timesteps=cfg["timesteps"],
                objective=cfg["objective"],
                beta_schedule=cfg["beta_schedule"],
                loss_type=cfg["loss_type"]), model)
            self.trainer = Trainer(
                model, diffusion, folder,
                train_batch_size=tr["microbatch"],
                gradient_accumulate_every=tr["accumulate"],
                augment_horizontal_flip=tr["horizontal_flip"],
                train_lr=tr["lr"], train_num_steps=1 << 40,
                ema_update_every=tr["ema_update_every"],
                ema_decay=tr["ema_decay"],
                adam_betas=tuple(tr["adam_betas"]),
                save_and_sample_every=tr["save_and_sample_every"],
                results_folder=str(self.root / "results"),
                samples_folder=str(self.root / "samples"), gt_log=gt_log,
                grad_clip=tr["grad_clip"],
                num_workers=tr["loader_threads"], seed=self.seed,
                device=self.device)
            self._resume(ema_sd)
            self.batches = self.trainer.dl
            self.images_per_step = tr["microbatch"] * tr["accumulate"]
            # as Trainer.train seeds its (t, noise) stream at its step
            self.generator = torch.Generator(device=self.device).manual_seed(
                self.trainer._generator_seed())
        with self.spans.span("setup.first_steps"):
            self._first_steps()

    def _resume(self, ema_sd) -> None:
        """Write the milestone ``resume`` in the Trainer's layout and load
        it through ``Trainer.load``."""
        t, step = self.trainer, self.tr["resume_step"]
        host = {k: v.detach().cpu() for k, v in self.sd.items()}
        ema = {"initted": torch.tensor(True), "step": torch.tensor(step)}
        for k in t.ema.state_dict():
            for prefix, sd in (("online_model.model.", host),
                               ("ema_model.model.", ema_sd)):
                if k.startswith(prefix):
                    ema[k] = sd[k[len(prefix):]].detach().cpu()
        path = self.root / "results" / "model-resume.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"step": step,
                    "model": {f"model.{k}": v for k, v in host.items()},
                    "opt": training.zero_adam_state(
                        t.opt, step, self.device.type != "cpu"),
                    "ema": ema}, path)
        t.load("resume")
        path.unlink()
        names = dict(t.ema.ema_model["model"].named_parameters())
        self.ema0 = {k: ema_sd[k] for k in names}

    def _ema(self):
        return dict(self.trainer.ema.ema_model["model"].named_parameters())

    def ema_decay(self, s: int):
        """The reference EMA's decay after captured step ``s`` (None: no
        update); the milestone's EMA is initialised."""
        tr = self.tr
        count = tr["resume_step"] + s
        if count % tr["ema_update_every"]:
            return None
        k = count - tr["ema_update_after_step"]
        if k <= 0:
            return 0.0
        return min(max(1.0 - (1.0 + k) ** -tr["ema_power"], 0.0),
                   tr["ema_decay"])

    def _keep(self, batch) -> dict:
        return {"img": batch["img"].copy(),
                "intrinsic": batch["intrinsic"].copy(),
                "state": self.generator.get_state()}

    def _step(self, batch) -> torch.Tensor:
        t = self.trainer
        with self.spans.span("upload"):
            img, intrinsic = t._upload(batch)
        with self.spans.span("step_dispatch"):
            loss = t.train_step(img, intrinsic, self.generator)
        t.step += 1
        return loss

    def _draws(self, s: int):
        """Step ``s``'s images, intrinsics and, per microbatch, its t and
        noise replayed from the kept generator state."""
        cfg, mb, dev = self.cfg, self.tr["microbatch"], self.device
        inp = self.cap.inputs[s]
        img = torch.from_numpy(inp["img"]).to(dev)
        intr = torch.from_numpy(inp["intrinsic"]).to(dev)
        g = torch.Generator(device=dev)
        g.set_state(inp["state"])
        for i in range(self.tr["accumulate"]):
            t = torch.randint(0, cfg["timesteps"], (mb,), generator=g,
                              device=dev)
            noise = torch.randn((mb,) + tuple(img.shape[1:]), generator=g,
                                device=dev)
            sl = slice(i * mb, (i + 1) * mb)
            yield img[sl], intr[sl], t, noise

    def own_loss(self, s: int, outs) -> float:
        """The reference's loss of step ``s`` from ``outs``, the net's
        output of each microbatch (nan unless every row is there)."""
        tab = rdiff.tables(self.cfg["timesteps"])
        mb = self.tr["microbatch"]
        if len(outs) != self.tr["accumulate"] or \
                any(o.shape[0] != mb for o in outs):
            return math.nan
        total = 0.0
        for (img, intr, t, noise), out in zip(self._draws(s), outs):
            _, _, x0 = rdiff.training_inputs(img, intr, t, noise,
                                             tab["alphas_cumprod"])
            total += float(rdiff.loss_of(out, x0, t, tab["loss_weight"]))
        return total / len(outs)

    def reference(self, precision: str, *, half_batch: bool = False) -> dict:
        """The reference's steps at ``precision``; ``half_batch`` plants a
        fault in it: the loss of the first half of each microbatch alone,
        the mean taken over it."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg, tr = self.cfg, self.tr
        fwd = runet.forward_fn(cfg, rounding(precision))
        tab = rdiff.tables(cfg["timesteps"])
        mb, acc, rows = tr["microbatch"], tr["accumulate"], \
            tr["reference_rows"]
        used = mb // 2 if half_batch else mb

        def grads_of(params, s):
            total, outs = 0.0, []
            for img, intr, t, noise in self._draws(s):
                parts = []
                # the rows in the loss, then (the fault) the rows left out
                for lo, hi in ((0, used), (used, mb)):
                    for j in range(lo, hi, rows):
                        k = slice(j, min(j + rows, hi))
                        n = k.stop - k.start
                        with torch.set_grad_enabled(hi == used):
                            loss, out = rdiff.training_loss(
                                lambda x, tt, c: fwd(params, x, tt, c),
                                img[k], intr[k], t[k], noise[k],
                                tab["alphas_cumprod"], tab["loss_weight"])
                        if hi == used:
                            (loss * (n / used / acc)).backward()
                            total += float(loss.detach()) * n / used / acc
                        parts.append(out.detach())
                outs.append(torch.cat(parts))
            return total, outs

        return training.reference_steps(
            self.sd, tr["captured_steps"], grads_of, lambda s: tr["lr"],
            tuple(tr["adam_betas"]), 1e-8, tr["grad_clip"],
            count=tr["resume_step"], ema0=self.ema0,
            ema_decay=self.ema_decay)
