"""Generation with guided-diffusion's ADM as the denoiser:
``jobs/generate.py``'s closed loop of ``Generator.generate`` calls, its
recording and its checks, with the ADM (``configs/adm256_uncond.json``'s
flags) built through ``config.build_adm_unet``, drawn by
``lib/adm_weights.py``, saved as the EMA of a ``{step, ema}`` milestone
that ``Generator.load`` reads, and held against ``reference/adm.py``:

- ``unet_gap``: the ADM's whole output (noise and variance), max |got -
  ref| / max |ref|;
- ``chain_gap``: the DDIM + DDNM transition of a noise-predicting net
  (``reference.adm.ddim_ddnm_step`` on the configuration's beta schedule)
  from the recorded x_t and the port's own noise channel, the noise
  replayed, against the port's next x_t;
- the MaskUNet's, the geometry's and the files' numbers as in
  ``jobs/generate.py``.

Besides the window's record: the ADM's forwards, and the attention
routes' counts during the traced call (``traced_routes``: K2 at d = 64
for ``k2_roofline.adm``).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List

import torch

from portbench.jobs import generate
from portbench.lib import adm_weights, checks, traffic, weights
from portbench.reference import adm as radm
from portbench.reference import diffusion as rdiff
from portbench.reference import unet as runet
from portbench.reference.precision import rounding


class Job(generate.Job):
    def __init__(self, *args):
        super().__init__(*args)
        self.forwards = 0
        self.record: dict = {}

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from pointreggpt_tpu_torch import config as C
        from pointreggpt_tpu_torch.generate.generator import Generator

        # as generate_dataset's build_generator: fp32 stays fp32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        tr = self.tr
        with self.spans.span("setup.inputs"):
            self.rgbd, self.indoor, self.info = traffic.scene_pool(
                self.root, tr["scene_pool"], tr["frame_height"],
                tr["frame_width"], self.seed)
        with self.spans.span("setup.program"):
            model, dcfg = self._build(C, Generator)
        # warm-up: one chunk at the window's shapes through a short chain
        with self.spans.span("setup.warmup"):
            self.gen.diffusion = C.build_diffusion(
                replace(dcfg, sampling_timesteps=2), model)
            self._generate(tr["warmup_scene"])
            self.gen.diffusion = self.diffusion
        self.next_scene = 0

    def _build(self, C, Generator):
        tr, cfg, mcfg = self.tr, self.cfg, self.mask_cfg
        # built without an init of its own: Generator.load fills it
        with torch.device("meta"):
            model = C.build_adm_unet(C.ADMConfig(
                num_channels=cfg["num_channels"],
                channel_mult=tuple(cfg["channel_mult"]),
                num_res_blocks=cfg["num_res_blocks"],
                attention_resolutions=tuple(cfg["attention_resolutions"]),
                num_head_channels=cfg["num_head_channels"],
                in_channels=cfg["in_channels"],
                use_fp16=cfg["compute_dtype"] == "bf16"), cfg["image_size"])
        model = model.to_empty(device="cpu")
        mask = C.build_mask_unet(C.MaskModelConfig(
            dim=mcfg["dim"], dim_mults=tuple(mcfg["dim_mults"]),
            resnet_block_groups=mcfg["resnet_block_groups"],
            bf16=mcfg["compute_dtype"] == "bf16"))
        dcfg = C.DiffusionConfig(
            image_size=cfg["image_size"], timesteps=cfg["diffusion_steps"],
            sampling_timesteps=cfg["sampling_timesteps"],
            objective=cfg["objective"], beta_schedule=cfg["noise_schedule"],
            ddim_sampling_eta=cfg["ddim_sampling_eta"],
            is_ddnm_sampling=cfg["is_ddnm_sampling"])
        self.diffusion = C.build_diffusion(dcfg, model)
        self.sd = adm_weights.seeded(weights.layout_of(model), 2 * self.seed,
                                     self.device, cfg["num_head_channels"])
        self.msd = weights.seeded(weights.layout_of(mask), 2 * self.seed + 1,
                                  self.device,
                                  mask_out_bias=mcfg["mask_out_bias"])
        traffic.save_diffusion_checkpoint(
            self.root / "results" / "model-1.pt", self.sd)
        traffic.save_mask_checkpoint(
            self.root / "dc" / "model-best.pt", self.msd)
        job = self

        class BenchGenerator(Generator):
            def device_models(self):
                ema, dc = super().device_models()
                if getattr(self, "_wrapped_of", None) is not ema:
                    self._wrapped_of = ema
                    self._wrapped = (generate._Recorder(ema, "unet", job),
                                     generate._Recorder(dc, "mask", job))
                return self._wrapped

            def step(self, *args, **kw):
                return job.on_step(super().step, args, kw)

            def _setup_chunk(self, *a, **kw):
                with job.spans.span("scene_setup"):
                    return super()._setup_chunk(*a, **kw)

            def _write_sample_outputs(self, *a, **kw):
                with job.spans.span("host_write"):
                    return super()._write_sample_outputs(*a, **kw)

        self.gen = BenchGenerator(
            model, self.diffusion, str(self.rgbd), batch_size=tr["batch"],
            results_folder=str(self.root / "results"),
            samples_folder=str(self.root / "out"),
            depth_correction_model=mask,
            depth_correction_results=str(self.root / "dc"),
            train_info_path=str(self.root / "train_info.pkl"),
            data_root=str(self.indoor),
            memory_capacity=tr["memory_capacity"], seed=self.seed,
            device=self.device)
        self.gen.load("1")
        return model, dcfg

    # -- recording --------------------------------------------------------
    def on_call(self, kind: str, args, out) -> None:
        if kind == "unet":
            self.forwards += 1
        super().on_call(kind, args, out)

    def window(self, seconds: float) -> dict:
        self.record = super().window(seconds)
        return self.record

    def traced_segment(self) -> None:
        from pointreggpt_tpu_torch.ops import attention

        before = dict(attention.ROUTES)
        super().traced_segment()
        self.record["traced_routes"] = {
            k: v - before[k] for k, v in attention.ROUTES.items()}

    def flops_per_call(self) -> dict:
        from portbench.lib.adm_work import forward_flops
        from portbench.lib.flops import forward_flops as unet_flops

        b, s = self.tr["batch"], self.cfg["image_size"]
        fwd = forward_flops(self.cfg, b, s)
        mask = unet_flops(self.mask_cfg, b, s)
        n = self.tr["num_samples"]
        chain = self.cfg["sampling_timesteps"] + \
            (1 if self.tr["has_refine_step"] else 0)
        return {k: n * (chain * fwd[k] + 2 * mask[k]) for k in fwd}

    def counter_lines(self) -> List[str]:
        from pointreggpt_tpu_torch.ops import attention

        r = attention.ROUTES
        per = r["attn_k2_d64"] / max(self.forwards, 1)
        return super().counter_lines() + [
            f"attention routes since start: {r}; ADM forwards "
            f"{self.forwards}, attn_k2_d64 per forward {per!r}"]

    # -- the check --------------------------------------------------------
    def numbers(self, control) -> Dict[str, float]:
        """``jobs/generate.py``'s numbers with the ADM's reference and its
        chain step in the DiffusionUNet's place."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg, tr = self.cfg, self.tr
        exact = rounding("fp32")
        adm = radm.forward_fn(cfg, exact)
        mask = runet.forward_fn(self.mask_cfg, exact)
        ctrl = None
        if control is not None:
            ctrl = {"unet": radm.forward_fn(cfg, rounding(cfg["control"])),
                    "mask": runet.forward_fn(self.mask_cfg, rounding(
                        self.mask_cfg["control"])),
                    "geometry": rounding(self.mask_cfg["control"])}
        rows = tr["reference_rows"]
        ac = radm.alphas_cumprod(cfg["noise_schedule"], cfg["diffusion_steps"])
        nxt = rdiff.ddim_next(cfg["diffusion_steps"],
                              cfg["sampling_timesteps"])
        eta, ch = cfg["ddim_sampling_eta"], cfg["in_channels"]
        out = {k: 0.0 for k in ("splat_gap", "unet_gap", "chain_gap",
                                "mask_gap", "cloud_gap", "memory_gap",
                                "ply_gap")}
        if control is None:
            out["frame_mismatch"] = 0.0
        with torch.no_grad():
            for idx, step in enumerate(self.steps):
                calls = {c["pos"]: c for c in self.unet_calls.get(idx, [])}
                o = step["out"]
                cond_img = torch.stack(
                    [o.images_rpj, o.keep_mask.float()], -1) * 2.0 - 1.0
                for k in step["picks"]:
                    c, c1 = calls.get(k), calls.get(k + 1)
                    if c is None or c1 is None:
                        raise RuntimeError(f"chain call {k} not recorded")
                    ref = runet.in_blocks(lambda x, t: adm(self.sd, x, t),
                                          rows, c["x"], c["t"])
                    got = c["out"] if ctrl is None else runet.in_blocks(
                        lambda x, t: ctrl["unet"](self.sd, x, t), rows,
                        c["x"], c["t"])
                    out["unet_gap"] = max(out["unet_gap"],
                                          checks.rel_max_gap(got, ref))
                    t = int(c["t"][0].item())
                    g = torch.Generator(device=c["x"].device)
                    g.set_state(c["state"])
                    x = c["x"].permute(0, 2, 3, 1).float()
                    z = torch.randn(x.shape, generator=g, device=x.device)
                    eps = c["out"][:, :ch].permute(0, 2, 3, 1).float()
                    args = (x, eps, t, nxt[t], cond_img, z)
                    want = radm.ddim_ddnm_step(*args, eta, ac)
                    if ctrl is None:
                        got_next = c1["x"].permute(0, 2, 3, 1)
                    else:  # the step's own arithmetic, a rung lower
                        low = [a.to(generate.CHAIN_DTYPES[
                            cfg["chain_control"]])
                            if torch.is_tensor(a) else a for a in args]
                        got_next = radm.ddim_ddnm_step(*low, eta, ac).float()
                    out["chain_gap"] = max(out["chain_gap"],
                                           checks.max_gap(got_next, want))
                for x, p in step["mask_calls"]:
                    ref = runet.in_blocks(lambda d: mask(self.msd, d), rows,
                                          x)
                    got = p if ctrl is None else runet.in_blocks(
                        lambda d: ctrl["mask"](self.msd, d), rows, x)
                    dp = (got.double() - ref.double()).abs().sum()
                    w = (ref.double() * (1 - ref.double())).sum()
                    out["mask_gap"] = max(out["mask_gap"],
                                          float(dp / w.clamp_min(1e-30)))
                self._frame(step, out, ctrl)
        return out
