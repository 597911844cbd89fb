"""Generation: ``Generator.generate`` in a closed loop, one chunk of
``batch`` new scene indices a call, on synthetic 3DMatch-RGBD scenes.

Recorded while the window runs (references and clones on the device, no
host sync): each sample step's CUDA events and its inputs and outputs; the
DiffusionUNet's inputs and output at chain positions drawn from the seed
(and the next call's input), with the noise generator's state at that call;
every MaskUNet call. Checked after the window against the plain reference:

- ``unet_gap``: each recorded DiffusionUNet output, max |got - ref| / max
  |ref|;
- ``splat_gap``: the condition's depth before depth correction, the scene
  memory the step was given splatted into the sampled camera: pixels
  where it differs from the reference's (one of the two empty, or depths
  more than ``splat_tol`` m apart) over the pixels the reference covers;
- ``chain_gap``: the DDIM + DDNM transition from the recorded x_t and the
  port's own net output (the net is ``unet_gap``'s), with the step's noise
  replayed from the recorded generator state, against the port's next
  x_t: max |got - ref| in model units; the control computes the step in
  bf16, the rung below the fp32 it is stated in;
- ``mask_gap``: each MaskUNet call's keep probabilities, sum |got - ref|
  over sum ref (1 - ref) (a mean gap of logits, which the probabilities
  near 1 would hide);
- ``cloud_gap``: the new frame back-projected to the world, max |got - ref|
  in metres;
- ``memory_gap`` / ``ply_gap``: the scene memory after the sample and the
  written fragment cloud against the reference's voxelization of the
  reference's world points (:func:`reference.geometry.set_gap`);
- ``frame_mismatch`` (exact): pixels where a keep mask was applied other
  than its probability says (on the condition's depth and its mask), written depth PNG pixels other than the
  sample's, pose entries other than the inverse of the sampled pose.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from PIL import Image

from portbench.lib import checks, traffic, weights
from portbench.reference import diffusion as rdiff
from portbench.reference import geometry as rgeo
from portbench.reference import unet as runet
from portbench.reference.precision import rounding


def _port_configs(cfg: dict, mask_cfg: dict):
    from pointreggpt_tpu_torch import config as C

    model = C.ModelConfig(dim=cfg["dim"], dim_mults=tuple(cfg["dim_mults"]),
                          resnet_block_groups=cfg["resnet_block_groups"],
                          param_cond_dim=cfg["param_cond_dim"],
                          bf16=cfg["compute_dtype"] == "bf16")
    mask = C.MaskModelConfig(dim=mask_cfg["dim"],
                             dim_mults=tuple(mask_cfg["dim_mults"]),
                             resnet_block_groups=mask_cfg[
                                 "resnet_block_groups"],
                             bf16=mask_cfg["compute_dtype"] == "bf16")
    diff = C.DiffusionConfig(
        image_size=cfg["image_size"], timesteps=cfg["timesteps"],
        sampling_timesteps=cfg["sampling_timesteps"],
        objective=cfg["objective"], beta_schedule=cfg["beta_schedule"],
        ddim_sampling_eta=cfg["ddim_sampling_eta"],
        is_ddnm_sampling=cfg["is_ddnm_sampling"])
    return model, mask, diff


CHAIN_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


class _Recorder:
    """Calls a baked net and, while the window runs, keeps what the check
    needs of the calls it was asked for."""

    def __init__(self, net, kind: str, job: "Job"):
        self.net, self.kind, self.job = net, kind, job

    def __call__(self, *args):
        out = self.net(*args)
        self.job.on_call(self.kind, args, out)
        return out


class Job:
    def __init__(self, cell, seed, device, workdir, spans):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.root, self.spans = workdir, spans
        self.cfg, self.tr = cell.config, cell.traffic
        self.mask_cfg = self.cfg["mask_net"]
        self.recording = False
        self.steps: List[dict] = []
        self.unet_calls: Dict[int, List[dict]] = {}
        self.events = []
        self.calls: List[tuple] = []
        self.pending_unet, self.pending_mask, self.picks = [], [], []

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from pointreggpt_tpu_torch import config as C
        from pointreggpt_tpu_torch.generate.generator import Generator

        # as generate_dataset's build_generator: fp32 stays fp32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        tr, cfg = self.tr, self.cfg
        with self.spans.span("setup.inputs"):
            self.rgbd, self.indoor, self.info = traffic.scene_pool(
                self.root, tr["scene_pool"], tr["frame_height"],
                tr["frame_width"], self.seed)
        with self.spans.span("setup.program"):
            model, dcfg = self._build(C, Generator)
        # warm-up: one chunk at the window's shapes through a short chain
        with self.spans.span("setup.warmup"):
            self.gen.diffusion = C.build_diffusion(C.DiffusionConfig(
                **{**dcfg.__dict__, "sampling_timesteps": 2}), model)
            self._generate(tr["warmup_scene"])
            self.gen.diffusion = self.diffusion
        self.next_scene = 0

    def _build(self, C, Generator):
        tr, cfg = self.tr, self.cfg
        mcfg, kcfg, dcfg = _port_configs(cfg, self.mask_cfg)
        model = C.build_diffusion_unet(mcfg)
        mask = C.build_mask_unet(kcfg)
        self.diffusion = C.build_diffusion(dcfg, model)
        self.sd = weights.seeded(weights.layout_of(model), 2 * self.seed,
                                 self.device)
        self.msd = weights.seeded(weights.layout_of(mask), 2 * self.seed + 1,
                                  self.device,
                                  mask_out_bias=self.mask_cfg[
                                      "mask_out_bias"])
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
                    self._wrapped = (_Recorder(ema, "unet", job),
                                     _Recorder(dc, "mask", job))
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
            model, self.diffusion, str(self.rgbd),
            batch_size=tr["batch"],
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

    def _generate(self, start: int) -> None:
        tr = self.tr
        self.gen.generate(start, start + tr["batch"], tr["num_samples"],
                          memory_voxel_size=tr["memory_voxel"],
                          save_voxel_size=tr["save_voxel"],
                          has_refine_step=tr["has_refine_step"],
                          info_train=self.info, verbose=False)

    # -- recording --------------------------------------------------------
    def on_step(self, step_fn, args, kw):
        self.generator = args[4] if len(args) > 4 else kw.get("generator")
        self.call_in_step = 0
        if self.recording:
            rng = np.random.default_rng([self.seed % (1 << 63),
                                         len(self.steps)])
            picks = rng.choice(self.diffusion.sampling_timesteps - 1,
                               size=self.tr["chain_checks"], replace=False)
            self.picks = sorted(int(p) for p in picks)
        cuda = self.device.type == "cuda"
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        with self.spans.span("step_dispatch"):
            out = step_fn(*args, **kw)
        if cuda:
            e1.record()
        if self.recording:
            if cuda:
                self.events.append((e0, e1))
            self.unet_calls[len(self.steps)] = self.pending_unet
            self.pending_unet = []
            self.steps.append({
                "mem_pts": args[0], "mem_valid": args[1],
                "intrinsic": args[2], "out": out, "mask_calls": [],
                "picks": self.picks, "chunk": self.chunk})
        return out

    def on_call(self, kind: str, args, out) -> None:
        if not self.recording:
            return
        if kind == "mask":
            self.pending_mask.append((args[0].clone(), out.clone()))
            return
        pos = self.call_in_step
        self.call_in_step += 1
        if pos in self.picks or pos - 1 in self.picks:
            self.pending_unet.append({
                "pos": pos, "x": args[0].clone(), "t": args[1].clone(),
                "cond": args[2].clone(), "out": out.clone(),
                "state": self.generator.get_state()})

    # -- the window -------------------------------------------------------
    def _timed_call(self) -> None:
        self.pending_unet, self.pending_mask = [], []
        self.chunk = self.next_scene
        with self.spans.span("generate"):
            t0 = time.time_ns()
            self._generate(self.next_scene)
            t1 = time.time_ns()
        if self.recording:
            # a chunk's mask calls, two to each of its sample steps
            mine = [s for s in self.steps if s["chunk"] == self.chunk]
            for i, s in enumerate(mine):
                s["mask_calls"] = self.pending_mask[2 * i:2 * i + 2]
            self.calls.append((self.next_scene, t0, t1))
        self.next_scene += self.tr["batch"]

    def window(self, seconds: float) -> dict:
        self.recording = True
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._timed_call()
        wall = time.perf_counter() - t0
        self.recording = False
        n = len(self.calls)
        pairs = n * self.tr["batch"] * self.tr["num_samples"]
        step_s = [a.elapsed_time(b) / 1e3 for a, b in self.events] \
            if self.events else []
        return {"attempted": pairs, "failed": 0, "pairs": pairs,
                "calls": n, "wall_s": wall, "step_s": step_s,
                "chunk_s": [(t1 - t0) / 1e9 for _, t0, t1 in self.calls],
                "steps_per_call": self.tr["num_samples"],
                "flops": self.flops_per_call()}

    def traced_segment(self) -> None:
        self._timed_call()

    def flops_per_call(self) -> dict:
        from portbench.lib.flops import forward_flops

        b, s = self.tr["batch"], self.cfg["image_size"]
        fwd = forward_flops(self.cfg, b, s)
        mask = forward_flops(self.mask_cfg, b, s)
        n = self.tr["num_samples"]
        chain = self.cfg["sampling_timesteps"] + \
            (1 if self.tr["has_refine_step"] else 0)
        return {k: n * (chain * fwd[k] + 2 * mask[k]) for k in fwd}

    def counter_lines(self) -> List[str]:
        from pointreggpt_tpu_torch.ops.attention import multihead_attention
        from pointreggpt_tpu_torch.ops.linear_attention import \
            fused_linear_attention

        k1, k2 = fused_linear_attention, multihead_attention
        return [f"launches since start: K1 {k1.launches}, K2 {k2.launches},"
                f" K1 plain routes {k1.plain_routes}; calls timed "
                f"{len(self.calls)}"]

    def release(self) -> None:
        self.gen = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    def check(self) -> Dict[str, float]:
        return self.numbers(None)

    def controls(self) -> Dict[str, Dict[str, float]]:
        """The control (the reference at each net's control precision in
        the port's place) beside the port's own numbers."""
        return {"control": self.numbers(True), "port": self.numbers(None)}

    def numbers(self, control) -> Dict[str, float]:
        """The compared numbers; with ``control`` (a precision) the
        reference at that precision stands in the port's place."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        exact = rounding("fp32")
        nets = {"unet": runet.forward_fn(self.cfg, exact),
                "mask": runet.forward_fn(self.mask_cfg, exact)}
        ctrl = None
        if control is not None:
            ctrl = {"unet": runet.forward_fn(self.cfg, rounding(
                        self.cfg["control"])),
                    "mask": runet.forward_fn(self.mask_cfg, rounding(
                        self.mask_cfg["control"])),
                    "geometry": rounding(self.mask_cfg["control"])}
        rows = self.tr["reference_rows"]
        tab = rdiff.tables(self.cfg["timesteps"])
        nxt = rdiff.ddim_next(self.cfg["timesteps"],
                              self.cfg["sampling_timesteps"])
        eta = self.cfg["ddim_sampling_eta"]
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
                    ref = runet.in_blocks(
                        lambda x, t, cd: nets["unet"](self.sd, x, t, cd),
                        rows, c["x"], c["t"], c["cond"])
                    got = c["out"] if ctrl is None else runet.in_blocks(
                        lambda x, t, cd: ctrl["unet"](self.sd, x, t, cd),
                        rows, c["x"], c["t"], c["cond"])
                    out["unet_gap"] = max(out["unet_gap"],
                                          checks.rel_max_gap(got, ref))
                    t = int(c["t"][0].item())
                    g = torch.Generator(device=c["x"].device)
                    g.set_state(c["state"])
                    x = c["x"].permute(0, 2, 3, 1).float()
                    z = torch.randn(x.shape, generator=g, device=x.device)
                    args = (x, c["out"].permute(0, 2, 3, 1).float(), t,
                            nxt[t], cond_img, z)
                    want = rdiff.ddim_ddnm_step(*args, eta,
                                                tab["alphas_cumprod"])
                    if ctrl is None:
                        got_next = c1["x"].permute(0, 2, 3, 1)
                    else:  # the step's own arithmetic, a rung lower
                        low = [a.to(CHAIN_DTYPES[self.cfg["chain_control"]])
                               if torch.is_tensor(a) else a for a in args]
                        got_next = rdiff.ddim_ddnm_step(
                            *low, eta, tab["alphas_cumprod"]).float()
                    out["chain_gap"] = max(out["chain_gap"],
                                           checks.max_gap(got_next, want))
                for x, p in step["mask_calls"]:
                    ref = runet.in_blocks(lambda d: nets["mask"](self.msd, d),
                                          rows, x)
                    got = p if ctrl is None else runet.in_blocks(
                        lambda d: ctrl["mask"](self.msd, d), rows, x)
                    # |dp| over p (1 - p): near p = 1 a logit's gap shrinks
                    # by p (1 - p) in the probability
                    dp = (got.double() - ref.double()).abs().sum()
                    w = (ref.double() * (1 - ref.double())).sum()
                    out["mask_gap"] = max(out["mask_gap"],
                                          float(dp / w.clamp_min(1e-30)))
                self._frame(step, out, ctrl)
        return out

    def _frame(self, step, out, ctrl) -> None:
        """Back-projection, memory, fragment cloud and files of one
        sample step."""
        o, tr = step["out"], self.tr
        exact = rounding("fp32")
        size = self.cfg["image_size"]
        args = (step["mem_pts"], step["mem_valid"], o.pose,
                step["intrinsic"], size)
        want = rgeo.splat(*args, exact)
        got = o.images_raw.float() * 10.0 if ctrl is None else \
            rgeo.splat(*args, ctrl["geometry"])
        out["splat_gap"] = max(out["splat_gap"], rgeo.splat_gap(
            got, want, tr["splat_tol"]))
        depth = o.images[..., 0].float() * 10.0
        world, valid = rgeo.back_project(depth, step["intrinsic"], o.pose,
                                         exact)
        if ctrl is None:
            got_world, got_valid = o.world, o.world_valid
        else:
            got_world, got_valid = rgeo.back_project(
                depth, step["intrinsic"], o.pose, ctrl["geometry"])
        mism = int((got_valid != valid).sum())
        gap = float((got_world - world).abs()[valid].max()) \
            if bool(valid.any()) else 0.0
        out["cloud_gap"] = max(out["cloud_gap"], gap + mism)
        for i in range(o.images.shape[0]):
            mem_in = step["mem_pts"][i][step["mem_valid"][i]]
            want = rgeo.memory_after(mem_in, world[i][valid[i]],
                                     tr["memory_voxel"],
                                     tr["memory_capacity"])
            if ctrl is None:
                got = o.mem_pts[i][o.mem_valid[i]]
            else:
                got = rgeo.memory_after(mem_in, got_world[i][got_valid[i]],
                                        tr["memory_voxel"],
                                        tr["memory_capacity"])
            out["memory_gap"] = max(out["memory_gap"], rgeo.set_gap(
                got.cpu().numpy(), want.cpu().numpy(), tr["memory_voxel"]))
            if tr["num_samples"] != 1:
                continue
            sid = step["chunk"] + i
            scene = self.root / "out" / f"scene-{sid:06d}"
            want_ply = rgeo.fragment_cloud(world[i][valid[i]], o.pose[i],
                                           tr["save_voxel"], exact)
            if ctrl is None:
                from pointreggpt_tpu_torch.core import plyio

                got_ply = plyio.read_ply(scene / "sample-000001.cloud.ply")
            else:
                got_ply = rgeo.fragment_cloud(
                    got_world[i][got_valid[i]], o.pose[i], tr["save_voxel"],
                    ctrl["geometry"]).cpu().numpy()
            out["ply_gap"] = max(out["ply_gap"], rgeo.set_gap(
                got_ply, want_ply.cpu().numpy(), tr["save_voxel"]))
            if ctrl is None:
                out["frame_mismatch"] += self._files(step, i, scene)

    def _files(self, step, i: int, scene) -> int:
        """Exact checks of one scene's sample: the keep masks as their
        probabilities say, the depth PNG, the pose file."""
        o = step["out"]
        bad = 0
        (x1, p1), (x2, p2) = step["mask_calls"][:2]
        raw = o.images_raw[i]
        kept = torch.where(p1[i, 0] > 0.99, raw, torch.zeros_like(raw))
        bad += int((kept != o.images_rpj[i]).sum())
        bad += int((((raw > 0) & (p1[i, 0] > 0.99)) != o.keep_mask[i]).sum())
        chain = x2[i, 0]
        final = torch.where(p2[i, 0] > 0.99, chain, torch.zeros_like(chain))
        bad += int((final != o.images[i, ..., 0]).sum())
        img = o.images[i, ..., 0].double().cpu().numpy()
        png = np.asarray(Image.open(scene / "sample-000001.depth.png"))
        bad += int((png != (img * 1e4).astype(np.uint16)).sum())
        pose = np.loadtxt(scene / "sample-000001.pose.txt")
        want = np.linalg.inv(o.pose[i].cpu().numpy())
        bad += int((pose != want).sum())
        return bad
