"""Turn published reference checkpoints, or the JAX package's ``.ckpt``
files, into the port's ``model-<milestone>.pt`` (PyTorch port).

Same flags as ``pointreggpt_tpu/cli/import_torch_checkpoint.py``:

    python -m pointreggpt_tpu_torch.cli.import_torch_checkpoint \
        --diffusion successive_ddnm_diffusion_results/model-official.pt \
        --depth_correction depth_correction_results/model-best.pt

A **reference ``.pt``** (diffusion ``{step, model, opt, ema, scaler}``;
depth correction ``{epoch, model, opt, scheduler, scaler, loss_hist,
metrics}``) keeps its model and EMA weights, step or epoch, loss history
and best metrics; its torch Adam and scaler state are dropped and the
port's checkpoint starts a fresh Adam, as the JAX importer does (a
``--resume`` restarts the optimizer statistics and the depth-correction
learning-rate clock). A **JAX ``.ckpt``** (by its suffix) also keeps its
Adam moments and count, so a ``--resume`` continues the JAX run's
optimizer and learning-rate clock. Either way the weights are loaded into
nets built from the ``ModelConfig`` / ``dc_``-prefixed ``MaskModelConfig``
flags with ``strict=True`` before anything is written, and the checkpoint
records ``version: "ported:<file name>"``. The loaders of the port read a
JAX ``.ckpt`` directly through the same conversion
(``train/checkpoint.py``), so this CLI is needed only to keep ``.pt``
files.

The output is what the port's Trainer / MaskTrainer save, which
``generate_dataset``, the Tester and both ``--resume`` flags read. The
conversion moves weights between files and computes nothing, so it runs
on the host.
"""

import argparse
import os
from pathlib import Path

import torch
import torch.nn as nn

from pointreggpt_tpu_torch import config as C


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--diffusion", default=None, type=str,
                        help="reference diffusion .pt (e.g. model-official."
                        "pt) or a JAX package .ckpt")
    parser.add_argument("--depth_correction", default=None, type=str,
                        help="reference depth-correction .pt (model-best."
                        "pt) or a JAX package .ckpt")
    parser.add_argument("--diffusion_out",
                        default="./successive_ddnm_diffusion_results",
                        help="results folder receiving the diffusion .pt")
    parser.add_argument("--dc_out", default="./depth_correction_results",
                        help="results folder receiving the dc .pt")
    parser.add_argument("--milestone", default=None, type=str,
                        help="override the milestone name (default: taken "
                        "from the input file name, model-<milestone>.pt)")
    C.add_dataclass_args(parser, C.ModelConfig)
    C.add_dataclass_args(parser, C.MaskModelConfig, prefix="dc_")
    return parser


def _milestone_from(path: str, override) -> str:
    if override is not None:
        return str(override)
    stem = Path(path).stem  # model-official
    return stem[len("model-"):] if stem.startswith("model-") else stem


def _adam(net: nn.Module, lr: float, state=None) -> dict:
    """A torch Adam state dict for ``net``: fresh, or ``state`` checked
    against ``net``'s parameter groups."""
    from pointreggpt_tpu_torch.train.checkpoint import ADAM_BETAS, ADAM_EPS

    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=ADAM_BETAS,
                           eps=ADAM_EPS)
    if state is not None:
        opt.load_state_dict(state)
    return opt.state_dict()


def convert_diffusion(path: str, out_dir: str, milestone: str,
                      model_cfg: C.ModelConfig) -> Path:
    """``{step, model, opt, ema, version}`` from a reference diffusion
    ``.pt`` or a JAX Trainer ``.ckpt`` (as ``Trainer.load`` reads one)."""
    from pointreggpt_tpu_torch.train import checkpoint as ckpt
    from pointreggpt_tpu_torch.train.ema import EMA
    from pointreggpt_tpu_torch.utils import jax_params as JP

    lr = C.TrainConfig().train_lr
    net = C.build_diffusion_unet(model_cfg)
    if path.endswith(".ckpt"):
        payload = ckpt.diffusion_payload_from_jax(path, net, lr=lr)
    else:
        data = JP.load_reference_checkpoint(path)
        step = int(data["step"])
        ref_ema = data["ema"]
        model_sd = JP.strip_prefix(data["model"], "model.")
        payload = {
            "step": step, "model": data["model"],
            "opt": None,  # fresh: the reference's Adam and scaler are dropped
            "ema": ckpt.ema_state(
                model_sd, JP.strip_prefix(ref_ema, "ema_model.model."),
                int(ref_ema.get("step", step)),
                bool(ref_ema.get("initted", True))),
            "version": f"ported:{os.path.basename(path)}"}

    # every piece loads into the nets strictly before anything is written
    net.load_state_dict(JP.strip_prefix(payload["model"], "model."),
                        strict=True)
    ema = EMA(nn.ModuleDict({"model": net}))
    ema.load_state_dict(payload["ema"], strict=True)
    out = Path(out_dir) / f"model-{milestone}.pt"
    ckpt.save_checkpoint(out, {
        "step": payload["step"],
        "model": {f"model.{k}": v for k, v in net.state_dict().items()},
        "opt": _adam(net, lr, payload["opt"]),
        "ema": ema.state_dict(),
        "version": payload["version"]})
    return out


def convert_depth_correction(path: str, out_dir: str, milestone: str,
                             model_cfg: C.MaskModelConfig) -> Path:
    """``{epoch, model, opt, loss_hist, best_metrics, version}`` from a
    reference depth-correction ``.pt`` or a JAX MaskTrainer ``.ckpt`` (as
    ``MaskTrainer.load`` reads one)."""
    from pointreggpt_tpu_torch.train import checkpoint as ckpt
    from pointreggpt_tpu_torch.utils import jax_params as JP

    lr = C.MaskTrainConfig().train_lr
    net = C.build_mask_unet(model_cfg)
    if path.endswith(".ckpt"):
        payload = ckpt.mask_payload_from_jax(path, net, lr=lr)
    else:
        data = JP.load_reference_checkpoint(path)
        metrics = data.get("metrics") or {}
        payload = dict(
            epoch=int(data["epoch"]), model=data["model"], opt=None,
            loss_hist=[float(x) for x in data.get("loss_hist") or []],
            best_metrics={k: float(v)
                          for k, v in (metrics.get("best") or {}).items()},
            version=f"ported:{os.path.basename(path)}")
    net.load_state_dict(payload["model"], strict=True)
    out = Path(out_dir) / f"model-{milestone}.pt"
    ckpt.save_checkpoint(out, {
        "epoch": payload["epoch"],
        "model": net.state_dict(),
        "opt": _adam(net, lr, payload["opt"]),
        "loss_hist": payload["loss_hist"],
        "best_metrics": payload["best_metrics"],
        "version": payload["version"]})
    return out


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.diffusion is None and args.depth_correction is None:
        raise SystemExit(
            "nothing to do: pass --diffusion and/or --depth_correction")

    if args.diffusion is not None:
        milestone = _milestone_from(args.diffusion, args.milestone)
        out = convert_diffusion(args.diffusion, args.diffusion_out, milestone,
                                C.from_args(args, C.ModelConfig))
        print(f"diffusion: {args.diffusion} -> {out}")

    if args.depth_correction is not None:
        milestone = _milestone_from(args.depth_correction, args.milestone)
        out = convert_depth_correction(
            args.depth_correction, args.dc_out, milestone,
            C.from_args(args, C.MaskModelConfig, prefix="dc_"))
        print(f"depth correction: {args.depth_correction} -> {out}")


if __name__ == "__main__":
    main()
