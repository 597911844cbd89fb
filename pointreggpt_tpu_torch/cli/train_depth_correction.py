"""Train the depth-correction MaskUNet on one GPU or data-parallel on several
(PyTorch port).

Same flags as ``pointreggpt_tpu/cli/train_depth_correction.py``: MaskUNet
dim 64, (1, 2, 4, 8), fp32 (its keep mask is thresholded at 0.99); batch
4 at 256^2, Adam 4e-5 (0.9, 0.99) falling by 0.95 an epoch, clip 1.0, 100
epochs, validation batch 8. Every epoch writes ``model-latest.pt``, and
``model-best.pt`` when its SAE is the best so far, to ``results_folder``.

    python -m pointreggpt_tpu_torch.cli.train_depth_correction \
        --data ./dataset/depth_correction

Runs on ``cuda``; ``PRGPT_PLATFORM=cpu`` runs the plain path on the CPU.
``--resume latest`` (or ``best``) goes on at the epoch after the saved one.
On several GPUs, one process each, every process trains on
``--train_batch_size`` pairs of each step (the batch scales with the
process count, as the JAX MaskTrainer's with its device count); rank 0
writes the log and the checkpoints::

    torchrun --nproc_per_node 8 \
        -m pointreggpt_tpu_torch.cli.train_depth_correction \
        --data ./dataset/depth_correction
"""

import argparse

import torch

from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch.parallel import mesh as M


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--resume", default=None, type=str,
                        help="checkpoint milestone to load (best/latest)")
    C.add_dataclass_args(parser, C.MaskModelConfig)
    C.add_dataclass_args(parser, C.MaskTrainConfig)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    with M.process_group():
        _train(args)


def _train(args) -> None:
    from pointreggpt_tpu_torch.train.mask_trainer import MaskTrainer

    # fp32 stays fp32: cuDNN would otherwise run fp32 convs in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = C.from_args(args, C.MaskTrainConfig)
    torch.manual_seed(cfg.seed)  # the initial weights
    model = C.build_mask_unet(C.from_args(args, C.MaskModelConfig))

    trainer = MaskTrainer(
        model, cfg.data,
        image_size=cfg.image_size,
        train_batch_size=cfg.train_batch_size,
        train_lr=cfg.train_lr,
        lr_gamma=cfg.lr_gamma,
        epochs=cfg.epochs,
        results_folder=cfg.results_folder,
        samples_folder=cfg.samples_folder,
        val_batch_size=cfg.val_batch_size,
        num_workers=cfg.num_workers or None,
        seed=cfg.seed)
    if args.resume is not None:
        trainer.load(args.resume)
    trainer.train_and_eval()


if __name__ == "__main__":
    main()
