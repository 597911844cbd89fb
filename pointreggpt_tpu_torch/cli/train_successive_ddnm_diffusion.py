"""Train the successive-DDNM depth-inpainting diffusion model on one GPU
(PyTorch port).

Same flags as ``pointreggpt_tpu/cli/train_successive_ddnm_diffusion.py``:
DiffusionUNet dim 64, bf16 compute with fp32 parameters, 1000 timesteps,
sigmoid schedule, pred_x0, L1; microbatch 32 x accumulation 2, Adam 8e-5
(0.9, 0.99), clip 1.0, EMA 0.995 every 10 steps, h-flip; a 25-image EMA
grid (250 DDIM steps, eta 0) and ``model-{m}.pt`` every 1000 steps.

    python -m pointreggpt_tpu_torch.cli.train_successive_ddnm_diffusion \
        --data /path/to/3DMatch-RGBD/train \
        --gt_log ./dataset/3DMatch/metadata/gt.log

Runs on ``cuda``; ``PRGPT_PLATFORM=cpu`` runs the plain path on the CPU.
``--resume m`` continues from ``{results_folder}/model-{m}.pt``.
Multi-GPU training and FID are not ported yet and raise.
"""

import argparse

import torch

from pointreggpt_tpu_torch import config as C


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--resume", default=None, type=int,
                        help="checkpoint milestone to load")
    C.add_dataclass_args(parser, C.ModelConfig,
                         defaults=C.ModelConfig(remat=False))
    C.add_dataclass_args(parser, C.DiffusionConfig)
    C.add_dataclass_args(parser, C.TrainConfig)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from pointreggpt_tpu_torch.train.trainer import Trainer

    # fp32 stays fp32: cuDNN would otherwise run fp32 convs in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    model_cfg = C.from_args(args, C.ModelConfig)
    model = C.build_diffusion_unet(model_cfg)
    diffusion = C.build_diffusion(C.from_args(args, C.DiffusionConfig),
                                  channels=model_cfg.channels)
    cfg = C.from_args(args, C.TrainConfig)

    trainer = Trainer(
        model, diffusion, cfg.data,
        train_batch_size=cfg.train_batch_size,
        train_lr=cfg.train_lr,
        train_num_steps=cfg.train_num_steps,
        gradient_accumulate_every=cfg.gradient_accumulate_every,
        augment_horizontal_flip=cfg.augment_horizontal_flip,
        ema_decay=cfg.ema_decay,
        ema_update_every=cfg.ema_update_every,
        save_and_sample_every=cfg.save_and_sample_every,
        num_samples=cfg.num_samples,
        results_folder=cfg.results_folder,
        samples_folder=cfg.samples_folder,
        gt_log=cfg.gt_log,
        calculate_fid=cfg.calculate_fid,
        num_workers=cfg.num_workers or None,
        seed=cfg.seed)
    if args.resume is not None:
        trainer.load(args.resume)
    trainer.train()


if __name__ == "__main__":
    main()
