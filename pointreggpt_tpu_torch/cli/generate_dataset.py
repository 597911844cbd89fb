"""Generate the synthetic registration dataset on the GPU (PyTorch port).

Same flags as ``pointreggpt_tpu/cli/generate_dataset.py``: 250-step
DDIM + DDNM (eta 1.0), depth-correction MaskUNet, refine step off. Weights
come from ``{results_folder}/model-{resume}.pt`` ({step, model, ema}) and
``./depth_correction_results/model-best.pt`` ({epoch, model}).

    python -m pointreggpt_tpu_torch.cli.generate_dataset --resume 1 \
        --data /path/to/3DMatch-RGBD/train -start 0 -stop 8 --num_samples 2

Runs on ``cuda``; ``PRGPT_PLATFORM=cpu`` runs the plain path on the CPU.
Multi-process scene sharding is not ported yet: one process takes the
whole [-start, -stop) range.
"""

import argparse

import torch

from pointreggpt_tpu_torch import config as C

GEN_DIFFUSION = C.DiffusionConfig(ddim_sampling_eta=1.0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--resume", default=None, type=str, required=True,
                        help="checkpoint milestone to load")
    parser.add_argument("--start_scene_index", "-start", default=0, type=int)
    parser.add_argument("--stop_scene_index", "-stop", default=1, type=int)
    C.add_dataclass_args(parser, C.ModelConfig)
    C.add_dataclass_args(parser, C.DiffusionConfig, defaults=GEN_DIFFUSION)
    C.add_dataclass_args(parser, C.GenerateConfig)
    C.add_dataclass_args(parser, C.MaskModelConfig, prefix="dc_")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from pointreggpt_tpu_torch.generate import Generator

    # fp32 convs (the default fp32 MaskUNet, thresholded at 0.99) stay
    # fp32: cuDNN would otherwise run them in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    model_cfg = C.from_args(args, C.ModelConfig)
    model = C.build_diffusion_unet(model_cfg)
    diffusion = C.build_diffusion(C.from_args(args, C.DiffusionConfig),
                                  channels=model_cfg.channels)
    depth_correction = C.build_mask_unet(
        C.from_args(args, C.MaskModelConfig, prefix="dc_"))
    cfg = C.from_args(args, C.GenerateConfig)

    generator = Generator(
        model, diffusion, cfg.data,
        batch_size=cfg.batch_size,
        results_folder=cfg.results_folder,
        samples_folder=f"./{cfg.dataset_name}/data",
        depth_correction_model=depth_correction,
        train_info_path=cfg.train_info_path,
        data_root=cfg.data_root,
        memory_capacity=cfg.memory_capacity,
        seed=cfg.seed)
    generator.load(args.resume)
    generator.generate(
        start_scene_index=args.start_scene_index,
        stop_scene_index=args.stop_scene_index,
        num_samples=cfg.num_samples,
        memory_voxel_size=cfg.memory_voxel_size,
        save_voxel_size=cfg.save_voxel_size,
        has_refine_step=cfg.has_refine_step)


if __name__ == "__main__":
    main()
