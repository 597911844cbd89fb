"""Generate the synthetic registration dataset on the GPU (PyTorch port).

Same flags as ``pointreggpt_tpu/cli/generate_dataset.py``: 250-step
DDIM + DDNM (eta 1.0), depth-correction MaskUNet, refine step off. Weights
come from ``{results_folder}/model-{resume}.pt`` ({step, model, ema}) and
``./depth_correction_results/model-best.pt`` ({epoch, model}).

    python -m pointreggpt_tpu_torch.cli.generate_dataset --resume 1 \
        --data /path/to/3DMatch-RGBD/train -start 0 -stop 8 --num_samples 2

Runs on ``cuda``; ``PRGPT_PLATFORM=cpu`` runs the plain path on the CPU.
On several GPUs, one process each, every process takes its strided share
of [-start, -stop) (``parallel.local_scene_range``) with ``--batch_size``
scenes a step on its own GPU::

    torchrun --nproc_per_node 8 -m pointreggpt_tpu_torch.cli.generate_dataset \
        --resume 1 --data /path/to/3DMatch-RGBD/train -start 0 -stop 64
"""

import argparse

import torch

from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch.parallel import mesh as M

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
    with M.process_group():
        _generate(args)


def build_generator(args):
    """The entry point's ``(Generator, GenerateConfig)`` for parsed
    ``args``, with TF32 off."""
    from pointreggpt_tpu_torch.generate import Generator

    # fp32 convs (the default fp32 MaskUNet, thresholded at 0.99) stay
    # fp32: cuDNN would otherwise run them in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    model = C.build_diffusion_unet(C.from_args(args, C.ModelConfig))
    diffusion = C.build_diffusion(C.from_args(args, C.DiffusionConfig),
                                  model)
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
    return generator, cfg


def _generate(args) -> None:
    generator, cfg = build_generator(args)
    scene_indices = None
    if M.process_count() > 1:
        scene_indices = M.local_scene_range(args.start_scene_index,
                                            args.stop_scene_index)
        print(f"process {M.process_index()}/{M.process_count()}: "
              f"{len(scene_indices)} scenes of "
              f"[{args.start_scene_index}, {args.stop_scene_index})")

    generator.load(args.resume)
    generator.generate(
        start_scene_index=args.start_scene_index,
        stop_scene_index=args.stop_scene_index,
        num_samples=cfg.num_samples,
        memory_voxel_size=cfg.memory_voxel_size,
        save_voxel_size=cfg.save_voxel_size,
        has_refine_step=cfg.has_refine_step,
        scene_indices=scene_indices)


if __name__ == "__main__":
    main()
