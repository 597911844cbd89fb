"""Compute gt.log overlap metadata for a generated dataset (PyTorch port).

Same flags as ``pointreggpt_tpu/cli/generate_gt.py``: for scenes
[-start, -stop) of ``./{dataset_name}/data``, every pair of the first
``num_samples`` sample clouds is scored (voxel-downsampled, then the share
of points with a counterpart within ``voxel_size * overlap_factor``); the
per-scene ``gt.log`` files are concatenated into
``./{dataset_name}/metadata/gt.log``.

    python -m pointreggpt_tpu_torch.cli.generate_gt -start 0 -stop 8

Runs on ``cuda``; ``PRGPT_PLATFORM=cpu`` runs it on the CPU.
"""

import argparse

import torch

from pointreggpt_tpu_torch import config as C


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--start_scene_index", "-start", default=0, type=int)
    parser.add_argument("--stop_scene_index", "-stop", default=1, type=int)
    parser.add_argument("--disable_tqdm", action="store_true",
                        help="silence the per-pair progress prints")
    C.add_dataclass_args(parser, C.GtLogConfig)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from pointreggpt_tpu_torch.generate.gt import gather_gt, generate_gt

    # the pairwise distances are fp32 products: TF32 would move points
    # across the radius
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = C.from_args(args, C.GtLogConfig)
    generate_gt(cfg.dataset_name, args.start_scene_index,
                args.stop_scene_index, cfg.num_samples,
                min_points=cfg.min_points, min_overlap=cfg.min_overlap,
                voxel_size=cfg.voxel_size, overlap_factor=cfg.overlap_factor,
                verbose=not args.disable_tqdm)
    gather_gt(cfg.dataset_name, args.start_scene_index,
              args.stop_scene_index)


if __name__ == "__main__":
    main()
