"""Qualitative depth-correction evaluation on 3DMatch test reprojections
(PyTorch port).

Same flags as ``pointreggpt_tpu/cli/test_depth_correction.py``: for each
test pair (both directions) the reprojected input and its label go to
``{idx:06d}-input.gif``, and the input kept where the MaskUNet's keep
probability passes 0.99 with its label to ``{idx:06d}-output.gif``, in
``samples_folder``; frames last 1000 ms.

    python -m pointreggpt_tpu_torch.cli.test_depth_correction \
        --resume best --data /path/to/3DMatch-RGBD/test \
        --info ./dataset/indoor/metadata/3DMatch.pkl --limit 16

The fragments' ``.info.txt`` files are read under
``./dataset/indoor/data``. Runs on ``cuda``; ``PRGPT_PLATFORM=cpu`` runs
the plain path on the CPU.
"""

import argparse
import pickle

import torch

from pointreggpt_tpu_torch import config as C


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--resume", default=None, type=str,
                        help="checkpoint milestone to load (best/latest)")
    parser.add_argument("--data", default="/path/to/3DMatch-RGBD/test",
                        help="path to 3DMatch RGB-D test set")
    parser.add_argument("--info",
                        default="./dataset/indoor/metadata/3DMatch.pkl",
                        help="test pair metadata pickle")
    parser.add_argument("--limit", default=None, type=int,
                        help="cap the number of evaluated pairs")
    parser.add_argument("--image_size", default=256, type=int)
    parser.add_argument("--results_folder",
                        default="./depth_correction_results")
    parser.add_argument("--samples_folder",
                        default="./depth_correction_samples")
    C.add_dataclass_args(parser, C.MaskModelConfig)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from pointreggpt_tpu_torch.train.mask_trainer import MaskTester

    # fp32 stays fp32: cuDNN would otherwise run fp32 convs in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    with open(args.info, "rb") as f:
        info = pickle.load(f)
    model = C.build_mask_unet(C.from_args(args, C.MaskModelConfig))
    tester = MaskTester(
        model, args.data, info=info,
        image_size=args.image_size,
        results_folder=args.results_folder,
        samples_folder=args.samples_folder)
    if args.resume is not None:
        tester.load(args.resume)
    tester.test(limit=args.limit)


if __name__ == "__main__":
    main()
