"""Qualitative successive sampling (quick 32-step DDIM), PyTorch port.

Same flags and defaults as
``pointreggpt_tpu/cli/test_successive_ddnm_diffusion.py``: the EMA U-Net
of ``{results_folder}/model-{resume}.pt`` samples ``--num_scenes`` scenes
of ``--num_samples`` frames each (an unconditional first frame, then
successive frames under a forward motion) with DDIM, 32 steps, eta 1.0,
and writes triptych PNGs, PLYs and ``overview.png`` to
``--samples_folder``.

    python -m pointreggpt_tpu_torch.cli.test_successive_ddnm_diffusion \
        --resume 1

Runs on ``cuda``; ``PRGPT_PLATFORM=cpu`` runs the plain path on the CPU.
``--sampling_timesteps 1000`` (= ``--timesteps``) runs the ancestral chain.
On several GPUs, one process each, every batch holds ``--batch_size``
scenes per process, split in contiguous blocks; each process writes its
scenes' files and rank 0 the overview::

    torchrun --nproc_per_node 8 \
        -m pointreggpt_tpu_torch.cli.test_successive_ddnm_diffusion \
        --resume 1 --num_scenes 32
"""

import argparse

import torch

from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch.parallel import mesh as M

TEST_DIFFUSION = C.DiffusionConfig(sampling_timesteps=32,
                                   ddim_sampling_eta=1.0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--resume", default=None, type=str,
                        help="checkpoint milestone to load (required)")
    parser.add_argument("--num_scenes", default=4, type=int)
    parser.add_argument("--num_samples", default=4, type=int)
    parser.add_argument("--batch_size", default=4, type=int)
    parser.add_argument("--results_folder",
                        default="./successive_ddnm_diffusion_results")
    parser.add_argument("--samples_folder",
                        default="./successive_ddnm_diffusion_samples")
    C.add_dataclass_args(parser, C.ModelConfig)
    C.add_dataclass_args(parser, C.DiffusionConfig, defaults=TEST_DIFFUSION)
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.resume is None:
        # fail fast: load(None) would surface as a missing "model-None.pt"
        parser.error("--resume is required (checkpoint milestone to load)")
    with M.process_group():
        _test(args)


def _test(args) -> None:
    from pointreggpt_tpu_torch.generate.tester import Tester

    # fp32 stays fp32: cuDNN would otherwise run fp32 convs in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    model = C.build_diffusion_unet(C.from_args(args, C.ModelConfig))
    diffusion = C.build_diffusion(C.from_args(args, C.DiffusionConfig),
                                  model)

    tester = Tester(
        model,
        diffusion,
        batch_size=args.batch_size,
        results_folder=args.results_folder,
        samples_folder=args.samples_folder,
    )

    tester.load(args.resume)
    tester.sample(num_scenes=args.num_scenes, num_samples=args.num_samples)


if __name__ == "__main__":
    main()
