"""Build the depth-correction training pairs on the GPU (PyTorch port).

Same flags and outputs as
``pointreggpt_tpu/cli/make_depth_correction_data.py``. For each 3DMatch
train pair, in the order ``np.random.default_rng(seed).permutation``
draws, the source frame is reprojected into the target view (the
point-penetration artifacts the MaskUNet learns to mask) and written
beside the real target depth:

    data/{n:06d}-input.depth.png   reprojected depth
    data/{n:06d}-label.depth.png   real target depth
    metadata/{train,val}.json      [{"input_path", "label_path"}, ...]

A pair whose frames cannot be read is skipped and logged; fewer than two
usable pairs is an error. ``PairedDepthDataset`` derives the keep mask
at load time.

    python -m pointreggpt_tpu_torch.cli.make_depth_correction_data \
        --data /path/to/3DMatch-RGBD/train \
        --train_info ./dataset/indoor/metadata/train_info.pkl

Runs on ``cuda``; ``PRGPT_PLATFORM=cpu`` runs the reprojection on the CPU.
"""

import argparse
import json
import pickle
from pathlib import Path

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", default="/path/to/3DMatch-RGBD/train",
                        help="3DMatch RGB-D train root")
    parser.add_argument("--train_info",
                        default="./dataset/indoor/metadata/train_info.pkl")
    parser.add_argument("--data_root", default="./dataset/indoor/data",
                        help="fragment .info.txt root")
    parser.add_argument("--out", default="./dataset/depth_correction")
    parser.add_argument("--image_size", default=256, type=int)
    parser.add_argument("--num_pairs", default=2000, type=int)
    parser.add_argument("--val_fraction", default=0.05, type=float)
    parser.add_argument("--seed", default=0, type=int)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from pointreggpt_tpu_torch import resolve_device
    from pointreggpt_tpu_torch.core import imageio16
    from pointreggpt_tpu_torch.core.geometry import reproject
    from pointreggpt_tpu_torch.data.datasets import resolve_frame_record

    device = resolve_device()
    with open(args.train_info, "rb") as f:
        info = pickle.load(f)

    out = Path(args.out)
    (out / "data").mkdir(parents=True, exist_ok=True)
    (out / "metadata").mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(info["src"]))[:args.num_pairs]

    def frame_record(rel_path):
        return resolve_frame_record(args.data_root, args.data, rel_path,
                                    args.image_size, with_pose=True)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a[None])).to(device)

    entries = []
    for n, idx in enumerate(order):
        try:
            src_depth, src_pose, intr = frame_record(info["src"][idx])
            tgt_depth, tgt_pose, _ = frame_record(info["tgt"][idx])
        except (OSError, ValueError) as e:
            print(f"pair {idx}: skipped ({e})")
            continue

        relative = (np.linalg.inv(tgt_pose) @ src_pose).astype(np.float32)
        depth_rpj, mask_rpj = reproject(on_device(src_depth * 10.0),
                                        on_device(intr), on_device(relative))
        input01 = depth_rpj[0].cpu().numpy() * 0.1
        input01 = np.where(mask_rpj[0].cpu().numpy(), input01, 0.0)

        name_in = f"{n:06d}-input.depth.png"
        name_lb = f"{n:06d}-label.depth.png"
        imageio16.write_depth_png(out / "data" / name_in, input01)
        imageio16.write_depth_png(out / "data" / name_lb, tgt_depth)
        entries.append({"input_path": name_in, "label_path": name_lb})
        if (n + 1) % 100 == 0:
            print(f"{n + 1}/{len(order)} pairs written")

    # a train and a val pair at least: with fewer the trainer's loader
    # would fail later instead
    if len(entries) < 2:
        raise SystemExit(
            f"only {len(entries)} usable pair(s) out of {len(order)} "
            "sampled — need >= 2 for a train/val split; check --data / "
            "--data_root (skipped pairs are logged above)")
    n_val = min(len(entries) - 1,
                max(1, int(len(entries) * args.val_fraction)))
    with open(out / "metadata/val.json", "w") as f:
        json.dump(entries[:n_val], f)
    with open(out / "metadata/train.json", "w") as f:
        json.dump(entries[n_val:], f)
    print(f"wrote {len(entries) - n_val} train / {n_val} val pairs to {out}")


if __name__ == "__main__":
    main()
