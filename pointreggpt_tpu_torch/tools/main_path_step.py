"""Seconds per sample step of the generation main path and per optimizer
step of the training path, as ``chip_smoke.py`` measures them, for the
checkout at ROOT.

    python pointreggpt_tpu_torch/tools/main_path_step.py ROOT

Builds ROOT's kernels, then runs ROOT's ``chip_smoke.phase_main_path``
(``generate_dataset.main`` at the production configuration on a
synthetic tree, two sample steps, with its launch-count and output
checks) and prints one JSON line: each step's device seconds, the last
step's seconds and pairs per minute, and the card's ``nvidia-smi`` name
and power limit; then ROOT's ``chip_smoke.phase_train_step`` (one
production optimizer step, microbatch 32 x accumulation 2, on 64
synthetic frames; its own JSON line, ``sec_per_step``). To compare two
commits on one card, unpack the other into a directory and run this in
turns in one call (parent, change, change, parent). Needs a CUDA GPU.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke
    from pointreggpt_tpu_torch.ops import _build
    from pointreggpt_tpu_torch.ops import attention as K2
    from pointreggpt_tpu_torch.ops import linear_attention as K1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    with tempfile.TemporaryDirectory(prefix="prgpt_step_") as tmp:
        res = chip_smoke.phase_main_path(torch, K1, K2, 0, 2,
                                         Path(tmp) / "main")
        out = dict(root=argv[0], card=chip_smoke.card_line(),
                   **{k: res[k] for k in ("step_device_s",
                                          "sec_per_sample_step",
                                          "pairs_per_min")})
        print(json.dumps(out), flush=True)
        folder, gt_log = chip_smoke.write_training_tree(Path(tmp), 64, 0)
        chip_smoke.phase_train_step(torch, K1, K2, folder, gt_log, Path(tmp))
    return out


if __name__ == "__main__":
    main()
