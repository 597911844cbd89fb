#!/usr/bin/env python3
"""The readings the limits of a cell's comparison are set from: for each
seed, a run of the cell (set-up, a window of ``--seconds``) and then its
numbers against the plain reference beside those of the control (the
reference at the configuration's control precision, in the port's place)
and, in a training cell, of the planted half-batch fault (the loss of
half of each microbatch alone), each with the verdict the cell's limits
give it. The benchmark's own runs do not run this. One JSON line per
seed; the first ``--control-seeds`` seeds (all by default) read the
control and the fault, the others the port alone:

    python3 portbench/control.py --workload <cell> --seconds 10 \
        --seeds 11 12 13 --control-seeds 2
"""

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(name: str, seed: int, seconds: float, device=None,
             overrides=None, controls: bool = True) -> dict:
    import torch

    from portbench.lib import card, checks, spec
    from portbench.lib.trace import Spans

    cell = spec.Cell(name, overrides=overrides)
    if device is None:
        card.require_cards(cell.chips)
        device = "cuda"
    workdir = Path(tempfile.mkdtemp(prefix="portbench-control-"))
    try:
        job = cell.job().Job(cell, seed, torch.device(device), workdir,
                             Spans())
        job.setup()
        job.window(seconds)
        job.release()
        sides = job.controls() if controls else {"port": job.check()}
        # a control reads no exact number: its verdict is on the others
        verdicts = {f"{k}_correct": checks.verdict(
            v, {n: lim for n, lim in cell.limits.items() if n in v})
            for k, v in sides.items()}
        return {"workload": name, "seed": seed, **sides, **verdicts}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=None)
    args = p.parse_args()
    n = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  controls=i < n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
