"""Data-parallel dry run: N processes started as torchrun starts them.

    python -m pointreggpt_tpu_torch.tools.dryrun_multiprocess \
        [--nproc 2] [--full_width] [--share_card]

Counterpart of ``__graft_entry__.py::dryrun_multiprocess``. It writes a
small synthetic training tree and starts ``--nproc`` processes (the
``spawn`` start method, torchrun's environment, a free port taken by
binding port 0, a wall-clock limit per launch). In every process it runs
one data-parallel ``Trainer`` step and takes a digest of the parameters
and the EMA, takes ``local_scene_range(0, 10)``, and calls
``Trainer.save`` into a results folder of the process's own. It then
checks that the digests agree, that the ranges tile [0, 10) disjointly,
and that rank 0 alone wrote a checkpoint.

The processes run where the port's entry points run: on the card, each
taking ``cuda:<LOCAL_RANK>`` and NCCL (``--share_card`` puts every process
on ``cuda:0`` over gloo instead, since NCCL takes one process per card);
on the CPU only when asked, with ``PRGPT_PLATFORM=cpu``, over gloo. With
no card and no such request it raises. The model is dim 8 at 32^2 unless
``--full_width`` (``ModelConfig()``: dim 64, 256^2, bf16).

:func:`launch` is the launcher itself, for any picklable function: the
tests and ``chip_smoke.py`` drive their data-parallel checks through it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import pickle
import socket
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

SCENES = (0, 10)  # the scene range each dry run splits


def free_port() -> int:
    """A port that was free a moment ago (bound to port 0, released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, env: Dict[str, str], backend, timeout_s,
               threads, out_path: str) -> None:
    """One process: torchrun's environment, the process group, ``fn``;
    its result (or traceback) pickled to ``out_path``."""
    os.environ.update(env)
    import torch

    from pointreggpt_tpu_torch.parallel import mesh as M

    if threads:
        torch.set_num_threads(threads)
    status = "ok"
    try:
        with M.process_group(backend, timeout_s):
            result = fn(*args)
    except BaseException:  # noqa: BLE001 - reported to the launcher
        status, result = "error", traceback.format_exc()
    with open(out_path, "wb") as f:
        pickle.dump((status, result), f)
    if status != "ok":
        raise SystemExit(1)


def launch(fn: Callable, nprocs: int, *, args: Sequence = (),
           local_ranks: Optional[Sequence[int]] = None,
           backend: Optional[str] = None, platform: Optional[str] = None,
           timeout_s: float = 300.0, collective_timeout_s: float = 60.0,
           threads: Optional[int] = 1) -> List[Any]:
    """Run ``fn(*args)`` in ``nprocs`` processes of one process group and
    return their results in rank order.

    Each process gets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (from
    ``local_ranks``, default its rank), ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``, and ``PRGPT_PLATFORM`` when
    ``platform`` is given; it joins the group through
    ``parallel.process_group(backend)`` and sets ``threads`` torch
    threads (None: torch's default). Raises when a process fails (with
    its traceback) or the launch outlives ``timeout_s`` (its processes
    are then killed).
    """
    local_ranks = list(range(nprocs) if local_ranks is None
                       else local_ranks)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="prgpt_launch_") as tmp:
        procs = []
        for rank in range(nprocs):
            rank_env = dict(
                RANK=str(rank), WORLD_SIZE=str(nprocs),
                LOCAL_RANK=str(local_ranks[rank]),
                LOCAL_WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port))
            if platform is not None:
                rank_env["PRGPT_PLATFORM"] = platform
            p = ctx.Process(
                target=_rank_main,
                args=(fn, tuple(args), rank_env, backend,
                      collective_timeout_s, threads,
                      os.path.join(tmp, f"rank-{rank}.pkl")),
                name=f"prgpt-rank-{rank}")
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [p.name for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        results, errors = [], []
        for rank, p in enumerate(procs):
            path = os.path.join(tmp, f"rank-{rank}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {rank}: no result (exit code "
                              f"{p.exitcode})")
                continue
            with open(path, "rb") as f:  # written by this launch's ranks
                status, result = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {rank}:\n{result}")
            results.append(result)
    if late:
        raise RuntimeError(f"launch of {nprocs} processes outlived its "
                           f"{timeout_s} s limit: {late} killed\n"
                           + "\n".join(errors))
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


# ---------------------------------------------------------------------------
# the dry run

def write_depth_tree(root: Path, n_frames: int = 8, seed: int = 0):
    """``n_frames`` 480x640 uint16 mm depth frames over two scenes, their
    intrinsics and the gt.log that lists them; returns (folder, gt_log)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    folder, lines = Path(root) / "rgbd", []
    yy, xx = np.mgrid[0:480, 0:640]
    for f in range(n_frames):
        scene = folder / f"scene-{f % 2}"
        seq = scene / "seq-01"
        if not seq.exists():
            seq.mkdir(parents=True)
            np.savetxt(scene / "camera-intrinsics.txt",
                       [[585.0, 0, 320.0], [0, 585.0, 240.0], [0, 0, 1]])
        depth = 2000 + 600 * np.sin(xx / 70.0 + f) * np.cos(yy / 50.0) + \
            rng.integers(0, 60, (480, 640))
        name = f"frame-{f // 2:06d}.depth.png"
        Image.fromarray(depth.astype(np.uint16)).save(seq / name)
        lines.append(f"scene-{f % 2}/seq-01/{name}")
    gt_log = Path(root) / "gt.log"
    gt_log.write_text("\n".join(lines) + "\n")
    return str(folder), str(gt_log)


def digest(*modules) -> str:
    """sha256 of every parameter's and buffer's bytes."""
    import torch

    h = hashlib.sha256()
    for m in modules:
        for t in list(m.parameters()) + list(m.buffers()):
            flat = t.detach().cpu().contiguous().reshape(-1)
            h.update(flat.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def build_trainer(folder: str, gt_log: str, results: str, *,
                  full_width: bool, global_batch: int, steps: int = 1,
                  seed: int = 0, **overrides):
    """A Trainer at ``ModelConfig()`` width (or dim 8, 32^2, fp32) on
    ``global_batch`` images a microbatch, weights from ``seed``;
    ``overrides`` replace its other arguments."""
    import torch

    from pointreggpt_tpu_torch import config as C
    from pointreggpt_tpu_torch.train.trainer import Trainer

    if full_width:
        model_cfg, diff_cfg = C.ModelConfig(), C.DiffusionConfig()
    else:
        model_cfg = C.ModelConfig(dim=8, dim_mults=(1, 2), bf16=False)
        diff_cfg = C.DiffusionConfig(image_size=32, timesteps=16,
                                     sampling_timesteps=4)
    torch.manual_seed(seed)
    kw = dict(train_batch_size=global_batch, gradient_accumulate_every=1,
              train_lr=1e-4, train_num_steps=steps,
              save_and_sample_every=10**9, results_folder=results,
              samples_folder=results, gt_log=gt_log, num_workers=2,
              ema_update_every=1, seed=seed)
    model = C.build_diffusion_unet(model_cfg)
    return Trainer(model, C.build_diffusion(diff_cfg, model), folder,
                   **dict(kw, **overrides))


def dryrun_rank(root: str, full_width: bool) -> dict:
    """One process of the dry run: a Trainer step, the digest, the scene
    range and a save into this process's own folder."""
    from pointreggpt_tpu_torch.parallel import mesh as M

    folder, gt_log = str(Path(root) / "rgbd"), str(Path(root) / "gt.log")
    rank, world = M.process_index(), M.process_count()
    results = Path(root) / f"results-{rank}"
    trainer = build_trainer(folder, gt_log, str(results),
                            full_width=full_width, global_batch=2 * world)
    t0 = time.perf_counter()
    trainer.train(log_every=1)
    step_s = time.perf_counter() - t0
    trainer.save(0)
    return dict(rank=rank, world=world, device=str(trainer.device),
                digest=digest(trainer.ema),
                scenes=list(M.local_scene_range(*SCENES)),
                wrote=sorted(p.name for p in results.glob("model-*.pt")),
                step_s=step_s)


def check_dryrun(reports: List[dict]) -> dict:
    """The launcher's three checks; returns the summary."""
    digests = {r["digest"] for r in reports}
    if len(digests) != 1:
        raise AssertionError(f"replicas differ after the step: {digests}")
    scenes = [s for r in reports for s in r["scenes"]]
    if sorted(scenes) != list(range(*SCENES)) or \
            len(scenes) != len(set(scenes)):
        raise AssertionError("scene ranges do not tile "
                             f"{SCENES}: {[r['scenes'] for r in reports]}")
    wrote = [r["wrote"] for r in reports]
    if wrote[0] != ["model-0.pt"] or any(wrote[1:]):
        raise AssertionError(f"checkpoints written per rank: {wrote}")
    return dict(processes=len(reports), digest=reports[0]["digest"][:16],
                scenes=[r["scenes"] for r in reports],
                devices=[r["device"] for r in reports],
                step_s=[r["step_s"] for r in reports])


def dryrun(nprocs: int = 2, *, full_width: bool = False,
           local_ranks: Optional[Sequence[int]] = None,
           backend: Optional[str] = None, platform: Optional[str] = None,
           timeout_s: float = 300.0) -> dict:
    """Write the tree, launch :func:`dryrun_rank` in ``nprocs`` processes
    and check their reports."""
    with tempfile.TemporaryDirectory(prefix="prgpt_dryrun_") as root:
        write_depth_tree(Path(root), n_frames=max(8, 4 * nprocs))
        reports = launch(dryrun_rank, nprocs, args=(root, full_width),
                         local_ranks=local_ranks, backend=backend,
                         platform=platform, timeout_s=timeout_s)
        return check_dryrun(reports)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--full_width", action="store_true")
    ap.add_argument("--share_card", action="store_true",
                    help="every process on cuda:0, over gloo")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    from pointreggpt_tpu_torch import resolve_device

    # raises with no card unless PRGPT_PLATFORM=cpu, which the processes
    # inherit
    resolve_device()
    out = dryrun(args.nproc, full_width=args.full_width,
                 local_ranks=[0] * args.nproc if args.share_card else None,
                 backend="gloo" if args.share_card else None,
                 timeout_s=args.timeout)
    print(json.dumps({"dryrun_multiprocess": out}))


if __name__ == "__main__":
    main()
