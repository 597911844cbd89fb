"""The inputs a cell feeds the port, written from ``--seed`` under the run's
own directory: copies of ``chip_smoke.py``'s synthetic 3DMatch trees
(``write_synthetic_tree``, ``write_training_tree``, ``write_mask_pairs``)
with their sizes taken from the traffic file, and the weights saved where
the port's loaders read them.
"""

from __future__ import annotations

import json
import pickle
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
from PIL import Image

K_MATRIX = np.array([[585.0, 0, 320.0], [0, 585.0, 240.0], [0, 0, 1]])


def _rng(seed: int, *tag: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *tag])


def _save_all(jobs) -> None:
    """Encode and write (array, path) pairs on a few threads (PNG
    encoding releases the interpreter lock)."""
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda j: Image.fromarray(j[0]).save(j[1]), jobs))


def scene_pool(root: Path, n_scenes: int, height: int, width: int,
               seed: int):
    """A 3DMatch-style pool: per scene one uint16 mm depth frame (around
    2-2.8 m), its intrinsics and info files, and the ``train_info`` pool
    that lists every scene as both source and target. Returns (rgbd root,
    info root, the pool as a dict)."""
    rng = _rng(seed, 1)
    rgbd, indoor = root / "rgbd", root / "indoor"
    info = {"src": [], "tgt": []}
    yy, xx = np.mgrid[0:height, 0:width]
    jobs = []
    for s in range(n_scenes):
        name = f"scene-{s}"
        seq = rgbd / name / "seq-01"
        seq.mkdir(parents=True)
        np.savetxt(rgbd / name / "camera-intrinsics.txt", K_MATRIX)
        phase = rng.uniform(0, 2 * np.pi)
        depth = 2000 + 400 * np.sin(xx / 90.0 + phase) * np.cos(yy / 70.0) \
            + rng.integers(0, 40, (height, width))
        jobs.append((depth.astype(np.uint16), seq / "frame-000000.depth.png"))
        np.savetxt(seq / "frame-000000.pose.txt", np.eye(4))
        (indoor / name).mkdir(parents=True)
        for role in ("src", "tgt"):
            (indoor / name / f"{role}.info.txt").write_text(
                f"{name} seq-01 0 0\n")
            info[role].append(f"{name}/{role}.pth")
    _save_all(jobs)
    with open(root / "train_info.pkl", "wb") as f:
        pickle.dump(info, f)
    return rgbd, indoor, info


def training_tree(root: Path, n_frames: int, distinct: int, height: int,
                  width: int, seed: int):
    """A 3DMatch-RGBD-style training tree: ``n_frames`` uint16 mm frames
    over 4 scenes, their intrinsics, and the gt.log that lists them. The
    first ``distinct`` frames are drawn; the others copy their files in
    turn (the loader decodes each file all the same, and set-up stays
    short). Returns (folder, gt_log)."""
    rng = _rng(seed, 2)
    folder, lines, jobs = root / "rgbd_train", [], []
    yy, xx = np.mgrid[0:height, 0:width]
    paths = []
    for f in range(n_frames):
        scene = folder / f"scene-{f % 4}"
        seq = scene / "seq-01"
        if not seq.exists():
            seq.mkdir(parents=True)
            np.savetxt(scene / "camera-intrinsics.txt", K_MATRIX)
        name = f"frame-{f // 4:06d}.depth.png"
        paths.append(seq / name)
        lines.append(f"scene-{f % 4}/seq-01/{name}")
        if f < distinct:
            phase = rng.uniform(0, 2 * np.pi)
            depth = 2000 + 600 * np.sin(xx / 70.0 + phase) * \
                np.cos(yy / 50.0) + rng.integers(0, 60, (height, width))
            jobs.append((depth.astype(np.uint16), paths[-1]))
    _save_all(jobs)
    for f in range(distinct, n_frames):
        shutil.copyfile(paths[f % distinct], paths[f])
    gt_log = root / "gt.log"
    gt_log.write_text("\n".join(lines) + "\n")
    return str(folder), str(gt_log)


def mask_pairs(root: Path, n_train: int, n_val: int, distinct: int,
               size: int, seed: int) -> str:
    """A depth-correction pair root (``data/*.depth.png``,
    ``metadata/{train,val}.json``) of uint16 mm frames, each label the
    input plus a few mm of noise and large offsets on some pixels. The
    first ``distinct`` training pairs are drawn and the others list their
    files in turn (the loader decodes each all the same, and set-up stays
    short); the validation pairs are drawn."""
    rng = _rng(seed, 3)
    (root / "data").mkdir(parents=True)
    (root / "metadata").mkdir()
    jobs = []
    for subset, count, drawn in (("train", n_train, min(distinct, n_train)),
                                 ("val", n_val, n_val)):
        entries = []
        for i in range(drawn):
            base = rng.integers(500, 9000, (size, size))
            label = base + rng.integers(0, 30, base.shape)
            off = rng.uniform(size=base.shape) < 0.3
            label[off] += rng.integers(60, 2000, int(off.sum()))
            names = (f"{subset}-{i:06d}-input.depth.png",
                     f"{subset}-{i:06d}-label.depth.png")
            for name, a in zip(names, (base, label)):
                jobs.append((a.astype(np.uint16), root / "data" / name))
            entries.append({"input_path": names[0], "label_path": names[1]})
        entries = [entries[i % drawn] for i in range(count)]
        (root / "metadata" / f"{subset}.json").write_text(
            json.dumps(entries))
    _save_all(jobs)
    return str(root)


def save_diffusion_checkpoint(path: Path, sd: dict) -> None:
    """A diffusion milestone in the reference layout, read by
    ``Generator.load``: the EMA's U-Net under ``ema_model.model.``."""
    import torch

    host = {k: v.detach().cpu() for k, v in sd.items()}
    ema = {f"ema_model.model.{k}": v for k, v in host.items()}
    ema["initted"] = torch.tensor(True)
    ema["step"] = torch.tensor(0)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"step": 0, "ema": ema}, path)


def save_mask_checkpoint(path: Path, sd: dict) -> None:
    """A depth-correction ``model-best.pt`` ({epoch, model})."""
    import torch

    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"epoch": 0,
                "model": {k: v.detach().cpu() for k, v in sd.items()}}, path)
