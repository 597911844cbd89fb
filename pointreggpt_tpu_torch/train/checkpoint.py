"""Checkpoints in the reference ``.pt`` layout, written atomically.

The diffusion trainer saves ``{step, model, opt, ema, version}`` to
``model-{milestone}.pt``: the U-Net under ``model.``, the torch Adam
``state_dict`` under ``opt``, and the EMA's state dict, whose U-Net sits
under ``ema_model.model.`` (the reference's EMA wraps its
GaussianDiffusion, whose ``model`` is the U-Net). ``Generator.load`` reads
the same files. The MaskTrainer saves ``{epoch, model, opt, loss_hist,
best_metrics}``, its MaskUNet under ``model`` with no prefix, which
``Generator`` reads from ``model-best.pt``.

A write goes to a temporary file, is flushed and fsynced, and replaces the
target with ``os.replace``; the directory is fsynced after, so a crash
leaves the old checkpoint or the new one, never a torn or empty file.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from pointreggpt_tpu_torch.utils.jax_params import load_reference_checkpoint

PathLike = Union[str, os.PathLike]


def save_checkpoint(path: PathLike, payload: Dict[str, Any]) -> None:
    """``torch.save`` ``payload`` to ``path`` atomically and durably."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # a file system without directory fsync
        pass


def load_checkpoint(path: PathLike) -> Dict[str, Any]:
    """Read a checkpoint onto the CPU (weights-only unpickling)."""
    return load_reference_checkpoint(path)


def latest_milestone(results_folder: PathLike,
                     prefix: str = "model-") -> Optional[str]:
    """The milestone name of the newest ``{prefix}*.pt`` in a folder."""
    folder = Path(results_folder)
    if not folder.exists():
        return None
    paths = sorted(folder.glob(f"{prefix}*.pt"),
                   key=lambda p: p.stat().st_mtime)
    return paths[-1].stem[len(prefix):] if paths else None
