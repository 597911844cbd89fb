"""Logging, running averages and the depth-correction validation metrics
(port of ``pointreggpt_tpu/train/metrics.py``)."""

from __future__ import annotations

import logging
import sys
from typing import Dict, Optional

import torch


def create_logger(log_file: Optional[str] = None,
                  name: Optional[str] = None) -> logging.Logger:
    """File or console logger. The name defaults to the destination, so a
    second Logger re-points only its own handlers."""
    if name is None:
        name = ("pointreggpt_torch.console" if log_file is None
                else f"pointreggpt_torch.file.{log_file}")
    logger = logging.getLogger(name)
    logger.handlers.clear()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    handler: logging.Handler = (logging.FileHandler(log_file)
                                if log_file is not None
                                else logging.StreamHandler(sys.stdout))
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname).4s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(handler)
    return logger


class Logger:
    """Logger wrapper that is silent off the main process."""

    def __init__(self, log_file: Optional[str] = None, is_main: bool = True):
        self.logger = create_logger(log_file) if is_main else None

    def info(self, message: str) -> None:
        if self.logger is not None:
            self.logger.info(message)

    def warning(self, message: str) -> None:
        if self.logger is not None:
            self.logger.warning(message)

    def error(self, message: str) -> None:
        if self.logger is not None:
            self.logger.error(message)


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val: float, num: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * num
        self.count += num
        self.avg = self.sum / self.count

    def __float__(self) -> float:
        return float(self.avg)


# the keys of mask_metrics, in its order
METRIC_NAMES = ("MSE", "MAE", "SAE", "mIoU", "PAcc", "FP")


def mask_metrics(input_img: torch.Tensor, label_img: torch.Tensor,
                 label_mask: torch.Tensor, output_prob: torch.Tensor, *,
                 mask_threshold: float = 0.99) -> Dict[str, torch.Tensor]:
    """Depth-correction validation metrics of each item, on its device.

    The depth errors between the input kept where the predicted
    probability passes ``mask_threshold`` and the label kept where the
    label mask does, and the 2x2 confusion matrix of the two masks: MSE,
    MAE, SAE (summed absolute error), mIoU (the nan-mean of the two
    classes' IoU, a class absent from both masks left out), PAcc and FP
    (pixels the label drops and the prediction keeps).

    Args:
        input_img / label_img: (b, ...) depths in [0, 1].
        label_mask: (b, ...) float or bool ground-truth keep mask.
        output_prob: (b, ...) predicted keep probability.

    Returns:
        dict of (b,) float32 tensors, one value per item; the JAX
        package's ``mask_metrics`` of a whole batch is this function's of
        that batch with a leading axis of 1.
    """
    b = input_img.shape[0]
    out_mask = (output_prob > mask_threshold).reshape(b, -1)
    lab_mask = (label_mask > mask_threshold).reshape(b, -1)
    zero = input_img.new_zeros(())
    out_img = torch.where(out_mask, input_img.reshape(b, -1), zero)
    lab_img = torch.where(lab_mask, label_img.reshape(b, -1), zero)

    diff = lab_img - out_img
    mse = (diff * diff).mean(dim=1)
    mae = diff.abs().mean(dim=1)
    sae = diff.abs().sum(dim=1)

    # rows: label keeps (0, 1); columns: prediction keeps (0, 1)
    idx = 2 * lab_mask.long() + out_mask.long()
    counts = torch.zeros(b, 4, dtype=torch.float32, device=idx.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
    matrix = counts.reshape(b, 2, 2)
    intersection = torch.diagonal(matrix, dim1=1, dim2=2)
    union = matrix.sum(dim=2) + matrix.sum(dim=1) - intersection
    iou = intersection / torch.where(union > 0, union,
                                     torch.full_like(union, float("nan")))
    return {"MSE": mse, "MAE": mae, "SAE": sae,
            "mIoU": torch.nanmean(iou, dim=1),
            "PAcc": intersection.sum(dim=1) / matrix.sum(dim=(1, 2)),
            "FP": matrix[:, 0, 1]}
