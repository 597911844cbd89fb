"""Logging and running averages (port of the first half of
``pointreggpt_tpu/train/metrics.py``; ``mask_metrics`` comes with the mask
trainer)."""

from __future__ import annotations

import logging
import sys
from typing import Optional


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
