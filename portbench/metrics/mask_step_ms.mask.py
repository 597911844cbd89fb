"""Milliseconds of an optimizer step: the median over the window of the
CUDA-event time around each ``train_step``."""

from portbench.lib.readers import median


def read(run):
    m = median(run.record["step_s"])
    return None if m is None else 1e3 * m
