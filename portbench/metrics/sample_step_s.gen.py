"""Seconds of a sample step (``Generator.step``): the median over the window
of the CUDA-event time around each step."""

from portbench.lib.readers import median


def read(run):
    return median(run.record["step_s"])
