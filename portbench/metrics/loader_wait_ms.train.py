"""Milliseconds a training step waited for its batch: the mean over the
window of the span around ``next(loader)``."""

from portbench.lib.readers import mean


def read(run):
    m = mean(run.record["loader_wait_s"])
    return None if m is None else 1e3 * m
