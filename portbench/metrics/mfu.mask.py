"""Model-FLOP utilization of training: the least time, at the card's
peaks, of the window's steps' model operations (the forward from the
configuration's shapes, ``lib/flops.py``, the backward twice that, no
recompute) over the window's wall, in percent."""

from portbench.lib.readers import mfu


def read(run):
    rec = run.record
    return mfu(rec["flops_per_step"], rec["steps"], rec["wall_s"])
