"""Model-FLOP utilization of generation: the least time, at the card's bf16
and TF32 peaks, of the model operations of the window's completed calls
(counted from the configuration's shapes, ``lib/flops.py``), over the
window's wall, in percent."""

from portbench.lib.readers import mfu


def read(run):
    rec = run.record
    return mfu(rec["flops"], rec["calls"], rec["wall_s"])
