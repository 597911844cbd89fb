"""Depth-correction training images per second: the images of the window's optimizer steps
over its wall seconds, the last step's end included (host clock)."""

from portbench.lib.readers import per_s


def read(run):
    return per_s(run.record.get("images", 0), run.record["wall_s"])
