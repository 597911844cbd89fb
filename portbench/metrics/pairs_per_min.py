"""Pairs a generation job writes per minute: 60 x the pairs of the window's
completed ``Generator.generate`` calls over the wall seconds from the first
call's start to the last call's end (host clock)."""

from portbench.lib.readers import per_s


def read(run):
    rate = per_s(run.record.get("pairs", 0), run.record["wall_s"])
    return None if rate is None else 60.0 * rate
