"""Host seconds of a generation chunk that the card did not cover: the
median over the window's calls of the call's wall less its sample steps'
event time (scene set-up, the first queueing, the writes left after the
last step)."""

from portbench.lib.readers import median


def read(run):
    rec = run.record
    n = rec["steps_per_call"]
    steps = rec["step_s"]
    if not steps:
        return None
    host = [c - sum(steps[i * n:(i + 1) * n])
            for i, c in enumerate(rec["chunk_s"])]
    return median(host)
