"""Share of the traced window in which no device activity ran."""

from portbench.lib.readers import idle_share


def read(run):
    return idle_share(run.trace)
