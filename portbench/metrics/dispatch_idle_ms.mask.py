"""Device-idle milliseconds per traced step inside the port's
``train_step`` spans (``MaskTrainer.train_step``: forward, backward,
all-reduce, clip, Adam) and so their children."""

from portbench.lib.port_spans import idle_ms_per


def read(run):
    return idle_ms_per(run, ("train_step",), "train_step")
