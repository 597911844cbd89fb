"""Device-idle milliseconds per traced step inside the port's ``upload``
(``Trainer._upload``) and ``loader_wait`` (the consumer's wait on the
loader's queue) spans; steps are the port's ``train_step`` spans."""

from portbench.lib.port_spans import idle_ms_per


def read(run):
    return idle_ms_per(run, ("upload", "loader_wait"), "train_step")
