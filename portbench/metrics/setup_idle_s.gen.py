"""Device-idle seconds of the traced ``generate`` call inside the port's
``scene_setup`` and ``chunk_upload`` spans (the chunk's host set-up and
its upload)."""

from portbench.lib.port_spans import idle_s


def read(run):
    return idle_s(run, ("scene_setup", "chunk_upload"))
