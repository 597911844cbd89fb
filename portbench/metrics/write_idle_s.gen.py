"""Device-idle seconds of the traced ``generate`` call inside the port's
``host_write`` spans (the wait on a step's copies, the PNGs and poses, the
fragment's voxel downsample and PLY)."""

from portbench.lib.port_spans import idle_s


def read(run):
    return idle_s(run, ("host_write",))
