"""Share of the traced training steps's kernel time in glue: kernels that
are neither the port's hand-written ones nor library convolutions and
matrix products (``lib/trace.py``'s name table)."""


def read(run):
    return None if run.trace is None else run.trace.share("glue")
