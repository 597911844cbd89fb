"""Share of the traced depth-correction steps' kernel time in library
convolutions and matrix products (cuDNN, cuBLAS)."""


def read(run):
    return None if run.trace is None else run.trace.share("library")
