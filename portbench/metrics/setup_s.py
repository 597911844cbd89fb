"""Set-up: process start to the first timed call (imports, the kernels'
load, seeded weights, synthetic inputs, warm-up; host clock)."""


def read(run):
    return run.setup_s
