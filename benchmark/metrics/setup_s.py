"""End to end: process start to the first timed call (imports, the
kernels' library found or built, the tables made, one network to warm
up)."""


def read(run):
    return run.setup_s
