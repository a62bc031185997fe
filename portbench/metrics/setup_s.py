"""End-to-end: seconds from the process's start to the window's: imports,
the data made from the seed and loaded, kernels built or loaded from the
build cache, and the warm-up actions."""
KIND = "end_to_end"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
