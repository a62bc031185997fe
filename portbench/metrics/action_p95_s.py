"""End-to-end: the 95th percentile of every window action's wall, from
its issue to its answer on the host (numpy's linear interpolation over
all of them, not a median of chunks)."""
import numpy as np

KIND = "end_to_end"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return float(np.percentile(run.walls, 95)) if run.walls else None
