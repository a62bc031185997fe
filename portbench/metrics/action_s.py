"""End-to-end: the window's seconds over the actions completed in it.

The window runs from the first action's issue to the last one's answer
on the host, so it holds all the work and all the time between actions.
"""
KIND = "end_to_end"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.window_s / len(run.walls) if run.walls else None
