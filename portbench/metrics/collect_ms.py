"""Per layer, result gather: the mean over the window's actions of the
action's wall on the benchmark's clock minus the program's own
``ActionReport.wall_s``: the gather and copy of the result to the host
after the executor returns."""
KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "result gather"
MOVES = "action_s"


def read(run):
    got = [w - r["wall_s"] for w, r in zip(run.walls, run.reports)]
    return 1e3 * sum(got) / len(got) if got else None
