"""Per layer, runtime: the mean over the window's actions of the
program's ``dispatch`` phase (``ActionReport.phases``): host time to
enqueue the action's work, host reads inside it included."""
KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "runtime"
MOVES = "action_s"


def read(run):
    got = [r["phases"]["dispatch"] for r in run.reports
           if "dispatch" in r["phases"]]
    return 1e3 * sum(got) / len(got) if got else None
