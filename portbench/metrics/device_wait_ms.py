"""Per layer, runtime: the mean over the window's actions of the
program's ``device_wait`` phase: the host waiting for the action's last
launch to finish on the device."""
KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "runtime"
MOVES = "action_s"


def read(run):
    got = [r["phases"]["device_wait"] for r in run.reports
           if "device_wait" in r["phases"]]
    return 1e3 * sum(got) / len(got) if got else None
