"""Per layer, the LM's prefill: the mean over the window's actions of the
program's ``prefill`` phase (``launch.serve.greedy_request``): host time
from the request's start to the end of the prefill's last launch on the
device, the waits for the MoE's expert sizes inside it included."""
KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "LM prefill and decode"
MOVES = "action_s"


def read(run):
    got = [r["phases"]["prefill"] for r in run.reports
           if "prefill" in r["phases"]]
    return 1e3 * sum(got) / len(got) if got else None
