"""Per layer, the LM's decode: the mean over the window's actions of the
program's ``decode`` phase (``launch.serve.greedy_request``: the decode
steps' host time, their host reads included) over the steps an action
decodes (``work["decode_tokens"]``)."""
KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "LM prefill and decode"
MOVES = "action_s"


def read(run):
    steps = run.work.get("decode_tokens") if run.work else None
    got = [r["phases"]["decode"] for r in run.reports
           if "decode" in r["phases"]]
    if not got or not steps:
        return None
    return 1e3 * sum(got) / len(got) / steps
