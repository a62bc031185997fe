"""Per layer, keyed fold kernels: the fold's least bytes (``work/
keyed_fold.py``, from the reference table's valid windows and distinct
keys) at the card's published HBM rate, over the segment-sum kernels'
device time per traced action (``csrc/segment_sum.cu``: the binned
route's ``segsum_*`` kernels and the atomic ``segment_sum_kernel``).

The table layout's scatters and sorts around the kernels are not counted
until the program marks the fold with a span the profiler sees.
"""
from portbench.work import keyed_fold, peaks

KIND = "per_layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "keyed fold kernels"
MOVES = "action_s"


def is_fold_kernel(name: str) -> bool:
    return name.startswith("segsum_") or name == "segment_sum_kernel"


def read(run):
    t, work = run.trace, run.work
    rate = peaks.peak(run.device_kind, "hbm_bytes_per_s")
    if t is None or rate is None or "windows" not in work:
        return None
    fold_s = t.seconds(is_fold_kernel) / t.actions
    if fold_s <= 0:
        return None
    least_s = keyed_fold.least_bytes(work["windows"], work["distinct"]) \
        / rate
    return 100.0 * least_s / fold_s
