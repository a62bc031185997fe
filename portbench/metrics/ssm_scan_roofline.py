"""Per layer, the SSM scan kernels: the least time of an action's scan
calls (``work/ssm_scan.py``: each call's bytes at the card's published
HBM rate or its operations at its float32 rate, whichever is larger; the
calls from ``work["ssm_scan"]``) over the scan kernels' device time per
traced action (``csrc/ssm_scan.cu``: every kernel whose name starts with
``ssm_``).  None where the trace holds no scan kernel."""
from portbench.work import peaks, ssm_scan

KIND = "per_layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "SSM scan kernels"
MOVES = "action_s"


def is_scan_kernel(name: str) -> bool:
    return name.startswith("ssm_")


def read(run):
    t, work = run.trace, run.work or {}
    hbm = peaks.peak(run.device_kind, "hbm_bytes_per_s")
    f32 = peaks.peak(run.device_kind, "fp32_flops")
    if t is None or hbm is None or f32 is None or "ssm_scan" not in work:
        return None
    scan_s = t.seconds(is_scan_kernel) / t.actions
    if scan_s <= 0:
        return None
    return 100.0 * ssm_scan.least_seconds(work["ssm_scan"], hbm, f32) \
        / scan_s
