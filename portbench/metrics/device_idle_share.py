"""Per layer, the device: the share of the traced window in which no
kernel, memcpy or memset ran, from the union of their intervals in the
profiler's trace (work that overlaps on two streams counts once)."""
KIND = "per_layer"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "action_s"


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
