"""End-to-end: ``torch.cuda.max_memory_allocated()`` over the window, its
peak reset after warm-up, in GiB.  The resident dataset is included, so
memory traded for speed shows."""
KIND = "end_to_end"
UNIT = "GiB"
BETTER = "lower"
SOURCE = "device_trace"


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.window_peak_bytes \
        else None
