"""The least bytes a keyed sum of (key, count) pairs has to move.

Frozen here so that a change to a kernel, or to the program's own work
counter (``kernels/work.py``), cannot move what the keyed fold's roofline
divides by.  It counts the work that the data needs, whatever kernel or
how many passes implement the fold: each valid (int32 key, int32 count)
pair read once, and each result row (int32 key, int32 sum, int32 count)
written once.
"""
from __future__ import annotations

PAIR_BYTES = 8
ROW_BYTES = 12


def least_bytes(windows: int, distinct: int) -> int:
    """Bytes of a fold of ``windows`` pairs into ``distinct`` rows."""
    return PAIR_BYTES * windows + ROW_BYTES * distinct
