"""Block-size helpers shared by the port's kernels and host code (the
reference's ``kernels/common.py`` without its TPU constants)."""
from __future__ import annotations


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pick_block(n: int, preferred: int, align: int = 128) -> int:
    """Largest ``align``-aligned block <= preferred that does not over-pad
    n; blocks of at most ``align`` rows round up to a multiple of 8."""
    if n <= align:
        return round_up(max(n, 1), 8)
    b = min(preferred, round_up(n, align))
    while b > align and round_up(n, b) - n >= b // 2:
        b //= 2
    return max(align, b)


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b
