"""Block-size and layout helpers shared by the port's kernels and host
code (the reference's ``kernels/common.py`` without its TPU constants)."""
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


def row_stride(x) -> int:
    """The row stride of x [B, T, d] whose rows a kernel reads in place:
    the last dimension contiguous, rows ``stride(1)`` apart and batch rows
    ``T * stride(1)`` apart (as in a slice of a contiguous [B, T, w >= d]
    tensor); raises otherwise."""
    b, t, d = x.shape
    s = x.stride(1) if t > 1 else (x.stride(0) if b > 1 else d)
    if x.stride(2) != 1 or s < d or (b > 1 and x.stride(0) != t * s):
        raise ValueError(f"rows of [B, T, d] {tuple(x.shape)} with strides "
                         f"{x.stride()}: the last dimension contiguous and "
                         f"the rows of a [B, T, w >= d] tensor")
    return s
