"""The least work of the selective scan's dt route (the published Mamba-1
scan with dt a channel and B, C given).

Frozen here so that a change to a kernel, or to the program's own work
counter (``kernels/work.py``), cannot move what the scan's roofline
divides by.  It counts the work the function needs, whatever kernel or
how many passes compute it: u and dt ([b, t, d]) and B and C ([b, t, n])
read once in their type, dt_bias, a_log and h0 read once and y and the
final h written once in float32; and the operations at the CUDA cores'
float32 rate, 5 a channel and step (softplus's add, exp, log1p and max,
and dt * u) and 7 a state and step (-A * dt, exp, dt * u * B, a * h + bx,
h * C summed).
"""
from __future__ import annotations


def least_bytes(b: int, t: int, d: int, n: int, itemsize: int) -> int:
    return (itemsize * (2 * b * t * d + 2 * b * t * n)
            + 4 * (d + d * n + b * d * n) + 4 * (b * t * d + b * d * n))


def operations(b: int, t: int, d: int, n: int) -> int:
    return 5 * b * t * d + 7 * b * t * d * n


def least_seconds(calls, hbm_bytes_per_s: float, fp32_flops: float
                  ) -> float:
    """The sum over ``calls`` ([b, t, d, n, itemsize, count] each) of the
    larger of a call's bytes at ``hbm_bytes_per_s`` and its operations at
    ``fp32_flops``, times its count."""
    return sum(count * max(least_bytes(b, t, d, n, item) / hbm_bytes_per_s,
                           operations(b, t, d, n) / fp32_flops)
               for b, t, d, n, item, count in calls)
