"""The work of each kernel's function: its operations and the bytes it
must move, one formula a kernel, and the least time an H100 could take
for it.

A formula counts the function, whatever route computes it: each input
read once and each output written once, and the operations its inputs
need (a masked pair or a step the mask drops is not counted).  The
kernels' wrappers report these numbers to the active work counter
(:mod:`repro_torch.launch.hlo_cost`) for every call they take on a CUDA
or a meta tensor; ``chip_smoke.py`` divides them by the card's rates for
the bound it prints beside each kernel's time.

Rates: NVIDIA H100 SXM 80GB data sheet — HBM3 at 3.35 TB/s, 989 TFLOP/s
of dense bf16 on the tensor cores, 67 TFLOP/s of float32 on the CUDA
cores (the rate integer and compare work is bounded by here too), and
NVLink 4 at 450 GB/s in one direction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
LINK_BYTES_PER_S = 450e9

#: Steps of the SSM scan's chunks (``CHUNK`` in ``csrc/ssm_scan.cu``): the
#: forward saves the state entering every chunk but the first.
SSM_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class Work:
    """``ops`` operations at ``rate`` a second, and ``nbytes`` moved."""

    ops: int
    nbytes: int
    rate: float

    def bound(self) -> Tuple[float, str]:
        """(least ms, "operations" or "bytes"): the larger of the bytes
        over HBM bandwidth and the operations over their peak rate."""
        t_ops = self.ops / self.rate
        t_bytes = self.nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")


def _peak(itemsize: int) -> float:
    return BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S


def flash_pairs(sq: int, sk: int, causal: bool,
                window: Optional[int]) -> int:
    """(query, key) pairs the mask keeps, per head: queries right-aligned
    to the keys, a causal or windowed mask as the kernel's."""
    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    masked = causal or window is not None
    hi = np.minimum(qpos + 1, sk) if masked else np.full(sq, sk)
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.clip(hi - lo, 0, None).sum())


def flash(bh: int, group: int, sq: int, sk: int, d: int, causal: bool,
          window: Optional[int], itemsize: int, lse: bool = False) -> Work:
    """Attention over q [bh, sq, d] and k, v [bh / group, sk, d]: q.k and
    p.v over the kept pairs (4 d operations a pair) at the tensor cores'
    peak for the inputs' type; q, k, v read once, o written once (and the
    rows' float32 log-sum-exp with ``lse``)."""
    bkv = bh // group
    ops = 4 * d * bh * flash_pairs(sq, sk, causal, window)
    nbytes = itemsize * d * (2 * bh * sq + 2 * bkv * sk) \
        + (4 * bh * sq if lse else 0)
    return Work(ops, nbytes, _peak(itemsize))


def flash_bwd(bh: int, group: int, sq: int, sk: int, d: int, causal: bool,
              window: Optional[int], itemsize: int,
              per_pair: int = 10) -> Work:
    """Attention's gradient: five products of 2 d operations a kept pair
    (``per_pair`` = 10; 14 gives the floor of a design that recomputes S
    and dP in two passes) at the tensor cores' peak for the inputs' type;
    q, k, v, o, do and lse read once, dq, dk, dv written once."""
    bkv = bh // group
    ops = per_pair * d * bh * flash_pairs(sq, sk, causal, window)
    nbytes = (itemsize * d * (3 * bh * sq + 2 * bkv * sk) + 4 * bh * sq
              + itemsize * d * (bh * sq + 2 * bkv * sk))
    return Work(ops, nbytes, _peak(itemsize))


def ssm_row_floats(n: int) -> int:
    """Floats a step of the scan's saved projection rows holds: B, C and
    dt in slots of n rounded up to 4, 8, 16 or 32, padded to a 16-byte
    row."""
    slots = 4 if n <= 4 else 8 if n <= 8 else 16 if n <= 16 else 32
    return 2 * slots + 4


def ssm(b: int, t: int, d: int, n: int, itemsize: int,
        save: bool = False) -> Work:
    """The selective scan over xc [b, t, d] with n states a channel: xc
    and x_proj read once (their type), dt_bias, a_log and h0 once, y and h
    written once (float32), and with ``save`` the projection rows and the
    chunk-entering states the backward starts from; the operations at the
    CUDA cores' float32 peak: 2 a multiply-add of the projection (2n+1
    columns), 5 a channel and step (dt * x and softplus's add, exp, log1p,
    max) and 7 a state and step (-A * dt, exp, dt * x * B, a * h + bx,
    h * C summed)."""
    cols = 2 * n + 1
    nbytes = (itemsize * (b * t * d + d * cols) + 4 * (d + d * n + b * d * n)
              + 4 * (b * t * d + b * d * n))
    if save:
        ends = -(-t // SSM_CHUNK) - 1
        nbytes += 4 * (b * t * ssm_row_floats(n) + b * ends * n * d)
    ops = 2 * b * t * d * cols + 5 * b * t * d + 7 * b * t * d * n
    return Work(ops, nbytes, F32_FLOP_PER_S)


def ssm_dt(b: int, t: int, d: int, n: int, itemsize: int) -> Work:
    """The selective scan's dt route over u [b, t, d] with dt a channel
    and step and B, C [b, t, n] given: u, dt, B and C read once (their
    type), dt_bias, a_log and h0 once, y and h written once (float32); the
    operations at the CUDA cores' float32 peak: 5 a channel and step
    (softplus's add, exp, log1p, max, dt * u) and 7 a state and step (as
    :func:`ssm`)."""
    nbytes = (itemsize * (2 * b * t * d + 2 * b * t * n)
              + 4 * (d + d * n + b * d * n) + 4 * (b * t * d + b * d * n))
    return Work(5 * b * t * d + 7 * b * t * d * n, nbytes, F32_FLOP_PER_S)


def ssm_bwd(b: int, t: int, d: int, n: int, itemsize: int) -> Work:
    """The scan's gradient: xc, x_proj, dt_bias, a_log, h0, dy, dh and the
    forward's saved projection rows and chunk-entering states read once,
    dxc, dx_proj, ddt_bias, da_log and dh0 written once; the operations at
    the CUDA cores' float32 peak: the forward's 7 a state-step re-run (see
    :func:`ssm`) and 15 a state-step back (lam, a, a h, the carry, dA,
    sum lam B, sum q A, dB and dC), 15 a channel-step (softplus, sigmoid,
    ddt, dz, dx) and 4 (2n + 1) a channel-step for dxc and dx_proj."""
    cols = 2 * n + 1
    ends = -(-t // SSM_CHUNK) - 1
    rows = b * t
    nbytes = (2 * itemsize * (rows * d + d * cols)
              + 4 * 2 * (d + d * n + b * d * n)
              + 4 * (rows * d + b * d * n)
              + 4 * (rows * ssm_row_floats(n) + b * ends * n * d))
    ops = rows * d * (22 * n + 15 + 4 * cols)
    return Work(ops, nbytes, F32_FLOP_PER_S)


def rmsnorm(rows: int, d: int, itemsize: int) -> Work:
    """x read once, w read once, out written once; ~4 operations an
    element at the float32 peak."""
    return Work(4 * rows * d, itemsize * (2 * rows * d + d), F32_FLOP_PER_S)


def dispatch(n: int, groups: int) -> Work:
    """n ids read, n positions and ``groups`` counts written; one compare
    and one add an id."""
    return Work(2 * n, 4 * (2 * n + groups), F32_FLOP_PER_S)


def topk(n: int, k: int) -> Work:
    """n scores and the valid count read, k values and indices written;
    one compare a score."""
    return Work(n, 4 * n + 8 * k + 4, F32_FLOP_PER_S)


def segment_sum(n: int, n_valid: int, d: int, num_keys: int) -> Work:
    """Every valid flag (1 B) read, the key (4 B) and d values (4 B each)
    of each valid record read once, the table, the counts and the
    overflow word written once; d + 1 adds a valid record."""
    nbytes = n + n_valid * (4 + 4 * d) + num_keys * (4 * d + 4) + 4
    return Work(n_valid * (d + 1), nbytes, F32_FLOP_PER_S)


__all__ = ["BF16_FLOP_PER_S", "F32_FLOP_PER_S", "HBM_BYTES_PER_S",
           "LINK_BYTES_PER_S", "SSM_CHUNK", "Work", "dispatch", "flash",
           "flash_bwd", "flash_pairs", "rmsnorm", "segment_sum", "ssm",
           "ssm_bwd", "ssm_row_floats", "topk"]
