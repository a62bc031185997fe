"""Plain PyTorch exchange: the oracle and the CUDA kernel's plain version,
with the 32-bit hash the kernel computes on the card.

Hashes are 32-bit unsigned values.  Torch has no full uint32 arithmetic,
so :func:`hash_keys` works in int64 and masks to the low 32 bits; every
multiply is split so no intermediate leaves int64 range.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``: the
    multiply is split into 16-bit halves of ``c`` so no product exceeds
    2**48 (a plain int64 product with c >= 2**31 would overflow)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash_keys(keys: torch.Tensor) -> torch.Tensor:
    """Deterministic 32-bit integer mix (splitmix32-style) — the
    HashPartitioner.  Accepts any integer dtype; returns the reference's
    uint32 hash values in an int64 tensor."""
    x = keys.to(torch.int64) & _MASK32      # astype(uint32): wrap negatives
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


class Exchanged(NamedTuple):
    """What an exchange of n sources hands the n destinations: leaf l of
    destination d is ``leaves[l][d]``, ``[n * capacity, ...]``, its
    received rows first and zeros after."""

    leaves: List[torch.Tensor]   # [n, n * capacity, ...] a leaf
    counts: torch.Tensor         # [n] int32 rows each destination received
    send_counts: torch.Tensor    # [n, n] int32: [s, d] rows s sent to d
    dropped: torch.Tensor        # [n] int32 rows each source lost


def exchange_ref(leaves: Sequence[Sequence[torch.Tensor]],
                 counts: Sequence[torch.Tensor], capacity: int,
                 dests: Sequence[torch.Tensor]) -> Exchanged:
    """``leaves[s]``: source s's leaves, each ``[cap_in, ...]``, its first
    ``counts[s]`` rows valid; ``dests[s]`` ``[cap_in]`` each row's
    destination (one outside ``[0, n)`` matches none: neither sent nor
    dropped).

    Destination d receives, for s = 0 .. n-1 in order, the first
    ``min(count[s][d], capacity)`` of source s's valid rows bound for d,
    in source order; its rows after them are zeros.  Each source's rows
    are sorted stably by destination, so a row's rank within its
    destination is its place in the sorted run; a rank below
    ``capacity`` puts the row at the sum of the earlier sources' rows at
    that destination plus its rank.
    """
    n = len(dests)
    dev = dests[0].device
    cap_in = dests[0].shape[0]
    rows = torch.arange(cap_in, device=dev)
    bounds = torch.arange(n + 1, device=dev)
    orders, sorted_dests, ranks, sizes = [], [], [], []
    for s in range(n):
        d = dests[s].to(torch.int64)
        ok = (rows < counts[s]) & (d >= 0) & (d < n)
        d = torch.where(ok, d, n)
        order = torch.sort(d, stable=True).indices
        d = d[order]
        start = torch.searchsorted(d, bounds)
        orders.append(order)
        sorted_dests.append(d)
        ranks.append(rows - start[d])
        sizes.append(start[1:] - start[:-1])
    size = torch.stack(sizes)                      # [source, destination]
    send = size.clamp(max=capacity)
    base = torch.cumsum(send, 0) - send            # earlier sources' rows
    out_rows = n * capacity
    outs = []
    for l, like in enumerate(leaves[0]):
        # one spare row past every destination's takes the rows not kept
        flat = like.new_zeros((n * out_rows + 1,) + tuple(like.shape[1:]))
        for s in range(n):
            d, rank = sorted_dests[s], ranks[s]
            keep = (d < n) & (rank < capacity)
            dc = d.clamp(max=n - 1)
            at = torch.where(keep, dc * out_rows + base[s][dc] + rank,
                             n * out_rows)
            flat[at] = leaves[s][l][orders[s]]
        outs.append(flat[:n * out_rows].reshape(
            (n, out_rows) + tuple(like.shape[1:])))
    return Exchanged(leaves=outs, counts=send.sum(0).to(torch.int32),
                     send_counts=send.to(torch.int32),
                     dropped=(size - send).sum(1).to(torch.int32))
