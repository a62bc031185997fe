"""Plain PyTorch segment reduce: the oracle and the CPU path.

All functions aggregate records into a bounded, direct-indexed key table:
record ``i`` with key ``k`` contributes ``values[i]`` to table row ``k``
under a monoid (sum / max / min).  Records whose key falls outside
``[0, num_keys)`` are *counted* into an overflow scalar and excluded from
the table — the caller surfaces the counter through the planner's
one-sync-per-action error channel instead of silently corrupting rows.

* :func:`segment_reduce_ref` handles every monoid over a value pytree
  (``scatter_add_`` / ``scatter_reduce_`` per leaf into a
  sentinel-extended table).
* :func:`segment_sum_ref` is the plain version of the CUDA segment-sum
  kernel (``kernel.py``) with the kernel's exact signature — one
  ``[n, d]`` value matrix — as a thin call into
  :func:`segment_reduce_ref`.  The CPU path and the on-card comparison
  use it.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import tree

MONOIDS = ("sum", "max", "min")


class SegmentReduceResult(NamedTuple):
    values: Any              # pytree of [num_keys, ...] aggregate tables
    counts: torch.Tensor     # [num_keys] int32, records folded into each key
    overflow: torch.Tensor   # int32 scalar, valid records with out-of-range keys


def monoid_identity(op: str, dtype: torch.dtype):
    """The monoid's identity element for ``dtype`` (a Python scalar)."""
    if op == "sum":
        return 0
    if op not in ("max", "min"):
        raise ValueError(f"unknown segment-reduce op {op!r}; "
                         f"expected {MONOIDS}")
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    if dtype == torch.bool:
        return op == "min"
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def _ok_idx_overflow(keys: torch.Tensor, num_keys: int,
                     valid: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared masking: validity x range check, sentinel index, overflow."""
    keys = keys.to(torch.int32)
    if valid is None:
        valid = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    in_range = (keys >= 0) & (keys < num_keys)
    ok = valid & in_range
    overflow = (valid & ~in_range).sum().to(torch.int32)
    # out-of-range / invalid records go to a sentinel row, sliced off
    idx = torch.where(ok, keys, torch.full_like(keys, num_keys)).long()
    return ok, idx, overflow


def segment_sum_ref(keys: torch.Tensor, values: torch.Tensor, num_keys: int,
                    valid: torch.Tensor):
    """Plain version of the segment-sum kernel.

    ``keys`` [n] int32, ``values`` [n, d], ``valid`` [n] bool ->
    ``(table [num_keys, d] values.dtype, counts [num_keys] int32,
    overflow [1] int32)``.
    """
    (table,), counts, overflow = segment_reduce_ref(keys, (values,), num_keys,
                                                    valid=valid)
    return table, counts, overflow.reshape(1)


def segment_reduce_ref(keys: torch.Tensor, values: Any, num_keys: int,
                       op: str = "sum",
                       valid: Optional[torch.Tensor] = None
                       ) -> SegmentReduceResult:
    """Scatter-accumulate ``values`` into a ``[num_keys, ...]`` table.

    ``keys``: int [n]; ``values``: pytree of ``[n, ...]`` tensors;
    ``valid``: bool [n] (entries beyond a partition's count).  Rows of
    absent keys hold the monoid identity; use ``counts > 0`` to find
    present keys.
    """
    if op not in MONOIDS:
        raise ValueError(f"unknown segment-reduce op {op!r}; "
                         f"expected {MONOIDS}")
    ok, idx, overflow = _ok_idx_overflow(keys, num_keys, valid)
    dev = keys.device
    counts = torch.zeros(num_keys + 1, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))

    def reduce_leaf(leaf):
        ident = monoid_identity(op, leaf.dtype)
        okb = ok.reshape((-1,) + (1,) * (leaf.ndim - 1))
        contrib = torch.where(okb, leaf, torch.full((), ident,
                                                    dtype=leaf.dtype,
                                                    device=dev))
        tab = torch.full((num_keys + 1,) + tuple(leaf.shape[1:]), ident,
                         dtype=leaf.dtype, device=dev)
        index = idx.reshape((-1,) + (1,) * (leaf.ndim - 1)).expand(
            leaf.shape)
        if op == "sum":
            tab.scatter_add_(0, index, contrib)
        else:
            tab.scatter_reduce_(0, index, contrib,
                                reduce="amax" if op == "max" else "amin")
        return tab[:num_keys]

    return SegmentReduceResult(values=tree.tree_map(reduce_leaf, values),
                               counts=counts[:num_keys], overflow=overflow)
