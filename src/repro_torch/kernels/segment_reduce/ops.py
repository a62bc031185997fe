"""Strategy-dispatched segment reduce: the CUDA kernel or the scatter
reference.

``segment_reduce`` is the keyed-aggregation primitive behind
``MaRe.reduce_by_key``: both the map-side combiner (pre-shuffle) and the
post-shuffle merge fold records into a bounded ``[num_keys, ...]`` key
table.  Two strategies implement the same contract (see
:func:`~repro_torch.kernels.segment_reduce.ref.segment_reduce_ref`):

========  ===============================================  ==================
strategy  implementation                                   availability
========  ===============================================  ==================
scatter   per-leaf ``scatter_add_`` / ``scatter_reduce_``  all monoids/dtypes
kernel    CUDA segment-sum kernel (``kernel.py``)          sum; int32/float32
========  ===============================================  ==================

Dispatch (``use_kernel`` tri-state, as in the reference):

* ``use_kernel=True``  — the kernel (on a CPU tensor its wrapper takes
  the kernel's plain version).
* ``use_kernel=False`` — the scatter reference.
* ``use_kernel=None``  (the default) — the kernel on a CUDA tensor, the
  scatter reference elsewhere.

Non-``sum`` monoids and an empty value pytree always take ``scatter``.
On the kernel path the value leaves are grouped by dtype and each group
is folded by ONE launch over the stacked ``[n, D]`` matrix; a CUDA
value leaf of another dtype than int32 / float32 raises (pass
``use_kernel=False`` for those).

Overflow contract (all strategies): valid records whose key falls
outside ``[0, num_keys)`` contribute to ``result.overflow`` and nothing
else.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.core import tree
from repro_torch.kernels.segment_reduce.kernel import segment_sum
from repro_torch.kernels.segment_reduce.ref import (MONOIDS,
                                                    SegmentReduceResult,
                                                    monoid_identity,
                                                    segment_reduce_ref,
                                                    segment_sum_ref)

STRATEGIES = ("scatter", "kernel")


def resolve_use_kernel(explicit: Optional[bool], op: str,
                       device: torch.device) -> bool:
    """Would the kernel strategy run for this op on this device?"""
    if op != "sum":
        return False
    if explicit is not None:
        return explicit
    return torch.device(device).type == "cuda"


def resolve_strategy(use_kernel: Optional[bool], op: str, values: Any,
                     device: torch.device) -> str:
    """Map the public knobs to a strategy name (one of ``STRATEGIES``)."""
    if op not in MONOIDS:
        raise ValueError(f"unknown segment-reduce op {op!r}; "
                         f"expected {MONOIDS}")
    if op != "sum" or not tree.leaves(values):
        return "scatter"
    return "kernel" if resolve_use_kernel(use_kernel, op, device) \
        else "scatter"


def _segment_sum_grouped(keys: torch.Tensor, values: Any, num_keys: int,
                         valid: torch.Tensor) -> SegmentReduceResult:
    """Kernel path: one launch per value dtype over the dtype's leaves
    stacked column-wise as ``[n, D]``."""
    leaves, treedef = tree.flatten(values)
    n = keys.shape[0]
    keys = keys.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    groups: dict = {}
    for pos, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(pos)
    out: list = [None] * len(leaves)
    counts = overflow = None
    for dtype, members in groups.items():
        cols = [leaves[p].reshape(n, math.prod(leaves[p].shape[1:]))
                for p in members]
        mat = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
        table, cnt, ovf = segment_sum(keys, mat.contiguous(), num_keys,
                                      valid)
        if counts is None:
            counts, overflow = cnt, ovf[0]
        off = 0
        for p, col in zip(members, cols):
            w = col.shape[1]
            out[p] = table[:, off:off + w].reshape(
                (num_keys,) + tuple(leaves[p].shape[1:]))
            off += w
    return SegmentReduceResult(values=tree.unflatten(treedef, out),
                               counts=counts, overflow=overflow)


def segment_reduce(keys: torch.Tensor, values: Any, num_keys: int,
                   op: str = "sum",
                   valid: Optional[torch.Tensor] = None,
                   use_kernel: Optional[bool] = None) -> SegmentReduceResult:
    """Aggregate ``values`` ([n, ...] pytree) per key into a
    ``[num_keys, ...]`` table.

    Args:
      keys: int ``[n]`` key per record; out-of-range keys count into
        ``result.overflow`` and touch no table row.
      values: pytree of ``[n, ...]`` tensors (may be empty — counts only).
      num_keys: key-space bound; the table has exactly this many rows,
        absent keys hold the monoid identity (``counts > 0`` marks
        presence).
      op: monoid, one of ``("sum", "max", "min")``.
      valid: bool ``[n]`` record mask (``Partition.mask()``); ``None``
        means all valid.
      use_kernel: tri-state dispatch (see the module docstring).

    Returns a :class:`SegmentReduceResult` ``(values, counts, overflow)``;
    int results are bit-identical across strategies.
    """
    n = keys.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=keys.device)
    if resolve_strategy(use_kernel, op, values, keys.device) == "kernel":
        return _segment_sum_grouped(keys, values, num_keys, valid)
    return segment_reduce_ref(keys, values, num_keys, op=op, valid=valid)


__all__ = ["segment_reduce", "segment_reduce_ref", "segment_sum",
           "segment_sum_ref", "resolve_use_kernel", "resolve_strategy",
           "STRATEGIES", "SegmentReduceResult", "MONOIDS",
           "monoid_identity"]
