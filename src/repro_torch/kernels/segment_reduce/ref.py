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
  kernels (``kernel.py``) with their exact signature — one ``[n, d]``
  value matrix — as a thin call into :func:`segment_reduce_ref`.  The CPU
  path and the on-card comparison use it.
* :func:`segment_reduce_fused` — sum only: value leaves grouped by dtype,
  each group stacked column-wise and folded by ONE ``index_add_`` (the
  counts column rides with the int32 group).  The tuner's CPU candidate.
* :func:`segment_reduce_sorted` — sum over integer leaves only: stable
  sort by key, cumulative sum, difference at the key boundaries — no
  scatter.  Exact for integers; not offered for floats, whose reordered
  sums round differently.
* :func:`segment_sum_binned_ref` is the binned route's algebra in tensor
  code (tile histogram, partition by tile, per-tile fold, hot tiles split
  into items of ``split`` records), so that its tile arithmetic is tested
  on the CPU.  Nothing on the CUDA path calls it.  (The CUDA partition
  takes two steps, by buckets of 64 tiles and then by tile, and orders
  rows within a tile as its atomics fall; int32 sums do not see it.)
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import tree

MONOIDS = ("sum", "max", "min")

#: Records a fold item of the binned route takes: a tile holding more is
#: folded in several items (the first writes the tile, the others add to
#: it), so that one hot tile does not serialise on one block.
SPLIT = 8192


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


def bin_tiles(keys: torch.Tensor, valid: torch.Tensor, num_keys: int,
              key_block: int, split: int = SPLIT):
    """The binned route's layout: ``(ok, tile, tile_start, extra_start,
    overflow)``.  ``ok`` marks valid in-range records and ``tile`` is
    their key tile (``key // key_block``); ``tile_start`` [tiles + 1] is
    the exclusive scan of the tiles' record counts, ``extra_start``
    [tiles + 1] that of their extra fold items (``(c - 1) // split`` for a
    tile of c > split records), and ``overflow`` [1] counts the valid
    out-of-range records once."""
    keys = keys.to(torch.int32)
    tiles = -(-num_keys // key_block)
    in_range = (keys >= 0) & (keys < num_keys)
    ok = valid & in_range
    overflow = (valid & ~in_range).sum().to(torch.int32).reshape(1)
    tile = torch.where(ok, keys // key_block, tiles).long()
    per_tile = torch.bincount(tile[ok], minlength=tiles)
    extras = torch.where(per_tile > split, (per_tile - 1) // split, 0)
    zero = per_tile.new_zeros(1)
    tile_start = torch.cat([zero, per_tile.cumsum(0)])
    extra_start = torch.cat([zero, extras.cumsum(0)])
    return ok, tile, tile_start, extra_start, overflow


def segment_sum_binned_ref(keys: torch.Tensor, values: torch.Tensor,
                           num_keys: int, valid: torch.Tensor,
                           key_block: int, split: int = SPLIT):
    """The binned route in tensor code; same signature and results as
    :func:`segment_sum_ref` (int32 bit for bit).

    1-3. bin the valid in-range records by key tile (:func:`bin_tiles`);
    4. partition them into tile order (stable: record order in a tile);
    5. fold each tile's first ``split`` records into a zeroed tile and
       write the whole tile, zeros included;
    6. fold each extra item ``j`` (item ``q >= 1`` of the last tile whose
       ``extra_start <= j``) the same way and add it to its tile.
    """
    n, d = values.shape
    dev = keys.device
    ok, tile, tile_start, extra_start, overflow = bin_tiles(
        keys, valid, num_keys, key_block, split)
    tiles = tile_start.numel() - 1
    order = torch.argsort(tile, stable=True)[:int(tile_start[-1])]
    local = (keys.long() - tile * key_block)[order]
    rows = values[order]

    def fold(t: int, q: int):
        first = t * key_block
        width = min(key_block, num_keys - first)
        lo = int(tile_start[t]) + q * split
        hi = min(int(tile_start[t + 1]), lo + split)
        tab = torch.zeros((width, d), dtype=values.dtype, device=dev)
        cnt = torch.zeros((width,), dtype=torch.int32, device=dev)
        tab.index_add_(0, local[lo:hi], rows[lo:hi])
        cnt.index_add_(0, local[lo:hi], torch.ones(hi - lo, dtype=torch.int32,
                                                   device=dev))
        return slice(first, first + width), tab, cnt

    table = torch.empty((num_keys, d), dtype=values.dtype, device=dev)
    counts = torch.empty((num_keys,), dtype=torch.int32, device=dev)
    for t in range(tiles):
        rng, tab, cnt = fold(t, 0)
        table[rng], counts[rng] = tab, cnt
    for j in range(int(extra_start[-1])):
        t = int(torch.searchsorted(extra_start[:tiles], j, right=True)) - 1
        rng, tab, cnt = fold(t, j - int(extra_start[t]) + 1)
        table[rng] += tab
        counts[rng] += cnt
    return table, counts, overflow


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


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def segment_reduce_fused(keys: torch.Tensor, values: Any, num_keys: int,
                         valid: Optional[torch.Tensor] = None
                         ) -> SegmentReduceResult:
    """Sum-monoid segment reduce with dtype-grouped fused scatters.

    Value leaves sharing a dtype are flattened to ``[n, d_i]`` columns and
    stacked into one ``[n, D]`` matrix folded by a single ``index_add_``
    into a sentinel-extended table.  The int32 counts column is appended
    to the int32 group when one exists and folded on its own otherwise.
    Integer results are bit-identical to :func:`segment_reduce_ref`.
    """
    ok, idx, overflow = _ok_idx_overflow(keys, num_keys, valid)
    leaves, treedef = tree.flatten(values)
    n = keys.shape[0]
    dev = keys.device
    groups: dict = {}                 # dtype -> [(leaf position, [n, d])]
    for pos, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append((pos, leaf.reshape(n, -1)))
    groups.setdefault(torch.int32, [])
    out: list = [None] * len(leaves)
    counts = None
    for dtype, members in groups.items():
        cols = [torch.where(ok[:, None], flat, torch.zeros((), dtype=dtype,
                                                          device=dev))
                for _, flat in members]
        if dtype == torch.int32:
            cols.append(ok.to(torch.int32)[:, None])
        aug = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
        tab = torch.zeros((num_keys + 1, aug.shape[1]), dtype=dtype,
                          device=dev)
        tab.index_add_(0, idx, aug)
        tab = tab[:num_keys]
        off = 0
        for pos, flat in members:
            w = flat.shape[1]
            out[pos] = tab[:, off:off + w].reshape(
                (num_keys,) + tuple(leaves[pos].shape[1:]))
            off += w
        if dtype == torch.int32:
            counts = tab[:, -1]
    return SegmentReduceResult(values=tree.unflatten(treedef, out),
                               counts=counts, overflow=overflow)


def segment_reduce_sorted(keys: torch.Tensor, values: Any, num_keys: int,
                          valid: Optional[torch.Tensor] = None
                          ) -> SegmentReduceResult:
    """Sort-based sum-monoid segment reduce (integer leaves only).

    Stable-sort the (sentinel-masked) keys once, take a cumulative sum of
    every value column in sorted order, and read each key's total as the
    difference at its ``searchsorted`` boundaries.  The cumulative sum of
    leaves up to 32 bits runs in int64 and the difference is cast back, so
    the result wraps exactly as the scatter paths' sums do.  Floating
    leaves raise: the reordered sums would round differently.
    """
    ok, idx, overflow = _ok_idx_overflow(keys, num_keys, valid)
    leaves, treedef = tree.flatten(values)
    for leaf in leaves:
        if not _is_integer(leaf.dtype):
            raise TypeError(f"segment_reduce_sorted takes integer leaves, "
                            f"got {leaf.dtype}")
    n = keys.shape[0]
    dev = keys.device
    order = torch.argsort(idx, stable=True)
    bounds = torch.searchsorted(idx[order],
                                torch.arange(num_keys + 1, device=dev))
    counts = (bounds[1:] - bounds[:-1]).to(torch.int32)

    def reduce_leaf(leaf):
        acc = torch.int64 if leaf.dtype.itemsize <= 4 else leaf.dtype
        flat = torch.where(ok[:, None], leaf.reshape(n, -1),
                           torch.zeros((), dtype=leaf.dtype, device=dev))
        csum = torch.cat([torch.zeros((1, flat.shape[1]), dtype=acc,
                                      device=dev),
                          torch.cumsum(flat[order], dim=0, dtype=acc)])
        tot = csum[bounds[1:]] - csum[bounds[:-1]]
        return tot.to(leaf.dtype).reshape((num_keys,)
                                          + tuple(leaf.shape[1:]))

    return SegmentReduceResult(
        values=tree.unflatten(treedef, [reduce_leaf(l) for l in leaves]),
        counts=counts, overflow=overflow)
