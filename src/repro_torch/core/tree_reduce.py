"""K-level tree reduction over logical shards — MaRe's ``reduce`` primitive,
plus the keyed combine/merge behind ``reduce_by_key``.

Paper semantics (§1.2.2, Fig. 2): given a user depth K (default 2), records
are aggregated level by level: within-partition combine (mapPartitions),
then ``repartition`` to fewer partitions — K shuffles total — until a single
partition remains.  The combiner must be associative + commutative.

Port mapping: the reference factors its mesh axis into K group sizes and
ships each group member's partition to the group leader with ``ppermute``;
the port does the same over a Python list of per-shard partitions.  A
``ppermute`` pair becomes a list lookup, a shard that receives nothing
gets zeros with count 0, and non-leaders keep their partition — exactly
the values the reference's shards hold.  After K levels shard 0 holds the
result, which is replicated to every shard (log-doubling, as in the
reference).  The trainer's gradient all-reduces (:func:`tree_allreduce`,
:func:`fused_allreduce`, :func:`hierarchical_allreduce`) run the same
levels over an axis of a :class:`~repro_torch.core.collectives.Mesh`.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.core import collectives, tree
from repro_torch.core.collectives import SHARDS_AXIS, shards_mesh
from repro_torch.core.container import Partition, make_partition
from repro_torch.core.tensors import stable_argsort_false_first, take_clip


def split_factors(n: int, depth: int) -> List[int]:
    """Factor ``n`` into ``depth`` integer factors, each as near n^(1/K) as
    possible.  Excess depth yields trailing 1s."""
    if n <= 0:
        raise ValueError(f"axis size must be positive, got {n}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    factors: List[int] = []
    remaining = n
    for level in range(depth, 0, -1):
        if remaining == 1:
            factors.append(1)
            continue
        target = round(remaining ** (1.0 / level))
        target = max(2, target)
        divs = [d for d in range(1, remaining + 1) if remaining % d == 0]
        g = min((d for d in divs if d > 1),
                key=lambda d: (abs(d - target), d)) if remaining > 1 else 1
        factors.append(g)
        remaining //= g
    if remaining != 1:
        factors[-1] *= remaining
    if _prod(factors) != n:
        raise AssertionError((factors, n))
    return factors


def _prod(xs: Sequence[int]) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def _level_pairs(axis_size: int, stride: int, group: int, j: int):
    """(source, leader) pairs sending member ``j`` of each group to its
    leader."""
    leaders = range(0, axis_size, stride * group)
    return [(l + j * stride, l) for l in leaders if l + j * stride < axis_size]


def broadcast_from_zero(xs: Sequence[Any],
                        mesh: Optional[collectives.Mesh] = None,
                        axis_name: collectives.AxisName = SHARDS_AXIS
                        ) -> List[Any]:
    """Replicate index 0's value to every member of each group over
    ``axis_name`` by log-doubling ``ppermute`` waves, as the reference's;
    without a mesh, over the list's logical shards."""
    xs = list(xs)
    mesh = mesh or shards_mesh(len(xs))
    n = collectives.axis_size(mesh, axis_name)
    idx = collectives.axis_index(mesh, axis_name)
    k = 1
    while k < n:
        pairs = [(s, s + k) for s in range(min(k, n - k))]
        received = collectives.ppermute(xs, mesh, axis_name, pairs)
        xs = [r if k <= i < 2 * k else x
              for r, x, i in zip(received, xs, idx)]
        k *= 2
    return xs


def _fit_capacity(part: Partition, out_cap: int) -> Partition:
    """Pad or truncate a (front-compacted) partition to a fixed capacity."""
    cap = part.capacity
    if cap == out_cap:
        return part
    if cap < out_cap:
        rec = tree.tree_map(
            lambda l: torch.cat(
                [l, l.new_zeros((out_cap - cap,) + tuple(l.shape[1:]))]),
            part.records)
    else:
        rec = tree.tree_map(lambda l: l[:out_cap], part.records)
    return Partition(records=rec,
                     count=torch.clamp(part.count, max=out_cap))


def tree_reduce_partition(
    parts: Sequence[Partition],
    combine: Callable[[Partition], Partition],
    depth: int = 2,
    broadcast_result: bool = True,
    out_capacity: Optional[int] = None,
) -> List[Partition]:
    """Run MaRe's K-level reduce over the shards' partitions.

    ``combine`` maps a partition of up-to ``g * out_cap`` records to one of
    ``out_cap`` records (it must be mask-aware).  Must be associative +
    commutative (paper requirement).  ``out_capacity`` fixes the per-level
    record capacity; concatenating combiners need ``axis_size *
    input_capacity`` and get it inferred, as in the reference.
    """
    axis_size = len(parts)
    factors = split_factors(axis_size, depth)
    in_cap = parts[0].capacity
    # Level 0: local pre-combine (paper: mapPartitions before first shuffle).
    parts = [combine(p) for p in parts]
    if out_capacity is None and parts[0].capacity >= in_cap:
        out_capacity = axis_size * in_cap        # concat-like combiner
    out_cap = out_capacity or parts[0].capacity
    parts = [_fit_capacity(p, out_cap) for p in parts]
    stride = 1
    for g in factors:
        if g == 1:
            continue
        sources = {l: [l] for l in range(0, axis_size, stride * g)}
        for j in range(1, g):
            for src, leader in _level_pairs(axis_size, stride, g, j):
                sources[leader].append(src)
        new_parts = list(parts)
        for leader, members in sources.items():
            recs = [parts[m].records for m in members]
            counts = [parts[m].count for m in members]
            # a group cut short by the axis end receives zeros (ppermute)
            while len(recs) < g:
                recs.append(tree.tree_map(torch.zeros_like, recs[0]))
                counts.append(torch.zeros_like(counts[0]))
            gathered = tree.tree_map(lambda *ls: torch.cat(ls), *recs)
            # records of member j occupy [j*out_cap, j*out_cap + count_j)
            pos = torch.arange(out_cap, device=counts[0].device)
            mask = torch.cat([pos < c for c in counts])
            total = torch.stack(counts).sum().to(torch.int32)
            order = stable_argsort_false_first(mask)
            gathered = tree.tree_map(lambda l: take_clip(l, order), gathered)
            new_parts[leader] = _fit_capacity(
                combine(make_partition(gathered, total)), out_cap)
        parts = new_parts
        stride *= g
    if broadcast_result:
        parts = broadcast_from_zero(parts)
    return parts


# ---------------------------------------------------------------------------
# Keyed aggregation (the MaRe.reduce_by_key primitive, per shard)
# ---------------------------------------------------------------------------

def segment_table_to_partition(tables: Any, counts: torch.Tensor,
                               num_keys: int) -> Partition:
    """Compact a direct-indexed key table into partition records.

    Present keys (``counts > 0``) move to the front; output records are the
    3-tuple ``(keys int32, values pytree, counts int32)`` with
    ``count = #present``.
    """
    present = counts > 0
    order = stable_argsort_false_first(present)   # present keys first
    keys = order.to(torch.int32)                  # table index IS the key
    vals = tree.tree_map(lambda t: take_clip(t, order), tables)
    cnts = take_clip(counts, order)
    return make_partition((keys, vals, cnts), present.sum().to(torch.int32))


def keyed_combine_partition(keys: torch.Tensor, values: Any,
                            valid: torch.Tensor, num_keys: int,
                            op: str = "sum",
                            use_kernel: Optional[bool] = None):
    """Map-side combiner: locally fold (key, value) records into at most
    ``num_keys`` partial-aggregate records.  Returns ``(partition,
    overflow)`` where overflow counts valid records whose key fell outside
    ``[0, num_keys)``."""
    from repro_torch.kernels.segment_reduce.ops import segment_reduce
    res = segment_reduce(keys, values, num_keys, op=op, valid=valid,
                         use_kernel=use_kernel)
    return (segment_table_to_partition(res.values, res.counts, num_keys),
            res.overflow)


def keyed_merge_partition(part: Partition, num_keys: int,
                          op: str = "sum",
                          use_kernel: Optional[bool] = None):
    """Post-shuffle merge: fold received ``(keys, values, counts)`` partial
    aggregates into final per-key records on the owning shard.  Per-key
    record counts always merge with ``sum``; for the sum monoid they ride
    the same segment-reduce call as the values.  Returns ``(partition,
    overflow)``."""
    from repro_torch.kernels.segment_reduce.ops import segment_reduce
    rkeys, rvalues, rcounts = part.records
    mask = part.mask()
    if op == "sum":
        leaves, treedef = tree.flatten(rvalues)
        merged = segment_reduce(rkeys, tuple(leaves) + (rcounts,), num_keys,
                                op="sum", valid=mask, use_kernel=use_kernel)
        vals = tree.unflatten(treedef, list(merged.values[:-1]))
        out = segment_table_to_partition(vals, merged.values[-1], num_keys)
        return out, merged.overflow
    merged = segment_reduce(rkeys, rvalues, num_keys, op=op, valid=mask,
                            use_kernel=use_kernel)
    counts = segment_reduce(rkeys, (rcounts,), num_keys, op="sum",
                            valid=mask, use_kernel=use_kernel)
    out = segment_table_to_partition(merged.values, counts.values[0],
                                     num_keys)
    return out, merged.overflow


def merge_keyed_tables(state: Partition, delta: Partition, num_keys: int,
                       op: str = "sum",
                       use_kernel: Optional[bool] = None) -> Partition:
    """Fold two keyed-result partitions of the SAME shard into one.

    Both inputs are front-compacted ``(keys, values, counts)`` partitions
    of capacity ``num_keys`` as a ``reduce_by_key`` merge produces them.
    Validity is rebuilt per half (the concatenation is not
    front-compacted).  The output is front-compacted in ascending key
    order — bit-identical to a one-shot ``reduce_by_key`` over the union
    on this shard (for int values).
    """
    from repro_torch.kernels.segment_reduce.ops import segment_reduce
    skeys, svalues, scounts = state.records
    dkeys, dvalues, dcounts = delta.records
    keys = torch.cat([skeys, dkeys])
    pos = torch.arange(num_keys, device=skeys.device)
    valid = torch.cat([pos < state.count, pos < delta.count])
    values, counts = tree.tree_map(lambda a, b: torch.cat([a, b]),
                                   (svalues, scounts), (dvalues, dcounts))
    if op == "sum":
        leaves, treedef = tree.flatten(values)
        merged = segment_reduce(keys, tuple(leaves) + (counts,), num_keys,
                                op="sum", valid=valid, use_kernel=use_kernel)
        vals = tree.unflatten(treedef, list(merged.values[:-1]))
        return segment_table_to_partition(vals, merged.values[-1], num_keys)
    merged = segment_reduce(keys, values, num_keys, op=op, valid=valid,
                            use_kernel=use_kernel)
    cnt = segment_reduce(keys, (counts,), num_keys, op="sum", valid=valid,
                         use_kernel=use_kernel)
    return segment_table_to_partition(merged.values, cnt.values[0], num_keys)


# ---------------------------------------------------------------------------
# Dense-gradient all-reduces over a mesh axis (the trainer's grad syncs)
# ---------------------------------------------------------------------------

def tree_allreduce(xs: Sequence[Any], mesh: collectives.Mesh,
                   axis_name: collectives.AxisName, depth: int = 2,
                   factors: Optional[Sequence[int]] = None) -> List[Any]:
    """Paper-faithful K-level tree all-reduce of per-shard pytrees over
    ``axis_name``: each level ships whole partials to group leaders (g-1
    strided ``ppermute`` sends) and sums them, adding the members in
    order; the total is tree-broadcast from index 0.  The reference's
    non-leaders add the zeros they receive and carry that garbage, which
    they never send and the broadcast overwrites; the port leaves their
    values as they are.  The MaRe-style gradient synchronizer
    (``grad_sync="mare_tree"``)."""
    xs = list(xs)
    n = collectives.axis_size(mesh, axis_name)
    if n == 1:
        return xs
    factors = list(factors) if factors is not None else split_factors(
        n, depth)
    idx = collectives.axis_index(mesh, axis_name)
    stride = 1
    for g in factors:
        if g == 1:
            continue
        acc = xs
        for j in range(1, g):
            pairs = _level_pairs(n, stride, g, j)
            leaders = {leader for _, leader in pairs}
            recv = collectives.ppermute(xs, mesh, axis_name, pairs)
            acc = [tree.tree_map(torch.add, a, r) if i in leaders else a
                   for a, r, i in zip(acc, recv, idx)]
        xs = acc
        stride *= g
    return broadcast_from_zero(xs, mesh, axis_name)


def fused_allreduce(xs: Sequence[Any], mesh: collectives.Mesh,
                    axis_name: collectives.AxisName) -> List[Any]:
    """The reference's beyond-paper path (XLA's fused all-reduce): one
    ``psum``, an ordered sum in the port."""
    return collectives.psum(xs, mesh, axis_name)


def hierarchical_allreduce(xs: Sequence[Any], mesh: collectives.Mesh,
                           inner_axis: str, outer_axis: str) -> List[Any]:
    """Two-level tree across mesh axes: a ``psum`` over ``inner_axis``
    (within a pod), then over ``outer_axis`` (across pods) — the paper's
    K=2 tree at mesh granularity."""
    xs = collectives.psum(xs, mesh, inner_axis)
    return collectives.psum(xs, mesh, outer_axis)


def collective_bytes_tree(nbytes: int, axis_size: int, depth: int = 2) -> int:
    """Napkin math: bytes moved per shard-link by the K-level tree over
    ``axis_size`` shards of ``nbytes`` each (the levels' sends to group
    leaders, then the log-doubling broadcast), as the reference's."""
    factors = split_factors(axis_size, depth)
    total = 0
    shards = axis_size
    for g in factors:
        senders = shards - shards // g
        total += senders * nbytes
        shards //= g
    k = 1
    while k < axis_size:
        total += min(k, axis_size - k) * nbytes
        k *= 2
    return total
