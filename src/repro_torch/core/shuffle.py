"""Key-based repartitioning — MaRe's ``repartitionBy`` primitive.

Paper semantics (§1.2.1/§1.2.2): a user ``keyBy`` function computes a key
per record; ``repartition`` + ``HashPartitioner`` then guarantees records
with equal keys land in the same partition.

Port mapping: partitions are the logical shards of one device.  Each
shard hashes its record keys and packs records into a ``[n, capacity,
...]`` send buffer grouped by destination (:func:`_pack_by_dest`);
:func:`all_to_all` then moves block ``[s][d]`` to ``[d][s]`` — the
reference's ``lax.all_to_all`` as an exact index permutation over the
shard dimension — and each destination compacts what it received.  Fixed
capacity keeps every shard's buffers one shape; overflow is counted and
surfaced, never silently ignored.

Hashes are 32-bit unsigned values.  Torch has no full uint32 arithmetic,
so :func:`hash_keys` works in int64 and masks to the low 32 bits; every
multiply is split so no intermediate leaves int64 range.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import collectives, tree
from repro_torch.core.collectives import SHARDS_AXIS, shards_mesh
from repro_torch.core.container import Partition, make_partition
from repro_torch.core.tensors import stable_argsort_false_first, take_clip
from repro_torch.obs import TRACER, span

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


def keyed_bucket_capacities(num_keys: int, axis_size: int) -> np.ndarray:
    """Exact per-destination bucket sizes of the keyed hash exchange:
    entry ``d`` is ``|{k in [0, num_keys) : hash(k) % axis_size == d}|``.
    A combiner-side shard sends at most one record per distinct key, so
    entry ``d`` bounds what any shard can send to ``d``.  Runs chunked so
    a 4**15-sized key space costs MiBs of host scratch.  (Host-side mirror
    of :func:`hash_keys`; keep in lockstep.)"""
    mask = np.uint64(_MASK32)
    buckets = np.zeros((axis_size,), np.int64)
    chunk = 1 << 22
    for start in range(0, num_keys, chunk):
        x = np.arange(start, min(start + chunk, num_keys), dtype=np.uint64)
        x = ((x ^ (x >> np.uint64(16))) * np.uint64(0x7FEB352D)) & mask
        x = ((x ^ (x >> np.uint64(15))) * np.uint64(0x846CA68B)) & mask
        x = x ^ (x >> np.uint64(16))
        dest = (x % np.uint64(axis_size)).astype(np.int64)
        buckets += np.bincount(dest, minlength=axis_size)
    return buckets


@functools.lru_cache(maxsize=64)
def keyed_bucket_capacity(num_keys: int, axis_size: int) -> int:
    """Exact-lossless *uniform* per-destination send capacity for a
    combined keyed exchange: ``max(keyed_bucket_capacities(...))``.  All
    shards share one buffer shape, so the buffer is sized to the largest
    hash bucket; with this bound a combined exchange never drops."""
    return max(1, int(keyed_bucket_capacities(num_keys, axis_size).max()))


def salted_dest(keys: torch.Tensor, axis_size: int, salt: int
                ) -> torch.Tensor:
    """Hot-key-splitting destination map: spread each key's records over
    ``salt`` consecutive shards round-robin by record slot.

    ``dest = (hash(key) + (slot % salt)) % axis_size`` in uint32
    arithmetic — the sum wraps at 2**32 as in the reference.  Equal keys
    no longer co-locate after ONE exchange; callers follow with a per-key
    merge and a second, combiner-style exchange.
    """
    base = hash_keys(keys)
    slot = torch.arange(keys.shape[0], device=keys.device, dtype=torch.int64)
    return (((base + slot % salt) & _MASK32) % axis_size).to(torch.int32)


class ShuffleResult(NamedTuple):
    part: Partition              # received records, compacted to the front
    dropped: torch.Tensor        # int32 scalar: records lost to overflow
    send_counts: torch.Tensor    # [n] int32 records sent to each destination


class PackResult(NamedTuple):
    buffer: Any                  # [num_dest, capacity, ...] pytree
    counts: torch.Tensor         # [num_dest] int32 records per destination
    dropped: torch.Tensor        # int32 overflow count
    dest: torch.Tensor           # [n] int32 destination of each record
    pos: torch.Tensor            # [n] int32 slot of each record at its dest
    in_cap: torch.Tensor         # [n] bool, record made it into the buffer


def _pack_by_dest(records: Any, dest: torch.Tensor, valid: torch.Tensor,
                  num_dest: int, capacity: int) -> PackResult:
    """Group records into a [num_dest, capacity, ...] send buffer.

    Gather-only construction: a stable sort by destination, then each
    output slot (d, p) gathers sorted row ``start[d] + p``.  Stable order
    within a destination mirrors Spark's deterministic partitioning.  The
    returned (dest, pos, in_cap) triple lets callers invert the pack with
    another pure gather.
    """
    dev = dest.device
    cap_in = dest.shape[0]
    dest = dest.to(torch.int32)
    dest_m = torch.where(valid, dest, torch.full_like(dest, num_dest))
    order = torch.sort(dest_m, stable=True).indices
    sorted_dest = dest_m[order]
    start = torch.searchsorted(
        sorted_dest, torch.arange(num_dest + 1, device=dev,
                                  dtype=torch.int32))
    counts = start[1:] - start[:-1]
    dropped = torch.clamp(counts - capacity, min=0).sum().to(torch.int32)
    counts_c = torch.clamp(counts, max=capacity)
    slots = torch.arange(capacity, device=dev)
    src_pos = start[:num_dest, None] + slots[None, :]
    slot_ok = slots[None, :] < counts_c[:, None]
    src_pos = torch.where(slot_ok, src_pos, torch.full_like(src_pos, cap_in))

    def build(leaf):
        sorted_leaf = take_clip(leaf, order)
        ext = torch.cat([sorted_leaf, leaf.new_zeros((1,) + leaf.shape[1:])])
        return take_clip(ext, src_pos.reshape(-1)).reshape(
            (num_dest, capacity) + tuple(leaf.shape[1:]))

    buffer = tree.tree_map(build, records)
    # per-record placement in original order (inverse permutation)
    pos_sorted = torch.arange(cap_in, device=dev) \
        - start[sorted_dest.clamp(0, num_dest).long()]
    in_cap_sorted = (pos_sorted < capacity) & (sorted_dest < num_dest)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(cap_in, device=dev)
    pos = take_clip(pos_sorted, inv)
    in_cap = take_clip(in_cap_sorted, inv)
    return PackResult(buffer=buffer, counts=counts_c.to(torch.int32),
                      dropped=dropped, dest=dest_m, pos=pos.to(torch.int32),
                      in_cap=in_cap)


def unpack_gather(packed_flat: torch.Tensor, pack: PackResult,
                  capacity: int) -> torch.Tensor:
    """Inverse of _pack_by_dest for one leaf: per input record, the row of
    ``packed_flat`` ([num_dest * capacity, ...]) it was packed into (zeros
    for dropped records).  Pure gather."""
    n_slots = packed_flat.shape[0]
    ext = torch.cat([packed_flat,
                     packed_flat.new_zeros((1,) + packed_flat.shape[1:])])
    idx = torch.where(pack.in_cap,
                      pack.dest.long() * capacity + pack.pos.long(),
                      torch.full_like(pack.pos, n_slots, dtype=torch.int64))
    return take_clip(ext, idx)


def all_to_all(buffers: Sequence[Any]) -> List[Any]:
    """The exchange over logical shards: source ``s`` holds a pytree of
    ``[n, cap, ...]`` blocks, block ``d`` addressed to shard ``d``; the
    result for shard ``d`` is ``[n, cap, ...]`` with row ``s`` from source
    ``s`` — ``lax.all_to_all(split_axis=0, concat_axis=0)`` per shard, over
    the one-axis mesh of the shards."""
    return collectives.all_to_all(buffers, shards_mesh(len(buffers)),
                                  SHARDS_AXIS)


def shuffle_partition(parts: Sequence[Partition],
                      keys: Sequence[torch.Tensor],
                      capacity: Optional[int] = None,
                      partitioner: Callable[[torch.Tensor], torch.Tensor]
                      = hash_keys,
                      dests: Optional[Sequence[torch.Tensor]] = None
                      ) -> List[ShuffleResult]:
    """repartitionBy over all logical shards: pack -> exchange -> compact.

    ``parts[s]`` / ``keys[s]`` are shard ``s``'s partition and its int
    keys [capacity_in] (entries beyond the count are ignored).  Output
    partition capacity is ``n * capacity``.  With ``capacity ==
    part.capacity`` the shuffle is lossless.  ``dests[s]`` (int32, values
    in ``[0, n)``) overrides ``partitioner(keys) % n`` — the hook the
    salted skew path uses (:func:`salted_dest`).

    The whole exchange is one ``exchange`` span (args: shards, capacity,
    and with tracing on the send buffers' bytes, from the shapes).
    """
    n = len(parts)
    cap_in = parts[0].capacity
    capacity = capacity or cap_in
    with span("exchange", shards=n, capacity=capacity) as sp:
        if TRACER.enabled:
            sp.set(buffer_bytes=n * n * capacity * sum(
                leaf.element_size() * math.prod(leaf.shape[1:])
                for leaf in tree.leaves(parts[0].records)))
        packs = []
        for s, part in enumerate(parts):
            dest = (dests[s] if dests is not None
                    else (partitioner(keys[s]) % n).to(torch.int32))
            packs.append(_pack_by_dest(part.records, dest, part.mask(), n,
                                       capacity))
        recv = all_to_all([p.buffer for p in packs])
        # recv_counts[d][s] = what source s sent to d
        recv_counts = torch.stack([p.counts for p in packs]).t()
        slots = torch.arange(capacity, device=recv_counts.device)
        out = []
        for d in range(n):
            slot_valid = (slots[None, :] < recv_counts[d][:, None]
                          ).reshape(-1)
            order = stable_argsort_false_first(slot_valid)

            def compact(leaf):
                flat = leaf.reshape((n * capacity,) + tuple(leaf.shape[2:]))
                return take_clip(flat, order)

            part = make_partition(tree.tree_map(compact, recv[d]),
                                  recv_counts[d].sum().to(torch.int32))
            out.append(ShuffleResult(part=part, dropped=packs[d].dropped,
                                     send_counts=packs[d].counts))
    return out


def grouped_all_to_all(xs: Sequence[torch.Tensor],
                       group_ids: Sequence[torch.Tensor],
                       mesh: collectives.Mesh,
                       axis_name: collectives.AxisName, capacity: int):
    """Structured variant used by MoE dispatch: rows of each shard's ``x``
    [tokens, d] are routed to member ``group_ids[i] % axis_size`` of its
    group over ``axis_name``, keeping the [source, slot] structure (no
    compaction).  Returns per shard (recv [axis_size, capacity, d],
    recv_counts [axis_size]).  This is repartitionBy with an identity
    partitioner."""
    n = collectives.axis_size(mesh, axis_name)
    packs = []
    for x, gid in zip(xs, group_ids):
        part = make_partition((x,), torch.tensor(x.shape[0],
                                                 dtype=torch.int32))
        dest = (gid % n).to(torch.int32)
        packs.append(_pack_by_dest(part.records, dest, part.mask(), n,
                                   capacity))
    recv = collectives.all_to_all([p.buffer[0] for p in packs], mesh,
                                  axis_name)
    counts = collectives.all_to_all([p.counts.reshape(n, 1) for p in packs],
                                    mesh, axis_name)
    return [(r, c.reshape(n)) for r, c in zip(recv, counts)]
