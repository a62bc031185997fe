"""ShardedDataset: the RDD analogue — a dataset split into logical shards.

The reference shards its records over a device mesh axis.  The port keeps
all shards on ONE device and makes the shard a leading logical
dimension: every record leaf is a tensor of ``num_shards * cap`` rows in
which shard ``s`` owns the block ``[s * cap, (s + 1) * cap)``, and
``counts[s]`` (int32) is the number of valid records in that block —
byte for byte the layout of the reference's global arrays.
``from_host`` plays the role of ``sc.parallelize``, ``collect`` of
``RDD.collect``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.core.container import Partition
from repro_torch.obs import TRACER, span

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point places data on: ``cuda`` unless the
    caller names another.  A CUDA device without a visible GPU raises —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class ShardedDataset:
    records: Any            # pytree of tensors; leading dim = n * cap
    counts: torch.Tensor    # [n_shards] int32, valid records per shard
    num_shards: int
    #: Lineage fingerprint (repro_torch.runtime.lineage.Lineage) naming
    #: how this dataset was produced; None = unknown provenance.
    lineage: Any = None
    #: ``ActionReport.action_id`` of the action that last returned this
    #: dataset (None before any): the ``gather`` span's argument, so an
    #: action's spans and its gather share one id.
    action_id: Optional[int] = None

    @property
    def device(self) -> torch.device:
        return self.counts.device

    @property
    def capacity(self) -> int:
        """Per-shard record capacity."""
        return tree.leaves(self.records)[0].shape[0] // self.num_shards

    def record_spec(self) -> Any:
        """The records' shapes and dtypes as meta tensors (no data)."""
        return tree.tree_map(
            lambda l: torch.empty(l.shape, dtype=l.dtype, device="meta"),
            self.records)

    def with_records(self, records: Any,
                     counts: Optional[torch.Tensor] = None
                     ) -> "ShardedDataset":
        # records changed by an unknown transformation -> provenance lost
        return dataclasses.replace(
            self, records=records, lineage=None, action_id=None,
            counts=self.counts if counts is None else counts)

    def shard(self, s: int) -> Partition:
        """Shard ``s`` as a :class:`Partition` of views (no copy)."""
        return shard_partition(self.records, self.counts, self.num_shards, s)


def shard_partition(records: Any, counts: torch.Tensor, num_shards: int,
                    s: int) -> Partition:
    def block(leaf):
        cap = leaf.shape[0] // num_shards
        return leaf[s * cap:(s + 1) * cap]

    return Partition(records=tree.tree_map(block, records), count=counts[s])


def stack_partitions(parts: Sequence[Partition]):
    """Inverse of :meth:`ShardedDataset.partitions`: ``(records [n * cap,
    ...], counts [n])`` from per-shard partitions of equal shapes."""
    records = tree.tree_map(lambda *ls: torch.cat(ls, dim=0),
                            *[p.records for p in parts])
    counts = torch.stack([p.count for p in parts]).to(torch.int32)
    return records, counts


def _block_counts(total: int, n: int, cap: int) -> np.ndarray:
    counts = np.full((n,), cap, np.int32)
    rem = n * cap - total
    for i in range(rem):
        counts[n - 1 - (i % n)] -= 1
    return counts


def from_host(records: Any, num_shards: int = 1, device: DeviceLike = None,
              capacity: Optional[int] = None) -> ShardedDataset:
    """Distribute host records block-wise over ``num_shards`` shards,
    padding each shard to a common capacity (the reference's layout:
    shard ``s`` holds records ``[sum(counts[:s]), +counts[s])``)."""
    dev = resolve_device(device)
    n = int(num_shards)
    total = tree.leaves(records)[0].shape[0]
    cap = capacity or math.ceil(total / n)
    counts = _block_counts(total, n, cap)
    offsets = np.concatenate([[0], np.cumsum(counts)])

    def place(leaf):
        leaf = np.asarray(leaf)
        out = np.zeros((n * cap,) + leaf.shape[1:], leaf.dtype)
        for s in range(n):
            c = counts[s]
            out[s * cap:s * cap + c] = leaf[offsets[s]:offsets[s] + c]
        return torch.from_numpy(out).to(dev)

    return ShardedDataset(records=tree.tree_map(place, records),
                          counts=torch.from_numpy(counts).to(dev),
                          num_shards=n)


def from_numpy(records: Any, counts: Any, num_shards: int,
               device: DeviceLike = None) -> ShardedDataset:
    """Build the port's dataset from the reference's dataset contents:
    ``records`` a pytree of ``[num_shards * cap, ...]`` numpy arrays and
    ``counts`` the ``[num_shards]`` valid counts (as ``jax.device_get``
    returns them), so both packages run on identical data."""
    dev = resolve_device(device)
    counts = np.asarray(counts, np.int32).reshape(-1)
    if counts.shape[0] != num_shards:
        raise ValueError(f"got {counts.shape[0]} counts for {num_shards} "
                         f"shards")
    return ShardedDataset(
        records=tree.tree_map(
            lambda l: torch.from_numpy(np.array(l)).to(dev),
            records),
        counts=torch.from_numpy(counts.copy()).to(dev),
        num_shards=int(num_shards))


def from_shard_arrays(shard_records: Iterable[Any],
                      shard_counts: Sequence[int], num_shards: int,
                      device: DeviceLike = None) -> ShardedDataset:
    """Assemble a dataset from per-shard host pytrees of ``[cap, ...]``
    numpy arrays (identical cap/dtype/trailing shape across shards).

    On a CUDA device each shard is staged through one of two pinned host
    buffers and copied with ``non_blocking=True``, so when the iterable
    packs lazily (``repro_torch.io.ingest``) the transfer of shard *s*
    overlaps host packing of shard *s+1*.  A staging buffer is reused only
    after the copy that last read it has finished.
    """
    dev = resolve_device(device)
    n = int(num_shards)
    pinned = dev.type == "cuda"
    treedef = None
    outs: List[torch.Tensor] = []
    staging: List[List[torch.Tensor]] = []
    done: List[Optional[torch.cuda.Event]] = [None, None]
    seen = 0
    for s, rec in enumerate(shard_records):
        if s >= n:
            raise ValueError(f"got more than {n} shard pytrees")
        leaves, td = tree.flatten(rec)
        leaves = [np.ascontiguousarray(leaf) for leaf in leaves]
        if treedef is None:
            treedef = td
            for leaf in leaves:
                cap = leaf.shape[0]
                outs.append(torch.empty((n * cap,) + leaf.shape[1:],
                                        dtype=torch.from_numpy(leaf).dtype,
                                        device=dev))
            if pinned:
                staging = [[torch.empty(leaf.shape,
                                        dtype=torch.from_numpy(leaf).dtype,
                                        pin_memory=True) for leaf in leaves]
                           for _ in range(2)]
        slot = s % 2
        if pinned and done[slot] is not None:
            done[slot].synchronize()     # the copy that last read it ended
        for li, leaf in enumerate(leaves):
            cap = leaf.shape[0]
            dst = outs[li][s * cap:(s + 1) * cap]
            if pinned:
                buf = staging[slot][li]
                buf.copy_(torch.from_numpy(leaf))
                dst.copy_(buf, non_blocking=True)
            else:
                dst.copy_(torch.from_numpy(leaf))
        if pinned:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            done[slot] = ev
        seen += 1
    if seen != n:
        raise ValueError(f"got {seen} shard pytrees for {n} shards")
    for ev in done:
        if ev is not None:
            ev.synchronize()
    counts = torch.tensor([int(c) for c in shard_counts[:n]],
                          dtype=torch.int32).to(dev)
    return ShardedDataset(records=tree.unflatten(treedef, outs),
                          counts=counts, num_shards=n)


def _host_bytes(out: Any) -> int:
    return sum(a.nbytes for a in tree.leaves(out))


def collect_shard(ds: ShardedDataset, shard: int = 0) -> Any:
    """One shard's valid records as numpy (``MaRe.collect(shard=...)``):
    slices the shard's block on the device and transfers only its valid
    rows.  One ``gather`` span covers the count's read and the copy."""
    n = ds.num_shards
    if not 0 <= shard < n:
        raise ValueError(f"shard index {shard} out of range for "
                         f"{n}-shard dataset")
    with span("gather", action_id=ds.action_id, shard=shard) as sp:
        rows = int(ds.counts[shard])

        def one(leaf):
            cap = leaf.shape[0] // n
            lo = shard * cap
            return leaf[lo:lo + min(cap, rows)].cpu().numpy()

        out = tree.tree_map(one, ds.records)
        if TRACER.enabled:
            sp.set(rows=min(rows, ds.capacity), bytes=_host_bytes(out))
    return out


def collect_first_shard(ds: ShardedDataset) -> Any:
    """Shard 0's valid records (for reduced/replicated results)."""
    return collect_shard(ds, 0)


def collect(ds: ShardedDataset) -> Any:
    """Gather every shard's valid records to host numpy (RDD.collect).
    One ``gather`` span covers the counts' read, the concatenation and
    the copy."""
    with span("gather", action_id=ds.action_id) as sp:
        counts = ds.counts.cpu().numpy()
        cap = ds.capacity

        def gather(leaf):
            segs = [leaf[s * cap:s * cap + int(counts[s])]
                    for s in range(ds.num_shards)]
            return torch.cat(segs, dim=0).cpu().numpy()

        out = tree.tree_map(gather, ds.records)
        if TRACER.enabled:
            sp.set(rows=int(counts.sum()), bytes=_host_bytes(out))
    return out
