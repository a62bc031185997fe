"""Parallel ingestion: splits -> fetch pool -> packed ShardedDataset.

The MaRe ingestion path (paper Fig. 5): splits are fetched concurrently by
a thread pool (latency-bound against remote storage, so pool width is the
paper's "number of workers"), framed per split into a columnar
:class:`~repro_torch.io.formats.RecordBatch`, gathered per shard into the
fixed-shape byte-record contract, and copied to the device shard by shard
from pinned host memory with ``non_blocking=True`` (the copy of shard *s*
overlaps packing of shard *s+1* — see
:func:`repro_torch.core.dataset.from_shard_arrays`).  The copies run on
the calling thread's current stream.

``parser="legacy"`` keeps the reference's per-line ``List[bytes]``
framing and row-at-a-time packer: the oracle the vectorized path is
pinned against.  It is GIL-bound Python, so its local pool default is
serial.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

from repro_torch.core.dataset import (DeviceLike, ShardedDataset,
                                      from_shard_arrays, resolve_device)
from repro_torch.io.formats import RecordBatch, pack_batches, pack_records
from repro_torch.io.source import DataSource
from repro_torch.io.splits import InputSplit, assign_splits
from repro_torch.kernels.common import round_up
from repro_torch.obs import METRICS, span
from repro_torch.runtime.lineage import source_root

#: Pack geometry is rounded up to these multiples (the reference's
#: buckets), so both packages pack the same source to the same shape.
_CAP_BUCKET = 64
_WIDTH_BUCKET = 16

#: Local (latency-free) pool cap: enough threads to overlap OS reads with
#: framing, few enough that pool bookkeeping stays negligible.
_LOCAL_POOL_CAP = 4


def _round_up(x: int, m: int) -> int:
    return round_up(max(x, 1), m)


def default_workers(backend, num_splits: int,
                    parser: str = "vectorized") -> int:
    """Latency-aware fetch-pool width: up to 32 threads for latency-bound
    (emulated/remote) backends; for local ones a small pool under the
    vectorized parser (framing is GIL-releasing NumPy, so fetch+frame of
    neighbouring splits overlap) and the serial path under
    ``parser="legacy"`` (GIL-bound per-line Python)."""
    latency = float(getattr(backend, "latency_s", 0.0) or 0.0)
    if latency <= 0.0:
        if parser == "legacy":
            return 1
        return max(1, min(_LOCAL_POOL_CAP, os.cpu_count() or 1, num_splits))
    return min(32, max(1, num_splits))


def ingest(source: DataSource, num_shards: int = 1,
           device: DeviceLike = None,
           capacity: Optional[int] = None, width: Optional[int] = None,
           workers: Optional[int] = None,
           splits: Optional[Sequence[InputSplit]] = None,
           parser: str = "vectorized") -> ShardedDataset:
    """Fetch ``source`` (or an explicit subset of its splits) into a
    :class:`ShardedDataset` of ``{"data", "len"}`` byte records on
    ``device`` (default ``cuda``).

    ``parser`` selects the framing/packing implementation:
    ``"vectorized"`` (default) flows columnar ``RecordBatch`` offsets
    from storage to the device buffer; ``"legacy"`` is the per-line
    ``List[bytes]`` oracle the property tests pin it against.
    """
    if parser not in ("vectorized", "legacy"):
        raise ValueError(f"unknown parser {parser!r}; "
                         "expected 'vectorized' or 'legacy'")
    dev = resolve_device(device)
    if splits is None:
        splits = source.splits()
    n = int(num_shards)
    bins = assign_splits(splits, n)
    if workers is None:
        workers = default_workers(source.backend, len(splits), parser)
    backend, fmt = source.backend, source.fmt

    def read_one(sp: InputSplit) -> RecordBatch:
        # fetch + frame of one split (possibly on a pool thread — spans
        # record their thread, so the trace shows pool parallelism)
        with span("ingest.fetch", path=sp.path, start=sp.start,
                  length=sp.length):
            payload = fmt.read_payload(backend, sp)
        with span("ingest.frame", path=sp.path, bytes=len(payload)):
            if parser == "legacy":
                batch = RecordBatch.from_records(
                    fmt.parse(payload) if payload else [])
            else:
                batch = fmt.frame(payload)
        METRICS.counter("ingest.splits").inc()
        METRICS.counter("ingest.records").inc(len(batch))
        return batch

    def read_bin(b: Sequence[InputSplit]) -> List[RecordBatch]:
        return [read_one(sp) for sp in b]

    def pack_one(batches: List[RecordBatch], count: int, shard: int):
        # one gather per batch straight out of the framed payload buffers;
        # the legacy parser goes through the row-at-a-time oracle packer
        with span("ingest.gather", shard=shard, records=count):
            if parser == "legacy":
                recs = [r for b in batches for r in b.to_list()]
                return pack_records(recs, capacity=cap, width=w)
            return pack_batches(batches, capacity=cap, width=w)

    latency = float(getattr(backend, "latency_s", 0.0) or 0.0)
    with span("ingest", splits=len(splits), shards=n, workers=workers,
              parser=parser):
        if workers <= 1:
            shard_batches = [read_bin(b) for b in bins]
        else:
            with ThreadPoolExecutor(max_workers=workers,
                                    thread_name_prefix="ingest") as pool:
                if latency <= 0.0:
                    # one task per shard bin: whole shards fetch+frame at
                    # once
                    shard_batches = [f.result() for f in
                                     [pool.submit(read_bin, b)
                                      for b in bins]]
                else:
                    # latency-bound: one future per split so every wait
                    # overlaps
                    futs = [[pool.submit(read_one, sp) for sp in b]
                            for b in bins]
                    shard_batches = [[f.result() for f in shard]
                                     for shard in futs]
        counts = [sum(len(b) for b in bs) for bs in shard_batches]
        max_count = max(counts, default=0)
        max_width = max((b.max_len for bs in shard_batches for b in bs),
                        default=0)
        cap = capacity if capacity is not None else _round_up(max_count,
                                                              _CAP_BUCKET)
        w = width if width is not None else _round_up(max_width,
                                                      _WIDTH_BUCKET)
        if max_count > cap:
            raise ValueError(
                f"shard record count {max_count} exceeds capacity {cap}; "
                "raise `capacity` or stream via repro_torch.io.waves")
        if max_width > w:
            raise ValueError(f"record length {max_width} exceeds width {w}")
        # a lazy generator: shard s packs while shard s-1's copy drains
        packed = (pack_one(bs, counts[i], i)
                  for i, bs in enumerate(shard_batches))
        with span("ingest.device_put", shards=n, capacity=cap, width=w):
            ds = from_shard_arrays(packed, counts, n, dev)
    # content-keyed lineage root: same byte ranges + pack geometry -> same
    # root (sources assumed immutable — the HDFS/object-store model)
    ds.lineage = source_root(type(backend).__name__, type(fmt).__name__,
                             splits, cap, w)
    return ds
