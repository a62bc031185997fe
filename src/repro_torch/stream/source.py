"""ContinuousSource: poll a storage backend for newly arrived splits.

The streaming entry point: a :class:`~repro_torch.io.source.DataSource`
names *what* to read; a ``ContinuousSource`` adds *when* — each
:meth:`poll` re-plans the source's splits and returns only the ones not
seen by an earlier epoch, as an :class:`EpochBatch`.  Split sets are
**monotone**: a split, once observed, belongs to its epoch forever
(files are assumed append-only at file granularity — the object-store
arrival model, where a producer drops whole new objects into a prefix;
mutating an already-observed file in place is undetected, as for the
batch lineage cache).

Pack geometry is **pinned** across epochs: the first ingested epoch
fixes ``capacity``/``width`` (rounded up by the ingestion buckets, or
taken from the constructor), and every later epoch packs into the same
shapes, so the delta plan and the fold see one shape signature for the
stream's lifetime.  The flip side is a hard bound: an epoch whose
per-shard record count exceeds the pinned capacity raises at ingest —
size ``capacity`` for the largest epoch, not the first one.

Where the reference takes a device ``mesh`` and ``axis``, the port takes
``num_shards`` and ``device`` (``cuda`` unless the caller names
another), as :class:`~repro_torch.io.waves.WaveRunner` does.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Set, Tuple

from repro_torch.core.dataset import (DeviceLike, ShardedDataset,
                                      resolve_device)
from repro_torch.io.ingest import ingest
from repro_torch.io.source import DataSource
from repro_torch.io.splits import InputSplit
from repro_torch.obs import METRICS, span


@dataclasses.dataclass(frozen=True)
class EpochBatch:
    """One poll's worth of newly discovered splits.

    ``epoch`` is the batch's position in the monotone arrival order (0,
    1, ...); ``watermark`` == ``epoch`` is the stream position an
    aggregate that folded this batch is complete *up to*.
    """

    epoch: int
    splits: Tuple[InputSplit, ...]

    @property
    def watermark(self) -> int:
        return self.epoch

    @property
    def num_splits(self) -> int:
        return len(self.splits)


class ContinuousSource:
    """A DataSource polled for new splits, ingested epoch by epoch.

    .. code-block:: python

        cont = ContinuousSource(text_source(inbox_dir), num_shards=8,
                                capacity=512)
        batch = cont.poll()            # None until new files arrive
        if batch is not None:
            delta = cont.ingest_epoch(batch)   # ShardedDataset

    Thread-safe: :class:`~repro_torch.stream.live.LiveQuery` polls from a
    background thread while the owning session inspects
    :attr:`watermark` from its own.
    """

    def __init__(self, source: DataSource, num_shards: int = 1,
                 device: DeviceLike = None,
                 capacity: Optional[int] = None,
                 width: Optional[int] = None,
                 workers: Optional[int] = None,
                 parser: str = "vectorized") -> None:
        self.source = source
        self.num_shards = int(num_shards)
        self.device = resolve_device(device)
        self.workers = workers
        #: Framing implementation for every epoch's ingest.
        self.parser = parser
        #: Pinned pack geometry (fixed after the first ingested epoch).
        self.capacity = capacity
        self.width = width
        self._seen: Set[InputSplit] = set()
        self._next_epoch = 0
        self._lock = threading.Lock()

    # -- discovery -----------------------------------------------------------

    def poll(self) -> Optional[EpochBatch]:
        """Newly arrived splits since the last poll as the next epoch's
        batch, or ``None`` when nothing new arrived (no epoch number is
        consumed in that case).  Arrival order within a batch follows the
        source's split plan order, so a batch's content — and therefore
        its content-keyed ingest lineage — is deterministic."""
        with self._lock:
            with span("stream.poll", epoch=self._next_epoch):
                fresh = [sp for sp in self.source.splits()
                         if sp not in self._seen]
            if not fresh:
                return None
            self._seen.update(fresh)
            batch = EpochBatch(epoch=self._next_epoch, splits=tuple(fresh))
            self._next_epoch += 1
            METRICS.counter("stream.epochs").inc()
            METRICS.counter("stream.splits_discovered").inc(len(fresh))
            return batch

    # -- ingestion -----------------------------------------------------------

    def ingest_epoch(self, batch: EpochBatch) -> ShardedDataset:
        """Ingest one epoch's splits through the parallel fetch pool into
        a dataset with the stream's pinned pack geometry."""
        with span("stream.ingest", epoch=batch.epoch,
                  splits=batch.num_splits):
            ds = ingest(self.source, self.num_shards, device=self.device,
                        capacity=self.capacity, width=self.width,
                        workers=self.workers, splits=list(batch.splits),
                        parser=self.parser)
        with self._lock:
            # the first epoch fixes the geometry every later epoch reuses
            if self.capacity is None:
                self.capacity = ds.capacity
            if self.width is None:
                leaf = ds.records["data"] if isinstance(ds.records, dict) \
                    else None
                if leaf is not None and leaf.ndim == 2:
                    self.width = int(leaf.shape[1])
        METRICS.counter("stream.splits_ingested").inc(batch.num_splits)
        return ds

    # -- introspection -------------------------------------------------------

    @property
    def watermark(self) -> int:
        """Highest epoch handed out so far (-1 before the first)."""
        with self._lock:
            return self._next_epoch - 1

    def seen_splits(self) -> List[InputSplit]:
        with self._lock:
            return sorted(self._seen,
                          key=lambda sp: (sp.path, sp.start, sp.stop))

    def __repr__(self) -> str:
        return (f"ContinuousSource(epochs={self._next_epoch}, "
                f"splits={len(self._seen)}, capacity={self.capacity}, "
                f"width={self.width})")
