"""Tumbling and sliding windows over epoch streams.

A window is a *wave group over epochs*: the window state is a ring of
per-epoch partial aggregates — each epoch's delta runs the same plan
suffix as an :class:`~repro_torch.stream.incremental.IncrementalQuery`
epoch and is persisted under its content lineage — and the window result
is a monoid fold of the ring with the same shard-by-shard fold.
Eviction is cache-native: when an epoch slides out of the window, its
partial's materialization is dropped
(:meth:`repro_torch.runtime.cache.MaterializationCache.drop`), so window
state occupies exactly ``size`` epochs of cache budget, forever.

Semantics: a window of ``size`` S covers the S most recent epochs
``(e - S, e]``; ``slide`` L emits an aggregate every L arrivals.
``slide=1`` is the classic sliding window, ``slide == size`` (the
:meth:`WindowedQuery.tumbling` constructor) the tumbling window —
between emissions :attr:`state` holds the previous window's aggregate.
Windows are counted in *epochs*, not wall time: epochs are consecutive
by construction (``poll()`` consumes no epoch number when nothing
arrived), so epoch-based eviction is arrival-based eviction.
"""
from __future__ import annotations

import collections
import time
from typing import Deque, Tuple

from repro_torch.core.dataset import ShardedDataset
from repro_torch.obs import METRICS, span
from repro_torch.stream.incremental import IncrementalQuery, StreamUpdate
from repro_torch.stream.source import EpochBatch


class WindowedQuery(IncrementalQuery):
    """A keyed aggregate over the last ``size`` epochs of a stream.

    .. code-block:: python

        win = WindowedQuery(cont, build, size=4)          # sliding
        tum = WindowedQuery.tumbling(cont, build, size=4)  # slide == size

    Same constructor seams as :class:`IncrementalQuery` (executor,
    plan_cache, reports, label).
    """

    def __init__(self, source, build, *, size: int, slide: int = 1,
                 **kwargs) -> None:
        super().__init__(source, build, **kwargs)
        if size < 1:
            raise ValueError(f"window size must be >= 1 epoch, got {size}")
        if not 1 <= slide <= size:
            raise ValueError(f"slide must be in [1, size={size}], "
                             f"got {slide}")
        self.size = size
        self.slide = slide
        #: (epoch, per-epoch partial aggregate) pairs, oldest first.
        self._ring: Deque[Tuple[int, ShardedDataset]] = collections.deque()
        self._arrivals = 0
        self._evicted = 0

    @classmethod
    def tumbling(cls, source, build, *, size: int, **kwargs
                 ) -> "WindowedQuery":
        """Non-overlapping windows: one aggregate per ``size`` epochs."""
        return cls(source, build, size=size, slide=size, **kwargs)

    # -- the windowed update path --------------------------------------------

    def apply(self, batch: EpochBatch) -> StreamUpdate:
        t0 = time.monotonic()
        with span("stream.window.update", epoch=batch.epoch,
                  size=self.size, slide=self.slide, label=self.label):
            delta = self.source.ingest_epoch(batch)
            suffix = self._suffix(delta)
            table = suffix._materialize(
                label=f"{self.label} window epoch {batch.epoch}")
            del delta, suffix
            # each epoch's partial lives in the cache under its content
            # lineage until it slides out of the window
            self.executor.persist(table, tier=self.persist_tier)
            self._ring.append((batch.epoch, table))
            del table
            evicted = 0
            while self._ring and self._ring[0][0] <= batch.epoch - self.size:
                _, expired = self._ring.popleft()
                if expired.lineage is not None:
                    self.executor.mat_cache.drop(expired.lineage)
                del expired
                evicted += 1
            if evicted:
                self._evicted += evicted
                METRICS.counter("stream.window.evictions").inc(evicted)
            self._arrivals += 1
            keyed = self._keyed
            fold_s = 0.0
            if self._arrivals % self.slide == 0:
                f0 = time.monotonic()
                acc = self._ring[0][1]
                for _, partial in list(self._ring)[1:]:
                    acc = self.fold_engine.fold(
                        acc, partial, keyed.num_keys, keyed.op,
                        use_kernel=keyed.use_kernel)
                fold_s = time.monotonic() - f0
                self._install(acc, batch.epoch)
                del acc
        METRICS.histogram("stream.update_s").observe(time.monotonic() - t0)
        METRICS.gauge("stream.watermark").set(batch.epoch)
        report = self.reports.latest
        if report is not None:
            report.counters["stream.epoch"] = batch.epoch
            report.counters["stream.watermark"] = batch.epoch
            report.counters["stream.new_splits"] = batch.num_splits
            report.counters["stream.window.epochs"] = len(self._ring)
            report.counters["stream.window.evicted"] = evicted
            report.phases["stream.fold"] = fold_s
        return StreamUpdate(epoch=batch.epoch, watermark=batch.epoch,
                            new_splits=batch.num_splits, fold_s=fold_s,
                            dataset=self._state, report=report)

    # -- introspection -------------------------------------------------------

    @property
    def window_epochs(self) -> Tuple[int, ...]:
        """Epochs currently inside the window, oldest first."""
        return tuple(e for e, _ in self._ring)

    @property
    def evicted(self) -> int:
        """Total per-epoch partials dropped from the cache so far."""
        return self._evicted

    def describe(self) -> str:
        plan = self._plan.describe() if self._plan is not None \
            else "<unbuilt>"
        kind = "tumbling" if self.slide == self.size else "sliding"
        return (f"WindowedQuery([{plan}], {kind} size={self.size} "
                f"slide={self.slide}, ring={list(self.window_epochs)}) "
                f"[incremental @ epoch {self._epoch}]")
