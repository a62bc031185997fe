"""Out-of-core wave execution: datasets larger than the device holds.

A :class:`WaveRunner` streams a :class:`~repro_torch.io.source.DataSource`
through a MaRe map(+reduce) pipeline in *waves*: each wave ingests a
byte-budgeted group of splits into one on-device ``ShardedDataset``, runs
the pipeline, and releases the wave.  Per-wave reduce outputs are folded
with the same (required-associative+commutative) combiner in a final MaRe
reduce, so ``collect`` over a source that never fits on the device at
once is exact.

The wave loop runs on the SAME engine as every other MaRe action
(:class:`repro_torch.runtime.Executor`): each wave's pipeline is
submitted as an async action on the executor's bounded dispatch queue,
so wave *w*'s device execution (executor thread, default stream) overlaps
wave *w+1*'s fetch/pack/copy (the :class:`~repro_torch.data.pipeline.
Prefetcher`'s thread, on a side stream of the same device), and every
wave appends its :class:`~repro_torch.runtime.reports.ActionReport` to
one shared diagnostics channel (``runner.reports``).

Memory bound: at most two waves are resident — the one being computed
and the one being ingested.  The ingest of wave *w+2* waits until wave
*w*'s action has finished and every reference to its dataset is gone.

Because ingestion buckets wave geometry (capacity/width rounding in
:mod:`repro_torch.io.ingest`) and the plan cache keys on (stage
structure, shapes, shards, device), the pipeline lowers once and every
same-shaped wave is a cache hit — ``stats["programs_compiled"]`` records
how many distinct programs a run built.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import planner as planner_lib
from repro_torch.core import tree
from repro_torch.core.container import DEFAULT_REGISTRY, Registry
from repro_torch.core.dataset import DeviceLike, resolve_device
from repro_torch.core.mare import MaRe
from repro_torch.data.pipeline import Prefetcher
from repro_torch.io.ingest import ingest
from repro_torch.io.source import DataSource
from repro_torch.io.splits import InputSplit
from repro_torch.obs import METRICS, span
from repro_torch.runtime.executor import DEFAULT_EXECUTOR, Executor, on_device
from repro_torch.runtime.reports import ReportLog

#: Waves resident at once on the prefetch path: the one being computed
#: and the one being ingested.
RESIDENT_WAVES = 2


def plan_waves(splits: Sequence[InputSplit], wave_bytes: Optional[int]
               ) -> List[List[InputSplit]]:
    """Group splits (plan order) into waves of at most ``wave_bytes`` each
    (always at least one split per wave); ``None`` -> a single wave."""
    if wave_bytes is None:
        return [list(splits)] if splits else []
    waves: List[List[InputSplit]] = []
    cur: List[InputSplit] = []
    cur_bytes = 0
    for sp in splits:
        if cur and cur_bytes + sp.length > wave_bytes:
            waves.append(cur)
            cur, cur_bytes = [], 0
        cur.append(sp)
        cur_bytes += sp.length
    if cur:
        waves.append(cur)
    return waves


class WaveRunner:
    """MaRe-shaped pipeline builder executed wave-by-wave.

    .. code-block:: python

        total = (WaveRunner(fasta_source("genome.fa"), wave_bytes=1 << 20)
                 .map(image="ubuntu", command="grep-chars GC")
                 .reduce(image="ubuntu", command="awk-sum")
                 .collect())

    Where the reference takes a device ``mesh``, the runner takes
    ``num_shards`` (logical shards per wave) and ``device`` (``cuda``
    unless the caller passes another), as :class:`MaRe` does.
    """

    def __init__(self, source: DataSource, num_shards: int = 1,
                 device: DeviceLike = None,
                 wave_bytes: Optional[int] = None,
                 workers: Optional[int] = None,
                 capacity: Optional[int] = None,
                 width: Optional[int] = None,
                 registry: Registry = DEFAULT_REGISTRY,
                 prefetch: bool = True,
                 plan_cache: Optional["planner_lib.PlanCache"] = None,
                 executor: Optional[Executor] = None,
                 parser: str = "vectorized"):
        self.source = source
        self.num_shards = int(num_shards)
        self.device = resolve_device(device)
        self.wave_bytes = wave_bytes
        self.workers = workers
        self.capacity = capacity
        self.width = width
        #: Framing implementation forwarded to every wave's ingest.
        self.parser = parser
        self.registry = registry
        self.prefetch = prefetch
        self.plan_cache = plan_cache
        self.executor = executor if executor is not None else DEFAULT_EXECUTOR
        #: One diagnostics channel for the whole run: every wave action
        #: (and the cross-wave fold) appends its ActionReport here.
        self.reports = ReportLog()
        self._maps: List[Dict[str, Any]] = []
        self._reduce: Optional[Dict[str, Any]] = None
        self.stats: Dict[str, Any] = {}

    # -- pipeline spec (MaRe-API mirror) ------------------------------------

    def map(self, **kwargs: Any) -> "WaveRunner":
        if self._reduce is not None:
            raise ValueError("map after reduce is not supported in waves")
        self._maps.append(kwargs)
        return self

    def reduce(self, **kwargs: Any) -> "WaveRunner":
        if self._reduce is not None:
            raise ValueError("only one reduce stage per wave pipeline")
        self._reduce = kwargs
        return self

    # -- execution -----------------------------------------------------------

    def waves(self) -> List[List[InputSplit]]:
        return plan_waves(self.source.splits(), self.wave_bytes)

    def _pipeline(self, ds) -> MaRe:
        m = MaRe(ds, registry=self.registry, plan_cache=self.plan_cache,
                 executor=self.executor, _reports=self.reports)
        for kw in self._maps:
            m = m.map(**kw)
        if self._reduce is not None:
            m = m.reduce(**self._reduce)
        return m

    def _submit_wave(self, ds, idx: int):
        """Queue one wave's pipeline on the executor's dispatch thread
        (bounded queue: backpressure once ``max_pending`` waves are in
        flight) and return its ActionHandle."""
        m = self._pipeline(ds)
        shard = 0 if self._reduce is not None else None
        return m.collect(shard=shard, asynchronous=True,
                         label=f"wave {idx}")

    def _ingest_wave(self, wave: Sequence[InputSplit], idx: int,
                     stream: Optional["torch.cuda.Stream"] = None):
        """Ingest one wave.  On the prefetch path this runs on the
        Prefetcher's threads, so it names its device and, on a card, puts
        its copies on ``stream`` (a side stream) and hands the wave to the
        dispatch worker's stream: that stream waits for the copies, and
        every tensor of the wave is marked as used there, so the caching
        allocator cannot give its blocks back to the side stream while
        the wave's kernels still read them."""
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with span("wave.ingest", index=idx, splits=len(wave)), \
                on_device(self.device), ctx:
            ds = ingest(self.source, self.num_shards, device=self.device,
                        capacity=self.capacity, width=self.width,
                        workers=self.workers, splits=wave,
                        parser=self.parser)
            if stream is not None:
                # the dispatch worker never sets a stream of its own: its
                # current stream is the device's default stream
                consumer = torch.cuda.default_stream(self.device)
                consumer.wait_stream(stream)
                for t in tree.leaves(ds.records) + [ds.counts]:
                    t.record_stream(consumer)
        return ds

    def _await_wave(self, handle, idx: int):
        """Block for one wave's async action; the wave span links the
        wave index to the ActionReport the executor recorded for it."""
        with span("wave", index=idx) as sp:
            out = handle.result()
            rep = handle.report
            if rep is not None:
                sp.set(action_id=rep.action_id,
                       action_wall_s=rep.wall_s,
                       queue_wait_s=rep.queue_wait_s)
        METRICS.counter("waves.completed").inc()
        return out

    def _run_prefetched(self, waves: List[List[InputSplit]]) -> List[Any]:
        # one-wave ingest lookahead (Prefetcher) + async dispatch: wave
        # w's compute (executor thread) overlaps wave w+1's
        # fetch/pack/copy (prefetcher thread, side stream).  ``slots``
        # keeps at most RESIDENT_WAVES waves on the device: wave w+2's
        # ingest starts only after wave w's action has resolved, and the
        # dispatch worker drops an action's dataset before resolving it.
        stream = (torch.cuda.Stream(device=self.device)
                  if self.device.type == "cuda" else None)
        slots = threading.Semaphore(RESIDENT_WAVES)
        stopped = threading.Event()

        def gated():
            for i, w in enumerate(waves):
                slots.acquire()
                if stopped.is_set():
                    return
                yield self._ingest_wave(w, i, stream)

        outputs: List[Any] = []
        pf = Prefetcher(gated, capacity=1)
        try:
            pending = None
            for i in range(len(waves)):
                if pending is not None:
                    outputs.append(self._await_wave(pending, i - 1))
                    slots.release()
                pending = self._submit_wave(next(pf), i)
            outputs.append(self._await_wave(pending, len(waves) - 1))
        finally:
            stopped.set()
            slots.release()          # wake a producer waiting for a slot
            pf.close()
        return outputs

    def collect(self) -> Any:
        """Run all waves and return the folded (reduced) or concatenated
        (map-only) result as host arrays."""
        waves = self.waves()
        self.stats = {"num_waves": len(waves),
                      "num_splits": sum(len(w) for w in waves)}
        if not waves:
            raise ValueError("source produced no input splits")
        cache = (self.plan_cache if self.plan_cache is not None
                 else planner_lib.DEFAULT_CACHE)
        cache_before = cache.stats()
        reports_before = self.reports.appended

        if self.prefetch and len(waves) > 1:
            outputs = self._run_prefetched(waves)
        else:
            outputs = [self._await_wave(
                self._submit_wave(self._ingest_wave(w, i), i), i)
                for i, w in enumerate(waves)]

        def snap_stats():
            # taken at every return so the cross-wave fold program (when
            # it runs) is counted too
            cache_after = cache.stats()
            self.stats["programs_compiled"] = (cache_after["misses"]
                                               - cache_before["misses"])
            self.stats["program_cache_hits"] = (cache_after["hits"]
                                                - cache_before["hits"])
            # lifetime append counter, not len(): the ReportLog is bounded
            self.stats["actions"] = (self.reports.appended
                                     - reports_before)

        if len(outputs) == 1:
            snap_stats()
            return outputs[0]

        def cat(*ls):
            ls = [np.asarray(x) for x in ls]
            # waves may pack different record widths; pad trailing dims to
            # the common max before concatenating along records
            tail = tuple(max(x.shape[d] for x in ls)
                         for d in range(1, ls[0].ndim))
            ls = [np.pad(x, [(0, 0)] + [(0, t - s) for t, s in
                                        zip(tail, x.shape[1:])])
                  for x in ls]
            return np.concatenate(ls, axis=0)

        stacked = tree.tree_map(cat, *outputs)
        if self._reduce is None:
            snap_stats()
            return stacked
        # fold per-wave partials with the same associative combiner — a
        # plain MaRe action on the same executor/report channel
        fold = MaRe(stacked, num_shards=self.num_shards, device=self.device,
                    registry=self.registry, plan_cache=self.plan_cache,
                    executor=self.executor,
                    _reports=self.reports).reduce(**self._reduce)
        out = fold.collect(shard=0)
        snap_stats()
        return out
