"""Incremental maintenance of a persisted ``reduce_by_key`` aggregate.

The batch stack already has everything an incremental view needs:
manifests declare the reduce *monoid*, the runtime persists
lineage-keyed keyed aggregates, and the hash exchange routes a key to
``hash(key) % num_shards`` **deterministically** — so the state table
and any new epoch's delta table are partitioned identically.  An
:class:`IncrementalQuery` exploits all three: each poll epoch's new
splits run through the *same plan suffix* as the original query
(identical pack geometry, stable op signatures: a plan-cache hit from
epoch 1 on), and the resulting delta table is folded into the persisted
state **shard by shard** with one segment reduce a shard
(:func:`repro_torch.core.tree_reduce.merge_keyed_tables`) — no exchange,
no recomputation of history.  Update cost scales with the *delta*, not
the history.

Snapshot generations: every fold produces a new state whose lineage is
:func:`repro_torch.runtime.lineage.stream_root` (base query lineage,
epoch watermark), persisted in the materialization cache; the superseded
generation is explicitly dropped, so its device memory is freed once the
query lets go of it.  ``describe()`` shows ``[incremental @ epoch N]``.

Exactness: for integer values (and ``max``/``min`` on anything) the
incrementally maintained table is **bit-identical** to a one-shot
``reduce_by_key`` over the union of all epochs — same dtypes, values and
record order.  Float ``sum`` reassociates across epochs, as any
partitioned sum does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Set, Tuple

from repro_torch.core import dataset as ds_lib
from repro_torch.core import tree
from repro_torch.core.container import DEFAULT_REGISTRY, Registry
from repro_torch.core.dataset import ShardedDataset, stack_partitions
from repro_torch.core.mare import MaRe
from repro_torch.core.plan import KeyedReduceStage, Plan
from repro_torch.core.tree_reduce import merge_keyed_tables
from repro_torch.obs import METRICS, span
from repro_torch.runtime.executor import _device_wait, on_device
from repro_torch.runtime.lineage import Lineage, stream_root
from repro_torch.runtime.reports import ActionReport, ReportLog
from repro_torch.stream.source import ContinuousSource, EpochBatch

#: The executor seam (see repro_torch.serve.session): anything with run /
#: persist / ensure_lineage / mat_cache works — the default engine or a
#: session's tenant proxy.
Builder = Callable[[MaRe], MaRe]


class FoldEngine:
    """Shard-by-shard fold of a keyed state with a keyed delta.

    The reference compiles one program per (mesh, num_keys, op, value
    shapes); the port runs eagerly, so ``compiles`` counts the distinct
    fold signatures it has seen — for a stream with pinned geometry
    exactly ONE over the query's lifetime (the zero-recompile witness).
    The fold is shard-local: state and delta agree on every key's owner
    shard, so no exchange takes place.
    """

    def __init__(self) -> None:
        self._seen: Set[Tuple] = set()
        self.compiles = 0
        self.folds = 0

    @staticmethod
    def _key(state: ShardedDataset, num_keys: int, op: str,
             use_kernel: Optional[bool]) -> Tuple:
        leaves, treedef = tree.flatten(state.records)
        return (state.num_shards, str(state.device), num_keys, op,
                use_kernel, treedef,
                tuple((tuple(leaf.shape), str(leaf.dtype))
                      for leaf in leaves))

    def fold(self, state: ShardedDataset, delta: ShardedDataset,
             num_keys: int, op: str,
             use_kernel: Optional[bool] = None) -> ShardedDataset:
        """``state ⊕ delta`` under the query's monoid, per shard."""
        key = self._key(state, num_keys, op, use_kernel)
        if key not in self._seen:
            self._seen.add(key)
            self.compiles += 1
        # the current device is per thread: a live query folds on its own
        with on_device(state.device), \
                span("stream.fold", num_keys=num_keys, op=op):
            parts = [merge_keyed_tables(state.shard(s), delta.shard(s),
                                        num_keys, op=op,
                                        use_kernel=use_kernel)
                     for s in range(state.num_shards)]
            records, counts = stack_partitions(parts)
            del parts
            _device_wait(state.device)
        self.folds += 1
        METRICS.counter("stream.folds").inc()
        return ShardedDataset(records=records, counts=counts,
                              num_shards=state.num_shards)


@dataclasses.dataclass
class StreamUpdate:
    """What one :meth:`IncrementalQuery.update` did."""

    epoch: int
    watermark: int
    new_splits: int
    fold_s: float
    dataset: ShardedDataset
    report: Optional[ActionReport] = None


class IncrementalQuery:
    """A continuously maintained keyed aggregate over a polled source.

    .. code-block:: python

        cont = ContinuousSource(fasta_source(inbox), num_shards=8,
                                capacity=512)
        query = IncrementalQuery(
            cont, lambda m: (m.map(image="kmer-stats", k=6)
                              .reduce_by_key(key_of, value_by=ones_of,
                                             op="sum")))
        while producing:
            query.update()                 # no-op when nothing arrived
        keys, (vals,), counts = query.collect()

    ``build`` applies the plan *suffix* to a fresh MaRe handle over each
    epoch's delta — it must build the same plan every epoch (module-level
    ``key_by``/``value_by`` callables, same images/params; enforced by
    signature check) and end in a ``reduce_by_key``.  ``executor`` is
    the runtime seam: pass a session's tenant executor (or use
    :meth:`repro_torch.serve.session.Session.stream`) to get admission,
    fairness, batching, and per-refresh reports on the session's stream.
    """

    def __init__(self, source: ContinuousSource, build: Builder, *,
                 executor: Any = None,
                 plan_cache: Any = None,
                 reports: Optional[ReportLog] = None,
                 registry: Registry = DEFAULT_REGISTRY,
                 label: str = "stream",
                 persist_tier: str = "device") -> None:
        from repro_torch.runtime.executor import DEFAULT_EXECUTOR
        self.source = source
        self.build = build
        self.executor = executor if executor is not None \
            else DEFAULT_EXECUTOR
        self.plan_cache = plan_cache
        self.reports = reports if reports is not None else ReportLog()
        self.registry = registry
        self.label = label
        self.persist_tier = persist_tier
        self.fold_engine = FoldEngine()
        self._state: Optional[ShardedDataset] = None
        self._epoch = -1                 # watermark folded into state
        self._plan: Optional[Plan] = None
        self._plan_sig: Optional[Tuple] = None
        self._keyed: Optional[KeyedReduceStage] = None
        self._base: Optional[Lineage] = None
        self._generation: Optional[Lineage] = None

    # -- plan suffix ---------------------------------------------------------

    def _suffix(self, delta: ShardedDataset) -> MaRe:
        m = self.build(MaRe(delta, registry=self.registry,
                            plan_cache=self.plan_cache,
                            executor=self.executor,
                            _reports=self.reports))
        if not isinstance(m, MaRe):
            raise TypeError(f"build must return a MaRe chain, got "
                            f"{type(m).__name__}")
        plan = m.plan
        if plan.empty or not isinstance(plan.stages[-1], KeyedReduceStage):
            raise ValueError(
                "an IncrementalQuery plan must end in reduce_by_key — "
                "only a monoid-folded keyed table is incrementally "
                f"maintainable (got plan [{plan.describe()}])")
        if self._plan_sig is None:
            self._plan = plan
            self._plan_sig = plan.signature()
            self._keyed = plan.stages[-1]
            # base lineage of the maintained query: its canonical stage
            # signatures.  Generations extend it with the epoch watermark.
            self._base = Lineage(source=("stream-query", self.label),
                                 stages=self._plan_sig)
        elif plan.signature() != self._plan_sig:
            raise ValueError(
                "build produced a different plan than the previous epoch "
                "— an incremental query must apply the SAME suffix every "
                "epoch (use module-level key_by/value_by callables; "
                f"was [{self._plan.describe()}], now [{plan.describe()}])")
        return m

    # -- the update path -----------------------------------------------------

    def update(self) -> Optional[StreamUpdate]:
        """Poll once; when new splits arrived, ingest them, run the plan
        suffix over the delta, and fold the result into the maintained
        state.  Returns ``None`` when nothing arrived (nothing runs)."""
        batch = self.source.poll()
        if batch is None:
            return None
        return self.apply(batch)

    def apply(self, batch: EpochBatch) -> StreamUpdate:
        """Fold one epoch batch into the state (the non-polling half of
        :meth:`update`, for callers that already hold a batch)."""
        t0 = time.monotonic()
        with span("stream.update", epoch=batch.epoch,
                  splits=batch.num_splits, label=self.label):
            delta = self.source.ingest_epoch(batch)
            suffix = self._suffix(delta)
            table = suffix._materialize(
                label=f"{self.label} epoch {batch.epoch}")
            del delta, suffix
            keyed = self._keyed
            f0 = time.monotonic()
            if self._state is None:
                folded = table
            else:
                folded = self.fold_engine.fold(
                    self._state, table, keyed.num_keys, keyed.op,
                    use_kernel=keyed.use_kernel)
            del table
            fold_s = time.monotonic() - f0
            self._install(folded, batch.epoch)
        update_s = time.monotonic() - t0
        METRICS.histogram("stream.update_s").observe(update_s)
        METRICS.histogram("stream.fold_s").observe(fold_s)
        METRICS.gauge("stream.watermark").set(batch.epoch)
        report = self.reports.latest
        if report is not None:
            # the epoch's counters ride the delta action's report (a
            # shared dict: session-side clones see them too)
            report.counters["stream.epoch"] = batch.epoch
            report.counters["stream.watermark"] = batch.epoch
            report.counters["stream.new_splits"] = batch.num_splits
            report.phases["stream.fold"] = fold_s
        return StreamUpdate(epoch=batch.epoch, watermark=batch.epoch,
                            new_splits=batch.num_splits, fold_s=fold_s,
                            dataset=self._state, report=report)

    def _install(self, folded: ShardedDataset, epoch: int) -> None:
        """Persist the new snapshot generation, drop the superseded one."""
        generation = stream_root(self._base, epoch)
        state = ShardedDataset(records=folded.records, counts=folded.counts,
                               num_shards=folded.num_shards,
                               lineage=generation)
        self.executor.persist(state, tier=self.persist_tier)
        if self._generation is not None:
            self.executor.mat_cache.drop(self._generation)
        self._state = state
        self._generation = generation
        self._epoch = epoch

    # -- results -------------------------------------------------------------

    @property
    def state(self) -> Optional[ShardedDataset]:
        """The maintained keyed table (None before the first epoch)."""
        return self._state

    @property
    def epoch(self) -> int:
        """Watermark: highest epoch folded into the state (-1 = none)."""
        return self._epoch

    watermark = epoch

    def collect(self) -> Any:
        """Host copy of the maintained aggregate — the same
        ``(keys, values, counts)`` layout ``reduce_by_key().collect()``
        returns.  Raises before the first epoch."""
        if self._state is None:
            raise RuntimeError("IncrementalQuery has no state yet: no "
                               "epoch has arrived (call update() after "
                               "data lands)")
        return ds_lib.collect(self._state)

    def describe(self) -> str:
        plan = self._plan.describe() if self._plan is not None \
            else "<unbuilt>"
        gen = (f" @{self._generation.digest()}"
               if self._generation is not None else "")
        return (f"IncrementalQuery([{plan}]{gen}) "
                f"[incremental @ epoch {self._epoch}]")

    def __repr__(self) -> str:
        return self.describe()
