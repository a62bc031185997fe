"""MaRe: the user-facing driver API (paper Listings 1-3, PyTorch edition).

.. code-block:: python

    result = (MaRe.from_source(fasta_source("genome.fa"), num_shards=8)
        .map(input_mount=TextFile("/dna"), output_mount=TextFile("/count"),
             image="ubuntu", command="grep-chars GC")
        .reduce(input_mount=TextFile("/counts"),
                output_mount=TextFile("/sum"),
                image="ubuntu", command="awk-sum")
        .collect(shard=0))

Semantics match the paper and the reference package: ``map`` applies a
container to each partition (single stage, no shuffle); ``reduce``
aggregates all partitions down to one via a depth-K tree (combiner must be
associative+commutative; default K=2); ``repartition_by`` co-locates
records by key (hash shuffle); ``reduce_by_key`` folds equal keys.

All primitives are **lazy**: they append stages to a logical plan and
type-check it against the images' manifests.  An action (``collect`` /
``persist`` / ``dataset``) hands the chain to the runtime executor, which
runs the planner's lowered program over the dataset's logical shards,
reusing any plan *prefix* previously materialized with
:meth:`MaRe.persist` (lineage-keyed cache), syncs stage counters once,
and appends an :class:`~repro_torch.runtime.reports.ActionReport` to the
chain's history (:meth:`MaRe.report` / :meth:`MaRe.reports`).

There is ONE action signature: ``collect(shard=..., asynchronous=...,
label=...)``.  The former variants (``collect_async``,
``collect_first_shard``, ``collect_first_shard_async``) and the
``last_diagnostics`` dict survive as deprecated shims, as do the
paper-spelling camelCase aliases — each warning once per process
(:mod:`repro_torch.deprecations`).

Where the reference takes a device ``Mesh``, the port takes
``num_shards`` (the logical shard count) and ``device`` (``cuda`` unless
the caller passes another, e.g. ``device="cpu"``).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import dataset as ds_lib
from repro_torch.core.container import (ContainerOp, Registry,
                                        DEFAULT_REGISTRY)
from repro_torch.core.dataset import DeviceLike, ShardedDataset
from repro_torch.core.mounts import Mount
from repro_torch.core.plan import (KEYED_MONOIDS, Plan, StageState,
                                   infer_stage, infer_states)
from repro_torch.core.planner import PlanCache
from repro_torch.core.schema import schema_of_records
from repro_torch.deprecations import warn_once
from repro_torch.obs import METRICS, TRACER
from repro_torch.runtime.executor import (DEFAULT_EXECUTOR, ActionHandle,
                                          Executor)
from repro_torch.runtime.reports import ActionReport, ReportLog

#: Deprecated camelCase method -> canonical snake_case method, applied to
#: MaRe by :func:`paper_aliases` (the ONE place paper spellings live).
PAPER_METHOD_ALIASES: Dict[str, str] = {
    "repartitionBy": "repartition_by",
    "reduceByKey": "reduce_by_key",
}

#: Deprecated camelCase kwarg -> canonical kwarg, translated on the
#: methods listed in :data:`PAPER_KWARG_METHODS`.
PAPER_KWARG_ALIASES: Dict[str, str] = {
    "inputMountPoint": "input_mount",
    "outputMountPoint": "output_mount",
}

#: Methods whose kwargs go through the alias table.
PAPER_KWARG_METHODS = ("map", "reduce")


def _alias_method(camel: str, snake: str) -> Callable:
    def shim(self, *args: Any, **kwargs: Any):
        warn_once(("method", camel),
                  f"MaRe.{camel}() is deprecated; use MaRe.{snake}() "
                  f"(paper-spelling alias, forwarded unchanged)")
        return getattr(self, snake)(*args, **kwargs)

    shim.__name__ = camel
    shim.__qualname__ = f"MaRe.{camel}"
    shim.__doc__ = (f"Deprecated paper spelling of :meth:`{snake}` "
                    f"(warns once, forwards everything).")
    return shim


def _translate_kwargs(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapper(self, *args: Any, **kwargs: Any):
        for camel, snake in PAPER_KWARG_ALIASES.items():
            if camel in kwargs:
                if kwargs.get(snake) is not None:
                    raise TypeError(
                        f"{fn.__name__}() got both {snake!r} and its "
                        f"deprecated alias {camel!r}")
                warn_once(("kwarg", camel),
                          f"{camel}= is deprecated; use {snake}= "
                          f"(paper-spelling kwarg alias)")
                kwargs[snake] = kwargs.pop(camel)
        return fn(self, *args, **kwargs)

    return wrapper


def paper_aliases(cls):
    """Class decorator installing every paper-spelling alias from the
    tables above."""
    for camel, snake in PAPER_METHOD_ALIASES.items():
        setattr(cls, camel, _alias_method(camel, snake))
    for name in PAPER_KWARG_METHODS:
        setattr(cls, name, _translate_kwargs(getattr(cls, name)))
    return cls


#: Per-shard finalizer cache: ``collect(shard=i)`` hands the runtime the
#: SAME callable object for a given ``i`` every time (finalize identity
#: keys the serving layer's batching, as in the reference).
_SHARD_FINALIZERS: Dict[int, Callable] = {}


def _finalizer(shard: Optional[int]) -> Callable:
    """The dataset->host callable for ``collect(shard=...)``: whole-dataset
    gather when ``shard`` is None, else a cached per-shard slicer."""
    if shard is None:
        return ds_lib.collect
    fn = _SHARD_FINALIZERS.get(shard)
    if fn is None:
        fn = _SHARD_FINALIZERS[shard] = functools.partial(
            ds_lib.collect_shard, shard=shard)
    return fn


def _resolve_monoid(image: str, command: str, registry: Registry) -> str:
    """Keyed-reduce combiner via the paper's container spelling: the image
    is pulled and its *manifest* must declare a monoid."""
    op = registry.pull(image, command=command)
    monoid = op.contract.monoid if op.contract is not None else None
    if monoid is None:
        raise ValueError(
            f"image {image!r} (command {command!r}) is not a known "
            f"keyed-reduce monoid: its manifest declares no `monoid`; "
            f"use op= directly ({KEYED_MONOIDS}) or an image whose "
            f"manifest declares one (e.g. 'toolbox/sum', or 'ubuntu' "
            f"with command 'awk-sum')")
    return monoid


def _resolve_op(image: Optional[str], op: Optional[ContainerOp],
                command: str, registry: Registry,
                input_mount: Optional[Mount],
                output_mount: Optional[Mount], **params: Any) -> ContainerOp:
    if op is None:
        if image is None:
            raise ValueError("either `image` or `op` must be given")
        op = registry.pull(image, command=command, **params)
    if input_mount is not None or output_mount is not None:
        op = op.with_mounts(input_mount, output_mount, command)
    return op


@paper_aliases
class MaRe:
    """Driver handle over a :class:`ShardedDataset` with a lazy stage plan.

    ``data`` is a ``ShardedDataset`` or a host record pytree (numpy
    arrays), which is split block-wise over ``num_shards`` logical shards
    (default 1) on ``device`` (default ``cuda``).  ``plan_cache``
    overrides the process-wide plan cache; ``fuse=False`` runs
    stage-at-a-time; ``executor`` overrides the process-wide executor
    (its materialization cache is what ``persist()`` feeds).
    """

    def __init__(self, data: Any, num_shards: Optional[int] = None,
                 device: DeviceLike = None,
                 registry: Registry = DEFAULT_REGISTRY,
                 _plan: Optional[Plan] = None,
                 plan_cache: Optional[PlanCache] = None,
                 fuse: bool = True,
                 executor: Optional[Executor] = None,
                 _reports: Optional[ReportLog] = None):
        if isinstance(data, ShardedDataset):
            self._dataset = data
        else:
            self._dataset = ds_lib.from_host(data, num_shards or 1, device)
        self.registry = registry
        self.plan = _plan or Plan()
        self.plan_cache = plan_cache
        self.fuse = fuse
        self.executor = executor if executor is not None else DEFAULT_EXECUTOR
        # Per-chain action history (shared across handles forked from this
        # one): every action appends an ActionReport here AND to the
        # executor's global history.
        self._report_log = _reports if _reports is not None else ReportLog()
        #: Inferred StageState per stage boundary (build-time type check).
        self._states: Optional[list] = None

    @classmethod
    def from_source(cls, source: Any, num_shards: int = 1,
                    device: DeviceLike = None,
                    capacity: Optional[int] = None,
                    width: Optional[int] = None,
                    workers: Optional[int] = None,
                    registry: Registry = DEFAULT_REGISTRY,
                    executor: Optional[Executor] = None,
                    parser: str = "vectorized") -> "MaRe":
        """Ingest a :class:`repro_torch.io.DataSource` (storage backend +
        format + split plan) into ``num_shards`` logical shards on
        ``device`` — the paper's heterogeneous-storage entry point.
        ``parser`` selects the framing path: ``"vectorized"`` columnar
        :class:`~repro_torch.io.formats.RecordBatch` (default) or the
        ``"legacy"`` per-line oracle it is property-tested against."""
        from repro_torch.io.ingest import ingest  # io depends on core
        ds = ingest(source, num_shards, device=device, capacity=capacity,
                    width=width, workers=workers, parser=parser)
        return cls(ds, registry=registry, executor=executor)

    # -- reports -------------------------------------------------------------

    def report(self) -> Optional[ActionReport]:
        """The NEWEST ActionReport on this chain (None before the first
        action).  ``report().diagnostics`` is the per-stage counter dict;
        ``report().phases`` the wall breakdown."""
        return self._report_log.latest

    def reports(self) -> ReportLog:
        """The chain's full action history (shared across forked handles):
        iterate, index, ``total(counter)``, ``summary()``."""
        return self._report_log

    @property
    def last_diagnostics(self) -> dict:
        """Deprecated: counter totals of the newest action.  Use
        ``report().diagnostics`` (and ``reports()`` for history)."""
        warn_once(("property", "last_diagnostics"),
                  "MaRe.last_diagnostics is deprecated; use "
                  "MaRe.report().diagnostics (reports() for history)")
        latest = self.report()
        return latest.diagnostics if latest is not None else {}

    def _initial_state(self) -> StageState:
        ds = self._dataset
        return StageState(schema=schema_of_records(ds.records),
                          capacity=ds.capacity, num_shards=ds.num_shards)

    def _stage_states(self) -> list:
        """Inferred [initial, after-stage-0, ...] states for the pending
        plan — the build-time type check (raises PlanTypeError)."""
        if self._states is None:
            self._states = infer_states(self.plan, self._initial_state())
        return self._states

    def _chain(self, plan: Plan) -> "MaRe":
        m = MaRe(self._dataset, registry=self.registry, _plan=plan,
                 plan_cache=self.plan_cache, fuse=self.fuse,
                 executor=self.executor, _reports=self._report_log)
        # type-check at BUILD time, incrementally: only the new plan's last
        # stage is (re-)inferred
        prefix = self._stage_states()[:len(plan.stages)]
        last = len(plan.stages) - 1
        m._states = prefix + [infer_stage(plan.stages[last], prefix[-1],
                                          last)]
        return m

    def _materialize(self, label: Optional[str] = None) -> ShardedDataset:
        """Run all pending stages through the executor: one lowered
        program for the suffix not already materialized in the lineage
        cache, one counter sync, one appended ActionReport."""
        if not self.plan.empty:
            self._dataset, _ = self.executor.run(
                self._dataset, self.plan, fuse=self.fuse,
                plan_cache=self.plan_cache, reports=self._report_log,
                label=label)
            self.plan = Plan()
            self._states = None
        else:
            self.executor.ensure_lineage(self._dataset)
        return self._dataset

    @property
    def dataset(self) -> ShardedDataset:
        """The materialized dataset (triggers execution of pending stages)."""
        return self._materialize()

    # -- primitives ---------------------------------------------------------

    def map(self, *, image: Optional[str] = None,
            op: Optional[ContainerOp] = None,
            command: str = "",
            input_mount: Optional[Mount] = None,
            output_mount: Optional[Mount] = None,
            **params: Any) -> "MaRe":
        """Apply a container to each partition (lazy; fused into one stage)."""
        op = _resolve_op(image, op, command, self.registry,
                         input_mount, output_mount, **params)
        return self._chain(self.plan.then(op))

    def reduce(self, *, image: Optional[str] = None,
               op: Optional[ContainerOp] = None,
               command: str = "",
               input_mount: Optional[Mount] = None,
               output_mount: Optional[Mount] = None,
               depth: int = 2,
               **params: Any) -> "MaRe":
        """K-level tree aggregation of all partitions to one (paper K=2).
        Lazy; the result is replicated on every shard."""
        op = _resolve_op(image, op, command, self.registry,
                         input_mount, output_mount, **params)
        if not op.associative_commutative:
            raise ValueError(
                f"reduce combiner {op.name} is not marked associative+"
                "commutative (paper: required for tree-reduce consistency)")
        return self._chain(self.plan.then_reduce(op, depth))

    def repartition_by(self, key_by: Callable[[Any], torch.Tensor],
                       capacity: Optional[int] = None,
                       num_partitions: Optional[int] = None) -> "MaRe":
        """Hash-shuffle records so equal keys share a partition (lazy).

        ``key_by(records) -> int tensor [capacity]``.  Capacity overflow
        (dropped records) raises ``RuntimeError`` at action time through
        the one-sync counter vector.
        """
        return self._chain(self.plan.then_shuffle(
            key_by, capacity=capacity, num_partitions=num_partitions))

    def reduce_by_key(self, key_by: Callable[[Any], torch.Tensor], *,
                      num_keys: Optional[int] = None,
                      op: str = "sum",
                      value_by: Optional[Callable[[Any], Any]] = None,
                      image: Optional[str] = None,
                      command: str = "",
                      combiner: bool = True,
                      capacity: Optional[int] = None,
                      use_kernel: Optional[bool] = None,
                      salt: int = 1) -> "MaRe":
        """Grouped aggregation: fold records with equal keys (lazy).

        ``key_by(records) -> int tensor [capacity]``; keys must lie in
        ``[0, num_keys)`` (out-of-range keys raise ``RuntimeError`` at
        action time).  ``num_keys`` may be omitted when the upstream
        image's manifest declares a ``key_space`` (``kmer-stats``:
        ``4**k``).  ``value_by`` selects the values to fold (default: the
        whole record); ``op`` is the monoid (``sum`` / ``max`` / ``min``),
        or pass a container spelling (``image="toolbox/sum"``).

        With ``combiner=True`` (default) each shard pre-aggregates per key
        before the hash exchange.  The result partition on each shard
        holds the keys hashing to it as ``(key, folded_values,
        record_count)`` records, compacted to the front.  The sum folds
        run through the CUDA segment-sum kernel on a CUDA device
        (``use_kernel=False`` forces the scatter reference).  ``salt=S``
        (with ``combiner=False``) spreads hot keys over S shards and
        re-exchanges per-key partials in a second hop.
        """
        if image is not None:
            op = _resolve_monoid(image, command, self.registry)
        if op not in KEYED_MONOIDS:
            raise ValueError(f"unknown reduce_by_key op {op!r}; expected "
                             f"one of {KEYED_MONOIDS}")
        if salt < 1:
            raise ValueError(f"salt must be >= 1, got {salt}")
        if salt > 1 and combiner:
            raise ValueError(
                "salt > 1 requires combiner=False: the map-side combiner "
                "already caps the exchange at one record per distinct key, "
                "so hot-key splitting has nothing to spread")
        if num_keys is None:
            num_keys = self._stage_states()[-1].key_space
            if num_keys is None:
                raise ValueError(
                    "num_keys not given and no upstream image manifest "
                    "declares a key_space to infer it from")
        if num_keys < 1:
            raise ValueError(f"num_keys must be >= 1, got {num_keys}")
        return self._chain(self.plan.then_keyed_reduce(
            key_by, op=op, num_keys=num_keys, value_by=value_by,
            combiner=combiner, capacity=capacity, use_kernel=use_kernel,
            salt=salt))

    # -- actions ------------------------------------------------------------

    def persist(self, tier: str = "device") -> "MaRe":
        """Materialize the pending plan and register the result in the
        runtime's lineage-keyed materialization cache (Spark
        ``RDD.persist`` analogue).

        ``tier="device"`` keeps the dataset's tensors live on its device;
        ``tier="host"`` stores a CPU copy that is copied back on a hit.
        The cache is budgeted LRU per tier (device evictions spill to
        host, host evictions drop — recomputable from lineage).  After
        ``persist()``, ANY handle whose plan prefix reaches this lineage
        node starts from the cached dataset and executes only the suffix.
        """
        ds = self._materialize()
        self.executor.persist(ds, tier=tier)
        return MaRe(ds, registry=self.registry, plan_cache=self.plan_cache,
                    fuse=self.fuse, executor=self.executor,
                    _reports=self._report_log)

    def cache(self) -> "MaRe":
        """Sugar for :meth:`persist` (``tier="device"``)."""
        return self.persist(tier="device")

    def collect(self, *, shard: Optional[int] = None,
                asynchronous: bool = False,
                label: Optional[str] = None) -> Any:
        """THE action: run pending stages and gather valid records to host
        numpy arrays.

        ``shard=None`` gathers every shard's valid records; ``shard=i``
        ships only shard ``i``'s valid rows (the right call for reduced,
        replicated results).  On a CUDA dataset the arrays are views over
        pinned host memory from PyTorch's caching host allocator, into
        which each shard's valid rows are copied straight from the device:
        an answer that is kept keeps its pinned block, a dropped one
        returns it to the allocator's cache, which is kept until the
        process ends.

        ``asynchronous=False`` (default) blocks and returns host arrays.
        ``asynchronous=True`` dispatches on the executor's action thread
        behind its bounded queue and returns an
        :class:`~repro_torch.runtime.executor.ActionHandle` (``.result()``
        blocks, ``.report`` carries the ActionReport).  Snapshot
        semantics: the pending plan is captured at call time and this
        handle is left lazy.

        ``label`` tags the action's report either way.
        """
        if shard is not None and not (0 <= shard
                                      < self._dataset.num_shards):
            raise ValueError(
                f"shard index {shard} out of range for "
                f"{self._dataset.num_shards}-shard dataset")
        finalize = _finalizer(shard)
        if not asynchronous:
            return finalize(self._materialize(label=label))
        return self.executor.submit_action(
            self._dataset, self.plan, finalize=finalize,
            fuse=self.fuse, plan_cache=self.plan_cache,
            reports=self._report_log, label=label)

    # -- deprecated action shims (one collect() signature replaces them) -----

    def collect_async(self, label: Optional[str] = None) -> ActionHandle:
        """Deprecated: use ``collect(asynchronous=True)``."""
        warn_once(("method", "collect_async"),
                  "MaRe.collect_async(label=...) is deprecated; use "
                  "MaRe.collect(asynchronous=True, label=...)")
        return self.collect(asynchronous=True, label=label)

    def collect_first_shard(self) -> Any:
        """Deprecated: use ``collect(shard=0)``."""
        warn_once(("method", "collect_first_shard"),
                  "MaRe.collect_first_shard() is deprecated; use "
                  "MaRe.collect(shard=0)")
        return self.collect(shard=0)

    def collect_first_shard_async(self, label: Optional[str] = None
                                  ) -> ActionHandle:
        """Deprecated: use ``collect(shard=0, asynchronous=True)``."""
        warn_once(("method", "collect_first_shard_async"),
                  "MaRe.collect_first_shard_async(label=...) is "
                  "deprecated; use MaRe.collect(shard=0, "
                  "asynchronous=True, label=...)")
        return self.collect(shard=0, asynchronous=True, label=label)

    def num_partitions(self) -> int:
        return self._dataset.num_shards

    # -- observability -------------------------------------------------------

    def trace_to(self, path: str) -> str:
        """Export everything the process-wide tracer has recorded as
        Chrome-trace JSON (load at https://ui.perfetto.dev) and return
        ``path``.  Recording must be on — wrap the session in
        ``repro_torch.obs.tracing()`` or call
        ``repro_torch.obs.TRACER.start()`` first."""
        return TRACER.export(path)

    def metrics(self) -> dict:
        """Snapshot of the process-wide metrics registry: cache hits and
        evictions per tier, plan-cache hits/misses, exchanged-record
        volume, dispatch-queue depth, per-phase wall histograms."""
        return METRICS.snapshot()

    def describe(self) -> str:
        """Human-readable view of the pending stage DAG (no execution),
        annotated with the inferred record schema at every stage boundary
        (``{schema}#capacity``; ``?`` where an op without a manifest makes
        it unknown).  Stages whose lineage node is materialized in the
        runtime cache — the prefix an action would NOT re-execute — are
        marked ``[cached]``.  A ``counters=[...]`` section lists the
        counters the program will emit."""
        states = self._stage_states()
        cached, _ = self.executor.cached_prefix(self._dataset, self.plan)
        if self.plan.empty:
            chain = "<identity>"
        else:
            chain = " -> ".join(
                f"{st.describe()} : {state.describe()}"
                + (" [cached]" if i < cached else "")
                for i, (st, state) in enumerate(zip(self.plan.stages,
                                                    states[1:])))
        specs = self.plan.counter_specs()
        counters = (", counters=[" + ", ".join(
            f"stage{i}.{kind}" for i, kind in specs) + "]") if specs else ""
        return (f"MaRe(shards={self._dataset.num_shards}, "
                f"cap={self._dataset.capacity}, "
                f"schema={states[0].describe()}, "
                f"plan=[{chain}]{counters})")
