"""Whole-pipeline lowering: a stage DAG lowered to ONE callable over all
logical shards.

* :func:`lower` turns a :class:`~repro_torch.core.plan.Plan` into a single
  function ``(records, counts) -> (records, counts[, counters])`` over the
  dataset's ``[num_shards * cap, ...]`` tensors.  Each stage runs the
  reference's per-shard code on every shard's partition, with the
  exchanges (:func:`~repro_torch.core.shuffle.shuffle_partition`) and the
  reduce tree between shards; map chains feed straight into their downstream
  shuffle/reduce with no intermediate ``ShardedDataset``.
* Stage counters (shuffle drops, key-table overflow, exchange volume) are
  packed into ONE int32 vector per action — ``[num_shards * C]``, shard
  major, the reference's layout — that the runtime syncs once.
* Lowered callables are memoized in a :class:`PlanCache` keyed on stage
  structure x record shapes/dtypes x shard count x device, so re-running
  an identical pipeline reuses the callable and its host-side constants
  (bucket capacities); ``hits`` / ``misses`` count reuses and lowerings.

This module is *lowering only*: dispatching a program, syncing its
counters and recording diagnostics is :mod:`repro_torch.runtime.executor`.
The lowered program spans each stage once over all shards (``map``,
``keyed.combine``, ``keyed.merge``, ``tree_reduce``; the exchange spans
itself in :func:`~repro_torch.core.shuffle.shuffle_partition`), inside the
executor's ``dispatch`` span: with the tracer's profiler sink on, the
device time of each stage shows under its own profiler range.
With tracing on, the first dispatch of a new program runs under the work
counter (:mod:`repro_torch.launch.hlo_cost`) and fills
:attr:`CompiledProgram.cost` (the reference annotates its compile span so;
the port has no compile, so the dispatch's span carries it).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

from repro_torch.core import tree
from repro_torch.core.container import Partition, make_partition
from repro_torch.core.dataset import (ShardedDataset, shard_partition,
                                      stack_partitions)
from repro_torch.core.plan import (KeyedReduceStage, MapStage, Plan,
                                   ReduceStage, ShuffleStage, _apply_chain)
from repro_torch.core.shuffle import (keyed_bucket_capacity, salted_dest,
                                      shuffle_partition)
from repro_torch.core.tensors import stable_argsort_false_first, take_clip
from repro_torch.core.tree_reduce import (keyed_combine_partition,
                                          keyed_merge_partition,
                                          tree_reduce_partition)
from repro_torch.launch import hlo_cost
from repro_torch.obs import METRICS, TRACER, span, timed

Counters = List[List[torch.Tensor]]     # [shard][counter] int32 scalars


@dataclasses.dataclass
class CompiledProgram:
    """A lowered whole-pipeline callable plus its plan metadata."""

    fn: Callable[..., Tuple]      # (records, counts) -> outputs
    counters: Tuple[Tuple[int, str], ...]  # trailing counter-vector layout
    key: Hashable                 # cache key it was lowered under
    #: FLOP / byte / wire-byte count of one dispatch (launch/hlo_cost),
    #: filled by the first dispatch when tracing is enabled; ``work`` is
    #: the counter's whole result (each kernel's reports among it).
    cost: Optional[Dict[str, float]] = None
    work: Optional[Dict[str, Any]] = None
    _dispatched: bool = False

    def __call__(self, records: Any, counts: torch.Tensor,
                 span: Any = None) -> Tuple:
        """Run the program; the first dispatch under an enabled tracer
        counts its work into :attr:`cost` and onto ``span``."""
        first = not self._dispatched
        self._dispatched = True
        if not (first and TRACER.enabled):
            return self.fn(records, counts)
        outs, self.work = hlo_cost.count(self.fn, records, counts)
        self.cost = {k: float(self.work[k])
                     for k in ("flops", "bytes", "wire_bytes")}
        if span is not None:
            span.set(**self.cost)
        return outs

    @property
    def num_counters(self) -> int:
        return len(self.counters)


class PlanCache:
    """Lowering cache: pipeline shape -> :class:`CompiledProgram` (LRU).

    ``misses`` counts programs lowered; ``hits`` counts reuses.
    ``maxsize`` bounds retained programs (keys pin ``key_by`` callables).
    """

    def __init__(self, maxsize: int = 128) -> None:
        self._programs: "OrderedDict[Hashable, CompiledProgram]" = \
            OrderedDict()
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._programs)

    def stats(self) -> Dict[str, int]:
        return {"programs": len(self._programs), "hits": self.hits,
                "misses": self.misses}

    def clear(self) -> None:
        self._programs.clear()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_compile(self, key: Hashable,
                       build: Callable[[], CompiledProgram],
                       phases: Optional[Dict[str, float]] = None
                       ) -> CompiledProgram:
        prog = self._programs.get(key)
        if prog is not None:
            self.hits += 1
            METRICS.counter("compile_cache.hits").inc()
            self._programs.move_to_end(key)
            return prog
        self.misses += 1
        METRICS.counter("compile_cache.misses").inc()
        with timed("plan.build", phases):
            prog = build()
        self._programs[key] = prog
        while len(self._programs) > self.maxsize:
            self._programs.popitem(last=False)
            self.evictions += 1
            METRICS.counter("compile_cache.evictions").inc()
        return prog


#: Process-wide default cache (MaRe actions share it).
DEFAULT_CACHE = PlanCache()


def program_key(plan: Plan, ds: ShardedDataset) -> Hashable:
    """Cache key: stage structure x input shapes/dtypes x shard geometry."""
    leaves, treedef = tree.flatten(ds.records)
    shapes = tuple((tuple(leaf.shape), str(leaf.dtype)) for leaf in leaves)
    return (plan.signature(), treedef, shapes,
            (tuple(ds.counts.shape), str(ds.counts.dtype)),
            ds.num_shards, str(ds.device))


def _scalar(x: Any, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=like.device
                           ).reshape(())


def _apply_keyed(stage: KeyedReduceStage, parts: List[Partition]
                 ) -> Tuple[List[Partition], Counters]:
    """Keyed aggregation over all shards: (combine) -> exchange -> merge.

    With the map-side combiner on, each shard first folds its records into
    at most ``num_keys`` per-key partials, so the exchange moves distinct
    keys, not records, and the per-destination send capacity is the
    statically known largest hash bucket (exact-lossless).  Combiner off
    ships raw ``(key, value, 1)`` records with the input capacity.

    Skew (``combiner=False, salt > 1``): hop 1 spreads each key's records
    over ``salt`` consecutive shards (``salted_dest``) at capacity ``~2 *
    cap_in / spread`` where ``spread = min(salt, axis_size)``, every shard
    merges what it received into per-key partials, and hop 2 re-exchanges
    those partials combiner-style at the exact-lossless bucket capacity.

    Counters per shard (order = ``stage_counter_kinds``): key_overflow,
    shuffle_dropped, exchanged_records, max_send_count,
    exchange_buffer_rows.
    """
    axis_size = len(parts)
    num_keys = stage.num_keys
    salt = 1 if stage.combiner else max(1, int(stage.salt))
    sends, overflows = [], []
    with span("keyed.combine", num_keys=num_keys,
              rows=axis_size * parts[0].capacity):
        for part in parts:
            keys = torch.as_tensor(stage.key_by(part.records)
                                   ).to(torch.int32)
            values = (stage.value_by(part.records)
                      if stage.value_by is not None else part.records)
            valid = part.mask()
            if stage.combiner:
                send, overflow = keyed_combine_partition(
                    keys, values, valid, num_keys, op=stage.op,
                    use_kernel=stage.use_kernel)
            else:
                in_range = (keys >= 0) & (keys < num_keys)
                ok = valid & in_range
                overflow = (valid & ~in_range).sum().to(torch.int32)
                # compact surviving records to the front (count semantics)
                order = stable_argsort_false_first(ok)
                recs = (take_clip(keys, order),
                        tree.tree_map(lambda l: take_clip(l, order), values),
                        take_clip(ok.to(torch.int32), order))
                send = make_partition(recs, ok.sum().to(torch.int32))
            sends.append(send)
            overflows.append(overflow)
    if stage.combiner:
        default_cap = keyed_bucket_capacity(num_keys, axis_size)
    elif salt > 1:
        # a perfectly-spread hot key needs cap_in/spread; 2x headroom for
        # overlapping salt windows; a key cannot spread over more
        # destinations than exist
        cap_in = parts[0].capacity
        spread = min(salt, axis_size)
        default_cap = min(cap_in, 2 * ((cap_in + spread - 1) // spread))
    else:
        default_cap = parts[0].capacity   # any shard may ship every record
    cap = stage.capacity or default_cap
    dests = ([salted_dest(s.records[0], axis_size, salt) for s in sends]
             if salt > 1 else None)
    res = shuffle_partition(sends, [s.records[0] for s in sends],
                            capacity=cap, dests=dests)
    exchanged = [r.send_counts.sum().to(torch.int32) for r in res]
    max_send = [r.send_counts.max().to(torch.int32) for r in res]
    dropped = [r.dropped for r in res]
    buffer_rows = axis_size * cap
    with span("keyed.merge", num_keys=num_keys, rows=axis_size * buffer_rows):
        merged = [keyed_merge_partition(r.part, num_keys, op=stage.op,
                                        use_kernel=stage.use_kernel)
                  for r in res]
    outs = [m[0] for m in merged]
    merge_ovf = [m[1] for m in merged]
    if salt > 1:
        # hop 2: per-key partials back to their hash owner (combiner-style,
        # exact-lossless capacity) + final merge
        cap2 = keyed_bucket_capacity(num_keys, axis_size)
        res2 = shuffle_partition(outs, [o.records[0] for o in outs],
                                 capacity=cap2)
        for s, r in enumerate(res2):
            exchanged[s] = exchanged[s] + r.send_counts.sum().to(torch.int32)
            max_send[s] = torch.maximum(max_send[s],
                                        r.send_counts.max().to(torch.int32))
            dropped[s] = dropped[s] + r.dropped
        buffer_rows += axis_size * cap2
        with span("keyed.merge", num_keys=num_keys,
                  rows=axis_size * axis_size * cap2):
            merged2 = [keyed_merge_partition(r.part, num_keys, op=stage.op,
                                             use_kernel=stage.use_kernel)
                       for r in res2]
        outs = [m[0] for m in merged2]
        merge_ovf = [a + m[1] for a, m in zip(merge_ovf, merged2)]
    counters = [[(overflows[s] + merge_ovf[s]).to(torch.int32),
                 dropped[s].to(torch.int32), exchanged[s], max_send[s],
                 _scalar(buffer_rows, exchanged[s])]
                for s in range(axis_size)]
    return outs, counters


def _validate_mount(mount, records, stage_idx: int, op_name: str,
                    which: str) -> None:
    """Execution-time mount validation with stage/image context."""
    if mount is None:
        return
    try:
        mount.validate(records)
    except ValueError as e:
        raise ValueError(
            f"stage {stage_idx} (reduce[{op_name}]): {which} mount "
            f"validation failed: {e}") from e


def _apply_stage(stage, parts: List[Partition], stage_idx: int = 0
                 ) -> Tuple[List[Partition], Counters]:
    """Apply one stage to every shard; returns ``(parts, counters)`` with
    each shard's counters matching ``stage_counter_kinds(stage)``."""
    n = len(parts)
    if isinstance(stage, MapStage):
        with span("map", stage=stage.describe()):
            out = [_apply_chain(stage.ops, p.records, p.count, stage_idx)
                   for p in parts]
        return out, [[] for _ in parts]
    if isinstance(stage, ShuffleStage):
        keys = []
        for p in parts:
            k = stage.key_by(p.records)
            if stage.num_partitions is not None and stage.num_partitions != n:
                k = k % stage.num_partitions
            keys.append(k)
        res = shuffle_partition(parts, keys, capacity=stage.capacity)
        return ([r.part for r in res],
                [[r.dropped.to(torch.int32)] for r in res])
    if isinstance(stage, KeyedReduceStage):
        return _apply_keyed(stage, parts)
    if isinstance(stage, ReduceStage):
        for p in parts:
            _validate_mount(stage.op.input_mount, p.records, stage_idx,
                            stage.op.name, "input")
        with span("tree_reduce", image=stage.op.name, depth=stage.depth):
            parts = tree_reduce_partition(parts, stage.op,
                                          depth=stage.depth)
        for p in parts:
            _validate_mount(stage.op.output_mount, p.records, stage_idx,
                            stage.op.name, "output")
        return parts, [[] for _ in parts]
    raise TypeError(f"unknown stage type {type(stage).__name__}")


def lower(plan: Plan, num_shards: int):
    """Build the whole-dataset function for a plan.

    Returns ``program(records, counts) -> (records, counts[, counters])``
    where ``counters`` is an int32 vector ``[num_shards * C]`` laid out
    shard-major per ``plan.counter_specs()`` (omitted when the plan has
    none).
    """

    def program(records, counts):
        parts = [shard_partition(records, counts, num_shards, s)
                 for s in range(num_shards)]
        counters: Counters = [[] for _ in range(num_shards)]
        for i, stage in enumerate(plan.stages):
            parts, cs = _apply_stage(stage, parts, i)
            for s in range(num_shards):
                counters[s].extend(cs[s])
        out_records, out_counts = stack_partitions(parts)
        outs = (out_records, out_counts)
        if counters[0]:
            outs = outs + (torch.stack([torch.stack(c) for c in counters])
                           .to(torch.int32).reshape(-1),)
        return outs

    return program


def compile_plan(plan: Plan, ds: ShardedDataset,
                 cache: Optional[PlanCache] = None,
                 phases: Optional[Dict[str, float]] = None
                 ) -> CompiledProgram:
    """Memoized lowering of ``plan`` against ``ds``'s shapes and shards.
    ``phases`` (when given) accumulates build time under ``plan.build``."""
    cache = cache if cache is not None else DEFAULT_CACHE
    key = program_key(plan, ds)

    def build() -> CompiledProgram:
        return CompiledProgram(fn=lower(plan, ds.num_shards),
                               counters=plan.counter_specs(), key=key)

    return cache.get_or_compile(key, build, phases=phases)
