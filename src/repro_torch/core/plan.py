"""Lazy execution plan — the Spark-DAG/stage analogue, a stage DAG.

MaRe inherits Spark's lazy evaluation: chained ``map`` calls generate a
single stage (one ``mapPartitions`` chain, no shuffle); ``reduce`` and
``repartitionBy`` are stage *boundaries* — but not execution boundaries.
A :class:`Plan` accumulates a linear DAG of :class:`MapStage` /
:class:`ShuffleStage` / :class:`ReduceStage` / :class:`KeyedReduceStage`
nodes; nothing runs until an action.  :mod:`repro_torch.core.planner`
lowers the whole DAG into one callable over all logical shards and
memoizes it by plan signature.

Plan-time checks evaluate ``key_by`` / ``value_by`` on *meta* tensors
(shapes and dtypes, no data) where the reference uses ``jax.eval_shape``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Hashable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.core.container import ContainerOp, Partition, make_partition
from repro_torch.core.manifests import PlanTypeError
from repro_torch.core.schema import Field, Schema, SchemaMismatch, dtype_name
from repro_torch.obs import span


class _IdKey:
    """Identity-based hashable wrapper for unhashable op params.

    Param values are baked into the lowered program, so two pipelines may
    only share a compiled program when their params hold the same value —
    a repr() fallback could collide (e.g. numpy's truncated repr of large
    arrays) and silently reuse a program compiled with different
    constants.  Holding a strong reference keeps ``id`` from being
    recycled for as long as the cache key lives.  CAVEAT: identity keying
    means in-place mutation of the param object goes unseen — numpy
    arrays are therefore keyed by content digest in :func:`_freeze`;
    anything that falls through to ``_IdKey`` must be treated as
    immutable.
    """

    __slots__ = ("obj",)

    def __init__(self, obj: Any) -> None:
        self.obj = obj

    def __hash__(self) -> int:
        return id(self.obj)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, _IdKey) and other.obj is self.obj

    def __repr__(self) -> str:
        return f"_IdKey({type(self.obj).__name__}@{id(self.obj):#x})"


def _freeze(value: Any) -> Hashable:
    """Hashable view of an op parameter.

    Hashable values key on themselves; numpy arrays key on a content
    digest (so in-place mutation correctly misses the cache); any other
    unhashable value keys on object identity and must not be mutated.
    """
    try:
        hash(value)
        return value
    except TypeError:
        pass
    if isinstance(value, np.ndarray):
        arr = np.ascontiguousarray(value)
        digest = hashlib.sha1(arr.tobytes()).hexdigest()
        return ("ndarray", arr.shape, str(arr.dtype), digest)
    return _IdKey(value)


def op_signature(op: ContainerOp) -> Tuple:
    """Hashable identity of a ContainerOp for plan/compile-cache keying.

    Two ops with the same registry function, command, params and mounts
    compute the same function, so they may share a lowered program.
    """
    params = tuple(sorted((k, _freeze(v)) for k, v in op.params.items()))
    return (op.image, op.tag, op.command, op.fn, op.out_capacity,
            repr(op.input_mount), repr(op.output_mount), params)


@dataclasses.dataclass(frozen=True)
class MapStage:
    """A fused chain of per-partition ContainerOps (no collectives)."""

    ops: Tuple[ContainerOp, ...]

    def signature(self) -> Tuple:
        return ("map",) + tuple(op_signature(op) for op in self.ops)

    def describe(self) -> str:
        return "map[" + " | ".join(op.name for op in self.ops) + "]"


@dataclasses.dataclass(frozen=True)
class ShuffleStage:
    """Hash repartition by a vectorized keyBy (one exchange)."""

    key_by: Callable[[Any], torch.Tensor]
    capacity: Optional[int] = None
    num_partitions: Optional[int] = None

    def signature(self) -> Tuple:
        # key_by keys on the callable object: two equal lambdas miss the
        # cache.
        return ("shuffle", self.key_by, self.capacity, self.num_partitions)

    def describe(self) -> str:
        extra = (f", parts={self.num_partitions}"
                 if self.num_partitions is not None else "")
        return f"shuffle(cap={self.capacity}{extra})"


@dataclasses.dataclass(frozen=True)
class ReduceStage:
    """K-level tree aggregation of all partitions down to one."""

    op: ContainerOp
    depth: int = 2

    def signature(self) -> Tuple:
        return ("reduce", op_signature(self.op), self.depth)

    def describe(self) -> str:
        return f"reduce[{self.op.name}, depth={self.depth}]"


#: Monoids a KeyedReduceStage can fold values with (segment-reduce table).
KEYED_MONOIDS = ("sum", "max", "min")


@dataclasses.dataclass(frozen=True)
class KeyedReduceStage:
    """Grouped aggregation: fold records with equal keys into one record.

    ``key_by(records) -> int array [capacity]`` (vectorized keyBy); keys
    must lie in ``[0, num_keys)`` — the bounded key table is the static-SPMD
    price of sort-free aggregation, and out-of-range keys are counted into
    the action-time error channel rather than silently dropped.
    ``value_by`` selects the value pytree to fold (default: the whole
    record).  With ``combiner=True`` each shard pre-aggregates its records
    per key *before* the exchange (the classic map-side combiner), so
    shuffle volume scales with distinct keys, not records.  With
    ``combiner=False``, ``salt > 1`` splits hot keys over ``salt``
    destination shards (round-robin by record slot) and re-exchanges the
    per-key partials in a second, combiner-style hop — the skew defense
    when one key dominates the raw record stream.
    """

    key_by: Callable[[Any], torch.Tensor]
    op: str
    num_keys: int
    value_by: Optional[Callable[[Any], Any]] = None
    combiner: bool = True
    capacity: Optional[int] = None
    use_kernel: Optional[bool] = None
    salt: int = 1

    def signature(self) -> Tuple:
        # key_by/value_by key on callable identity, like ShuffleStage.key_by
        return ("keyed_reduce", self.key_by, self.value_by, self.op,
                self.num_keys, self.combiner, self.capacity, self.use_kernel,
                self.salt)

    def describe(self) -> str:
        comb = "on" if self.combiner else "off"
        extra = f", salt={self.salt}" if self.salt > 1 else ""
        return (f"reduce_by_key[{self.op}, keys={self.num_keys}, "
                f"combiner={comb}{extra}]")


Stage = Union[MapStage, ShuffleStage, ReduceStage, KeyedReduceStage]


#: Counter kinds that abort the action with RuntimeError when non-zero
#: (the rest are informational diagnostics, e.g. exchanged-record volume).
COUNTER_ERROR_KINDS = frozenset({"shuffle_dropped", "key_overflow"})


def stage_counter_kinds(stage: Stage) -> Tuple[str, ...]:
    """Diagnostic counters a stage contributes to the lowered program's
    counter vector (one int32 scalar per shard per kind, in this order).

    ``max_send_count`` is max-reduced across shards (not summed, unlike
    the rest): it is the tightest per-destination ``capacity=`` that would
    have been lossless for this run — the runtime capacity-feedback knob.
    ``exchange_buffer_rows`` is the *static* per-shard exchange buffer
    allocation (rows) so skewed-vs-salted buffer volume is observable.
    """
    if isinstance(stage, ShuffleStage):
        return ("shuffle_dropped",)
    if isinstance(stage, KeyedReduceStage):
        return ("key_overflow", "shuffle_dropped", "exchanged_records",
                "max_send_count", "exchange_buffer_rows")
    return ()


@dataclasses.dataclass
class Plan:
    """A pending linear DAG of stages (immutable builder)."""

    stages: Tuple[Stage, ...] = ()

    def then(self, op: ContainerOp) -> "Plan":
        """Append a map op, fusing into a trailing MapStage if present."""
        if self.stages and isinstance(self.stages[-1], MapStage):
            head, last = self.stages[:-1], self.stages[-1]
            return Plan(stages=head + (MapStage(last.ops + (op,)),))
        return Plan(stages=self.stages + (MapStage((op,)),))

    def then_shuffle(self, key_by: Callable[[Any], torch.Tensor],
                     capacity: Optional[int] = None,
                     num_partitions: Optional[int] = None) -> "Plan":
        return Plan(stages=self.stages + (
            ShuffleStage(key_by, capacity, num_partitions),))

    def then_reduce(self, op: ContainerOp, depth: int = 2) -> "Plan":
        return Plan(stages=self.stages + (ReduceStage(op, depth),))

    def then_keyed_reduce(self, key_by: Callable[[Any], torch.Tensor],
                          op: str, num_keys: int,
                          value_by: Optional[Callable[[Any], Any]] = None,
                          combiner: bool = True,
                          capacity: Optional[int] = None,
                          use_kernel: Optional[bool] = None,
                          salt: int = 1) -> "Plan":
        return Plan(stages=self.stages + (KeyedReduceStage(
            key_by=key_by, op=op, num_keys=num_keys, value_by=value_by,
            combiner=combiner, capacity=capacity, use_kernel=use_kernel,
            salt=salt),))

    def drop(self, n: int) -> "Plan":
        """Plan with the first ``n`` stages removed (the suffix left to
        execute after a materialization-cache prefix hit)."""
        return Plan(stages=self.stages[n:]) if n else self

    @property
    def empty(self) -> bool:
        return not self.stages

    @property
    def ops(self) -> Tuple[ContainerOp, ...]:
        """All pending map ops (legacy view of a map-only plan)."""
        return tuple(op for st in self.stages
                     if isinstance(st, MapStage) for op in st.ops)

    @property
    def num_shuffles(self) -> int:
        """ShuffleStage count (legacy view; keyed stages shuffle too — the
        program's counter-vector layout lives in :meth:`counter_specs`)."""
        return sum(isinstance(st, ShuffleStage) for st in self.stages)

    def counter_specs(self) -> Tuple[Tuple[int, str], ...]:
        """(stage_index, kind) for every diagnostic counter the lowered
        program outputs, in program-output order."""
        return tuple((i, kind) for i, st in enumerate(self.stages)
                     for kind in stage_counter_kinds(st))

    def signature(self) -> Tuple:
        """Hashable pipeline shape — the compile-cache key component."""
        return tuple(st.signature() for st in self.stages)

    def describe(self) -> str:
        return " -> ".join(st.describe() for st in self.stages) \
            or "<identity>"


def _apply_chain(ops: Tuple[ContainerOp, ...], records: Any,
                 count: torch.Tensor, stage_idx: Optional[int] = None
                 ) -> Partition:
    where = f"stage {stage_idx}" if stage_idx is not None else "stage"
    part = make_partition(records, count)
    for op in ops:
        if op.input_mount is not None:
            try:
                op.input_mount.validate(part.records)
            except ValueError as e:
                raise ValueError(
                    f"{where} (map[{op.name}]): input mount validation "
                    f"failed: {e}") from e
        part = op(part)
        if op.output_mount is not None:
            try:
                op.output_mount.validate(part.records)
            except ValueError as e:
                raise ValueError(
                    f"{where} (map[{op.name}]): output mount validation "
                    f"failed: {e}") from e
    return part


# ---------------------------------------------------------------------------
# Plan-time schema & capacity inference (manifests consumed here)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageState:
    """Inferred dataset state at one stage boundary.

    ``schema``/``capacity`` are ``None`` when an op without a manifest (or
    without a declared output schema) makes them unknown — downstream
    checks are then skipped and errors surface at action time.  ``key_space`` is the declared key range of the current
    records' key leaf (set by key-emitting images like ``kmer-stats``),
    used to size and bounds-check keyed-reduce tables; ``producer`` labels
    the stage that produced the current schema, for error messages.
    """

    schema: Optional[Schema]
    capacity: Optional[int]
    num_shards: int = 1
    key_space: Optional[int] = None
    producer: str = "input dataset"

    def describe(self) -> str:
        s = self.schema.describe() if self.schema is not None else "?"
        c = self.capacity if self.capacity is not None else "?"
        return f"{s}#{c}"


def _infer_op(state: StageState, op: ContainerOp, stage_idx: int,
              reduce_shards: Optional[int] = None) -> StageState:
    """Push ``state`` through one ContainerOp's declared contract.

    ``reduce_shards`` is set when the op runs as a reduce combiner: a
    capacity-PRESERVE combiner is concat-like and its single surviving
    partition must hold every shard's records (tree_reduce's rule).
    """
    op_label = op.contract.label if op.contract is not None else op.name
    label = f"stage {stage_idx} ({op_label})"
    if op.input_mount is not None and state.schema is not None:
        try:
            op.input_mount.validate_schema(state.schema)
        except ValueError as e:
            raise PlanTypeError(f"{label}: input mount: {e}") from e
    contract = op.contract
    env: dict = dict(contract.params) if contract is not None else {}
    if (contract is not None and contract.input_schema is not None
            and state.schema is not None):
        try:
            env = contract.check_input(state.schema)
        except SchemaMismatch as e:
            raise PlanTypeError(
                f"{label}: input schema mismatch: {contract.label} "
                f"expects {contract.input_schema.describe()} but receives "
                f"{state.schema.describe()} from {state.producer}: {e}"
            ) from e
    if contract is not None:
        out_schema = contract.infer_output_schema(state.schema, env)
        try:
            out_cap = contract.infer_out_capacity(state.capacity, env)
        except ValueError as e:
            raise PlanTypeError(f"{label}: {e}") from e
        if reduce_shards is not None and out_cap is not None \
                and state.capacity is not None and out_cap >= state.capacity:
            # concat-like combiner: the surviving partition holds all shards
            out_cap = reduce_shards * state.capacity
        key_space = contract.infer_key_space(env)
    else:
        out_schema = None
        out_cap = op.out_capacity
        key_space = None
    if op.output_mount is not None and out_schema is not None:
        try:
            op.output_mount.validate_schema(out_schema)
        except ValueError as e:
            raise PlanTypeError(f"{label}: output mount: {e}") from e
    return StageState(schema=out_schema, capacity=out_cap,
                      num_shards=state.num_shards, key_space=key_space,
                      producer=label)


def _check_key_by(stage, state: StageState, stage_idx: int,
                  what: str) -> None:
    """Abstractly evaluate a keyBy against the inferred schema: it must
    map the record pytree to an int array of one key per record."""
    if state.schema is None or state.capacity is None \
            or not state.schema.concrete:
        return
    structs = state.schema.structs(state.capacity)
    try:
        spec = stage.key_by(structs)
    except Exception as e:
        raise PlanTypeError(
            f"stage {stage_idx} ({what}): key_by failed against inferred "
            f"schema {state.schema.describe()} (from {state.producer}): "
            f"{e}") from e
    leaves = tree.leaves(spec)
    ok = (len(leaves) == 1 and isinstance(leaves[0], torch.Tensor)
          and np.issubdtype(np.dtype(dtype_name(leaves[0].dtype)),
                            np.integer)
          and tuple(leaves[0].shape) == (state.capacity,))
    if not ok:
        got = [(dtype_name(l.dtype), tuple(l.shape)) for l in leaves]
        raise PlanTypeError(
            f"stage {stage_idx} ({what}): key_by must return one int "
            f"array of shape [{state.capacity}] over schema "
            f"{state.schema.describe()}, got {got}")


def _key_by_is_passthrough(key_by, state: StageState) -> bool:
    """Whether ``key_by`` provably returns the KEY leaf unchanged.

    The declared ``key_space`` describes the record's key leaf — by
    convention the *first* leaf of a key-emitting image's output records
    (``kmer-stats``: ``(codes, ones)``).  An arbitrary ``key_by`` may
    remap keys into a smaller range, or key on a different column
    entirely, so the plan-time bounds check below is only sound when the
    key leaf reaches the table untransformed — detected conservatively
    as ``key_by`` returning the very tensor object of the first leaf.
    Anything else defers to the action-time overflow counter.
    """
    if state.schema is None or state.capacity is None \
            or not state.schema.concrete:
        return False
    structs = state.schema.structs(state.capacity)
    leaves = tree.leaves(structs)
    try:
        out = key_by(structs)
    except Exception:
        return False
    return bool(leaves) and out is leaves[0]


def _infer_keyed(state: StageState, stage: "KeyedReduceStage",
                 stage_idx: int) -> StageState:
    label = f"stage {stage_idx} ({stage.describe()})"
    if (state.key_space is not None and stage.num_keys < state.key_space
            and _key_by_is_passthrough(stage.key_by, state)):
        raise PlanTypeError(
            f"{label}: key table num_keys={stage.num_keys} is smaller "
            f"than the key space {state.key_space} declared by "
            f"{state.producer} — keys would overflow at action time; "
            f"raise num_keys (or omit it to infer {state.key_space})")
    _check_key_by(stage, state, stage_idx, stage.describe())
    out_schema = None
    if state.schema is not None and state.capacity is not None \
            and state.schema.concrete:
        structs = state.schema.structs(state.capacity)
        values = structs if stage.value_by is None else None
        if stage.value_by is not None:
            try:
                values = stage.value_by(structs)
            except Exception as e:
                raise PlanTypeError(
                    f"{label}: value_by failed against inferred schema "
                    f"{state.schema.describe()}: {e}") from e
        value_fields = tree.tree_map(
            lambda l: Field(dtype_name(l.dtype),
                            tuple(int(d) for d in l.shape[1:])), values)
        out_schema = Schema((Field("int32"), value_fields, Field("int32")))
    return StageState(schema=out_schema, capacity=stage.num_keys,
                      num_shards=state.num_shards,
                      key_space=stage.num_keys, producer=label)


def infer_stage(stage: Stage, state: StageState, i: int) -> StageState:
    """Push an inferred state through one stage (see :func:`infer_states`)."""
    if isinstance(stage, MapStage):
        for op in stage.ops:
            state = _infer_op(state, op, i)
        return state
    if isinstance(stage, ShuffleStage):
        _check_key_by(stage, state, i, "repartition_by")
        # every source shard may contribute up to `capacity` records
        # (shuffle_partition: output capacity = axis_size * capacity)
        send_cap = stage.capacity or state.capacity
        out_cap = (state.num_shards * send_cap
                   if send_cap is not None else None)
        return dataclasses.replace(state, capacity=out_cap)
    if isinstance(stage, KeyedReduceStage):
        return _infer_keyed(state, stage, i)
    if isinstance(stage, ReduceStage):
        return _infer_op(state, stage.op, i, reduce_shards=state.num_shards)
    raise TypeError(  # pragma: no cover - defensive
        f"unknown stage type {type(stage).__name__}")


def infer_states(plan: Plan, initial: StageState) -> List[StageState]:
    """Type-check a plan against manifests; states after each stage.

    Runs at plan-*build* time (every ``MaRe.map/...`` call): declared
    image contracts, mount contracts, capacity transfers and keyBy
    signatures are checked stage by stage, raising :class:`PlanTypeError`
    with the stage index and both schemas — instead of a cryptic shape
    error from inside the lowered program.  Returns
    ``[initial, after_stage_0, ...]``.
    """
    with span("plan.typecheck", stages=len(plan.stages)):
        states = [initial]
        state = initial
        for i, stage in enumerate(plan.stages):
            state = infer_stage(stage, state, i)
            states.append(state)
        return states
