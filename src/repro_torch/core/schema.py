"""Record schemas: dtype + per-record shape pytrees (the typed half of a
container's mount contract).

A :class:`Schema` describes the records of one partition *without* the
capacity dimension: a pytree mirroring the record pytree whose leaves are
:class:`Field` (dtype + per-record shape).  Dimensions may be symbolic
(``"W"``) so an image can declare a contract over any record width and a
capacity transfer function can reference the width that actually arrives
(``kmer-stats``: ``out_capacity = cap * (W - k + 1)``).

Field dtypes are stored as numpy-style names (``"int32"``), so schemas
and their ``describe()`` strings are the reference's character for
character; :data:`TORCH_DTYPES` maps the names to torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import tree

Dim = Union[int, str]   # int = concrete extent, str = symbolic dimension

#: dtype name <-> torch dtype.
TORCH_DTYPES: Dict[str, torch.dtype] = {
    "uint8": torch.uint8, "uint16": torch.uint16, "uint32": torch.uint32,
    "uint64": torch.uint64, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float64": torch.float64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in TORCH_DTYPES.items()}


def dtype_name(dtype: Any) -> str:
    """Numpy-style name of a torch dtype, numpy dtype or name string."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise TypeError(f"unsupported record dtype {dtype}")
        return _NAMES[dtype]
    return np.dtype(dtype).name


def torch_dtype(dtype: Any) -> torch.dtype:
    """Torch dtype of a torch dtype, numpy dtype or name string."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return TORCH_DTYPES[dtype_name(dtype)]


class SchemaMismatch(TypeError):
    """A concrete record layout violates a declared schema."""


@dataclasses.dataclass(frozen=True)
class Field:
    """One record leaf: dtype (``None`` = any) + per-record shape.

    ``shape`` excludes the leading capacity dimension; entries are ints or
    symbolic dimension names that bind on first match.
    """

    dtype: Optional[str] = None
    shape: Tuple[Dim, ...] = ()

    def describe(self) -> str:
        base = _SHORT_DTYPES.get(self.dtype, self.dtype) if self.dtype \
            else "*"
        if not self.shape:
            return base
        return base + "[" + ",".join(str(d) for d in self.shape) + "]"


_SHORT_DTYPES = {
    "uint8": "u8", "uint16": "u16", "uint32": "u32", "uint64": "u64",
    "int8": "i8", "int16": "i16", "int32": "i32", "int64": "i64",
    "float16": "f16", "bfloat16": "bf16", "float32": "f32",
    "float64": "f64", "bool": "bool",
}


def field(dtype: Any = None, shape: Tuple[Dim, ...] = ()) -> Field:
    """Build a :class:`Field`, normalizing ``dtype`` to a numpy name."""
    name = None if dtype is None else dtype_name(dtype)
    return Field(dtype=name, shape=tuple(shape))


@dataclasses.dataclass(frozen=True)
class Schema:
    """A pytree of :class:`Field` mirroring a record pytree's structure."""

    fields: Any

    @property
    def concrete(self) -> bool:
        """True when every dim is an int and every dtype is declared."""
        return all(f.dtype is not None
                   and all(isinstance(d, int) for d in f.shape)
                   for f in tree.leaves(self.fields))

    def structs(self, capacity: int) -> Any:
        """Meta-tensor pytree with a leading ``capacity`` dim (for
        evaluating keyBy/value selectors at plan time without data);
        requires a concrete schema."""
        if not self.concrete:
            raise ValueError(f"schema {self.describe()} is not concrete")
        return tree.tree_map(
            lambda f: torch.empty((capacity,) + tuple(f.shape),
                                  dtype=TORCH_DTYPES[f.dtype], device="meta"),
            self.fields)

    def describe(self) -> str:
        return _describe(self.fields)


def _describe(node: Any) -> str:
    if isinstance(node, Field):
        return node.describe()
    if isinstance(node, dict):
        inner = ", ".join(f"{k}: {_describe(v)}"
                          for k, v in sorted(node.items()))
        return "{" + inner + "}"
    if isinstance(node, (tuple, list)):
        return "(" + ", ".join(_describe(v) for v in node) + ")"
    return repr(node)


def schema_of_records(records: Any) -> Schema:
    """Concrete schema of actual record tensors (leading dim dropped)."""
    return Schema(tree.tree_map(
        lambda l: Field(dtype_name(l.dtype),
                        tuple(int(d) for d in l.shape[1:])),
        records))


def bytes_record_schema(width: Dim = "W") -> Schema:
    """The packed byte-record contract shared by ``repro_torch.io`` formats
    and the byte-oriented images: ``{"data": u8[width], "len": i32}``."""
    return Schema({"data": Field("uint8", (width,)),
                   "len": Field("int32", ())})


def unify(declared: Schema, actual: Schema,
          env: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """Match a concrete ``actual`` schema against a ``declared`` one.

    Returns ``env`` extended with bindings for the declared schema's
    symbolic dims; raises :class:`SchemaMismatch` (structure, dtype or
    shape) with the offending leaf path in the message.

    Structure must match exactly, with one leniency: a SINGLE-leaf
    declared schema accepts any single-leaf actual pytree regardless of
    the container.
    """
    env = dict(env) if env else {}
    d_paths, d_struct = tree.flatten_with_path(declared.fields)
    a_paths, a_struct = tree.flatten_with_path(actual.fields)
    if d_struct != a_struct and not (len(d_paths) == 1
                                     and len(a_paths) == 1):
        raise SchemaMismatch(
            f"record structure mismatch: declared {declared.describe()} "
            f"vs actual {actual.describe()}")
    for (path, d), (_, a) in zip(d_paths, a_paths):
        where = f"field {path or '<root>'}"
        if d.dtype is not None and a.dtype is not None and d.dtype != a.dtype:
            raise SchemaMismatch(
                f"{where}: dtype {a.dtype} != declared {d.dtype}")
        if len(d.shape) != len(a.shape):
            raise SchemaMismatch(
                f"{where}: record rank {len(a.shape)} != declared "
                f"{len(d.shape)} ({d.describe()})")
        for dim_d, dim_a in zip(d.shape, a.shape):
            if isinstance(dim_d, str):
                bound = env.get(dim_d)
                if bound is None:
                    env[dim_d] = dim_a
                elif bound != dim_a:
                    raise SchemaMismatch(
                        f"{where}: dim {dim_d}={dim_a} conflicts with "
                        f"earlier binding {dim_d}={bound}")
            elif dim_d != dim_a:
                raise SchemaMismatch(
                    f"{where}: record shape dim {dim_a} != declared "
                    f"{dim_d}")
    return env


def substitute(schema: Schema, env: Dict[str, int]) -> Schema:
    """Replace bound symbolic dims with their concrete extents."""

    def sub(f: Field) -> Field:
        return Field(f.dtype, tuple(env.get(d, d) if isinstance(d, str)
                                    else d for d in f.shape))

    return Schema(tree.tree_map(sub, schema.fields))
