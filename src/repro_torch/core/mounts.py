"""Mount points: typed I/O contracts between partitions and ContainerOps.

Paper mapping (MaRe §1.2.1): ``TextFile(path, recordSeparator)`` mounts a
partition as one file whose records are separated by a configurable
separator; ``BinaryFiles(dir)`` mounts each record as a distinct file in a
directory.  On an accelerator there is no POSIX filesystem inside the compute unit,
so a mount becomes a *typed tensor contract*:

* ``RecordMount`` (== ``TextFile``): the partition is a single array pytree
  whose **leading dimension indexes records** (the "record separator" is the
  leading-dim boundary; custom separators map to custom record widths).
* ``FileSetMount`` (== ``BinaryFiles``): the partition is a **dict of named
  arrays** — each entry a distinct "file".
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

from repro_torch.core import tree
from repro_torch.core.schema import Schema, dtype_name


@dataclasses.dataclass(frozen=True)
class Mount:
    """Base class for mount points.

    ``path`` is kept for provenance / paper fidelity (e.g. ``"/dna"``) and
    used in error messages; it has no filesystem meaning here.
    """

    path: str

    def validate(self, records: Any) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def validate_schema(self, schema: Schema) -> None:
        """Plan-time twin of :meth:`validate`: check the mount contract
        against an *inferred* record schema instead of live arrays."""
        raise NotImplementedError  # pragma: no cover - abstract


@dataclasses.dataclass(frozen=True)
class RecordMount(Mount):
    """A partition mounted as one array (pytree) of stacked records.

    Equivalent to the paper's ``TextFile``.  ``record_shape``/``dtype`` are
    optional contracts checked against the mounted arrays; ``separator`` is
    recorded for provenance only (leading-dim boundaries separate records).
    """

    dtype: Optional[Any] = None
    record_shape: Optional[Tuple[int, ...]] = None
    separator: Optional[str] = None

    def validate(self, records: Any) -> None:
        leaves = tree.leaves(records)
        if not leaves:
            raise ValueError(f"mount {self.path}: empty record pytree")
        lead = {l.shape[0] for l in leaves if hasattr(l, "shape") and l.ndim}
        if len(lead) > 1:
            raise ValueError(
                f"mount {self.path}: inconsistent record counts {lead}")
        if self.dtype is not None:
            want = dtype_name(self.dtype)
            for l in leaves:
                if dtype_name(l.dtype) != want:
                    raise ValueError(
                        f"mount {self.path}: dtype {dtype_name(l.dtype)} != "
                        f"contract {want}")
        if self.record_shape is not None:
            for l in leaves:
                if tuple(l.shape[1:]) != tuple(self.record_shape):
                    raise ValueError(
                        f"mount {self.path}: record shape "
                        f"{tuple(l.shape[1:])} != contract "
                        f"{self.record_shape}")

    def validate_schema(self, schema: Schema) -> None:
        fields = tree.leaves(schema.fields)
        if not fields:
            raise ValueError(f"mount {self.path}: empty record schema")
        if self.dtype is not None:
            want = dtype_name(self.dtype)
            for f in fields:
                if f.dtype is not None and f.dtype != want:
                    raise ValueError(
                        f"mount {self.path}: dtype {f.dtype} != contract "
                        f"{want} (schema {schema.describe()})")
        if self.record_shape is not None:
            want_shape = tuple(self.record_shape)
            for f in fields:
                concrete = tuple(d for d in f.shape if isinstance(d, int))
                if len(concrete) == len(f.shape) and f.shape != want_shape:
                    raise ValueError(
                        f"mount {self.path}: record shape {f.shape} != "
                        f"contract {want_shape} (schema "
                        f"{schema.describe()})")


@dataclasses.dataclass(frozen=True)
class FileSetMount(Mount):
    """A partition mounted as a directory of named arrays.

    Equivalent to the paper's ``BinaryFiles``: each dict entry is one
    "file".  All entries must share the leading record dimension.
    """

    keys: Optional[Tuple[str, ...]] = None

    def validate(self, records: Any) -> None:
        if not isinstance(records, Mapping):
            raise ValueError(
                f"mount {self.path}: FileSetMount requires a dict of arrays, "
                f"got {type(records).__name__}")
        if self.keys is not None:
            missing = set(self.keys) - set(records)
            if missing:
                raise ValueError(f"mount {self.path}: missing files {missing}")

    def validate_schema(self, schema: Schema) -> None:
        if not isinstance(schema.fields, Mapping):
            raise ValueError(
                f"mount {self.path}: FileSetMount requires a dict of arrays, "
                f"got record schema {schema.describe()}")
        if self.keys is not None:
            missing = set(self.keys) - set(schema.fields)
            if missing:
                raise ValueError(
                    f"mount {self.path}: missing files {sorted(missing)} "
                    f"(schema {schema.describe()})")


# Paper-fidelity aliases -----------------------------------------------------

def TextFile(path: str, separator: Optional[str] = None,
             dtype: Optional[Any] = None,
             record_shape: Optional[Tuple[int, ...]] = None) -> RecordMount:
    """Alias matching MaRe Listing 1/2 spelling."""
    return RecordMount(path=path, dtype=dtype, record_shape=record_shape,
                       separator=separator)


def BinaryFiles(path: str, keys: Optional[Tuple[str, ...]] = None
                ) -> FileSetMount:
    """Alias matching MaRe Listing 3 spelling."""
    return FileSetMount(path=path, keys=keys)
