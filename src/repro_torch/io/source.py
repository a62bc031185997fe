"""DataSource: a storage backend + record format + split plan.

The handle passed to ``MaRe.from_source`` — everything ingestion needs to
enumerate and fetch a dataset, with no data touched until ingest time.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

from repro_torch.io.backends import StorageBackend, make_backend
from repro_torch.io.formats import (FastaFormat, LineFormat, RecordFormat,
                              SmilesFormat)
from repro_torch.io.splits import (DEFAULT_SPLIT_BYTES, InputSplit, plan_splits)


@dataclasses.dataclass
class DataSource:
    backend: StorageBackend
    fmt: RecordFormat
    paths: Optional[Sequence[str]] = None
    split_bytes: int = DEFAULT_SPLIT_BYTES

    def splits(self) -> List[InputSplit]:
        return plan_splits(self.backend, self.paths, self.split_bytes)

    def total_bytes(self) -> int:
        return sum(s.length for s in self.splits())

    def with_splits(self, split_bytes: int) -> "DataSource":
        return dataclasses.replace(self, split_bytes=split_bytes)


def _resolve_backend(backend: Union[str, StorageBackend], root: str
                     ) -> StorageBackend:
    if isinstance(backend, StorageBackend):
        return backend
    return make_backend(backend, root)


def text_source(root: str, backend: Union[str, StorageBackend] = "local",
                split_bytes: int = DEFAULT_SPLIT_BYTES) -> DataSource:
    """Line-delimited text under ``root`` (file or directory)."""
    return DataSource(_resolve_backend(backend, root), LineFormat(),
                      split_bytes=split_bytes)


def fasta_source(root: str, backend: Union[str, StorageBackend] = "local",
                 split_bytes: int = DEFAULT_SPLIT_BYTES) -> DataSource:
    """FASTA sequence data under ``root``."""
    return DataSource(_resolve_backend(backend, root), FastaFormat(),
                      split_bytes=split_bytes)


def smiles_source(root: str, backend: Union[str, StorageBackend] = "local",
                  split_bytes: int = DEFAULT_SPLIT_BYTES) -> DataSource:
    """SMILES molecule files under ``root``."""
    return DataSource(_resolve_backend(backend, root), SmilesFormat(),
                      split_bytes=split_bytes)
