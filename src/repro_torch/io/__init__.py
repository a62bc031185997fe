"""repro_torch.io — storage backends, record formats, split planning,
ingestion into a :class:`~repro_torch.core.dataset.ShardedDataset`, and
out-of-core execution.

The framing and packing code is the reference's NumPy code, unchanged, so
both packages pack the same bytes; :mod:`repro_torch.io.ingest` places
the packed shards on the device from pinned host memory.
:mod:`repro_torch.io.waves` streams a source bigger than the device
through a map+reduce pipeline in waves, folding per-wave reduce outputs
with the associative combiner.
"""
from repro_torch.io.backends import (BACKEND_PROFILES, EmulatedObjectStore,
                                     HDFS, LocalFS, S3, StorageBackend, Swift,
                                     make_backend)
from repro_torch.io.formats import (FastaFormat, LineFormat, RecordBatch,
                                    RecordFormat, SmilesFormat, pack_batches,
                                    pack_records, unpack_records)
from repro_torch.io.ingest import default_workers, ingest
from repro_torch.io.source import (DataSource, fasta_source, smiles_source,
                                   text_source)
from repro_torch.io.splits import InputSplit, assign_splits, plan_splits
from repro_torch.io.waves import WaveRunner, plan_waves

__all__ = [
    "StorageBackend", "LocalFS", "EmulatedObjectStore", "HDFS", "Swift",
    "S3", "BACKEND_PROFILES", "make_backend",
    "RecordFormat", "RecordBatch", "LineFormat", "FastaFormat",
    "SmilesFormat", "pack_batches", "pack_records", "unpack_records",
    "InputSplit", "plan_splits", "assign_splits",
    "DataSource", "text_source", "fasta_source", "smiles_source",
    "ingest", "default_workers", "WaveRunner", "plan_waves",
]
