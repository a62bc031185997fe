"""repro_torch.core — MaRe's primitives over logical shards on one device.

MapReduce-oriented primitives (map / reduce / repartition_by /
reduce_by_key) over a sharded dataset, with ContainerOps (named,
registered, self-contained transformations) standing in for Docker
images.  Mirrors :mod:`repro.core` module by module.
"""
from repro_torch.core.container import (ContainerOp, Partition, Registry,
                                        DEFAULT_REGISTRY, container_op,
                                        make_partition, pull, register)
from repro_torch.core.dataset import (ShardedDataset, collect,
                                      collect_first_shard, collect_shard,
                                      from_host, from_numpy, resolve_device)
from repro_torch.core.manifests import (ArgSpec, CommandSpec, Contract,
                                        ImageManifest, PRESERVE,
                                        PlanTypeError, SAME)
from repro_torch.core.mare import MaRe
from repro_torch.core.mounts import (BinaryFiles, FileSetMount, Mount,
                                     RecordMount, TextFile)
from repro_torch.core.plan import (KEYED_MONOIDS, KeyedReduceStage,
                                   MapStage, Plan, ReduceStage, ShuffleStage,
                                   StageState, infer_states)
from repro_torch.core.planner import (DEFAULT_CACHE, PlanCache, compile_plan,
                                      program_key)
from repro_torch.core.schema import (Field, Schema, SchemaMismatch,
                                     bytes_record_schema, field,
                                     schema_of_records)
from repro_torch.core.shuffle import (ShuffleResult, all_to_all, hash_keys,
                                      keyed_bucket_capacity,
                                      shuffle_partition)
from repro_torch.core.tree_reduce import (broadcast_from_zero,
                                          keyed_combine_partition,
                                          keyed_merge_partition,
                                          merge_keyed_tables,
                                          segment_table_to_partition,
                                          split_factors,
                                          tree_reduce_partition)
from repro_torch.core import images as _images  # registers standard images


def __getattr__(name):
    # execution lives in the runtime layer; `execute` stays importable
    # from repro_torch.core as in the reference, resolved lazily so
    # neither package requires the other at module-import time
    if name == "execute":
        from repro_torch.runtime.executor import execute
        return execute
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "MaRe", "ContainerOp", "Partition", "Registry", "DEFAULT_REGISTRY",
    "container_op", "make_partition", "pull", "register",
    "ShardedDataset", "collect", "collect_first_shard", "collect_shard",
    "from_host", "from_numpy",
    "resolve_device",
    "Mount", "RecordMount", "FileSetMount", "TextFile", "BinaryFiles",
    "Plan", "MapStage", "ShuffleStage", "ReduceStage", "KeyedReduceStage",
    "KEYED_MONOIDS", "StageState", "infer_states",
    "ImageManifest", "CommandSpec", "ArgSpec", "Contract", "PlanTypeError",
    "PRESERVE", "SAME",
    "Field", "Schema", "SchemaMismatch", "bytes_record_schema", "field",
    "schema_of_records",
    "PlanCache", "DEFAULT_CACHE", "compile_plan", "execute", "program_key",
    "ShuffleResult", "all_to_all", "hash_keys", "shuffle_partition",
    "keyed_bucket_capacity",
    "broadcast_from_zero", "split_factors", "tree_reduce_partition",
    "keyed_combine_partition", "keyed_merge_partition",
    "merge_keyed_tables", "segment_table_to_partition",
]
