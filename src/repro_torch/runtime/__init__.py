"""repro_torch.runtime — the action engine.

Layering (bottom-up): ``repro_torch.io`` ingests bytes into sharded
datasets, ``repro_torch.core.plan`` accumulates lazy stage DAGs with
plan-time type inference, ``repro_torch.core.planner`` lowers a DAG into
one memoized program, and **this package executes actions**: lineage
fingerprints (:mod:`~repro_torch.runtime.lineage`), the budgeted
device/host materialization cache behind ``MaRe.persist()``
(:mod:`~repro_torch.runtime.cache`), the dispatch/counter-sync/report
engine with async action handles (:mod:`~repro_torch.runtime.executor`),
and structured per-action diagnostics
(:mod:`~repro_torch.runtime.reports`).
"""
from repro_torch.runtime.cache import (DEVICE_BUDGET_DEFAULT,
                                       HOST_BUDGET_DEFAULT, CacheEntry,
                                       MaterializationCache, estimate_nbytes)
from repro_torch.runtime.executor import (DEFAULT_EXECUTOR, ActionHandle,
                                          Executor, check_counters, execute)
from repro_torch.runtime.lineage import (Lineage, host_root, source_root,
                                         stream_root)
from repro_torch.runtime.reports import ActionReport, ReportLog

__all__ = [
    "ActionHandle", "ActionReport", "CacheEntry", "DEFAULT_EXECUTOR",
    "DEVICE_BUDGET_DEFAULT", "Executor", "HOST_BUDGET_DEFAULT", "Lineage",
    "MaterializationCache", "ReportLog", "check_counters",
    "estimate_nbytes", "execute", "host_root", "source_root",
    "stream_root",
]
