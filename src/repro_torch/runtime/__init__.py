"""repro_torch.runtime — the synchronous action engine: lineage
fingerprints, dispatch with one counter sync per action, and per-action
reports."""
from repro_torch.runtime.executor import (DEFAULT_EXECUTOR, Executor,
                                          check_counters, execute)
from repro_torch.runtime.lineage import Lineage, host_root, source_root
from repro_torch.runtime.reports import ActionReport, ReportLog

__all__ = ["ActionReport", "DEFAULT_EXECUTOR", "Executor", "Lineage",
           "ReportLog", "check_counters", "execute", "host_root",
           "source_root"]
