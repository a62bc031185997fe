"""Cross-session dispatch coalescing: the batch key and the queue record.

Interactive multi-tenant load is repetitive: dashboards and notebooks
from different sessions fire the *same* compiled plan over the *same*
persisted dataset.  Executing each copy serially through the executor
wastes the device; the service instead groups queued actions whose
results are provably identical and dispatches the group ONCE — the
leader executes, every member's handle resolves to the shared value.

"Provably identical" is :func:`batch_key`:

* the **result lineage digest** — root fingerprint of the underlying
  dataset extended by the pending plan's canonical stage signatures.
  Two sessions batch only when they act on the same source through the
  same logical stages (module-level ``key_by``/``value_by`` callables
  keep signatures equal across sessions; lambdas defeat coalescing the
  same way they defeat the compile cache);
* the **finalize identity** — ``collect()`` vs ``collect(shard=0)``
  produce different host values, so the per-shard finalizers are cached
  module-level partials (one object per shard index) and the sync path
  always uses ``finalize=None``;
* the **fuse flag** and **plan-cache identity** — different execution
  configurations never share a dispatch, even though their values would
  match (keeps per-config diagnostics honest).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Tuple

from repro_torch.core.plan import Plan
from repro_torch.core.dataset import ShardedDataset
from repro_torch.runtime.executor import ActionHandle
from repro_torch.runtime.lineage import Lineage
from repro_torch.runtime.reports import ReportLog

#: (lineage digest, fuse, finalize id, plan-cache id)
BatchKey = Tuple[str, bool, Optional[int], Optional[int]]


def batch_key(root: Lineage, plan: Plan, *, fuse: bool,
              finalize: Optional[Callable], plan_cache: Any) -> BatchKey:
    """Key under which queued actions may share one dispatch."""
    lineage = root if plan.empty else root.extend(plan)
    return (lineage.digest(), fuse,
            id(finalize) if finalize is not None else None,
            id(plan_cache) if plan_cache is not None else None)


@dataclasses.dataclass
class Pending:
    """One admitted, not-yet-dispatched action in a tenant's queue."""

    key: BatchKey
    tenant: str
    ds: ShardedDataset
    plan: Plan
    fuse: bool
    plan_cache: Any
    finalize: Optional[Callable[[ShardedDataset], Any]]
    reports: Optional[ReportLog]          # the session's report stream
    label: Optional[str]
    cost: float                           # DRR cost (pending stage count)
    handle: ActionHandle                  # resolved at dispatch completion
    submitted_at: float = dataclasses.field(
        default_factory=time.monotonic)
