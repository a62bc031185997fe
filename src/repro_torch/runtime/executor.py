"""The action engine (synchronous): dispatch, counter sync, reports.

:mod:`repro_torch.core.planner` stops at *lowering*.  Everything that
happens when an action fires lives here:

* **Counter sync** — stage counters (shuffle drops, key-table overflow,
  exchange volume) come back as one packed int32 vector from the
  dispatched program and are copied to the host and checked ONCE per
  action, here, not per stage.
* **Device wait** — the program's kernels run asynchronously; the
  executor synchronises the device before the counter sync, so device
  time lands in the action that spent it (``device_wait``).
* **Structured diagnostics** — every action appends an
  :class:`~repro_torch.runtime.reports.ActionReport` to a bounded history.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import planner as planner_lib
from repro_torch.core.dataset import ShardedDataset
from repro_torch.core.plan import Plan
from repro_torch.runtime.lineage import Lineage, host_root
from repro_torch.runtime.reports import ActionReport, ReportLog, timed

#: Counter kinds reduced with max across shards instead of sum (bounds,
#: not totals) — see :func:`repro_torch.core.plan.stage_counter_kinds`.
MAX_COUNTER_KINDS = frozenset({"max_send_count"})


def check_counters(counter_vec: torch.Tensor, specs, num_shards: int,
                   diagnostics: Optional[Dict[str, int]] = None,
                   stage_offset: int = 0) -> None:
    """One host sync for ALL stage counters, after the single dispatch.

    Error kinds (shuffle drops, keyed overflow) raise; every kind lands
    in ``diagnostics`` keyed ``"stage<i>.<kind>"``.  Most kinds are totals
    and sum across shards; ``max_send_count`` is a bound and max-reduces.
    """
    grid = counter_vec.cpu().numpy().reshape(num_shards, len(specs))
    per = [int(grid[:, i].max()) if kind in MAX_COUNTER_KINDS
           else int(grid[:, i].sum())
           for i, (_, kind) in enumerate(specs)]
    if diagnostics is not None:
        for (stage_idx, kind), total in zip(specs, per):
            diagnostics[f"stage{stage_idx + stage_offset}.{kind}"] = \
                int(total)
    drops = [(stage_idx + stage_offset, int(total))
             for (stage_idx, kind), total in zip(specs, per)
             if kind == "shuffle_dropped" and total]
    if drops:
        total = sum(t for _, t in drops)
        raise RuntimeError(
            f"repartition_by overflow: {total} records dropped "
            f"(per stage: {drops}); raise `capacity` (paper analogue: "
            "partition exceeded tmpfs capacity — fall back to a larger "
            "staging area)")
    key_ovf = [(stage_idx + stage_offset, int(total))
               for (stage_idx, kind), total in zip(specs, per)
               if kind == "key_overflow" and total]
    if key_ovf:
        total = sum(t for _, t in key_ovf)
        raise RuntimeError(
            f"reduce_by_key key-table overflow: {total} records had keys "
            f"outside [0, num_keys) (per stage: {key_ovf}); raise "
            "`num_keys` or fix `key_by`")


def _device_wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(ds: ShardedDataset, plan: Plan, *,
            cache: Optional["planner_lib.PlanCache"] = None,
            fuse: bool = True,
            diagnostics: Optional[Dict[str, int]] = None,
            stage_offset: int = 0,
            phases: Optional[Dict[str, float]] = None) -> ShardedDataset:
    """Dispatch a plan against a dataset (no lineage/report bookkeeping —
    that is :meth:`Executor.run`; this is the bare engine under it).

    ``fuse=True`` (default): one lowered program for the entire DAG,
    counters checked once after it.  ``fuse=False``: stage-at-a-time
    execution (each stage its own program, counters synced after each).
    ``diagnostics`` is filled with per-counter totals; ``phases``
    accumulates the wall breakdown (plan.build / dispatch / device_wait /
    counter_sync).
    """
    if plan.empty:
        return ds
    if not fuse:
        for i, stage in enumerate(plan.stages):
            ds = execute(ds, Plan(stages=(stage,)), cache=cache, fuse=True,
                         diagnostics=diagnostics,
                         stage_offset=stage_offset + i, phases=phases)
        return ds
    prog = planner_lib.compile_plan(plan, ds, cache, phases=phases)
    with timed("dispatch", phases):
        outs = prog(ds.records, ds.counts)
    if prog.num_counters:
        out_records, out_counts, counter_vec = outs
    else:
        out_records, out_counts = outs
    with timed("device_wait", phases):
        _device_wait(ds.device)
    if prog.num_counters:
        with timed("counter_sync", phases):
            check_counters(counter_vec, prog.counters, ds.num_shards,
                           diagnostics, stage_offset)
    return ShardedDataset(records=out_records, counts=out_counts,
                          num_shards=ds.num_shards)


class Executor:
    """Runs actions synchronously against one plan cache and keeps their
    reports.  ``plan_cache`` defaults to the process-wide
    :data:`repro_torch.core.planner.DEFAULT_CACHE`."""

    def __init__(self, plan_cache: Optional["planner_lib.PlanCache"] = None,
                 report_history: int = 256) -> None:
        self.plan_cache = plan_cache
        self.reports = ReportLog(report_history)

    def ensure_lineage(self, ds: ShardedDataset) -> Lineage:
        """Dataset's lineage root, assigning a fresh host root once for
        datasets of unknown provenance."""
        if ds.lineage is None:
            ds.lineage = host_root()
        return ds.lineage

    def run(self, ds: ShardedDataset, plan: Plan, *,
            fuse: bool = True,
            plan_cache: Optional["planner_lib.PlanCache"] = None,
            reports: Optional[ReportLog] = None,
            label: Optional[str] = None
            ) -> Tuple[ShardedDataset, ActionReport]:
        """Run one action: dispatch, counter check, report.  Returns the
        materialized dataset (lineage = root + whole plan) and the
        action's report."""
        cache = plan_cache if plan_cache is not None else self.plan_cache
        cache = cache if cache is not None else planner_lib.DEFAULT_CACHE
        t0 = time.perf_counter()
        before = cache.stats()
        result_lineage = self.ensure_lineage(ds).extend(plan)
        counters: Dict[str, int] = {}
        phases: Dict[str, float] = {}
        device = str(ds.device)
        if not plan.empty:
            ds = execute(ds, plan, cache=cache, fuse=fuse,
                         diagnostics=counters, phases=phases)
            ds.lineage = result_lineage
        after = cache.stats()
        report = ActionReport(
            action_id=self.reports.new_id(),
            plan=plan.describe(),
            total_stages=len(plan.stages),
            lineage=ds.lineage.digest() if ds.lineage else None,
            counters=counters,
            programs_compiled=after["misses"] - before["misses"],
            program_cache_hits=after["hits"] - before["hits"],
            wall_s=time.perf_counter() - t0,
            phases=phases,
            label=label,
            device=device)
        self.reports.append(report)
        if reports is not None:
            reports.append(report)
        return ds, report


#: Process-wide default engine shared by MaRe actions.
DEFAULT_EXECUTOR = Executor()
