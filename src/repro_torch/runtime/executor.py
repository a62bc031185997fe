"""The action engine: dispatch, counter sync, prefix reuse, async actions.

:mod:`repro_torch.core.planner` stops at *lowering*.  Everything that
happens when an action fires lives here:

* **Prefix reuse** — before dispatching, the executor looks up the
  longest plan prefix whose lineage node is materialized in the
  :class:`~repro_torch.runtime.cache.MaterializationCache`; the action
  starts from that cached dataset and only executes the suffix (the
  paper's interactive processing: many queries over one persisted
  dataset pay the shared prefix once).
* **Counter sync** — stage counters (shuffle drops, key-table overflow,
  exchange volume) come back as one packed int32 vector from the
  dispatched program and are copied to the host and checked ONCE per
  action, here, not per stage.
* **Device wait** — the program's kernels run asynchronously; the
  executor waits for an event recorded on the action's own stream after
  its last launch, so device time lands in the action that spent it
  (``device_wait``) and never waits for another thread's stream (the
  wave runner ingests the next wave on a side stream meanwhile).
* **Structured diagnostics** — every action appends an
  :class:`~repro_torch.runtime.reports.ActionReport` to a bounded history.
* **Async actions** — :meth:`Executor.submit_action` queues the action
  on one dispatch thread behind a *bounded* queue and returns an
  :class:`ActionHandle`; backpressure keeps at most ``max_pending``
  actions queued.  The worker runs each action under
  ``torch.cuda.device(<the dataset's device>)``, since the current device
  is per thread.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import planner as planner_lib
from repro_torch.core.dataset import ShardedDataset
from repro_torch.core.plan import Plan
from repro_torch.obs import METRICS, span, timed
from repro_torch.runtime.cache import MaterializationCache
from repro_torch.runtime.lineage import Lineage, host_root
from repro_torch.runtime.reports import ActionReport, ReportLog

#: Guards the check-then-set of ShardedDataset.lineage: an async action on
#: the dispatch thread and a describe()/action on the caller thread may
#: race to root the SAME dataset object.
_LINEAGE_LOCK = threading.Lock()

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
    for (stage_idx, kind), total in zip(specs, per):
        METRICS.counter(f"counters.{kind}").inc(int(total))
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


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, else a no-op: the
    current device is per thread, so work moved to another thread names
    its device again."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _device_wait(device: torch.device) -> None:
    """Wait for this thread's work on ``device``: an event recorded on
    the calling thread's current stream after the action's last launch.
    A device-wide synchronize would also wait for other threads' streams
    (the wave runner's ingest of the next wave)."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


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
    counter_sync).  ``stage_offset`` shifts reported stage indices when
    the plan is the suffix of a longer one (prefix served from the
    materialization cache).
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
    with timed("dispatch", phases, stages=len(plan.stages)) as sp:
        outs = prog(ds.records, ds.counts, span=sp)
    if prog.num_counters:
        out_records, out_counts, counter_vec = outs
    else:
        out_records, out_counts = outs
    with timed("device_wait", phases):
        _device_wait(ds.device)
    if prog.num_counters:
        with timed("counter_sync", phases,
                   num_counters=prog.num_counters):
            check_counters(counter_vec, prog.counters, ds.num_shards,
                           diagnostics, stage_offset)
    return ShardedDataset(records=out_records, counts=out_counts,
                          num_shards=ds.num_shards)


class ActionHandle:
    """Future-like handle to an asynchronously dispatched action."""

    def __init__(self, label: Optional[str] = None) -> None:
        self.label = label
        self.report: Optional[ActionReport] = None
        #: Set by Executor.submit / the dispatch worker: when the action
        #: entered the queue and when the worker dequeued it.
        self.submitted_at: Optional[float] = None
        self.started_at: Optional[float] = None
        self._done = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    @property
    def queue_wait_s(self) -> float:
        """Seconds spent queued behind earlier actions (0.0 until the
        dispatch worker picks this action up)."""
        if self.submitted_at is None or self.started_at is None:
            return 0.0
        return max(0.0, self.started_at - self.submitted_at)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block for the action's value.  A ``TimeoutError`` does NOT
        poison the handle: a later ``result()`` call still succeeds once
        the action completes."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"action {self.label or ''} still pending")
        if self._error is not None:
            raise self._error
        return self._value

    # -- producer side (executor thread only) --------------------------------

    def _finish(self, value: Any = None,
                error: Optional[BaseException] = None) -> None:
        self._value = value
        self._error = error
        self._done.set()


class Executor:
    """Owns action dispatch against one pair of caches.

    ``plan_cache`` — lowered-program memoization (defaults to the
    process-wide :data:`repro_torch.core.planner.DEFAULT_CACHE`; a
    per-action override may be passed to :meth:`run`).  ``mat_cache`` —
    the lineage-keyed materialization store that ``persist()`` feeds and
    prefix lookup reads.  ``max_pending`` bounds the async dispatch queue
    (submitting beyond it blocks the caller — backpressure).
    """

    def __init__(self, plan_cache: Optional["planner_lib.PlanCache"] = None,
                 mat_cache: Optional[MaterializationCache] = None,
                 max_pending: int = 2,
                 report_history: int = 256) -> None:
        self.plan_cache = plan_cache
        self.mat_cache = mat_cache if mat_cache is not None \
            else MaterializationCache()
        self.reports = ReportLog(report_history)
        self.max_pending = max_pending
        self._run_lock = threading.RLock()
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()

    # -- lineage -------------------------------------------------------------

    def ensure_lineage(self, ds: ShardedDataset) -> Lineage:
        """Dataset's lineage root, assigning a fresh host root once for
        datasets of unknown provenance (mutates ``ds`` in place so every
        handle over the same dataset object shares the root)."""
        if ds.lineage is None:
            with _LINEAGE_LOCK:
                if ds.lineage is None:
                    ds.lineage = host_root()
        return ds.lineage

    def cached_prefix(self, ds: ShardedDataset, plan: Plan
                      ) -> Tuple[int, Optional[Lineage]]:
        """(stage count, lineage) of the longest materialized plan prefix
        — key lookup only, safe for ``describe()``."""
        if plan.empty:
            return 0, None
        return self.mat_cache.longest_prefix(self.ensure_lineage(ds), plan)

    # -- synchronous actions -------------------------------------------------

    def run(self, ds: ShardedDataset, plan: Plan, *,
            fuse: bool = True,
            plan_cache: Optional["planner_lib.PlanCache"] = None,
            reports: Optional[ReportLog] = None,
            label: Optional[str] = None,
            queue_wait_s: float = 0.0,
            tenant: Optional[str] = None
            ) -> Tuple[ShardedDataset, ActionReport]:
        """Run one action: prefix lookup, suffix dispatch, counter check,
        report.  Returns the materialized dataset (lineage = root + whole
        plan) and the action's report.  ``queue_wait_s`` is the async
        path's measured time on the queue, recorded on the report
        (execution wall time starts here, not at submit); ``tenant`` tags
        the report and the cache lookup with the session that issued the
        action."""
        cache = plan_cache if plan_cache is not None else self.plan_cache
        cache = cache if cache is not None else planner_lib.DEFAULT_CACHE
        with self._run_lock, on_device(ds.device), \
                span("action", plan=plan.describe(),
                     label=label) as action_span:
            t0 = time.monotonic()
            before = cache.stats()
            root = self.ensure_lineage(ds)
            result_lineage = root.extend(plan)
            counters: Dict[str, int] = {}
            phases: Dict[str, float] = {}
            device = str(ds.device)
            cached_stages, cache_tier = 0, None
            if not plan.empty:
                with timed("cache_lookup", phases):
                    k, tier, cached = self.mat_cache.lookup_prefix(
                        root, plan, tenant=tenant)
                if cached is not None:
                    ds = cached
                    cached_stages = k
                    cache_tier = tier
                ds = execute(ds, plan.drop(cached_stages), cache=cache,
                             fuse=fuse, diagnostics=counters,
                             stage_offset=cached_stages, phases=phases)
                ds.lineage = result_lineage
            after = cache.stats()
            report = ActionReport(
                action_id=self.reports.new_id(),
                plan=plan.describe(),
                total_stages=len(plan.stages),
                cached_stages=cached_stages,
                cache_tier=cache_tier,
                lineage=ds.lineage.digest() if ds.lineage else None,
                counters=counters,
                programs_compiled=after["misses"] - before["misses"],
                program_cache_hits=after["hits"] - before["hits"],
                wall_s=time.monotonic() - t0,
                phases=phases,
                queue_wait_s=queue_wait_s,
                label=label,
                tenant=tenant,
                device=device)
            action_span.set(action_id=report.action_id,
                            cached_stages=cached_stages)
            ds.action_id = report.action_id
            METRICS.counter("executor.actions").inc()
            for phase, s in phases.items():
                METRICS.histogram(f"phase.{phase}").observe(s)
            if queue_wait_s:
                METRICS.histogram("phase.queue_wait").observe(queue_wait_s)
            self.reports.append(report)
            if reports is not None:
                reports.append(report)
            return ds, report

    def persist(self, ds: ShardedDataset, tier: str = "device",
                owner: Optional[str] = None):
        """Register a materialized dataset in the materialization cache
        under its lineage (``MaRe.persist()``'s engine half).  ``owner``
        charges the entry to that tenant's cache-budget partition."""
        self.ensure_lineage(ds)
        return self.mat_cache.put(ds, tier=tier, owner=owner)

    # -- async actions -------------------------------------------------------

    def _ensure_worker(self) -> None:
        with self._worker_lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._drain, name="repro-torch-executor",
                    daemon=True)
                self._worker.start()

    def _drain(self) -> None:
        while True:
            handle, fn = self._queue.get()
            METRICS.gauge("executor.queue_depth").set(self._queue.qsize())
            handle.started_at = time.monotonic()
            value, error = None, None
            try:
                value = fn(handle)
            except BaseException as e:          # delivered via result()
                error = e
            # the action closure holds its input dataset (a whole wave on
            # the wave path): drop it before the handle resolves, so a
            # caller that waits on result() and then ingests the next
            # wave never has three waves resident
            del fn
            handle._finish(value=value, error=error)
            del handle, value, error
            self._queue.task_done()

    def submit(self, fn: Callable[[ActionHandle], Any],
               label: Optional[str] = None) -> ActionHandle:
        """Queue ``fn(handle)`` on the dispatch thread (FIFO, bounded:
        blocks when ``max_pending`` actions are already queued)."""
        self._ensure_worker()
        handle = ActionHandle(label=label)
        handle.submitted_at = time.monotonic()
        self._queue.put((handle, fn))
        METRICS.gauge("executor.queue_depth").set(self._queue.qsize())
        return handle

    def submit_action(self, ds: ShardedDataset, plan: Plan, *,
                      finalize: Optional[Callable[[ShardedDataset], Any]]
                      = None,
                      fuse: bool = True,
                      plan_cache: Optional["planner_lib.PlanCache"] = None,
                      reports: Optional[ReportLog] = None,
                      label: Optional[str] = None,
                      tenant: Optional[str] = None) -> ActionHandle:
        """Async :meth:`run`: dispatch the plan on the executor thread and
        (optionally) post-process the materialized dataset with
        ``finalize`` (e.g. ``dataset.collect``); the handle resolves to
        ``finalize(ds)`` (or the dataset itself).  Queue wait (submit ->
        worker dequeue) is measured separately from execution and lands
        in ``report.queue_wait_s``."""

        def action(handle: ActionHandle) -> Any:
            out, report = self.run(ds, plan, fuse=fuse,
                                   plan_cache=plan_cache, reports=reports,
                                   label=label,
                                   queue_wait_s=handle.queue_wait_s,
                                   tenant=tenant)
            handle.report = report
            with on_device(out.device):
                return finalize(out) if finalize is not None else out

        return self.submit(action, label=label)


#: Process-wide default engine: MaRe actions and WaveRunner waves share it
#: (and, through it, the planner's DEFAULT_CACHE), so interactive handles,
#: eager actions and out-of-core waves see one materialization cache and
#: one report history.
DEFAULT_EXECUTOR = Executor()
