"""QueryService: the shared multi-tenant engine behind every Session.

One service owns one :class:`~repro_torch.runtime.executor.Executor` and puts
three policies between sessions and it:

1. **Admission + fairness** — submissions pass the
   :class:`~repro_torch.serve.scheduler.DeficitRoundRobin` front door
   (per-tenant and total backlog limits raise
   :class:`~repro_torch.serve.scheduler.AdmissionError`), and a single pump
   thread drains the tenant queues in DRR order into the executor's
   *bounded* dispatch queue — when the device is saturated the pump
   blocks on that queue, backlog accumulates under per-tenant limits,
   and overload surfaces as rejections at the offending tenant instead
   of unbounded latency for everyone.
2. **Batching** — after taking a leader the pump waits
   ``batch_window_s`` and extracts every queued action with the same
   :func:`~repro_torch.serve.batching.batch_key` (any tenant), executing the
   group as ONE executor action; every member's handle resolves to the
   shared value and receives its own per-tenant
   :class:`~repro_torch.runtime.reports.ActionReport` clone (``batch_size``,
   ``batch_leader``, own ``queue_wait_s``).
3. **Cache partitioning** — the config's per-tenant budgets are applied
   to the executor's :class:`~repro_torch.runtime.cache.MaterializationCache`,
   and ``Session.persist`` charges entries to the owning tenant, so one
   tenant's persists can only evict that tenant's entries; *reads* of a
   common lineage prefix stay shared across tenants (counted as
   ``shared_hits``).

Metrics (process registry): ``serve.queue_depth.<tenant>`` gauges,
``serve.admission_rejected`` counter, ``serve.dispatches`` counter,
``serve.batched_followers`` counter, ``serve.batch_occupancy``
histogram (mean = average actions per dispatch),
``serve.service_s_per_cost`` histogram (the latency-admission rate
estimate's samples) and ``serve.latency_rejected`` counter (rejections
from the predicted-delay bound specifically).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional

from repro_torch.core.dataset import ShardedDataset
from repro_torch.core.plan import Plan
from repro_torch.obs import METRICS
from repro_torch.runtime.executor import ActionHandle, Executor, on_device
from repro_torch.serve.batching import Pending, batch_key
from repro_torch.serve.scheduler import AdmissionError, DeficitRoundRobin


@dataclasses.dataclass
class ServiceConfig:
    """Knobs of one QueryService (all enforced per service instance)."""

    #: Admission: max actions queued per tenant / across all tenants.
    max_queued_per_tenant: int = 8
    max_queued_total: int = 64
    #: DRR credit granted per rotation visit (stage-count units).
    quantum: float = 4.0
    #: Priority tiers: per-tenant DRR weight (a visit grants
    #: ``quantum * weight``, so a weight-3 tenant is served ~3x the cost
    #: of a weight-1 tenant under saturation).  Unlisted tenants get
    #: ``default_weight``.
    tenant_weights: Optional[dict] = None
    default_weight: float = 1.0
    #: Latency-aware admission: reject a submission when its *predicted
    #: queue delay* — (queued cost + its own cost) x the recently observed
    #: seconds-per-cost-unit service rate — exceeds this bound.  None
    #: disables the check (backlog-count limits still apply).  Cold start
    #: admits: with no completed dispatches yet there is no rate to
    #: predict from.
    max_predicted_delay_s: Optional[float] = None
    #: How many recent dispatches the service-rate estimate averages over.
    service_rate_window: int = 32
    #: How long the pump lingers after taking a leader before harvesting
    #: same-key followers.  0 disables batching (strict DRR order).
    batch_window_s: float = 0.01
    #: Per-tenant materialization-cache partitions (None = tier budget is
    #: the only limit).  Applied to the executor's cache at construction.
    tenant_device_budget_bytes: Optional[int] = None
    tenant_host_budget_bytes: Optional[int] = None
    #: Bound of the underlying executor's dispatch queue when the service
    #: constructs its own executor (ignored for a passed-in executor).
    executor_max_pending: int = 2


class QueryService:
    """Shared engine: admission -> fair queue -> batch -> executor.

    Context-manager friendly (``with QueryService() as svc:``) — exit
    stops the pump thread.  All state is per-instance; two services
    never share queues (they may share an executor, though that forfeits
    cross-service fairness).
    """

    def __init__(self, executor: Optional[Executor] = None,
                 config: Optional[ServiceConfig] = None) -> None:
        self.config = config if config is not None else ServiceConfig()
        if executor is None:
            executor = Executor(
                max_pending=self.config.executor_max_pending)
        self.executor = executor
        cache = executor.mat_cache
        if self.config.tenant_device_budget_bytes is not None:
            cache.tenant_device_budget_bytes = \
                self.config.tenant_device_budget_bytes
        if self.config.tenant_host_budget_bytes is not None:
            cache.tenant_host_budget_bytes = \
                self.config.tenant_host_budget_bytes
        self.scheduler = DeficitRoundRobin(
            quantum=self.config.quantum,
            max_queued_per_tenant=self.config.max_queued_per_tenant,
            max_queued_total=self.config.max_queued_total,
            weights=self.config.tenant_weights,
            default_weight=self.config.default_weight)
        # recent (wall_s / cost) samples for latency-aware admission
        self._rate_lock = threading.Lock()
        self._rate_samples: deque = deque(
            maxlen=max(1, self.config.service_rate_window))
        self._stop = threading.Event()
        self._pump: Optional[threading.Thread] = None
        self._pump_lock = threading.Lock()

    # -- session factory -----------------------------------------------------

    def session(self, tenant: str) -> "Session":
        """A :class:`~repro_torch.serve.session.Session` bound to this service."""
        from repro_torch.serve.session import Session  # session imports service
        return Session(tenant, service=self)

    # -- submission (called by sessions, any thread) -------------------------

    def submit(self, *, tenant: str, ds: ShardedDataset, plan: Plan,
               finalize: Optional[Callable[[ShardedDataset], Any]] = None,
               fuse: bool = True, plan_cache: Any = None,
               reports: Any = None,
               label: Optional[str] = None) -> ActionHandle:
        """Admit one action for ``tenant`` and return its handle.

        Raises :class:`AdmissionError` when the tenant's (or the total)
        backlog limit is hit — nothing is queued in that case.
        """
        root = self.executor.ensure_lineage(ds)
        key = batch_key(root, plan, fuse=fuse, finalize=finalize,
                        plan_cache=plan_cache)
        handle = ActionHandle(label=label)
        handle.submitted_at = time.monotonic()
        item = Pending(key=key, tenant=tenant, ds=ds, plan=plan, fuse=fuse,
                       plan_cache=plan_cache, finalize=finalize,
                       reports=reports, label=label,
                       cost=max(1, len(plan.stages)), handle=handle,
                       submitted_at=handle.submitted_at)
        bound = self.config.max_predicted_delay_s
        if bound is not None:
            rate = self.service_rate()
            if rate is not None:
                # backlog cost (everything already admitted, any tenant)
                # plus this action, at the recently observed pace
                predicted = (self.scheduler.total_cost() + item.cost) * rate
                if predicted > bound:
                    METRICS.counter("serve.admission_rejected").inc()
                    METRICS.counter("serve.latency_rejected").inc()
                    raise AdmissionError(
                        f"predicted queue delay {predicted:.3f}s exceeds "
                        f"max_predicted_delay_s={bound:.3f}s "
                        f"(backlog cost {self.scheduler.total_cost():.1f} "
                        f"at {rate * 1e3:.2f}ms/cost-unit)",
                        tenant, "latency")
        try:
            self.scheduler.offer(tenant, item, cost=item.cost)
        except AdmissionError:
            METRICS.counter("serve.admission_rejected").inc()
            raise
        METRICS.gauge(f"serve.queue_depth.{tenant}").add(1)
        self._ensure_pump()
        return handle

    # -- latency-aware admission ---------------------------------------------

    def service_rate(self) -> Optional[float]:
        """Mean seconds per cost unit over the recent dispatch window
        (None until the first dispatch completes — cold start admits)."""
        with self._rate_lock:
            if not self._rate_samples:
                return None
            return sum(self._rate_samples) / len(self._rate_samples)

    def observe_service_rate(self, wall_s: float, cost: float) -> None:
        """Record one completed dispatch's pace.  Called by the dispatch
        path; exposed so tests can seed the estimator deterministically."""
        sample = max(0.0, wall_s) / max(cost, 1e-9)
        with self._rate_lock:
            self._rate_samples.append(sample)
        METRICS.histogram("serve.service_s_per_cost").observe(sample)

    # -- the pump thread -----------------------------------------------------

    def _ensure_pump(self) -> None:
        with self._pump_lock:
            if self._pump is None or not self._pump.is_alive():
                self._stop.clear()
                self._pump = threading.Thread(
                    target=self._pump_loop, name="repro-torch-serve-pump",
                    daemon=True)
                self._pump.start()

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            leader = self.scheduler.take(timeout=0.1)
            if leader is None:
                continue
            group = [leader]
            if self.config.batch_window_s > 0:
                # linger: same-key submissions racing with the take get
                # to join this dispatch instead of paying their own
                time.sleep(self.config.batch_window_s)
                key = leader.key
                group += self.scheduler.extract(lambda p: p.key == key)
            for member in group:
                METRICS.gauge(
                    f"serve.queue_depth.{member.tenant}").add(-1)
            METRICS.counter("serve.dispatches").inc()
            METRICS.histogram("serve.batch_occupancy").observe(len(group))
            if len(group) > 1:
                METRICS.counter("serve.batched_followers").inc(
                    len(group) - 1)
            self._dispatch(group)

    def _dispatch(self, group: List[Pending]) -> None:
        """Hand one coalesced group to the executor (blocks on its
        bounded queue — the backpressure layer)."""
        leader = group[0]

        def action(_h: ActionHandle) -> None:
            started = time.monotonic()
            try:
                out, report = self.executor.run(
                    leader.ds, leader.plan, fuse=leader.fuse,
                    plan_cache=leader.plan_cache, reports=None,
                    label=leader.label,
                    queue_wait_s=max(0.0, started - leader.submitted_at),
                    tenant=leader.tenant)
                with on_device(out.device):
                    value = (leader.finalize(out)
                             if leader.finalize is not None else out)
                self.observe_service_rate(report.wall_s, leader.cost)
            except BaseException as e:
                # the whole group shares one plan, so it shares the
                # failure; OTHER keys/tenants are untouched
                for member in group:
                    member.handle.started_at = started
                    member.handle._finish(error=e)
                return None
            for member in group:
                clone = dataclasses.replace(
                    report,
                    tenant=member.tenant, label=member.label,
                    queue_wait_s=max(0.0,
                                     started - member.submitted_at),
                    batch_size=len(group),
                    batch_leader=report.action_id)
                if member.reports is not None:
                    clone = dataclasses.replace(
                        clone, action_id=member.reports.new_id())
                    member.reports.append(clone)
                member.handle.report = clone
                member.handle.started_at = started
                member.handle._finish(value=value)
            return None

        self.executor.submit(action, label=leader.label)

    # -- lifecycle -----------------------------------------------------------

    def close(self, timeout: float = 2.0) -> None:
        """Stop the pump thread (queued-but-undispatched actions stay
        queued; their handles never resolve — close after draining)."""
        self._stop.set()
        pump = self._pump
        if pump is not None and pump.is_alive():
            pump.join(timeout)

    def __enter__(self) -> "QueryService":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
