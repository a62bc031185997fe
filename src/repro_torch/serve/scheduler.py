"""Admission control + deficit-round-robin fair queueing across tenants.

The scheduler is the service's front door: :meth:`DeficitRoundRobin.offer`
either enqueues an action under its tenant or raises :class:`AdmissionError`
(per-tenant or total backlog limit hit — the caller sees the rejection
immediately instead of a silently growing queue), and
:meth:`DeficitRoundRobin.take` hands the pump thread the next action to
dispatch under deficit round robin [Shreedhar & Varghese '96]: each
non-empty tenant in rotation accrues ``quantum`` credit per visit and is
served while the credit covers the head action's cost (we cost an action
by its pending stage count, so a tenant burning 10-stage chains cannot
starve one issuing 1-stage lookups).  A tenant's credit resets when its
queue drains — idle tenants cannot bank credit.

The scheduler is deliberately free of service concerns: no metrics, no
batching, no executor — it queues opaque items with a ``cost`` and picks
fairly.  Batching support is the one extension: :meth:`extract` removes
every queued item matching a predicate (the service pulls same-key
actions out of ALL tenant queues to coalesce them into one dispatch).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional


class AdmissionError(RuntimeError):
    """Raised by :meth:`DeficitRoundRobin.offer` when a backlog limit is
    hit.  Carries ``tenant`` and ``scope`` (``"tenant"`` or ``"total"``)
    so callers/tests can distinguish which limit rejected."""

    def __init__(self, message: str, tenant: str, scope: str) -> None:
        super().__init__(message)
        self.tenant = tenant
        self.scope = scope


class DeficitRoundRobin:
    """Thread-safe per-tenant FIFO queues served in DRR order."""

    def __init__(self, quantum: float = 4.0,
                 max_queued_per_tenant: int = 8,
                 max_queued_total: int = 64,
                 weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0) -> None:
        if quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        if default_weight <= 0:
            raise ValueError(
                f"default_weight must be > 0, got {default_weight}")
        for tenant, w in (weights or {}).items():
            if w <= 0:
                raise ValueError(
                    f"weight for tenant {tenant!r} must be > 0, got {w}")
        self.quantum = quantum
        self.max_queued_per_tenant = max_queued_per_tenant
        self.max_queued_total = max_queued_total
        self.default_weight = default_weight
        self._weights: Dict[str, float] = dict(weights or {})
        self._cond = threading.Condition()
        self._queues: Dict[str, Deque[Any]] = {}
        self._costs: Dict[str, Deque[float]] = {}
        self._deficits: Dict[str, float] = {}
        self._rotation: Deque[str] = deque()
        self._total = 0
        self._total_cost = 0.0

    # -- per-tenant weights (priority tiers) ----------------------------------

    def weight(self, tenant: str) -> float:
        """This tenant's service weight: its quantum per rotation visit is
        ``quantum * weight``, so over saturation a weight-3 tenant gets ~3x
        the served cost of a weight-1 tenant (priority tiers; cost-based
        starvation protection is unchanged — every weight is > 0)."""
        with self._cond:
            return self._weights.get(tenant, self.default_weight)

    def set_weight(self, tenant: str, weight: float) -> None:
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        with self._cond:
            self._weights[tenant] = weight

    # -- producer side -------------------------------------------------------

    def offer(self, tenant: str, item: Any, cost: float = 1.0) -> None:
        """Enqueue ``item`` under ``tenant`` or raise AdmissionError."""
        with self._cond:
            q = self._queues.get(tenant)
            depth = len(q) if q is not None else 0
            if depth >= self.max_queued_per_tenant:
                raise AdmissionError(
                    f"tenant {tenant!r} backlog full "
                    f"({depth}/{self.max_queued_per_tenant} queued)",
                    tenant, "tenant")
            if self._total >= self.max_queued_total:
                raise AdmissionError(
                    f"service backlog full "
                    f"({self._total}/{self.max_queued_total} queued)",
                    tenant, "total")
            if q is None:
                q = self._queues[tenant] = deque()
                self._costs[tenant] = deque()
            if not q and tenant not in self._rotation:
                self._rotation.append(tenant)
            q.append(item)
            self._costs[tenant].append(max(cost, 0.0))
            self._total += 1
            self._total_cost += max(cost, 0.0)
            self._cond.notify()

    # -- consumer side (the service pump) ------------------------------------

    def take(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Next item under DRR policy; blocks up to ``timeout`` for one to
        arrive (None on timeout / empty)."""
        with self._cond:
            if self._total == 0 and not self._cond.wait_for(
                    lambda: self._total > 0, timeout):
                return None
            return self._take_locked()

    def _take_locked(self) -> Optional[Any]:
        # Each pass over the rotation grants every non-empty tenant one
        # quantum, so any head item (finite cost) becomes servable after
        # at most ceil(max_cost / quantum) passes — the loop terminates.
        while self._rotation:
            tenant = self._rotation[0]
            q = self._queues.get(tenant)
            if not q:
                self._rotation.popleft()
                self._deficits[tenant] = 0.0
                continue
            cost = self._costs[tenant][0]
            if cost <= self._deficits.get(tenant, 0.0):
                item = q.popleft()
                self._costs[tenant].popleft()
                self._total -= 1
                self._total_cost = max(0.0, self._total_cost - cost)
                if q:
                    self._deficits[tenant] = self._deficits[tenant] - cost
                else:
                    self._rotation.popleft()
                    self._deficits[tenant] = 0.0  # no banking while idle
                return item
            # weighted DRR: a visit grants quantum * weight, so relative
            # served cost under saturation tracks the weight ratio
            self._deficits[tenant] = self._deficits.get(tenant, 0.0) \
                + self.quantum * self._weights.get(tenant,
                                                   self.default_weight)
            self._rotation.rotate(-1)
        return None

    def extract(self, pred: Callable[[Any], bool]) -> List[Any]:
        """Remove and return every queued item with ``pred(item)`` true —
        the batching hook: the service coalesces same-plan actions from
        ALL tenants into the leader's dispatch.  Extraction does not
        touch deficits: a batched follower rides for free (its execution
        is shared, so charging its tenant would double-bill)."""
        out: List[Any] = []
        with self._cond:
            for tenant, q in self._queues.items():
                if not q:
                    continue
                keep: Deque[Any] = deque()
                keep_costs: Deque[float] = deque()
                for item, cost in zip(q, self._costs[tenant]):
                    if pred(item):
                        out.append(item)
                        self._total -= 1
                        self._total_cost = max(0.0, self._total_cost - cost)
                    else:
                        keep.append(item)
                        keep_costs.append(cost)
                self._queues[tenant] = keep
                self._costs[tenant] = keep_costs
        return out

    # -- introspection -------------------------------------------------------

    def depth(self, tenant: str) -> int:
        with self._cond:
            q = self._queues.get(tenant)
            return len(q) if q is not None else 0

    def total_cost(self) -> float:
        """Summed cost of everything queued (all tenants) — the backlog
        size in cost units, which the service's latency-aware admission
        multiplies by the observed per-cost-unit service rate."""
        with self._cond:
            return self._total_cost

    def depths(self) -> Dict[str, int]:
        with self._cond:
            return {t: len(q) for t, q in self._queues.items() if q}

    def __len__(self) -> int:
        return self._total
