"""Session: a tenant-scoped handle over the shared QueryService.

A session looks like plain single-user MaRe — ``session.mare(data)``
returns a normal :class:`~repro_torch.core.mare.MaRe` with the full primitive
and action API — but every action the chain fires is routed through the
service: admitted (or rejected) at the tenant's backlog limit, scheduled
fairly against other tenants, batched with identical queries from other
sessions, and reported into the session's own
:class:`~repro_torch.runtime.reports.ReportStream`.

The routing trick is the executor seam MaRe already has: MaRe talks to
"its executor" through five calls (``run`` / ``submit_action`` /
``persist`` / ``ensure_lineage`` / ``cached_prefix``).
:class:`_TenantExecutor` implements exactly that surface, stamping the
session's tenant on every call — sync actions submit with
``finalize=None`` (key-stable, so identical sync queries from different
sessions coalesce) and block on the handle; ``persist`` charges the
entry to the tenant's cache partition.  MaRe itself is unchanged and
unaware of tenancy.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from repro_torch.core.dataset import ShardedDataset
from repro_torch.core.mare import MaRe
from repro_torch.core.plan import Plan
from repro_torch.runtime.executor import ActionHandle
from repro_torch.runtime.lineage import Lineage
from repro_torch.runtime.reports import ActionReport, ReportStream
from repro_torch.serve.service import QueryService


class _TenantExecutor:
    """Executor-shaped proxy: MaRe's runtime surface, routed through the
    service with the session's tenant attached.  Intentionally NOT an
    Executor subclass — anything outside the seam (queue internals,
    ``submit``) stays on the real executor via delegation below."""

    def __init__(self, session: "Session") -> None:
        self._session = session
        self._service = session.service

    # MaRe._materialize: sync action -> admitted + scheduled + batched,
    # then block.  finalize=None keeps the batch key identical across
    # sessions issuing the same sync query.
    def run(self, ds: ShardedDataset, plan: Plan, *, fuse: bool = True,
            plan_cache: Any = None, reports: Any = None,
            label: Optional[str] = None, queue_wait_s: float = 0.0,
            tenant: Optional[str] = None
            ) -> Tuple[ShardedDataset, ActionReport]:
        handle = self._service.submit(
            tenant=self._session.tenant, ds=ds, plan=plan, finalize=None,
            fuse=fuse, plan_cache=plan_cache, reports=reports, label=label)
        out = handle.result()
        return out, handle.report

    # MaRe.collect(asynchronous=True)
    def submit_action(self, ds: ShardedDataset, plan: Plan, *,
                      finalize: Optional[Callable[[ShardedDataset], Any]]
                      = None,
                      fuse: bool = True, plan_cache: Any = None,
                      reports: Any = None, label: Optional[str] = None,
                      tenant: Optional[str] = None) -> ActionHandle:
        return self._service.submit(
            tenant=self._session.tenant, ds=ds, plan=plan,
            finalize=finalize, fuse=fuse, plan_cache=plan_cache,
            reports=reports, label=label)

    # MaRe.persist: charge the entry to this tenant's cache partition
    def persist(self, ds: ShardedDataset, tier: str = "device",
                owner: Optional[str] = None):
        return self._service.executor.persist(
            ds, tier=tier,
            owner=owner if owner is not None else self._session.tenant)

    # key/bookkeeping lookups need no scheduling — straight through
    def ensure_lineage(self, ds: ShardedDataset) -> Lineage:
        return self._service.executor.ensure_lineage(ds)

    def cached_prefix(self, ds: ShardedDataset, plan: Plan):
        return self._service.executor.cached_prefix(ds, plan)

    @property
    def mat_cache(self):
        return self._service.executor.mat_cache

    @property
    def plan_cache(self):
        return self._service.executor.plan_cache

    @property
    def reports(self):
        """The EXECUTOR's global history (every tenant's dispatches);
        per-session history lives on ``Session.reports``."""
        return self._service.executor.reports


class Session:
    """One tenant's interactive handle on a shared QueryService.

    .. code-block:: python

        svc = QueryService(config=ServiceConfig(
            tenant_device_budget_bytes=64 << 20))
        alice = svc.session("alice")
        data = alice.mare(shared_dataset).map(image=..., command=...)
        pinned = data.persist()            # charged to alice's partition
        rows = pinned.collect(shard=0)     # fair-scheduled + batched

    Constructing ``Session(tenant="alice")`` without a service spins up a
    private one (single-tenant convenience; pass ``service=`` to share).
    ``reports`` is the session's live :class:`ReportStream`: every action
    this session runs appends exactly one report (with ``tenant``,
    ``batch_size``, per-member ``queue_wait_s``) — :meth:`follow` blocks
    for reports not yet seen.
    """

    def __init__(self, tenant: str,
                 service: Optional[QueryService] = None) -> None:
        if not tenant:
            raise ValueError("tenant must be a non-empty string")
        self.tenant = tenant
        self.service = service if service is not None else QueryService()
        self.reports: ReportStream = ReportStream()
        self.executor = _TenantExecutor(self)

    def mare(self, data: Any, **kwargs: Any) -> MaRe:
        """A MaRe chain whose actions route through this session (accepts
        every ``MaRe(...)`` keyword except ``executor``/``_reports``,
        which the session owns)."""
        for reserved in ("executor", "_reports"):
            if reserved in kwargs:
                raise TypeError(
                    f"Session.mare() manages {reserved!r}; it cannot be "
                    f"overridden per chain")
        return MaRe(data, executor=self.executor, _reports=self.reports,
                    **kwargs)

    __call__ = mare

    # -- report stream -------------------------------------------------------

    def report(self) -> Optional[ActionReport]:
        """Newest report of any chain in this session."""
        return self.reports.latest

    def follow(self, seen: int = 0, timeout: Optional[float] = None
               ) -> List[ActionReport]:
        """Reports appended after the first ``seen`` (blocks until one
        arrives or ``timeout``); cursor pattern: ``seen += len(batch)``."""
        return self.reports.next_after(seen, timeout)

    # -- streaming -----------------------------------------------------------

    def stream(self, source: Any, build: Callable[[MaRe], MaRe], *,
               window: Optional[int] = None, slide: int = 1,
               label: Optional[str] = None, **kwargs: Any):
        """A session-scoped incremental query over a
        :class:`~repro_torch.stream.source.ContinuousSource`.

        Every epoch's delta action routes through this session — admitted
        at the tenant's limits, fair-scheduled, batched — and every
        refresh appends one report (with ``stream.*`` counters) to
        :attr:`reports`, so :meth:`follow` wakes per refresh: wrap the
        returned query in a :class:`~repro_torch.stream.live.LiveQuery` for a
        live dashboard.  ``window=None`` maintains the full-history
        aggregate (:class:`~repro_torch.stream.incremental.IncrementalQuery`);
        ``window=S`` a sliding window of S epochs emitting every
        ``slide`` arrivals (:class:`~repro_torch.stream.windows.WindowedQuery`;
        ``slide=S`` makes it tumbling).
        """
        # deferred: serve must stay importable without the stream package
        from repro_torch.stream import IncrementalQuery, WindowedQuery
        for reserved in ("executor", "reports"):
            if reserved in kwargs:
                raise TypeError(f"Session.stream() manages {reserved!r}; "
                                f"it cannot be overridden per query")
        label = label if label is not None else f"{self.tenant}/stream"
        if window is None:
            return IncrementalQuery(source, build, executor=self.executor,
                                    reports=self.reports, label=label,
                                    **kwargs)
        return WindowedQuery(source, build, size=window, slide=slide,
                             executor=self.executor, reports=self.reports,
                             label=label, **kwargs)

    # -- introspection -------------------------------------------------------

    def queue_depth(self) -> int:
        """Actions of THIS tenant currently queued (admitted, not yet
        dispatched)."""
        return self.service.scheduler.depth(self.tenant)

    def cache_bytes(self) -> dict:
        """This tenant's materialization-cache footprint per tier."""
        return self.service.executor.mat_cache.owner_bytes().get(
            self.tenant, {"device": 0, "host": 0})

    def __repr__(self) -> str:
        return (f"Session(tenant={self.tenant!r}, "
                f"queued={self.queue_depth()}, "
                f"actions={self.reports.appended})")
