"""repro_torch.serve — the multi-tenant interactive query service.

Layering: :mod:`repro_torch.core` builds lazy plans, :mod:`repro_torch.runtime`
executes actions against one pair of caches, and **this package puts a
service boundary above the runtime**: N concurrent sessions (tenants)
share one executor, one materialization cache and one compile cache,
with the policies a shared deployment needs — admission control and
deficit-round-robin fairness (:mod:`~repro_torch.serve.scheduler`),
cross-session batching of identical queries (:mod:`~repro_torch.serve.batching`),
per-tenant cache-budget partitions, and per-tenant report streams
(:mod:`~repro_torch.serve.service`, :mod:`~repro_torch.serve.session`).

Entry points: ``QueryService(config=ServiceConfig(...))`` then
``svc.session("alice").mare(data)...collect()``; or a standalone
``Session(tenant="alice")`` for the single-tenant case.  The serving
loop is ``python -m repro_torch.launch.serve --service``.
"""
from repro_torch.serve.batching import BatchKey, Pending, batch_key
from repro_torch.serve.scheduler import AdmissionError, DeficitRoundRobin
from repro_torch.serve.service import QueryService, ServiceConfig
from repro_torch.serve.session import Session

__all__ = [
    "AdmissionError", "BatchKey", "DeficitRoundRobin", "Pending",
    "QueryService", "ServiceConfig", "Session", "batch_key",
]
