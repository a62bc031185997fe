"""Observability: span tracing + process-wide metrics for the runtime.

Two independent, dependency-free primitives (stdlib only — importable
from any layer without cycles):

* :mod:`repro_torch.obs.trace` — a bounded-ring span recorder with a
  Chrome-trace/Perfetto JSON exporter.  Disabled by default; the
  instrumentation threaded through ingest, planner, executor, cache and
  wave layers costs one branch per call site until
  :func:`~repro_torch.obs.trace.tracing` (or ``TRACER.start()``) attaches
  the ring.  Spans time the host: a span around a kernel launch ends
  when the launch is queued, so device time lands in the executor's
  ``device_wait`` span.
* :mod:`repro_torch.obs.metrics` — always-on counters/gauges/histograms
  (cache hits per tier, plan-cache hits, exchanged records, queue depth,
  per-phase walls), snapshotted by ``MaRe.metrics()``.

Event names, arguments and metric names are the reference's
(:mod:`repro.obs`), so one trace viewer and one dashboard read both.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, METRICS)
from repro_torch.obs.trace import (TRACER, Tracer, instant,  # noqa: F401
                                   span, timed, tracing)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "METRICS",
    "TRACER", "Tracer", "instant", "span", "timed", "tracing",
]
