"""Observability: span tracing + process-wide metrics for the runtime.

Two independent, dependency-free primitives (stdlib only — importable
from any layer without cycles; torch is imported only when the
profiler sink is switched on):

* :mod:`repro_torch.obs.trace` — a bounded-ring span recorder with a
  Chrome-trace/Perfetto JSON exporter.  Disabled by default; the
  instrumentation threaded through ingest, planner, executor, cache and
  wave layers and the program's stages costs one branch per call site
  until :func:`~repro_torch.obs.trace.tracing` (or ``TRACER.start()``)
  attaches the ring.  The ring times the host: a span around a kernel
  launch ends when the launch is queued.  ``tracing(profiler=True)``
  inside one's own ``torch.profiler`` session also opens a profiler
  range a span (``mare.<name>``), so the profiler puts each kernel and
  each idle gap of the device down to the layer that launched it or
  held it back.
* :mod:`repro_torch.obs.metrics` — always-on counters/gauges/histograms
  (cache hits per tier, plan-cache hits, exchanged records, queue depth,
  per-phase walls), snapshotted by ``MaRe.metrics()``.

Event names, arguments and metric names are the reference's
(:mod:`repro.obs`), so one trace viewer and one dashboard read both.
The port adds the spans of its program's stages (``map``, ``exchange``,
``keyed.combine``, ``keyed.merge``, ``tree_reduce``) and of the
``gather``: the reference's stages run inside one compiled XLA program,
where no host span can sit.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, METRICS)
from repro_torch.obs.trace import (PREFIX, TRACER, Tracer,  # noqa: F401
                                   instant, span, timed, tracing)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "METRICS",
    "PREFIX", "TRACER", "Tracer", "instant", "span", "timed", "tracing",
]
