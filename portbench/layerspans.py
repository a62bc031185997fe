"""The program's layer spans on the profiler's timeline, and the readings
of each layer they allow.

A version of the port that offers a profiler sink
(``repro_torch.obs.tracing(profiler=True)``) opens one ``torch.profiler``
range a span, named ``mare.<span>``.  The profiler records such a range
on the host timeline and, where kernels were launched inside it, as a
GPU user annotation over them.  So a kernel is put down to the layer
whose annotation covers it, and an idle gap to the layer whose host range
covered its middle.

``parse(events, actions)`` reads a profiler's event list into the
``devtrace.DeviceTrace`` that ``devtrace.record`` computes (a program
annotation never counts as device work, whatever flag the profiler set
on it; the gaps are named by the innermost host range, a program layer
where one was open) and the program's spans.  ``readings`` gives each
layer's number a traced action, None where the trace holds no span of
that layer:

- ``map_device_ms``: the union of device intervals under ``mare.map``
  annotations;
- ``exchange_device_ms``: the same under ``mare.exchange``;
- ``keyed_fold_device_ms``: the same under ``mare.keyed.combine`` and
  ``mare.keyed.merge``;
- ``tree_reduce_device_ms``: the same under ``mare.tree_reduce``;
- ``gather_ms``: the host duration of the ``mare.gather`` ranges;
- ``dispatch_idle_ms``: the idle gaps whose middle lies inside a
  ``mare.dispatch`` host range.

``harness.Run.trace`` does not carry the spans yet: ``devtrace.record``
would have to switch the sink on and call ``parse`` for the readings to
be metrics of the benchmark.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench import devtrace
from portbench.devtrace import Interval, union

#: Prefix of the program's profiler ranges (``repro_torch.obs.PREFIX``).
PREFIX = "mare."

#: One profiler event: (start_s, end_s, name, on the host, an annotation).
Event = Tuple[float, float, str, bool, bool]

#: Each reading that unions device time under spans: the spans' names.
DEVICE_LAYERS = {
    "map_device_ms": ("map",),
    "exchange_device_ms": ("exchange",),
    "keyed_fold_device_ms": ("keyed.combine", "keyed.merge"),
    "tree_reduce_device_ms": ("tree_reduce",),
}


@dataclasses.dataclass
class ProgramSpans:
    """The program's ranges, their names without the prefix."""
    host: List[Interval]            # (start_s, end_s, name) on the host
    device: List[Interval]          # the GPU annotations over kernels


def events_of(prof) -> List[Event]:
    """A ``torch.profiler.profile``'s events as :data:`Event` tuples."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    return [(e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name,
             e.device_type == cpu,
             bool(getattr(e, "is_user_annotation", False)))
            for e in prof.events()]


def parse(events: Iterable[Event], actions: int
          ) -> Tuple[devtrace.DeviceTrace, ProgramSpans]:
    """The device trace of the window ``devtrace.WINDOW`` and the
    program's spans, from ``events``."""
    dev: List[Interval] = []
    host: List[Interval] = []
    spans = ProgramSpans(host=[], device=[])
    window = None
    for start, end, name, on_host, annotation in events:
        iv = (start, end, name)
        program = name.startswith(PREFIX)
        if on_host:
            host.append(iv)
            if name == devtrace.WINDOW:
                window = iv
            if program:
                spans.host.append((start, end, name[len(PREFIX):]))
        elif program:
            spans.device.append((start, end, name[len(PREFIX):]))
        elif not (annotation
                  or name in (devtrace.WINDOW, devtrace.ACTION)):
            dev.append(iv)
    if window is None:
        raise RuntimeError("the profiler recorded no traced window")
    w0, w1, _ = window
    inside = [(max(s, w0), min(e, w1), devtrace.bare_name(n))
              for s, e, n in dev if e > w0 and s < w1]
    cover = union(inside)
    gaps, t = [], w0
    for s, e in cover:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    trace = devtrace.DeviceTrace(
        actions=actions, window_s=w1 - w0,
        busy_s=sum(e - s for s, e in cover), device=inside,
        gaps=devtrace.label_gaps(gaps, host))
    return trace, spans


def overlap(a: Sequence[Tuple[float, float]],
            b: Sequence[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def layer_device_s(trace: devtrace.DeviceTrace, spans: ProgramSpans,
                   names: Sequence[str]) -> Optional[float]:
    """Device seconds a traced action under the annotations of the spans
    ``names``: the union of the device intervals they cover, so work
    under two nested spans of the set counts once."""
    marks = [iv for iv in spans.device if iv[2] in names]
    if not marks:
        return None
    return overlap(union(trace.device), union(marks)) / trace.actions


def host_s(spans: ProgramSpans, name: str,
           actions: int) -> Optional[float]:
    """Host seconds a traced action inside the ``name`` ranges."""
    got = [e - s for s, e, n in spans.host if n == name]
    return sum(got) / actions if got else None


def dispatch_idle_s(trace: devtrace.DeviceTrace,
                    spans: ProgramSpans) -> Optional[float]:
    """Idle seconds a traced action whose gap's middle lies inside a
    ``dispatch`` host range: the host holding the card back while it
    enqueues the action's work."""
    ranges = union([iv for iv in spans.host if iv[2] == "dispatch"])
    if not ranges:
        return None
    idle = 0.0
    for s, e, _ in trace.gaps:
        mid = 0.5 * (s + e)
        if any(lo <= mid <= hi for lo, hi in ranges):
            idle += e - s
    return idle / trace.actions


def readings(trace: devtrace.DeviceTrace,
             spans: ProgramSpans) -> Dict[str, Optional[float]]:
    """Every reading of the module's list, in ms a traced action."""
    out = {name: layer_device_s(trace, spans, names)
           for name, names in DEVICE_LAYERS.items()}
    out["gather_ms"] = host_s(spans, "gather", trace.actions)
    out["dispatch_idle_ms"] = dispatch_idle_s(trace, spans)
    return {k: None if v is None else 1e3 * v for k, v in out.items()}
