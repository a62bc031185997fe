"""Thread-safe span tracing with a Chrome-trace/Perfetto JSON exporter.

The runtime layers (ingest pool, planner, executor, materialization
cache, wave loop) are permanently instrumented with :func:`span` /
:func:`instant` calls against the process-wide :data:`TRACER`.  The
tracer is **disabled by default**: until a ring sink is attached with
:meth:`Tracer.start` (or the :func:`tracing` context manager), ``span``
returns a shared null context manager and ``instant`` returns
immediately — one attribute load and a branch, cheap enough to leave in
every hot path (asserted < 5% of a small fused action in
``tests/test_torch_obs.py``).

When enabled, completed spans land in a bounded in-memory ring (oldest
events drop first; ``events_dropped`` counts the loss) as Chrome-trace
"complete" (``ph="X"``) events: wall-clock microseconds since the
tracer's epoch, the recording thread's id as ``tid``, and arbitrary
JSON-serializable ``args``.  Nesting is by containment on a thread —
Perfetto and ``chrome://tracing`` both render stacked slices without
explicit parent links.  Export with :meth:`Tracer.export` (or
``MaRe.trace_to``) and load the file straight into https://ui.perfetto.dev.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, Iterator, List, Optional


class _NullSpan:
    """Shared no-op span: the disabled-tracing fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **args: Any) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records [enter, exit) and appends to the ring."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]) -> None:
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.monotonic()
        self._tracer._record(self.name, self._t0, t1, self.args)

    def set(self, **args: Any) -> None:
        """Attach/override args after the span opened (e.g. an action id
        only known once the work completes)."""
        if self.args is None:
            self.args = {}
        self.args.update(args)


class Tracer:
    """Bounded-ring span recorder with a Chrome-trace JSON exporter.

    ``capacity`` bounds retained events (FIFO drop; ``events_dropped``
    counts evictions).  All methods are thread-safe: spans record their
    own thread id, and the ring append happens under a lock only at span
    *exit*, never per instruction inside the span.
    """

    def __init__(self, capacity: int = 1 << 16) -> None:
        self.capacity = capacity
        self._events: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._enabled = False
        self._epoch = time.monotonic()
        self.events_total = 0

    # -- control -------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def start(self, clear: bool = True) -> "Tracer":
        """Attach the ring sink: spans/instants record from now on."""
        with self._lock:
            if clear:
                self._events.clear()
                self.events_total = 0
                self._epoch = time.monotonic()
            self._enabled = True
        return self

    def stop(self) -> "Tracer":
        """Detach the sink: span()/instant() return to the no-op path
        (already-recorded events stay in the ring for export)."""
        self._enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.events_total = 0

    @property
    def events_dropped(self) -> int:
        return max(0, self.events_total - len(self._events))

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **args: Any) -> Any:
        """Context manager timing one named region.  Disabled: returns a
        shared null object (no allocation, no clock reads)."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def instant(self, name: str, **args: Any) -> None:
        """Zero-duration marker event (e.g. a speculative re-dispatch)."""
        if not self._enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": (time.monotonic() - self._epoch) * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)
            self.events_total += 1

    def _record(self, name: str, t0: float, t1: float,
                args: Optional[Dict[str, Any]]) -> None:
        ev = {"name": name, "ph": "X",
              "ts": (t0 - self._epoch) * 1e6,
              "dur": (t1 - t0) * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)
            self.events_total += 1

    # -- export --------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of recorded events (ring order = time order per
        thread; cross-thread order is by ``ts``)."""
        with self._lock:
            return list(self._events)

    def export(self, path: str) -> str:
        """Write the ring as Chrome-trace JSON (``traceEvents`` object
        format — loadable by Perfetto / chrome://tracing) and return
        ``path``."""
        payload = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"events_total": self.events_total,
                          "events_dropped": self.events_dropped},
        }
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


#: Process-wide tracer every instrumented layer records against.
TRACER = Tracer()


def span(name: str, **args: Any):
    """``TRACER.span`` shorthand (the instrumentation call sites)."""
    if not TRACER._enabled:
        return _NULL_SPAN
    return _Span(TRACER, name, args or None)


def instant(name: str, **args: Any) -> None:
    """``TRACER.instant`` shorthand."""
    if TRACER._enabled:
        TRACER.instant(name, **args)


@contextmanager
def tracing(tracer: Optional[Tracer] = None,
            clear: bool = True) -> Iterator[Tracer]:
    """Enable the (default) tracer for a block, restoring the previous
    enabled state on exit — the test/benchmark spelling:

    .. code-block:: python

        with obs.tracing() as t:
            m.collect()
        t.export("trace.json")
    """
    t = tracer if tracer is not None else TRACER
    was = t._enabled
    t.start(clear=clear)
    try:
        yield t
    finally:
        t._enabled = was


@contextmanager
def timed(name: str, phases: Optional[Dict[str, float]] = None,
          **args: Any) -> Iterator[Any]:
    """Span + phase accumulator in one: times the block, emits a span
    when tracing is enabled, adds the elapsed seconds into
    ``phases[name]`` (the ``ActionReport.phases`` breakdown) when a dict
    is given, and yields the span (null when disabled) so the block can
    ``set()`` late-known args.  The phase accumulation always runs — two
    clock reads — so per-phase attribution survives with tracing off."""
    t0 = time.monotonic()
    s = span(name, **args)
    s.__enter__()
    try:
        yield s
    finally:
        s.__exit__(None, None, None)
        if phases is not None:
            phases[name] = phases.get(name, 0.0) + (time.monotonic() - t0)
