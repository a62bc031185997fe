"""Thread-safe span tracing with two sinks: a bounded ring exported as
Chrome-trace/Perfetto JSON, and the profiler's timeline.

The runtime layers (ingest pool, planner, executor, materialization
cache, wave loop) and the program's stages (map, exchange, keyed combine
and merge, tree reduce, gather) are permanently instrumented with
:func:`span` / :func:`instant` calls against the process-wide
:data:`TRACER`.  The tracer is **disabled by default**: until a sink is
attached with :meth:`Tracer.start` (or the :func:`tracing` context
manager), ``span`` returns a shared null context manager and ``instant``
returns immediately — one attribute load and a branch, cheap enough to
leave in every hot path (asserted < 5% of a small fused action in
``tests/test_torch_obs.py``).

When enabled, completed spans land in a bounded in-memory ring (oldest
events drop first; ``events_dropped`` counts the loss) as Chrome-trace
"complete" (``ph="X"``) events: wall-clock microseconds since the
tracer's epoch, the recording thread's id as ``tid``, and arbitrary
JSON-serializable ``args``.  Nesting is by containment on a thread —
Perfetto and ``chrome://tracing`` both render stacked slices without
explicit parent links.  Export with :meth:`Tracer.export` (or
``MaRe.trace_to``) and load the file straight into https://ui.perfetto.dev.

The ring times the host: a span around a kernel launch ends when the
launch is queued.  The **profiler sink** (``tracing(profiler=True)``)
puts the device time down to layers: every span also opens a
``torch.profiler`` range named :data:`PREFIX` + its name (``mare.map``,
``mare.exchange``, ...), with the span's numeric arguments known at
entry as the range's inputs (shown with ``record_shapes=True``).  Inside
a running ``torch.profiler`` session the ranges land on the profiler's
own clock, on the host timeline and, as GPU user annotations, over the
kernels launched inside them::

    with torch.profiler.profile(activities=[...]) as prof:
        with obs.tracing(profiler=True):
            m.collect()
    # prof.events(): "mare.dispatch" > "mare.map" | "mare.exchange" | ...

Without a profiler session the ranges cost a little host time and
record nothing.  Torch is imported only when the profiler sink is
switched on, so this module stays importable without it.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional

#: Prefix of the profiler ranges the program's spans open, so a reader
#: tells them from aten operations and from other ``record_function``
#: ranges.
PREFIX = "mare."

#: This process's id, each event's ``pid``: read once, and again in a
#: forked child, since ``os.getpid()`` is a system call, ~150 us a call
#: where the operating system sandboxes system calls.
_PID = os.getpid()


def _reset_pid() -> None:
    global _PID
    _PID = os.getpid()


os.register_at_fork(after_in_child=_reset_pid)

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


class _ProfilerSink:
    """The profiler's record-function pair: a range opened at a span's
    entry and closed at its exit, on the calling thread."""

    __slots__ = ("enter", "exit")

    def __init__(self) -> None:
        import torch
        self.enter: Callable[..., Any] = \
            torch._C._autograd._record_function_with_args_enter
        self.exit: Callable[[Any], None] = \
            torch._C._autograd._record_function_with_args_exit

    def open(self, name: str, args: Optional[Dict[str, Any]]) -> Any:
        values = [v for v in args.values()
                  if isinstance(v, (int, float))] if args else ()
        return self.enter(PREFIX + name, *values)


class _Span:
    """One live span: records [enter, exit) and appends to the ring, and
    with the profiler sink on holds a profiler range over the same
    interval."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_sink", "_range")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]) -> None:
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._sink = sink = self._tracer._profiler
        if sink is not None:
            self._range = sink.open(self.name, self.args)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.monotonic()
        if self._sink is not None:
            self._sink.exit(self._range)
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
        #: The profiler sink while it is attached, else None.
        self._profiler: Optional[_ProfilerSink] = None
        self._epoch = time.monotonic()
        self.events_total = 0

    # -- control -------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def profiling(self) -> bool:
        """Whether spans also open profiler ranges."""
        return self._profiler is not None

    def start(self, clear: bool = True, profiler: bool = False
              ) -> "Tracer":
        """Attach the ring sink: spans/instants record from now on.
        ``profiler=True`` also attaches the profiler sink (module
        docstring); ``False`` leaves it as it was."""
        sink = _ProfilerSink() if profiler else self._profiler
        with self._lock:
            if clear:
                self._events.clear()
                self.events_total = 0
                self._epoch = time.monotonic()
            self._profiler = sink
            self._enabled = True
        return self

    def stop(self) -> "Tracer":
        """Detach both sinks: span()/instant() return to the no-op path
        (already-recorded events stay in the ring for export)."""
        self._enabled = False
        self._profiler = None
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
              "pid": _PID, "tid": threading.get_ident()}
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
              "pid": _PID, "tid": threading.get_ident()}
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
def tracing(tracer: Optional[Tracer] = None, clear: bool = True,
            profiler: bool = False) -> Iterator[Tracer]:
    """Enable the (default) tracer for a block, restoring the previous
    state of both sinks on exit — the test/benchmark spelling:

    .. code-block:: python

        with obs.tracing() as t:
            m.collect()
        t.export("trace.json")

    ``profiler=True`` also opens a profiler range a span, for a
    ``torch.profiler`` session around the block (module docstring).
    """
    t = tracer if tracer is not None else TRACER
    was, sink = t._enabled, t._profiler
    t.start(clear=clear, profiler=profiler)
    try:
        yield t
    finally:
        t._profiler = sink
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
