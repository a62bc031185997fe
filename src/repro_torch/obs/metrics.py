"""Process-wide metrics registry: counters, gauges, histograms.

Unlike spans (sampled timelines, off by default), metrics are *always*
maintained — they are a handful of integer adds per **action**, never
per record: materialization-cache hits/misses/spills/drops per tier,
compile-cache hits/misses, exchanged-record volume, dispatch-queue
depth, and per-phase wall histograms.  ``snapshot()`` returns a plain
dict (JSON-friendly, what ``MaRe.metrics()`` surfaces); ``render()``
a fixed-width text dump for interactive sessions.

Histograms use power-of-two bucketing over seconds (1 µs .. ~1 ks) —
coarse, allocation-free, and good enough to tell a 2 ms dispatch from a
200 ms compile at a glance.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Union

Number = Union[int, float]


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        return self._value


class Gauge:
    """Last-set value (e.g. current dispatch-queue depth)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value: Number = 0
        self._lock = threading.Lock()

    def set(self, v: Number) -> None:
        self._value = v

    def add(self, delta: Number) -> Number:
        """Atomic increment/decrement (per-tenant queue depths are
        maintained by +1 on enqueue / -1 on dequeue from different
        threads); returns the new value."""
        with self._lock:
            self._value += delta
            return self._value

    @property
    def value(self) -> Number:
        return self._value


#: Histogram bucket upper bounds (seconds): 1 µs .. 2^30 µs (~18 min),
#: one power of two per bucket, plus a +inf overflow bucket.
_BUCKET_EDGES = tuple(1e-6 * (1 << i) for i in range(31))


class Histogram:
    """Power-of-two-bucketed distribution of observed values (seconds)."""

    __slots__ = ("name", "count", "total", "min", "max", "buckets", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets = [0] * (len(_BUCKET_EDGES) + 1)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        idx = len(_BUCKET_EDGES)
        for i, edge in enumerate(_BUCKET_EDGES):
            if v <= edge:
                idx = i
                break
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self.buckets[idx] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Bucket-resolution percentile estimate (``q`` in [0, 100]):
        the upper edge of the bucket holding the q-th observation.
        Power-of-two buckets make this a factor-of-2 estimate — good
        enough for the serving loop's live p50/p99 display; exact
        percentiles come from the benchmark's raw sample lists."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(self.count * min(max(q, 0.0), 100.0)
                                / 100.0))
        with self._lock:
            seen = 0
            for i, n in enumerate(self.buckets):
                seen += n
                if seen >= rank:
                    return (_BUCKET_EDGES[i] if i < len(_BUCKET_EDGES)
                            else self.max)
        return self.max

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "total": self.total,
                "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0}


class MetricsRegistry:
    """Name -> metric store; metrics are created on first touch so call
    sites never need registration boilerplate."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter(name)
            return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge(name)
            return m

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                m = self._histograms[name] = Histogram(name)
            return m

    def reset(self) -> None:
        """Drop every metric (tests/benchmarks isolating a measurement)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict view: counters/gauges to their value, histograms to
        their ``summary()`` dict — ``MaRe.metrics()``'s return value."""
        with self._lock:
            out: Dict[str, object] = {}
            for name, c in sorted(self._counters.items()):
                out[name] = c.value
            for name, g in sorted(self._gauges.items()):
                out[name] = g.value
            for name, h in sorted(self._histograms.items()):
                out[name] = h.summary()
            return out

    def render(self, prefix: Optional[str] = None) -> str:
        """Fixed-width text dump (optionally filtered to names starting
        with ``prefix``) for interactive inspection."""
        lines: List[str] = []
        for name, value in self.snapshot().items():
            if prefix is not None and not name.startswith(prefix):
                continue
            if isinstance(value, dict):                    # histogram
                lines.append(
                    f"{name:<44} count={value['count']:<8} "
                    f"mean={value['mean'] * 1e3:.3f}ms "
                    f"min={value['min'] * 1e3:.3f}ms "
                    f"max={value['max'] * 1e3:.3f}ms "
                    f"total={value['total']:.3f}s")
            else:
                lines.append(f"{name:<44} {value}")
        return "\n".join(lines)


#: Process-wide registry every instrumented layer reports into.
METRICS = MetricsRegistry()
