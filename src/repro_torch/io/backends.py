"""Storage backends: the heterogeneous-storage abstraction (paper Fig. 5).

A :class:`StorageBackend` exposes exactly what split planning and parallel
ingestion need — ``list`` / ``size`` / ``read_range`` — mirroring the
narrow waist shared by HDFS, Swift and S3 clients.  ``LocalFS`` is a real
filesystem implementation; :class:`EmulatedObjectStore` wraps any backend
with a request-latency / jitter / bandwidth profile so the paper's three
storage tiers (HDFS co-located, Swift same-DC, S3 remote) are reproducible
on one machine.  The profile table lived hardcoded in
``benchmarks/ingestion.py``; it now lives here as :data:`BACKEND_PROFILES`
and the benchmark consumes the real ingestion path.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np


class StorageBackend:
    """Minimal storage contract: enumerate objects, stat, ranged read."""

    name = "base"

    def list(self) -> List[str]:  # pragma: no cover - abstract
        """All object paths under this backend's root (sorted)."""
        raise NotImplementedError

    def size(self, path: str) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def read_range(self, path: str, start: int, stop: int) -> bytes:
        """Bytes ``[start, stop)`` of ``path`` (may return fewer at EOF)."""
        raise NotImplementedError  # pragma: no cover - abstract


class LocalFS(StorageBackend):
    """Real local filesystem rooted at a file or directory."""

    name = "local"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def _resolve(self, path: str) -> str:
        if os.path.isabs(path):
            return path
        return os.path.join(self.root, path)

    def list(self) -> List[str]:
        if os.path.isfile(self.root):
            return [self.root]
        out: List[str] = []
        for dirpath, _, names in os.walk(self.root):
            for n in names:
                out.append(os.path.join(dirpath, n))
        return sorted(out)

    def size(self, path: str) -> int:
        return os.path.getsize(self._resolve(path))

    def read_range(self, path: str, start: int, stop: int) -> bytes:
        with open(self._resolve(path), "rb") as f:
            f.seek(start)
            return f.read(max(0, stop - start))


#: (request latency s, exponential jitter s) — co-located / same-DC / remote
#: storage tiers, matching the paper's HDFS / Swift / S3 deployment.
BACKEND_PROFILES: Dict[str, tuple] = {
    "hdfs": (0.0002, 0.0),
    "swift": (0.001, 0.0002),
    "s3": (0.004, 0.002),
}


class EmulatedObjectStore(StorageBackend):
    """Wrap a backend with a deterministic latency/jitter/bandwidth profile.

    Each ``read_range`` request pays ``latency_s`` plus an exponential
    jitter term (seeded per backend, so runs are reproducible) plus a
    bandwidth term proportional to bytes transferred.  Metadata calls
    (``list`` / ``size``) pay the base latency only.  Sleeps happen in the
    calling thread, so a fetch pool's thread scaling is honest even on one
    core (latency-bound, like the paper's remote-storage runs).
    """

    def __init__(self, inner: StorageBackend, name: str = "emulated",
                 latency_s: float = 0.0, jitter_s: float = 0.0,
                 bandwidth_bps: Optional[float] = None, seed: int = 0):
        self.inner = inner
        self.name = name
        self.latency_s = latency_s
        self.jitter_s = jitter_s
        self.bandwidth_bps = bandwidth_bps
        self.stats = {"requests": 0, "bytes": 0}
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def _delay(self, nbytes: int = 0) -> None:
        d = self.latency_s
        if self.jitter_s:
            with self._lock:
                d += float(self._rng.exponential(self.jitter_s))
        if self.bandwidth_bps and nbytes:
            d += nbytes / self.bandwidth_bps
        if d > 0:
            time.sleep(d)
        with self._lock:
            self.stats["requests"] += 1
            self.stats["bytes"] += nbytes

    def list(self) -> List[str]:
        self._delay()
        return self.inner.list()

    def size(self, path: str) -> int:
        self._delay()
        return self.inner.size(path)

    def read_range(self, path: str, start: int, stop: int) -> bytes:
        data = self.inner.read_range(path, start, stop)
        self._delay(len(data))
        return data


def HDFS(root: str, **kw) -> EmulatedObjectStore:
    """Co-located HDFS emulation (lowest request latency)."""
    lat, jit = BACKEND_PROFILES["hdfs"]
    return EmulatedObjectStore(LocalFS(root), name="hdfs", latency_s=lat,
                               jitter_s=jit, **kw)


def Swift(root: str, **kw) -> EmulatedObjectStore:
    """Same-datacenter OpenStack Swift emulation."""
    lat, jit = BACKEND_PROFILES["swift"]
    return EmulatedObjectStore(LocalFS(root), name="swift", latency_s=lat,
                               jitter_s=jit, **kw)


def S3(root: str, **kw) -> EmulatedObjectStore:
    """Remote S3 emulation (highest latency + jitter)."""
    lat, jit = BACKEND_PROFILES["s3"]
    return EmulatedObjectStore(LocalFS(root), name="s3", latency_s=lat,
                               jitter_s=jit, **kw)


_FACTORIES = {"local": LocalFS, "hdfs": HDFS, "swift": Swift, "s3": S3}


def make_backend(kind: str, root: str, **kw) -> StorageBackend:
    """Build a backend by name: ``local`` | ``hdfs`` | ``swift`` | ``s3``."""
    if kind not in _FACTORIES:
        raise KeyError(f"unknown backend {kind!r}; available: "
                       f"{sorted(_FACTORIES)}")
    return _FACTORIES[kind](root, **kw)
