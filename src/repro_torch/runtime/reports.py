"""Structured per-action diagnostics: a history, not an overwritten dict.

Every action the executor runs produces one :class:`ActionReport` — the
plan that ran, the program's counter totals (shuffle drops, key-table
overflow, exchanged-record volume), plan-cache deltas and the wall time
split into phases.  Reports accumulate in a bounded :class:`ReportLog`,
so an interactive session can inspect every query it ran.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Deque, Dict, Iterator, Optional


@contextlib.contextmanager
def timed(name: str, phases: Optional[Dict[str, float]]) -> Iterator[None]:
    """Accumulate the block's wall seconds into ``phases[name]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if phases is not None:
            phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0


@dataclasses.dataclass
class ActionReport:
    """Diagnostics of one executed action (one plan dispatch)."""

    action_id: int
    plan: str                       # human-readable stage chain
    total_stages: int
    lineage: Optional[str] = None   # result lineage digest
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    programs_compiled: int = 0      # plan-cache misses this action
    program_cache_hits: int = 0
    wall_s: float = 0.0
    #: Per-phase wall breakdown (seconds): plan.build, dispatch,
    #: device_wait, counter_sync — the phases sum to ~wall_s.
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    label: Optional[str] = None
    #: Device the action ran on (e.g. ``cuda:0``).
    device: Optional[str] = None

    @property
    def diagnostics(self) -> Dict[str, int]:
        """Per-stage counter totals, keyed ``"stage<i>.<kind>"``."""
        return self.counters

    def describe(self) -> str:
        tag = f" [{self.label}]" if self.label else ""
        return (f"action#{self.action_id}{tag}: {self.plan}, "
                f"compiled={self.programs_compiled}, "
                f"wall={self.wall_s * 1e3:.1f}ms")


class ReportLog:
    """Bounded FIFO history of :class:`ActionReport`."""

    def __init__(self, maxlen: int = 256) -> None:
        self._reports: Deque[ActionReport] = deque(maxlen=maxlen)
        self._next_id = 0
        #: Lifetime append count (not bounded by ``maxlen``).
        self.appended = 0

    def new_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    def append(self, report: ActionReport) -> None:
        self._reports.append(report)
        self.appended += 1

    @property
    def latest(self) -> Optional[ActionReport]:
        return self._reports[-1] if self._reports else None

    def __len__(self) -> int:
        return len(self._reports)

    def __iter__(self) -> Iterator[ActionReport]:
        return iter(self._reports)

    def __getitem__(self, i) -> ActionReport:
        return list(self._reports)[i]

    def total(self, counter: str) -> int:
        """Sum of one counter kind across all retained reports (suffix
        matching: ``total("exchanged_records")`` sums every stage)."""
        acc = 0
        for r in self._reports:
            for key, v in r.counters.items():
                if key == counter or key.endswith("." + counter):
                    acc += v
        return acc
