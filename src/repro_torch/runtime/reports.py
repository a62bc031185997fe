"""Structured per-action diagnostics: a history, not an overwritten dict.

Every action the executor runs produces one :class:`ActionReport` — the
plan that ran, how much of its prefix was served from the
materialization cache, the program's counter totals (shuffle drops,
key-table overflow, exchanged-record volume), plan-cache deltas and the
wall time split into phases.  Reports accumulate in a bounded
:class:`ReportLog`, so an interactive session can inspect every query it
ran; ``MaRe.last_diagnostics`` remains as a deprecated view over the
newest report's counters.  A :class:`ReportStream` is a log that
consumers can wait on: the serving layer's per-tenant report channel.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional


@dataclasses.dataclass
class ActionReport:
    """Diagnostics of one executed action (one plan dispatch)."""

    action_id: int
    plan: str                       # human-readable stage chain
    total_stages: int
    cached_stages: int = 0          # prefix stages served from the cache
    cache_tier: Optional[str] = None   # tier the prefix hit came from
    lineage: Optional[str] = None   # result lineage digest
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    programs_compiled: int = 0      # plan-cache misses this action
    program_cache_hits: int = 0
    wall_s: float = 0.0
    #: Per-phase wall breakdown (seconds): cache_lookup, plan.build,
    #: dispatch, device_wait, counter_sync — the phases sum to ~wall_s.
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: Async path only: seconds spent queued behind earlier actions
    #: BEFORE the dispatch worker started this one (NOT part of wall_s,
    #: which times execution only).
    queue_wait_s: float = 0.0
    label: Optional[str] = None     # e.g. "wave 3" on the wave path
    #: Tenant whose session issued this action (None for direct
    #: single-user executor use); tags the cache lookup too.
    tenant: Optional[str] = None
    #: Device the action ran on (e.g. ``cuda:0``).
    device: Optional[str] = None
    #: Serving layer: number of coalesced same-plan actions this dispatch
    #: served (1 = not batched) and, on a member's report, the action_id
    #: of the batch leader whose execution it shared.
    batch_size: int = 1
    batch_leader: Optional[int] = None

    @property
    def executed_stages(self) -> int:
        return self.total_stages - self.cached_stages

    @property
    def diagnostics(self) -> Dict[str, int]:
        """Per-stage counter totals, keyed ``"stage<i>.<kind>"`` — the
        view the deprecated ``MaRe.last_diagnostics`` dict exposes."""
        return self.counters

    def describe(self) -> str:
        hit = (f", cached_prefix={self.cached_stages}/{self.total_stages}"
               f" ({self.cache_tier})" if self.cached_stages else "")
        tag = f" [{self.label}]" if self.label else ""
        who = f" tenant={self.tenant}" if self.tenant else ""
        qw = (f", queue_wait={self.queue_wait_s * 1e3:.1f}ms"
              if self.queue_wait_s else "")
        batched = (f", batch={self.batch_size}" if self.batch_size > 1
                   else "")
        return (f"action#{self.action_id}{tag}:{who} {self.plan}{hit}, "
                f"compiled={self.programs_compiled}, "
                f"wall={self.wall_s * 1e3:.1f}ms{qw}{batched}")


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

    def phase_totals(self) -> Dict[str, float]:
        """Summed per-phase seconds across all retained reports."""
        acc: Dict[str, float] = {}
        for r in self._reports:
            for phase, s in r.phases.items():
                acc[phase] = acc.get(phase, 0.0) + s
        return acc

    def summary(self) -> str:
        """Session-level aggregate: action/compile/cache totals plus a
        phase-breakdown table over the retained history (the interactive
        "where did my time go" view)."""
        reports = list(self._reports)
        if not reports:
            return "ReportLog: no actions recorded"
        wall = sum(r.wall_s for r in reports)
        queued = sum(r.queue_wait_s for r in reports)
        compiled = sum(r.programs_compiled for r in reports)
        cached = sum(r.cached_stages for r in reports)
        stages = sum(r.total_stages for r in reports)
        lines = [
            f"ReportLog: {len(reports)} retained / {self.appended} total "
            f"actions, wall={wall:.3f}s"
            + (f", queue_wait={queued:.3f}s" if queued else ""),
            f"  stages: {stages} planned, {cached} served from cache; "
            f"programs compiled: {compiled}",
        ]
        totals = self.phase_totals()
        if totals:
            lines.append(f"  {'phase':<16} {'total':>10} {'mean':>10} "
                         f"{'share':>7}")
            for phase, s in sorted(totals.items(), key=lambda kv: -kv[1]):
                lines.append(
                    f"  {phase:<16} {s:>9.3f}s "
                    f"{s / len(reports) * 1e3:>8.2f}ms "
                    f"{s / wall * 100 if wall else 0:>6.1f}%")
        return "\n".join(lines)


class ReportStream(ReportLog):
    """A :class:`ReportLog` that consumers can *wait on* — the per-tenant
    report channel of the serving layer.

    Producers (the service's dispatch path, a live query's refresh
    thread) ``append`` from worker threads; a session-side consumer blocks
    in :meth:`wait_for` / :meth:`next_after` for reports it has not seen
    yet, so the log becomes a live stream without polling.
    """

    def __init__(self, maxlen: int = 256) -> None:
        super().__init__(maxlen)
        self._cond = threading.Condition()

    def new_id(self) -> int:
        with self._cond:
            return super().new_id()

    def append(self, report: ActionReport) -> None:
        with self._cond:
            super().append(report)
            self._cond.notify_all()

    def wait_for(self, appended: int, timeout: Optional[float] = None
                 ) -> bool:
        """Block until the stream's lifetime append count reaches
        ``appended`` (False on timeout)."""
        with self._cond:
            return self._cond.wait_for(lambda: self.appended >= appended,
                                       timeout)

    def next_after(self, seen: int, timeout: Optional[float] = None
                   ) -> List[ActionReport]:
        """Reports appended after the first ``seen`` (blocking until at
        least one arrives, or ``[]`` on timeout).  Cursor pattern:
        ``seen += len(batch)`` after each call.  Reports that aged out of
        the bounded history before being read are skipped."""
        with self._cond:
            if not self._cond.wait_for(lambda: self.appended > seen,
                                       timeout):
                return []
            missed = self.appended - seen
            return list(self._reports)[-min(missed, len(self._reports)):]
