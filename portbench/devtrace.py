"""The device's timeline over a few actions, from ``torch.profiler``.

``record`` runs ``actions`` actions under the profiler (CPU and CUDA
activities), the traced window and each action marked by a
``record_function`` span of the benchmark's own, and reads back:

- every device interval (kernels, memcpy, memset) inside the window;
- ``busy_s``: the length of their union, so work that overlaps on two
  streams counts once;
- the idle gaps between them, each named by the innermost host operation
  that covered its middle (``host python`` where only the benchmark's
  action span did, ``between actions`` where none did).

The profiler's host overhead stretches the window, so its idle share is
an upper bound on the untraced run's.
"""
from __future__ import annotations

import dataclasses
import heapq
import re
from typing import Callable, List, Tuple

WINDOW = "portbench.window"
ACTION = "portbench.action"

Interval = Tuple[float, float, str]


def bare_name(name: str) -> str:
    """A device operation's short name: a kernel's function name without
    namespaces, template arguments or parameters (``void (anonymous
    namespace)::segsum_fold<int, 1>(...)`` -> ``segsum_fold``), with the
    functor or launcher a generic PyTorch kernel wraps in brackets
    (``elementwise_kernel[launch_clamp_scalar]``); a copy or a fill keeps
    its whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    text = name[5:] if name.startswith("void ") else name
    text = text.replace("(anonymous namespace)", "anonymous")
    cut = min([i for i in (text.find("<"), text.find("(")) if i >= 0]
              or [len(text)])
    base = text[:cut].split("::")[-1].strip() or text[:80]
    inner = re.search(r"(launch_\w+|\w+Functor\w*)", text[cut:])
    return f"{base}[{inner.group(1)}]" if inner else base


def union(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The merged ``(start, end)`` cover of ``intervals``."""
    merged: List[List[float]] = []
    for start, end, _ in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def label_gaps(gaps: List[Tuple[float, float]],
               host: List[Interval]) -> List[Interval]:
    """Each gap with the innermost host interval covering its middle."""
    host = sorted(host)
    out: List[Interval] = []
    active: list = []                    # heap of (end, start, name)
    i = 0
    for start, end in sorted(gaps):
        mid = 0.5 * (start + end)
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (host[i][1], host[i][0], host[i][2]))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        inner = [a for a in active if a[2] != WINDOW]
        if not inner:
            name = "between actions"
        else:
            e, s, name = min(inner, key=lambda a: a[0] - a[1])
            name = "host python" if name == ACTION else name
        out.append((start, end, name))
    return out


@dataclasses.dataclass
class DeviceTrace:
    actions: int
    window_s: float
    busy_s: float
    device: List[Interval]          # (start_s, end_s, bare kernel name)
    gaps: List[Interval]            # (start_s, end_s, host label)

    def seconds(self, match: Callable[[str], bool]) -> float:
        """Summed device seconds of the intervals whose name matches."""
        return sum(e - s for s, e, n in self.device if match(n))

    @staticmethod
    def _top(intervals: List[Interval], n: int) -> list:
        by: dict = {}
        for s, e, name in intervals:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time and the idle gaps
        by what the host was doing, each summed over the window."""
        return {"device_ops": self._top(self.device, n),
                "idle_gaps": self._top(self.gaps, n)}


def record(action: Callable[[], object], actions: int,
           device) -> Tuple[DeviceTrace, list]:
    """Run ``action`` ``actions`` times under the profiler; returns the
    trace and the actions' results."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    results = []
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(actions):
                with record_function(ACTION):
                    results.append(action())
    cpu_type = torch.autograd.DeviceType.CPU
    dev: List[Interval] = []
    host: List[Interval] = []
    window = None
    for e in prof.events():
        iv = (e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
        if e.device_type == cpu_type:
            host.append(iv)
            if e.name == WINDOW:
                window = iv
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name in (WINDOW, ACTION)):
            # a record_function span also shows on the device's timeline
            # as an annotation: only kernels, copies and fills are work
            dev.append(iv)
    if window is None:
        raise RuntimeError("the profiler recorded no traced window")
    w0, w1, _ = window
    inside = [(max(s, w0), min(e, w1), bare_name(n)) for s, e, n in dev
              if e > w0 and s < w1]
    cover = union(inside)
    gaps, t = [], w0
    for s, e in cover:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return (DeviceTrace(actions=actions, window_s=w1 - w0,
                        busy_s=sum(e - s for s, e in cover), device=inside,
                        gaps=label_gaps(gaps, host)),
            results)
