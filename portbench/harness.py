"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name:

- the cell in ``BENCHMARK.json`` (``workloads``) names its configuration
  (``configs`` -> its ``file``), its traffic mix and its chips;
- the traffic mix is ``portbench/traffic/<traffic>.json``, whose ``kind``
  names the generator ``portbench/kinds/<kind>.py`` that reads it;
- each metric is ``portbench/metrics/<name>.py``, whose ``KIND`` says
  whether it is an end-to-end metric (printed with ``--trace 0``) or a
  per-layer one (``--trace 1``), and whose ``read(run)`` returns a number
  or None where the run holds nothing for it.

A generator module has ``setup(config, traffic, seed, device)``, which
returns a session with ``action() -> (answer, ActionReport)``,
``free()``, ``check(answers) -> ({name: (worst value, limit)}, work)``
and ``cached_stages`` (the stages an action may take from the cache).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
#: Top-level module names the process must not hold once the window has
#: closed: JAX and the JAX package of this repository.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: A window stops after this many failed actions.
MAX_ERRORS = 100


def load_module(path: Path):
    """Import the module at ``path`` under a name of its own."""
    name = "portbench_" + "_".join(path.relative_to(HERE).with_suffix("")
                                   .parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark(path: Optional[Path] = None) -> dict:
    """``BENCHMARK.json`` beside this folder, or the file at ``path``."""
    path = path or HERE.parent / "BENCHMARK.json"
    return json.loads(Path(path).read_text())


def cells(bench: dict) -> List[str]:
    return [w["name"] for w in bench["workloads"]]


def metric_readers(kind: str) -> Dict[str, Any]:
    """Every reader module of ``portbench/metrics`` of ``kind``
    (``end_to_end`` or ``per_layer``), by metric name."""
    out = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        mod = load_module(path)
        if getattr(mod, "KIND", None) == kind:
            out[path.stem] = mod
    return out


def resolve(bench: dict, cell_name: str,
            overrides: Optional[dict] = None) -> tuple:
    """(cell entry, configuration, traffic mix, generator module)."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in by_name:
        raise SystemExit(f"unknown workload {cell_name!r}; the benchmark "
                         f"has {sorted(by_name)}")
    cell = by_name[cell_name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((HERE.parent / entry["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    kind = load_module(HERE / "kinds" / f"{traffic['kind']}.py")
    return cell, config, traffic, kind


class Sampler:
    """A uniform sample of ``k`` answers drawn from the seed over a stream
    of unknown length (reservoir sampling), and always the last one."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng(seed)
        self.kept: list = []
        self.last = None
        self.seen = 0

    def offer(self, answer) -> None:
        if self.seen < self.k:
            self.kept.append(answer)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = answer
        self.last = answer
        self.seen += 1

    def answers(self) -> list:
        return self.kept + ([self.last] if self.seen > self.k else [])


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    walls: List[float]
    reports: List[dict]            # wall_s, phases, cached_stages
    window_s: float
    window_peak_bytes: int
    device_kind: str
    work: dict
    trace: Any = None              # devtrace.DeviceTrace with --trace 1


def report_of(report) -> dict:
    return {"wall_s": report.wall_s, "phases": dict(report.phases),
            "cached_stages": report.cached_stages}


def window(session, seconds: float, sampler: Sampler) -> dict:
    """Issue actions back to back, each as soon as the last one's answer
    is on the host, until ``seconds`` have passed."""
    walls, reports, errors = [], [], []
    t0 = time.perf_counter()
    end = t0 + seconds
    t1 = t0
    while t1 < end:
        ts = time.perf_counter()
        try:
            answer, report = session.action()
        except Exception as exc:      # an answer that never comes
            errors.append(repr(exc)[:500])
            t1 = time.perf_counter()
            if len(errors) >= MAX_ERRORS:
                break
            continue
        t1 = time.perf_counter()
        walls.append(t1 - ts)
        reports.append(report_of(report))
        sampler.offer(answer)
    return {"walls": walls, "reports": reports, "window_s": t1 - t0,
            "errors": errors}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             bench: Optional[dict] = None,
             overrides: Optional[dict] = None) -> dict:
    """Run one cell and return its result line (a dict; ``checks`` last).
    ``t0`` is the process's start on ``time.perf_counter``."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = bench or benchmark()
    cell, config, traffic, kind = resolve(bench, cell_name, overrides)
    program_path()
    import torch
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    session = kind.setup(config, traffic, seed, dev)
    warmup_errors = []
    for _ in range(int(traffic["warmup_actions"])):
        try:
            session.action()
        except Exception as exc:      # counted with the window's failures
            warmup_errors.append(repr(exc)[:500])
    if on_card:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0

    sampler = Sampler(int(traffic["samples"]), seed)
    got = window(session, seconds, sampler)
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    dtrace = None
    if trace:
        from portbench import devtrace
        dtrace, traced = devtrace.record(
            session.action, int(traffic["trace_actions"]), dev)
        for answer, _ in traced[-1:]:
            sampler.offer(answer)
        del traced

    device_kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    session.free()
    if on_card:
        torch.cuda.empty_cache()
    checks, work = session.check(sampler.answers())
    cached = sum(r["cached_stages"] != session.cached_stages
                 for r in got["reports"])
    errors = warmup_errors + got["errors"]
    checks["actions_failed"] = (len(errors), 0)
    checks["actions_cached"] = (cached, 0)

    run = Run(setup_s=setup_s, walls=got["walls"],
              reports=got["reports"], window_s=got["window_s"],
              window_peak_bytes=window_peak,
              device_kind=device_kind, work=work, trace=dtrace)
    readers = metric_readers("per_layer" if trace else "end_to_end")
    metrics = {}
    for name, mod in readers.items():
        value = mod.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": mod.UNIT}
    device_rec = {"platform": "gpu" if on_card else dev.type,
                  "kind": device_kind, "count": int(cell["chips"]),
                  "memory_peak_bytes": int(max(setup_peak, window_peak))
                  if on_card else 0}
    if dtrace is not None:
        device_rec["busy_s"] = dtrace.busy_s
        device_rec["window_s"] = dtrace.window_s
    correct = bool(got["walls"]) and all(
        v <= lim for v, lim in checks.values())
    line = {"correct": correct,
            "attempted": len(got["walls"]) + len(got["errors"]),
            "failed": len(got["errors"]), "metrics": metrics,
            "device": device_rec}
    if dtrace is not None:
        line["breakdown"] = dtrace.breakdown()
    line["errors"] = errors[:3]
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, (v, lim) in checks.items()}
    return line


def program_path() -> None:
    """Put the checkout's ``src`` (the port) on the import path."""
    src = HERE.parent / "src"
    if src.is_dir() and str(src) not in sys.path:
        sys.path.insert(0, str(src))
