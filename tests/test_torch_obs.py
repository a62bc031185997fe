"""The port's observability (``repro_torch.obs``) against the reference's
(``repro.obs``): the span tracer (ring, nesting, Chrome-trace export),
the metrics registry, the per-action phase breakdown and the
disabled-tracing overhead bound.

The cases are the reference's ``tests/test_obs.py``, each run through
both packages on the same inputs; what they record (event names and
arguments, snapshots, rendered text) is compared.  One difference is
settled: the reference splits a program's first build into
``plan.lower`` and ``plan.compile`` (XLA's AOT lowering and compile);
the port runs its lowered program eagerly, so its build is the one
``plan.build`` span and those two names never appear.  The other way
round, the port spans its program's stages and the gather, which run
inside one compiled XLA program in the reference, where no host span
can sit.  The port's profiler sink (``tracing(profiler=True)``) is its
own and is tested on the port alone.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro.io as RI
import repro.obs as RO
import repro.runtime as RR
import repro_torch.core as T
import repro_torch.io as TI
import repro_torch.obs as TO
import repro_torch.runtime as TR
from repro.core.container import ContainerOp as RContainerOp
from repro_torch.core.container import ContainerOp as TContainerOp

PKGS = {
    R: dict(obs=RO, io=RI, rt=RR, op=RContainerOp, kw={},
            first_byte_mod3=lambda recs: (recs["data"][:, 0] % 3
                                          ).astype("int32")),
    T: dict(obs=TO, io=TI, rt=TR, op=TContainerOp, kw={"device": "cpu"},
            first_byte_mod3=lambda recs: (recs["data"][:, 0] % 3
                                          ).to(torch.int32)),
}

#: The reference's span names that the port's eager lowering has no
#: counterpart for (module docstring).
REFERENCE_ONLY = {"plan.lower", "plan.compile"}
#: The port's spans inside its program and around the gather, which the
#: reference's compiled program has no host span for (module docstring).
PORT_ONLY = {"map", "exchange", "keyed.combine", "keyed.merge",
             "tree_reduce", "gather"}


def both(case):
    """case(mod, pkg) for the reference, then the port; returns both."""
    return case(R, PKGS[R]), case(T, PKGS[T])


def _executor(pkg):
    return pkg["rt"].Executor(mat_cache=pkg["rt"].MaterializationCache())


def _ident_op(pkg, name="obs/id"):
    return pkg["op"](image=name, fn=lambda part, **kw: part)


def _shape(evs):
    """Events without their clocks and thread ids."""
    return [{k: v for k, v in e.items()
             if k not in ("ts", "dur", "pid", "tid")} for e in evs]


# -- tracer unit behavior -----------------------------------------------------

def test_disabled_span_is_shared_null_object():
    def case(mod, pkg):
        obs = pkg["obs"]
        assert not obs.TRACER.enabled
        before = obs.TRACER.events_total
        a, b = obs.span("x", k=1), obs.span("y")
        assert a is b                       # no allocation on the fast path
        with a as s:
            s.set(late=True)                # all no-ops
        obs.instant("nothing")
        return obs.TRACER.events_total - before, type(a).__name__
    ref, port = both(case)
    assert ref == port == (0, "_NullSpan")


def test_nested_spans_are_contained_and_args_recorded():
    def case(mod, pkg):
        obs = pkg["obs"]
        with obs.tracing() as t:
            with obs.span("outer", k=1) as sp:
                with obs.span("inner"):
                    pass
                sp.set(late=2)
            obs.instant("marker", batch=3)
        assert not obs.TRACER.enabled       # tracing() restored the state
        evs = t.events()
        inner, outer, marker = evs
        assert outer["ts"] <= inner["ts"]
        assert (outer["ts"] + outer["dur"]) >= (inner["ts"] + inner["dur"])
        return _shape(evs)
    ref, port = both(case)
    assert [e["name"] for e in port] == ["inner", "outer", "marker"]
    assert port[1]["args"] == {"k": 1, "late": 2}
    assert port[2]["ph"] == "i" and port[2]["args"] == {"batch": 3}
    assert ref == port


def test_ring_bounds_events_and_counts_drops():
    def case(mod, pkg):
        t = pkg["obs"].Tracer(capacity=8).start()
        for i in range(20):
            t.instant(f"e{i}")
        return (len(t.events()), t.events_total, t.events_dropped,
                [e["name"] for e in t.events()])
    ref, port = both(case)
    assert port == (8, 20, 12, [f"e{i}" for i in range(12, 20)])
    assert ref == port


def test_export_writes_valid_chrome_trace_object(tmp_path):
    def case(mod, pkg):
        obs = pkg["obs"]
        with obs.tracing() as t:
            with obs.span("work", n=1):
                pass
        out = t.export(str(tmp_path / f"trace_{mod.__name__}.json"))
        with open(out) as f:
            payload = json.load(f)
        assert isinstance(payload["traceEvents"], list)
        ev = payload["traceEvents"][0]
        assert {"ts", "dur", "pid", "tid"} <= set(ev)
        return (payload["displayTimeUnit"], payload["otherData"],
                _shape(payload["traceEvents"]))
    ref, port = both(case)
    assert port == ("ms", {"events_total": 1, "events_dropped": 0},
                    [{"name": "work", "ph": "X", "args": {"n": 1}}])
    assert ref == port


def test_timed_accumulates_phases_with_tracing_off():
    def case(mod, pkg):
        obs = pkg["obs"]
        assert not obs.TRACER.enabled
        before = obs.TRACER.events_total
        phases = {}
        with obs.timed("p", phases):
            time.sleep(0.01)
        with obs.timed("p", phases):
            pass
        assert phases["p"] >= 0.01          # accumulated across both blocks
        return sorted(phases), obs.TRACER.events_total - before
    ref, port = both(case)
    assert ref == port == (["p"], 0)        # no span recorded while off


# -- metrics registry ---------------------------------------------------------

def test_metrics_counter_gauge_histogram_snapshot():
    def case(mod, pkg):
        reg = pkg["obs"].MetricsRegistry()
        reg.counter("c").inc()
        reg.counter("c").inc(4)             # get-or-create: same instance
        reg.gauge("g").set(7)
        for v in (0.001, 0.002, 0.003):
            reg.histogram("h").observe(v)
        snap = reg.snapshot()
        assert abs(snap["h"]["mean"] - 0.002) < 1e-9
        text = reg.render()
        one = reg.render(prefix="h")
        pcts = [reg.histogram("h").percentile(q) for q in (50, 99)]
        reg.reset()
        return snap, text, one, pcts, reg.snapshot()
    ref, port = both(case)
    snap, text, one, _, empty = port
    assert snap["c"] == 5 and snap["g"] == 7
    assert snap["h"]["count"] == 3
    assert snap["h"]["min"] == 0.001 and snap["h"]["max"] == 0.003
    assert "c" in text and "count=3" in text
    assert one.count("\n") == 0
    assert empty == {}
    assert ref == port


# -- integration: traced source-ingested action -------------------------------

def _contains(outer, inner):
    return (outer["tid"] == inner["tid"]
            and outer["ts"] <= inner["ts"]
            and outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"])


def test_traced_action_exports_nested_spans_and_phases(tmp_path):
    p = tmp_path / "d.txt"
    p.write_text("\n".join(f"line-{i:03d}" for i in range(64)) + "\n")

    def case(mod, pkg):
        obs = pkg["obs"]
        ex = _executor(pkg)
        with obs.tracing() as t:
            m = mod.MaRe.from_source(pkg["io"].text_source(str(p)),
                                     executor=ex, **pkg["kw"])
            m.plan_cache = mod.PlanCache()  # fresh: force a real build
            q = m.repartition_by(pkg["first_byte_mod3"])
            got = q.collect()
        out = t.export(str(tmp_path / f"trace_{mod.__name__}.json"))
        with open(out) as f:
            evs = json.load(f)["traceEvents"]
        names = {e["name"] for e in evs}

        # nesting: each executor phase span sits inside an action span on
        # the same thread (Chrome-trace nesting is by containment)
        actions = [e for e in evs if e["name"] == "action"]
        for inner_name in ({"plan.build", "plan.lower", "plan.compile",
                            "dispatch", "counter_sync"} & names):
            inner = [e for e in evs if e["name"] == inner_name]
            assert all(any(_contains(a, i) for a in actions)
                       for i in inner), inner_name
        # each per-split fetch sits inside the top-level ingest span's time
        # window (fetches may run on pool threads, so time-only)
        ingest_ev = next(e for e in evs if e["name"] == "ingest")
        for f_ev in (e for e in evs if e["name"] == "ingest.fetch"):
            assert ingest_ev["ts"] <= f_ev["ts"]
            assert (ingest_ev["ts"] + ingest_ev["dur"]
                    >= f_ev["ts"] + f_ev["dur"])

        # phase breakdown accounts for the action wall (>= 90%)
        rep = q.report()
        total = sum(rep.phases.values())
        assert total >= 0.9 * rep.wall_s, (rep.phases, rep.wall_s)
        assert total <= rep.wall_s * 1.01   # phases are disjoint sub-spans
        args = {e["name"]: e.get("args") for e in evs
                if e["name"] in ("ingest", "action", "dispatch",
                                 "ingest.device_put", "plan.typecheck")}
        return (names, sorted(rep.phases), args,
                sorted(int(x) for x in np.asarray(got["len"])))
    ref, port = both(case)
    assert {"ingest", "ingest.fetch", "ingest.frame", "ingest.gather",
            "ingest.device_put", "action", "plan.typecheck", "plan.build",
            "dispatch", "counter_sync", "cache_lookup",
            "device_wait"} <= port[0]
    assert {"exchange", "gather"} <= port[0]
    assert port[0] - PORT_ONLY == ref[0] - REFERENCE_ONLY
    assert port[1] == sorted(set(ref[1]) - REFERENCE_ONLY)
    assert {"plan.build", "dispatch", "device_wait"} <= set(port[1])
    ref_args, port_args = ref[2], port[2]
    assert port_args["ingest"]["parser"] == "vectorized"
    # the port's first dispatch of a program carries its counted work
    # (the reference sets it on plan.compile, which the port lacks)
    cost = {k: port_args["dispatch"].pop(k)
            for k in ("flops", "bytes", "wire_bytes")}
    assert cost["bytes"] > 0 and cost["flops"] >= 0, cost
    assert port_args == ref_args
    assert ref[3] == port[3]


def test_mare_metrics_and_trace_to_surface(tmp_path):
    def case(mod, pkg):
        obs = pkg["obs"]
        m = mod.MaRe((np.arange(32, dtype=np.int32),),
                     plan_cache=mod.PlanCache(), executor=_executor(pkg),
                     **pkg["kw"]).map(op=_ident_op(pkg))
        with obs.tracing():
            m.collect()
        out = m.trace_to(str(tmp_path / f"t_{mod.__name__}.json"))
        with open(out) as f:
            names = sorted({e["name"] for e in
                            json.load(f)["traceEvents"]})
        snap = m.metrics()
        assert snap["executor.actions"] >= 1
        assert "phase.dispatch" in snap
        assert snap == obs.METRICS.snapshot()
        return names
    ref, port = both(case)
    assert "action" in port
    assert {"map", "gather"} <= set(port)
    assert set(port) - PORT_ONLY == set(ref) - REFERENCE_ONLY


# -- overhead bound -----------------------------------------------------------

def _best_seconds(fn, reps: int) -> float:
    """Fastest of ``reps`` timed calls: noise from other processes only
    ever adds time, so the minimum is the steadiest estimate."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


@pytest.mark.parametrize("mod", [R, T], ids=["reference", "port"])
def test_disabled_tracing_overhead_under_5pct_of_small_action(mod):
    """The instrumentation is always on; with no sink attached a span is
    one attribute load + branch.  Bound: crossing every site a warm fused
    action actually hits (action, cache_lookup, dispatch, device_wait,
    counter_sync, and in the port map and gather + headroom: 16 spans)
    must cost < 5% of that action.
    Both sides are the best of repeated timings, so a busy machine
    (other test workers) does not decide the outcome."""
    pkg = PKGS[mod]
    obs = pkg["obs"]
    assert not obs.TRACER.enabled
    m = mod.MaRe((np.arange(1 << 20, dtype=np.int32),),
                 plan_cache=mod.PlanCache(), executor=_executor(pkg),
                 **pkg["kw"]).map(op=_ident_op(pkg))
    m.collect()                             # build once
    action_s = _best_seconds(m.collect, reps=5)

    n = 10_000

    def spans():
        for _ in range(n):
            with obs.span("x"):
                pass
    per_span = _best_seconds(spans, reps=5) / n
    assert per_span * 16 < 0.05 * action_s, (per_span, action_s)


# -- the profiler sink (the port's own) ---------------------------------------

def _profiled(fn, tracing_kw=None):
    """``fn()`` inside a CPU ``torch.profiler`` session, with the port's
    tracer switched on as ``tracing_kw`` says (off when None); returns
    the result, the profiler's ``mare.*`` host ranges in time order, and
    the ring's events."""
    from torch.profiler import ProfilerActivity, profile
    ring = []
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        if tracing_kw is None:
            out = fn()
        else:
            with TO.tracing(**tracing_kw) as t:
                out = fn()
            ring = t.events()
    ranges = sorted((e for e in prof.events()
                     if e.name.startswith(TO.PREFIX)),
                    key=lambda e: e.time_range.start)
    return out, ranges, ring


def _within(outer, inner) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def _kmer_action(executor=None):
    rng = np.random.default_rng(8)
    data = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8),
                      size=(300, 64)).astype(np.uint8)
    lens = rng.integers(0, 65, 300).astype(np.int32)
    m = (T.MaRe({"data": data, "len": lens}, num_shards=4, device="cpu",
                plan_cache=T.PlanCache(),
                executor=executor or _executor(PKGS[T]))
         .map(image="kmer-stats", command="kmer-stats 5")
         .reduce_by_key(lambda r: r[0], value_by=lambda r: (r[1],),
                        op="sum"))
    return m.collect(), m


def test_profiler_sink_nests_the_kmer_actions_layers():
    """A k-mer ``collect()`` under ``tracing(profiler=True)`` inside a
    CPU profiler session: ``mare.action > mare.dispatch > mare.map |
    mare.exchange | mare.keyed.combine | mare.keyed.merge`` as nested
    host ranges in that order, then ``mare.gather`` after the action,
    carrying the action's id as its first input and in the ring."""
    ex = _executor(PKGS[T])
    (keys, _, _), m = _kmer_action(ex)
    _, ranges, ring = _profiled(lambda: _kmer_action(ex),
                                {"profiler": True})
    by = {}
    for e in ranges:
        by.setdefault(e.name[len(TO.PREFIX):], []).append(e)
    (action,), (dispatch,), (gather,) = (by["action"], by["dispatch"],
                                         by["gather"])
    assert _within(action, dispatch)
    layers = [e for e in ranges if e.name[len(TO.PREFIX):] in
              ("map", "exchange", "keyed.combine", "keyed.merge")]
    assert [e.name for e in layers] == [
        "mare.map", "mare.keyed.combine", "mare.exchange",
        "mare.keyed.merge"]
    assert all(_within(dispatch, e) for e in layers)
    assert gather.time_range.start >= action.time_range.end
    action_id = m.report().action_id + 1      # the profiled action's
    assert gather.concrete_inputs[0] == action_id
    ring_ids = {e["name"]: e["args"].get("action_id") for e in ring
                if e["name"] in ("action", "gather")}
    assert ring_ids == {"action": action_id, "gather": action_id}
    ring_gather = next(e for e in ring if e["name"] == "gather")["args"]
    assert ring_gather["rows"] == len(keys)
    assert ring_gather["bytes"] > 0
    # each range's ring event carries the same name without the prefix
    assert {e.name[len(TO.PREFIX):] for e in ranges} \
        == {e["name"] for e in ring}


def test_profiler_sink_shows_the_listing3_tree_reduce():
    """A Listing-3-style pipeline (map -> repartition_by -> map ->
    reduce(toolbox/concat, depth=2) -> collect(shard=0)) shows one
    ``mare.exchange`` and one ``mare.tree_reduce`` inside the dispatch,
    with the image and depth in the ring."""
    data = np.arange(64, dtype=np.int32)

    def action():
        return (T.MaRe((data,), num_shards=8, device="cpu",
                       plan_cache=T.PlanCache(),
                       executor=_executor(PKGS[T]))
                .map(op=_ident_op(PKGS[T]))
                .repartition_by(lambda r: r[0] % 3)
                .map(op=_ident_op(PKGS[T], "obs/id2"))
                .reduce(image="toolbox/concat", depth=2)
                .collect(shard=0))

    (got,), ranges, ring = _profiled(action, {"profiler": True})
    assert sorted(got.tolist()) == data.tolist()
    names = [e.name for e in ranges]
    assert names.count("mare.exchange") == 1
    assert names.count("mare.tree_reduce") == 1
    assert names.count("mare.map") == 2
    (dispatch,) = [e for e in ranges if e.name == "mare.dispatch"]
    (tree,) = [e for e in ranges if e.name == "mare.tree_reduce"]
    assert _within(dispatch, tree)
    args = next(e for e in ring if e["name"] == "tree_reduce")["args"]
    assert args == {"image": "toolbox/concat:latest", "depth": 2}


@pytest.mark.parametrize("ring", [False, True],
                         ids=["tracer_off", "ring_only"])
def test_no_profiler_range_without_the_profiler_sink(ring):
    """With the tracer off, or with the ring alone, the program opens no
    profiler range and the answer is the same; with the tracer off
    ``span()`` is still the shared null object."""
    (keys, _, _), _ = _kmer_action()
    (again, _, _), ranges, events = _profiled(
        lambda: _kmer_action()[0], {} if ring else None)
    np.testing.assert_array_equal(again, keys)
    assert ranges == []
    assert bool(events) == ring
    assert not TO.TRACER.enabled and not TO.TRACER.profiling
    assert TO.span("map") is TO.span("gather")
    assert type(TO.span("exchange")).__name__ == "_NullSpan"


def test_tracing_restores_both_sinks():
    with TO.tracing(profiler=True):
        assert TO.TRACER.enabled and TO.TRACER.profiling
        with TO.tracing():                  # the ring alone keeps the sink
            assert TO.TRACER.profiling
        assert TO.TRACER.profiling
    assert not TO.TRACER.enabled and not TO.TRACER.profiling
    t = TO.Tracer().start(profiler=True)
    assert t.stop().profiling is False


def test_trace_module_imports_without_torch():
    """``obs.trace`` needs torch only for the profiler sink: loaded in a
    process where ``import torch`` fails, the ring records and
    ``start(profiler=True)`` raises ImportError."""
    path = Path(TO.__file__).with_name("trace.py")
    code = f"""
import importlib.util, sys
sys.modules["torch"] = None
spec = importlib.util.spec_from_file_location("trace_alone", {str(path)!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
t = mod.Tracer().start()
with t.span("x", n=1):
    pass
assert [e["name"] for e in t.events()] == ["x"]
try:
    t.start(profiler=True)
except ImportError:
    print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.stdout.strip() == "ok", out.stderr


def test_events_carry_the_recording_process_id():
    """The ring reads the process id once, and again in a forked child:
    an event recorded in the child carries the child's id."""
    path = Path(TO.__file__).with_name("trace.py")
    code = f"""
import importlib.util, os
spec = importlib.util.spec_from_file_location("trace_alone", {str(path)!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
t = mod.Tracer().start()
t.instant("parent")
assert t.events()[0]["pid"] == os.getpid()
r, w = os.pipe()
child = os.fork()
if child == 0:
    t.instant("child")
    os.write(w, str(t.events()[-1]["pid"] == os.getpid()).encode())
    os._exit(0)
os.waitpid(child, 0)
print(os.read(r, 16).decode())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.stdout.strip() == "True", out.stderr
