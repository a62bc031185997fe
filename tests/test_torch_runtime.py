"""The port's runtime layer against the reference: the lineage-keyed
materialization cache (prefix reuse, budgeted LRU tiers), the async
action engine, the per-action report history, counters across chained
handles, the executor's counter checks and the lineage fingerprints
(``repro_torch.runtime.{cache,executor,reports,lineage}``), at one shard
in this process.

The cases named as in the reference are its ``tests/test_runtime.py``
cases, all 21, each run through both packages on the same inputs.  The
rest hold further parts of the port's runtime to the reference's on the
same inputs: report fields, counter totals, the counter checks' errors,
lineage digests and the cache's size estimate.

An op's Python function runs once per lowered program in the reference
(``jit`` traces it) and once per execution in the port (eager); a
counting op counts the same in both wherever a cached prefix is NOT
re-run, which is what these cases pin.
"""
import collections
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.io as RI
import repro.runtime as RR
import repro_torch.core as T
import repro_torch.io as TI
import repro_torch.runtime as TR
from repro import compat
from repro.core.container import ContainerOp as RContainerOp
from repro.runtime.reports import ActionReport as RReport
from repro.runtime.reports import ReportLog as RLog
from repro_torch.core.container import ContainerOp as TContainerOp
from repro_torch.runtime.reports import ActionReport as TReport
from repro_torch.runtime.reports import ReportLog as TLog

PKGS = {
    R: dict(op=RContainerOp, report=RReport, log=RLog, rt=RR, kw={},
            executor=lambda **kw: RR.Executor(
                mat_cache=RR.MaterializationCache(**kw)),
            vec=jnp.asarray, io=RI,
            host=lambda recs: R.from_host(
                recs, compat.make_mesh((1,), ("data",)))),
    T: dict(op=TContainerOp, report=TReport, log=TLog, rt=TR,
            kw={"device": "cpu"},
            executor=lambda **kw: TR.Executor(
                mat_cache=TR.MaterializationCache(**kw)),
            vec=torch.as_tensor, io=TI,
            host=lambda recs: T.from_host(recs, 1, device="cpu")),
}


def both(case):
    """case(mod, pkg) for the reference, then the port; returns both."""
    return case(R, PKGS[R]), case(T, PKGS[T])


def mare(mod, pkg, data, **kw):
    return mod.MaRe(data, **pkg["kw"], **kw)


def _key_first(recs):
    return recs[0]


def _val_second(recs):
    return (recs[1],)


def _keyed(mod, pkg, num_keys=4, cache=None, executor=None):
    keys = np.array([0, 1, 2, 3] * 8, np.int32) % num_keys
    vals = np.ones(32, np.float32)
    return mare(mod, pkg, (keys, vals),
                plan_cache=cache if cache is not None else mod.PlanCache(),
                executor=executor or pkg["executor"]()).reduce_by_key(
        _key_first, value_by=_val_second, op="sum", num_keys=num_keys)


# -- the reference's cases ----------------------------------------------------

def test_reportlog_overflow_bounds_history_but_counts_monotonically():
    def case(mod, pkg):
        log = pkg["log"](maxlen=4)
        for _ in range(10):
            log.append(pkg["report"](action_id=log.new_id(), plan="p",
                                     total_stages=1))
        return (len(log), log.appended, [r.action_id for r in log],
                log.new_id(), log.latest.action_id)
    ref, port = both(case)
    assert ref == port == (4, 10, [6, 7, 8, 9], 10, 9)


def test_report_diagnostics_survive_chaining():
    def case(mod, pkg):
        m = _keyed(mod, pkg)
        m.collect()
        diag = m.report().diagnostics
        assert diag["stage0.exchanged_records"] > 0
        chained = m.map(op=pkg["op"](image="rt/id",
                                     fn=lambda part, **kw: part))
        assert chained.report().diagnostics == diag
        chained.collect()
        assert len(chained.reports()) == 2
        assert chained.reports()[0].counters == diag
        assert chained.report().diagnostics == {}   # map-only action
        return diag
    ref, port = both(case)
    assert ref == port


def test_describe_lists_keyed_reduce_counter_specs():
    def case(mod, pkg):
        return _keyed(mod, pkg, num_keys=2).describe()
    ref, port = both(case)
    assert "counters=[" in port and "stage0.key_overflow" in port
    assert "stage0.exchanged_records" in port
    assert ref == port


# -- what the port's runtime has, held to the reference -----------------------

def test_action_report_fields_match():
    def case(mod, pkg):
        cache, executor = mod.PlanCache(), pkg["executor"]()
        reports = []
        for _ in range(2):                     # the second: a cache hit
            m = _keyed(mod, pkg, cache=cache, executor=executor)
            m.collect()
            reports.append(m.report())
        return [(r.plan, r.total_stages, r.counters, r.programs_compiled,
                 r.program_cache_hits) for r in reports]
    ref, port = both(case)
    assert port[0][3:] == (1, 0) and port[1][3:] == (0, 1)
    assert ref == port


def test_reportlog_total_sums_every_stage():
    def case(mod, pkg):
        log = pkg["log"]()
        for i, counters in enumerate((
                {"stage0.exchanged_records": 5, "stage1.key_overflow": 0},
                {"stage2.exchanged_records": 7},
                {"exchanged_records": 1})):
            log.append(pkg["report"](action_id=i, plan="p", total_stages=3,
                                     counters=counters))
        return (log.total("exchanged_records"), log.total("key_overflow"),
                log[1].action_id, log.latest.diagnostics)
    ref, port = both(case)
    assert ref == port == (13, 0, 1, {"exchanged_records": 1})


@pytest.mark.parametrize("counts,kinds", [
    ([[0, 3, 0], [0, 4, 0]], "key_overflow"),
    ([[2, 0, 0], [5, 0, 0]], "shuffle_dropped"),
    ([[0, 0, 4], [0, 0, 9]], "none: max_send_count max-reduces"),
], ids=["key_overflow", "shuffle_dropped", "clean"])
def test_check_counters_raise_and_record_alike(counts, kinds):
    """Two shards' counters: totals sum over shards, max_send_count takes
    the largest, and an overflow raises the same message."""
    specs = ((0, "shuffle_dropped"), (1, "key_overflow"),
             (1, "max_send_count"))

    def case(mod, pkg):
        vec = pkg["vec"](np.asarray(counts, np.int32).reshape(-1))
        diag = {}
        try:
            pkg["rt"].check_counters(vec, specs, 2, diag, stage_offset=1)
        except RuntimeError as e:
            return diag, str(e)
        return diag, None
    ref, port = both(case)
    assert ref == port
    assert (port[1] is None) == kinds.startswith("none")
    assert port[0]["stage2.max_send_count"] == max(counts[0][2],
                                                   counts[1][2])


def test_lineage_digests_match():
    """An ingested source's root is content-keyed alike in both packages
    (same backend, format, byte ranges and pack geometry, same digest); a
    host-parallelized dataset's root is fresh each time in both."""
    split = collections.namedtuple("Split", "path start stop file_size")
    splits = [split("a.fa", 0, 100, 250), split("a.fa", 100, 250, 250)]

    def case(mod, pkg):
        rt = pkg["rt"]
        src = rt.source_root("local", "fasta", splits, 4, 64)
        same = rt.source_root("local", "fasta", list(splits), 4, 64)
        other = rt.source_root("local", "fasta", splits[:1], 4, 64)
        assert src.digest() == same.digest() != other.digest()
        return (src.digest(), other.digest(),
                rt.host_root().digest() == rt.host_root().digest())
    ref, port = both(case)
    assert port[2] is False and ref == port


# -- the materialization cache: prefix hits across forked handles -------------

def _counting_op(pkg, name="rt/counter"):
    """An op whose fn counts its runs: a cached-prefix action executes the
    suffix only, so the prefix op must not run again."""
    runs = {"n": 0}

    def fn(part, **kw):
        runs["n"] += 1
        return part

    return pkg["op"](image=name, fn=fn), runs


def _ident_op(pkg, name="rt/id"):
    return pkg["op"](image=name, fn=lambda part, **kw: part)


def _key_mod3(recs):
    return recs[0] % 3


def _data(n=32):
    return (np.arange(n, dtype=np.int32),)


def _report(r):
    """A report's fields that do not depend on the clock."""
    return (r.plan, r.total_stages, r.cached_stages, r.executed_stages,
            r.cache_tier, r.counters, r.programs_compiled,
            r.program_cache_hits, r.label)


def test_persist_prefix_hit_on_forked_handle():
    def case(mod, pkg):
        op, runs = _counting_op(pkg)
        base = mare(mod, pkg, _data(), plan_cache=mod.PlanCache(),
                    executor=pkg["executor"]())
        base.map(op=op).persist()
        after_persist = runs["n"]
        assert after_persist == 1
        # a FORK of base rebuilding the same map prefix + a new suffix:
        # the prefix is served from the cache, so the map op never runs
        q = base.map(op=op).repartition_by(_key_mod3)
        got = q.collect()
        assert sorted(got[0].tolist()) == list(range(32))
        assert runs["n"] == after_persist
        report = q.report()
        assert report.cached_stages == 1 and report.total_stages == 2
        assert report.cache_tier == "device"
        return _report(report), runs["n"]
    ref, port = both(case)
    assert ref == port


def test_whole_plan_hit_compiles_and_executes_nothing():
    def case(mod, pkg):
        op, runs = _counting_op(pkg)
        cache = mod.PlanCache()
        base = mare(mod, pkg, _data(), plan_cache=cache,
                    executor=pkg["executor"]())
        base.map(op=op).persist()
        compiles_after_persist = cache.stats()["misses"]
        q = base.map(op=op)                 # exactly the persisted plan
        got = q.collect()
        assert sorted(got[0].tolist()) == list(range(32))
        report = q.report()
        assert report.cached_stages == report.total_stages == 1
        assert report.programs_compiled == 0
        assert cache.stats()["misses"] == compiles_after_persist
        return _report(report), runs["n"], cache.stats()
    ref, port = both(case)
    assert ref == port


def test_different_prefix_misses():
    def case(mod, pkg):
        op_a, _ = _counting_op(pkg, "rt/a")
        op_b, runs_b = _counting_op(pkg, "rt/b")
        base = mare(mod, pkg, _data(), plan_cache=mod.PlanCache(),
                    executor=pkg["executor"]())
        base.map(op=op_a).persist()
        q = base.map(op=op_b)               # different op -> different node
        q.collect()
        assert q.report().cached_stages == 0
        assert runs_b["n"] == 1             # really executed
        return _report(q.report())
    ref, port = both(case)
    assert ref == port


def test_separately_parallelized_hosts_do_not_share_lineage():
    """Equal host arrays parallelized twice get distinct roots — content
    identity is unknown, so never a false hit."""
    def case(mod, pkg):
        op, _ = _counting_op(pkg)
        ex = pkg["executor"]()
        mare(mod, pkg, _data(), plan_cache=mod.PlanCache(),
             executor=ex).map(op=op).persist()
        q = mare(mod, pkg, _data(), plan_cache=mod.PlanCache(),
                 executor=ex).map(op=op)
        q.collect()
        return _report(q.report()), len(ex.mat_cache)
    ref, port = both(case)
    assert port[0][2] == 0
    assert ref == port


def test_cache_is_persist_sugar():
    def case(mod, pkg):
        op, _ = _counting_op(pkg)
        ex = pkg["executor"]()
        base = mare(mod, pkg, _data(), plan_cache=mod.PlanCache(),
                    executor=ex)
        cached = base.map(op=op).cache()
        assert len(ex.mat_cache) == 1
        assert cached.plan.empty
        q = base.map(op=op)
        q.collect()
        assert q.report().cached_stages == 1
        return _report(q.report()), ex.mat_cache.stats()
    ref, port = both(case)
    assert ref == port


def test_ingest_lineage_is_content_keyed(tmp_path):
    """Re-opening the same source reaches materializations persisted by a
    previous handle (roots digest the resolved splits + geometry)."""
    p = tmp_path / "d.txt"
    p.write_text("\n".join(f"line-{i}" for i in range(50)) + "\n")

    def case(mod, pkg):
        op, runs = _counting_op(pkg)
        ex = pkg["executor"]()
        cache = mod.PlanCache()
        m1 = mod.MaRe.from_source(pkg["io"].text_source(str(p)),
                                  executor=ex, **pkg["kw"])
        m1.plan_cache = cache
        m1.map(op=op).persist()
        after_persist = runs["n"]
        m2 = mod.MaRe.from_source(pkg["io"].text_source(str(p)),
                                  executor=ex, **pkg["kw"])
        m2.plan_cache = cache
        q = m2.map(op=op)
        got = q.collect()
        assert q.report().cached_stages == 1
        assert runs["n"] == after_persist
        return (_report(q.report()), m2._dataset.lineage.source,
                sorted(bytes(r[:n]) for r, n in zip(got["data"],
                                                    got["len"])))
    ref, port = both(case)
    assert ref == port


# -- budgeted LRU tiers -------------------------------------------------------

def _tiny_ds(pkg, n=8, fill=0):
    ds = pkg["host"]((np.full(n, fill, np.int32),))
    ds.lineage = pkg["rt"].host_root("test")
    return ds


def _host(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def test_estimate_nbytes_schema_based():
    def case(mod, pkg):
        est = pkg["rt"].estimate_nbytes
        kv = pkg["host"]((np.arange(10, dtype=np.int32),
                          np.ones((10, 3), np.float32),
                          {"b": np.zeros((10, 2, 5), np.uint8)}))
        return est(_tiny_ds(pkg, n=8)), est(kv)
    ref, port = both(case)
    assert port[0] == 8 * 4 + 4             # records + counts
    assert ref == port


def test_device_eviction_spills_to_host_then_hits():
    def case(mod, pkg):
        a, b = _tiny_ds(pkg, fill=1), _tiny_ds(pkg, fill=2)
        # budget fits exactly one 36-byte entry: putting b evicts a (LRU)
        cache = pkg["rt"].MaterializationCache(device_budget_bytes=40)
        cache.put(a)
        cache.put(b)
        assert cache.stats()["spills"] == 1
        assert cache.entry(a.lineage).tier == "host"
        assert cache.entry(b.lineage).tier == "device"
        got = cache.get(a.lineage)          # host hit: placed back
        assert got is not None
        assert got.lineage == a.lineage
        return _host(got.records[0]).tolist(), cache.stats()
    ref, port = both(case)
    assert port[0] == [1] * 8
    assert port[1]["hits"] == 1 and port[1]["host_hits"] == 1
    assert ref == port


def test_host_eviction_drops_lru():
    def case(mod, pkg):
        a, b = _tiny_ds(pkg, fill=1), _tiny_ds(pkg, fill=2)
        cache = pkg["rt"].MaterializationCache(device_budget_bytes=40,
                                               host_budget_bytes=40)
        cache.put(a)
        cache.put(b)                        # a spills to host (fits)
        c = _tiny_ds(pkg, fill=3)
        cache.put(c)                        # b spills; host over budget
        assert cache.entry(a.lineage) is None   # LRU host entry dropped
        assert cache.entry(b.lineage).tier == "host"
        assert cache.entry(c.lineage).tier == "device"
        assert cache.get(a.lineage) is None     # recompute from lineage
        return cache.stats()
    ref, port = both(case)
    assert port["spills"] == 2 and port["drops"] == 1
    assert ref == port


def test_prefix_hit_from_host_tier_via_executor():
    def case(mod, pkg):
        op, runs = _counting_op(pkg)
        # device budget below one dataset: persist lands on device then
        # is immediately spilled -> the later hit comes from the host tier
        ex = pkg["executor"](device_budget_bytes=1)
        base = mare(mod, pkg, _data(), plan_cache=mod.PlanCache(),
                    executor=ex)
        base.map(op=op).persist()
        assert ex.mat_cache.stats()["spills"] == 1
        q = base.map(op=op).repartition_by(_key_mod3)
        got = q.collect()
        assert sorted(got[0].tolist()) == list(range(32))
        assert q.report().cached_stages == 1
        assert q.report().cache_tier == "host"
        assert runs["n"] == 1               # prefix still not re-run
        return _report(q.report()), ex.mat_cache.stats()
    ref, port = both(case)
    assert ref == port


# -- async action engine ------------------------------------------------------

def test_async_actions_preserve_fifo_order():
    def case(mod, pkg):
        op, _ = _counting_op(pkg)
        ex = pkg["executor"]()
        cache = mod.PlanCache()
        handles = []
        for i in range(5):
            m = mare(mod, pkg, (np.full(16, i, np.int32),),
                     plan_cache=cache, executor=ex).map(op=op)
            handles.append(m.collect(asynchronous=True, label=f"q{i}"))
        for i, h in enumerate(handles):
            got = h.result(timeout=60)
            assert got[0].tolist() == [i] * 16
            assert h.done()
            assert h.report is not None and h.report.label == f"q{i}"
        ids = [r.action_id for r in ex.reports]
        assert ids == sorted(ids)           # dispatched in submit order
        return [r.label for r in ex.reports], [_report(h.report)
                                               for h in handles]
    ref, port = both(case)
    assert port[0] == [f"q{i}" for i in range(5)]
    assert ref == port


def test_async_action_delivers_exceptions():
    def case(mod, pkg):
        ex = pkg["executor"]()
        m = (mare(mod, pkg, (np.arange(4, dtype=np.int32),),
                  plan_cache=mod.PlanCache(), executor=ex)
             .repartition_by(lambda recs: recs[0] * 0, capacity=1))
        h = m.collect(asynchronous=True)
        with pytest.raises(RuntimeError, match="overflow") as e:
            h.result(timeout=60)
        # the worker survives the failed action
        ok = mare(mod, pkg, _data(4), plan_cache=mod.PlanCache(),
                  executor=ex).map(op=_ident_op(pkg))
        assert ok.collect(asynchronous=True).result(timeout=60)[0].tolist() \
            == [0, 1, 2, 3]
        return str(e.value)
    ref, port = both(case)
    assert ref == port


def test_async_result_timeout_does_not_poison_handle():
    def case(mod, pkg):
        ex = pkg["executor"]()
        release = threading.Event()
        h = ex.submit(lambda handle: (release.wait(30), "ok")[1],
                      label="slow")
        with pytest.raises(TimeoutError) as e:
            h.result(timeout=0.05)
        assert not h.done()
        release.set()
        assert h.result(timeout=30) == "ok"  # later call still succeeds
        assert h.done()
        return str(e.value)
    ref, port = both(case)
    assert ref == port


def test_queue_wait_measured_separately_from_execution():
    def case(mod, pkg):
        ex = pkg["executor"]()
        gate = threading.Event()
        ex.submit(lambda handle: gate.wait(30))     # hog the worker
        op, _ = _counting_op(pkg, "rt/qw")
        m = mare(mod, pkg, _data(), plan_cache=mod.PlanCache(),
                 executor=ex).map(op=op)
        t_submit = time.monotonic()
        h = m.collect(asynchronous=True, label="queued")
        time.sleep(0.25)
        gate.set()
        h.result(timeout=60)
        elapsed = time.monotonic() - t_submit
        assert h.queue_wait_s >= 0.2
        rep = h.report
        assert rep.queue_wait_s == h.queue_wait_s
        assert f"queue_wait={rep.queue_wait_s * 1e3:.1f}ms" in \
            rep.describe()
        # wait and execution are disjoint sub-intervals of submit->result
        assert rep.queue_wait_s + rep.wall_s <= elapsed + 0.05
        return _report(rep)
    ref, port = both(case)
    assert ref == port


def test_reportlog_summary_renders_phase_table():
    def case(mod, pkg):
        log = pkg["log"]()
        empty = log.summary()
        log.append(pkg["report"](
            action_id=0, plan="p", total_stages=2, cached_stages=1,
            programs_compiled=1, wall_s=0.2, queue_wait_s=0.1,
            phases={"dispatch": 0.15, "counter_sync": 0.05}))
        return empty, log.summary(), log.phase_totals()
    ref, port = both(case)
    empty, s, totals = port
    assert empty == "ReportLog: no actions recorded"
    assert "1 retained / 1 total actions" in s
    assert "queue_wait=0.100s" in s
    assert "2 planned, 1 served from cache" in s
    assert "programs compiled: 1" in s
    assert "dispatch" in s and "75.0%" in s     # 0.15 / 0.2 wall
    assert totals == {"dispatch": 0.15, "counter_sync": 0.05}
    assert ref == port


def test_async_is_snapshot_not_mutation():
    def case(mod, pkg):
        op, _ = _counting_op(pkg)
        m = mare(mod, pkg, _data(), plan_cache=mod.PlanCache(),
                 executor=pkg["executor"]()).map(op=op)
        h = m.collect(asynchronous=True)
        h.result(timeout=60)
        return m.plan.empty, m.describe()
    ref, port = both(case)
    assert port[0] is False                 # handle left lazy
    assert ref == port


def test_report_counters_keep_absolute_stage_indices_after_prefix_hit():
    """A suffix executed after a cached prefix reports counters under the
    ORIGINAL stage indices, not suffix-relative ones."""
    def case(mod, pkg):
        op, _ = _counting_op(pkg)
        keys = np.array([0, 1, 2, 3] * 8, np.int32)
        vals = np.ones(32, np.float32)
        base = mare(mod, pkg, (keys, vals), plan_cache=mod.PlanCache(),
                    executor=pkg["executor"]())
        base.map(op=op).persist()
        q = base.map(op=op).reduce_by_key(_key_first, value_by=_val_second,
                                          op="sum", num_keys=4)
        q.collect()
        report = q.report()
        assert report.cached_stages == 1
        assert "stage1.exchanged_records" in report.counters
        assert q.reports().total("exchanged_records") > 0
        return _report(report), q.reports().total("exchanged_records")
    ref, port = both(case)
    assert ref == port


def test_describe_annotates_cached_lineage_nodes_golden():
    def case(mod, pkg):
        ex = pkg["executor"]()
        cache = mod.PlanCache()
        op = _ident_op(pkg)
        base = mare(mod, pkg, pkg["host"]((np.arange(8, dtype=np.int32),)),
                    plan_cache=cache, executor=ex)
        base.map(op=op).persist()
        q = base.map(op=op).repartition_by(_key_mod3)
        fresh = mare(mod, pkg,
                     pkg["host"]((np.arange(8, dtype=np.int32),)),
                     plan_cache=cache, executor=ex).map(op=op)
        return q.describe(), fresh.describe()
    ref, port = both(case)
    assert port[0] == (
        "MaRe(shards=1, cap=8, schema=(i32)#8, "
        "plan=[map[rt/id:latest] : ?#? [cached] -> "
        "shuffle(cap=None) : ?#?], counters=[stage1.shuffle_dropped])")
    # the persisted node is marked; a fresh root is not
    assert "[cached]" not in port[1]
    assert ref == port


def test_cache_tenant_partitions_shared_hits_and_drop():
    """Per-owner budgets evict only the owner's entries, a reader other
    than the owner counts a shared hit, an explicit drop is an
    invalidation, and a tenant-tagged action names its tenant."""
    def case(mod, pkg):
        cache = pkg["rt"].MaterializationCache(
            tenant_device_budget_bytes=40)
        a, b, c = (_tiny_ds(pkg, fill=i) for i in (1, 2, 3))
        cache.put(a, owner="alice")
        cache.put(b, owner="bob")
        cache.put(c, owner="alice")         # alice over 40: a spills
        tiers = [cache.entry(d.lineage).tier for d in (a, b, c)]
        got = _host(cache.get(b.lineage, tenant="alice").records[0])
        owners = cache.owner_bytes()
        dropped = (cache.drop(c.lineage), cache.drop(c.lineage))
        ex = pkg["executor"]()
        m = mare(mod, pkg, _data(), plan_cache=mod.PlanCache(), executor=ex)
        ex.run(m._dataset, m.map(op=_ident_op(pkg)).plan, tenant="carol")
        rep = ex.reports.latest
        return (tiers, got.tolist(), owners, dropped, cache.stats(),
                rep.tenant, "tenant=carol" in rep.describe())
    ref, port = both(case)
    assert port[0] == ["host", "device", "device"]
    assert port[3] == (True, False)
    assert port[4]["shared_hits"] == 1 and port[4]["invalidations"] == 1
    assert port[5] == "carol" and port[6]
    assert ref == port
