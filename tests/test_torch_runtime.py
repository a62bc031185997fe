"""The port's runtime layer against the reference: the per-action report
history, counters across chained handles, the executor's counter checks
and the lineage fingerprints (``repro_torch.runtime.{executor,reports,
lineage}``), at one shard in this process.

The first three cases are the reference's ``tests/test_runtime.py`` cases
that need no materialization cache (ROADMAP Queue 1 item 9), no async
actions (item 10) and no ``ReportLog.summary`` (item 19); each runs
through both packages on the same inputs.  The rest hold what the port's
runtime has to the reference's on the same inputs: report fields, counter
totals, the counter checks' errors and lineage digests.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.runtime as RR
import repro_torch.core as T
import repro_torch.runtime as TR
from repro.core.container import ContainerOp as RContainerOp
from repro.runtime.reports import ActionReport as RReport
from repro.runtime.reports import ReportLog as RLog
from repro_torch.core.container import ContainerOp as TContainerOp
from repro_torch.runtime.reports import ActionReport as TReport
from repro_torch.runtime.reports import ReportLog as TLog

PKGS = {
    R: dict(op=RContainerOp, report=RReport, log=RLog, rt=RR, kw={},
            executor=lambda: RR.Executor(
                mat_cache=RR.MaterializationCache()),
            vec=jnp.asarray),
    T: dict(op=TContainerOp, report=TReport, log=TLog, rt=TR,
            kw={"device": "cpu"}, executor=TR.Executor,
            vec=torch.as_tensor),
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
