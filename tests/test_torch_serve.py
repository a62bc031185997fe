"""The port's serving layer (``repro_torch.serve``) against the
reference's (``repro.serve``): the DRR scheduler, admission, cross-
session batching, per-tenant cache partitions, report streams and tenant
isolation.

The cases named as in the reference are its ``tests/test_serve.py``
cases, all 24, each run through both packages on the same inputs; what
each observes (values, report fields, metrics, errors) is compared
exactly.  The port takes ``device="cpu"`` where the reference takes its
one-device mesh.  The last cases are the port's own: the report fields,
the kernel launches of max/min merges (their counts only), and
``launch.serve --service``.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.obs as RO
import repro.runtime as RR
import repro.serve as RV
import repro_torch.core as T
import repro_torch.obs as TO
import repro_torch.runtime as TR
import repro_torch.serve as TV
from repro import compat
from repro.core.container import ContainerOp as RContainerOp
from repro_torch.core.container import ContainerOp as TContainerOp
from repro_torch.kernels.segment_reduce import ops as tops

PKGS = {
    R: dict(serve=RV, rt=RR, obs=RO, op=RContainerOp, kw={},
            host=lambda recs: R.from_host(
                recs, compat.make_mesh((jax.device_count(),), ("data",)))),
    T: dict(serve=TV, rt=TR, obs=TO, op=TContainerOp, kw={"device": "cpu"},
            host=lambda recs: T.from_host(recs, 1, device="cpu")),
}


def both(case):
    """case(mod, pkg) for the reference, then the port; returns both."""
    return case(R, PKGS[R]), case(T, PKGS[T])


def drr_both(case):
    """case(DeficitRoundRobin, AdmissionError) through both packages."""
    return tuple(case(pkg["serve"].DeficitRoundRobin,
                      pkg["serve"].AdmissionError)
                 for pkg in (PKGS[R], PKGS[T]))


# -- scheduler ----------------------------------------------------------------

def test_drr_alternates_equal_cost_tenants():
    def case(DRR, _):
        drr = DRR(quantum=1.0)
        for i in range(3):
            drr.offer("a", f"a{i}", cost=1.0)
            drr.offer("b", f"b{i}", cost=1.0)
        taken = [drr.take(timeout=0) for _ in range(6)]
        # equal costs + quantum 1: strict alternation, no tenant bursts
        assert taken == ["a0", "b0", "a1", "b1", "a2", "b2"]
        assert drr.take(timeout=0) is None
        return taken
    ref, port = drr_both(case)
    assert ref == port


def test_drr_serves_cost_share_not_item_share():
    def case(DRR, _):
        # "big" queues 4-cost items, "small" 1-cost: over any window both
        # get the same COST share, so "small" gets ~4x the items
        drr = DRR(quantum=2.0, max_queued_per_tenant=16)
        for i in range(4):
            drr.offer("big", f"B{i}", cost=4.0)
        for i in range(12):
            drr.offer("small", f"s{i}", cost=1.0)
        first8 = [drr.take(timeout=0) for _ in range(8)]
        n_small = sum(1 for t in first8 if t.startswith("s"))
        assert n_small >= 2 * (8 - n_small)
        return first8
    ref, port = drr_both(case)
    assert ref == port


def test_drr_admission_limits_both_scopes():
    def case(DRR, AdmissionError):
        drr = DRR(max_queued_per_tenant=2, max_queued_total=3)
        drr.offer("a", 1)
        drr.offer("a", 2)
        with pytest.raises(AdmissionError) as e1:
            drr.offer("a", 3)
        assert e1.value.scope == "tenant" and e1.value.tenant == "a"
        drr.offer("b", 4)
        with pytest.raises(AdmissionError) as e2:
            drr.offer("b", 5)
        assert e2.value.scope == "total"
        assert drr.depths() == {"a": 2, "b": 1}
        return str(e1.value), str(e2.value), drr.depths()
    ref, port = drr_both(case)
    assert ref == port


def test_drr_extract_pulls_matches_from_all_tenants():
    def case(DRR, _):
        drr = DRR()
        drr.offer("a", ("k1", "a0"))
        drr.offer("a", ("k2", "a1"))
        drr.offer("b", ("k1", "b0"))
        out = drr.extract(lambda it: it[0] == "k1")
        assert sorted(v for _, v in out) == ["a0", "b0"]
        assert len(drr) == 1
        assert drr.take(timeout=0) == ("k2", "a1")
        assert drr.take(timeout=0) is None
        return out
    ref, port = drr_both(case)
    assert ref == port


def test_drr_take_blocks_until_offer():
    def case(DRR, _):
        drr = DRR()
        got = []
        t = threading.Thread(
            target=lambda: got.append(drr.take(timeout=5)))
        t.start()
        drr.offer("a", "x")
        t.join(timeout=5)
        assert not t.is_alive()
        assert got == ["x"]
        return got
    ref, port = drr_both(case)
    assert ref == port


# -- service fixtures ---------------------------------------------------------

def _service(mod, pkg, **over):
    cfg = dict(batch_window_s=0.0)
    cfg.update(over)
    rt = pkg["rt"]
    return pkg["serve"].QueryService(
        executor=rt.Executor(plan_cache=mod.PlanCache(),
                             mat_cache=rt.MaterializationCache()),
        config=pkg["serve"].ServiceConfig(**cfg))


def _double_op(pkg, name="serve/double"):
    return pkg["op"](image=name, fn=lambda part, **kw: part)


_OPS = {id(pkg): _double_op(pkg) for pkg in PKGS.values()}


def _op(pkg):
    return _OPS[id(pkg)]


def _data(n=32):
    return (np.arange(n, dtype=np.int32),)


def _bad_keys(recs):
    return recs[0]            # 0..31, far outside num_keys=2


def _good_keys(recs):
    return recs[0] % 2


def _vals(recs):
    return (recs[0],)


def _mare(sess, pkg, data):
    return sess.mare(data, **pkg["kw"])


def _rows(out):
    return np.asarray(out[0]).tolist()


# -- sessions: routing, reports, admission ------------------------------------

def test_session_sync_collect_routes_through_service():
    def case(mod, pkg):
        with _service(mod, pkg) as svc:
            sess = svc.session("alice")
            out = _mare(sess, pkg, _data()).map(op=_op(pkg)).collect()
            assert _rows(out) == list(range(32))
            rep = sess.report()
            assert rep is not None and rep.tenant == "alice"
            assert rep.batch_size == 1
            assert sess.reports.appended == 1
            # the executor's global history carries the dispatch too
            assert svc.executor.reports.latest.tenant == "alice"
            return (_rows(out), rep.tenant, rep.batch_size,
                    sess.reports.appended, rep.plan, rep.total_stages)
    ref, port = both(case)
    assert ref == port


def test_session_async_collect_and_labels():
    def case(mod, pkg):
        with _service(mod, pkg) as svc:
            sess = svc.session("alice")
            h = _mare(sess, pkg, _data()).map(op=_op(pkg)).collect(
                asynchronous=True, label="q0")
            out = h.result(timeout=60)
            assert _rows(out) == list(range(32))
            assert h.report.tenant == "alice" and h.report.label == "q0"
            return _rows(out), h.report.tenant, h.report.label
    ref, port = both(case)
    assert ref == port


def test_admission_rejection_raises_and_counts():
    def case(mod, pkg):
        pkg["obs"].METRICS.reset()
        with _service(mod, pkg, max_queued_per_tenant=0) as svc:
            sess = svc.session("carol")
            with pytest.raises(pkg["serve"].AdmissionError) as e:
                _mare(sess, pkg, _data()).map(op=_op(pkg)).collect()
        snap = pkg["obs"].METRICS.snapshot()
        assert snap["serve.admission_rejected"] == 1
        return str(e.value), e.value.scope, snap["serve.admission_rejected"]
    ref, port = both(case)
    assert ref == port


def test_session_rejects_reserved_mare_kwargs():
    def case(mod, pkg):
        with _service(mod, pkg) as svc:
            sess = svc.session("alice")
            with pytest.raises(TypeError, match="executor") as e:
                sess.mare(_data(), executor=svc.executor)
            return str(e.value)
    ref, port = both(case)
    assert ref == port


def test_report_stream_follow_blocks_until_report():
    def case(mod, pkg):
        with _service(mod, pkg) as svc:
            sess = svc.session("alice")
            got = []
            t = threading.Thread(
                target=lambda: got.append(sess.follow(0, timeout=30)))
            t.start()
            _mare(sess, pkg, _data()).map(op=_op(pkg)).collect()
            t.join(timeout=30)
            assert not t.is_alive()
            assert len(got) == 1 and [r.tenant for r in got[0]] == ["alice"]
            return [r.tenant for r in got[0]]
    ref, port = both(case)
    assert ref == port


# -- cross-session batching ---------------------------------------------------

def test_same_query_from_two_sessions_coalesces():
    def case(mod, pkg):
        pkg["obs"].METRICS.reset()
        with _service(mod, pkg, batch_window_s=0.5) as svc:
            a, b = svc.session("alice"), svc.session("bob")
            ds = pkg["host"](_data())
            # async back-to-back: both queued before the pump's batch
            # window closes, so they must share ONE dispatch
            ha = a.mare(ds).map(op=_op(pkg)).collect(asynchronous=True)
            hb = b.mare(ds).map(op=_op(pkg)).collect(asynchronous=True)
            va, vb = ha.result(timeout=60), hb.result(timeout=60)
            assert _rows(va) == _rows(vb)
            assert ha.report.batch_size == 2 and hb.report.batch_size == 2
            assert ha.report.batch_leader == hb.report.batch_leader
            assert {ha.report.tenant, hb.report.tenant} == {"alice", "bob"}
            assert a.reports.appended == 1 and b.reports.appended == 1
        snap = pkg["obs"].METRICS.snapshot()
        assert snap["serve.batched_followers"] == 1
        assert snap["serve.queue_depth.alice"] == 0
        assert snap["serve.queue_depth.bob"] == 0
        return (_rows(va), ha.report.batch_size,
                {k: v for k, v in snap.items()
                 if k.startswith("serve.") and not isinstance(v, dict)})
    ref, port = both(case)
    assert ref == port


def test_different_plans_never_coalesce():
    def case(mod, pkg):
        other = _double_op(pkg, "serve/other")
        with _service(mod, pkg, batch_window_s=0.3) as svc:
            a, b = svc.session("alice"), svc.session("bob")
            ds = pkg["host"](_data())
            ha = a.mare(ds).map(op=_op(pkg)).collect(asynchronous=True)
            hb = b.mare(ds).map(op=other).collect(asynchronous=True)
            ha.result(timeout=60), hb.result(timeout=60)
            assert ha.report.batch_size == 1
            assert hb.report.batch_size == 1
            return ha.report.batch_size, hb.report.batch_size
    ref, port = both(case)
    assert ref == port


# -- per-tenant cache partitions ----------------------------------------------

def test_tenant_persist_charged_to_owner_partition():
    def case(mod, pkg):
        with _service(mod, pkg) as svc:
            a, b = svc.session("alice"), svc.session("bob")
            _mare(a, pkg, _data()).persist()
            assert a.cache_bytes()["device"] > 0
            assert b.cache_bytes() == {"device": 0, "host": 0}
            return a.cache_bytes(), b.cache_bytes()
    ref, port = both(case)
    assert ref == port


def test_tenant_eviction_stays_within_owner():
    def case(mod, pkg):
        probe = pkg["rt"].estimate_nbytes(
            _mare(pkg["serve"].Session("probe"), pkg, _data())._dataset)
        budget = int(probe * 2.5)       # fits 2 entries, 3rd must evict
        with _service(mod, pkg, tenant_device_budget_bytes=budget) as svc:
            a, b = svc.session("alice"), svc.session("bob")
            _mare(b, pkg, _data()).persist()
            b_bytes = b.cache_bytes()["device"]
            for i in range(3):          # distinct datasets, distinct entries
                _mare(a, pkg, (np.arange(32, dtype=np.int32) + i,)).persist()
            cache = svc.executor.mat_cache
            # alice stayed within her partition by evicting HER entries;
            # bob's entry is untouched and no violation was recorded
            assert a.cache_bytes()["device"] <= budget
            assert b.cache_bytes()["device"] == b_bytes
            assert cache.stats()["tenant_budget_violations"] == 0
            return (probe, a.cache_bytes(), b.cache_bytes(),
                    cache.stats()["tenant_budget_violations"])
    ref, port = both(case)
    assert ref == port


def test_shared_prefix_read_counts_shared_hit():
    def case(mod, pkg):
        op = _double_op(pkg, "serve/prefix")
        with _service(mod, pkg) as svc:
            a, b = svc.session("alice"), svc.session("bob")
            ds = pkg["host"](_data())
            a.mare(ds).map(op=op).persist()
            out = b.mare(ds).map(op=op).collect()
            assert _rows(out) == list(range(32))
            assert b.report().cached_stages == 1
            shared = svc.executor.mat_cache.stats()["shared_hits"]
            assert shared >= 1
            return _rows(out), b.report().cached_stages, shared
    ref, port = both(case)
    assert ref == port


# -- tenant isolation ---------------------------------------------------------

def test_key_overflow_in_one_session_never_poisons_another():
    def case(mod, pkg):
        with _service(mod, pkg) as svc:
            a, b = svc.session("alice"), svc.session("bob")
            bad = (_mare(a, pkg, _data())
                   .reduce_by_key(_bad_keys, value_by=_vals, op="sum",
                                  num_keys=2))
            with pytest.raises(RuntimeError, match="overflow") as e:
                bad.collect()
            # the failure is alice's alone: bob's session still serves,
            # the pump and executor threads survived, and alice can query
            good = (_mare(b, pkg, _data())
                    .reduce_by_key(_good_keys, value_by=_vals, op="sum",
                                   num_keys=2))
            keys, (vals,), counts = good.collect()
            assert sorted(np.asarray(keys).tolist()) == [0, 1]
            assert b.report().tenant == "bob"
            out = _mare(a, pkg, _data()).map(op=_op(pkg)).collect()
            assert _rows(out) == list(range(32))
            order = np.argsort(np.asarray(keys))
            return (str(e.value), np.asarray(keys)[order].tolist(),
                    np.asarray(vals)[order].tolist(),
                    np.asarray(counts)[order].tolist(), _rows(out))
    ref, port = both(case)
    assert ref == port


# -- weighted DRR (priority tiers) --------------------------------------------

def test_drr_weights_bias_cost_share():
    def case(DRR, _):
        # gold (weight 3) vs bronze (weight 1), equal-cost items: served
        # cost over a saturated window tracks the weight ratio
        drr = DRR(quantum=1.0, max_queued_per_tenant=32,
                  weights={"gold": 3.0})
        for i in range(16):
            drr.offer("gold", f"g{i}", cost=1.0)
            drr.offer("bronze", f"b{i}", cost=1.0)
        first12 = [drr.take(timeout=0) for _ in range(12)]
        n_gold = sum(1 for t in first12 if t.startswith("g"))
        assert n_gold >= 2 * (12 - n_gold)
        # ...but bronze is never starved outright
        assert any(t.startswith("b") for t in first12)
        return first12
    ref, port = drr_both(case)
    assert ref == port


def test_drr_weight_validation_and_set_weight():
    def case(DRR, _):
        drr = DRR()
        assert drr.weight("anyone") == 1.0
        drr.set_weight("vip", 2.5)
        assert drr.weight("vip") == 2.5
        msgs = []
        for bad in (lambda: drr.set_weight("vip", 0.0),
                    lambda: DRR(weights={"x": -1.0}),
                    lambda: DRR(default_weight=0.0)):
            with pytest.raises(ValueError) as e:
                bad()
            msgs.append(str(e.value))
        return drr.weight("vip"), msgs
    ref, port = drr_both(case)
    assert ref == port


def test_drr_total_cost_tracks_offer_take_extract():
    def case(DRR, _):
        drr = DRR(quantum=8.0)
        drr.offer("a", ("k1", "a0"), cost=3.0)
        drr.offer("b", ("k2", "b0"), cost=2.0)
        seen = [drr.total_cost()]
        drr.take(timeout=0)
        seen.append(drr.total_cost())
        drr.extract(lambda it: it[0] == "k2")
        seen.append(drr.total_cost())
        assert seen == [5.0, 2.0, 0.0]
        return seen
    ref, port = drr_both(case)
    assert ref == port


def test_service_config_weights_reach_scheduler():
    def case(mod, pkg):
        with _service(mod, pkg, tenant_weights={"gold": 3.0},
                      default_weight=2.0) as svc:
            assert svc.scheduler.weight("gold") == 3.0
            assert svc.scheduler.weight("anyone") == 2.0
            return svc.scheduler.weight("gold"), svc.scheduler.weight("x")
    ref, port = both(case)
    assert ref == port


# -- latency-aware admission --------------------------------------------------

def test_latency_admission_rejects_on_predicted_delay():
    def case(mod, pkg):
        pkg["obs"].METRICS.reset()
        with _service(mod, pkg, max_predicted_delay_s=0.5,
                      max_queued_per_tenant=64, max_queued_total=64) as svc:
            # observed pace: 1 s per cost unit -> a 1-stage action
            # predicts (0 backlog + 1) * 1.0 = 1 s > 0.5 s bound
            svc.observe_service_rate(wall_s=1.0, cost=1.0)
            sess = svc.session("dave")
            with pytest.raises(pkg["serve"].AdmissionError) as e:
                _mare(sess, pkg, _data()).map(op=_op(pkg)).collect()
            assert e.value.scope == "latency"
            assert sess.queue_depth() == 0      # nothing was queued
        snap = pkg["obs"].METRICS.snapshot()
        assert snap["serve.latency_rejected"] == 1
        assert snap["serve.admission_rejected"] == 1
        return (str(e.value), e.value.scope, snap["serve.latency_rejected"],
                snap["serve.admission_rejected"])
    ref, port = both(case)
    assert ref == port


def test_latency_admission_cold_start_admits():
    def case(mod, pkg):
        # no completed dispatch yet -> no rate estimate -> admit even
        # under a bound nothing could meet once the estimator is warm
        with _service(mod, pkg, max_predicted_delay_s=1e-9) as svc:
            sess = svc.session("erin")
            out = _mare(sess, pkg, _data()).map(op=_op(pkg)).collect()
            assert _rows(out) == list(range(32))
            # that dispatch seeded the estimator
            assert svc.service_rate() is not None
            return _rows(out)
    ref, port = both(case)
    assert ref == port


def test_latency_admission_admits_under_fast_rate():
    def case(mod, pkg):
        with _service(mod, pkg, max_predicted_delay_s=10.0) as svc:
            svc.observe_service_rate(wall_s=0.001, cost=1.0)
            sess = svc.session("fay")
            out = _mare(sess, pkg, _data()).map(op=_op(pkg)).collect()
            assert _rows(out) == list(range(32))
            return _rows(out), svc.service_rate()
    ref, port = both(case)
    assert port[0] == ref[0]


def test_async_failure_isolated_to_its_batch():
    def case(mod, pkg):
        with _service(mod, pkg, batch_window_s=0.2) as svc:
            a, b = svc.session("alice"), svc.session("bob")
            ha = (_mare(a, pkg, _data())
                  .reduce_by_key(_bad_keys, value_by=_vals, op="sum",
                                 num_keys=2)
                  .collect(asynchronous=True))
            hb = _mare(b, pkg, _data()).map(op=_op(pkg)).collect(
                asynchronous=True)
            with pytest.raises(RuntimeError, match="overflow") as e:
                ha.result(timeout=60)
            out = hb.result(timeout=60)
            assert _rows(out) == list(range(32))
            return str(e.value), _rows(out)
    ref, port = both(case)
    assert ref == port


# -- the port's own -----------------------------------------------------------

def test_action_report_fields_match_the_reference():
    """The port's report has every field of the reference's, the batch
    fields included, plus ``device``."""
    ref = {f.name for f in dataclasses.fields(RR.ActionReport)}
    port = {f.name for f in dataclasses.fields(TR.ActionReport)}
    assert port - ref == {"device"} and ref - port == set()
    rep = TR.ActionReport(action_id=3, plan="p", total_stages=1,
                          batch_size=2, batch_leader=7)
    want = RR.ActionReport(action_id=3, plan="p", total_stages=1,
                           batch_size=2, batch_leader=7)
    assert rep.describe() == want.describe()
    assert (rep.batch_size, rep.batch_leader) == (2, 7)


def _max_key(recs):
    return recs[0] % 5


def test_max_min_merges_fold_counts_through_the_kernel(monkeypatch):
    """A max/min query folds its values by scatter; its merge's per-key
    counts are a sum and take the caller's ``use_kernel``, one launch a
    shard (the reference folds those counts by scatter).  A sum folds
    values and counts in one launch a shard at the combine and at the
    merge.  The tables equal the reference's either way."""
    calls = []
    real = tops.segment_sum

    def counting(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tops, "segment_sum", counting)
    data = (np.arange(40, dtype=np.int32),)
    # 2 shards: a max/min merge's counts; a sum's combine and merge
    for op, launches in (("max", 2), ("min", 2), ("sum", 4)):
        calls.clear()
        got = T.MaRe(data, num_shards=2, device="cpu").reduce_by_key(
            _max_key, value_by=_vals, op=op, num_keys=5,
            use_kernel=True).collect()
        want = R.MaRe(data, compat.make_mesh((1,), ("data",))
                      ).reduce_by_key(_max_key, value_by=_vals, op=op,
                                      num_keys=5).collect()
        assert len(calls) == launches
        order = np.argsort(got[0])
        worder = np.argsort(np.asarray(want[0]))
        assert got[0][order].tolist() == np.asarray(want[0])[worder].tolist()
        assert got[1][0][order].tolist() == \
            np.asarray(want[1][0])[worder].tolist()
        assert got[2][order].tolist() == np.asarray(want[2])[worder].tolist()


def _kmer_table(reads: np.ndarray, k: int) -> np.ndarray:
    """numpy's k-mer occurrence table over fixed-length ACGT reads."""
    code = np.zeros(256, np.int64)
    for i, b in enumerate(b"ACGT"):
        code[b] = i
    c = code[reads]
    nw = reads.shape[1] - k + 1
    acc = np.zeros((reads.shape[0], nw), np.int64)
    for j in range(k):
        acc = acc * 4 + c[:, j:j + nw]
    return np.bincount(acc.reshape(-1), minlength=4 ** k)


def test_service_entry_on_the_cpu(capsys):
    """``launch.serve --service --device cpu``: the reference's lines, every
    tenant's sum table equal to numpy's and to the reference's one-shot
    query on the same reads, max and min equal to the same plan run
    outside the service, identical queries coalesced."""
    from repro_torch.launch import serve
    assert serve.main(["--service", "--device", "cpu", "--tenants", "2",
                       "--rounds", "2"]) == 0
    out = capsys.readouterr().out
    assert "mean batch occupancy=" in out
    assert "tenant_budget_violations=0" in out
    args = serve.parse_args(["--service", "--device", "cpu", "--tenants",
                             "3", "--rounds", "3", "--reads", "300",
                             "--batch-window", "0.2"])
    run = serve.service_loop(args)
    reads = serve.make_reads(args.reads, args.seed)
    want = _kmer_table(reads["data"], args.k)
    ref = R.MaRe(reads, compat.make_mesh((1,), ("data",))).map(
        image="kmer-stats", k=args.k).reduce_by_key(
        serve._key_of, value_by=serve._ones_of, op="sum",
        num_keys=4 ** args.k).collect()
    ref_table = np.zeros(4 ** args.k, np.int64)
    ref_table[np.asarray(ref[0])] = np.asarray(ref[1][0])
    assert np.array_equal(ref_table, want)
    alone = {op: T.MaRe(run.shared).map(image="kmer-stats", k=args.k)
             .reduce_by_key(serve._key_of, value_by=serve._ones_of, op=op,
                            num_keys=4 ** args.k).collect()
             for op in ("max", "min")}
    assert sorted(run.results) == ["tenant0", "tenant1", "tenant2"]
    for tenant, results in run.results.items():
        assert [op for op, _ in results] == ["sum", "max", "min"]
        for op, (keys, (vals,), counts) in results:
            if op == "sum":
                table = np.zeros(4 ** args.k, np.int64)
                table[keys] = vals
                assert np.array_equal(table, want)
                assert np.array_equal(vals, counts)
            else:
                for a, b in zip((keys, vals, counts),
                                (alone[op][0], alone[op][1][0],
                                 alone[op][2])):
                    assert np.array_equal(a, b)
    # one dispatch a round when the three tenants coalesce, and never
    # more than one a query
    assert 3 <= run.dispatches <= 9
    assert run.occupancy == 9 / run.dispatches
    assert run.cache_stats["tenant_budget_violations"] == 0
    assert run.cache_stats["shared_hits"] >= 1
    assert len(run.latencies) == 9 and run.qps > 0
    for tenant, reps in run.reports.items():
        assert [r.tenant for r in reps] == [tenant] * \
            (4 if tenant == "tenant0" else 3)
        assert all(r.cached_stages == 1 for r in reps[-3:])


def test_service_entry_runs_on_cuda_unless_told(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        serve.main(["--service", "--tenants", "1", "--rounds", "1"])
