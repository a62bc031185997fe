"""The port's streaming layer (``repro_torch.stream``) against the
reference's (``repro.stream``): continuous sources, incremental keyed
aggregation, windows and live queries — and the exactness contract: the
incrementally maintained aggregate is bit-identical to a one-shot
``reduce_by_key`` over the union of all epochs, for ANY partition of the
input into epochs.

The cases named as in the reference are its ``tests/test_stream.py``
cases, all 14 (24 items, the reference's parametrizations kept as ids),
each run through both packages on the same files; tables, counters and
watermarks are compared exactly.  The port takes ``num_shards=1`` and
``device="cpu"`` where the reference takes its one-device mesh.

Files arrive atomically in both packages: each is written outside the
inbox and moved in with ``os.replace``, so no poll can list a
half-written file (the reference's own ``_drop`` writes ``name.tmp``
inside the inbox, which a poll can list before the rename).  Every wait
has a timeout.  The last cases are the port's own: eight shards, and the
superseded generation's tensors freed at once.
"""
import os
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.io as RI
import repro.runtime as RR
import repro.serve as RV
import repro.stream as RS
import repro_torch.core as T
import repro_torch.io as TI
import repro_torch.runtime as TR
import repro_torch.serve as TV
import repro_torch.stream as TS
from repro import compat

NUM_KEYS = 7


def _mesh():
    return compat.make_mesh((jax.device_count(),), ("data",))


PKGS = {
    R: dict(io=RI, rt=RR, serve=RV, stream=RS,
            cont=lambda src, **kw: RS.ContinuousSource(src, _mesh(), **kw),
            oneshot=lambda src, **kw: R.MaRe.from_source(src, _mesh(),
                                                         **kw)),
    T: dict(io=TI, rt=TR, serve=TV, stream=TS,
            cont=lambda src, **kw: TS.ContinuousSource(
                src, num_shards=1, device="cpu", **kw),
            oneshot=lambda src, **kw: T.MaRe.from_source(
                src, num_shards=1, device="cpu", **kw)),
}


def both(case):
    """case(mod, pkg) for the reference, then the port; returns both."""
    return case(R, PKGS[R]), case(T, PKGS[T])


def _inbox(tmp_path, mod, name="inbox"):
    root = tmp_path / f"{mod.__name__}-{name}"
    root.mkdir()
    return str(root)


def _drop(root, name, lines):
    """Write ``name`` beside the inbox, then move it in atomically."""
    staging = root + ".staging"
    os.makedirs(staging, exist_ok=True)
    tmp = os.path.join(staging, name)
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, os.path.join(root, name))


def _lines(rng, n):
    return ["".join(rng.choice(list("ACGT"),
                               size=int(rng.integers(4, 30))))
            for _ in range(n)]


def _i32(x):
    return x.to(torch.int32) if isinstance(x, torch.Tensor) \
        else x.astype(jnp.int32)


# module-level key_by/value_by: plan and lineage signatures key on
# callable identity, so the suffix must reuse the SAME objects every epoch
def _key7(recs):
    return _i32(recs["data"][:, 0]) % NUM_KEYS


def _len_val(recs):
    return (_i32(recs["len"]),)


def _oob_key(recs):
    return _i32(recs["len"]) + 100    # far outside NUM_KEYS


def _build_for(op):
    def build(m):
        return m.reduce_by_key(_key7, value_by=_len_val, op=op,
                               num_keys=NUM_KEYS)
    return build


def _sorted_table(out):
    keys, (vals,), counts = (np.asarray(out[0]),
                             tuple(np.asarray(v) for v in out[1]),
                             np.asarray(out[2]))
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order], counts[order]


def _assert_tables_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype            # same dtype,
        assert np.array_equal(g, w)          # same values, exactly


def _query(pkg, root, build, **kw):
    rt = pkg["rt"]
    kw.setdefault("plan_cache", (R if pkg is PKGS[R] else T).PlanCache())
    kw.setdefault("executor", rt.Executor(
        mat_cache=rt.MaterializationCache()))
    cont = pkg["cont"](pkg["io"].text_source(root), capacity=256)
    return pkg["stream"].IncrementalQuery(cont, build, **kw)


# -- exactness: any epoch partition == one-shot over the union ----------------

@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_incremental_equals_oneshot_for_any_epoch_partition(
        tmp_path, op, seed):
    def case(mod, pkg):
        rng = np.random.default_rng(seed)
        build = _build_for(op)
        root = _inbox(tmp_path, mod)
        q = _query(pkg, root, build)
        splits = []
        for epoch in range(int(rng.integers(2, 6))):
            _drop(root, f"part{epoch:03d}.txt",
                  _lines(rng, int(rng.integers(2, 14))))
            update = q.update()
            assert update is not None and update.epoch == epoch
            splits.append(update.new_splits)
        got = _sorted_table(q.collect())
        one = build(pkg["oneshot"](pkg["io"].text_source(root),
                                   capacity=1024))
        _assert_tables_equal(got, _sorted_table(one.collect()))
        assert q.epoch == q.source.watermark
        return got, splits, q.epoch
    ref, port = both(case)
    _assert_tables_equal(port[0], ref[0])
    assert port[1:] == ref[1:]


def test_incremental_zero_recompiles_after_first_epoch(tmp_path):
    def case(mod, pkg):
        rng = np.random.default_rng(7)
        pc = mod.PlanCache()
        root = _inbox(tmp_path, mod)
        q = _query(pkg, root, _build_for("sum"), plan_cache=pc)
        epochs = 5
        for epoch in range(epochs):
            _drop(root, f"e{epoch}.txt", _lines(rng, 6))
            q.update()
        stats = pc.stats()
        # ONE delta program at epoch 0, hit every epoch after; ONE fold
        # signature from epoch 1 (the first two-table fold)
        assert stats["programs"] == 1
        assert stats["hits"] == epochs - 1
        assert q.fold_engine.compiles == 1
        assert q.fold_engine.folds == epochs - 1
        return (stats["programs"], stats["hits"], q.fold_engine.compiles,
                q.fold_engine.folds)
    ref, port = both(case)
    assert ref == port


def test_key_overflow_raises_like_oneshot(tmp_path):
    def case(mod, pkg):
        rng = np.random.default_rng(3)
        root = _inbox(tmp_path, mod)
        _drop(root, "bad.txt", _lines(rng, 5))

        def build(m):
            return m.reduce_by_key(_oob_key, value_by=_len_val, op="sum",
                                   num_keys=NUM_KEYS)
        q = _query(pkg, root, build)
        with pytest.raises(RuntimeError, match="overflow") as e1:
            q.update()
        one = build(pkg["oneshot"](pkg["io"].text_source(root),
                                   capacity=256))
        with pytest.raises(RuntimeError, match="overflow") as e2:
            one.collect()
        return str(e1.value), str(e2.value)
    ref, port = both(case)
    assert ref == port


# -- continuous source --------------------------------------------------------

def test_poll_is_monotone_and_consumes_no_empty_epochs(tmp_path):
    def case(mod, pkg):
        rng = np.random.default_rng(0)
        root = _inbox(tmp_path, mod)
        cont = pkg["cont"](pkg["io"].text_source(root), capacity=64)
        assert cont.poll() is None and cont.watermark == -1
        _drop(root, "a.txt", _lines(rng, 3))
        batch = cont.poll()
        assert batch.epoch == 0 and batch.num_splits == 1
        assert cont.poll() is None           # same files -> nothing new
        _drop(root, "b.txt", _lines(rng, 3))
        _drop(root, "c.txt", _lines(rng, 3))
        batch = cont.poll()
        assert batch.epoch == 1 and batch.num_splits == 2  # one epoch, both
        assert len(cont.seen_splits()) == 3
        return ([(os.path.basename(sp.path), sp.start, sp.stop)
                 for sp in cont.seen_splits()], cont.watermark,
                batch.watermark)
    ref, port = both(case)
    assert ref == port


def test_incremental_report_carries_stream_counters(tmp_path):
    def case(mod, pkg):
        rng = np.random.default_rng(1)
        root = _inbox(tmp_path, mod)
        q = _query(pkg, root, _build_for("sum"))
        _drop(root, "a.txt", _lines(rng, 4))
        q.update()
        _drop(root, "b.txt", _lines(rng, 4))
        update = q.update()
        rep = update.report
        assert rep is not None
        assert rep.counters["stream.epoch"] == 1
        assert rep.counters["stream.watermark"] == 1
        assert rep.counters["stream.new_splits"] == 1
        assert "stream.fold" in rep.phases
        assert "[incremental @ epoch 1]" in q.describe()
        return ({k: v for k, v in rep.counters.items()
                 if k.startswith("stream.")}, q.describe().split(") ")[-1])
    ref, port = both(case)
    assert ref == port


def test_generations_are_distinct_and_old_ones_dropped(tmp_path):
    def case(mod, pkg):
        rng = np.random.default_rng(2)
        executor = pkg["rt"].Executor(
            mat_cache=pkg["rt"].MaterializationCache())
        root = _inbox(tmp_path, mod)
        q = _query(pkg, root, _build_for("sum"), executor=executor)
        seen = set()
        epochs = 4
        for epoch in range(epochs):
            _drop(root, f"e{epoch}.txt", _lines(rng, 3))
            q.update()
            lineage = q.state.lineage
            assert lineage not in seen       # (base, watermark) per gen
            seen.add(lineage)
        stats = executor.mat_cache.stats()
        # every superseded generation was explicitly invalidated
        assert stats["invalidations"] == epochs - 1
        assert executor.mat_cache.get(q.state.lineage) is not None
        return stats["invalidations"], len(seen)
    ref, port = both(case)
    assert ref == port


# -- plan-suffix validation ---------------------------------------------------

def test_plan_must_end_in_reduce_by_key(tmp_path):
    def case(mod, pkg):
        rng = np.random.default_rng(4)
        root = _inbox(tmp_path, mod)
        _drop(root, "a.txt", _lines(rng, 3))
        q = _query(pkg, root, lambda m: m)       # identity plan
        with pytest.raises(ValueError, match="reduce_by_key") as e:
            q.update()
        return str(e.value)
    ref, port = both(case)
    assert ref == port


def test_build_must_produce_the_same_plan_every_epoch(tmp_path):
    def case(mod, pkg):
        rng = np.random.default_rng(5)
        builds = [_build_for("sum"), _build_for("max")]

        def unstable(m):
            return builds.pop(0)(m)
        root = _inbox(tmp_path, mod)
        q = _query(pkg, root, unstable)
        _drop(root, "a.txt", _lines(rng, 3))
        q.update()
        _drop(root, "b.txt", _lines(rng, 3))
        with pytest.raises(ValueError, match="SAME suffix") as e:
            q.update()
        return str(e.value).split("(")[0]
    ref, port = both(case)
    assert ref == port


# -- windows ------------------------------------------------------------------

def _window_oneshot(pkg, root, build, names):
    ref_root = root + "-window-ref"
    os.makedirs(ref_root, exist_ok=True)
    for name in names:
        with open(os.path.join(root, name)) as src, \
                open(os.path.join(ref_root, name), "w") as dst:
            dst.write(src.read())
    one = build(pkg["oneshot"](pkg["io"].text_source(ref_root),
                               capacity=1024))
    return one.collect()


@pytest.mark.parametrize("size,slide", [(2, 1), (2, 2), (3, 3)])
def test_window_aggregate_covers_exactly_the_ring(tmp_path, size, slide):
    def case(mod, pkg):
        rng = np.random.default_rng(6)
        build = _build_for("sum")
        root = _inbox(tmp_path, mod)
        cont = pkg["cont"](pkg["io"].text_source(root), capacity=256)
        w = pkg["stream"].WindowedQuery(
            cont, build, size=size, slide=slide, plan_cache=mod.PlanCache(),
            executor=pkg["rt"].Executor(
                mat_cache=pkg["rt"].MaterializationCache()))
        epochs = 6
        names = []
        for epoch in range(epochs):
            name = f"e{epoch}.txt"
            names.append(name)
            _drop(root, name, _lines(rng, 5))
            w.update()
        # the last emission happened at the newest slide boundary; its
        # window is the `size` epochs ending there
        last_emit = (epochs // slide) * slide - 1
        covered = names[max(0, last_emit - size + 1):last_emit + 1]
        got = _sorted_table(w.collect())
        _assert_tables_equal(got, _sorted_table(
            _window_oneshot(pkg, root, build, covered)))
        assert w.window_epochs == tuple(
            range(max(0, epochs - size), epochs))
        assert w.evicted == epochs - size
        return got, w.window_epochs, w.evicted, w.describe().split(", ")[0]
    ref, port = both(case)
    _assert_tables_equal(port[0], ref[0])
    assert port[1:3] == ref[1:3]


def test_window_eviction_invalidates_cache_entries(tmp_path):
    def case(mod, pkg):
        rng = np.random.default_rng(8)
        executor = pkg["rt"].Executor(
            mat_cache=pkg["rt"].MaterializationCache())
        root = _inbox(tmp_path, mod)
        cont = pkg["cont"](pkg["io"].text_source(root), capacity=128)
        w = pkg["stream"].WindowedQuery(cont, _build_for("sum"), size=2,
                                        slide=1, plan_cache=mod.PlanCache(),
                                        executor=executor)
        for epoch in range(4):
            _drop(root, f"e{epoch}.txt", _lines(rng, 3))
            w.update()
        # 2 expired per-epoch partials + superseded window generations
        stats = executor.mat_cache.stats()
        assert stats["invalidations"] >= 2
        assert w.evicted == 2
        return stats["invalidations"], w.evicted
    ref, port = both(case)
    assert ref == port


def test_window_validates_size_and_slide(tmp_path):
    def case(mod, pkg):
        root = _inbox(tmp_path, mod)
        cont = pkg["cont"](pkg["io"].text_source(root))
        WQ = pkg["stream"].WindowedQuery
        with pytest.raises(ValueError, match="size") as e1:
            WQ(cont, _build_for("sum"), size=0)
        with pytest.raises(ValueError, match="slide") as e2:
            WQ(cont, _build_for("sum"), size=2, slide=3)
        t = WQ.tumbling(cont, _build_for("sum"), size=3)
        assert t.slide == t.size == 3
        return str(e1.value), str(e2.value), t.slide
    ref, port = both(case)
    assert ref == port


# -- sessions + live queries --------------------------------------------------

def _service(mod, pkg):
    rt = pkg["rt"]
    return pkg["serve"].QueryService(
        executor=rt.Executor(plan_cache=mod.PlanCache(),
                             mat_cache=rt.MaterializationCache()),
        config=pkg["serve"].ServiceConfig(batch_window_s=0.0))


def test_session_stream_routes_reports_through_session(tmp_path):
    def case(mod, pkg):
        rng = np.random.default_rng(9)
        root = _inbox(tmp_path, mod)
        with _service(mod, pkg) as svc:
            sess = svc.session("alice")
            cont = pkg["cont"](pkg["io"].text_source(root), capacity=128)
            q = sess.stream(cont, _build_for("sum"))
            _drop(root, "a.txt", _lines(rng, 4))
            update = q.update()
            assert update is not None
            assert sess.reports.appended == 1
            rep = sess.report()
            assert rep.tenant == "alice"
            assert rep.counters["stream.epoch"] == 0
            assert rep.label.startswith("alice/stream")
            with pytest.raises(TypeError, match="reports") as e:
                sess.stream(cont, _build_for("sum"), reports=sess.reports)
            return (rep.tenant, rep.label, rep.batch_size,
                    rep.counters["stream.epoch"], str(e.value),
                    _sorted_table(q.collect()))
    ref, port = both(case)
    assert port[:5] == ref[:5]
    _assert_tables_equal(port[5], ref[5])


def test_live_query_drives_follow_loop(tmp_path):
    def case(mod, pkg):
        rng = np.random.default_rng(10)
        root = _inbox(tmp_path, mod)
        with _service(mod, pkg) as svc:
            sess = svc.session("alice")
            cont = pkg["cont"](pkg["io"].text_source(root), capacity=128)
            q = sess.stream(cont, _build_for("sum"))
            refreshed = threading.Event()
            with pkg["stream"].LiveQuery(
                    q, interval_s=0.05,
                    on_refresh=lambda _u: refreshed.set()) as live:
                _drop(root, "a.txt", _lines(rng, 4))
                reports = sess.follow(0, timeout=30.0)   # wakes per refresh
                assert reports and reports[0].tenant == "alice"
                assert refreshed.wait(timeout=30.0)
                assert live.running
            assert not live.running
            assert live.refreshes >= 1
            assert live.latest is not None and live.latest.epoch == 0
            return (reports[0].tenant, reports[0].counters["stream.epoch"],
                    live.refreshes, live.latest.epoch,
                    _sorted_table(q.collect()))
    ref, port = both(case)
    assert port[:4] == ref[:4] == ("alice", 0, 1, 0)
    _assert_tables_equal(port[4], ref[4])


def test_live_query_surfaces_refresh_errors_on_stop(tmp_path):
    def case(mod, pkg):
        rng = np.random.default_rng(11)
        root = _inbox(tmp_path, mod)
        _drop(root, "bad.txt", _lines(rng, 3))

        def build(m):
            return m.reduce_by_key(_oob_key, value_by=_len_val, op="sum",
                                   num_keys=NUM_KEYS)
        q = _query(pkg, root, build)
        live = pkg["stream"].LiveQuery(q, interval_s=0.05).start()
        deadline = 30.0
        while live.error is None and deadline > 0:
            threading.Event().wait(0.05)
            deadline -= 0.05
        with pytest.raises(RuntimeError, match="overflow") as e:
            live.stop()
        assert not live.running
        return str(e.value)
    ref, port = both(case)
    assert ref == port


# -- the port's own -----------------------------------------------------------

def test_incremental_equals_oneshot_over_eight_shards(tmp_path):
    """Eight shards, as on the card: each epoch's files land on several
    shards, every fold merges eight shard pairs, and the table equals the
    one-shot action's over the union (and the reference's)."""
    rng = np.random.default_rng(12)
    root = _inbox(tmp_path, T)
    pc = T.PlanCache()
    cont = TS.ContinuousSource(TI.text_source(root), num_shards=8,
                               device="cpu", capacity=64)
    q = TS.IncrementalQuery(cont, _build_for("sum"), plan_cache=pc,
                            executor=TR.Executor(
                                mat_cache=TR.MaterializationCache()))
    for epoch in range(4):
        for j in range(3):                   # three files an epoch
            _drop(root, f"e{epoch}-{j}.txt", _lines(rng, 9))
        assert q.update().new_splits == 3
    got = _sorted_table(q.collect())
    one = _build_for("sum")(T.MaRe.from_source(
        TI.text_source(root), num_shards=8, device="cpu", capacity=256))
    _assert_tables_equal(got, _sorted_table(one.collect()))
    ref = _build_for("sum")(R.MaRe.from_source(
        RI.text_source(root), _mesh(), capacity=1024))
    _assert_tables_equal(got, _sorted_table(ref.collect()))
    assert q.fold_engine.compiles == 1 and q.fold_engine.folds == 3
    assert pc.stats()["programs"] == 1


def test_superseded_generation_is_freed_at_once(tmp_path):
    """Installing a new generation drops the old one from the cache and
    from the query; nothing else holds it, so its tensors are freed by
    reference counting, without the cyclic collector."""
    rng = np.random.default_rng(13)
    root = _inbox(tmp_path, T)
    executor = TR.Executor(mat_cache=TR.MaterializationCache())
    q = _query(PKGS[T], root, _build_for("sum"), executor=executor)
    _drop(root, "e0.txt", _lines(rng, 5))
    q.update()
    refs = [weakref.ref(t) for t in
            [q.state.counts, *[leaf for leaf in
                               TS.incremental.tree.leaves(q.state.records)]]]
    assert all(r() is not None for r in refs)
    _drop(root, "e1.txt", _lines(rng, 5))
    q.update()
    assert all(r() is None for r in refs), "old generation still alive"
    assert len(executor.mat_cache) == 1


def test_device_tier_default_is_a_share_of_the_card(monkeypatch):
    """The reference's 1 GiB device tier without CUDA; with it, a quarter
    of the current card's memory, resolved at first use, so a stream's
    generations stay on the card.  An explicit budget is kept."""
    assert TR.MaterializationCache()._device_budget() == \
        RR.DEVICE_BUDGET_DEFAULT == TR.DEVICE_BUDGET_DEFAULT

    class Props:
        total_memory = 80 << 30

    cache = TR.MaterializationCache()
    explicit = TR.MaterializationCache(device_budget_bytes=123)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: Props)
    assert TR.default_device_budget() == 20 << 30
    assert cache.device_budget_bytes == "auto"
    assert cache._device_budget() == cache.device_budget_bytes == 20 << 30
    assert explicit._device_budget() == 123
    assert TR.MaterializationCache(
        device_budget_bytes=None)._device_budget() is None
