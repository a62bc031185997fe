"""The port's lazy stage planner against the reference: laziness and
fusion, the plan cache, shuffle-overflow accounting, keyed aggregation
and plan structure (``repro_torch.core.{plan,planner,shuffle}``), at one
shard in this process.

The cases are the reference's ``tests/test_planner.py``, each run through
both packages on the same inputs: what it pins holds for both, and the
outputs (records, cache statistics, counters, ``describe()`` strings,
error messages) are equal.  One difference is by design and pinned as
such: the reference counts an op's *traces* (``jit`` runs its Python
once per compiled program), the port calls the op on every execution
(eager PyTorch has no trace); ROADMAP Queue 3 lists it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.core as R
import repro_torch.core as T
from repro import compat
from repro.core import planner as r_planner
from repro.core.container import ContainerOp as RContainerOp
from repro.core.shuffle import keyed_bucket_capacities as r_capacities
from repro_torch.core import planner as t_planner
from repro_torch.core.container import ContainerOp as TContainerOp
from repro_torch.core.shuffle import keyed_bucket_capacities as t_capacities

PKGS = {
    R: dict(op=RContainerOp, planner=r_planner, capacities=r_capacities,
            zeros_like=jnp.zeros_like, arr=jnp.asarray, kw={},
            from_host=lambda data, **kw: R.from_host(
                data, compat.make_mesh((1,), ("data",)), **kw)),
    T: dict(op=TContainerOp, planner=t_planner, capacities=t_capacities,
            zeros_like=torch.zeros_like, arr=torch.as_tensor,
            kw={"device": "cpu"},
            from_host=lambda data, **kw: T.from_host(data, 1, "cpu", **kw)),
}


def both(case):
    """case(mod, pkg) for the reference, then the port; returns both."""
    return case(R, PKGS[R]), case(T, PKGS[T])


def mare(mod, pkg, data, **kw):
    return mod.MaRe(data, **pkg["kw"], **kw)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(
        tree, is_leaf=torch.is_tensor)]


def same_leaves(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype, (x.dtype, y.dtype)
        np.testing.assert_array_equal(y, x)


def message(exc, fn):
    with pytest.raises(exc) as e:
        fn()
    return str(e.value)


def _counting_op(pkg, name="trace/counter"):
    """An op whose fn counts its calls: the reference's traces, the port's
    executions."""
    calls = {"n": 0}

    def fn(part, **kw):
        calls["n"] += 1
        return part

    return pkg["op"](image=name, fn=fn), calls


def _key_mod5(recs):
    return recs[0] % 5


# -- laziness & fusion --------------------------------------------------------

def test_chain_is_lazy_until_action():
    def case(mod, pkg):
        op, calls = _counting_op(pkg)
        m = (mare(mod, pkg, (np.arange(32, dtype=np.int32),),
                  plan_cache=mod.PlanCache())
             .map(op=op).repartition_by(_key_mod5).map(op=op))
        assert calls["n"] == 0                 # nothing ran yet
        assert [type(s).__name__ for s in m.plan.stages] == [
            "MapStage", "ShuffleStage", "MapStage"]
        got = m.collect()
        assert sorted(leaves(got)[0].tolist()) == list(range(32))
        return calls["n"], got
    (ref_calls, ref), (port_calls, port) = both(case)
    assert ref_calls == port_calls == 2        # the op appears twice
    same_leaves(ref, port)


def test_whole_chain_compiles_one_program():
    def case(mod, pkg):
        cache = mod.PlanCache()
        scores = np.random.default_rng(0).normal(size=64).astype(np.float32)
        ids = np.arange(64, dtype=np.int32)
        m = (mare(mod, pkg, (scores, ids), plan_cache=cache)
             .map(image="toolbox/concat")
             .repartition_by(lambda recs: recs[1] % 3)
             .reduce(image="toolbox/topk", k=8))
        out = m.collect(shard=0)
        assert set(leaves(out)[1].tolist()) == set(
            np.argsort(-scores)[:8].tolist())
        return cache.stats(), out
    (ref_stats, ref), (port_stats, port) = both(case)
    assert ref_stats == port_stats == {"programs": 1, "hits": 0,
                                       "misses": 1}
    same_leaves(ref, port)


def test_fused_equals_stage_at_a_time():
    def case(mod, pkg):
        def run(fuse):
            cache = mod.PlanCache()
            m = (mare(mod, pkg, (np.arange(48, dtype=np.int32),),
                      plan_cache=cache, fuse=fuse)
                 .map(image="toolbox/concat")
                 .repartition_by(_key_mod5)
                 .reduce(image="toolbox/sum"))
            return m.collect(shard=0), cache.stats()["misses"]
        (fused, fused_misses), (eager, eager_misses) = run(True), run(False)
        same_leaves(fused, eager)
        return fused_misses, eager_misses, fused
    ref, port = both(case)
    assert ref[:2] == port[:2] == (1, 3)       # one program per stage
    same_leaves(ref[2], port[2])


# -- compile cache ------------------------------------------------------------

def test_compile_cache_hits_on_identical_pipeline():
    def case(mod, pkg):
        cache = mod.PlanCache()
        op, calls = _counting_op(pkg)
        data = (np.arange(16, dtype=np.int32),)

        def build():
            return (mare(mod, pkg, data, plan_cache=cache)
                    .map(op=op).repartition_by(_key_mod5))

        build().collect()
        first = (cache.stats(), calls["n"])
        build().collect()                      # fresh MaRe, same pipeline
        second = (cache.stats(), calls["n"])
        # the same program object for the same key
        ds = pkg["from_host"](data)
        plan = build().plan
        p1 = pkg["planner"].compile_plan(plan, ds, cache)
        assert pkg["planner"].compile_plan(plan, ds, cache) is p1
        return first, second
    ref, port = both(case)
    assert ref[0][0] == port[0][0] == {"programs": 1, "hits": 0,
                                       "misses": 1}
    assert ref[1][0] == port[1][0] == {"programs": 1, "hits": 1,
                                       "misses": 1}
    # the reference re-uses its trace; the port runs the op again
    assert ref[0][1] == ref[1][1] == 1
    assert (port[0][1], port[1][1]) == (1, 2)


def test_numpy_params_key_on_content_not_identity():
    """Array params are baked into the program, so the cache keys them by
    content: equal arrays share a program, and mutating one in place
    misses the cache instead of serving stale constants."""
    def case(mod, pkg):
        cache = mod.PlanCache()
        table = np.full((4,), 10, np.int32)

        def add_table(part, table=None, **kw):
            return mod.make_partition(
                (part.records[0] + pkg["arr"](table)[0],), part.count)

        def run():
            op = pkg["op"](image="t/add", fn=add_table,
                           params={"table": table})
            m = mare(mod, pkg, (np.zeros(8, np.int32),),
                     plan_cache=cache).map(op=op)
            return int(leaves(m.collect())[0][0])

        out = [run(), run()]
        stats = dict(cache.stats())
        table += 90                            # in-place mutation
        out.append(run())
        return out, stats, cache.stats()["misses"]
    ref, port = both(case)
    assert ref == port
    assert port[0] == [10, 10, 100]
    assert port[1]["misses"] == 1 and port[1]["hits"] == 1 and port[2] == 2


def test_compile_cache_misses_on_shape_or_structure_change():
    def case(mod, pkg):
        cache = mod.PlanCache()
        op, _ = _counting_op(pkg)

        def run(n, twice):
            m = mare(mod, pkg, (np.arange(n, dtype=np.int32),),
                     plan_cache=cache).map(op=op)
            if twice:
                m = m.map(op=op)
            m.collect()

        run(16, False)
        run(32, False)                         # shape change
        run(16, True)                          # structure change
        return cache.stats()["misses"]
    assert both(case) == (3, 3)


# -- shuffle overflow ---------------------------------------------------------

def test_shuffle_partition_dropped_accounting():
    """All records hash to one destination; capacity caps what arrives and
    the remainder is counted, never silently lost."""
    mesh = compat.make_mesh((1,), ("data",))

    def interior(records, counts):
        part = R.make_partition(records, counts[0])
        keys = jnp.zeros((part.capacity,), jnp.int32)
        res = R.shuffle_partition(part, keys, axis_name="data", axis_size=1,
                                  capacity=3)
        return res.part.records, res.part.count[None], res.dropped[None]

    fn = jax.jit(compat.shard_map(
        interior, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data"))))
    ref_records, ref_counts, ref_dropped = fn(
        (jnp.arange(10, dtype=jnp.int32),), jnp.asarray([10], jnp.int32))

    part = T.make_partition((torch.arange(10, dtype=torch.int32),), 10)
    (res,) = T.shuffle_partition([part], [torch.zeros(10, dtype=torch.int32)],
                                 capacity=3)
    assert int(res.dropped) == int(ref_dropped[0]) == 7   # 10 sent, 3 fit
    assert int(res.part.count) == int(ref_counts[0]) == 3
    # survivors are a prefix of the stable destination order
    assert res.part.records[0][:3].tolist() == \
        ref_records[0][:3].tolist() == [0, 1, 2]


def test_repartition_overflow_raises_at_action():
    def case(mod, pkg):
        m = (mare(mod, pkg, (np.arange(4, dtype=np.int32),),
                  plan_cache=mod.PlanCache())
             .repartition_by(lambda recs: pkg["zeros_like"](recs[0]),
                             capacity=1))
        return message(RuntimeError, m.collect)
    ref, port = both(case)
    assert "overflow" in port and ref == port


def test_lossless_shuffle_never_raises():
    def case(mod, pkg):
        m = (mare(mod, pkg, (np.arange(12, dtype=np.int32),),
                  plan_cache=mod.PlanCache())
             .repartition_by(lambda recs: pkg["zeros_like"](recs[0])))
        got = m.collect()
        assert sorted(leaves(got)[0].tolist()) == list(range(12))
        return got
    same_leaves(*both(case))


# -- keyed aggregation (reduce_by_key) ---------------------------------------

def _kv_data(n=64, num_keys=8, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, num_keys, size=n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    return keys, vals


def _key_first(recs):
    return recs[0]


def _val_second(recs):
    return (recs[1],)


def _expected_groupby(keys, vals):
    return {int(k): (float(vals[keys == k].sum()), int((keys == k).sum()))
            for k in np.unique(keys)}


def _keyed(mod, pkg, data, num_keys=8, cache=None, **kw):
    cache = cache if cache is not None else mod.PlanCache()
    return mare(mod, pkg, data, plan_cache=cache).reduce_by_key(
        _key_first, value_by=_val_second, op="sum", num_keys=num_keys, **kw)


def _close_tables(ref, port, atol=1e-5):
    """Keys and counts equal, float sums within ``atol`` (the port's
    segment sums add in another order)."""
    (rk, (rs,), rc), (pk, (ps,), pc) = ref, port
    np.testing.assert_array_equal(np.asarray(pk), np.asarray(rk))
    np.testing.assert_array_equal(np.asarray(pc), np.asarray(rc))
    np.testing.assert_allclose(np.asarray(ps), np.asarray(rs), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("combiner", [True, False])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_reduce_by_key_matches_groupby(combiner, use_kernel):
    keys, vals = _kv_data()

    def case(mod, pkg):
        out = _keyed(mod, pkg, (keys, vals), combiner=combiner,
                     use_kernel=use_kernel).collect()
        out_keys, (out_sum,), out_cnt = out
        got = {int(k): (float(s), int(c))
               for k, s, c in zip(out_keys, out_sum, out_cnt)}
        exp = _expected_groupby(keys, vals)
        assert set(got) == set(exp)
        for k, (s, c) in exp.items():
            assert got[k][1] == c and abs(got[k][0] - s) < 1e-4
        return out
    _close_tables(*both(case))


def test_reduce_by_key_combiner_shrinks_exchange():
    keys, vals = _kv_data(n=256, num_keys=4)

    def case(mod, pkg):
        on = _keyed(mod, pkg, (keys, vals), num_keys=4, combiner=True)
        on.collect()
        off = _keyed(mod, pkg, (keys, vals), num_keys=4, combiner=False)
        off.collect()
        return on.report().diagnostics, off.report().diagnostics
    ref, port = both(case)
    assert ref == port
    on, off = port
    assert off["stage0.exchanged_records"] == 256
    assert on["stage0.exchanged_records"] <= 4
    assert on["stage0.key_overflow"] == 0


def test_reduce_by_key_is_lazy_and_fuses_to_one_program():
    keys, vals = _kv_data()

    def case(mod, pkg):
        cache = mod.PlanCache()
        m = (mare(mod, pkg, (keys, vals), plan_cache=cache)
             .map(image="toolbox/concat")
             .reduce_by_key(_key_first, value_by=_val_second, op="sum",
                            num_keys=8))
        assert [type(s).__name__ for s in m.plan.stages] == [
            "MapStage", "KeyedReduceStage"]
        assert cache.stats()["misses"] == 0
        m.collect()
        return cache.stats()
    assert both(case) == ({"programs": 1, "hits": 0, "misses": 1},) * 2


def test_reduce_by_key_cache_hit_on_rerun():
    keys, vals = _kv_data()

    def case(mod, pkg):
        cache = mod.PlanCache()
        _keyed(mod, pkg, (keys, vals), cache=cache).collect()
        _keyed(mod, pkg, (keys, vals), cache=cache).collect()
        return cache.stats()
    assert both(case) == ({"programs": 1, "hits": 1, "misses": 1},) * 2


def test_reduce_by_key_max_monoid():
    keys, vals = _kv_data()

    def case(mod, pkg):
        out = mare(mod, pkg, (keys, vals), plan_cache=mod.PlanCache()
                   ).reduce_by_key(_key_first, value_by=_val_second,
                                   op="max", num_keys=8).collect()
        out_keys, (out_max,), _ = out
        for k, v in zip(out_keys, out_max):
            assert abs(float(v) - float(vals[keys == int(k)].max())) < 1e-6
        return out
    same_leaves(*both(case))


def test_reduce_by_key_single_distinct_key():
    vals = np.arange(16, dtype=np.float32)
    keys = np.full(16, 3, np.int32)

    def case(mod, pkg):
        out = _keyed(mod, pkg, (keys, vals), num_keys=8).collect()
        out_keys, (out_sum,), out_cnt = out
        assert out_keys.tolist() == [3] and out_cnt.tolist() == [16]
        assert float(out_sum[0]) == float(vals.sum())
        return out
    same_leaves(*both(case))


def test_reduce_by_key_empty_partitions():
    def case(mod, pkg):
        ds = pkg["from_host"]((np.zeros(0, np.int32),
                               np.zeros(0, np.float32)), capacity=8)
        out = mod.MaRe(ds).reduce_by_key(
            _key_first, value_by=_val_second, op="sum", num_keys=8).collect()
        out_keys, _, out_cnt = out
        assert out_keys.shape[0] == 0 and out_cnt.shape[0] == 0
        return out
    same_leaves(*both(case))


def test_reduce_by_key_all_records_masked_out():
    keys, vals = _kv_data(n=16)

    def case(mod, pkg):
        ds = pkg["from_host"]((keys, vals))
        ds = dataclasses.replace(ds, counts=ds.counts * 0)
        m = mod.MaRe(ds).reduce_by_key(_key_first, value_by=_val_second,
                                       op="sum", num_keys=8)
        out = m.collect()
        assert out[0].shape[0] == 0
        assert m.report().diagnostics["stage0.key_overflow"] == 0
        return out
    same_leaves(*both(case))


@pytest.mark.parametrize("combiner", [True, False])
def test_reduce_by_key_overflow_raises_at_action_not_trace(combiner):
    keys = np.array([0, 1, 200, 300], np.int32)
    vals = np.ones(4, np.float32)

    def case(mod, pkg):
        m = _keyed(mod, pkg, (keys, vals), num_keys=4, combiner=combiner)
        d = m.describe()                       # building must not raise
        assert "reduce_by_key[sum, keys=4" in d
        return d, message(RuntimeError, m.collect)
    ref, port = both(case)
    assert "key-table overflow" in port[1] and ref == port


def test_reduce_by_key_monoid_validation_and_image_spelling():
    keys, vals = _kv_data()

    def case(mod, pkg):
        errs = (message(ValueError, lambda: mare(mod, pkg, (keys, vals))
                        .reduce_by_key(_key_first, op="mean", num_keys=8)),
                message(ValueError, lambda: mare(mod, pkg, (keys, vals))
                        .reduce_by_key(_key_first, image="toolbox/topk",
                                       num_keys=8)))
        m = mare(mod, pkg, (keys, vals), plan_cache=mod.PlanCache()
                 ).reduce_by_key(_key_first, value_by=_val_second,
                                 image="ubuntu", command="awk-sum",
                                 num_keys=8)
        assert m.plan.stages[-1].op == "sum"
        out = m.collect()
        exp = _expected_groupby(keys, vals)
        for k, s in zip(out[0], out[1][0]):
            assert abs(float(s) - exp[int(k)][0]) < 1e-4
        return errs, out
    ref, port = both(case)
    assert "unknown reduce_by_key op" in port[0][0]
    assert "not a known keyed-reduce monoid" in port[0][1]
    assert ref[0] == port[0]
    _close_tables(ref[1], port[1])


def _as_uint32(t):
    """The port's hash (int64 holding uint32 values) as the reference's
    uint32 values."""
    return t.numpy().astype(np.uint32)


def test_keyed_bucket_capacity_matches_device_hash():
    num_keys, n = 97, 4
    for mod, pkg, hashed in (
            (R, PKGS[R], lambda k: np.asarray(R.hash_keys(jnp.asarray(k)))),
            (T, PKGS[T], lambda k: _as_uint32(T.hash_keys(torch.from_numpy(k))))):
        caps = np.zeros(n, np.int64)
        dest = hashed(np.arange(num_keys, dtype=np.int32)) % n
        np.add.at(caps, dest.astype(np.int64), 1)
        assert mod.keyed_bucket_capacity(num_keys, n) == int(caps.max())
    assert R.keyed_bucket_capacity(num_keys, n) == \
        T.keyed_bucket_capacity(num_keys, n)


def test_keyed_bucket_capacities_partition_the_key_space():
    def case(mod, pkg):
        caps = pkg["capacities"](1000, 8)
        assert caps.shape == (8,) and int(caps.sum()) == 1000
        assert int(caps.max()) == mod.keyed_bucket_capacity(1000, 8)
        return caps.tolist()
    ref, port = both(case)
    assert ref == port


# -- hot-key skew: the salted two-hop exchange --------------------------------

def _hot_key_data(n=2048, num_keys=32, hot=7, frac=0.9):
    rng = np.random.default_rng(5)
    keys = np.where(rng.random(n) < frac, hot,
                    rng.integers(0, num_keys, n)).astype(np.int32)
    vals = rng.integers(0, 10, n).astype(np.int32)
    return keys, vals


def test_reduce_by_key_salted_hot_key_matches_groupby():
    keys, vals = _hot_key_data()

    def case(mod, pkg):
        sal = _keyed(mod, pkg, (keys, vals), num_keys=32, combiner=False,
                     salt=8)
        out = sal.collect()
        got = {int(k): (int(s), int(c))
               for k, s, c in zip(out[0], out[1][0], out[2])}
        assert got == {int(k): (int(vals[keys == k].sum()),
                                int((keys == k).sum()))
                       for k in np.unique(keys)}
        d = sal.report().diagnostics
        assert d["stage0.shuffle_dropped"] == d["stage0.key_overflow"] == 0
        return out
    same_leaves(*both(case))


def test_salted_diagnostics_present_and_lossless():
    keys, vals = _hot_key_data()

    def case(mod, pkg):
        sal = _keyed(mod, pkg, (keys, vals), num_keys=32, combiner=False,
                     salt=8)
        sal.collect()
        return sal.report().diagnostics
    ref, port = both(case)
    assert ref == port
    assert port["stage0.shuffle_dropped"] == 0
    assert 0 < port["stage0.max_send_count"] <= len(keys)
    assert port["stage0.exchange_buffer_rows"] > 0


def test_salt_validation():
    keys, vals = _kv_data()

    def case(mod, pkg):
        return (message(ValueError,
                        lambda: _keyed(mod, pkg, (keys, vals), salt=0)),
                message(ValueError, lambda: _keyed(
                    mod, pkg, (keys, vals), combiner=True, salt=4)))
    ref, port = both(case)
    assert "salt must be >= 1" in port[0]
    assert "requires combiner=False" in port[1]
    assert ref == port


# -- plan structure & describe ------------------------------------------------

def test_plan_builder_fuses_adjacent_maps():
    def case(mod, pkg):
        op, _ = _counting_op(pkg)
        p = mod.Plan().then(op).then(op).then_shuffle(_key_mod5).then(op)
        return ([type(s).__name__ for s in p.stages], len(p.stages[0].ops),
                len(p.ops), p.num_shuffles)
    ref, port = both(case)
    assert ref == port == (["MapStage", "ShuffleStage", "MapStage"], 2, 3, 1)


def test_describe_shows_stage_dag():
    def case(mod, pkg):
        return (mare(mod, pkg, (np.arange(8, dtype=np.int32),),
                     plan_cache=mod.PlanCache())
                .map(image="toolbox/concat")
                .repartition_by(_key_mod5)
                .reduce(image="toolbox/sum", depth=1)).describe()
    ref, port = both(case)
    assert "map[toolbox/concat:latest]" in port and "shuffle" in port
    assert "reduce[toolbox/sum:latest, depth=1]" in port
    assert ref == port


def test_describe_shows_keyed_stage_and_counter_specs():
    def case(mod, pkg):
        m = (mare(mod, pkg, (np.arange(8, dtype=np.int32),),
                  plan_cache=mod.PlanCache())
             .repartition_by(_key_mod5)
             .reduce_by_key(_key_first, op="sum", num_keys=5))
        return m.describe(), m.plan.counter_specs()
    ref, port = both(case)
    assert "reduce_by_key[sum, keys=5, combiner=on]" in port[0]
    assert port[1] == ((0, "shuffle_dropped"), (1, "key_overflow"),
                       (1, "shuffle_dropped"), (1, "exchanged_records"),
                       (1, "max_send_count"), (1, "exchange_buffer_rows"))
    assert ref == port


def test_dataset_property_materializes_pending_plan():
    def case(mod, pkg):
        op, calls = _counting_op(pkg)
        m = mare(mod, pkg, (np.arange(8, dtype=np.int32),),
                 plan_cache=mod.PlanCache()).map(op=op)
        assert calls["n"] == 0
        ds = m.dataset                         # an action: runs the plan
        assert calls["n"] == 1 and m.plan.empty
        return ds.num_shards
    assert both(case) == (1, 1)
