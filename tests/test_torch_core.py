"""The reference's core and property cases (``tests/test_core.py``,
``tests/test_property.py``) through both packages on the same numpy
inputs: the MaRe API's semantics on one shard, mount validation, the
registry, ``split_factors``, the top-k image's mask, and the hypothesis
invariants of the hash exchange's pack step and of the reduce's tree
depth, and the tree reduce's byte model.  Integer results must match
bit for bit; the port runs on the CPU.  (The int8 codec's twin is in
``tests/test_torch_optim.py``.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as R
import repro_torch.core as T
from repro import compat
from repro.core.container import make_partition as R_make_partition
from repro.core.shuffle import _pack_by_dest as R_pack_by_dest
from repro.core.shuffle import hash_keys as R_hash_keys
from repro.core.shuffle import unpack_gather as R_unpack_gather
from repro.core.tree_reduce import \
    collective_bytes_tree as R_collective_bytes_tree
from repro_torch.core.container import make_partition as T_make_partition
from repro_torch.core.shuffle import _pack_by_dest as T_pack_by_dest
from repro_torch.core.shuffle import hash_keys as T_hash_keys
from repro_torch.core.shuffle import unpack_gather as T_unpack_gather
from repro_torch.core.tree_reduce import \
    collective_bytes_tree as T_collective_bytes_tree

SETTINGS = dict(max_examples=30, deadline=None)


def _mare(mod, data):
    return mod.MaRe(data) if mod is R else mod.MaRe(data, device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- tests/test_core.py -------------------------------------------------------

def _gc(mod, dna):
    return (_mare(mod, (dna,))
            .map(input_mount=mod.TextFile("/dna"),
                 output_mount=mod.TextFile("/count"),
                 image="ubuntu", command="grep-count 2 3")
            .reduce(input_mount=mod.TextFile("/counts"),
                    output_mount=mod.TextFile("/sum"),
                    image="ubuntu", command="awk-sum"))


def test_gc_count_single_device_twin():
    rng = np.random.default_rng(0)
    dna = rng.integers(0, 4, size=333).astype(np.int32)
    true_gc = int(np.sum((dna == 2) | (dna == 3)))
    got = [int(_gc(mod, dna).collect(shard=0)[0][0]) for mod in (R, T)]
    assert got == [true_gc, true_gc]


def test_map_is_lazy_and_fused_twin():
    for mod in (R, T):
        m = _mare(mod, (np.arange(10, dtype=np.int32),))
        m2 = m.map(image="toolbox/concat").map(image="toolbox/concat")
        assert len(m2.plan.ops) == 2      # fused into one pending stage
        assert sorted(_np(m2.collect()[0]).tolist()) == list(range(10))


def test_reduce_requires_assoc_commutative_twin():
    def not_ac(part, **kw):
        return part

    for mod in (R, T):
        op = mod.ContainerOp(image="bad", fn=not_ac)
        with pytest.raises(ValueError, match="associative"):
            _mare(mod, (np.arange(4, dtype=np.int32),)).reduce(op=op)


def test_dataset_roundtrip_uneven_twin():
    data = (np.arange(7, dtype=np.int32),
            np.arange(14, dtype=np.float32).reshape(7, 2))
    ref = R.collect(R.from_host(data, compat.make_mesh((1,), ("data",))))
    port = T.collect(T.from_host(data, num_shards=1, device="cpu"))
    for r, p, want in zip(ref, port, data):
        np.testing.assert_array_equal(np.asarray(r), want)
        np.testing.assert_array_equal(_np(p), want)
        assert _np(p).dtype == np.asarray(r).dtype


@pytest.mark.parametrize("mod", [R, T], ids=["reference", "port"])
def test_mount_validation_twin(mod):
    xp = jnp if mod is R else torch
    rm = mod.RecordMount("/x", dtype=xp.int32)
    rm.validate((xp.zeros((3,), dtype=xp.int32),))
    with pytest.raises(ValueError, match="dtype"):
        rm.validate((xp.zeros((3,), dtype=xp.float32),))
    fm = mod.FileSetMount("/y", keys=("a",))
    fm.validate({"a": xp.zeros((2,))})
    with pytest.raises(ValueError, match="missing"):
        fm.validate({"b": xp.zeros((2,))})
    with pytest.raises(ValueError, match="dict"):
        fm.validate((xp.zeros((2,)),))


def test_registry_pull_unknown_twin():
    for mod in (R, T):
        with pytest.raises(KeyError, match="not found"):
            mod.pull("no/such/image")


def test_split_factors_twin():
    assert T.split_factors(16, 2) == R.split_factors(16, 2) == [4, 4]
    assert T.split_factors(16, 4) == [2, 2, 2, 2]
    assert T.split_factors(8, 2) == [2, 4]
    assert T.split_factors(1, 2) == [1, 1]
    for n in (2, 6, 12, 16, 64, 256):
        for k in (1, 2, 3):
            f = T.split_factors(n, k)
            assert f == R.split_factors(n, k)
            assert len(f) == k and int(np.prod(f)) == n


def test_collective_bytes_tree_monotone_twin():
    """Deeper trees never ship more bytes per level-sum than depth 1 (the
    paper's motivation for K > 1 when partitions are large), and both
    packages count the same bytes."""
    b1 = T_collective_bytes_tree(1000, 16, depth=1)
    b2 = T_collective_bytes_tree(1000, 16, depth=2)
    assert b2 <= b1
    for n, axis, depth in ((1000, 16, 1), (1000, 16, 2), (4096, 8, 3),
                           (7, 1, 2)):
        assert T_collective_bytes_tree(n, axis, depth=depth) == \
            R_collective_bytes_tree(n, axis, depth=depth)


def test_topk_image_masks_invalid_twin():
    scores, ids = [5.0, 4.0, 3.0, 99.0, 98.0], np.arange(5, dtype=np.int32)
    got = []
    for mod, make, xp in ((R, R_make_partition, jnp),
                          (T, T_make_partition, torch)):
        op = mod.pull("toolbox/topk", k=3)
        recs = (xp.asarray(np.asarray(scores, np.float32)), xp.asarray(ids))
        out = op(make(recs, 3))           # only the first 3 valid
        got.append(_np(out.records[1])[:3].tolist())
        assert set(got[-1]) == {0, 1, 2}
    assert got[0] == got[1]


# -- tests/test_property.py ---------------------------------------------------

@given(st.integers(1, 512), st.integers(1, 5))
@settings(**SETTINGS)
def test_split_factors_product_twin(n, k):
    f = T.split_factors(n, k)
    assert f == R.split_factors(n, k)
    assert len(f) == k and int(np.prod(f)) == n


def _packs(keys, ndest):
    """The reference's and the port's pack of records 0..n-1 by their
    keys' hashed destination, capacity n."""
    n = len(keys)
    ka = np.asarray(keys, np.int32)
    rd = (R_hash_keys(jnp.asarray(ka)) % ndest).astype(jnp.int32)
    td = (T_hash_keys(torch.from_numpy(ka)) % ndest).to(torch.int32)
    assert np.array_equal(np.asarray(rd), td.numpy())
    rp = R_pack_by_dest((jnp.arange(n, dtype=jnp.int32),), rd,
                        jnp.ones((n,), bool), ndest, n)
    tp = T_pack_by_dest((torch.arange(n, dtype=torch.int32),), td,
                        torch.ones((n,), dtype=torch.bool), ndest, n)
    return rp, tp, td.numpy()


@given(st.lists(st.integers(0, 1000), min_size=1, max_size=64),
       st.integers(2, 8))
@settings(**SETTINGS)
def test_pack_by_dest_preserves_multiset_twin(keys, ndest):
    """repartitionBy's invariant in both packages: with capacity ==
    n_records the pack is lossless, every record lands in its hashed
    destination, and the two packs are equal element for element."""
    rp, tp, dest = _packs(keys, ndest)
    assert int(rp.dropped) == int(tp.dropped) == 0
    counts = _np(tp.counts)
    np.testing.assert_array_equal(np.asarray(rp.counts), counts)
    (rvals,), (tvals,) = rp.buffer, tp.buffer
    got = []
    for d in range(ndest):
        row = _np(tvals[d, :counts[d]]).tolist()
        assert row == np.asarray(rvals[d, :counts[d]]).tolist()
        assert all(dest[r] == d for r in row)
        got += row
    assert sorted(got) == list(range(len(keys)))


@given(st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=32))
@settings(**SETTINGS)
def test_hash_keys_deterministic_twin(keys):
    ka = np.asarray(keys, np.int32)
    a = T_hash_keys(torch.from_numpy(ka))
    b = T_hash_keys(torch.from_numpy(ka.copy()))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(R_hash_keys(jnp.asarray(ka))).astype(np.int64))


@given(st.integers(0, 100), st.integers(1, 30), st.integers(2, 5))
@settings(**SETTINGS)
def test_mare_reduce_depth_invariance_twin(seed, n, k):
    """Paper §1.2.2 in both packages: for an associative and commutative
    combiner the reduce's result does not depend on the tree depth K."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=n).astype(np.float32)
    want = set(np.argsort(-scores)[:min(5, n)].tolist())
    for mod in (R, T):
        results = []
        for depth in (1, k):
            r = _mare(mod, (scores, np.arange(n, dtype=np.int32))).reduce(
                image="toolbox/topk", k=5, depth=depth)
            _, idx = r.collect(shard=0)
            results.append(set(_np(idx).tolist()))
        assert results[0] == results[1] == want


@given(st.lists(st.integers(0, 6), min_size=1, max_size=48),
       st.integers(2, 6))
@settings(**SETTINGS)
def test_pack_unpack_roundtrip_twin(dests, ndest):
    """unpack_gather(pack(x)) returns each record's own row in both
    packages (the MoE dispatch's invariant)."""
    n = len(dests)
    recs = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    dest = np.asarray([d % ndest for d in dests], np.int32)
    rp = R_pack_by_dest((jnp.asarray(recs),), jnp.asarray(dest),
                        jnp.ones((n,), bool), ndest, n)
    tp = T_pack_by_dest((torch.from_numpy(recs),), torch.from_numpy(dest),
                        torch.ones((n,), dtype=torch.bool), ndest, n)
    rb = R_unpack_gather(rp.buffer[0].reshape(ndest * n, 2), rp, n)
    tb = T_unpack_gather(tp.buffer[0].reshape(ndest * n, 2), tp, n)
    np.testing.assert_array_equal(np.asarray(rb), recs)
    np.testing.assert_array_equal(_np(tb), recs)
