"""The whole slice — FASTA -> GC count / k-mer reduce_by_key -> collect —
through the port and through the reference, on the same data, at 1
shard in this process (the 8-shard case is ``test_torch_mare_8shard.py``).
Integer outputs, ``describe()`` strings and counter diagnostics must be
identical.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.io import fasta_source as ref_fasta_source
from repro_torch import deprecations
from repro_torch.io import fasta_source as port_fasta_source

K = 4


def key_of(r):
    return r[0]


def ones_of(r):
    return (r[1],)


def _genome(tmp_path, n_lines=240, seed=0):
    rng = np.random.default_rng(seed)
    rows = [b">chr21 synthetic"]
    for w in rng.integers(20, 61, n_lines):
        rows.append(rng.choice(np.frombuffer(b"ACGTACGTNacgt", np.uint8),
                               size=int(w)).tobytes())
    path = tmp_path / "genome.fa"
    path.write_bytes(b"\n".join(rows) + b"\n")
    return str(path)


def _gc(m, TextFile):
    return (m.map(input_mount=TextFile("/dna"),
                  output_mount=TextFile("/count"),
                  image="ubuntu", command="grep-chars GC")
            .reduce(input_mount=TextFile("/counts"),
                    output_mount=TextFile("/sum"),
                    image="ubuntu", command="awk-sum"))


def _kmer(m, **kw):
    return (m.map(image="kmer-stats", command=f"kmer-stats {K}")
            .reduce_by_key(key_of, value_by=ones_of, op="sum", **kw))


PIPELINES = {
    "gc": lambda m, mod: _gc(m, mod.TextFile),
    "kmer": lambda m, mod: _kmer(m),
    "kmer_kernel": lambda m, mod: _kmer(m, use_kernel=True),
    "kmer_nocombiner": lambda m, mod: _kmer(m, combiner=False),
    "kmer_salted": lambda m, mod: _kmer(m, combiner=False, salt=3),
    "kmer_repartition": lambda m, mod: (
        m.map(image="kmer-stats", command=f"kmer-stats {K}")
        .repartition_by(key_of)),
    "kmer_topk_depth3": lambda m, mod: (
        m.map(image="kmer-stats", command=f"kmer-stats {K}")
        .reduce(image="toolbox/topk", k=5, depth=3)),
}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _assert_identical(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("name", ["gc", "kmer", "kmer_nocombiner",
                                  "kmer_salted"])
def test_one_shard_matches_reference(tmp_path, name):
    path = _genome(tmp_path)
    build = PIPELINES[name]
    ref_ds = R.MaRe.from_source(
        ref_fasta_source(path, split_bytes=1 << 11))._dataset
    port_ds = T.MaRe.from_source(
        port_fasta_source(path, split_bytes=1 << 11), num_shards=1,
        device="cpu")._dataset
    ref = build(R.MaRe(ref_ds, plan_cache=R.PlanCache()), R)
    port = build(T.MaRe(port_ds, plan_cache=T.PlanCache()), T)
    assert port.describe() == ref.describe()
    _assert_identical(_leaves(ref.collect(shard=0)),
                      _leaves(port.collect(shard=0)))
    assert port.report().diagnostics == ref.report().diagnostics


def test_merge_keyed_tables_matches_reference():
    from repro.core.tree_reduce import merge_keyed_tables as ref_merge
    from repro_torch.core.tree_reduce import merge_keyed_tables as port_merge
    rng = np.random.default_rng(11)
    num_keys = 32

    def table(count):
        keys = np.sort(rng.choice(num_keys, num_keys, replace=False)
                       ).astype(np.int32)
        vals = rng.integers(0, 9, num_keys).astype(np.int32)
        cnts = rng.integers(1, 5, num_keys).astype(np.int32)
        return (keys, (vals,), cnts), count

    (a, ca), (b, cb) = table(20), table(9)
    want = ref_merge(R.make_partition(jax.tree.map(jax.numpy.asarray, a), ca),
                     R.make_partition(jax.tree.map(jax.numpy.asarray, b), cb),
                     num_keys)
    got = port_merge(T.make_partition(jax.tree.map(torch.from_numpy, a), ca),
                     T.make_partition(jax.tree.map(torch.from_numpy, b), cb),
                     num_keys)
    _assert_identical(_leaves(want.records),
                      [x.numpy() for x in jax.tree.leaves(
                          got.records, is_leaf=torch.is_tensor)])
    assert int(got.count) == int(want.count)


def test_gc_count_equals_numpy(tmp_path):
    path = _genome(tmp_path, seed=3)
    raw = open(path, "rb").read().split(b"\n", 1)[1]
    want = raw.count(b"G") + raw.count(b"C")
    (total,) = _gc(T.MaRe.from_source(port_fasta_source(path), num_shards=3,
                                      device="cpu"), T.TextFile
                   ).collect(shard=0)
    assert total.dtype == np.int32 and int(total[0]) == want


def test_plan_type_errors_match():
    data = (np.arange(64, dtype=np.int32) % 4,)
    errs = []
    for mod, kw in ((R, {}), (T, {"device": "cpu"})):
        with pytest.raises(mod.PlanTypeError) as e:
            (mod.MaRe(data, **kw)
             .map(image="ubuntu", command="grep-count 2 3")
             .map(image="ubuntu", command="grep-chars GC"))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_key_table_errors_match(tmp_path):
    path = _genome(tmp_path, seed=4)
    errs = []
    for mod, src, kw in ((R, ref_fasta_source, {}),
                         (T, port_fasta_source, {"device": "cpu"})):
        m = mod.MaRe.from_source(src(path), **kw).map(
            image="kmer-stats", command=f"kmer-stats {K}")
        with pytest.raises(mod.PlanTypeError) as e:
            m.reduce_by_key(key_of, num_keys=4 ** K - 1, op="sum")
        errs.append(str(e.value))
        shifted = m.reduce_by_key(lambda r: r[0] + 1, num_keys=4 ** K,
                                  value_by=ones_of, op="sum")
        with pytest.raises(RuntimeError) as e:
            shifted.collect()
        errs.append(str(e.value))
    assert errs[0] == errs[2] and errs[1] == errs[3]


def test_plan_cache_hits_on_rebuild(tmp_path):
    path = _genome(tmp_path, seed=5)
    cache = T.PlanCache()
    ds = T.MaRe.from_source(port_fasta_source(path), device="cpu")._dataset
    for _ in range(2):
        _kmer(T.MaRe(ds, plan_cache=cache)).collect()
    assert cache.stats() == {"programs": 1, "hits": 1, "misses": 1}


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = (np.arange(8, dtype=np.int32),)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.MaRe(data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.MaRe.from_source(port_fasta_source(_genome(tmp_path)))
    assert T.MaRe(data, device="cpu").dataset.device.type == "cpu"


@pytest.mark.filterwarnings(
    "always::repro_torch.deprecations.MaReDeprecationWarning")
def test_paper_aliases_warn_once():
    deprecations.reset()
    m = T.MaRe((np.arange(8, dtype=np.int32),), device="cpu")
    with pytest.warns(deprecations.MaReDeprecationWarning):
        m.reduceByKey(lambda r: r[0], num_keys=8, op="sum")
    with pytest.warns(deprecations.MaReDeprecationWarning):
        m.map(image="ubuntu", command="awk-sum", inputMountPoint=None)
