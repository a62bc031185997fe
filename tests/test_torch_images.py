"""Container images: the port's images against the reference's on the
same partitions — records, counts and dtypes bit for bit, and the same
command-grammar errors at pull time."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import container as ref_c
from repro_torch.core import container as port_c


def _bytes_part(seed, cap=40, width=24, count=33):
    rng = np.random.default_rng(seed)
    data = rng.choice(np.frombuffer(b"ACGTNacgtnGC-", np.uint8),
                      size=(cap, width)).astype(np.uint8)
    lens = rng.integers(0, width + 1, cap).astype(np.int32)
    return {"data": data, "len": lens}, count


def _run(image, command, records, count, **params):
    r_op = ref_c.pull(image, command=command, **params)
    p_op = port_c.pull(image, command=command, **params)
    r = r_op(ref_c.make_partition(jax.tree.map(jnp.asarray, records),
                                  count))
    p = p_op(port_c.make_partition(
        jax.tree.map(torch.from_numpy, records), count))
    return r, p


def _assert_same(r, p, exact=True):
    r_leaves = jax.tree.leaves(r.records)
    p_leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), p.records,
                                            is_leaf=torch.is_tensor))
    assert len(r_leaves) == len(p_leaves)
    for a, b in zip(r_leaves, p_leaves):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        if exact:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5,
                                       atol=1e-6 * max(a.size, 1))
    assert p.count.dtype == torch.int32
    assert int(p.count) == int(r.count)


@pytest.mark.parametrize("k", [1, 6, 15])
def test_kmer_stats(k):
    records, count = _bytes_part(k, width=24)
    r, p = _run("kmer-stats", f"kmer-stats {k}", records, count)
    _assert_same(r, p)


def test_kmer_stats_errors_match():
    records, count = _bytes_part(0, width=10)
    for command in ("kmer-stats 16", "kmer-stats 11"):
        errs = []
        for c in (ref_c, port_c):
            op = c.pull("kmer-stats", command=command)
            conv = (jnp.asarray if c is ref_c else torch.from_numpy)
            with pytest.raises(ValueError) as e:
                op(c.make_partition({k: conv(v) for k, v in records.items()},
                                    count))
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("command", ["grep-chars GC", "grep-chars N-"])
def test_grep_chars(command):
    records, count = _bytes_part(7)
    _assert_same(*_run("ubuntu", command, records, count))


@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.float32])
def test_grep_count(dtype):
    rng = np.random.default_rng(8)
    tokens = (rng.integers(0, 6, 50).astype(dtype),)
    _assert_same(*_run("ubuntu", "grep-count 2 3", tokens, 41))
    _assert_same(*_run("posix", "grep-count", tokens, 41))


@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.float32])
def test_awk_sum(dtype):
    rng = np.random.default_rng(9)
    vals = (rng.integers(0, 200, 60).astype(dtype),)
    _assert_same(*_run("ubuntu", "awk-sum", vals, 47),
                 exact=dtype != np.float32)


def test_awk_sum_wraps_int32():
    vals = (np.full(8, 2 ** 30, np.int32),)
    _assert_same(*_run("ubuntu", "awk-sum", vals, 8))


def test_toolbox_images():
    rng = np.random.default_rng(10)
    scores = np.round(rng.normal(size=30), 1).astype(np.float32)  # ties
    recs = (scores, rng.integers(0, 9, (30, 2)).astype(np.int32))
    _assert_same(*_run("toolbox/topk", "", recs, 25, k=7))
    _assert_same(*_run("toolbox/sum", "", recs, 25), exact=False)
    _assert_same(*_run("toolbox/concat", "", recs, 25))


@pytest.mark.parametrize("image,command", [
    ("ubuntu", "frobnicate"),
    ("ubuntu", ""),
    ("ubuntu", "grep-count x"),
    ("ubuntu", "grep-chars"),
    ("ubuntu", "awk-sum 3"),
    ("kmer-stats", "kmer-stats eight"),
    ("nope", ""),
])
def test_command_grammar_errors_match(image, command):
    errs = []
    for c in (ref_c, port_c):
        with pytest.raises((ValueError, KeyError)) as e:
            c.pull(image, command=command)
        errs.append((type(e.value), str(e.value)))
    if image == "nope":   # registries list their own image sets
        assert errs[0][0] is errs[1][0] is KeyError
        return
    assert errs[0] == errs[1]
