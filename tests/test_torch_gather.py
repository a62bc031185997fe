"""The port's result gather (``core/dataset.collect`` / ``collect_shard``)
on the CPU: each shard's valid rows copied straight to their offset in
host arrays the answer owns.

The answers are held to the concatenation of the valid slices, computed
here in numpy from the records as built, over uneven counts (an empty
shard, a full one, a shard of one row, a partial one), leaves with
trailing dimensions and four dtypes, and both ways a leaf's slices reach
the host (a copy a slice, or concatenated on the device first, as a leaf
below ``CAT_BELOW_BYTES`` is); the padding rows hold values that must
never reach an answer.  The CUDA side, where the arrays are views
over pinned host memory, is tested on the card in
``tests/test_torch_runtime_gpu.py``.  This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ShardedDataset, collect, collect_shard, dataset
from repro_torch.obs import METRICS, tracing

#: Valid rows a shard: empty, full, one row, partial.
COUNTS = (0, 5, 1, 3)
CAP = 5
N_SHARDS = len(COUNTS)

#: Leaf kind -> (trailing shape, dtype).
LEAVES = {
    "int32": ((), np.int32),
    "int64x2": ((2,), np.int64),
    "float32x3x2": ((3, 2), np.float32),
    "bool": ((), np.bool_),
}

#: The gathers: the whole dataset, then each shard on its own.
GATHERS = ["all"] + [f"shard{s}" for s in range(N_SHARDS)]

#: How a leaf's valid slices reach the host (``CAT_BELOW_BYTES``): a copy
#: a slice, or concatenated on the device first and copied once.
COPIES = {"per_slice": 0, "concatenated": 1 << 62}


@pytest.fixture(params=sorted(COPIES))
def copies(request, monkeypatch):
    monkeypatch.setattr(dataset, "CAT_BELOW_BYTES", COPIES[request.param])


def _leaf(kind: str, seed: int) -> np.ndarray:
    trail, dtype = LEAVES[kind]
    rng = np.random.default_rng(seed)
    shape = (N_SHARDS * CAP,) + trail
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if dtype == np.float32:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.integers(-2**31, 2**31, shape).astype(dtype)


def _records(leaves: str):
    """The host records of one case: a single leaf, or every kind in a
    nested pytree."""
    if leaves != "mixed":
        return _leaf(leaves, 1)
    kinds = sorted(LEAVES)
    return {"a": _leaf(kinds[0], 2),
            "b": (_leaf(kinds[1], 3), _leaf(kinds[2], 4)),
            "c": _leaf(kinds[3], 5)}


def _dataset(records) -> ShardedDataset:
    recs = _map(lambda a: torch.from_numpy(a.copy()), records)
    return ShardedDataset(records=recs,
                          counts=torch.tensor(COUNTS, dtype=torch.int32),
                          num_shards=N_SHARDS)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [a for v in tree for a in _flat(v)]
    return [tree]


def _gather(ds: ShardedDataset, which: str):
    if which == "all":
        return collect(ds)
    return collect_shard(ds, int(which[len("shard"):]))


def _expected(records, which: str):
    shards = (range(N_SHARDS) if which == "all"
              else [int(which[len("shard"):])])
    return _map(lambda a: np.concatenate(
        [a[s * CAP:s * CAP + COUNTS[s]] for s in shards], axis=0), records)


@pytest.mark.parametrize("leaves", sorted(LEAVES) + ["mixed"])
@pytest.mark.parametrize("which", GATHERS)
def test_gather_equals_the_valid_slices(which, leaves, copies):
    """Each leaf of the answer equals the concatenation of the shards'
    valid slices bit for bit, in dtype, shape and row order, and is a
    C-contiguous, writable array."""
    records = _records(leaves)
    got = _gather(_dataset(records), which)
    want = _expected(records, which)
    assert type(got) is type(want)
    got_l, want_l = _flat(got), _flat(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert isinstance(g, np.ndarray)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
        assert g.flags.c_contiguous and g.flags.writeable


@pytest.mark.parametrize("which", GATHERS)
def test_successive_gathers_share_no_memory(which, copies):
    """Two answers of one dataset share no memory with each other or with
    the dataset: writing one leaves the other, and the next gather,
    unchanged."""
    records = _records("mixed")
    ds = _dataset(records)
    a, b = _flat(_gather(ds, which)), _flat(_gather(ds, which))
    for x, y in zip(a, b):
        assert not np.shares_memory(x, y)
        before = y.copy()
        x[...] = ~x if x.dtype == np.bool_ else x + 1
        assert y.tobytes() == before.tobytes()
    again = _flat(_gather(ds, which))
    for y, z in zip(b, again):
        assert y.tobytes() == z.tobytes()


@pytest.mark.parametrize("which", GATHERS)
def test_gather_span_and_counter(which):
    """The ``gather`` span carries the answer's rows and host bytes and
    says that the copy was not pinned; ``gather.pageable_bytes`` counts
    the CPU gather's bytes and ``gather.pinned_bytes`` nothing."""
    records = _records("mixed")
    ds = _dataset(records)
    pageable = METRICS.counter("gather.pageable_bytes").value
    pinned = METRICS.counter("gather.pinned_bytes").value
    with tracing() as t:
        out = _gather(ds, which)
    nbytes = sum(a.nbytes for a in _flat(out))
    (ev,) = [e for e in t.events() if e["name"] == "gather"]
    assert ev["args"]["rows"] == _flat(out)[0].shape[0]
    assert ev["args"]["bytes"] == nbytes
    assert ev["args"]["pinned"] is False
    assert METRICS.counter("gather.pageable_bytes").value - pageable \
        == nbytes
    assert METRICS.counter("gather.pinned_bytes").value == pinned
