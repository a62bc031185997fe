"""Segment reduce: the port against the reference on the same inputs.

The reference runs its Pallas kernel in interpret mode (``use_kernel=True``)
or its scatter path (``use_kernel=False``); the port runs its kernel
wrapper (which on a CPU tensor takes the kernel's plain version) or its
scatter path.  Integers must match bit for bit, dtypes included; float32
sums are taken in another order, so they match to rtol 1e-5 and
atol 1e-6 * n.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce import segment_reduce as ref_segment_reduce
from repro_torch.kernels.segment_reduce import kernel as kmod
from repro_torch.kernels.segment_reduce import (resolve_strategy,
                                                segment_reduce,
                                                segment_sum,
                                                segment_sum_ref)


def _case(seed, n, num_keys, spill=True, hot=None, valid_frac=0.8):
    rng = np.random.default_rng(seed)
    lo, hi = (-3, num_keys + 5) if spill else (0, num_keys)
    keys = rng.integers(lo, hi, size=n).astype(np.int32)
    if hot is not None:
        keys[rng.random(n) < 0.9] = hot
    valid = rng.random(n) < valid_frac
    ints = rng.integers(-50, 100, size=(n, 2)).astype(np.int32)
    floats = rng.normal(size=(n,)).astype(np.float32)
    return rng, keys, valid, ints, floats


def _assert_same(ref, got, n):
    r_leaves = [np.asarray(x) for x in ref]
    g_leaves = [x.numpy() for x in got]
    assert len(r_leaves) == len(g_leaves)
    for r, g in zip(r_leaves, g_leaves):
        assert r.dtype == g.dtype and r.shape == g.shape
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6 * max(n, 1))
        else:
            np.testing.assert_array_equal(g, r)


def _run_both(keys, values_np, num_keys, valid, use_kernel, op="sum",
              key_block=None):
    jv = tuple(jnp.asarray(v) for v in values_np)
    ref = ref_segment_reduce(jnp.asarray(keys), jv, num_keys, op=op,
                             valid=jnp.asarray(valid), use_kernel=use_kernel,
                             block=64, key_block=key_block, interpret=True)
    tv = tuple(torch.from_numpy(v) for v in values_np)
    got = segment_reduce(torch.from_numpy(keys), tv, num_keys, op=op,
                         valid=torch.from_numpy(valid),
                         use_kernel=use_kernel)
    return ref, got


CASES = {
    "mixed_pytree": dict(n=300, num_keys=37),
    "single_key": dict(n=200, num_keys=1),
    "num_keys_not_block_multiple": dict(n=257, num_keys=200, key_block=64),
    "all_masked": dict(n=128, num_keys=16, valid_frac=0.0),
    "hot_key": dict(n=400, num_keys=50, hot=7),
    "out_of_range": dict(n=300, num_keys=20, spill=True),
    "empty_shard": dict(n=0, num_keys=9),
}


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sum_matches_reference(name, use_kernel):
    c = dict(CASES[name])
    key_block = c.pop("key_block", None)
    n, num_keys = c["n"], c["num_keys"]
    _, keys, valid, ints, floats = _case(
        1, n, num_keys, spill=c.get("spill", True), hot=c.get("hot"),
        valid_frac=c.get("valid_frac", 0.8))
    ref, got = _run_both(keys, (ints, floats), num_keys, valid, use_kernel,
                         key_block=key_block)
    _assert_same(list(ref.values) + [ref.counts, ref.overflow],
                 list(got.values) + [got.counts, got.overflow], n)
    assert got.counts.dtype == torch.int32
    assert got.overflow.dtype == torch.int32 and got.overflow.ndim == 0


@pytest.mark.parametrize("op", ["max", "min"])
def test_max_min_match_reference(op):
    n, num_keys = 300, 25
    _, keys, valid, ints, floats = _case(3, n, num_keys)
    ref, got = _run_both(keys, (ints, floats), num_keys, valid, None, op=op)
    _assert_same(list(ref.values) + [ref.counts, ref.overflow],
                 list(got.values) + [got.counts, got.overflow], n)


def test_nan_padding_never_reaches_the_table():
    """Invalid slots may hold NaN; they are skipped, not multiplied by 0."""
    n, num_keys = 64, 8
    _, keys, valid, _, floats = _case(4, n, num_keys, spill=False)
    floats[~valid] = np.nan
    ref, got = _run_both(keys, (floats,), num_keys, valid, True)
    assert np.isfinite(got.values[0].numpy()).all()
    _assert_same([ref.values[0]], [got.values[0]], n)


def test_strategy_dispatch():
    vals = (torch.zeros(4, dtype=torch.int32),)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert resolve_strategy(None, "sum", vals, cuda) == "kernel"
    assert resolve_strategy(None, "sum", vals, cpu) == "scatter"
    assert resolve_strategy(True, "sum", vals, cpu) == "kernel"
    assert resolve_strategy(False, "sum", vals, cuda) == "scatter"
    assert resolve_strategy(None, "max", vals, cuda) == "scatter"
    assert resolve_strategy(True, "sum", (), cuda) == "scatter"
    with pytest.raises(ValueError, match="unknown segment-reduce op"):
        resolve_strategy(None, "mean", vals, cpu)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    keys = torch.zeros(4, dtype=torch.int32)
    valid = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError, match="int32 or float32"):
        segment_sum(keys, torch.zeros((4, 1), dtype=torch.int64), 3, valid)
    with pytest.raises(TypeError, match="int32 keys"):
        segment_sum(keys.long(), torch.zeros((4, 1), dtype=torch.int32), 3,
                    valid)
    with pytest.raises(ValueError, match=r"values \[n, d\]"):
        segment_sum(keys, torch.zeros(4, dtype=torch.int32), 3, valid)
    with pytest.raises(ValueError, match="contiguous"):
        segment_sum(keys, torch.zeros((2, 4), dtype=torch.int32).t(), 3,
                    valid)


def test_cpu_wrapper_takes_the_plain_version_without_launching():
    _, keys, valid, ints, _ = _case(5, 100, 10)
    before = kmod.LAUNCHES
    got = segment_sum(torch.from_numpy(keys), torch.from_numpy(ints), 10,
                      torch.from_numpy(valid))
    want = segment_sum_ref(torch.from_numpy(keys), torch.from_numpy(ints),
                           10, torch.from_numpy(valid))
    assert kmod.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,preferred", [(1, 512), (100, 512), (129, 512),
                                         (1000, 512), (5000, 1024),
                                         (70000, 4096)])
def test_block_helpers_match_reference(n, preferred):
    from repro.kernels import common as ref_common
    from repro_torch.kernels import common as port_common
    assert port_common.pick_block(n, preferred) == \
        ref_common.pick_block(n, preferred)
    assert port_common.round_up(n, 64) == ref_common.round_up(n, 64)
    assert port_common.cdiv(n, 7) == ref_common.cdiv(n, 7)
