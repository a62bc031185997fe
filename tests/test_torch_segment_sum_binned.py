"""The binned segment-sum route's algebra on the CPU.

``ref.segment_sum_binned_ref`` does in tensor code what the CUDA binned
route does (tile histogram, partition by key tile, per-tile fold, hot
tiles split into items of ``split`` records).  It is held to the port's
plain version and to the reference's Pallas kernel
(``repro.kernels.segment_reduce.kernel.segment_sum_tiled``, interpret
mode) on the same inputs: int32 bit for bit, dtypes included.  float32
sums are taken in another order, so they are held to the plain version
taken in float64 with rtol 1e-5 and atol 1e-6 x the largest per-key count
x the largest valid |value|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce.kernel import segment_sum_tiled
from repro_torch.kernels.segment_reduce import kernel as kmod
from repro_torch.kernels.segment_reduce.ref import (SPLIT, bin_tiles,
                                                    segment_sum_binned_ref,
                                                    segment_sum_ref)

CASES = {
    # name: n, num_keys, key_block, d, split, and the keys' shape
    "edge_keys": dict(n=400, num_keys=97, key_block=16, d=2, edges=True),
    "odd_num_keys_partial_tile": dict(n=500, num_keys=201, key_block=64,
                                      d=1),
    "tiny_key_block": dict(n=600, num_keys=150, key_block=2, d=3),
    "one_hot_key_split": dict(n=700, num_keys=64, key_block=16, d=2,
                              split=50, hot=37, hot_frac=1.0),
    "hot_key_on_tile_edge": dict(n=500, num_keys=40, key_block=8, d=1,
                                 split=32, hot=8, hot_frac=0.9),
    "split_equals_tile": dict(n=64, num_keys=4, key_block=4, d=3, split=64,
                              valid_frac=1.0, spill=False),
    "all_masked": dict(n=256, num_keys=33, key_block=8, d=2,
                       valid_frac=0.0),
    "key_block_past_num_keys": dict(n=300, num_keys=5, key_block=8, d=1),
    "single_key": dict(n=200, num_keys=1, key_block=1, d=3),
    "empty": dict(n=0, num_keys=9, key_block=4, d=2),
}


def _case(seed, n, num_keys, key_block, d, split=SPLIT, hot=None,
          hot_frac=0.9, valid_frac=0.8, spill=True, edges=False):
    rng = np.random.default_rng(seed)
    lo, hi = (-3, num_keys + 5) if spill else (0, num_keys)
    keys = rng.integers(lo, hi, size=n).astype(np.int32)
    if hot is not None:
        keys[rng.random(n) < hot_frac] = hot
    if edges:        # both ends of the key space and just past them
        keys[:40] = np.resize([0, num_keys - 1, -1, num_keys], 40)
    valid = rng.random(n) < valid_frac
    if edges:
        valid[:40] = True
    ints = rng.integers(-50, 100, size=(n, d)).astype(np.int32)
    floats = rng.normal(size=(n, d)).astype(np.float32)
    floats[~valid] = np.nan            # padding may hold NaN
    return keys, valid, ints, floats


def _args(name):
    c = dict(CASES[name])
    keys, valid, ints, floats = _case(11, **c)
    return c, torch.from_numpy(keys), torch.from_numpy(valid), ints, floats


@pytest.mark.parametrize("name", sorted(CASES))
def test_binned_equals_plain_version_bit_for_bit(name):
    c, keys, valid, ints, _ = _args(name)
    vals = torch.from_numpy(ints)
    got = segment_sum_binned_ref(keys, vals, c["num_keys"], valid,
                                 c["key_block"], c.get("split", SPLIT))
    want = segment_sum_ref(keys, vals, c["num_keys"], valid)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(set(CASES) - {"empty"}))
def test_binned_equals_reference_tiled_kernel(name):
    c, keys, valid, ints, _ = _args(name)
    got = segment_sum_binned_ref(keys, torch.from_numpy(ints),
                                 c["num_keys"], valid, c["key_block"],
                                 c.get("split", SPLIT))
    ref = segment_sum_tiled(jnp.asarray(keys.numpy()), jnp.asarray(ints),
                            c["num_keys"], jnp.asarray(valid.numpy()),
                            block=64, key_block=c["key_block"],
                            interpret=True)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_binned_float32_within_tolerance(name):
    c, keys, valid, _, floats = _args(name)
    vals = torch.from_numpy(floats)
    table, counts, overflow = segment_sum_binned_ref(
        keys, vals, c["num_keys"], valid, c["key_block"],
        c.get("split", SPLIT))
    want = segment_sum_ref(keys, vals.double(), c["num_keys"], valid)
    assert table.dtype == torch.float32
    assert torch.isfinite(table).all()          # NaN padding never read
    assert torch.equal(counts, want[1]) and torch.equal(overflow, want[2])
    vmax = float(vals[valid].abs().max()) if bool(valid.any()) else 0.0
    atol = 1e-6 * (int(counts.max()) if counts.numel() else 0) * vmax
    torch.testing.assert_close(table.double(), want[0], rtol=1e-5,
                               atol=atol)


def test_overflow_is_counted_once_whatever_the_tiling():
    keys = torch.tensor([-1, 7, 8, 3, 100, -5, 0, 7], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 0, 1, 1, 1, 0], dtype=torch.bool)
    for key_block in (1, 2, 4, 8, 16):
        *_, overflow = bin_tiles(keys, valid, 8, key_block)
        assert overflow.tolist() == [4]    # -1, 8, 100, -5; invalid 3, 7 not
        got = segment_sum_binned_ref(keys, torch.ones((8, 1),
                                                      dtype=torch.int32),
                                     8, valid, key_block)
        assert got[2].tolist() == [4]
        assert got[1].tolist() == [1, 0, 0, 0, 0, 0, 0, 1]


@pytest.mark.parametrize("count,split,extras", [
    (1, 4, 0), (4, 4, 0), (5, 4, 1), (8, 4, 1), (9, 4, 2), (700, 50, 13),
])
def test_hot_tile_folds_in_items_of_split_records(count, split, extras):
    keys = torch.full((count + 3,), 5, dtype=torch.int32)
    keys[-3:] = torch.tensor([0, 9, 12], dtype=torch.int32)  # other tiles
    valid = torch.ones(count + 3, dtype=torch.bool)
    ok, tile, tile_start, extra_start, overflow = bin_tiles(
        keys, valid, 16, 4, split)
    assert tile_start.tolist() == [0, 1, 1 + count, 2 + count, 3 + count]
    assert extra_start.tolist() == [0, 0, extras, extras, extras]
    assert overflow.tolist() == [0]
    vals = torch.arange(count + 3, dtype=torch.int32).reshape(-1, 1)
    got = segment_sum_binned_ref(keys, vals, 16, valid, 4, split)
    want = segment_sum_ref(keys, vals, 16, valid)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("num_keys,d", [(4 ** 12, 1), (4 ** 12, 2),
                                        (1000003, 3), (37, 2), (1, 1)])
def test_kernel_key_block_tiles_cover_the_key_space(num_keys, d):
    """The CUDA route's tiles: a power of two of keys whose table rows and
    counts fit the shared-memory budget, enough of them to cover every
    key, and the binned algebra exact at that tiling."""
    kb = kmod.key_block(num_keys, d)
    assert kb & (kb - 1) == 0
    assert kb * (d + 1) * 4 <= kmod.TILE_BYTES
    assert -(-num_keys // kb) * kb >= num_keys
    assert kb < 2 * num_keys           # no wider than the key space needs
    if num_keys <= 1000003:
        keys, valid, ints, _ = _case(12, 3000, num_keys, kb, d)
        keys, valid = torch.from_numpy(keys), torch.from_numpy(valid)
        vals = torch.from_numpy(ints)
        got = segment_sum_binned_ref(keys, vals, num_keys, valid, kb)
        want = segment_sum_ref(keys, vals, num_keys, valid)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
