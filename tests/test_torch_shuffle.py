"""Hash exchange: the port's hashing, bucket sizing and pack/unpack
against the reference, bit for bit, dtypes included; plus the
jnp-semantics helpers the port relies on (clip-mode take, stable
partition) and the reference's 32-bit wraparound traps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shuffle as ref
from repro_torch.core import shuffle as port
from repro_torch.core.tensors import (masked_sum, stable_argsort_false_first,
                                      take_clip)

M32 = (1 << 32) - 1


def _eq(ref_arr, got):
    r = np.asarray(ref_arr)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert r.dtype == g.dtype, (r.dtype, g.dtype)
    np.testing.assert_array_equal(g, r)


def test_hash_keys_every_4pow8_key():
    keys = np.arange(4 ** 8, dtype=np.int32)
    want = np.asarray(ref.hash_keys(jnp.asarray(keys))).astype(np.int64)
    got = port.hash_keys(torch.from_numpy(keys))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_keys_random_int32_with_negatives():
    rng = np.random.default_rng(0)
    keys = rng.integers(-2 ** 31, 2 ** 31, size=50_000, dtype=np.int64
                        ).astype(np.int32)
    keys[:4] = [-1, -2 ** 31, 2 ** 31 - 1, 0]
    want = np.asarray(ref.hash_keys(jnp.asarray(keys))).astype(np.int64)
    np.testing.assert_array_equal(
        port.hash_keys(torch.from_numpy(keys)).numpy(), want)


@pytest.mark.parametrize("num_keys,axis_size", [(4 ** 6, 8), (1000, 3),
                                                (7, 8), (4 ** 8, 1)])
def test_bucket_capacities_equal(num_keys, axis_size):
    np.testing.assert_array_equal(
        port.keyed_bucket_capacities(num_keys, axis_size),
        ref.keyed_bucket_capacities(num_keys, axis_size))
    assert port.keyed_bucket_capacity(num_keys, axis_size) == \
        ref.keyed_bucket_capacity(num_keys, axis_size)


def _unhash(h):
    """Preimage of the splitmix32 mix (every step is invertible mod 2**32),
    to build keys whose hash sits right below 2**32."""
    def unxorshift(x, s):
        y = x
        for _ in range(32 // s + 1):
            y = x ^ (y >> s)
        return y & M32
    h = unxorshift(h, 16)
    h = (h * pow(0x846CA68B, -1, 1 << 32)) & M32
    h = unxorshift(h, 15)
    h = (h * pow(0x7FEB352D, -1, 1 << 32)) & M32
    return unxorshift(h, 16)


def test_salted_dest_wraps_at_2pow32_like_the_reference():
    # hashes within `salt` of 2**32: base + slot % salt wraps in uint32
    keys = np.array([_unhash(M32 - i) for i in range(8)], np.uint32
                    ).view(np.int32)
    assert (np.asarray(ref.hash_keys(jnp.asarray(keys))).astype(np.int64)
            >= M32 - 7).all()
    for salt, axis in ((8, 3), (4, 7), (3, 8)):
        _eq(ref.salted_dest(jnp.asarray(keys), axis, salt),
            port.salted_dest(torch.from_numpy(keys), axis, salt))


def test_salted_dest_random():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 4 ** 10, 5000).astype(np.int32)
    _eq(ref.salted_dest(jnp.asarray(keys), 8, 4),
        port.salted_dest(torch.from_numpy(keys), 8, 4))


@pytest.mark.parametrize("capacity", [40, 5])
def test_pack_and_unpack_equal(capacity):
    rng = np.random.default_rng(2)
    n, num_dest = 120, 5
    dest = rng.integers(0, num_dest, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    recs = (rng.integers(0, 1000, n).astype(np.int32),
            {"v": rng.normal(size=(n, 3)).astype(np.float32)})
    r = ref._pack_by_dest(
        (jnp.asarray(recs[0]), {"v": jnp.asarray(recs[1]["v"])}),
        jnp.asarray(dest), jnp.asarray(valid), num_dest, capacity)
    g = port._pack_by_dest(
        (torch.from_numpy(recs[0]), {"v": torch.from_numpy(recs[1]["v"])}),
        torch.from_numpy(dest), torch.from_numpy(valid), num_dest, capacity)
    _eq(r.buffer[0], g.buffer[0])
    _eq(r.buffer[1]["v"], g.buffer[1]["v"])
    for field in ("counts", "dropped", "dest", "pos", "in_cap"):
        _eq(getattr(r, field), getattr(g, field))
    flat_r = r.buffer[0].reshape(num_dest * capacity)
    flat_g = g.buffer[0].reshape(num_dest * capacity)
    _eq(ref.unpack_gather(flat_r, r, capacity),
        port.unpack_gather(flat_g, g, capacity))


def test_all_to_all_is_the_block_transpose():
    n, cap = 4, 3
    bufs = [torch.arange(n * cap).reshape(n, cap) + 100 * s
            for s in range(n)]
    out = port.all_to_all(bufs)
    for d in range(n):
        for s in range(n):
            assert torch.equal(out[d][s], bufs[s][d])


def test_take_clip_matches_jnp_clip_mode():
    x = np.arange(10, dtype=np.int32) * 3
    idx = np.array([-5, 0, 3, 9, 10, 99], np.int64)
    _eq(jnp.take(jnp.asarray(x), jnp.asarray(idx), mode="clip"),
        take_clip(torch.from_numpy(x), torch.from_numpy(idx)))


def test_stable_partition_matches_jnp_argsort():
    rng = np.random.default_rng(3)
    mask = rng.random(1000) < 0.5
    want = np.asarray(jnp.argsort(~jnp.asarray(mask), stable=True))
    got = stable_argsort_false_first(torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_int32_sums_stay_int32_and_wrap():
    """``torch.sum`` widens int32 to int64; the reference's counters and
    sums are int32 and wrap."""
    vals = np.full(4, 2 ** 30, np.int32)
    valid = np.ones(4, bool)
    got = masked_sum(torch.from_numpy(vals), torch.from_numpy(valid))
    want = jnp.sum(jnp.where(jnp.asarray(valid), jnp.asarray(vals), 0))
    _eq(want, got)
