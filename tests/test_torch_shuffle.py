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
from repro_torch.core import tree as ttree
from repro_torch.core.container import make_partition
from repro_torch.core.tensors import (masked_sum, stable_argsort_false_first,
                                      take_clip)
from repro_torch.kernels import exchange as ex_mod

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


# -- the exchange: the kernel module's plain version against the pack /
# all_to_all / compact it replaced ------------------------------------------

def _pack_exchange(leaves, counts, capacity, dests):
    """The exchange as the port did it before its kernel, in the same
    layout as ``exchange``: each source packed by destination
    (``_pack_by_dest``), the blocks moved by ``all_to_all``, each
    destination's blocks compacted by a stable false-first sort."""
    n = len(leaves)
    cap_in = dests[0].shape[0]
    packs = [port._pack_by_dest(tuple(src), d.to(torch.int32),
                                torch.arange(cap_in) < c, n, capacity)
             for src, d, c in zip(leaves, dests, counts)]
    recv = port.all_to_all([p.buffer for p in packs])
    recv_counts = torch.stack([p.counts for p in packs]).t()
    slots = torch.arange(capacity)
    outs = [[] for _ in leaves[0]]
    for d in range(n):
        valid = (slots[None, :] < recv_counts[d][:, None]).reshape(-1)
        order = stable_argsort_false_first(valid)
        for l, leaf in enumerate(recv[d]):
            flat = leaf.reshape((n * capacity,) + tuple(leaf.shape[2:]))
            outs[l].append(take_clip(flat, order))
    return ex_mod.Exchanged(
        leaves=[torch.stack(o) for o in outs],
        counts=recv_counts.sum(1).to(torch.int32),
        send_counts=torch.stack([p.counts for p in packs]),
        dropped=torch.stack([p.dropped for p in packs]))


def _sources(rng, n, cap_in, counts, wide=False):
    """n sources of cap_in rows: int32 keys and an int32 value, or (with
    ``wide``) a pytree of mixed dtypes with [rows, w] leaves and a bool
    leaf."""
    out = []
    for _ in range(n):
        leaves = [torch.from_numpy(rng.integers(-50, 50, cap_in)
                                   .astype(np.int32))]
        if wide:
            leaves += [
                torch.from_numpy(rng.integers(-9, 9, (cap_in, 3))
                                 .astype(np.int16)),
                torch.from_numpy(rng.normal(size=(cap_in, 2))),
                torch.from_numpy(rng.random(cap_in) < 0.5),
                torch.from_numpy(rng.integers(0, 255, (cap_in, 5))
                                 .astype(np.uint8))]
        out.append(leaves)
    return out, [torch.tensor(c, dtype=torch.int32) for c in counts]


def _keys(rng, kind, n_src, cap_in):
    if kind == "int64":
        return [torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, cap_in))
                for _ in range(n_src)]
    return [torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, cap_in)
                             .astype(np.int32)) for _ in range(n_src)]


# name: (shards, rows a shard, valid counts, capacity or None, how the
# destinations come: "int32" / "int64" keys, "salted", "partitioner")
EXCHANGE_CASES = {
    "int32_keys": (4, 300, [300, 250, 17, 299], None, "int32"),
    "int64_keys": (5, 257, [257, 100, 0, 3, 256], None, "int64"),
    "dests_salted": (4, 200, [200, 180, 160, 140], 120, "salted"),
    "partitioner": (3, 150, [150, 90, 10], None, "partitioner"),
    "capacity_drops": (4, 400, [400, 390, 380, 10], 60, "int32"),
    "empty_shard": (4, 128, [128, 0, 128, 64], None, "int32"),
    "all_counts_zero": (3, 64, [0, 0, 0], 16, "int32"),
    "no_rows": (3, 0, [0, 0, 0], None, "int32"),
    "one_shard": (1, 99, [73], None, "int32"),
    "one_shard_drops": (1, 99, [73], 40, "int32"),
    "wide_pytree": (4, 333, [333, 200, 1, 300], 70, "int32"),
}


@pytest.mark.parametrize("name", sorted(EXCHANGE_CASES))
def test_exchange_plain_equals_pack_all_to_all_compact(name):
    """Bit for bit: the received rows and their zero tails, each
    destination's count, each source's drops and sends."""
    n, cap_in, counts, capacity, how = EXCHANGE_CASES[name]
    rng = np.random.default_rng(sorted(EXCHANGE_CASES).index(name))
    leaves, cnts = _sources(rng, n, cap_in, counts, wide=name == "wide_pytree")
    capacity = capacity or cap_in
    keys = _keys(rng, how, n, cap_in)
    if how == "salted":
        dests = [port.salted_dest(k, n, 3) for k in keys]
        got = ex_mod.exchange(leaves, cnts, capacity, dests=dests)
    elif how == "partitioner":
        dests = [(k * 7 + 3) % n for k in keys]
        got = ex_mod.exchange(leaves, cnts, capacity, dests=dests)
    else:
        dests = [port.hash_keys(k) % n for k in keys]
        got = ex_mod.exchange(leaves, cnts, capacity, keys=keys)
    want = _pack_exchange(leaves, cnts, capacity, dests)
    assert len(got.leaves) == len(want.leaves)
    for g, w in zip(got.leaves, want.leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    for field in ("counts", "send_counts", "dropped"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype == torch.int32, field
        assert torch.equal(g, w), field
    if name == "capacity_drops":
        assert int(got.dropped.sum()) > 0


def test_shuffle_partition_takes_a_partitioner_as_destinations():
    """A partitioner other than hash_keys gives the same partitions as the
    destinations it computes."""
    rng = np.random.default_rng(7)
    n, cap_in = 3, 120
    leaves, cnts = _sources(rng, n, cap_in, [120, 60, 5], wide=True)
    parts = [make_partition(tuple(src), c) for src, c in zip(leaves, cnts)]
    keys = [src[0] for src in leaves]
    got = port.shuffle_partition(parts, keys, capacity=50,
                                 partitioner=lambda k: k * 5 - 1)
    want = _pack_exchange(leaves, cnts, 50, [(k * 5 - 1) % n for k in keys])
    for d, r in enumerate(got):
        for g, w in zip(ttree.leaves(r.part.records), want.leaves):
            assert torch.equal(g, w[d])
        assert torch.equal(r.part.count, want.counts[d])
        assert torch.equal(r.dropped, want.dropped[d])
        assert torch.equal(r.send_counts, want.send_counts[d])


def test_exchange_rejects_keys_and_destinations_together():
    k = [torch.zeros(4, dtype=torch.int32)]
    with pytest.raises(ValueError):
        ex_mod.exchange([[k[0]]], [torch.tensor(4)], 4, keys=k, dests=k)
    with pytest.raises(ValueError):
        ex_mod.exchange([[k[0]]], [torch.tensor(4)], 4)


def _mare_answers():
    from repro_torch.core import MaRe
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 40, 3000).astype(np.int32)
    vals = rng.integers(-100, 100, 3000).astype(np.int32)
    out = {}
    for combiner in (True, False):
        out[f"reduce_by_key combiner={combiner}"] = MaRe(
            (keys, vals), num_shards=4, device="cpu").reduce_by_key(
                lambda r: r[0], value_by=lambda r: (r[1],), op="sum",
                num_keys=40, combiner=combiner).collect()
    out["reduce_by_key salted"] = MaRe(
        (keys, vals), num_shards=4, device="cpu").reduce_by_key(
            lambda r: r[0], value_by=lambda r: (r[1],), op="sum",
            num_keys=40, combiner=False, salt=3).collect()
    out["repartition_by"] = MaRe(
        (keys, vals), num_shards=4, device="cpu").repartition_by(
            lambda r: r[0]).collect()
    return out


def test_mare_answers_unchanged_by_the_exchange(monkeypatch):
    """reduce_by_key (with and without the combiner, and salted) and
    repartition_by through MaRe give the answers they gave through the
    pack / all_to_all / compact."""
    got = _mare_answers()

    def packed(leaves, counts, capacity, keys=None, dests=None):
        n = len(leaves)
        if dests is None:
            dests = [port.hash_keys(k) % n for k in keys]
        return _pack_exchange(leaves, counts, capacity, dests)

    monkeypatch.setattr(port, "exchange", packed)
    want = _mare_answers()
    assert got.keys() == want.keys()
    for name in got:
        g, w = ttree.leaves(got[name]), ttree.leaves(want[name])
        assert len(g) == len(w) and len(g) > 0, name
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)
