"""Top-k selection: the port's op (its plain version on the CPU) against
the reference's Pallas kernel in interpret mode and its ``lax.top_k``
oracle — equal values and equal ordered indices — and the port's
``toolbox/topk`` image against the reference's on float scores, whole
buffers bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import container as R_c
from repro.kernels import topk_reduce as R_topk_reduce
from repro.kernels import topk_ref as R_topk_ref
from repro_torch.core import container as T_c
from repro_torch.kernels.topk_reduce import kernel as tmod
from repro_torch.kernels.topk_reduce import topk_reduce, topk_ref

RNG = np.random.default_rng(1)


def _same(got, want):
    v, i = got
    rv, ri = want
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


@pytest.mark.parametrize("n,k,vc,block", [
    (1000, 30, 1000, 128), (257, 10, 200, 64), (64, 5, 64, 8),
    (4096, 50, 4000, 1024), (100, 100, 100, 32),
])
def test_topk_matches_reference_kernel(n, k, vc, block):
    s = RNG.normal(size=n).astype(np.float32)
    want = R_topk_reduce(jnp.asarray(s), k, jnp.int32(vc), block=block,
                         interpret=True)
    before = tmod.LAUNCHES
    got = topk_reduce(torch.from_numpy(s), k, vc)
    assert tmod.LAUNCHES == before          # CPU: the plain version
    _same(got, want)
    _same(got, R_topk_ref(jnp.asarray(s), k, vc))


@pytest.mark.parametrize("block", [16, 1024])
def test_duplicates_go_to_the_earlier_index(block):
    s = np.repeat(np.float32([3.0, 1.0, 2.0]), 30)
    got = topk_reduce(torch.from_numpy(s), 40)
    assert got[1].tolist() == list(range(30)) + list(range(60, 70))
    _same(got, R_topk_reduce(jnp.asarray(s), 40, block=block,
                             interpret=True))
    r = np.round(RNG.normal(size=500), 1).astype(np.float32)
    _same(topk_reduce(torch.from_numpy(r), 60, 450),
          R_topk_ref(jnp.asarray(r), 60, 450))


@pytest.mark.parametrize("k,vc", [(30, 10), (30, 0), (64, 63), (64, 64)])
def test_k_past_valid_count_follows_lax_top_k(k, vc):
    """Past the valid entries: the earliest invalid ones, as -inf, in
    index order (the TPU kernel gives -1e30 / -1 there instead)."""
    s = RNG.normal(size=64).astype(np.float32)
    vct = torch.tensor(vc, dtype=torch.int32)
    got = topk_reduce(torch.from_numpy(s), k, vct)
    _same(got, R_topk_ref(jnp.asarray(s), k, vc))
    tail = got[1][vc:].tolist()
    assert tail == sorted(tail) and all(t >= vc for t in tail)
    assert bool(torch.isneginf(got[0][vc:]).all())


def test_k_equal_to_n_zero_and_too_large():
    s = RNG.normal(size=37).astype(np.float32)
    _same(topk_reduce(torch.from_numpy(s), 37),
          R_topk_ref(jnp.asarray(s), 37))
    v, i = topk_reduce(torch.from_numpy(s), 0)
    assert v.shape == i.shape == (0,)
    for fn in (topk_reduce, topk_ref):
        with pytest.raises(ValueError, match="k <= n"):
            fn(torch.from_numpy(s), 38)


# -- toolbox/topk on float scores ---------------------------------------------

@pytest.mark.parametrize("count", [4, 7, 19, 40])
def test_toolbox_topk_float_scores_match_reference(count):
    """count < k, = k, > k and a full partition, with ties in the
    scores: records and count bit for bit over the whole buffer."""
    rng = np.random.default_rng(count)
    scores = np.round(rng.normal(size=40), 1).astype(np.float32)
    ids = np.arange(40, dtype=np.int32)
    feats = rng.normal(size=(40, 3)).astype(np.float32)
    recs = (scores, ids, feats)
    r = R_c.pull("toolbox/topk", k=7)(R_c.make_partition(
        jax.tree.map(jnp.asarray, recs), count))
    p = T_c.pull("toolbox/topk", k=7)(T_c.make_partition(
        tuple(torch.from_numpy(x) for x in recs), count))
    for a, b in zip(jax.tree.leaves(r.records), p.records):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b.numpy(), a)
    assert int(p.count) == int(r.count) == min(count, 7)


def test_signed_zeros_and_nans_follow_lax_top_k():
    """lax.top_k orders the bits: -NaN < -inf < -0 < +0 < +inf < +NaN."""
    s = np.float32([-0.0, 0.0, 1.0, np.nan, -0.0, 0.0, -np.inf, -np.inf,
                    -np.nan, 2.0])
    for vc in (10, 6):
        _same(topk_reduce(torch.from_numpy(s), 10, vc),
              R_topk_ref(jnp.asarray(s), 10, vc))
