"""The top-k kernel's select route as algebra: ``topk_select_ref`` (the k
best of each of ``slices`` contiguous slices by the composite key, then
the k best of their union) against the reference's Pallas kernel in
interpret mode, its ``lax.top_k`` oracle and the port's plain version,
bit for bit, over slice counts 1, 2, 8 and 16, sizes they do not divide,
k in {1, 30, 32}, ties, signed zeros, NaNs, -inf, k past valid_count and
valid_count 0.

The TPU kernel gives -1e30 and index -1 where k > valid_count (its
initial buffer comes first among its candidates), and orders signed
zeros and NaNs by ``jnp.max``; there the reference's own oracle,
``lax.top_k`` on the masked scores, is the one the port follows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import topk_reduce as R_topk_reduce
from repro.kernels import topk_ref as R_topk_ref
from repro_torch.kernels.topk_reduce import kernel as tmod
from repro_torch.kernels.topk_reduce import topk_ref
from repro_torch.kernels.topk_reduce.ref import topk_select_ref

SLICES = [1, 2, 8, 16]


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _same(got, want):
    v, i = got
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(_bits(v.numpy()), _bits(want[0]))
    np.testing.assert_array_equal(i.numpy(), np.asarray(want[1]))


def _scores(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=n).astype(np.float32)
    if kind == "ties":
        return (np.round(rng.normal(size=n) * 2) / 2).astype(np.float32)
    if kind == "ascending":
        return np.arange(n, dtype=np.float32)
    if kind == "equal":
        return np.full(n, 0.25, dtype=np.float32)
    # signed zeros, NaNs of both signs, -inf and +inf among ties
    x = (np.round(rng.normal(size=n)) / 2).astype(np.float32)
    bits = x.view(np.int32)
    bits[rng.random(n) < 0.05] = 0x7FC00000           # +NaN
    bits[rng.random(n) < 0.05] = -0x00400000          # -NaN (0xFFC00000)
    x[rng.random(n) < 0.1] = -0.0
    x[rng.random(n) < 0.1] = 0.0
    x[rng.random(n) < 0.05] = -np.inf
    x[rng.random(n) < 0.01] = np.inf
    return x


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize("n,k,kind", [
    (1000, 30, "normal"), (4097, 32, "normal"), (257, 1, "normal"),
    (2049, 30, "ties"), (60, 30, "normal"), (120, 30, "ties"),
    (500, 32, "ascending"),
])
def test_select_algebra_matches_reference_kernel(n, k, kind, slices):
    """Finite scores, k <= valid_count: the TPU kernel's own case."""
    s = _scores(kind, n, n + k)
    vc = n - 7 if n > 100 else n
    got = topk_select_ref(torch.from_numpy(s), k, vc, slices)
    _same(got, R_topk_reduce(jnp.asarray(s), k, jnp.int32(vc), block=256,
                             interpret=True))
    _same(got, R_topk_ref(jnp.asarray(s), k, vc))
    _same(got, topk_ref(torch.from_numpy(s), k, vc))


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize("kind", ["special", "equal", "ties"])
@pytest.mark.parametrize("k", [1, 30, 32])
def test_select_algebra_follows_lax_top_k_order(kind, k, slices):
    """Signed zeros, NaNs, -inf and ties: the bits' total order, ties to
    the earlier index, as ``lax.top_k``."""
    n = 1003
    s = _scores(kind, n, 5 * k + slices)
    got = topk_select_ref(torch.from_numpy(s), k, n, slices)
    _same(got, R_topk_ref(jnp.asarray(s), k, n))
    _same(got, topk_ref(torch.from_numpy(s), k, n))


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize("k,vc", [(30, 10), (32, 0), (1, 0), (30, 29),
                                  (32, 31)])
def test_select_algebra_past_valid_count(k, vc, slices):
    """Past the valid entries: the earliest invalid ones, as -inf, in index
    order (the TPU kernel gives -1e30 / -1 there instead)."""
    s = _scores("special", 300, vc + slices)
    got = topk_select_ref(torch.from_numpy(s), k, torch.tensor(vc), slices)
    _same(got, R_topk_ref(jnp.asarray(s), k, vc))
    _same(got, topk_ref(torch.from_numpy(s), k, vc))
    tail = got[1][vc:].tolist()
    if vc < k:
        assert bool(torch.isneginf(got[0][vc:]).all())
        assert tail == sorted(tail) and all(t >= vc for t in tail)


@pytest.mark.parametrize("slices", [1, 16])
def test_select_algebra_small_and_bad_arguments(slices):
    for n, k in ((1, 1), (5, 5), (32, 32), (17, 0)):
        s = _scores("normal", n, n)
        _same(topk_select_ref(torch.from_numpy(s), k, None, slices),
              topk_ref(torch.from_numpy(s), k))
    with pytest.raises(ValueError, match="slices"):
        topk_select_ref(torch.zeros(4), 2, None, 0)
    with pytest.raises(ValueError, match="k <= n"):
        topk_select_ref(torch.zeros(4), 5, None, slices)


def test_select_algebra_on_a_shard_and_no_counter_moves():
    """A VS shard's 262,144 scores, k = 30, in 128 slices (the select
    route's blocks there) against the port's plain version; the wrapper's
    CPU path moves no launch counter."""
    s = torch.from_numpy(_scores("normal", 262144, 3))
    before = (tmod.LAUNCHES, dict(tmod.LAUNCHES_BY_ROUTE))
    _same(topk_select_ref(s, 30, 262000, 128), topk_ref(s, 30, 262000))
    _same(tmod.topk_reduce_kernel(s, 30, 262000), topk_ref(s, 30, 262000))
    assert (tmod.LAUNCHES, tmod.LAUNCHES_BY_ROUTE) == before
