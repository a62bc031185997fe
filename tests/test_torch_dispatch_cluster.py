"""The dispatch kernel's cluster route as algebra: ``dispatch_cluster_ref``
(rank within each of ``blocks`` contiguous slices, then add the earlier
slices' counts) against the reference's Pallas kernel in interpret mode
and its oracle, and against the port's plain version, bit for bit, over
slice counts 1, 2, 8 and 16 and sizes they do not divide."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch_ref as R_dispatch_ref
from repro.kernels import moe_dispatch as R_moe_dispatch
from repro_torch.kernels.moe_dispatch import dispatch_ref
from repro_torch.kernels.moe_dispatch import kernel as dmod
from repro_torch.kernels.moe_dispatch.ref import dispatch_cluster_ref

BLOCKS = [1, 2, 8, 16]
SIZES = [
    # n, groups, lowest id, highest id + 1
    (1, 4, 0, 4),
    (33, 32, 0, 32),          # a decode step's ids and one more
    (77, 3, 0, 3),
    (1000, 32, 0, 32),
    (2049, 8, -2, 10),        # ids outside [0, G)
    (4097, 64, 0, 64),
]


def _same(got, want):
    p, c = got
    assert p.dtype == c.dtype == torch.int32
    np.testing.assert_array_equal(p.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(c.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("n,g,lo,hi", SIZES)
def test_cluster_algebra_matches_reference_kernel(n, g, lo, hi, blocks):
    rng = np.random.default_rng(n * 31 + blocks)
    a = rng.integers(lo, hi, size=n).astype(np.int32)
    got = dispatch_cluster_ref(torch.from_numpy(a), g, blocks)
    _same(got, R_moe_dispatch(jnp.asarray(a), g, block=64, interpret=True))
    _same(got, R_dispatch_ref(jnp.asarray(a), g))
    _same(got, dispatch_ref(torch.from_numpy(a), g))


@pytest.mark.parametrize("blocks", BLOCKS)
def test_one_hot_group_across_every_slice(blocks):
    """Every id in one group: each slice's ranks run on from the earlier
    slices' counts."""
    a = np.full(1000, 5, dtype=np.int32)
    p, c = dispatch_cluster_ref(torch.from_numpy(a), 8, blocks)
    assert p.tolist() == list(range(1000))
    assert c.tolist() == [0] * 5 + [1000, 0, 0]
    _same((p, c), R_moe_dispatch(jnp.asarray(a), 8, block=128,
                                 interpret=True))


@pytest.mark.parametrize("blocks", [1, 16])
def test_more_slices_than_ids_and_no_ids(blocks):
    for n in (0, 3):
        a = torch.arange(n, dtype=torch.int32) % 2
        p, c = dispatch_cluster_ref(a, 2, blocks)
        _same((p, c), dispatch_ref(a, 2))
    with pytest.raises(ValueError, match="blocks"):
        dispatch_cluster_ref(torch.zeros(3, dtype=torch.int32), 2, 0)


def test_cluster_algebra_on_the_prefill_shape():
    """granite's prefill: 4 x 2048 tokens x top-8 over 32 experts, in the
    widest cluster's 16 slices, against the port's plain version (the
    interpret-mode kernel at this size is the other tests' job); no
    launch counter moves on the CPU."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(0, 32, size=65536).astype(np.int32))
    before = (dmod.LAUNCHES, dict(dmod.LAUNCHES_BY_ROUTE))
    _same(dispatch_cluster_ref(a, 32, 16), dispatch_ref(a, 32))
    _same(dmod.moe_dispatch_kernel(a, 32), dispatch_ref(a, 32))
    assert (dmod.LAUNCHES, dmod.LAUNCHES_BY_ROUTE) == before
