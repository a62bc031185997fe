"""MoE dispatch slotting: the port's op (its plain version on the CPU)
against the reference's Pallas kernel in interpret mode and its oracle,
bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch_ref as R_dispatch_ref
from repro.kernels import moe_dispatch as R_moe_dispatch
from repro_torch.kernels.moe_dispatch import kernel as dmod
from repro_torch.kernels.moe_dispatch import dispatch_ref, moe_dispatch

RNG = np.random.default_rng(3)


@pytest.mark.parametrize("n,g,block", [
    (512, 8, 64), (1000, 32, 256), (77, 3, 16), (64, 64, 64), (256, 1, 64),
])
def test_dispatch_matches_reference_kernel(n, g, block):
    a = RNG.integers(0, g, size=n).astype(np.int32)
    rp, rc = R_moe_dispatch(jnp.asarray(a), g, block=block, interpret=True)
    before = dmod.LAUNCHES
    p, c = moe_dispatch(torch.from_numpy(a), g)
    assert dmod.LAUNCHES == before          # CPU: the plain version
    assert p.dtype == c.dtype == torch.int32
    np.testing.assert_array_equal(p.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))


def test_positions_are_slots():
    """Within each group the positions are exactly 0..count-1."""
    a = RNG.integers(0, 7, size=300).astype(np.int32)
    p, c = map(lambda t: t.numpy(), moe_dispatch(torch.from_numpy(a), 7))
    rp, rc = R_moe_dispatch(jnp.asarray(a), 7, block=32, interpret=True)
    np.testing.assert_array_equal(p, np.asarray(rp))
    for g in range(7):
        assert sorted(p[a == g].tolist()) == list(range(c[g]))


def test_ids_outside_the_groups_match_no_group():
    """Position 0 and counted nowhere, in the reference's kernel, its
    oracle and the port."""
    a = RNG.integers(-3, 9, size=200).astype(np.int32)
    rp, rc = R_moe_dispatch(jnp.asarray(a), 6, block=64, interpret=True)
    op, oc = R_dispatch_ref(jnp.asarray(a), 6)
    p, c = moe_dispatch(torch.from_numpy(a), 6)
    for want in ((rp, rc), (op, oc)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(c.numpy(), np.asarray(want[1]))
    assert int(c.sum()) == int(((a >= 0) & (a < 6)).sum())


def test_slots_invert_the_stable_sort():
    """offsets[a] + positions is the inverse of argsort(a, stable): what
    the MoE layer uses in place of the reference's argsort."""
    a = RNG.integers(0, 32, size=4096)
    p, c = moe_dispatch(torch.from_numpy(a), 32)      # int64 ids
    offsets = torch.cumsum(c, 0) - c
    slot = (offsets[torch.from_numpy(a)] + p).numpy()
    order = np.asarray(jnp.argsort(jnp.asarray(a), stable=True))
    np.testing.assert_array_equal(slot[order], np.arange(a.size))
    np.testing.assert_array_equal(c.numpy(),
                                  np.bincount(a, minlength=32))


def test_empty_and_bad_arguments():
    p, c = moe_dispatch(torch.zeros((0,), dtype=torch.int32), 4)
    assert p.shape == (0,) and torch.equal(c, torch.zeros(4,
                                                          dtype=torch.int32))
    with pytest.raises(ValueError, match="num_groups"):
        moe_dispatch(torch.zeros((3,), dtype=torch.int32), 0)
    with pytest.raises(ValueError, match=r"\[n\]"):
        dmod.moe_dispatch_kernel(torch.zeros((2, 3), dtype=torch.int32), 4)
    a = torch.tensor([2, 0, 2, 1, 2], dtype=torch.int32)
    p, c = dispatch_ref(a, 3)
    assert p.tolist() == [0, 0, 1, 0, 2] and c.tolist() == [1, 1, 3]
