"""The tree all-reduce's napkin math in the port
(``core/tree_reduce.collective_bytes_tree`` beside ``split_factors``)
against the reference's: the reference's ``tests/test_core.py`` case and
the same bytes over a grid of sizes, shard counts and depths (integer
arithmetic: equal, not close)."""
import pytest

from repro.core.tree_reduce import collective_bytes_tree as R_bytes
from repro.core.tree_reduce import split_factors as R_split
from repro_torch.core.tree_reduce import (collective_bytes_tree,
                                          split_factors)


def test_collective_bytes_tree_monotone():
    """Deeper trees never ship more bytes per level-sum than depth-1
    (the paper's motivation for K>1 when partitions are large)."""
    b1 = collective_bytes_tree(1000, 16, depth=1)
    b2 = collective_bytes_tree(1000, 16, depth=2)
    assert b2 <= b1


@pytest.mark.parametrize("shards", [1, 2, 3, 6, 8, 12, 16, 64, 256])
def test_collective_bytes_tree_equals_reference(shards):
    for depth in (1, 2, 3, 4):
        for nbytes in (1, 1000, 4 << 20):
            assert collective_bytes_tree(nbytes, shards, depth) == \
                R_bytes(nbytes, shards, depth), (nbytes, shards, depth)
        assert split_factors(shards, depth) == R_split(shards, depth)
