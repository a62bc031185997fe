"""The port's in-process mesh and collectives (``core/collectives.py``)
against numpy, over one axis and tuples of axes (in both orders), tiled
and not: each collective's result per shard equals the same operation on
the mesh laid out as a numpy array ``[*mesh_shape, *value_shape]``.
Integer-valued floats make every sum exact; a sum's order is checked
apart, on floats that round differently in another order.  Then the
gradient all-reduces of ``core/tree_reduce`` built on them."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import collectives as C
from repro_torch.core.tree_reduce import (broadcast_from_zero,
                                          fused_allreduce,
                                          hierarchical_allreduce,
                                          split_factors, tree_allreduce)

MESHES = [((8,), ("data",)), ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((3, 2), ("a", "b"))]


def _axis_names(axes):
    """Every axis alone, and every ordered tuple of two or more."""
    out = list(axes)
    for r in range(2, len(axes) + 1):
        out += list(itertools.permutations(axes, r))
    return out


def _cases():
    for shape, axes in MESHES:
        for name in _axis_names(axes):
            yield shape, axes, name


CASES = list(_cases())
IDS = [f"{s}-{a}-{n}" for s, a, n in CASES]


def _values(mesh, shape=(4, 6), seed=0):
    """Integer-valued f32 per shard, and the [*mesh, *shape] array."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(-50, 50, tuple(mesh.axis_sizes) + shape).astype(
        np.float32)
    flat = arr.reshape((mesh.size,) + shape)
    return [torch.from_numpy(flat[s].copy()) for s in range(mesh.size)], arr


def _grouped(arr, mesh, name):
    """arr with the named mesh dims moved last-but-value, flattened in
    the named order: [*other mesh dims, n, *value]."""
    axes = (name,) if isinstance(name, str) else tuple(name)
    pos = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in pos]
    k = len(mesh.axis_names)
    moved = np.transpose(arr, rest + pos + list(range(k, arr.ndim)))
    n = int(np.prod([mesh.axis_sizes[i] for i in pos]))
    return moved.reshape(moved.shape[:len(rest)] + (n,)
                         + moved.shape[len(rest) + len(pos):]), rest, pos


def _per_shard(mesh, name, fn):
    """fn(group values [n, *v], index) for each shard, from numpy."""
    out = []
    for s in range(mesh.size):
        c = mesh.coords(s)
        axes = (name,) if isinstance(name, str) else tuple(name)
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + c[a]
        out.append(fn(s, idx))
    return out


def _group_of(arr, mesh, name, s):
    g, rest, _ = _grouped(arr, mesh, name)
    c = mesh.coords(s)
    return g[tuple(c[mesh.axis_names[i]] for i in rest)]


@pytest.mark.parametrize("shape,axes,name", CASES, ids=IDS)
def test_axis_index_and_groups(shape, axes, name):
    mesh = C.Mesh(shape, axes)
    idx = C.axis_index(mesh, name)
    groups = C.groups(mesh, name)
    n = C.axis_size(mesh, name)
    assert sorted(s for g in groups for s in g) == list(range(mesh.size))
    for g in groups:
        assert [idx[s] for s in g] == list(range(n))
        others = [{a: v for a, v in mesh.coords(s).items()
                   if a not in ((name,) if isinstance(name, str) else name)}
                  for s in g]
        assert all(o == others[0] for o in others)


@pytest.mark.parametrize("shape,axes,name", CASES, ids=IDS)
def test_psum_pmean_all_gather_match_numpy(shape, axes, name):
    mesh = C.Mesh(shape, axes)
    xs, arr = _values(mesh)
    n = C.axis_size(mesh, name)
    got = C.psum(xs, mesh, name)
    mean = C.pmean(xs, mesh, name)
    for s in range(mesh.size):
        g = _group_of(arr, mesh, name, s)
        np.testing.assert_array_equal(got[s].numpy(), g.sum(0))
        np.testing.assert_array_equal(mean[s].numpy(),
                                      (g.sum(0) / np.float32(n)))
    for axis in (0, 1, 2):
        stacked = C.all_gather(xs, mesh, name, axis=axis)
        for s in range(mesh.size):
            g = _group_of(arr, mesh, name, s)
            np.testing.assert_array_equal(stacked[s].numpy(),
                                          np.stack(list(g), axis=axis))
    for axis in (0, 1):
        tiled = C.all_gather(xs, mesh, name, axis=axis, tiled=True)
        for s in range(mesh.size):
            g = _group_of(arr, mesh, name, s)
            np.testing.assert_array_equal(tiled[s].numpy(),
                                          np.concatenate(list(g), axis=axis))


@pytest.mark.parametrize("shape,axes,name", CASES, ids=IDS)
def test_psum_scatter_and_all_to_all_match_numpy(shape, axes, name):
    mesh = C.Mesh(shape, axes)
    n = C.axis_size(mesh, name)
    idx = C.axis_index(mesh, name)
    xs, arr = _values(mesh, shape=(n, 2 * n, 3))
    for dim in (0, 1):
        out = C.psum_scatter(xs, mesh, name, scatter_dimension=dim,
                             tiled=True)
        for s in range(mesh.size):
            total = _group_of(arr, mesh, name, s).sum(0)
            want = np.split(total, n, axis=dim)[idx[s]]
            np.testing.assert_array_equal(out[s].numpy(), want)
    out = C.psum_scatter(xs, mesh, name, scatter_dimension=0)
    for s in range(mesh.size):
        total = _group_of(arr, mesh, name, s).sum(0)
        np.testing.assert_array_equal(out[s].numpy(), total[idx[s]])
    for split, concat, tiled in [(0, 0, False), (0, 1, False),
                                 (0, 2, False), (1, 0, True),
                                 (1, 2, True), (0, 2, True)]:
        out = C.all_to_all(xs, mesh, name, split_axis=split,
                           concat_axis=concat, tiled=tiled)
        for s in range(mesh.size):
            g = _group_of(arr, mesh, name, s)            # [n, *value]
            parts = [(np.split(g[i], n, axis=split) if tiled else
                      [np.take(g[i], j, axis=split) for j in range(n)])
                     [idx[s]] for i in range(n)]
            want = (np.concatenate(parts, axis=concat) if tiled
                    else np.stack(parts, axis=concat))
            np.testing.assert_array_equal(out[s].numpy(), want)


@pytest.mark.parametrize("shape,axes,name", CASES, ids=IDS)
def test_ppermute_matches_numpy(shape, axes, name):
    mesh = C.Mesh(shape, axes)
    n = C.axis_size(mesh, name)
    idx = C.axis_index(mesh, name)
    xs, arr = _values(mesh)
    for perm in ([(i, (i + 1) % n) for i in range(n)],
                 [(i, i + 1) for i in range(n - 1)], [(n - 1, 0)]):
        out = C.ppermute(xs, mesh, name, perm)
        src = {d: s for s, d in perm}
        for s in range(mesh.size):
            g = _group_of(arr, mesh, name, s)
            want = g[src[idx[s]]] if idx[s] in src else np.zeros_like(g[0])
            np.testing.assert_array_equal(out[s].numpy(), want)
    with pytest.raises(ValueError):
        C.ppermute(xs, mesh, name, [(0, n)])
    with pytest.raises(ValueError):
        C.ppermute(xs, mesh, name, [(0, 0), (0, 0)])


def test_sums_add_in_index_order():
    """f32 values whose sum rounds differently in another order: psum
    and the tiled psum_scatter add member 0, 1, 2, ... in turn."""
    mesh = C.Mesh((2, 2), ("data", "model"))
    vals = [1e8, 1.0, -1e8, 1.0]
    xs = [torch.tensor([v], dtype=torch.float32) for v in vals]
    for name, order in ((("data", "model"), (0, 1, 2, 3)),
                        (("model", "data"), (0, 2, 1, 3))):
        acc = np.float32(vals[order[0]])
        for s in order[1:]:
            acc = np.float32(acc + np.float32(vals[s]))
        assert float(C.psum(xs, mesh, name)[0]) == float(acc), name
    # 1e8 + 1 rounds the 1 away; 1e8 + -1e8 keeps both ones
    assert float(C.psum(xs, mesh, ("data", "model"))[0]) == 1.0
    assert float(C.psum(xs, mesh, ("model", "data"))[0]) == 2.0


@pytest.mark.parametrize("shape,axes", MESHES)
def test_shard_unshard_round_trip(shape, axes):
    mesh = C.Mesh(shape, axes)
    x = torch.arange(24 * 96 * 4, dtype=torch.float32).reshape(24, 96, 4)
    specs = [(axes[0],), (None, axes[-1]), (tuple(axes),),
             (tuple(reversed(axes)), None, None)]
    for spec in specs:
        blocks = C.shard(x, mesh, spec)
        assert torch.equal(C.unshard(blocks, mesh, spec), x), spec
    with pytest.raises(ValueError):
        C.shard(torch.zeros(5, 3), mesh, (tuple(axes),))   # 5 indivisible
    with pytest.raises(ValueError):
        C.shard(x, mesh, (axes[0], axes[0]))              # axis used twice


def test_unshard_takes_index_zero_over_unnamed_axes():
    mesh = C.Mesh((2, 3), ("data", "model"))
    xs = [torch.full((2,), float(s)) for s in range(6)]
    out = C.unshard(xs, mesh, ("data",))
    assert out.tolist() == [0.0, 0.0, 3.0, 3.0]


def test_pytrees_and_shard_count_checked():
    mesh = C.Mesh((4,), ("data",))
    xs = [{"a": torch.tensor([float(s)]), "b": (torch.tensor([1.0]),)}
          for s in range(4)]
    out = C.psum(xs, mesh, "data")
    assert float(out[3]["a"]) == 6.0 and float(out[0]["b"][0]) == 4.0
    with pytest.raises(ValueError):
        C.psum(xs[:3], mesh, "data")
    with pytest.raises(ValueError):
        C.psum(xs, mesh, "model")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_tree_allreduce_equals_psum_on_every_shard(n, depth):
    """The K-level tree over n shards: every shard ends with the exact
    sum (integers), whatever the non-leaders carried; in f32 the sum
    adds as the levels do."""
    mesh = C.Mesh((n,), ("data",))
    xs, arr = _values(mesh, shape=(3,), seed=n)
    trees = [{"w": x, "b": (x * 2,)} for x in xs]
    out = tree_allreduce(trees, mesh, "data", depth=depth)
    want = arr.sum(0)
    for s in range(n):
        np.testing.assert_array_equal(out[s]["w"].numpy(), want)
        np.testing.assert_array_equal(out[s]["b"][0].numpy(), 2 * want)
    # the levels' order: group sums first, then across groups
    vals = np.random.default_rng(n).normal(size=n).astype(np.float32) * 1e4
    got = tree_allreduce([torch.tensor(v) for v in vals], mesh, "data",
                         depth=depth)[0]
    level = list(vals)
    stride = 1
    for g in split_factors(n, depth):
        for lead in range(0, n, stride * g):
            for j in range(1, g):
                level[lead] = np.float32(level[lead]
                                         + level[lead + j * stride])
        stride *= g
    assert float(got) == float(level[0])


def test_tree_allreduce_over_an_axis_of_a_larger_mesh():
    mesh = C.Mesh((2, 4), ("pod", "data"))
    xs, arr = _values(mesh)
    out = tree_allreduce(xs, mesh, "data", depth=2)
    fused = fused_allreduce(xs, mesh, "data")
    for s in range(mesh.size):
        np.testing.assert_array_equal(out[s].numpy(),
                                      arr[mesh.coords(s)["pod"]].sum(0))
        assert torch.equal(out[s], fused[s])
    both = hierarchical_allreduce(xs, mesh, "data", "pod")
    for s in range(mesh.size):
        np.testing.assert_array_equal(both[s].numpy(), arr.sum((0, 1)))


def test_broadcast_from_zero():
    mesh = C.Mesh((2, 5), ("pod", "data"))
    xs = [torch.tensor([float(s)]) for s in range(10)]
    out = broadcast_from_zero(xs, mesh, "data")
    assert [float(x) for x in out] == [0.0] * 5 + [5.0] * 5
    assert [float(x) for x in broadcast_from_zero(xs[:7])] == [0.0] * 7
