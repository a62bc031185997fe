"""A device mesh and its collectives, in one process on one device.

The reference runs its multi-device code under ``shard_map`` over a
``jax.sharding.Mesh`` and exchanges values with ``jax.lax`` collectives.
The port keeps every shard of a mesh on one device, as it keeps MaRe's
logical shards (``core/dataset.py``): a :class:`Mesh` is a shape and
its axis names, and its shards are numbered row-major over the axes.  A
shard body runs once per shard, one after another, on the device its
values lie on (a collective moves no value between devices, so a mesh
names none); a value "on the mesh" is a list with one entry (a tensor or
a pytree of tensors) per shard, in shard order.

A collective over one axis name, or over a tuple of them, acts within
each group of shards that agree on every other axis.  Within a group a
shard's index is its row-major position over the named axes, in the
order they are named (``lax.axis_index`` of the same axes).  Every
collective is an exact gather, permutation or ordered sum of the
per-shard values: a sum adds in group order, so a result never depends
on timing.  Members of a group that receive the same value share one
tensor; treat results as read-only.

Under a work counter (:mod:`repro_torch.launch.hlo_cost`) each
collective reports one shard's result bytes under the reference's op
name (``all-reduce``, ``all-gather``, ``reduce-scatter``,
``all-to-all``, ``collective-permute``), its ring over the mesh's
largest axis, and every shard's operand and result bytes as memory
traffic, as the reference's HLO walk counts a collective; where the
gradient runs through it, its transpose (an all-gather's is a
reduce-scatter) reports itself alike.  The copies and adds that stand in
for the exchange here are not counted again, nor are :func:`unshard`'s
copies (the layout a ``shard_map`` assembles).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import tree
from repro_torch.launch import hlo_cost

AxisName = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axis_sizes`` over ``axis_names``."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.axis_sizes} and axes "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} repeat a name")
        if any(int(s) < 1 for s in self.axis_sizes):
            raise ValueError(f"mesh shape {self.axis_sizes} has an empty "
                             f"axis")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    def coords(self, shard: int) -> Dict[str, int]:
        """Shard ``shard``'s position on every axis (row-major)."""
        out = {}
        for name, size in reversed(list(zip(self.axis_names,
                                             self.axis_sizes))):
            out[name] = shard % size
            shard //= size
        return {a: out[a] for a in self.axis_names}

    def shard_at(self, coords: Dict[str, int]) -> int:
        """The shard at ``coords`` (every axis named)."""
        s = 0
        for name, size in zip(self.axis_names, self.axis_sizes):
            s = s * size + coords[name]
        return s

    def submesh(self, axes: Sequence[str]) -> "Mesh":
        """The mesh of ``axes`` alone, in this mesh's axis order."""
        keep = [a for a in self.axis_names if a in axes]
        return Mesh(tuple(self.shape[a] for a in keep), tuple(keep))


#: The axis of MaRe's logical shards (``core/dataset.py``) when a list of
#: per-shard values is exchanged as a one-axis mesh.
SHARDS_AXIS = "shards"


def shards_mesh(n: int) -> Mesh:
    """The one-axis mesh of ``n`` logical shards."""
    return Mesh((n,), (SHARDS_AXIS,))


def _axes(mesh: Mesh, axis_name: AxisName) -> Tuple[str, ...]:
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"axis {a!r} is not one of the mesh's "
                             f"{mesh.axis_names}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes} repeat a name")
    return axes


def axis_size(mesh: Mesh, axis_name: AxisName) -> int:
    n = 1
    for a in _axes(mesh, axis_name):
        n *= mesh.shape[a]
    return n


def axis_index(mesh: Mesh, axis_name: AxisName) -> List[int]:
    """Each shard's index within its group over ``axis_name``."""
    axes = _axes(mesh, axis_name)
    out = []
    for s in range(mesh.size):
        c = mesh.coords(s)
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + c[a]
        out.append(i)
    return out


def groups(mesh: Mesh, axis_name: AxisName) -> List[List[int]]:
    """The groups of ``axis_name``: each a list of shards in index order,
    the groups in order of their first shard."""
    axes = _axes(mesh, axis_name)
    rest = [a for a in mesh.axis_names if a not in axes]
    out = []
    for fixed in itertools.product(*(range(mesh.shape[a]) for a in rest)):
        base = dict(zip(rest, fixed))
        members = []
        for pos in itertools.product(*(range(mesh.shape[a]) for a in axes)):
            members.append(mesh.shard_at({**base, **dict(zip(axes, pos))}))
        out.append(members)
    return sorted(out)


def _check(xs: Sequence[Any], mesh: Mesh) -> None:
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} values for a mesh of {mesh.size} "
                         f"shards")


def _leafwise(fn: Callable[[List[torch.Tensor]], List[torch.Tensor]],
              xs: Sequence[Any]) -> List[Any]:
    """Apply ``fn`` (a list of one leaf over the shards -> a list) at
    every leaf position of the shards' pytrees."""
    flat = [tree.flatten(x) for x in xs]
    treedef = flat[0][1]
    if any(d != treedef for _, d in flat):
        raise ValueError("shards' values differ in structure")
    cols = [fn([f[0][i] for f in flat]) for i in range(len(flat[0][0]))]
    return [tree.unflatten(treedef, [c[s] for c in cols])
            for s in range(len(xs))]


def _per_group(mesh: Mesh, axis_name: AxisName, xs: Sequence[Any],
               fn: Callable[[List[torch.Tensor]], List[torch.Tensor]]
               ) -> List[Any]:
    """``fn`` over each group's leaves (in index order) -> the members'
    results, leaf by leaf."""
    _check(xs, mesh)
    gs = groups(mesh, axis_name)

    def col(leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for g in gs:
            for s, r in zip(g, fn([leaves[s] for s in g])):
                out[s] = r
        return out

    return _leafwise(col, xs)


def _ordered_sum(leaves: List[torch.Tensor]) -> torch.Tensor:
    acc = leaves[0]
    for x in leaves[1:]:
        acc = acc + x
    return acc


def _leaf_bytes(x: Any) -> int:
    """Bytes a shard's value holds (a received zero block in full)."""
    return sum(t.numel() * t.element_size() for t in tree.flatten(x)[0]
               if isinstance(t, torch.Tensor))


#: The collective a collective's gradient is.
_TRANSPOSE = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter",
              "reduce-scatter": "all-gather", "all-to-all": "all-to-all",
              "collective-permute": "collective-permute"}


def _collective(op: str, mesh: Mesh, axis_name: AxisName,
                xs: Sequence[Any],
                fn: Callable[[List[torch.Tensor]], List[torch.Tensor]]
                ) -> List[Any]:
    """``_per_group`` of ``fn``, reported to the active work counter as
    one ``op``, and its gradient as the transposed collective (see the
    module's docstring)."""
    if hlo_cost.active() is None:
        return _per_group(mesh, axis_name, xs, fn)
    ring = max(mesh.axis_sizes)
    traffic = [sum(_leaf_bytes(x) for x in xs)]

    def backward():     # the gradient's result on a shard is x's shape
        hlo_cost.report_collective(_TRANSPOSE[op], _leaf_bytes(xs[0]),
                                   ring, traffic[0])

    with hlo_cost.stand_in(backward):
        out = _per_group(mesh, axis_name, xs, fn)
    traffic[0] += sum(_leaf_bytes(y) for y in out)
    hlo_cost.report_collective(op, _leaf_bytes(out[0]), ring, traffic[0])
    return out


def psum(xs: Sequence[Any], mesh: Mesh, axis_name: AxisName) -> List[Any]:
    """``lax.psum``: each group's sum, added in index order."""
    return _collective("all-reduce", mesh, axis_name, xs,
                       lambda g: [_ordered_sum(g)] * len(g))


def pmean(xs: Sequence[Any], mesh: Mesh, axis_name: AxisName) -> List[Any]:
    """``lax.pmean``: each group's ordered sum over its size."""
    return _collective("all-reduce", mesh, axis_name, xs,
                       lambda g: [_ordered_sum(g) / len(g)] * len(g))


def all_gather(xs: Sequence[Any], mesh: Mesh, axis_name: AxisName,
               axis: int = 0, tiled: bool = False) -> List[Any]:
    """``lax.all_gather``: each group's values stacked on a new dim
    ``axis`` in index order, or with ``tiled`` concatenated along it."""
    def gather(g):
        out = torch.cat(g, dim=axis) if tiled else torch.stack(g, dim=axis)
        return [out] * len(g)
    return _collective("all-gather", mesh, axis_name, xs, gather)


def _chunks(x: torch.Tensor, n: int, dim: int, tiled: bool
            ) -> List[torch.Tensor]:
    size = x.shape[dim]
    if tiled:
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split "
                             f"into {n}")
        return list(torch.split(x, size // n, dim=dim))
    if size != n:
        raise ValueError(f"dim {dim} has size {size}, the group {n}")
    return list(torch.unbind(x, dim=dim))


def psum_scatter(xs: Sequence[Any], mesh: Mesh, axis_name: AxisName,
                 scatter_dimension: int = 0,
                 tiled: bool = False) -> List[Any]:
    """``lax.psum_scatter``: each group's ordered sum, member ``j`` keeping
    block ``j`` along ``scatter_dimension`` (with ``tiled`` a slice of
    size/n, else index ``j`` of a dimension of the group's size)."""
    def scatter(g):
        return _chunks(_ordered_sum(g), len(g), scatter_dimension, tiled)
    return _collective("reduce-scatter", mesh, axis_name, xs, scatter)


def all_to_all(xs: Sequence[Any], mesh: Mesh, axis_name: AxisName,
               split_axis: int = 0, concat_axis: int = 0,
               tiled: bool = False) -> List[Any]:
    """``lax.all_to_all``: member ``i`` splits its value into n blocks
    along ``split_axis`` and sends block ``j`` to member ``j``, which
    stacks what it receives on a new dim ``concat_axis`` in source order
    (with ``tiled``: concatenates along ``concat_axis``).  At
    ``split_axis == concat_axis == 0`` without ``tiled`` the whole group
    is one transpose of its stacked values."""
    def exchange(g):
        n = len(g)
        if not tiled and split_axis == 0 and concat_axis == 0:
            if any(x.shape[0] != n for x in g):
                raise ValueError(f"dim 0 must have the group's size {n}")
            return list(torch.stack(g).transpose(0, 1).contiguous())
        parts = [_chunks(x, n, split_axis, tiled) for x in g]
        join = torch.cat if tiled else torch.stack
        return [join([parts[i][j] for i in range(n)], dim=concat_axis)
                for j in range(n)]
    return _collective("all-to-all", mesh, axis_name, xs, exchange)


def _zeros(x: torch.Tensor) -> torch.Tensor:
    """Zeros of ``x``'s shape as a broadcast view: no memory."""
    return x.new_zeros(()).expand(x.shape)


def ppermute(xs: Sequence[Any], mesh: Mesh, axis_name: AxisName,
             perm: Sequence[Tuple[int, int]]) -> List[Any]:
    """``lax.ppermute``: within each group, member ``dst`` receives the
    value of member ``src`` for every ``(src, dst)`` pair; a member that
    receives nothing holds zeros (a read-only broadcast view)."""
    perm = [(int(s), int(d)) for s, d in perm]
    if len({d for _, d in perm}) != len(perm) or \
            len({s for s, _ in perm}) != len(perm):
        raise ValueError(f"ppermute pairs {perm} repeat a source or a "
                         f"destination")

    def move(g):
        n = len(g)
        if any(not (0 <= s < n and 0 <= d < n) for s, d in perm):
            raise ValueError(f"ppermute pairs {perm} leave a group of {n}")
        out = [_zeros(x) for x in g]
        for s, d in perm:
            out[d] = g[s]
        return out
    return _collective("collective-permute", mesh, axis_name, xs, move)


# ---------------------------------------------------------------------------
# Blocks of a global tensor under a partition spec
# ---------------------------------------------------------------------------

def _dim_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(x: torch.Tensor, mesh: Mesh, spec: Sequence[Any],
           shard: int) -> torch.Tensor:
    c = mesh.coords(shard)
    out = x
    for dim, entry in enumerate(spec):
        axes = _dim_axes(entry)
        if not axes:
            continue
        n, i = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + c[a]
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split "
                             f"over {axes} ({n})")
        out = out.narrow(dim, i * (size // n), size // n)
    return out


def _check_spec(x_dim: int, mesh: Mesh, spec: Sequence[Any]) -> None:
    if len(spec) > x_dim:
        raise ValueError(f"spec {tuple(spec)} is longer than the rank "
                         f"{x_dim}")
    used = [a for e in spec for a in _dim_axes(e)]
    _axes(mesh, tuple(used))


def shard(x: torch.Tensor, mesh: Mesh, spec: Sequence[Any]
          ) -> List[torch.Tensor]:
    """Each shard's block of ``x`` under ``spec`` (one entry per leading
    dim: None, a mesh axis or a tuple of them), as views: what
    ``shard_map``'s ``in_specs`` hands each shard."""
    _check_spec(x.dim(), mesh, spec)
    return [_block(x, mesh, spec, s) for s in range(mesh.size)]


def unshard(xs: Sequence[torch.Tensor], mesh: Mesh, spec: Sequence[Any]
            ) -> torch.Tensor:
    """The global tensor whose blocks under ``spec`` are ``xs``: what
    ``shard_map``'s ``out_specs`` assembles.  Over a mesh axis ``spec``
    does not name the shards are taken to agree, and the one at index 0
    on it gives the block (the reference's unchecked replication)."""
    _check(xs, mesh)
    _check_spec(xs[0].dim(), mesh, spec)
    used = {a for e in spec for a in _dim_axes(e)}
    free = [a for a in mesh.axis_names if a not in used]
    shape = list(xs[0].shape)
    for dim, entry in enumerate(spec):
        for a in _dim_axes(entry):
            shape[dim] *= mesh.shape[a]
    out = xs[0].new_empty(shape)
    with hlo_cost.uncounted():
        for s in range(mesh.size):
            if any(mesh.coords(s)[a] for a in free):
                continue
            _block(out, mesh, spec, s).copy_(xs[s])
    return out
