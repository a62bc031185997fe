"""Elastic rescale: resume a run on a different mesh (N -> M data shards),
the reference's ``checkpoint/elastic.py``.

Checkpoints are mesh-agnostic host arrays (``manager.py``), so rescaling
is rebuilding shardings for the new mesh.  This module adds the policy:
each parameter's spec from its logical axes, checked for divisibility.
A mesh of the port keeps every shard on one device
(``core/collectives.py``), so a sharding moves no bytes: it records
which block of a tensor each shard would own, and :func:`rescale`
restores through the manager, in place, and returns the state beside its
new shardings (the reference returns arrays that carry theirs).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import collectives
from repro_torch.core.collectives import Mesh
from repro_torch.optim.base import named_tree
from repro_torch.sharding import P, Rules


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout over a mesh: ``spec`` names the mesh axes each
    leading dim is split over (``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: P

    def check(self, shape: Sequence[int]) -> None:
        """Raise unless every split dim divides over its mesh axes."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} is longer than the shape "
                             f"{tuple(shape)}")
        for dim, entry in zip(shape, self.spec):
            if entry is not None and \
                    dim % collectives.axis_size(self.mesh, entry):
                raise ValueError(f"shape {tuple(shape)} does not split by "
                                 f"{self.spec} over {self.mesh.shape}")


def shardings_for(tree_axes: Any, mesh: Mesh, rules: Rules) -> Any:
    """Map a logical-axes tree (nested dicts whose leaves are tuples of
    names) to NamedShardings."""
    if isinstance(tree_axes, dict):
        return {k: shardings_for(v, mesh, rules)
                for k, v in tree_axes.items()}
    return NamedSharding(mesh, rules.spec_for(tuple(tree_axes)))


def _axes_of(logical_axes: Any, name: str) -> Tuple[Any, ...]:
    """A parameter's axes by dotted name (``blocks.3.attn.wq``): the
    reference's stacked leaf's axes without the leading ``"layers"`` its
    stack indices stand for."""
    parts = name.split(".")
    node = logical_axes
    for p in parts:
        if not p.isdigit():
            node = node[p]
    n_idx = sum(p.isdigit() for p in parts)
    axes = tuple(node)
    if any(a != "layers" for a in axes[:n_idx]):
        raise ValueError(f"{name}: axes {axes} do not lead with "
                         f"{n_idx} 'layers'")
    return axes[n_idx:]


def shardings_for_params(params: Any, logical_axes: Any, mesh: Mesh,
                         rules: Rules) -> Dict[str, NamedSharding]:
    """Divisibility-aware: each parameter's sharding by dotted name, from
    its axes in ``logical_axes`` (``Model.logical_axes()``) and its
    shape."""
    out = {}
    for name, leaf in named_tree(params).items():
        sh = NamedSharding(mesh, rules.spec_for(_axes_of(logical_axes, name),
                                                dims=leaf.shape))
        sh.check(leaf.shape)
        out[name] = sh
    return out


def rescale(manager: CheckpointManager, state_like: Any,
            new_mesh: Mesh, rules: Rules,
            logical_axes: Optional[Any] = None,
            step: Optional[int] = None
            ) -> Tuple[Any, Dict[str, NamedSharding]]:
    """Restore the latest checkpoint (or ``step``) into ``state_like``
    for ``new_mesh``: (the state, its parameters' shardings by dotted
    name).  With ``logical_axes`` the parameters get FSDP/TP shardings;
    otherwise, and for everything outside the parameters, replicated."""
    state = manager.restore(state_like, step=step)
    if logical_axes is not None:
        return state, shardings_for_params(state.params, logical_axes,
                                           new_mesh, rules)
    return state, {name: NamedSharding(new_mesh, P())
                   for name in named_tree(state.params)}
