"""Meshes (the reference's ``launch/mesh.py``).

A mesh of the port is logical: its shards run one after another on the
device their values lie on (``core/collectives.py``), so building one
needs no device count and names no device.  The reference's
``make_production_mesh`` raises when the process has fewer devices than
the mesh has shards; the port's builds the mesh anywhere."""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.collectives import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) data x model single pod; (2, 16, 16) pod x data x model
    for the 2-pod = 512-shard configuration."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over ``axes``."""
    return Mesh(tuple(int(s) for s in shape), tuple(axes))
