"""Logical-axis sharding rules: DP / FSDP / TP / EP / SP per (arch, shape)
— the reference's ``sharding/specs.py``.

Tensors are annotated with *logical* axis names ("embed", "heads", "ff",
"experts", "batch", "seq", ...).  A :class:`Rules` object maps logical
axes to mesh axes, refusing any mapping that does not divide the
dimension (25 hymba heads never shard over a 16-way model axis: the rule
degrades to replication) and using each mesh axis at most once a spec.

Activated via a context manager, so model code stays annotation-only:

    with use_rules(rules, mesh):
        logits = model.prefill(params, batch, max_len)

Under an active mesh the MoE FFN takes its expert-parallel path and a
hybrid prefill with ``cfg.ssm_cp`` its context-parallel SSM block.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.collectives import Mesh

MeshAxes = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry per leading dimension, each None, a
    mesh axis or a tuple of mesh axes (``jax.sharding.PartitionSpec`` as
    a plain tuple)."""

    def __new__(cls, *parts: MeshAxes) -> "P":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis name -> mesh axis (or tuple of mesh axes)."""

    table: Dict[str, MeshAxes]
    mesh_shape: Dict[str, int]

    def mesh_size(self, mesh_axes: MeshAxes) -> int:
        if mesh_axes is None:
            return 1
        if isinstance(mesh_axes, str):
            return self.mesh_shape.get(mesh_axes, 1)
        out = 1
        for a in mesh_axes:
            out *= self.mesh_shape.get(a, 1)
        return out

    def spec_for(self, logical: Sequence[Optional[str]],
                 dims: Optional[Sequence[int]] = None) -> P:
        """PartitionSpec for a tensor with the given logical axes.

        If ``dims`` is given, any mapping that does not evenly divide the
        dimension is dropped (replication) — divisibility-safe TP.
        Duplicate mesh axes across dims are dropped (a mesh axis may be
        used once per spec)."""
        used: set = set()
        out = []
        for i, name in enumerate(logical):
            axes = self.table.get(name) if name else None
            if axes is None:
                out.append(None)
                continue
            ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
            ax_tuple = tuple(a for a in ax_tuple if a not in used)
            if not ax_tuple:
                out.append(None)
                continue
            size = self.mesh_size(ax_tuple)
            if dims is not None and dims[i] % size != 0:
                out.append(None)
                continue
            used.update(ax_tuple)
            out.append(ax_tuple[0] if len(ax_tuple) == 1 else ax_tuple)
        return P(*out)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules], mesh: Optional[Mesh] = None):
    tok = _ACTIVE.set((rules, mesh))
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def active() -> Tuple[Optional[Rules], Optional[Mesh]]:
    cur = _ACTIVE.get()
    return cur if cur is not None else (None, None)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint, checked and then a no-op.

    Under active rules the reference asks XLA's partitioner to lay ``x``
    out by the spec of ``logical``; the constraint changes no value.  The
    port has no partitioner (every shard of a mesh lives on one device),
    so it computes the spec, which raises for more logical axes than
    ``x`` has dimensions as ``with_sharding_constraint`` does, and returns
    ``x`` itself."""
    rules, mesh = active()
    if rules is None or mesh is None:
        return x
    if len(logical) > x.dim():
        raise ValueError(f"{len(logical)} logical axes {logical} for a "
                         f"tensor of rank {x.dim()}")
    rules.spec_for(logical, dims=x.shape)
    return x


# ---------------------------------------------------------------------------
# Standard rule sets
# ---------------------------------------------------------------------------

def make_rules(mesh: Mesh, *, fsdp: bool = True,
               seq_shard: bool = True,
               batch_axes: MeshAxes = "data") -> Rules:
    """Default DP(+FSDP) x TP(+EP) rules for a ("data", "model") or
    ("pod", "data", "model") mesh.

    - batch       -> data (+pod if present)
    - seq         -> model (sequence/context parallelism for activations)
    - embed       -> data for weights (FSDP / ZeRO-3; gathered on use)
    - heads/ff    -> model (tensor parallelism)
    - experts     -> model (expert parallelism; MaRe repartition_by)
    - vocab       -> model (sharded logits + distributed softmax)
    """
    shape = dict(mesh.shape)
    has_pod = "pod" in shape
    batch = (("pod", "data") if has_pod else "data") if batch_axes == "data" \
        else batch_axes
    table: Dict[str, MeshAxes] = {
        "batch": batch,
        "seq": "model" if seq_shard else None,
        "embed": "data" if fsdp else None,
        "embed_pod": ("pod", "data") if (fsdp and has_pod) else (
            "data" if fsdp else None),
        "heads": "model",
        "kv": "model",
        "hd": None,
        "ff": "model",
        "experts": "model",
        "expert_ff": "data" if fsdp else None,
        "vocab": "model",
        "kv_seq": "model",
        "layers": None,
        "conv": None,
        "state": None,
    }
    return Rules(table=table, mesh_shape=shape)


def data_only_rules(mesh: Mesh) -> Rules:
    """Pure-DP rules (small models / paper-faithful MaRe tree grad sync)."""
    shape = dict(mesh.shape)
    axes = tuple(a for a in ("pod", "data", "model") if a in shape)
    table: Dict[str, MeshAxes] = {k: None for k in (
        "seq", "embed", "embed_pod", "heads", "kv", "hd", "ff", "experts",
        "expert_ff", "vocab", "kv_seq", "layers", "conv", "state")}
    table["batch"] = axes if len(axes) > 1 else (axes[0] if axes else None)
    return Rules(table=table, mesh_shape=shape)
