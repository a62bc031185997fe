"""Lineage fingerprints: the identity of a materialized dataset.

A :class:`Lineage` names a dataset by *how it was produced*: a root
source id plus the canonical signature of every stage applied since that
root — the RDD-lineage idea from the MapReduce survey literature
(Sakr et al., 1302.2966), reduced to a hashable cache key.  Two MaRe
handles forked from the same base dataset share a lineage prefix, so a
materialization registered by ``persist()`` on one handle is found by
*any* handle whose plan prefix reaches the same lineage node (see
:mod:`repro_torch.runtime.cache`).

Roots come in two flavors:

* **host roots** (:func:`host_root`) — a process-unique token per
  ``from_host``-style dataset.  Content identity of arbitrary host
  arrays is unknown, so equal arrays parallelized twice get distinct
  roots.
* **source roots** (:func:`source_root`) — a content digest over a
  :class:`~repro_torch.io.source.DataSource`'s resolved splits and pack
  geometry.  Re-ingesting the same byte ranges of the same files yields
  the SAME root.  This assumes sources are immutable (the
  HDFS/object-store model the paper targets).

Stage signatures reuse :meth:`repro_torch.core.plan.Plan.signature` — the
same canonical form the plan cache keys on, including the
callable-identity caveats for ``key_by`` documented there.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Hashable, Iterable, Optional, TYPE_CHECKING, Tuple

if TYPE_CHECKING:
    from repro_torch.core.plan import Plan

_HOST_IDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class Lineage:
    """Root source id + canonical signatures of every stage applied."""

    source: Hashable
    stages: Tuple[Hashable, ...] = ()

    def extend(self, plan: Plan, upto: Optional[int] = None) -> "Lineage":
        """Lineage after applying ``plan``'s first ``upto`` stages (all
        stages when ``upto`` is None)."""
        stages = plan.stages if upto is None else plan.stages[:upto]
        return Lineage(self.source,
                       self.stages + tuple(st.signature() for st in stages))

    @property
    def depth(self) -> int:
        return len(self.stages)

    def digest(self) -> str:
        """Short stable-ish hex tag for logs and reports (identity-keyed
        stage signatures make it process-local)."""
        h = hashlib.sha1(repr((self.source, self.stages)).encode())
        return h.hexdigest()[:8]

    def describe(self) -> str:
        root = self.source[0] if isinstance(self.source, tuple) \
            else self.source
        return f"lineage[{root}+{self.depth} stages @{self.digest()}]"


def host_root(tag: str = "host") -> Lineage:
    """Fresh process-unique root for a host-parallelized dataset."""
    return Lineage(source=(tag, next(_HOST_IDS)))


def source_root(backend_name: str, fmt_name: str, splits: Iterable,
                capacity: int, width: int) -> Lineage:
    """Content-keyed root for an ingested DataSource: same backend,
    format, byte ranges and pack geometry -> same root."""
    h = hashlib.sha1()
    h.update(f"{backend_name}|{fmt_name}|{capacity}|{width}".encode())
    for sp in splits:
        h.update(f"|{sp.path}:{sp.start}:{sp.stop}:{sp.file_size}".encode())
    return Lineage(source=("source", h.hexdigest()))


def stream_root(base: Lineage, epoch: int) -> Lineage:
    """Snapshot-generation root for an incrementally maintained aggregate:
    the base lineage of the maintained query plus the epoch watermark
    folded in so far.  Distinct epochs are distinct cache keys, while the
    same (base, epoch) pair from any handle reaches the same entry."""
    return Lineage(source=("stream", base.source, base.stages, epoch))
