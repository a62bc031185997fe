"""InputSplit planning: carve files into per-shard byte ranges.

The Hadoop InputFormat analogue: each file is cut into ``split_bytes``
ranges; :func:`assign_splits` then bin-packs splits onto shards by byte
length (longest-processing-time greedy) so each shard fetches only its own
byte ranges — locality by construction, balanced by size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.io.backends import StorageBackend

DEFAULT_SPLIT_BYTES = 1 << 20


@dataclasses.dataclass(frozen=True)
class InputSplit:
    """A byte range ``[start, stop)`` of one stored object."""

    path: str
    start: int
    stop: int
    file_size: int

    @property
    def length(self) -> int:
        return self.stop - self.start


def plan_splits(backend: StorageBackend,
                paths: Optional[Sequence[str]] = None,
                split_bytes: int = DEFAULT_SPLIT_BYTES,
                num_splits: Optional[int] = None) -> List[InputSplit]:
    """Carve ``paths`` (default: everything the backend lists) into splits.

    ``num_splits`` overrides ``split_bytes`` with ``ceil(total/num_splits)``
    (at least one split per file either way).
    """
    paths = list(paths) if paths is not None else backend.list()
    sizes = {p: backend.size(p) for p in paths}
    if num_splits is not None:
        total = sum(sizes.values())
        split_bytes = max(1, math.ceil(total / max(1, num_splits)))
    out: List[InputSplit] = []
    for p in paths:
        size = sizes[p]
        if size == 0:
            continue
        nchunks = max(1, math.ceil(size / split_bytes))
        chunk = math.ceil(size / nchunks)
        for start in range(0, size, chunk):
            out.append(InputSplit(path=p, start=start,
                                  stop=min(start + chunk, size),
                                  file_size=size))
    return out


def assign_splits(splits: Sequence[InputSplit], num_shards: int
                  ) -> List[List[InputSplit]]:
    """Greedy LPT bin packing of splits onto shards (balance by bytes).

    Within each shard, splits keep global plan order so record order is
    deterministic.
    """
    bins: List[List[int]] = [[] for _ in range(num_shards)]
    load = [0] * num_shards
    order = sorted(range(len(splits)), key=lambda i: -splits[i].length)
    for i in order:
        s = min(range(num_shards), key=lambda b: load[b])
        bins[s].append(i)
        load[s] += splits[i].length
    return [[splits[i] for i in sorted(b)] for b in bins]
