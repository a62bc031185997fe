"""Plain PyTorch MoE dispatch slotting: the oracle and the CUDA kernel's
plain version (the reference's ``ref.py``)."""
from __future__ import annotations

from typing import Tuple

import torch


def dispatch_ref(assignments: torch.Tensor, num_groups: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """assignments: [n] int group ids.

    Returns (positions [n], counts [num_groups]), both int32:
    positions[i] is the arrival rank of element i within its group
    (stable order) and counts[g] the group's size.  An id outside
    ``[0, num_groups)`` matches no group: position 0, counted nowhere.
    """
    groups = torch.arange(num_groups, device=assignments.device)
    onehot = (assignments.long()[:, None] == groups[None, :]).to(torch.int32)
    within = torch.cumsum(onehot, dim=0) - onehot        # ranks before i
    positions = torch.sum(within * onehot, dim=1).to(torch.int32)
    counts = torch.sum(onehot, dim=0).to(torch.int32)
    return positions, counts


def dispatch_cluster_ref(assignments: torch.Tensor, num_groups: int,
                         blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cluster route's algebra in tensor code: rank the ids within
    each of ``blocks`` contiguous slices (the last ones shorter or empty
    where n does not divide), then add to each id the counts of its group
    in the earlier slices.  Equals :func:`dispatch_ref` bit for bit; the
    tests hold it to the reference, the card's kernel is held to
    :func:`dispatch_ref`."""
    if blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    n = assignments.shape[0]
    size = -(-n // blocks)
    positions = torch.zeros((n,), dtype=torch.int32,
                            device=assignments.device)
    counts = torch.zeros((num_groups,), dtype=torch.int32,
                         device=assignments.device)
    for b in range(blocks):
        ids = assignments[b * size:(b + 1) * size].long()
        rank, hist = dispatch_ref(ids, num_groups)
        ok = (ids >= 0) & (ids < num_groups)
        earlier = counts[ids.clamp(0, num_groups - 1)]
        positions[b * size:b * size + ids.shape[0]] = torch.where(
            ok, rank + earlier, 0)
        counts = counts + hist
    return positions, counts
