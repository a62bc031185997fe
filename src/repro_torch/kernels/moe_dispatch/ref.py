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
