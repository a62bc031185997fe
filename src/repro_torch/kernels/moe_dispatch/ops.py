"""Public MoE dispatch slotting."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.moe_dispatch.kernel import moe_dispatch_kernel
from repro_torch.kernels.moe_dispatch.ref import dispatch_ref


def moe_dispatch(assignments: torch.Tensor, num_groups: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """assignments: [n] integer group ids -> (positions [n], counts
    [num_groups]) int32.  Ids are taken as int32, as in the reference."""
    return moe_dispatch_kernel(
        assignments.reshape(-1).to(torch.int32).contiguous(), num_groups)


__all__ = ["moe_dispatch", "dispatch_ref"]
