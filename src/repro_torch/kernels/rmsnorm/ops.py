"""Public RMSNorm over any number of leading dimensions."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [..., d]; weight: [d] -> x's shape and dtype."""
    shape = x.shape
    out = rmsnorm_kernel(x.reshape(-1, shape[-1]).contiguous(), weight,
                         eps=eps)
    return out.reshape(shape)


__all__ = ["rmsnorm", "rmsnorm_ref"]
