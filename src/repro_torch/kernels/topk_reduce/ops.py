"""Public top-k selection."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.topk_reduce.kernel import topk_reduce_kernel
from repro_torch.kernels.topk_reduce.ref import topk_ref


def topk_reduce(scores: torch.Tensor, k: int,
                valid_count: Optional[Union[int, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over [n] float32 scores -> (values [k], indices [k] int32).
    ``valid_count`` (default n) may be a tensor on the scores' device, so
    that nothing waits for the host."""
    n = scores.shape[0]
    return topk_reduce_kernel(scores.contiguous(), k,
                              n if valid_count is None else valid_count)


__all__ = ["topk_reduce", "topk_ref"]
